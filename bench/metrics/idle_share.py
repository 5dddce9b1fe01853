"""The share of the window in which no kernel, copy or memset ran on the
device (the profiler's trace).  Traced runs on a card; %."""


def read(record):
    if record.device is None or record.device.window_s <= 0:
        return None
    return (1 - record.device.busy_s / record.device.window_s) * 100
