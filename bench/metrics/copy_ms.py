"""Device time of the host<->device copies a request (the profiler's
``gpu_memcpy`` events inside the window).  Traced runs on a card; ms."""


def read(record):
    if record.device is None or not record.requests:
        return None
    return record.device.copy_s / record.requests * 1e3
