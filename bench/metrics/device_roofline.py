"""The share of the device's memory roofline: the least time the window's
answers need (their bytes written once and read once at 3.35 TB/s,
``bench.peaks``) over the summed time of the kernels in the window.  Defined on the operation's
work, so replacing or fusing kernels leaves the yardstick as it is.  Traced
runs on a card; %, against the published peak."""

from bench import peaks


def read(record):
    if record.device is None or record.device.kernel_s <= 0:
        return None
    return peaks.memory_bound_s(record.result_bytes) / record.device.kernel_s * 100
