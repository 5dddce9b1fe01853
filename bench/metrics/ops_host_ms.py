"""Host time inside the port's kernel wrappers and copies (kernels/ops.py:
the launches, and the wait for the device in to_host), a request: host-clock
spans wrapped around them from the benchmark's side.  Traced runs; ms."""


def read(record):
    if record.layer_s is None or not record.requests:
        return None
    return record.layer_s.get("ops", 0.0) / record.requests * 1e3
