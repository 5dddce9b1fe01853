"""Self time of the store layer (ReadBatch.read/.read_many and
IOScheduler._finish: bytes served, coalescing, dispatch, accounting), a
request: host-clock spans wrapped around the layer's entry points from the
benchmark's side, less the wrapped calls inside them. Traced runs; ms."""


def read(record):
    if record.layer_s is None or not record.requests:
        return None
    return record.layer_s.get("store", 0.0) / record.requests * 1e3
