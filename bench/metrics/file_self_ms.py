"""Self time of the file and encodings layer (FileReader.take_leaves/.scan_into
and the encoding readers under them, chunk decompression and word packing
included), a request: host-clock spans wrapped around the layer's entry
points from the benchmark's side, less the wrapped calls inside them. Traced
runs; ms."""


def read(record):
    if record.layer_s is None or not record.requests:
        return None
    return record.layer_s.get("file", 0.0) / record.requests * 1e3
