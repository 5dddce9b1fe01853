"""Self time of the dataset layer (DatasetReader.take/.scan: fragment fan-out,
concat_leaves, reorder_leaf_rows, unshred), a request: host-clock spans
wrapped around the layer's entry points from the benchmark's side, less the
wrapped calls inside them. Traced runs; ms."""


def read(record):
    if record.layer_s is None or not record.requests:
        return None
    return record.layer_s.get("dataset", 0.0) / record.requests * 1e3
