"""Metric readers: ``read(record) -> float | None`` (``cell.Record``); None
when the run has nothing to read, and the metric is then left out."""
