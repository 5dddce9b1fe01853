"""The port's flat store: a batched IO scheduler that coalesces each
take/scan's reads per dependency phase, sector-aligns them and prices them
on one backing device (NVMe or S3)."""

from .scheduler import IOScheduler, ReadBatch, TieredStore, make_store  # noqa: F401
from .stats import DrainRecord, TierStats  # noqa: F401
