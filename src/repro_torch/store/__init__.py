"""The port's flat store: a batched IO scheduler that coalesces each
take/scan's reads (and each append's writes) per dependency phase,
sector-aligns them and prices them on one backing device (NVMe or S3)."""

from .scheduler import (  # noqa: F401
    IOScheduler,
    ReadBatch,
    TieredStore,
    WriteBatch,
    make_store,
)
from .stats import DrainRecord, TierStats  # noqa: F401
