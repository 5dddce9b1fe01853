"""The port's tiered store: a batched IO scheduler that coalesces each
take/scan's reads (and each append's writes) per dependency phase,
sector-aligns them, classifies each sector against a cache hierarchy (an
NVMe block cache over S3, or RAM over NVMe over S3) and prices each tier on
its device model.  Readahead fills the cache ahead of scans, the workload
mix can pick the admission policy, and a flush policy decides when written
blocks become durable (write-through, write-back, flush-on-evict)."""

from .cache import BlockCache  # noqa: F401
from .flush import FlushPolicy, SimulatedCrash  # noqa: F401
from .prefetch import SequentialReadahead  # noqa: F401
from .scheduler import (  # noqa: F401
    CacheTier,
    IOScheduler,
    ReadBatch,
    TieredStore,
    WriteBatch,
    make_store,
)
from .stats import DrainRecord, TierStats  # noqa: F401
from .workload import WorkloadStats  # noqa: F401
