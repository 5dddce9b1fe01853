"""The port's tiered store: a batched IO scheduler that coalesces each
take/scan's reads (and each append's writes) per dependency phase,
sector-aligns them, classifies each sector against a cache hierarchy (an
NVMe block cache over S3, or RAM over NVMe over S3) and prices each tier on
its device model.  Readahead fills the cache ahead of scans, the workload
mix can pick the admission policy, and a flush policy decides when written
blocks become durable (write-through, write-back, flush-on-evict).  The event
loop (``evloop``) prices many requests' drains together on a virtual clock,
under the devices' fault schedules."""

from .cache import BlockCache  # noqa: F401
from .evloop import (  # noqa: F401
    EventLoop,
    Job,
    JobCompletion,
    QoS,
    RetryPolicy,
    ServiceResult,
    ServiceWindow,
    build_job,
    latency_percentiles,
)
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
