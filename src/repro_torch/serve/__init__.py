# Serving layer: the batched LM engine (BatchedEngine), the random-access
# retrieval path (Retriever.fetch), IVF search over an index stored as
# dataset fragments (Retriever.search), the multi-tenant Zipf serving workload priced by the store's event loop, and
# the paged KV cache whose gathers run on the fullzip_gather kernel.

from .engine import BatchedEngine, GenResult, Retriever, SearchResult  # noqa: F401
from .kv_cache import BLOCK, PagedKVCache  # noqa: F401
from .workload import (  # noqa: F401
    FaultScenario,
    ServeRequest,
    TenantSpec,
    ZipfWorkload,
    drive,
    run_scenario,
    tenant_summary,
)
