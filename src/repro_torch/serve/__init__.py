# Serving layer: the random-access retrieval path (Retriever.fetch), IVF
# search over an index stored as dataset fragments (Retriever.search), and
# the multi-tenant Zipf serving workload priced by the store's event loop.

from .engine import Retriever, SearchResult  # noqa: F401
from .workload import (  # noqa: F401
    FaultScenario,
    ServeRequest,
    TenantSpec,
    ZipfWorkload,
    drive,
    run_scenario,
    tenant_summary,
)
