# Serving layer: the random-access retrieval path (Retriever.fetch) and IVF
# search over an index stored as dataset fragments (Retriever.search).

from .engine import Retriever, SearchResult  # noqa: F401
