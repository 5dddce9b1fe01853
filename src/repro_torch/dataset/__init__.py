# Multi-file dataset layer: a fragment manifest with global row ids and a
# global byte-address space, read through ONE shared IOScheduler so a take
# over many Lance files coalesces across files and drains as one batch.
# The ingest side (DatasetWriter) appends fragments through the write path
# and commits versioned manifests; IvfIndex stores an IVF index as
# fragments of an attached writer.

from .manifest import (  # noqa: F401
    Fragment,
    Manifest,
    build_dataset_disk,
    footer_meta,
    write_fragments,
)
from .ivf import IvfIndex, kmeans  # noqa: F401
from .reader import DatasetReader  # noqa: F401
from .writer import DatasetWriter  # noqa: F401
