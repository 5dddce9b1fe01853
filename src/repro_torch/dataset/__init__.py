# Multi-file dataset layer: a fragment manifest with global row ids and a
# global byte-address space, read through ONE shared IOScheduler so a take
# over many Lance files coalesces across files and drains as one batch.

from .manifest import (  # noqa: F401
    Fragment,
    Manifest,
    build_dataset_disk,
    footer_meta,
    write_fragments,
)
from .reader import DatasetReader  # noqa: F401
