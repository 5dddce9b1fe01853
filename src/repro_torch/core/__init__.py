# The paper's primary contribution: adaptive structural encodings for
# columnar storage (Lance 2.1).  Shredding (Dremel rep/def levels), the
# mini-block and full-zip structural encodings and the file container with
# exact IOP accounting — the port's own copy of ``repro.core``'s take path.

from . import types  # noqa: F401
from .adaptive import FULLZIP_THRESHOLD_BYTES, choose_encoding  # noqa: F401
from .arrays import (  # noqa: F401
    Array,
    FixedSizeListArray,
    ListArray,
    PrimitiveArray,
    StructArray,
    VarBinaryArray,
    from_pylist,
    to_pylist,
)
from .file import FileReader, WriteOptions, write_table  # noqa: F401
from .io_sim import DRAM, NVME, S3, Disk, model_time  # noqa: F401
from .shred import ShreddedLeaf, shred, unshred  # noqa: F401
