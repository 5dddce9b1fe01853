"""File writer/reader: the container format around the structural encodings.

Layout (one "disk page" per encoded leaf column, paper §2.1: Lance columns
may have multiple disk pages; we write one per leaf for clarity):

    [leaf payload 0][leaf payload 1]...[footer msgpack][footer_len u64]["LNC1"]

The footer holds the schema, per-leaf encoding metadata and payload offsets.
It is read once when the file is opened (not counted against per-take IOPS —
it is the search cache + file metadata of §2.3; its size is reported so the
0.1 % goal can be checked).

Encodings: ``lance`` (adaptive mini-block/full-zip, §4), ``lance-miniblock``
/ ``lance-fullzip`` (forced, for the ablations).  The port writes the same
bytes as the JAX package.  The baselines (``parquet``, ``arrow``) and struct
packing (``packed``) are not ported yet: writing or opening them raises
``NotImplementedError``.
"""

from __future__ import annotations

import struct as _struct
from typing import Dict, List, Optional

import numpy as np

from . import arrays as A
from . import types as T
from . import msgpack_subset
from .adaptive import choose_encoding
from .encodings_base import EncodedColumn
from .fullzip import FullZipReader, encode_fullzip
from .io_sim import Disk
from .miniblock import MiniBlockReader, encode_miniblock
from .shred import ShreddedLeaf, _def_codes, leaf_paths, shred, unshred

MAGIC = b"LNC1"

__all__ = ["WriteOptions", "write_table", "FileReader", "read_footer",
           "type_to_dict", "type_from_dict"]


def read_footer(read, size: int):
    """Parse a Lance footer through ``read(offset, size) -> bytes-like``.

    The single source of the trailer format (``[footer][len u64][magic]``),
    shared by :class:`FileReader` (reading a Disk) and the dataset manifest
    (peeking raw fragment bytes).  Returns ``(meta, footer_len)``.
    """
    if size < 12:
        raise ValueError("not a Lance file (too short)")
    tail = bytes(read(size - 12, 12))
    if tail[-4:] != MAGIC:
        raise ValueError("not a Lance file (bad magic)")
    (flen,) = _struct.unpack("<Q", tail[:8])
    return unpack_meta(bytes(read(size - 12 - flen, flen))), flen


# ---------------------------------------------------------------------------
# schema serialization
# ---------------------------------------------------------------------------


def type_to_dict(t: T.DataType) -> Dict:
    if isinstance(t, T.Primitive):
        return {"k": "prim", "dtype": t.dtype, "null": t.nullable}
    if isinstance(t, T.Utf8):
        return {"k": "utf8", "null": t.nullable}
    if isinstance(t, T.Binary):
        return {"k": "bin", "null": t.nullable}
    if isinstance(t, T.FixedSizeList):
        return {"k": "fsl", "child": type_to_dict(t.child), "size": t.size, "null": t.nullable}
    if isinstance(t, T.List):
        return {"k": "list", "child": type_to_dict(t.child), "null": t.nullable}
    if isinstance(t, T.Struct):
        return {"k": "struct", "fields": [[n, type_to_dict(f)] for n, f in t.fields], "null": t.nullable}
    raise TypeError(t)


def type_from_dict(d: Dict) -> T.DataType:
    k = d["k"]
    if k == "prim":
        return T.Primitive(d["dtype"], d["null"])
    if k == "utf8":
        return T.Utf8(d["null"])
    if k == "bin":
        return T.Binary(d["null"])
    if k == "fsl":
        return T.FixedSizeList(type_from_dict(d["child"]), d["size"], d["null"])
    if k == "list":
        return T.List(type_from_dict(d["child"]), d["null"])
    if k == "struct":
        return T.Struct(tuple((n, type_from_dict(f)) for n, f in d["fields"]), d["null"])
    raise TypeError(d)


# msgpack (the port's own subset) with numpy support ------------------------------------------------


def _mp_default(obj):
    if isinstance(obj, np.ndarray):
        return {"__nd__": True, "d": obj.dtype.str, "s": list(obj.shape), "b": obj.tobytes()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, tuple):
        return list(obj)
    raise TypeError(type(obj))


def _mp_hook(obj):
    if "__nd__" in obj:
        return np.frombuffer(obj["b"], dtype=np.dtype(obj["d"])).reshape(obj["s"]).copy()
    return obj


def pack_meta(meta) -> bytes:
    return msgpack_subset.packb(meta, default=_mp_default)


def unpack_meta(blob: bytes):
    return msgpack_subset.unpackb(blob, object_hook=_mp_hook)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


_NOT_PORTED = ("ROADMAP.md, Queue 1: the parquet, arrow and packed "
               "readers are not ported yet")
# decode routes: the footer keeps the JAX package's name for the device route
_FOOTER_DECODE = {"numpy": "numpy", "device": "pallas"}
_DECODE_FROM_FOOTER = {"numpy": "numpy", "pallas": "device"}


def _check_decode(decode: str) -> str:
    if decode not in ("numpy", "device"):
        raise ValueError(f"decode must be 'numpy'|'device', got {decode!r}")
    return decode


class WriteOptions:
    def __init__(
        self,
        encoding: str = "lance",  # lance | lance-miniblock | lance-fullzip
        fixed_codec: Optional[str] = None,
        bytes_codec: Optional[str] = None,
        decode: str = "numpy",  # default chunk decoder: numpy | device
    ):
        self.encoding = encoding
        self.fixed_codec = fixed_codec
        self.bytes_codec = bytes_codec
        self.decode = _check_decode(decode)


def _encode_leaf(leaf: ShreddedLeaf, opts: WriteOptions) -> EncodedColumn:
    enc = opts.encoding
    if enc == "lance":
        enc = "lance-" + choose_encoding(leaf)
    if enc == "lance-miniblock":
        return encode_miniblock(
            leaf,
            fixed_codec=opts.fixed_codec,
            bytes_codec=opts.bytes_codec or "zstd_chunk",
        )
    if enc == "lance-fullzip":
        bc = opts.bytes_codec or "plain_bytes"
        from .compression import get_bytes_codec

        if not get_bytes_codec(bc).transparent:
            # full-zip requires transparent compression; opaque codecs are
            # applied per value instead (paper §2.2: "an opaque encoding can
            # be used in a transparent fashion if applied on a per-value
            # basis" — Lance's per-value LZ4)
            bc = "zstd_per_value"
        return encode_fullzip(
            leaf,
            fixed_codec=opts.fixed_codec or "plain",
            bytes_codec=bc,
        )
    if enc in ("parquet", "arrow"):
        raise NotImplementedError(f"encoding {enc!r}: {_NOT_PORTED}")
    raise ValueError(enc)


def write_table(table: Dict[str, A.Array], opts: Optional[WriteOptions] = None) -> bytes:
    """Encode ``table`` into one Lance file, byte-identical to the JAX
    package's writer for the same options."""
    opts = opts or WriteOptions()
    payload = b""
    cols_meta: List[Dict] = []
    for name, arr in table.items():
        col: Dict = {"name": name, "type": type_to_dict(arr.type), "n_rows": len(arr)}
        col["kind"] = "shredded"
        leaves_meta = []
        for leaf in shred(arr):
            ec = _encode_leaf(leaf, opts)
            leaves_meta.append({
                "base": len(payload), "meta": ec.meta, "bytes": len(ec.payload),
                "search_cache": ec.search_cache_bytes,
                "path": list(leaf.path),
                "n_entries": leaf.n_entries,
            })
            payload += ec.payload + b"\x00" * ((-len(ec.payload)) % 8)
        col["leaves"] = leaves_meta
        cols_meta.append(col)
    footer = pack_meta({"columns": cols_meta,
                        "options": {"encoding": opts.encoding,
                                    "decode": _FOOTER_DECODE[opts.decode]}})
    return payload + footer + _struct.pack("<Q", len(footer)) + MAGIC


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


_READERS = {
    "miniblock": MiniBlockReader,
    "fullzip": FullZipReader,
}


class FileReader:
    """Reads a Lance-style file through the flat storage subsystem.

    ``store`` selects the backing device (see
    :func:`repro_torch.store.make_store`): ``None``/"flat" prices every read
    on NVMe, "flat-s3" on a cold object store.  Every ``take``/``scan`` runs
    as one scheduler :class:`~repro_torch.store.ReadBatch`; random access is
    the batched decode-once pipeline (all needed chunks/spans submitted as
    phase-grouped ``read_many`` batches, each span decoded exactly once, rows
    fanned out to request order by a single permutation).

    ``decode`` selects the decode routes: ``"numpy"`` (host) or ``"device"``
    (the CUDA kernels of :mod:`repro_torch.kernels` on ``device``).  Under
    ``"device"`` mini-block chunks batch-decode through the
    ``miniblock_decode`` kernel (bit-packed and FoR-bytepacked ints,
    multi-bit rep/def streams, fixed-size-list values) and fixed-stride
    full-zip takes fan out through the ``fullzip_gather`` kernel.  ``None``
    defers to the writer's ``WriteOptions(decode=...)`` recorded in the
    footer, where the device route is spelled ``"pallas"``.

    ``device`` is where the device routes run: CUDA by default, which raises
    without a GPU; ``device="cpu"`` runs the kernels' plain PyTorch versions.

    ``scheduler``/``base`` plug this file into a *shared* IO path (the
    multi-file dataset layer, ``repro_torch.dataset``): instead of building
    its own store the reader enqueues every read — rebased by ``base`` into
    the scheduler's global address space — onto the injected
    :class:`~repro_torch.store.IOScheduler`, so many files coalesce in one
    dispatch.
    """

    def __init__(self, file_bytes_or_disk, store=None, queue_depth: int = 256,
                 decode: Optional[str] = None, scheduler=None, base: int = 0,
                 device=None):
        from ..kernels.ops import resolve_device
        from ..store import IOScheduler, make_store

        self.device = resolve_device(device)
        if isinstance(file_bytes_or_disk, (bytes, bytearray)):
            disk = Disk.from_bytes(bytes(file_bytes_or_disk))
        else:
            disk = file_bytes_or_disk
        self.disk = disk
        self.base = int(base)
        if scheduler is not None:
            if store is not None:
                raise ValueError("pass store or scheduler, not both")
            if queue_depth != 256:
                raise ValueError(
                    "queue_depth is fixed by the injected scheduler")
            if self.base < 0 or self.base + len(disk) > len(scheduler.store.disk):
                raise ValueError(
                    "file does not fit the shared store at base "
                    f"{self.base}")
            self.scheduler = scheduler
            self.store = scheduler.store
        else:
            if self.base:
                raise ValueError("base requires an injected scheduler")
            self.store = make_store(store, disk)
            self.scheduler = IOScheduler(self.store, queue_depth=queue_depth)
        self.meta, self.footer_bytes = read_footer(disk.read, len(disk))
        self.columns = {c["name"]: c for c in self.meta["columns"]}
        if decode is None:
            recorded = self.meta.get("options", {}).get("decode") or "numpy"
            decode = _DECODE_FROM_FOOTER.get(recorded, recorded)
        self.decode = _check_decode(decode)
        self._readers: Dict[str, list] = {}

    # -- reader construction ------------------------------------------------
    def _leaf_readers(self, name: str):
        if name in self._readers:
            return self._readers[name]
        col = self.columns[name]
        if col["kind"] != "shredded":
            raise NotImplementedError(
                f"column {name!r} is stored as {col['kind']!r}: {_NOT_PORTED}")
        typ = type_from_dict(col["type"])
        out = []
        protos = {tuple(p): tp for p, tp in leaf_paths(typ)}
        for lm in col["leaves"]:
            path = tuple(lm["path"])
            type_path = protos[path]
            proto = _proto_from(path, type_path, lm)
            enc = lm["meta"]["encoding"]
            if enc not in _READERS:
                raise NotImplementedError(
                    f"column {name!r} is encoded as {enc!r}: {_NOT_PORTED}")
            out.append(_READERS[enc](lm["meta"], lm["base"], proto,
                                     decode=self.decode, device=self.device))
        self._readers[name] = out
        return out

    # -- public API -----------------------------------------------------------
    def take(self, name: str, rows) -> A.Array:
        col = self.columns[name]
        rows = np.asarray(rows, dtype=np.int64)
        with self.scheduler.batch(f"take:{name}") as io:
            # the rows are the logical requests of this drain; declared here —
            # not in take_leaves — so a dataset-wide take counts each row once
            io.note_requests(len(rows))
            res = self.take_leaves(name, rows, io)
        return unshred(res, type_from_dict(col["type"]))

    def take_leaves(self, name: str, rows, io):
        """One take through an externally-owned batch handle.

        Returns the list of per-leaf ``ShreddedLeaf`` slices (request order,
        duplicates materialized) — the dataset layer concatenates leaves
        across fragments before unshredding once.  Reads are rebased by this
        file's ``base`` so a shared batch prices them in the global address
        space.
        """
        rows = np.asarray(rows, dtype=np.int64)
        readers = self._leaf_readers(name)
        io = io.at(self.base)
        return [r.take(rows, io) for r in readers]

    def scan(self, name: str, io_chunk: int = 8 << 20) -> A.Array:
        with self.scheduler.batch(f"scan:{name}") as io:
            return self.scan_into(name, io, io_chunk=io_chunk)

    def scan_into(self, name: str, io, io_chunk: int = 8 << 20) -> A.Array:
        """One full-column scan through an externally-owned batch handle."""
        typ = type_from_dict(self.columns[name]["type"])
        readers = self._leaf_readers(name)
        io = io.at(self.base)
        leaves = [r.scan(io, io_chunk=io_chunk) for r in readers]
        return unshred(leaves, typ)

    # -- accounting -------------------------------------------------------------
    def search_cache_bytes(self, name: Optional[str] = None) -> int:
        cols = [self.columns[name]] if name else self.meta["columns"]
        total = 0
        for c in cols:
            for lm in c["leaves"]:
                total += lm["search_cache"]
        return total

    def data_bytes(self, name: Optional[str] = None) -> int:
        cols = [self.columns[name]] if name else self.meta["columns"]
        return sum(lm["bytes"] for c in cols for lm in c["leaves"])

    def reset_io(self):
        """Zero the logical trace and tier counters."""
        self.scheduler.reset()

    def io_stats(self, coalesce_gap: int = 0):
        return self.scheduler.stats(coalesce_gap)

    def tier_stats(self):
        """Per-tier dispatched-IO stats (the backing device)."""
        return self.store.tier_stats()

    def modelled_time(self, queue_depth: Optional[int] = None) -> float:
        """Modelled wall time of all IO since the last reset, priced on the
        backing device."""
        return self.scheduler.model_time(queue_depth)


def _proto_from(path, type_path, lm) -> ShreddedLeaf:
    codes, meanings, max_def, null_item = _def_codes(type_path)
    max_rep = sum(1 for t in type_path if isinstance(t, T.List))
    return ShreddedLeaf(
        path=path, type_path=tuple(type_path), leaf_type=type_path[-1],
        rep=None, defs=None, values=None,
        n_entries=lm.get("n_entries", 0), max_rep=max_rep, max_def=max_def,
        def_meanings=meanings, null_item_code=null_item,
        n_rows=lm["meta"].get("n_rows", 0),
    )
