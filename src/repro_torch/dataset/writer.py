"""Dataset ingest path: appendable, versioned Lance datasets over the
write-back tiered store.

``DatasetWriter`` is the write-side dual of
:class:`~repro_torch.dataset.reader.DatasetReader`: one growable global
address space, one shared :class:`~repro_torch.store.TieredStore` +
:class:`~repro_torch.store.IOScheduler`, and a
:class:`~repro_torch.store.FlushPolicy` deciding when appended bytes become
durable on the backing device.

* :meth:`append` encodes a table into a new fragment with the file writer
  (:func:`~repro_torch.core.file.write_table`), extends the global
  block-address space (8-aligned, append-only — committed bytes are never
  overwritten), and stages the fragment's bytes through one scheduler
  ``WriteBatch`` — write-through pays a backing (S3) drain per append,
  write-back absorbs the blocks dirty into the NVMe tier and lets the flush
  policy batch them.
* :meth:`commit` is the durability fence: **flush-then-commit** — every
  dirty block is flushed to the backing device *before* the new manifest
  version exists, so a crash at any point of the flush+commit sequence
  leaves every previously committed version readable (the torn bytes are
  only ever inside uncommitted fragments).
* :meth:`reader` opens any committed manifest version over the shared
  scheduler (time travel); :meth:`take`/:meth:`scan` serve the latest one.
* :meth:`compact` rewrites runs of small fragments into one (reads priced
  through the shared scheduler, the rewrite staged through the write path),
  commits the new fragment list as a version, and retargets the shared
  cache by invalidating the replaced fragments' blocks.
* :meth:`simulate_crash` is the durability model's teeth: unflushed (dirty)
  bytes are torn off the media, uncommitted fragments vanish, and the live
  state rewinds to the last committed version — per-tier ``lost_bytes``
  records what the write-back latency trade put at risk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import arrays as A
from ..core.file import FileReader, WriteOptions, write_table
from ..core.io_sim import Disk, DiskView
from ..kernels.ops import resolve_device
from ..store import FlushPolicy, IOScheduler, make_store

from .manifest import FRAGMENT_ALIGN, Fragment, Manifest, footer_meta
from .reader import DatasetReader

__all__ = ["DatasetWriter"]


def _schema_key(columns) -> List[Tuple[str, Dict]]:
    return [(c["name"], c["type"]) for c in columns]


class DatasetWriter:
    """Appendable, versioned multi-fragment dataset behind one IO path.

    ``store`` accepts the specs of :func:`repro_torch.store.make_store`
    (resolved over the writer's growable global disk).  ``flush`` selects
    the write path: a :class:`~repro_torch.store.FlushPolicy` mode string
    (``"write-through"``, ``"write-back"``, ``"flush-on-evict"``), a ready
    policy instance, or ``None`` (no policy attached: writes behave
    write-through).  ``files`` optionally seeds the dataset with existing
    fragment bytes (ingested through the write path and committed as v1).
    ``decode``, ``dict_cached`` and ``device`` are passed to every
    fragment's :class:`~repro_torch.core.file.FileReader`: ``dict_cached``
    keeps a Parquet column's dictionary page in the search cache, and the
    device routes run on CUDA unless ``device="cpu"``.  ``tracer`` is the IO path's
    (:class:`~repro_torch.obs.Tracer`; None traces nothing): appends,
    commits and compactions open spans on it, and a simulated crash is an
    instant.
    """

    def __init__(self, files: Sequence[bytes] = (), store="tiered",
                 flush="write-back", opts: Optional[WriteOptions] = None,
                 queue_depth: int = 256, readahead="auto",
                 decode: Optional[str] = None, dict_cached: bool = False,
                 tracer=None, *, device=None):
        self.device = resolve_device(device)
        self.opts = opts or WriteOptions()
        self.disk = Disk(np.zeros(0, np.uint8))
        self.store = make_store(store, self.disk)
        if isinstance(flush, str):
            flush = FlushPolicy(flush)
        self.store.set_flush_policy(flush)
        self.scheduler = IOScheduler(self.store, queue_depth=queue_depth,
                                     readahead=readahead, tracer=tracer)
        self.tracer = self.scheduler.tracer
        self._decode = decode
        self._dict_cached = dict_cached
        self._columns: Optional[List[Dict]] = None
        self.fragments: List[Fragment] = []   # live (to-be-committed) list
        self._pending: List[Fragment] = []    # appended since last commit
        self.versions: List[Manifest] = []    # committed manifests, v1..vN
        self._next_id = 0
        self._frag_readers: Dict[int, FileReader] = {}
        self._version_readers: Dict[int, DatasetReader] = {}
        if files:
            for fb in files:
                self._append_file(bytes(fb))
            self.commit()

    @classmethod
    def attached(cls, parent: "DatasetWriter",
                 opts: Optional[WriteOptions] = None,
                 decode: Optional[str] = None) -> "DatasetWriter":
        """A sibling writer over ``parent``'s disk / store / scheduler.

        Its fragments land in the *same* global address space (tail-appended
        and 8-aligned like any append), so their blocks carry the same
        sector ids, warm the same :class:`~repro_torch.store.BlockCache`
        budget, and drain through the same scheduler queues as the parent's
        data — but it keeps its own schema, fragment list and manifest
        versions, so it can commit, time-travel and ``compact()``
        independently.  This is the index-as-fragments substrate of
        :class:`~repro_torch.dataset.IvfIndex`.
        """
        self = cls.__new__(cls)
        self.device = parent.device
        self.tracer = parent.tracer
        self.opts = opts or parent.opts
        self.disk = parent.disk
        self.store = parent.store
        self.scheduler = parent.scheduler
        self._decode = decode if decode is not None else parent._decode
        self._dict_cached = parent._dict_cached
        self._columns = None
        self.fragments = []
        self._pending = []
        self.versions = []
        # disjoint reader-cache key space from the parent: ids only key
        # this writer's private _frag_readers / _version_readers dicts
        self._next_id = 0
        self._frag_readers = {}
        self._version_readers = {}
        return self

    # -- geometry ------------------------------------------------------------
    @property
    def flush_policy(self) -> Optional[FlushPolicy]:
        return self.store.flush_policy

    @property
    def version(self) -> int:
        """Latest committed manifest version (0 = nothing committed yet)."""
        return len(self.versions)

    @property
    def n_rows(self) -> int:
        """Rows visible at the latest committed version."""
        return self.versions[-1].n_rows if self.versions else 0

    @property
    def dirty_bytes(self) -> int:
        """Bytes staged but not yet durable (lost if the process dies)."""
        return sum(lvl.cache.dirty_bytes for lvl in self.store.levels)

    # -- ingest ---------------------------------------------------------------
    def _append_file(self, fb: bytes, label: str = "append") -> Fragment:
        """Stage raw fragment bytes at the end of the global address space
        through one write batch; the fragment is pending until a commit."""
        meta = footer_meta(fb)
        cols = meta["columns"]
        if self._columns is None:
            self._columns = cols
        elif _schema_key(cols) != _schema_key(self._columns):
            raise ValueError(
                f"appended schema {_schema_key(cols)!r} does not match "
                f"dataset schema {_schema_key(self._columns)!r}")
        base = len(self.disk)
        base += (-base) % FRAGMENT_ALIGN
        self.disk.grow(base + len(fb) - len(self.disk))
        fid = self._next_id
        self._next_id += 1
        with self.tracer.span(f"{label}:{fid}", cat="writer",
                              nbytes=len(fb)):
            with self.scheduler.write_batch(f"{label}:{fid}") as wb:
                wb.write(base, fb, phase=0)
        row_start = self.fragments[-1].row_stop if self.fragments else 0
        frag = Fragment(id=fid, base=base, nbytes=len(fb),
                        n_rows=cols[0]["n_rows"] if cols else 0,
                        row_start=row_start)
        self.fragments.append(frag)
        self._pending.append(frag)
        return frag

    def append(self, table: Dict[str, A.Array], commit: bool = True,
               ) -> Optional[Manifest]:
        """Encode ``table`` as a new fragment and stage it.  With
        ``commit=True`` (default) the append is made durable immediately
        (flush barrier + new manifest version); ``commit=False`` defers the
        fence — the staged rows are invisible to readers and lost on crash
        until the next :meth:`commit`."""
        self._append_file(write_table(table, self.opts))
        return self.commit() if commit else None

    def commit(self) -> Optional[Manifest]:
        """Flush-then-commit fence.  Ordering is the crash-safety contract:
        (1) every dirty block is flushed to the backing device; (2) only
        then is the new manifest version created.  An interruption anywhere
        leaves the previous version's bytes fully durable and the new
        version nonexistent — never a torn committed manifest.  Returns the
        committed manifest (the latest one when nothing new was staged, or
        ``None`` for a still-empty dataset)."""
        with self.tracer.span("commit", cat="writer",
                              n_pending=len(self._pending)) as sp:
            # (1) durability barrier (may SimulatedCrash); routed through
            # the scheduler so the flush drains hit the serving plane
            self.scheduler.flush_barrier()
            if not self.fragments:
                return None  # empty dataset: nothing to commit
            if self.versions and not self._pending \
                    and self.versions[-1].fragments == self.fragments:
                return self.versions[-1]  # nothing new: no empty version
            m = Manifest(self.fragments, self._columns,
                         version=len(self.versions) + 1)  # (2) commit point
            self.versions.append(m)
            self._pending = []
            sp.set(version=m.version)
            return m

    def flush(self) -> int:
        """Manual durability barrier without a commit (staged fragments stay
        pending but their bytes stop being at risk)."""
        return self.scheduler.flush_barrier()

    # -- reading -------------------------------------------------------------
    def _reader_for(self, frag: Fragment) -> FileReader:
        fr = self._frag_readers.get(frag.id)
        if fr is None:
            fr = FileReader(DiskView(self.disk, frag.base, frag.nbytes),
                            scheduler=self.scheduler, base=frag.base,
                            decode=self._decode, dict_cached=self._dict_cached,
                            device=self.device)
            self._frag_readers[frag.id] = fr
        return fr

    def reader(self, version: Optional[int] = None) -> DatasetReader:
        """A :class:`DatasetReader` over a committed manifest version (1-based;
        default latest), sharing this writer's store/scheduler."""
        if not self.versions:
            raise ValueError("nothing committed yet — append() first")
        v = len(self.versions) if version is None else int(version)
        if not 1 <= v <= len(self.versions):
            raise ValueError(f"version {v} out of range 1..{len(self.versions)}")
        ds = self._version_readers.get(v)
        if ds is None:
            m = self.versions[v - 1]
            ds = DatasetReader.from_manifest(
                m, self.disk, self.scheduler,
                readers=[self._reader_for(f) for f in m.fragments])
            self._version_readers[v] = ds
        return ds

    def take(self, name: str, rows) -> A.Array:
        """Random access by global row id at the latest committed version."""
        return self.reader().take(name, rows)

    def scan(self, name: str, io_chunk: int = 8 << 20) -> A.Array:
        """Full-column scan of the latest committed version."""
        return self.reader().scan(name, io_chunk=io_chunk)

    # -- maintenance ---------------------------------------------------------
    def compact(self, max_rows: int) -> Manifest:
        """Rewrite every run of >=2 adjacent fragments whose combined rows
        fit ``max_rows`` into one fragment (global row order unchanged).
        Reads go through the shared scheduler (compaction IO is priced like
        any other traffic), the merged payload is staged through the write
        path, and the whole rewrite commits as one new manifest version —
        after which the replaced fragments' blocks are invalidated so the
        shared cache retargets its budget at the live layout.  Old versions
        still address the old fragments (the address space is append-only)."""
        if max_rows <= 0:
            raise ValueError("max_rows must be positive")
        if self._pending:
            self.commit()
        if not self.versions:
            raise ValueError("nothing committed yet — append() first")
        with self.tracer.span("compact", cat="writer", max_rows=max_rows):
            return self._compact(max_rows)

    def _compact(self, max_rows: int) -> Manifest:
        groups: List[List[Fragment]] = []
        run: List[Fragment] = []
        for f in self.fragments:
            if run and sum(g.n_rows for g in run) + f.n_rows <= max_rows:
                run.append(f)
            else:
                groups.append(run)
                run = [f]
        groups.append(run)
        groups = [g for g in groups if g]
        if all(len(g) == 1 for g in groups):
            return self.versions[-1]  # nothing small enough to merge
        names = [c["name"] for c in self._columns]
        new_list: List[Fragment] = []
        replaced: List[Fragment] = []
        for g in groups:
            if len(g) == 1:
                new_list.append(g[0])
                continue
            readers = [self._reader_for(f) for f in g]
            table = {}
            for name in names:
                with self.scheduler.batch(f"compact:{name}",
                                          prefetch=True) as io:
                    parts = [r.scan_into(name, io) for r in readers]
                table[name] = A.concat(parts)
            merged = self._append_file(write_table(table, self.opts),
                                       label="compact")
            # _append_file put it at the tail of the live list; it belongs
            # at the group's position instead (it stays pending either way)
            self.fragments.pop()
            new_list.append(merged)
            replaced.extend(g)
        # renumber the row space (order of the new list defines global rows)
        row = 0
        final: List[Fragment] = []
        for f in new_list:
            final.append(dataclasses.replace(f, row_start=row))
            row += f.n_rows
        self.fragments = final
        m = self.commit()
        # retarget the shared cache: the replaced fragments' blocks are dead
        # weight for the live version (old versions re-fetch on demand)
        for f in replaced:
            b0 = f.base // self.store.sector
            b1 = (f.base + f.nbytes + self.store.sector - 1) // self.store.sector
            for lvl in self.store.levels:
                for bid in range(b0, b1):
                    if not lvl.cache.is_dirty(bid):
                        lvl.cache.invalidate(bid)
        return m

    # -- crash model ---------------------------------------------------------
    def simulate_crash(self) -> int:
        """Tear the unflushed state off the media and rewind to the last
        committed version: dirty blocks are discarded (counted as
        ``lost_bytes`` per tier) and their bytes inside *uncommitted*
        fragments are zeroed — committed fragments were flushed by their
        commit fence, so a shared boundary block can only lose its
        uncommitted tail.  Returns the number of bytes torn."""
        lost_extents = self.store.discard_dirty()
        self.tracer.instant(
            "simulated_crash", cat="writer",
            lost_extents=len(lost_extents), n_pending=len(self._pending))
        pend = [(f.base, f.base + f.nbytes) for f in self._pending]
        torn = 0
        for lo, hi in lost_extents:
            for plo, phi in pend:
                a, b = max(lo, plo), min(hi, phi)
                if a < b:
                    self.disk.zero(a, b)
                    torn += b - a
        self.fragments = list(self.versions[-1].fragments) \
            if self.versions else []
        self._pending = []
        if not self.versions:
            self._columns = None
        return torn

    # -- accounting ----------------------------------------------------------
    def io_stats(self, coalesce_gap: int = 0):
        """Logical *read* trace over the shared scheduler."""
        return self.scheduler.stats(coalesce_gap)

    def write_stats(self, coalesce_gap: int = 0):
        """Logical *write* trace (appends + compaction rewrites)."""
        return self.scheduler.write_stats(coalesce_gap)

    def tier_stats(self):
        """Per-tier dispatched IO incl. write/flush/dirty/lost accounting."""
        return self.store.tier_stats()

    def modelled_time(self, queue_depth: Optional[int] = None) -> float:
        return self.scheduler.model_time(queue_depth)

    def reset_io(self) -> None:
        self.scheduler.reset()

    def drop_caches(self) -> None:
        self.store.drop_caches()
