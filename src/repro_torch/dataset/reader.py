"""Multi-file dataset reader: many Lance fragments, one IO path.

``DatasetReader`` opens every fragment against **one** shared
:class:`~repro_torch.store.TieredStore` + :class:`~repro_torch.store.IOScheduler`
over the dataset's concatenated global address space (see
:mod:`repro_torch.dataset.manifest`):

* ``take(column, global_rows)`` vector-maps rows to fragments (searchsorted
  over fragment row starts), fans out per-fragment batched leaf takes that
  all enqueue into **one** scheduler batch — spans from different files
  coalesce per dependency phase and the whole take is priced as a single
  queue drain — then stitches the per-fragment leaves together and restores
  request order with one shared
  :func:`~repro_torch.core.encodings_base.reorder_leaf_rows` permutation;
* ``scan(column)`` streams every fragment through one prefetch-flagged
  batch, so ``SequentialReadahead`` sees a single global request stream and
  keeps reading ahead **across fragment boundaries** (the inter-file gap is
  just a footer, far below the readahead's ``max_gap``);
* the scheduler's :class:`~repro_torch.store.WorkloadStats` watches the
  dataset's scan/take mix and auto-selects the admission policy of any
  cache level configured ``admission="auto"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core import arrays as A
from ..core.encodings_base import concat_leaves, reorder_leaf_rows
from ..core.file import FileReader, type_from_dict
from ..core.io_sim import DiskView
from ..core.shred import unshred

from .manifest import Manifest, build_dataset_disk

__all__ = ["DatasetReader"]


class DatasetReader:
    """Reads a fragmented Lance dataset behind one shared store/scheduler.

    ``files`` is the ordered fragment list (raw file bytes).  ``store``
    accepts the same specs as :func:`repro_torch.store.make_store`, resolved
    once over the dataset's global disk, so "tiered" gives the whole dataset
    a single NVMe budget.  ``decode``, ``dict_cached`` and ``device`` are
    passed to every fragment's :class:`~repro_torch.core.file.FileReader`:
    ``dict_cached`` keeps a Parquet column's dictionary page in the search
    cache, and the device routes run on CUDA unless ``device="cpu"``.  ``tracer`` is
    the IO path's (:class:`~repro_torch.obs.Tracer`; None traces nothing).
    """

    def __init__(self, files: Sequence[bytes], store=None,
                 queue_depth: int = 256, readahead="auto",
                 decode: Optional[str] = None, dict_cached: bool = False,
                 tracer=None, *, device=None):
        from ..store import IOScheduler, make_store

        manifest, disk = build_dataset_disk(files)
        scheduler = IOScheduler(make_store(store, disk),
                                queue_depth=queue_depth, readahead=readahead,
                                tracer=tracer)
        self._bind(manifest, disk, scheduler, decode=decode,
                   dict_cached=dict_cached, device=device)

    @classmethod
    def from_manifest(cls, manifest: Manifest, disk, scheduler,
                      decode: Optional[str] = None, dict_cached: bool = False,
                      readers: Optional[List[FileReader]] = None, *,
                      device=None) -> "DatasetReader":
        """View an already-materialized dataset (a manifest *version* over a
        shared disk + scheduler) without rebuilding the address space.  The
        dataset writer uses this for time travel: one reader per committed
        version, all sharing the writer's store/cache.  ``readers`` supplies
        pre-built per-fragment ``FileReader``\\ s (cached by the writer so a
        fragment's footer is parsed once, not once per version)."""
        self = cls.__new__(cls)
        self._bind(manifest, disk, scheduler, decode=decode,
                   dict_cached=dict_cached, device=device, readers=readers)
        return self

    def _bind(self, manifest, disk, scheduler, decode=None, dict_cached=False,
              device=None, readers=None):
        self.manifest = manifest
        self.disk = disk
        self.store = scheduler.store
        self.scheduler = scheduler
        self.tracer = scheduler.tracer
        self.fragments: List[FileReader] = readers if readers is not None else [
            FileReader(DiskView(self.disk, f.base, f.nbytes),
                       scheduler=self.scheduler, base=f.base,
                       decode=decode, dict_cached=dict_cached, device=device)
            for f in self.manifest.fragments
        ]
        self.columns = self.fragments[0].columns

    @property
    def device(self):
        """The device the fragments' decode routes run on."""
        return self.fragments[0].device

    # -- geometry ------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.manifest.n_rows

    @property
    def n_fragments(self) -> int:
        return self.manifest.n_fragments

    def locate(self, rows):
        """Vector-map global row ids to ``(fragment index, local row)``."""
        return self.manifest.locate(rows)

    # -- public API ----------------------------------------------------------
    def take(self, name: str, rows) -> A.Array:
        """Random access by *global* row ids (any order, duplicates fine).

        One scheduler batch covers every fragment's reads, so per-phase
        coalescing and queue-depth pricing see the union of all files'
        spans; the result is bit-identical to running each fragment's take
        separately and reassembling.
        """
        rows = np.asarray(rows, dtype=np.int64)
        col = self.columns[name]
        if len(rows) == 0:
            return self.fragments[0].take(name, rows)
        tr = self.tracer
        with tr.step("dataset.locate"):
            fi, local = self.locate(rows)
            # concat order = request rows stably grouped by fragment; inv maps
            # each request position to its row in that concatenation
            perm = np.argsort(fi, kind="stable")
            inv = np.empty(len(perm), dtype=np.int64)
            inv[perm] = np.arange(len(perm), dtype=np.int64)
            frag_ids = np.unique(fi)
        with tr.span(f"dataset.take:{name}", cat="reader", n_rows=len(rows),
                     n_fragments=len(frag_ids)) as sp, tr.usage("dataset", sp):
            with self.scheduler.batch(f"take:{name}") as io:
                # the global rows are the logical requests of this drain
                io.note_requests(len(rows))
                parts = [
                    self.fragments[f].take_leaves(name, local[fi == f], io)
                    for f in frag_ids
                ]
            with tr.step("dataset.assemble"):
                if col["kind"] in ("arrow", "packed"):
                    return A.concat(parts).take(inv)
                n_leaves = len(parts[0])
                leaves = [
                    reorder_leaf_rows(concat_leaves([p[k] for p in parts]), inv)
                    for k in range(n_leaves)
                ]
                return unshred(leaves, type_from_dict(col["type"]))

    def scan(self, name: str, io_chunk: int = 8 << 20) -> A.Array:
        """Full-column scan across all fragments, in global row order."""
        tr = self.tracer
        with tr.span(f"dataset.scan:{name}", cat="reader",
                     n_fragments=len(self.fragments)) as sp, tr.usage("dataset", sp):
            with self.scheduler.batch(f"scan:{name}", prefetch=True) as io:
                parts = [fr.scan_into(name, io, io_chunk=io_chunk)
                         for fr in self.fragments]
            with tr.step("dataset.assemble"):
                return A.concat(parts)

    # -- accounting ----------------------------------------------------------
    def io_stats(self, coalesce_gap: int = 0):
        """Logical-trace stats over the shared scheduler (all fragments)."""
        return self.scheduler.stats(coalesce_gap)

    def tier_stats(self):
        """Per-tier dispatched-IO stats of the shared store."""
        return self.store.tier_stats()

    def modelled_time(self, queue_depth: Optional[int] = None) -> float:
        return self.scheduler.model_time(queue_depth)

    def workload_stats(self):
        """The shared scheduler's scan/take mix observer."""
        return self.scheduler.workload

    def search_cache_bytes(self, name: Optional[str] = None) -> int:
        return sum(fr.search_cache_bytes(name) for fr in self.fragments)

    def data_bytes(self, name: Optional[str] = None) -> int:
        return sum(fr.data_bytes(name) for fr in self.fragments)

    def reset_io(self) -> None:
        """Zero trace/tier counters; cache residency survives (warm stays
        warm — :meth:`drop_caches` is the cold restart)."""
        self.scheduler.reset()

    def drop_caches(self) -> None:
        self.store.drop_caches()
