"""Batched IO scheduler over the flat store: the layer between the structural
encodings and the raw :class:`~repro_torch.core.io_sim.Disk`.

`FileReader` opens a :class:`ReadBatch` per ``take``/``scan`` and hands it
to the encoding readers; every logical read goes through
:meth:`ReadBatch.read` / :meth:`ReadBatch.read_many`, which serve bytes
synchronously (the data plane is the simulated disk) and record the request.
When the batch closes, the scheduler:

1. **coalesces** the batch's requests per dependency phase;
2. **aligns** each coalesced extent to device sectors;
3. **dispatches** each aligned extent on the backing device, priced with
   queue-depth-limited round trips.

Accounting is two-plane by design: :meth:`IOScheduler.stats` reports the
*logical* trace, while :meth:`TieredStore.tier_stats` reports what the
device actually served (aligned bytes).

This is the port's copy of the flat store (one backing device, no cache
tiers).  Cache tiers, readahead, the write path, tracing spans and the
event-loop serving plane come with the full store.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.io_sim import (
    NVME,
    S3,
    DeviceModel,
    Disk,
    IOStats,
    merge_phase_extents,
    trace_stats,
)
from .stats import DrainRecord, TierStats

__all__ = ["TieredStore", "ReadBatch", "IOScheduler", "make_store"]

DEFAULT_SECTOR = 4096


class TieredStore:
    """The flat store: every read priced on one backing device.

    The store prices reads; bytes always come from ``disk``.
    """

    def __init__(self, disk: Disk, backing: DeviceModel = NVME,
                 sector: int = DEFAULT_SECTOR):
        self.disk = disk
        self.backing = backing
        self.backing_stats = TierStats(backing.name)
        self.sector = int(sector)
        # every completed queue drain, for per-request attribution
        self.drain_log: List[DrainRecord] = []

    @classmethod
    def flat(cls, disk: Disk, device: DeviceModel = NVME,
             sector: int = DEFAULT_SECTOR) -> "TieredStore":
        """Single-tier store: every read priced on ``device``."""
        return cls(disk, backing=device, sector=sector)

    def dispatch_extent(self, lo: int, hi: int, phase: int) -> None:
        """Price one coalesced extent: sector-align and dispatch it on the
        backing device."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return
        b0 = lo // self.sector
        b1 = (hi + self.sector - 1) // self.sector
        self.backing_stats.add_op((b1 - b0) * self.sector, phase)

    def end_batch(self, label: str = "io", n_requests: int = 0) -> None:
        """Archive the open batch as one completed queue drain and log which
        (tier, phase) buckets it drained.  ``n_requests`` is the logical
        request count the batch carried (rows of a ``take``); 0 means
        "unattributed" (scans)."""
        drained = self.backing_stats.end_batch()
        if drained is not None:
            self.drain_log.append(DrainRecord(label, int(n_requests),
                                              {0: drained}))

    def tier_stats(self) -> List[TierStats]:
        """Per-tier stats (the backing device only).  Returns detached
        snapshots — safe to hold across a later reset."""
        return [self.backing_stats.snapshot()]

    def model_time(self, queue_depth: int = 256) -> float:
        """Modelled wall time of the dispatched trace on the backing device."""
        return self.backing_stats.model_time(self.backing, queue_depth)

    def reset_stats(self) -> None:
        """Zero all counters."""
        self.backing_stats.reset()
        self.drain_log = []


class ReadBatch:
    """Handle for one ``take``/``scan``'s reads.  Serves bytes synchronously
    and records the logical trace; dispatch happens when the batch closes."""

    def __init__(self, scheduler: "IOScheduler", label: str = "io"):
        self.scheduler = scheduler
        self.label = label
        self.ops: List[Tuple[int, int, int]] = []
        self._useful = 0
        self.n_requests = 0
        self._closed = False

    def read(self, offset: int, size: int, phase: int = 0) -> np.ndarray:
        if self._closed:
            raise RuntimeError("read on a closed ReadBatch")
        offset, size = int(offset), int(size)
        self.ops.append((offset, size, phase))
        return self.scheduler.store.disk.read(offset, size)

    def read_many(self, offsets, sizes, phase: int = 0):
        """Submit one phase-grouped batch of spans in a single dispatch.

        Records one logical op per span (accounting identical to N
        :meth:`read` calls) but serves all bytes with one vectorized gather.
        Returns ``(data, out_offsets)``: span ``k`` is
        ``data[out_offsets[k]:out_offsets[k + 1]]``.
        """
        if self._closed:
            raise RuntimeError("read on a closed ReadBatch")
        offsets = np.asarray(offsets, dtype=np.int64)
        sizes = np.asarray(sizes, dtype=np.int64)
        phase = int(phase)
        self.ops.extend(
            (o, s, phase) for o, s in zip(offsets.tolist(), sizes.tolist())
        )
        return self.scheduler.store.disk.read_gather(offsets, sizes)

    def note_useful(self, nbytes: int) -> None:
        self._useful += int(nbytes)

    def note_requests(self, n: int) -> None:
        """Declare how many logical requests (rows) this batch serves.
        Purely observational — never feeds back into coalescing or
        pricing."""
        self.n_requests += int(n)

    def at(self, base: int):
        """A view of this batch translated by ``base`` bytes.

        Encoding readers always issue file-local offsets; when several files
        share one scheduler (``repro_torch.dataset``) each file's reads are
        rebased into the dataset's global address space through this view,
        so spans from different files coalesce in the same per-phase pass."""
        return self if not base else _OffsetBatch(self, int(base))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.scheduler._finish(self)

    def __enter__(self) -> "ReadBatch":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _OffsetBatch:
    """Thin rebasing proxy over a :class:`ReadBatch` (see its ``at``)."""

    __slots__ = ("_batch", "base")

    def __init__(self, batch, base: int):
        self._batch = batch
        self.base = base

    def read(self, offset: int, size: int, phase: int = 0) -> np.ndarray:
        return self._batch.read(self.base + int(offset), size, phase)

    def read_many(self, offsets, sizes, phase: int = 0):
        offsets = np.asarray(offsets, dtype=np.int64) + self.base
        return self._batch.read_many(offsets, sizes, phase)

    def note_useful(self, nbytes: int) -> None:
        self._batch.note_useful(nbytes)

    def note_requests(self, n: int) -> None:
        self._batch.note_requests(n)

    def at(self, base: int):
        return self._batch.at(self.base + int(base))


class IOScheduler:
    """Accepts whole read batches, coalesces per phase, dispatches through
    the store, and keeps the logical-trace accounting."""

    def __init__(self, store: TieredStore, queue_depth: int = 256):
        self.store = store
        self.queue_depth = int(queue_depth)
        self.ops: List[Tuple[int, int, int]] = []
        self._useful = 0
        self.n_batches = 0

    def batch(self, label: str = "io") -> ReadBatch:
        return ReadBatch(self, label)

    def _finish(self, batch: ReadBatch) -> None:
        self.ops.extend(batch.ops)
        self._useful += batch._useful
        self.n_batches += 1
        extents = merge_phase_extents(batch.ops, gap=0)
        for phase in sorted(extents):
            for lo, hi in extents[phase]:
                self.store.dispatch_extent(lo, hi, phase)
        # each batch is its own queue drain: later batches pay their own
        # dependency round trips even though phase numbers restart at 0
        self.store.end_batch(batch.label, batch.n_requests)

    # -- accounting ----------------------------------------------------------
    def stats(self, coalesce_gap: int = 0) -> IOStats:
        """Logical-trace stats."""
        return trace_stats(self.ops, self._useful, coalesce_gap)

    def tier_stats(self) -> List[TierStats]:
        return self.store.tier_stats()

    def model_time(self, queue_depth: Optional[int] = None) -> float:
        if queue_depth is None:
            queue_depth = self.queue_depth
        return self.store.model_time(queue_depth)

    def reset(self) -> None:
        self.ops = []
        self._useful = 0
        self.n_batches = 0
        self.store.reset_stats()


def make_store(spec, disk: Disk) -> TieredStore:
    """Resolve a store spec: None/'flat' (NVMe) or 'flat-s3' (cold object
    store).  The cached specs ('tiered', 'tiered-auto', 'hot', a factory or
    a ready store) come with the full store."""
    if spec is None or spec == "flat":
        return TieredStore.flat(disk)
    if spec == "flat-s3":
        return TieredStore.flat(disk, device=S3)
    raise NotImplementedError(
        f"store spec {spec!r} is not ported yet (ROADMAP.md, Queue 1: the "
        "full store)")

