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

A :class:`WriteBatch` is the write-side dual: bytes land on the disk at
once, and when the batch closes the scheduler coalesces its extents per
phase and dispatches them write-through on the backing device (sub-sector
edges pay a read-modify-write read).  :meth:`IOScheduler.write_stats`
reports the logical write trace.

This is the port's copy of the flat store (one backing device, no cache
tiers, writes durable at batch close).  Cache tiers, readahead, flush
policies and the event-loop serving plane wait for ROADMAP.md, Queue 1
item 4 (the full store); tracing spans for item 5 (``obs``).
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

__all__ = ["TieredStore", "ReadBatch", "WriteBatch", "IOScheduler",
           "make_store"]

DEFAULT_SECTOR = 4096
_FULL_STORE = "ROADMAP.md, Queue 1 item 4: the full store"


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
        # write path: the flat store writes through (no policy attached)
        self.flush_policy = None
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

    # -- write path ----------------------------------------------------------
    def set_flush_policy(self, policy) -> None:
        """Attach a write-path policy.  Only ``None`` (write-through: every
        write durable at batch close) is ported; flush policies need cache
        tiers to hold dirty blocks."""
        if policy is not None:
            raise NotImplementedError(
                f"flush policy {policy!r} is not ported yet ({_FULL_STORE})")
        self.flush_policy = None

    def dispatch_write_extent(self, lo: int, hi: int, phase: int = 0,
                              flush: bool = False) -> None:
        """Price one sector-aligned write on the backing device.  A demand
        write (not a flush) first pays read-modify-write on its sub-sector
        edges (:meth:`price_rmw`)."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return
        b0 = lo // self.sector
        b1 = (hi + self.sector - 1) // self.sector
        if not flush:
            self.price_rmw(lo, hi, phase)
        self.backing_stats.add_write_op((b1 - b0) * self.sector, phase, flush)

    def price_rmw(self, lo: int, hi: int, phase: int = 0) -> None:
        """Sub-sector write edges pay read-modify-write.

        A write extent that starts or ends mid-sector shares its edge sector
        with bytes already on media (the previous append's tail in the
        8-aligned append-only layout); a sector-granular device cannot write
        part of a sector, so the merge reads the rest of the sector first:
        one sector-sized read on the backing tier (the flat store caches
        nothing, so it is always a miss), counted in ``rmw_iops`` /
        ``rmw_bytes``.  The read lands in the phase bucket of the write it
        unblocks; the *logical* trace never sees it."""
        lo, hi = int(lo), int(hi)
        edges = []
        if lo % self.sector:
            edges.append(lo // self.sector)
        if hi % self.sector and hi < len(self.disk):
            bid = hi // self.sector
            if bid not in edges:
                edges.append(bid)
        for _ in edges:
            self.backing_stats.add_op(self.sector, phase)
            self.backing_stats.rmw_iops += 1
            self.backing_stats.rmw_bytes += self.sector

    def flush_all(self) -> int:
        """Commit barrier: make every dirty block durable.  Write-through
        leaves nothing dirty, so it flushes nothing."""
        return 0

    def discard_dirty(self) -> List[Tuple[int, int]]:
        """Simulated crash: the byte extents of unflushed blocks, which the
        caller tears off the media.  Write-through leaves none."""
        return []

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


class WriteBatch:
    """Handle for one append/ingest operation's writes.  Mirrors
    :class:`ReadBatch`: bytes land on the simulated disk synchronously (the
    data plane); accounting is decided when the batch closes, where the
    scheduler coalesces the extents per phase and dispatches them
    write-through."""

    def __init__(self, scheduler: "IOScheduler", label: str = "write"):
        self.scheduler = scheduler
        self.label = label
        self.ops: List[Tuple[int, int, int]] = []
        self._closed = False

    def write(self, offset: int, data, phase: int = 0) -> None:
        if self._closed:
            raise RuntimeError("write on a closed WriteBatch")
        offset = int(offset)
        self.scheduler.store.disk.write(offset, data)
        self.ops.append((offset, len(data), phase))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.scheduler._finish_write(self)

    def __enter__(self) -> "WriteBatch":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class IOScheduler:
    """Accepts whole read and write batches, coalesces per phase, dispatches
    through the store, and keeps the logical-trace accounting."""

    def __init__(self, store: TieredStore, queue_depth: int = 256):
        self.store = store
        self.queue_depth = int(queue_depth)
        self.ops: List[Tuple[int, int, int]] = []
        self.write_ops: List[Tuple[int, int, int]] = []
        self._useful = 0
        self.n_batches = 0
        self.n_write_batches = 0

    def batch(self, label: str = "io") -> ReadBatch:
        return ReadBatch(self, label)

    def write_batch(self, label: str = "write") -> WriteBatch:
        return WriteBatch(self, label)

    def flush_barrier(self) -> int:
        """Commit-barrier flush of every dirty block (none on the flat
        store); returns the blocks flushed."""
        return self.store.flush_all()

    def _finish_write(self, batch: WriteBatch) -> None:
        self.write_ops.extend(batch.ops)
        self.n_write_batches += 1
        extents = merge_phase_extents(batch.ops, gap=0)
        # no flush policy: durable at batch close (write-through)
        for phase in sorted(extents):
            for lo, hi in extents[phase]:
                self.store.dispatch_write_extent(lo, hi, phase)
        self.store.end_batch(batch.label)

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
        """Logical-trace stats.  Reads only — the write trace is
        :meth:`write_stats`."""
        return trace_stats(self.ops, self._useful, coalesce_gap)

    def write_stats(self, coalesce_gap: int = 0) -> IOStats:
        """Logical *write* trace (ingest side), same accounting shape."""
        return trace_stats(self.write_ops, 0, coalesce_gap)

    def tier_stats(self) -> List[TierStats]:
        return self.store.tier_stats()

    def model_time(self, queue_depth: Optional[int] = None) -> float:
        if queue_depth is None:
            queue_depth = self.queue_depth
        return self.store.model_time(queue_depth)

    def reset(self) -> None:
        self.ops = []
        self.write_ops = []
        self._useful = 0
        self.n_batches = 0
        self.n_write_batches = 0
        self.store.reset_stats()


def make_store(spec, disk: Disk) -> TieredStore:
    """Resolve a store spec: None/'flat' (NVMe) or 'flat-s3' (cold object
    store).  The cached specs ('tiered', 'tiered-auto', 'hot', a factory or
    a ready store) wait for the full store."""
    if spec is None or spec == "flat":
        return TieredStore.flat(disk)
    if spec == "flat-s3":
        return TieredStore.flat(disk, device=S3)
    raise NotImplementedError(
        f"store spec {spec!r} is not ported yet ({_FULL_STORE})")

