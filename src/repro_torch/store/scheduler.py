"""Batched IO scheduler + tiered store: the layer between the structural
encodings and the raw :class:`~repro_torch.core.io_sim.Disk`.

`FileReader` opens a :class:`ReadBatch` per ``take``/``scan`` and hands it
to the encoding readers; every logical read goes through
:meth:`ReadBatch.read` / :meth:`ReadBatch.read_many`, which serve bytes
synchronously (the data plane is the simulated disk) and record the request.
When the batch closes, the scheduler:

1. **coalesces** the batch's requests per dependency phase;
2. **aligns** each coalesced extent to device sectors;
3. **classifies** each sector against the cache hierarchy (RAM-hot →
   NVMe-warm → S3-cold) and dispatches per-tier, per-phase ops with
   queue-depth-limited round-trip pricing;
4. optionally runs **readahead** (scan batches) to pull upcoming sectors
   into the cache ahead of demand.

Accounting is two-plane by design: :meth:`IOScheduler.stats` reports the
*logical* trace, while :meth:`TieredStore.tier_stats` reports what each
*device* actually served (aligned bytes, hits/misses, prefetch).

A :class:`WriteBatch` is the write-side dual: bytes land on the disk at
once, and when the batch closes the scheduler coalesces its extents per
phase and hands them to the store's :class:`~repro_torch.store.FlushPolicy`
(write-through dispatch or dirty absorption; no policy attached behaves as
write-through).  :meth:`IOScheduler.write_stats` reports the logical write
trace.

This is the port's copy of the full store without the event-loop serving
plane (service windows, the virtual clock, per-request ids) and without
fault-aware admission: no port device carries a fault schedule, so
:meth:`TieredStore._admission_gated` keeps its call sites and always answers
False.  Both wait for ROADMAP.md, Queue 1 item 4b; tracer spans, counter
tracks and the metrics plane wait for item 5 (``obs``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.io_sim import (
    DRAM,
    NVME,
    S3,
    DeviceModel,
    Disk,
    IOStats,
    merge_phase_extents,
    trace_stats,
)
from .cache import BlockCache
from .flush import FlushPolicy
from .prefetch import SequentialReadahead
from .stats import DrainRecord, TierStats
from .workload import WorkloadStats

__all__ = ["CacheTier", "TieredStore", "ReadBatch", "WriteBatch",
           "IOScheduler", "make_store"]

DEFAULT_SECTOR = 4096
DEFAULT_CACHE_BYTES = 64 << 20


class CacheTier:
    """One cache level: a fast device pricing blocks resident in ``cache``."""

    def __init__(self, device: DeviceModel, cache: BlockCache, name: Optional[str] = None):
        self.device = device
        self.cache = cache
        self.stats = TierStats(name or device.name)


class TieredStore:
    """A stack of cache tiers (fastest first) over one backing device.

    The store prices reads; bytes always come from ``disk``.  A block served
    by tier i is admitted into every faster tier (inclusive promotion); a
    block missing everywhere is read from the backing device and admitted
    into all tiers.
    """

    def __init__(
        self,
        disk: Disk,
        backing: DeviceModel = NVME,
        levels: Sequence[CacheTier] = (),
        sector: int = DEFAULT_SECTOR,
    ):
        self.disk = disk
        self.backing = backing
        self.backing_stats = TierStats(backing.name)
        self.levels: List[CacheTier] = list(levels)
        self.sector = int(sector)
        self.flush_policy: Optional[FlushPolicy] = None
        # every completed queue drain, for per-request attribution
        self.drain_log: List[DrainRecord] = []
        for lvl in self.levels:
            if lvl.cache.block_bytes != self.sector:
                raise ValueError("cache block size must equal the store sector")

    def _admission_gated(self, source: DeviceModel) -> bool:
        """True when ``source`` is inside a fault window right now, so the
        block it serves is not admitted into faster tiers.  No port device
        carries a fault schedule (ROADMAP.md, Queue 1 item 4b), so no
        admission is ever gated."""
        return False

    # -- constructors -------------------------------------------------------
    @classmethod
    def flat(cls, disk: Disk, device: DeviceModel = NVME,
             sector: int = DEFAULT_SECTOR) -> "TieredStore":
        """Single-tier store: every read priced on ``device``."""
        return cls(disk, backing=device, levels=(), sector=sector)

    @classmethod
    def cached(
        cls,
        disk: Disk,
        backing: DeviceModel = S3,
        cache_device: DeviceModel = NVME,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        sector: int = DEFAULT_SECTOR,
        policy: str = "clock",
        admission: str = "always",
        cache: Optional[BlockCache] = None,
    ) -> "TieredStore":
        """The paper's deployment shape: an NVMe block cache over S3.

        Pass an existing ``cache`` to share one block cache (one NVMe
        budget) across several stores — valid only when the stores price
        reads over the same address space (the same :class:`Disk`, or a
        dataset's concatenated global disk), since block ids are plain
        sector numbers."""
        if cache is None:
            cache = BlockCache(cache_bytes, block_bytes=sector, policy=policy,
                               admission=admission)
        return cls(disk, backing=backing,
                   levels=(CacheTier(cache_device, cache),), sector=sector)

    @classmethod
    def hot(
        cls,
        disk: Disk,
        backing: DeviceModel = S3,
        ram_bytes: int = 8 << 20,
        nvme_bytes: int = DEFAULT_CACHE_BYTES,
        sector: int = DEFAULT_SECTOR,
    ) -> "TieredStore":
        """Three tiers: RAM-hot over NVMe-warm over S3-cold."""
        ram = BlockCache(ram_bytes, block_bytes=sector, policy="lru")
        nvme = BlockCache(nvme_bytes, block_bytes=sector, policy="clock")
        return cls(disk, backing=backing,
                   levels=(CacheTier(DRAM, ram), CacheTier(NVME, nvme)),
                   sector=sector)

    # -- dispatch ------------------------------------------------------------
    def dispatch_extent(self, lo: int, hi: int, phase: int,
                        prefetch: bool = False) -> None:
        """Price one coalesced extent: sector-align, classify each block
        against the hierarchy, dispatch contiguous same-tier runs."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return
        b0 = lo // self.sector
        b1 = (hi + self.sector - 1) // self.sector
        if not self.levels:
            self.backing_stats.add_op((b1 - b0) * self.sector, phase, prefetch)
            return
        # classify each block: index into levels, or len(levels) for backing
        run_tier: Optional[int] = None
        run_blocks = 0

        def flush() -> None:
            if run_blocks == 0:
                return
            nbytes = run_blocks * self.sector
            if run_tier == len(self.levels):
                self.backing_stats.add_op(nbytes, phase, prefetch)
            else:
                self.levels[run_tier].stats.add_op(nbytes, phase, prefetch)

        for bid in range(b0, b1):
            if prefetch:
                # readahead only fills holes; resident blocks are skipped
                # without touching hit/miss counters, and a fill is billed
                # to the backing tier only if the admission policy actually
                # kept it
                if any(bid in lvl.cache for lvl in self.levels):
                    tier = None
                elif self._admission_gated(self.backing):
                    tier = None
                else:
                    resident = False
                    for lvl in self.levels:
                        resident |= lvl.cache.admit(bid)
                    tier = len(self.levels) if resident else None
            else:
                tier = len(self.levels)
                for li, lvl in enumerate(self.levels):
                    if lvl.cache.lookup(bid):
                        tier = li
                        break
                # fill every tier faster than the one that served (on a
                # backing miss that is all of them)
                source = self.levels[tier].device if tier < len(self.levels) \
                    else self.backing
                if tier > 0 and not self._admission_gated(source):
                    for li in range(min(tier, len(self.levels))):
                        self.levels[li].cache.admit(bid)
            if tier != run_tier:
                flush()
                run_tier, run_blocks = tier, 0
            if tier is not None:
                run_blocks += 1
        flush()

    def end_batch(self, label: str = "io", n_requests: int = 0) -> None:
        """Archive every tier's open batch as one completed queue drain and
        log which (tier, phase) buckets it drained.  ``n_requests`` is the
        logical request count the batch carried (rows of a ``take``); 0
        means "unattributed" (scans, flushes)."""
        tiers: Dict[int, Tuple[Dict[int, int], Dict[int, int]]] = {}
        for idx, lvl in enumerate(self.levels):
            drained = lvl.stats.end_batch()
            if drained is not None:
                tiers[idx] = drained
        drained = self.backing_stats.end_batch()
        if drained is not None:
            tiers[len(self.levels)] = drained
        if tiers:
            self.drain_log.append(DrainRecord(label, int(n_requests), tiers))

    # -- write path ----------------------------------------------------------
    def set_flush_policy(self, policy: Optional[FlushPolicy]) -> None:
        """Attach the write-path policy (see :mod:`repro_torch.store.flush`)
        and wire the fastest tier's eviction hook so dirty victims are
        written back before their slot is reused (flush-on-evict, always
        on)."""
        self.flush_policy = policy
        if self.levels:
            if policy is None:
                self.levels[0].cache.on_evict = None
            else:
                self.levels[0].cache.on_evict = (
                    lambda bid, dirty: policy.on_evict(self, bid, dirty))

    def dispatch_write_extent(self, lo: int, hi: int, phase: int = 0,
                              flush: bool = False) -> None:
        """Price one sector-aligned write on the backing device and fill the
        written blocks clean into the cache tiers (a write-through fill:
        subsequent reads are warm; the fill bypasses the admission filter —
        admission polices *reads*, and these are the writer's own freshest
        bytes).  The flush path skips the fill (its blocks are already
        resident dirty)."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return
        b0 = lo // self.sector
        b1 = (hi + self.sector - 1) // self.sector
        if not flush:
            self.price_rmw(lo, hi, phase)
        self.backing_stats.add_write_op((b1 - b0) * self.sector, phase, flush)
        if not flush:
            for bid in range(b0, b1):
                for lvl in self.levels:
                    lvl.cache.fill(bid)

    def price_rmw(self, lo: int, hi: int, phase: int = 0) -> None:
        """Sub-sector write edges pay read-modify-write.

        A write extent that starts or ends mid-sector shares its edge
        sector with bytes already on media (the previous append's tail in
        the 8-aligned append-only layout); a sector-granular device cannot
        write part of a sector, so the merge needs the rest of the sector
        first.  If the edge block is resident in any cache tier (clean or
        dirty) the merge happens in cache for free.  Otherwise one
        sector-sized read is priced on the backing tier and counted in
        ``rmw_iops``/``rmw_bytes``.  The read lands in the phase bucket of
        the write it unblocks; the *logical* trace never sees it."""
        lo, hi = int(lo), int(hi)
        edges = []
        if lo % self.sector:
            edges.append(lo // self.sector)
        if hi % self.sector and hi < len(self.disk):
            bid = hi // self.sector
            if bid not in edges:
                edges.append(bid)
        for bid in edges:
            if any(bid in lvl.cache for lvl in self.levels):
                continue
            self.backing_stats.add_op(self.sector, phase)
            self.backing_stats.rmw_iops += 1
            self.backing_stats.rmw_bytes += self.sector

    def flush_all(self) -> int:
        """Commit barrier: make every dirty block durable (no-op without a
        write-back policy)."""
        if self.flush_policy is None:
            return 0
        return self.flush_policy.flush_all(self)

    def dirty_extents(self) -> List[Tuple[int, int]]:
        """Contiguous byte extents of the not-yet-durable blocks."""
        out: List[Tuple[int, int]] = []
        for lvl in self.levels:
            blocks = lvl.cache.dirty_blocks
            if not blocks:
                continue
            run_lo = prev = blocks[0]
            for b in blocks[1:]:
                if b != prev + 1:
                    out.append((run_lo * self.sector, (prev + 1) * self.sector))
                    run_lo = b
                prev = b
            out.append((run_lo * self.sector, (prev + 1) * self.sector))
        return out

    def discard_dirty(self) -> List[Tuple[int, int]]:
        """Simulated crash: every dirty block's unflushed bytes are lost.
        Drops the blocks from the cache, counts ``lost_bytes`` per tier,
        clears flush-policy state, and returns the lost byte extents so the
        caller can tear the corresponding media ranges."""
        extents = self.dirty_extents()
        for lvl in self.levels:
            blocks = lvl.cache.dirty_blocks
            lvl.stats.lost_bytes += len(blocks) * self.sector
            for bid in blocks:
                lvl.cache.invalidate(bid)
                if self.flush_policy is not None:
                    self.flush_policy.drop_block(bid)
        return extents

    # -- reporting -----------------------------------------------------------
    def tier_stats(self) -> List[TierStats]:
        """Per-tier stats, fastest first, backing device last.  Cache
        hit/miss/eviction counters are folded in from each level's cache.
        Returns detached snapshots — safe to hold across a later reset."""
        out: List[TierStats] = []
        for lvl in self.levels:
            s = lvl.stats
            s.hits = lvl.cache.hits
            s.misses = lvl.cache.misses
            s.evictions = lvl.cache.evictions
            s.dirty_bytes = lvl.cache.dirty_bytes
            out.append(s.snapshot())
        out.append(self.backing_stats.snapshot())
        return out

    def model_time(self, queue_depth: int = 256) -> float:
        """Modelled wall time: each tier serves its share; tiers on the miss
        path are serial, so the total is the sum of per-tier times."""
        t = self.backing_stats.model_time(self.backing, queue_depth)
        for lvl in self.levels:
            t += lvl.stats.model_time(lvl.device, queue_depth)
        return t

    def reset_stats(self) -> None:
        """Zero all counters; cache *contents* survive (warm tiers stay
        warm — resetting residency is :meth:`drop_caches`)."""
        self.backing_stats.reset()
        for lvl in self.levels:
            lvl.stats.reset()
            lvl.cache.reset_stats()
        self.drain_log = []

    def drop_caches(self) -> None:
        for lvl in self.levels:
            lvl.cache.drop()


class ReadBatch:
    """Handle for one ``take``/``scan``'s reads.  Serves bytes synchronously
    and records the logical trace; dispatch happens when the batch closes.
    ``prefetch`` marks a scan: readahead watches its requests."""

    def __init__(self, scheduler: "IOScheduler", label: str = "io",
                 prefetch: bool = False):
        self.scheduler = scheduler
        self.label = label
        self.prefetch = prefetch
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
        so spans from different files coalesce in the same per-phase pass
        and hit the same cache block ids."""
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
    data plane); accounting and durability are decided when the batch
    closes."""

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
    through the tiered store, and keeps the logical-trace accounting.

    ``readahead`` is a :class:`~repro_torch.store.SequentialReadahead`,
    ``None``, or ``"auto"``: a default readahead when the store has a cache
    level to fill, none otherwise."""

    def __init__(
        self,
        store: TieredStore,
        queue_depth: int = 256,
        readahead: Union[str, None, SequentialReadahead] = "auto",
    ):
        self.store = store
        self.queue_depth = int(queue_depth)
        if readahead == "auto":
            readahead = SequentialReadahead() if store.levels else None
        self.readahead = readahead or None
        self.workload = WorkloadStats()
        self.ops: List[Tuple[int, int, int]] = []
        self.write_ops: List[Tuple[int, int, int]] = []
        self._useful = 0
        self.n_batches = 0
        self.n_write_batches = 0

    def batch(self, label: str = "io", prefetch: bool = False) -> ReadBatch:
        return ReadBatch(self, label, prefetch=prefetch)

    def write_batch(self, label: str = "write") -> WriteBatch:
        return WriteBatch(self, label)

    def flush_barrier(self) -> int:
        """Commit-barrier flush of every dirty block; returns the blocks
        flushed."""
        return self.store.flush_all()

    def _finish_write(self, batch: WriteBatch) -> None:
        self.write_ops.extend(batch.ops)
        self.n_write_batches += 1
        extents = merge_phase_extents(batch.ops, gap=0)
        policy = self.store.flush_policy
        if policy is None:
            # unattached stores behave write-through: durable at batch close
            for phase in sorted(extents):
                for lo, hi in extents[phase]:
                    self.store.dispatch_write_extent(lo, hi, phase)
        else:
            policy.absorb(self.store, extents)
        self.store.end_batch(batch.label)
        if policy is not None:
            policy.on_batch_end(self.store)

    def _finish(self, batch: ReadBatch) -> None:
        self.ops.extend(batch.ops)
        self._useful += batch._useful
        self.n_batches += 1
        # Admission auto-select: fold this batch into the scan/take mix and
        # re-point any auto cache level *before* the batch dispatches, so a
        # scan arriving at a take-warmed cache is already policed.
        self.workload.note_batch(batch.label, batch.prefetch, len(batch.ops),
                                 sum(sz for _, sz, _ in batch.ops))
        policy = self.workload.preferred_admission()
        for lvl in self.store.levels:
            if lvl.cache.admission == "auto":
                lvl.cache.set_active_admission(policy)
        # Readahead watches the *raw request stream in arrival order* — what
        # a streaming scheduler sees as the reader issues its chunks — and
        # its fills land in the cache ahead of the demand drain, so the
        # demand extents below hit the warm tier instead of the backing one.
        if batch.prefetch and self.readahead is not None and self.store.levels:
            disk_len = len(self.store.disk)
            for o, sz, p in batch.ops:
                if sz <= 0:
                    continue
                pf = self.readahead.observe(o, o + sz)
                if pf is not None:
                    plo, phi = pf[0], min(pf[1], disk_len)
                    if phi > plo:
                        self.store.dispatch_extent(plo, phi, p, prefetch=True)
        extents = merge_phase_extents(batch.ops, gap=0)
        for phase in sorted(extents):
            for lo, hi in extents[phase]:
                self.store.dispatch_extent(lo, hi, phase)
        # each batch is its own queue drain: later batches pay their own
        # dependency round trips even though phase numbers restart at 0
        self.store.end_batch(batch.label, batch.n_requests)
        # the flush deadline is measured in batches; tick it for read
        # batches too so dirty data ages out under read-heavy mixes
        if self.store.flush_policy is not None:
            self.store.flush_policy.on_batch_end(self.store)

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
        self.workload.reset()
        if self.readahead is not None:
            self.readahead.reset()


def make_store(spec, disk: Disk) -> TieredStore:
    """Resolve a store spec: None/'flat' (NVMe), 'flat-s3' (cold object
    store), 'tiered' (NVMe cache over S3), 'tiered-auto' (same with
    workload-driven admission), 'hot' (RAM over NVMe over S3), a callable
    ``disk -> TieredStore``, or a ready instance (which must have been built
    over the same ``Disk`` so cache block ids stay meaningful — sharing one
    store across readers of the same disk is how they share one NVMe
    budget)."""
    if spec is None or spec == "flat":
        return TieredStore.flat(disk)
    if spec == "flat-s3":
        return TieredStore.flat(disk, device=S3)
    if spec == "tiered":
        return TieredStore.cached(disk)
    if spec == "tiered-auto":
        return TieredStore.cached(disk, admission="auto")
    if spec == "hot":
        return TieredStore.hot(disk)
    if isinstance(spec, TieredStore):
        if spec.disk is not disk:
            raise ValueError("store was built over a different disk")
        return spec
    if callable(spec):
        store = spec(disk)
        if not isinstance(store, TieredStore):
            raise TypeError("store factory must return a TieredStore")
        return store
    raise ValueError(f"unknown store spec {spec!r}")
