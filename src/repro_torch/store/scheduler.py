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

The scheduler also carries the event-loop serving plane: outside a service
window each drain completes at its serial price on a virtual clock
(``vclock``); inside one (:meth:`IOScheduler.service_window`) drains become
event-loop jobs tagged with their request.  A tracer and a metrics plane
observe the pipeline and never steer it.
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
    gather_route,
    merge_phase_extents,
    trace_stats,
)
from ..obs.timeseries import NULL_PLANE, MetricsPlane
from ..obs.trace import NULL_TRACER
from .cache import BlockCache
from .evloop import (JobCompletion, QoS, RetryPolicy, ServiceWindow,
                     build_job)
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
        # Observability: drain_log records every completed queue drain (for
        # per-request attribution, always on — it is pure bookkeeping and
        # never feeds back into pricing); tracer is the span sink threaded
        # down from the IOScheduler (NULL_TRACER = disabled, zero-cost).
        self.drain_log: List[DrainRecord] = []
        self.tracer = NULL_TRACER
        # Fault-aware admission: when the *source* tier of a fetch has an
        # open fault window at the current virtual time, the block is
        # served but NOT admitted into faster tiers — brownout traffic is
        # slow-path evidence, not working-set evidence, and admitting it
        # evicts genuinely hot blocks.  ``fault_clock`` is installed by the
        # IOScheduler (window arrival time inside a service window, the
        # virtual clock otherwise); ``None`` means no clock — admission is
        # gated only when a device actually carries faults, so stores whose
        # devices are healthy (every committed baseline) are bit-identical.
        self.fault_clock = None
        self.admission_fault_skips = 0
        for lvl in self.levels:
            if lvl.cache.block_bytes != self.sector:
                raise ValueError("cache block size must equal the store sector")

    def _admission_gated(self, source: DeviceModel) -> bool:
        """True when ``source`` is inside a fault window right now (skip
        admission).  Zero-cost on healthy devices: the faults tuple is
        empty and the clock is never consulted."""
        if not source.faults:
            return False
        t = self.fault_clock() if self.fault_clock is not None else 0.0
        if source.fault_active_at(t):
            self.admission_fault_skips += 1
            return True
        return False

    # -- constructors -------------------------------------------------------
    @classmethod
    def flat(cls, disk: Disk, device: DeviceModel = NVME,
             sector: int = DEFAULT_SECTOR) -> "TieredStore":
        """Single-tier store: every read priced on ``device`` (the seed
        repo's behaviour)."""
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
                # kept it (the scheduler consults admission before issuing)
                if any(bid in lvl.cache for lvl in self.levels):
                    tier = None
                elif self._admission_gated(self.backing):
                    # a browned-out backing tier gets no speculative fills
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
                # backing miss that is all of them) — unless the serving
                # tier is inside a fault window (fault-aware admission)
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
        log which (tier, phase) buckets it drained — the substrate
        :func:`repro_torch.obs.attribute` decomposes ``model_time`` over.
        ``n_requests`` is the logical request count the batch carried (rows
        of a ``take``); 0 means "unattributed" (scans, flushes)."""
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
        """Attach the write-path policy (see :mod:`repro_torch.store.flush`) and
        wire the fastest tier's eviction hook so dirty victims are written
        back before their slot is reused (flush-on-evict, always on)."""
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
        dirty) the merge happens in cache for free — that is exactly why
        write-through fills and write-back dirty residency suppress repeat
        RMW on a hot append point.  Otherwise one sector-sized read is
        priced on the backing tier (it is a miss everywhere) and counted in
        ``rmw_iops``/``rmw_bytes``.  The read lands in the same phase
        bucket as the write it unblocks, so drains, ``model_time``,
        attribution and the event loop all see it; the *logical* trace
        never does — RMW is a device artifact, not a request."""
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
        Drops the blocks from the cache (their contents are no longer
        trustworthy), counts ``lost_bytes`` per tier, clears flush-policy
        state, and returns the lost byte extents so the caller can tear the
        corresponding media ranges."""
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
        self.admission_fault_skips = 0

    def drop_caches(self) -> None:
        for lvl in self.levels:
            lvl.cache.drop()


class ReadBatch:
    """Handle for one ``take``/``scan``'s reads.  Serves bytes synchronously
    and records the logical trace; dispatch happens when the batch closes."""

    def __init__(self, scheduler: "IOScheduler", label: str = "io",
                 prefetch: bool = False):
        self.scheduler = scheduler
        self.label = label
        self.prefetch = prefetch
        self.request: Optional[str] = None  # stamped by IOScheduler.batch
        self.ops: List[Tuple[int, int, int]] = []
        self._useful = 0
        self.n_requests = 0
        self._closed = False

    @property
    def tracer(self):
        """The IO path's tracer — encoding readers reach it through the
        batch handle to emit decode-route (pallas fallback) events."""
        return self.scheduler.tracer

    def read(self, offset: int, size: int, phase: int = 0) -> np.ndarray:
        if self._closed:
            raise RuntimeError("read on a closed ReadBatch")
        offset, size = int(offset), int(size)
        self.ops.append((offset, size, phase))
        with self.scheduler.tracer.step("store.read", bytes=size):
            return self.scheduler.store.disk.read(offset, size)

    def read_many(self, offsets, sizes, phase: int = 0):
        """Submit one phase-grouped batch of spans in a single dispatch.

        Records one logical op per span (accounting identical to N
        :meth:`read` calls) but serves all bytes with one
        :meth:`~repro_torch.core.io_sim.Disk.read_gather`, its spans counted
        under the route that copied them (``store.gather_spans.strided``,
        ``.sliced`` or ``.indexed``; see :func:`gather_route`).
        Returns ``(data, out_offsets)``: span ``k`` is
        ``data[out_offsets[k]:out_offsets[k + 1]]``.  This is the batched
        ``take`` pipeline's entry point — cross-row coalescing happens once
        per phase at batch close instead of N times.
        """
        if self._closed:
            raise RuntimeError("read on a closed ReadBatch")
        offsets = np.asarray(offsets, dtype=np.int64)
        sizes = np.asarray(sizes, dtype=np.int64)
        phase = int(phase)
        self.ops.extend(
            (o, s, phase) for o, s in zip(offsets.tolist(), sizes.tolist())
        )
        disk, tr = self.scheduler.store.disk, self.scheduler.tracer
        route = gather_route(sizes, disk.file_backed)
        with tr.step("store.gather", n_spans=len(sizes), route=route):
            out = disk.read_gather(offsets, sizes)
        tr.tally(f"store.gather_spans.{route}", len(sizes))
        return out

    def note_useful(self, nbytes: int) -> None:
        self._useful += int(nbytes)

    def note_requests(self, n: int) -> None:
        """Declare how many logical requests (rows) this batch serves; the
        drain's modeled cost is attributed across them
        (:func:`repro_torch.obs.attribute`).  Purely observational — never feeds
        back into coalescing or pricing."""
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

    @property
    def tracer(self):
        return self._batch.tracer

    def at(self, base: int):
        return self._batch.at(self.base + int(base))


class WriteBatch:
    """Handle for one append/ingest operation's writes.  Mirrors
    :class:`ReadBatch`: bytes land on the simulated disk synchronously (the
    data plane), accounting and durability are decided when the batch closes
    — the scheduler coalesces the write extents per phase and hands them to
    the store's :class:`~repro_torch.store.FlushPolicy` (write-through dispatch or
    dirty absorption; no policy attached behaves as write-through)."""

    def __init__(self, scheduler: "IOScheduler", label: str = "write"):
        self.scheduler = scheduler
        self.label = label
        self.request: Optional[str] = None  # stamped by write_batch
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
    """Accepts whole read batches, coalesces per phase, dispatches through
    the tiered store, and keeps the legacy logical-trace accounting."""

    def __init__(
        self,
        store: TieredStore,
        queue_depth: int = 256,
        readahead: Union[str, None, SequentialReadahead] = "auto",
        tracer=None,
        queue_depths: Optional[Dict[str, int]] = None,
        plane: MetricsPlane = NULL_PLANE,
        retry_policy: Optional[RetryPolicy] = RetryPolicy(),
    ):
        self.store = store
        self.queue_depth = int(queue_depth)
        # per-device-name depth overrides (e.g. {"nvme": 64, "s3": 8});
        # unnamed devices fall back to the shared queue_depth.  Used by
        # serial pricing here and inherited by ServiceWindow.run().
        self.queue_depths = dict(queue_depths) if queue_depths else None
        # Recovery policy inherited by ServiceWindow.run(): compiled in by
        # default, but only ever consulted on tiers whose fault schedule
        # can fail ops, so healthy-path pricing stays bit-identical.
        self.retry_policy = retry_policy
        # live metrics plane: store-side gauges (cache hit rate, dirty
        # bytes, admission state) sampled at batch close on the virtual
        # clock.  NULL_PLANE (the default) collects nothing.
        self.plane = plane if plane is not None else NULL_PLANE
        if readahead == "auto":
            readahead = SequentialReadahead() if store.levels else None
        self.readahead = readahead or None
        # One tracer per IO path: passing one here threads it through the
        # store (flush-policy spans) and every reader sharing this
        # scheduler.  Default is the store's (NULL_TRACER unless set) so
        # injected-scheduler readers inherit the path's tracer.
        if tracer is not None:
            store.tracer = tracer
        self.tracer = store.tracer
        self.workload = WorkloadStats()
        self.ops: List[Tuple[int, int, int]] = []
        self.write_ops: List[Tuple[int, int, int]] = []
        self._useful = 0
        self.n_batches = 0
        self.n_write_batches = 0
        # Event-loop serving plane (pure timing overlay — never feeds back
        # into classification or pricing).  Outside a service window every
        # drain completes immediately at its serial price on the virtual
        # clock; inside one, drains become Jobs the window simulates.
        self.vclock = 0.0
        self.completions: List[JobCompletion] = []
        self._window: Optional[ServiceWindow] = None
        self._request_seq = 0
        self._job_seq = 0
        # fault-aware admission reads the serving plane's notion of "now":
        # the current request's arrival inside a service window, the
        # virtual clock outside one
        store.fault_clock = self._fault_now

    def _fault_now(self) -> float:
        win = self._window
        if win is not None and getattr(win, "_arrival", None) is not None:
            return win._arrival
        return self.vclock

    def batch(self, label: str = "io", prefetch: bool = False) -> ReadBatch:
        rb = ReadBatch(self, label, prefetch=prefetch)
        self._request_seq += 1
        rb.request = f"{label}#{self._request_seq}"
        win = self._window
        if win is not None and win._cur is not None and win._cur.request:
            rb.request = win._cur.request
        return rb

    def write_batch(self, label: str = "write") -> WriteBatch:
        wb = WriteBatch(self, label)
        self._request_seq += 1
        wb.request = f"{label}#{self._request_seq}"
        return wb

    def service_window(self, qos: Optional[QoS] = None) -> ServiceWindow:
        """Open a multi-request serving window: drains completed inside it
        are captured as event-loop jobs (tagged per request via
        ``window.request(tenant=..., at=...)``) and priced together by
        ``window.run("interleaved")`` / ``run("serial")`` — the same
        executed workload under both dispatch models."""
        return ServiceWindow(self, qos)

    def _devices(self) -> List[DeviceModel]:
        """Tier devices in drain-record index order (levels, then backing)."""
        return [lvl.device for lvl in self.store.levels] + [self.store.backing]

    def flush_barrier(self) -> int:
        """Commit-barrier flush routed through the serving plane.

        ``TieredStore.flush_all`` records its drains but runs outside any
        batch close, so calling it directly would leave the barrier's write
        runs invisible to the virtual clock and to an open service window.
        This wrapper lifts them like every other drain — inside a window
        the flush becomes one more job sharing the device queues with the
        in-flight reads, which is exactly the read/flush interleaving the
        event loop prices."""
        n0 = len(self.store.drain_log)
        n = self.store.flush_all()
        self._ingest_drains(n0, request="flush:barrier")
        return n

    def _ingest_drains(self, n0: int, request: Optional[str] = None) -> None:
        """Lift every drain the closing batch appended (its own, plus any
        flush drains its close triggered) into the serving plane."""
        log = self.store.drain_log
        if len(log) <= n0:
            return
        win = self._window
        for rec in log[n0:]:
            self._job_seq += 1
            job = build_job(rec, self._devices(), request=request,
                            seq=self._job_seq, submit=self.vclock)
            if win is not None:
                win._submit(job)
            else:
                done = self.vclock + job.serial_time(self.queue_depth,
                                                     self.queue_depths)
                self.completions.append(JobCompletion(
                    rec.label, job.tenant, request, rec.n_requests,
                    self.vclock, done))
                self.vclock = done

    def _finish_write(self, batch: WriteBatch) -> None:
        tr = self.tracer
        n0 = len(self.store.drain_log)
        # every batch gets its own Perfetto track so concurrent requests
        # render as separate lanes instead of one flat span stream
        tid = tr.track(batch.request) if tr.enabled else None
        with tr.span(f"write:{batch.label}", cat="scheduler", tid=tid,
                     n_ops=len(batch.ops), request=batch.request,
                     bytes=sum(sz for _, sz, _ in batch.ops)):
            self.write_ops.extend(batch.ops)
            self.n_write_batches += 1
            extents = merge_phase_extents(batch.ops, gap=0)
            policy = self.store.flush_policy
            if policy is None:
                # unattached stores behave write-through: durable at batch
                # close
                with tr.span("dispatch:write-through", cat="scheduler",
                             tid=tid):
                    for phase in sorted(extents):
                        for lo, hi in extents[phase]:
                            self.store.dispatch_write_extent(lo, hi, phase)
            else:
                with tr.span("absorb", cat="flush", tid=tid):
                    policy.absorb(self.store, extents)
            self.store.end_batch(batch.label)
            if policy is not None:
                policy.on_batch_end(self.store)
            self._ingest_drains(n0, request=batch.request)
        if tr.enabled:
            self._sample_counters()
        if self.plane.enabled:
            self._sample_plane()

    def _finish(self, batch: ReadBatch) -> None:
        tr = self.tracer
        n0 = len(self.store.drain_log)
        logical_bytes = sum(sz for _, sz, _ in batch.ops)
        # per-request track id: concurrent takers get separate Perfetto
        # lanes (the request id is also stamped into args for filtering)
        tid = tr.track(batch.request) if tr.enabled else None
        with tr.span(f"drain:{batch.label}", cat="scheduler", tid=tid,
                     n_ops=len(batch.ops), bytes=logical_bytes,
                     n_requests=batch.n_requests, prefetch=batch.prefetch,
                     request=batch.request):
            self.ops.extend(batch.ops)
            self._useful += batch._useful
            self.n_batches += 1
            # Admission auto-select: fold this batch into the scan/take mix
            # and re-point any auto cache level *before* the batch
            # dispatches, so a scan arriving at a take-warmed cache is
            # already policed.
            self.workload.note_batch(batch.label, batch.prefetch,
                                     len(batch.ops), logical_bytes)
            policy = self.workload.preferred_admission()
            for lvl in self.store.levels:
                if lvl.cache.admission == "auto":
                    before = lvl.cache.active_admission
                    lvl.cache.set_active_admission(policy)
                    if tr.enabled and lvl.cache.active_admission != before:
                        tr.instant("admission_flip", cat="cache",
                                   tier=lvl.stats.name, to=policy,
                                   flips=lvl.cache.admission_flips)
            # Readahead watches the *raw request stream in arrival order* —
            # what a streaming scheduler sees as the reader issues its
            # chunks — and its fills land in the cache ahead of the demand
            # drain, so the demand extents below hit the warm tier instead
            # of the backing one.
            if (batch.prefetch and self.readahead is not None
                    and self.store.levels):
                with tr.span("readahead", cat="scheduler", tid=tid):
                    disk_len = len(self.store.disk)
                    for o, sz, p in batch.ops:
                        if sz <= 0:
                            continue
                        pf = self.readahead.observe(o, o + sz)
                        if pf is not None:
                            plo, phi = pf[0], min(pf[1], disk_len)
                            if phi > plo:
                                self.store.dispatch_extent(plo, phi, p,
                                                           prefetch=True)
            with tr.span("coalesce", cat="scheduler", tid=tid) as csp:
                extents = merge_phase_extents(batch.ops, gap=0)
                csp.set(n_phases=len(extents),
                        n_extents=sum(len(v) for v in extents.values()))
            for phase in sorted(extents):
                with tr.span(f"dispatch:p{phase}", cat="scheduler", tid=tid,
                             n_extents=len(extents[phase])):
                    for lo, hi in extents[phase]:
                        self.store.dispatch_extent(lo, hi, phase)
            # each batch is its own queue drain: later batches pay their own
            # dependency round trips even though phase numbers restart at 0
            self.store.end_batch(batch.label, batch.n_requests)
            # the flush deadline is measured in batches; tick it for read
            # batches too so dirty data ages out under read-heavy mixes
            if self.store.flush_policy is not None:
                self.store.flush_policy.on_batch_end(self.store)
            self._ingest_drains(n0, request=batch.request)
        if tr.enabled:
            self._sample_counters()
        if self.plane.enabled:
            self._sample_plane()

    def _sample_counters(self) -> None:
        """One sample per counter track at batch close (traced runs only)."""
        tr = self.tracer
        for lvl in self.store.levels:
            cache = lvl.cache
            looked = cache.hits + cache.misses
            tr.counter(f"cache:{lvl.stats.name}", {
                "hit_rate": cache.hits / looked if looked else 0.0,
                "dirty_bytes": cache.dirty_bytes,
                "evictions": cache.evictions,
            })
        tr.counter("scheduler", {
            "n_batches": self.n_batches,
            "n_write_batches": self.n_write_batches,
            "drains": len(self.store.drain_log),
        })

    def _sample_plane(self) -> None:
        """Store-side gauges into the live metrics plane at batch close,
        timestamped on the virtual clock (inside an open service window the
        store's vclock does not advance, so the window's latest arrival
        time stands in — the batch closed while that request was being
        served)."""
        win = self._window
        t = win._arrival if win is not None else self.vclock
        plane = self.plane
        for lvl in self.store.levels:
            for key, v in lvl.cache.gauges().items():
                plane.sample(f"cache.{lvl.stats.name}.{key}", t, v)
        plane.sample("scheduler.drains", t, len(self.store.drain_log))

    # -- accounting ----------------------------------------------------------
    def stats(self, coalesce_gap: int = 0) -> IOStats:
        """Logical-trace stats, bit-identical to the legacy ``IOTracker``.
        Reads only — the write trace is :meth:`write_stats`."""
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
        self.vclock = 0.0
        self.completions = []
        self._request_seq = 0
        self._job_seq = 0
        self.store.reset_stats()
        self.workload.reset()
        if self.readahead is not None:
            self.readahead.reset()


def make_store(spec, disk: Disk) -> TieredStore:
    """Resolve a store spec: None/'flat' (NVMe, seed behaviour), 'flat-s3'
    (cold object store), 'tiered' (NVMe cache over S3), 'tiered-auto' (same
    with workload-driven admission), 'hot' (RAM over NVMe over S3), a
    callable ``disk -> TieredStore``, or a ready instance (which must have
    been built over the same ``Disk`` so cache block ids stay meaningful —
    sharing one store across readers of the same disk is how they share one
    NVMe budget)."""
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
