"""Flush policies: when written blocks become durable on the backing device.

The read side of the tiered store decides what a read *costs*; this module
is its write-side dual — it decides when a write *persists*.  Every write
batch (``IOScheduler.write_batch``) closes into the store's attached
:class:`FlushPolicy`:

* ``write-through`` — every sector-aligned write extent is dispatched to the
  backing device at batch close (and admitted clean into the cache tiers so
  subsequent reads are NVMe-warm).  Durable immediately; every append pays a
  backing-device queue drain.
* ``write-back`` — extents are absorbed into the fastest cache tier as
  *dirty* blocks (priced as cache-device writes) and flushed to the backing
  device later: when the dirty footprint crosses ``high_watermark`` of the
  cache capacity (drained down to ``low_watermark``, oldest first), when a
  dirty block's age exceeds ``deadline_batches`` scheduler batches, when a
  dirty block is evicted (flush-on-evict, always on), or at an explicit
  :meth:`flush_all` barrier (the dataset writer's commit fence).
* ``flush-on-evict`` — the lazy extreme: dirty blocks persist only on
  eviction or an explicit barrier.  Maximum write coalescing, maximum
  bytes-at-risk.

Flush batches are dispatched **through the same accounting path as reads**:
contiguous dirty runs become sector-aligned backing write ops in
:class:`~repro_torch.store.TierStats` phase buckets, so write-back IOPS are priced
against the same queue-depth model as the read traffic they compete with.

Durability model: dirty = would be lost on crash.  ``TieredStore.
discard_dirty`` simulates the crash (drops dirty residency, counts
``lost_bytes``, returns the lost extents so the dataset writer can tear the
unflushed media bytes).  Tests inject ``fail_after`` to interrupt a flush
after N dispatched extents and prove any prefix of the flush+commit sequence
leaves every committed manifest version readable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FlushPolicy", "SimulatedCrash"]

MODES = ("write-through", "write-back", "flush-on-evict")


class SimulatedCrash(RuntimeError):
    """Raised by a fault-injected flush after ``fail_after`` extents; the
    blocks already dispatched are durable, the rest are still dirty."""


class FlushPolicy:
    """Write-path policy attached to a :class:`~repro_torch.store.TieredStore` via
    ``store.set_flush_policy`` (done by :func:`repro_torch.store.make_store` specs
    and the dataset writer)."""

    def __init__(
        self,
        mode: str = "write-back",
        high_watermark: float = 0.5,
        low_watermark: float = 0.25,
        deadline_batches: int = 8,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown flush mode {mode!r} (want one of {MODES})")
        if not 0.0 < high_watermark <= 1.0:
            raise ValueError("high_watermark must be in (0, 1]")
        if not 0.0 <= low_watermark <= high_watermark:
            raise ValueError("low_watermark must be in [0, high_watermark]")
        if deadline_batches <= 0:
            raise ValueError("deadline_batches must be positive")
        self.mode = mode
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.deadline_batches = int(deadline_batches)
        self._born: Dict[int, int] = {}  # dirty block id -> batch tick
        self._tick = 0
        self.n_flush_events = 0       # watermark/deadline/evict/barrier drains
        self.fail_after: Optional[int] = None  # fault injection (tests)

    # -- ingest ---------------------------------------------------------------
    def absorb(self, store, extents: Dict[int, List[Tuple[int, int]]]) -> None:
        """One closed write batch's per-phase coalesced extents.

        Write-through (also any store without a cache level) dispatches to
        the backing tier immediately; write-back/flush-on-evict absorb the
        blocks dirty into the fastest tier.
        """
        if self.mode == "write-through" or not store.levels:
            for phase in sorted(extents):
                for lo, hi in extents[phase]:
                    store.dispatch_write_extent(lo, hi, phase)
            return
        lvl = store.levels[0]
        sector = store.sector
        for phase in sorted(extents):
            for lo, hi in extents[phase]:
                if hi <= lo:
                    continue
                b0, b1 = lo // sector, (hi + sector - 1) // sector
                # a sub-sector edge whose block is not resident anywhere
                # needs the rest of the sector read from backing before the
                # dirty block is whole (read-modify-write); resident blocks
                # merge in cache for free
                store.price_rmw(lo, hi, phase)
                lvl.stats.add_write_op((b1 - b0) * sector, phase)
                for bid in range(b0, b1):
                    # birth = the clean->dirty transition: a block re-dirtied
                    # while still dirty keeps aging from its first write, but
                    # one whose dirty state was dropped elsewhere (drop_caches)
                    # must not inherit a stale tick and flush prematurely
                    if not lvl.cache.is_dirty(bid):
                        self._born[bid] = self._tick
                    lvl.cache.mark_dirty(bid)

    # -- triggers -------------------------------------------------------------
    def on_evict(self, store, block_id: int, was_dirty: bool) -> None:
        """Cache eviction hook: a dirty victim is written back before its
        slot is reused (one single-block backing write, part of the current
        open drain)."""
        if not was_dirty:
            return
        store.backing_stats.add_write_op(store.sector, phase=0, flush=True)
        self._born.pop(block_id, None)
        self.n_flush_events += 1
        store.tracer.instant("flush_on_evict", cat="flush", block=block_id)

    def on_batch_end(self, store) -> None:
        """Scheduler tick (one per closed read/write batch): age-out dirty
        blocks past the deadline, then enforce the high watermark."""
        self._tick += 1
        if self.mode != "write-back" or not store.levels:
            return
        cache = store.levels[0].cache
        # prune entries whose dirty state was dropped behind our back
        # (drop_caches, invalidate) so _born cannot grow without bound
        stale = [b for b in self._born if not cache.is_dirty(b)]
        for b in stale:
            del self._born[b]
        expired = [b for b, t in self._born.items()
                   if self._tick - t >= self.deadline_batches]
        if expired:
            self.flush(store, expired, reason="deadline")
        cap = cache.capacity_blocks * cache.block_bytes
        if cache.dirty_bytes > self.high_watermark * cap:
            excess = cache.dirty_bytes - int(self.low_watermark * cap)
            oldest = sorted(self._born, key=self._born.get)
            victims = [b for b in oldest if cache.is_dirty(b)]
            self.flush(store, victims[: max(excess // cache.block_bytes, 1)],
                       reason="watermark")

    # -- flushing -------------------------------------------------------------
    def flush(self, store, blocks: Sequence[int],
              reason: str = "barrier") -> int:
        """Write a set of dirty blocks back to the backing device: contiguous
        runs become one sector-aligned backing write op each, dispatched into
        the store's open drain and closed as one queue drain.  ``reason``
        names the trigger (``deadline``/``watermark``/``barrier``) — it
        labels the drain record and the trace span, so flush stalls are
        attributable.  Returns the number of blocks made durable.
        ``fail_after`` (fault injection) crashes the flush after that many
        dispatched extents."""
        blocks = sorted(b for b in blocks)
        if not blocks:
            return 0
        label = f"flush:{reason}"
        cache = store.levels[0].cache if store.levels else None
        sector = store.sector
        runs: List[Tuple[int, int]] = []
        run_lo = prev = blocks[0]
        for b in blocks[1:]:
            if b != prev + 1:
                runs.append((run_lo, prev + 1))
                run_lo = b
            prev = b
        runs.append((run_lo, prev + 1))
        done = 0
        with store.tracer.span(label, cat="flush", n_blocks=len(blocks),
                               n_runs=len(runs)):
            for i, (b0, b1) in enumerate(runs):
                if self.fail_after is not None and i >= self.fail_after:
                    store.end_batch(label)
                    raise SimulatedCrash(
                        f"flush interrupted after {i} of {len(runs)} extents")
                store.backing_stats.add_write_op((b1 - b0) * sector, phase=0,
                                                 flush=True)
                for bid in range(b0, b1):
                    if cache is not None:
                        cache.clean(bid)
                    self._born.pop(bid, None)
                    done += 1
            store.end_batch(label)  # a flush is its own queue drain
        self.n_flush_events += 1
        return done

    def flush_all(self, store) -> int:
        """The commit barrier: make every dirty block durable now."""
        if not store.levels:
            return 0
        return self.flush(store, store.levels[0].cache.dirty_blocks,
                          reason="barrier")

    def drop_block(self, block_id: int) -> None:
        """Forget policy state for a discarded (crashed/invalidated) block."""
        self._born.pop(block_id, None)
