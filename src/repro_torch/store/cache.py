"""Sector-granular block cache with pluggable eviction + admission.

The cache fronts a slow backing device (S3) with a fast one (NVMe, RAM).
It tracks *residency only* — block ids over the backing address space, at
``block_bytes`` (one device sector by default) granularity; actual bytes
always come from the simulated :class:`~repro_torch.core.io_sim.Disk`, the cache
decides which tier a block's read is priced on.

Eviction policies:

* ``clock`` — second-chance ring (one ref bit per slot); constant-time and
  scan-resistant enough for the paper's take-heavy workloads.
* ``lru`` — classic recency order, for comparison.

Admission policies:

* ``always`` — admit every missed block (default).
* ``second_touch`` — admit a block only on its second miss within the ghost
  window (a bounded FIFO of recently-seen block ids, 8x the cache's slot
  count).  Protects the cache from single-pass scan flooding.
* ``auto`` — start as ``always`` and let an observer of the workload (the
  scheduler's :class:`~repro_torch.store.WorkloadStats`) flip the *active* policy
  between ``always`` (take-heavy mixes: admit the hot rows immediately) and
  ``second_touch`` (scan-heavy mixes: keep single-pass streams from
  flooding the cache) via :meth:`BlockCache.set_active_admission`.

Write-back state (the ingest path, ``repro_torch.store.flush``): the cache
additionally tracks which resident blocks are **dirty** — written but not
yet flushed to the backing device.  ``mark_dirty`` force-inserts (dirty data
must occupy a slot, bypassing the admission filter), ``clean`` marks a block
flushed, and evicting a dirty block notifies ``on_evict`` so the flush
policy can write it back before the slot is reused (flush-on-evict).
``invalidate`` drops a block outright (compaction retargeting / crash
discard) without counting a capacity eviction.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set

__all__ = ["BlockCache"]

_MISSING = object()


class BlockCache:
    def __init__(
        self,
        capacity_bytes: int,
        block_bytes: int = 4096,
        policy: str = "clock",
        admission: str = "always",
    ):
        if block_bytes <= 0:
            raise ValueError("block_bytes must be positive")
        if capacity_bytes < block_bytes:
            raise ValueError("cache smaller than one block")
        if policy not in ("clock", "lru"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        if admission not in ("always", "second_touch", "auto"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.block_bytes = int(block_bytes)
        self.capacity_blocks = int(capacity_bytes) // self.block_bytes
        self.policy = policy
        self.admission = admission  # configured policy ("auto" stays "auto")
        self._active = "always" if admission == "auto" else admission
        self.admission_flips = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # lru state
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # clock state
        self._slot_of: Dict[int, int] = {}
        self._blocks: List[int] = []
        self._ref: List[int] = []
        self._hand = 0
        self._free: List[int] = []  # tombstoned clock slots (invalidate)
        # second-touch ghost list (ids seen once, not yet admitted)
        self._ghost: "OrderedDict[int, None]" = OrderedDict()
        self._ghost_cap = 8 * self.capacity_blocks
        # write-back state: dirty (written, unflushed) resident blocks
        self._dirty: Set[int] = set()
        # eviction hook (block_id, was_dirty); the flush policy uses it to
        # write back dirty victims before their slot is reused
        self.on_evict: Optional[Callable[[int, bool], None]] = None

    # -- residency ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._lru) if self.policy == "lru" else len(self._slot_of)

    def __contains__(self, block_id: int) -> bool:
        return block_id in (self._lru if self.policy == "lru" else self._slot_of)

    @property
    def resident_bytes(self) -> int:
        return len(self) * self.block_bytes

    # -- access ------------------------------------------------------------
    def lookup(self, block_id: int) -> bool:
        """Hit test; updates recency/ref state and hit/miss counters."""
        if self.policy == "lru":
            if block_id in self._lru:
                self._lru.move_to_end(block_id)
                self.hits += 1
                return True
        else:
            slot = self._slot_of.get(block_id)
            if slot is not None:
                self._ref[slot] = 1
                self.hits += 1
                return True
        self.misses += 1
        return False

    @property
    def active_admission(self) -> str:
        """The policy actually applied to admits (resolves ``auto``)."""
        return self._active

    def gauges(self) -> "Dict[str, float]":
        """Instantaneous gauge snapshot for the live metrics plane.

        ``hit_rate`` is lifetime hits / lookups (0.0 before any lookup —
        a gauge needs a number, and the windowed view comes from sampling
        this repeatedly, not from NaN); ``admission_second_touch`` encodes
        the active policy as 0/1 so a policy flip shows as a step on the
        counter track."""
        looked = self.hits + self.misses
        return {
            "hit_rate": self.hits / looked if looked else 0.0,
            "dirty_bytes": float(self.dirty_bytes),
            "resident_bytes": float(self.resident_bytes),
            "evictions": float(self.evictions),
            "admission_second_touch":
                1.0 if self._active == "second_touch" else 0.0,
        }

    def set_active_admission(self, policy: str) -> None:
        """Flip the active policy of an ``auto`` cache.  No-op unless the
        cache was configured ``admission="auto"`` — explicit policies are
        pinned by construction."""
        if policy not in ("always", "second_touch"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if self.admission != "auto" or policy == self._active:
            return
        self._active = policy
        self.admission_flips += 1

    def admit(self, block_id: int) -> bool:
        """Maybe-insert a block after a miss; returns True if now resident."""
        if block_id in self:
            return True
        if self._active == "second_touch":
            if block_id not in self._ghost:
                self._ghost[block_id] = None
                while len(self._ghost) > self._ghost_cap:
                    self._ghost.popitem(last=False)
                return False
            del self._ghost[block_id]
        self._insert(block_id)
        return True

    def _evicted(self, victim: int) -> None:
        self.evictions += 1
        was_dirty = victim in self._dirty
        self._dirty.discard(victim)
        if self.on_evict is not None:
            self.on_evict(victim, was_dirty)

    def _insert(self, block_id: int) -> None:
        """Unconditional insert (evicting as needed); no admission filter."""
        if self.policy == "lru":
            if len(self._lru) >= self.capacity_blocks:
                victim, _ = self._lru.popitem(last=False)
                self._evicted(victim)
            self._lru[block_id] = None
            return
        # clock: insert with a clear ref bit — only a subsequent lookup
        # earns the block its second chance
        if self._free:
            slot = self._free.pop()
            self._slot_of[block_id] = slot
            self._blocks[slot] = block_id
            self._ref[slot] = 0
            return
        if len(self._blocks) < self.capacity_blocks:
            self._slot_of[block_id] = len(self._blocks)
            self._blocks.append(block_id)
            self._ref.append(0)
            return
        while self._ref[self._hand]:
            self._ref[self._hand] = 0
            self._hand = (self._hand + 1) % self.capacity_blocks
        victim = self._blocks[self._hand]
        del self._slot_of[victim]
        self._evicted(victim)
        self._blocks[self._hand] = block_id
        self._slot_of[block_id] = self._hand
        self._ref[self._hand] = 0
        self._hand = (self._hand + 1) % self.capacity_blocks

    # -- write-back state ----------------------------------------------------
    def fill(self, block_id: int) -> None:
        """Write-path *clean* fill: force-insert resident, bypassing the
        admission filter.  A write-through store just put these bytes on the
        backing device — they are the freshest data there is, so the ghost
        list's scan protection does not apply (admission polices reads, not
        the writer's own fills)."""
        if block_id not in self:
            self._ghost.pop(block_id, None)
            self._insert(block_id)

    def mark_dirty(self, block_id: int) -> None:
        """Write-path insert: make the block resident — bypassing the
        admission filter, dirty data must hold a slot — and mark it dirty.
        Evicting it later notifies ``on_evict`` with ``was_dirty=True`` so
        the flush policy can write it back first."""
        if block_id not in self:
            self._ghost.pop(block_id, None)
            self._insert(block_id)
        elif self.policy == "lru":
            self._lru.move_to_end(block_id)
        else:
            self._ref[self._slot_of[block_id]] = 1
        self._dirty.add(block_id)

    def clean(self, block_id: int) -> None:
        """Mark a block flushed (durable); residency is unchanged."""
        self._dirty.discard(block_id)

    def is_dirty(self, block_id: int) -> bool:
        return block_id in self._dirty

    @property
    def dirty_blocks(self) -> List[int]:
        return sorted(self._dirty)

    @property
    def dirty_bytes(self) -> int:
        return len(self._dirty) * self.block_bytes

    def invalidate(self, block_id: int) -> bool:
        """Drop a block without a capacity eviction (no ``on_evict``, no
        eviction counter): compaction retargeting and crash discard.  Any
        dirty state is discarded with it."""
        self._dirty.discard(block_id)
        if self.policy == "lru":
            return self._lru.pop(block_id, _MISSING) is not _MISSING
        slot = self._slot_of.pop(block_id, None)
        if slot is None:
            return False
        self._blocks[slot] = -1  # tombstone; reused before any eviction
        self._ref[slot] = 0
        self._free.append(slot)
        return True

    # -- management ---------------------------------------------------------
    def drop(self) -> None:
        """Discard all resident blocks (counters are kept).  Dirty state is
        discarded silently — callers that care about durability flush before
        dropping (``TieredStore.discard_dirty`` is the accounted path)."""
        self._lru.clear()
        self._slot_of.clear()
        self._blocks = []
        self._ref = []
        self._hand = 0
        self._free = []
        self._ghost.clear()
        self._dirty.clear()

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0
