"""Per-tier IO accounting for the flat store.

The backing device carries one :class:`TierStats`: dispatched IOPS and
bytes (sector-aligned, i.e. what the device actually serves) and per-phase
op counts so queue-depth-limited round trips can be priced.

``model_time`` here is the same first-order device model as
:func:`repro_torch.core.io_sim.model_time`, extended with a queue-depth term —
a phase with more outstanding requests than the device queue can hold pays
one round-trip latency per queue drain, not one per phase.

The write path adds the ingest-side counters: ``write_iops`` /
``bytes_written`` are dispatched device writes; ``flush_iops`` /
``flush_bytes`` the subset issued by a flusher; ``rmw_iops`` / ``rmw_bytes``
the read-modify-write merge reads of sub-sector write edges; ``dirty_bytes``
the resident not-yet-durable footprint and ``lost_bytes`` the dirty bytes a
simulated crash discarded.  On the flat store writes are write-through, so
the last two stay 0 there.

This is the port's copy without the cache-tier counters (hits, misses,
evictions, prefetch), which wait for ROADMAP.md, Queue 1 item 4 (the full
store).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..core.io_sim import DeviceModel

__all__ = ["TierStats", "DrainRecord"]


@dataclasses.dataclass
class DrainRecord:
    """One completed queue drain across the whole store.

    Appended by ``TieredStore.end_batch``: ``tiers`` maps tier index (the
    ``tier_stats()`` order) to the ``(phase_ops, phase_bytes)`` buckets that
    drain archived.  ``n_requests`` is the logical request count the batch
    carried (rows of a ``take``; 0 for scans).
    """

    label: str
    n_requests: int
    tiers: Dict[int, Tuple[Dict[int, int], Dict[int, int]]]


@dataclasses.dataclass
class TierStats:
    """Dispatched-IO counters for one storage tier.

    Dependency round trips are tracked **per batch**: each ``take``/``scan``
    is its own queue drain, so two sequential batches pay two sets of phase
    latencies even though their ops share phase numbers.  ``phase_ops`` is
    the open batch; :meth:`end_batch` archives it into ``batch_phases``.
    """

    name: str
    n_iops: int = 0          # dispatched device requests
    bytes_read: int = 0      # sector-aligned bytes served
    write_iops: int = 0      # dispatched device write requests
    bytes_written: int = 0   # sector-aligned bytes written to this tier
    flush_iops: int = 0      # subset of write_iops issued by a flusher
    flush_bytes: int = 0     # subset of bytes_written issued by a flusher
    rmw_iops: int = 0        # read-modify-write merge reads (subset of n_iops)
    rmw_bytes: int = 0       # subset of bytes_read issued by RMW merges
    dirty_bytes: int = 0     # resident dirty bytes
    lost_bytes: int = 0      # dirty bytes discarded by a simulated crash
    max_phase: int = 0       # deepest dependency phase seen (+1)
    phase_ops: Dict[int, int] = dataclasses.field(default_factory=dict)
    phase_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    batch_phases: List[Dict[int, int]] = dataclasses.field(default_factory=list)

    def add_op(self, nbytes: int, phase: int) -> None:
        self.n_iops += 1
        self.bytes_read += int(nbytes)
        self.phase_ops[int(phase)] = self.phase_ops.get(int(phase), 0) + 1
        self.phase_bytes[int(phase)] = (
            self.phase_bytes.get(int(phase), 0) + int(nbytes))
        self.max_phase = max(self.max_phase, int(phase) + 1)

    def add_write_op(self, nbytes: int, phase: int, flush: bool = False) -> None:
        """One dispatched device *write*.  Writes share the per-phase op
        buckets with reads, so a drain's round-trip pricing covers both
        directions of traffic."""
        self.write_iops += 1
        self.bytes_written += int(nbytes)
        self.phase_ops[int(phase)] = self.phase_ops.get(int(phase), 0) + 1
        self.phase_bytes[int(phase)] = (
            self.phase_bytes.get(int(phase), 0) + int(nbytes))
        self.max_phase = max(self.max_phase, int(phase) + 1)
        if flush:
            self.flush_iops += 1
            self.flush_bytes += int(nbytes)

    def end_batch(self) -> Optional[Tuple[Dict[int, int], Dict[int, int]]]:
        """Close the open batch: its phases become one archived queue drain.
        Returns the drained ``(phase_ops, phase_bytes)`` buckets (``None`` if
        the batch touched nothing on this tier)."""
        if self.phase_ops:
            drained = (self.phase_ops, self.phase_bytes)
            self.batch_phases.append(self.phase_ops)
            self.phase_ops = {}
            self.phase_bytes = {}
            return drained
        return None

    def model_time(self, dev: DeviceModel, queue_depth: int = 256) -> float:
        """Price this tier's dispatched trace on ``dev``: throughput-limited
        term plus queue-depth-limited dependency round trips, one drain per
        (batch, phase).  Reads and writes share the device's throughput and
        queue."""
        total_ops = self.n_iops + self.write_iops
        if total_ops == 0:
            return 0.0
        total_bytes = self.bytes_read + self.bytes_written
        avg = max(total_bytes / total_ops, 1.0)
        eff = max(avg, dev.min_read)
        iops_limit = min(dev.iops_4k, dev.seq_bw / eff)
        t = max(total_ops / iops_limit, total_bytes / dev.seq_bw)
        qd = max(1, queue_depth)
        for phases in self.batch_phases + [self.phase_ops]:
            for ops in phases.values():
                t += math.ceil(ops / qd) * dev.latency
        return t

    def snapshot(self) -> "TierStats":
        """Detached copy — safe to hold across a later ``reset()``."""
        return dataclasses.replace(
            self, phase_ops=dict(self.phase_ops),
            phase_bytes=dict(self.phase_bytes),
            batch_phases=[dict(p) for p in self.batch_phases],
        )

    def reset(self) -> None:
        self.n_iops = self.bytes_read = 0
        self.write_iops = self.bytes_written = 0
        self.flush_iops = self.flush_bytes = 0
        self.rmw_iops = self.rmw_bytes = 0
        self.dirty_bytes = self.lost_bytes = 0
        self.max_phase = 0
        self.phase_ops = {}
        self.phase_bytes = {}
        self.batch_phases = []
