"""Per-request latency attribution over the tiered store's priced IO model.

``TierStats.model_time`` prices a tier's whole dispatched trace as one
number: a throughput-limited term plus one queue-drain latency term per
(batch, phase).  That is the right contract for end-to-end totals, but the
serving story (ROADMAP: tail-latency p999) needs the inverse mapping — *which
logical requests occupied each drain, and what did that drain cost them*.

This module computes that decomposition from the store's **drain log**: the
:class:`~repro_torch.store.TieredStore` records, at every ``end_batch``, which
per-(tier, phase) op/byte buckets the batch drained, plus the batch label and
how many logical requests (rows of a ``take``) the batch carried.  Given the
log, :func:`attribute` rebuilds each tier's cost with *identical arithmetic*
to ``model_time`` and splits it per drain:

* the **throughput term** ``max(ops / iops_limit, bytes / seq_bw)`` is a
  property of the whole trace (``iops_limit`` depends on the global average
  op size), so it is distributed across drains proportionally to each
  drain's dispatched bytes on that tier (ops when the tier moved no bytes);
* the **latency terms** ``ceil(ops / qd) * dev.latency`` are already
  per-(drain, phase) and are assigned where they arose.

The invariant (tested at 1e-9 relative): for every tier, the attributed
drain costs sum to exactly that tier's ``model_time``.  The proportional
split uses a remainder assignment on the last occupied drain so the sum is
exact in floating point, not just close.

A drain's cost divided by its request count is the modeled per-request
latency; drains that carried no counted requests (scans, flushes, open
buckets) count as one implicit request so nothing priced ever goes
unattributed.  :meth:`Attribution.percentiles` turns the resulting
per-request population into the p50/p99/p999 summary the benchmarks report.

Deliberately import-free of ``repro_torch.store``: the store object is duck-typed
(``levels``/``backing``/``backing_stats``/``drain_log``), keeping ``obs``
below every other layer in the import graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from .metrics import percentile

__all__ = ["DrainCost", "Attribution", "attribute"]


@dataclasses.dataclass
class DrainCost:
    """One queue drain's attributed cost, split per tier.

    ``tier_costs`` is keyed by tier index (fastest level first, backing
    device last — the same order as ``TieredStore.tier_stats()``).
    """

    label: str
    n_requests: int
    tier_costs: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def total(self) -> float:
        return sum(self.tier_costs.values())

    @property
    def effective_requests(self) -> int:
        """Drains that carried no counted requests (scans, flushes, open
        buckets) are one implicit request — cost is never dropped."""
        return self.n_requests if self.n_requests > 0 else 1

    @property
    def per_request(self) -> float:
        return self.total / self.effective_requests


@dataclasses.dataclass
class Attribution:
    """The full decomposition: one :class:`DrainCost` per logged drain."""

    tier_names: List[str]
    drains: List[DrainCost]

    def tier_sums(self) -> Dict[str, float]:
        """Per-tier attributed totals; equals each tier's ``model_time``."""
        sums = {name: 0.0 for name in self.tier_names}
        for d in self.drains:
            for idx, cost in d.tier_costs.items():
                sums[self.tier_names[idx]] += cost
        return sums

    @property
    def total(self) -> float:
        return sum(d.total for d in self.drains)

    def per_request_latencies(
        self, label_prefix: Optional[str] = None
    ) -> List[float]:
        """One modeled latency per logical request: each drain's cost spread
        uniformly over the requests it carried.  ``label_prefix`` restricts
        to matching drains (e.g. ``"take"``) — the percentiles then describe
        just that request class."""
        out: List[float] = []
        for d in self.drains:
            if label_prefix is not None and not d.label.startswith(label_prefix):
                continue
            out.extend([d.per_request] * d.effective_requests)
        return out

    def percentiles(
        self, label_prefix: Optional[str] = None
    ) -> Optional[Dict[str, float]]:
        """p50/p99/p999 summary of the per-request population, or ``None``
        when no drain matched (never NaN — these land in JSON artifacts)."""
        lats = self.per_request_latencies(label_prefix)
        if not lats:
            return None
        return {
            "count": len(lats),
            "mean": sum(lats) / len(lats),
            "p50": percentile(lats, 50),
            "p99": percentile(lats, 99),
            "p999": percentile(lats, 99.9),
            "max": percentile(lats, 100),
        }


def attribute(store, queue_depth: int = 256) -> Attribution:
    """Decompose every tier's ``model_time`` onto the store's drain log.

    ``store`` is duck-typed: needs ``levels`` (each with ``.stats`` and
    ``.device``), ``backing``/``backing_stats``, and ``drain_log`` (records
    with ``.label``/``.n_requests``/``.tiers``).  Open (not yet drained)
    phase buckets are attributed to a virtual ``"(open)"`` drain so the
    per-tier sums match ``model_time`` even mid-batch.
    """
    tiers = [(lvl.stats, lvl.device) for lvl in store.levels]
    tiers.append((store.backing_stats, store.backing))
    names = [s.name for s, _ in tiers]

    records = list(store.drain_log)
    open_buckets: Dict[int, tuple] = {}
    for idx, (s, _) in enumerate(tiers):
        if s.phase_ops:
            open_buckets[idx] = (dict(s.phase_ops), dict(s.phase_bytes))
    if open_buckets:
        records.append(_OpenDrain(open_buckets))

    drains = [DrainCost(r.label, r.n_requests) for r in records]
    qd = max(1, queue_depth)

    for idx, (s, dev) in enumerate(tiers):
        total_ops = s.n_iops + s.write_iops
        if total_ops == 0:
            continue
        # throughput term: identical arithmetic to TierStats.model_time
        total_bytes = s.bytes_read + s.bytes_written
        avg = max(total_bytes / total_ops, 1.0)
        eff = max(avg, dev.min_read)
        iops_limit = min(dev.iops_4k, dev.seq_bw / eff)
        t_tp = max(total_ops / iops_limit, total_bytes / dev.seq_bw)

        # split weight: dispatched bytes per drain on this tier (ops if the
        # tier somehow moved no bytes)
        weights: List[float] = []
        for r in records:
            buckets = r.tiers.get(idx)
            if buckets is None:
                weights.append(0.0)
            elif total_bytes:
                weights.append(float(sum(buckets[1].values())))
            else:
                weights.append(float(sum(buckets[0].values())))
        wsum = sum(weights)
        last_occupied = max(
            (i for i, w in enumerate(weights) if w > 0), default=None
        )

        assigned = 0.0
        for i, r in enumerate(records):
            cost = 0.0
            buckets = r.tiers.get(idx)
            if buckets is not None:
                for ops in buckets[0].values():
                    cost += math.ceil(ops / qd) * dev.latency
            if wsum > 0 and weights[i] > 0:
                if i == last_occupied:
                    # remainder assignment: the tier sum equals t_tp exactly
                    share = t_tp - assigned
                else:
                    share = t_tp * (weights[i] / wsum)
                    assigned += share
                cost += share
            if cost:
                drains[i].tier_costs[idx] = cost
        if last_occupied is None and t_tp:
            # priced ops with no logged drain (shouldn't happen through the
            # scheduler; defensive for hand-driven stores)
            drains.append(DrainCost("(unattributed)", 0, {idx: t_tp}))

    return Attribution(tier_names=names, drains=drains)


class _OpenDrain:
    """Virtual drain record for phase buckets not yet archived."""

    __slots__ = ("label", "n_requests", "tiers")

    def __init__(self, tiers: Dict[int, tuple]):
        self.label = "(open)"
        self.n_requests = 0
        self.tiers = tiers
