"""Counters and histograms queryable from tests and the bench harness.

A :class:`MetricsRegistry` is the aggregate companion to the event-stream
tracer: where the trace answers "what happened when", the registry answers
"how many / how distributed" without parsing the event list.  Counters are
monotonic ints (decode-fallback reasons, admission flips, flush drains);
histograms collect raw float samples and report quantiles by exact
nearest-rank selection — at the sample counts we deal in (10^2..10^5
per-request latencies) there is no reason to approximate.

Everything here is plain Python with no package imports, so the obs package
sits below every other layer and can never participate in an import cycle.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

__all__ = ["Counter", "Histogram", "MetricsRegistry", "percentile",
           "prometheus_text"]


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) over raw samples.

    Exact, deterministic, and matches what a serving dashboard means by
    "p99": the smallest sample ≥ the given fraction of the population.
    Raises on an empty sequence — callers decide how to render "no data"
    (``null``, never NaN).  The rank is at least 1: at a ``q`` so small that
    ``q / 100 * n`` underflows, the nearest rank is the minimum (the JAX
    package's copy returns ``xs[-1]`` there).
    """
    if not samples:
        raise ValueError("percentile of empty sample set")
    xs = sorted(samples)
    if q <= 0:
        return xs[0]
    if q >= 100:
        return xs[-1]
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


class Counter:
    """A monotonic integer counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counter({self.name}={self.value})"


class Histogram:
    """Raw-sample histogram with exact quantiles."""

    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    def observe_many(self, values: Sequence[float]) -> None:
        self.samples.extend(float(v) for v in values)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def total(self) -> float:
        return sum(self.samples)

    @property
    def mean(self) -> float:
        return self.total / len(self.samples) if self.samples else 0.0

    def quantile(self, q: float) -> float:
        return percentile(self.samples, q)

    def summary(self) -> Dict[str, Optional[float]]:
        """The fixed percentile set the benchmarks report.

        An empty histogram reports ``count: 0`` with every statistic
        ``None`` — never NaN and never a raise (``percentile`` raises on an
        empty sample set by design, but a *summary* of "no data yet" is a
        well-defined answer, and ``None`` is what the NaN-free bench policy
        serializes as ``null``)."""
        if not self.samples:
            return {"count": 0, "mean": None, "p50": None, "p99": None,
                    "p999": None, "max": None}
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(50),
            "p99": self.quantile(99),
            "p999": self.quantile(99.9),
            "max": self.quantile(100),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Histogram({self.name}, n={self.count})"


class MetricsRegistry:
    """Name-keyed counters and histograms, created on first touch."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def counter_values(self, prefix: str = "") -> Dict[str, int]:
        """Snapshot of all counters whose name starts with ``prefix``."""
        return {
            name: c.value for name, c in sorted(self.counters.items())
            if name.startswith(prefix)
        }

    def summaries(self, prefix: str = "") -> Dict[str, Dict]:
        """Snapshot of all histogram summaries whose name starts with
        ``prefix`` — the aggregate counterpart of :meth:`counter_values`
        (empty histograms report ``count: 0`` / ``None`` statistics, so a
        snapshot never raises)."""
        return {
            name: h.summary() for name, h in sorted(self.histograms.items())
            if name.startswith(prefix)
        }

    def reset(self) -> None:
        self.counters = {}
        self.histograms = {}


def _prom_name(name: str) -> str:
    """Sanitize a dotted metric name into the Prometheus charset."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render a registry in the Prometheus text exposition format.

    Counters become ``# TYPE <name> counter`` samples; raw-sample histograms
    become ``summary`` families (``{quantile="..."}`` gauges plus ``_sum`` /
    ``_count``), quantiles by the same exact nearest-rank estimator the
    bench artifacts use.  Deterministic output (sorted names), so the dump
    itself can be diffed across runs."""
    lines: List[str] = []
    for name, c in sorted(registry.counters.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {c.value}")
    for name, h in sorted(registry.histograms.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q in (0.5, 0.99, 0.999):
            if h.count:
                lines.append(f'{pn}{{quantile="{q}"}} {h.quantile(q * 100)!r}')
        lines.append(f"{pn}_sum {h.total!r}")
        lines.append(f"{pn}_count {h.count}")
    return "\n".join(lines) + "\n"
