"""Live metrics plane: mergeable log-bucket histograms and virtual-clock
gauge time series.

This module is the *continuous* half of the observability layer.  The raw
:class:`~repro_torch.obs.metrics.Histogram` keeps every sample — exact, but it
cannot window (dropping old samples means rescanning) and merging two of
them concatenates sample lists.  Serving telemetry needs the opposite
trade: bounded memory per stream, exact merge across tenants and windows,
and quantiles good to a *configured* relative error.  That is the
log-bucket histogram (the DDSketch construction):

* bucket ``i`` covers ``(gamma^(i-1), gamma^i]`` with
  ``gamma = (1 + rel_err) / (1 - rel_err)``, so reporting the bucket's
  geometric midpoint ``2 * gamma^i / (gamma + 1)`` is within ``rel_err``
  relative of any sample in the bucket;
* storage is one count per *occupied* bucket (O(log(max/min) / rel_err)
  worst case, O(1) per observe);
* merge is bucket-wise addition — exact, associative, commutative — which
  is what lets per-window and per-tenant histograms roll up without
  re-observing anything.

:class:`WindowedHistogram` rotates a ring of log-bucket histograms on the
**virtual clock** (the event loop's simulated seconds, not host time): each
window covers ``window`` virtual seconds, the live horizon is ``n_windows``
of them, and rotation never loses counts — an expired window's population
moves to the ``dropped`` tally and stays visible in the cumulative
``total`` histogram (invariant: ``total.count == dropped + live counts``).

:class:`GaugeSeries` is the plain time-series half: ``(t, value)`` samples
appended at event-loop round/completion boundaries — per-tier utilization,
outstanding-queue occupancy, in-flight jobs — and at batch close for the
store-side gauges (cache hit rate, dirty bytes, admission state).

:class:`MetricsPlane` bundles the three (series + windowed latency
histograms + a :class:`~repro_torch.obs.metrics.MetricsRegistry` for counters)
behind the same zero-cost contract as the tracer: the disabled plane (the
:data:`NULL_PLANE` singleton) allocates nothing — ``sample()`` returns
before creating anything — and an *enabled* plane is purely observational:
priced times and logical IOPS are bit-identical with sampling on or off
(tested).  Exporters: Perfetto counter tracks (``"C"`` events on the
virtual clock) into a :class:`~repro_torch.obs.trace.Tracer`, a Prometheus text
dump, and a JSON form the bench artifacts embed for
``tools/obs_report.py``'s terminal dashboard.

Like the rest of ``repro_torch.obs`` this module imports nothing from the wider
package (``metrics`` only), so every layer above can depend on it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import MetricsRegistry, prometheus_text

__all__ = ["LogBucketHistogram", "WindowedHistogram", "GaugeSeries",
           "MetricsPlane", "NULL_PLANE"]


class LogBucketHistogram:
    """Bounded-relative-error quantile sketch with exact merge.

    ``rel_err`` is the quantile accuracy guarantee: for any q,
    ``quantile(q)`` is within ``rel_err`` *relative* of the exact
    nearest-rank value over the observed samples (zeros are tracked exactly
    in their own bucket; negative values are rejected — these are latency /
    occupancy populations).  ``min``/``max``/``sum`` are tracked exactly, so
    ``mean`` and the extreme quantiles carry no bucket error.
    """

    __slots__ = ("rel_err", "gamma", "_lg", "buckets", "zero_count",
                 "count", "sum", "min", "max")

    def __init__(self, rel_err: float = 0.01):
        if not 0.0 < rel_err < 1.0:
            raise ValueError("rel_err must be in (0, 1)")
        self.rel_err = float(rel_err)
        self.gamma = (1.0 + self.rel_err) / (1.0 - self.rel_err)
        self._lg = math.log(self.gamma)
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- observe / merge -----------------------------------------------------
    def observe(self, value: float, n: int = 1) -> None:
        value = float(value)
        if value < 0.0:
            raise ValueError("log-bucket histogram takes non-negative samples")
        if n <= 0:
            return
        self.count += n
        self.sum += value * n
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if value == 0.0:
            self.zero_count += n
            return
        i = math.ceil(math.log(value) / self._lg)
        self.buckets[i] = self.buckets.get(i, 0) + n

    def merge(self, other: "LogBucketHistogram") -> "LogBucketHistogram":
        """Fold ``other`` into this histogram (exact: the result is
        indistinguishable from having observed both populations here).
        Requires equal ``rel_err`` — bucket boundaries must line up."""
        if other.rel_err != self.rel_err:
            raise ValueError("cannot merge histograms with different rel_err")
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "LogBucketHistogram":
        h = LogBucketHistogram(self.rel_err)
        h.buckets = dict(self.buckets)
        h.zero_count = self.zero_count
        h.count = self.count
        h.sum = self.sum
        h.min = self.min
        h.max = self.max
        return h

    # -- quantiles -----------------------------------------------------------
    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def _rep(self, i: int) -> float:
        """Bucket representative: the geometric midpoint of
        ``(gamma^(i-1), gamma^i]`` — max relative error ``rel_err``."""
        return 2.0 * self.gamma ** i / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile (``q`` in [0, 100]) to within ``rel_err``
        relative; raises on an empty histogram (same contract as
        :func:`repro_torch.obs.metrics.percentile`, whose rank clamp it
        shares: the rank is at least 1, so a ``q`` that underflows gives the
        minimum, where the JAX package's copy returns 0.0)."""
        if self.count == 0:
            raise ValueError("quantile of empty histogram")
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = self.zero_count
        if rank <= seen:
            return 0.0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank <= seen:
                # clamp into the exactly-tracked extremes: the top bucket's
                # midpoint may overshoot max (and the bottom undershoot min)
                return min(max(self._rep(i), self.min), self.max)
        return self.max  # pragma: no cover - counts always telescope

    def summary(self) -> Dict[str, Optional[float]]:
        """Same shape as ``Histogram.summary`` (``None`` fields when empty,
        never NaN)."""
        if self.count == 0:
            return {"count": 0, "mean": None, "p50": None, "p99": None,
                    "p999": None, "max": None}
        return {"count": self.count, "mean": self.mean,
                "p50": self.quantile(50), "p99": self.quantile(99),
                "p999": self.quantile(99.9), "max": self.max}

    def bucket_bounds(self) -> List[Tuple[float, int]]:
        """Sorted ``(upper_bound, count)`` pairs (zeros under bound 0.0) —
        the cumulative-bucket form the Prometheus exporter renders as
        ``_bucket{le=...}`` samples."""
        out: List[Tuple[float, int]] = []
        if self.zero_count:
            out.append((0.0, self.zero_count))
        for i in sorted(self.buckets):
            out.append((self.gamma ** i, self.buckets[i]))
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LogBucketHistogram(n={self.count}, "
                f"buckets={len(self.buckets)}, rel_err={self.rel_err})")


class WindowedHistogram:
    """A ring of log-bucket histograms rotating on the virtual clock.

    ``observe(t, v)`` lands ``v`` in the window covering virtual time ``t``
    (window ``w`` covers ``[w * window, (w + 1) * window)`` seconds); the
    live horizon is the most recent ``n_windows`` windows.  Rotation is
    lazy and **never loses counts**: a window that ages out of the horizon
    adds its population to ``dropped``, and the cumulative ``total``
    histogram observes everything forever — the tested invariant is
    ``total.count == dropped + sum(live window counts)``.  ``merged()``
    folds the live windows into one histogram (exact, by construction), so
    windowed quantiles carry the same ``rel_err`` bound as the buckets.
    """

    __slots__ = ("window", "n_windows", "rel_err", "total", "dropped",
                 "_ring", "_last_wid")

    def __init__(self, window: float = 1.0, n_windows: int = 8,
                 rel_err: float = 0.01):
        if window <= 0 or n_windows <= 0:
            raise ValueError("window and n_windows must be positive")
        self.window = float(window)
        self.n_windows = int(n_windows)
        self.rel_err = float(rel_err)
        self.total = LogBucketHistogram(rel_err)
        self.dropped = 0
        # ring slot -> (window id, histogram); lazily (re)populated
        self._ring: List[Optional[Tuple[int, LogBucketHistogram]]] = (
            [None] * self.n_windows)
        self._last_wid = -1

    def _wid(self, t: float) -> int:
        return max(int(t // self.window), 0)

    def observe(self, t: float, value: float) -> None:
        wid = self._wid(t)
        self._last_wid = max(self._last_wid, wid)
        if wid <= self._last_wid - self.n_windows:
            # a straggler older than the whole horizon: counted (total),
            # but it has no live window to land in
            self.total.observe(value)
            self.dropped += 1
            return
        slot = wid % self.n_windows
        cur = self._ring[slot]
        if cur is None or cur[0] != wid:
            if cur is not None and cur[0] < wid:
                self.dropped += cur[1].count  # rotation: counts move, not die
            self._ring[slot] = cur = (wid, LogBucketHistogram(self.rel_err))
        cur[1].observe(value)
        self.total.observe(value)

    def _live(self) -> List[LogBucketHistogram]:
        """Live-horizon histograms, expiring stale slots (a jump of more
        than ``n_windows`` windows can leave slots the rotation never
        touched)."""
        out: List[LogBucketHistogram] = []
        floor = self._last_wid - self.n_windows
        for slot, cur in enumerate(self._ring):
            if cur is None:
                continue
            if cur[0] <= floor:
                self.dropped += cur[1].count
                self._ring[slot] = None
            else:
                out.append(cur[1])
        return out

    @property
    def live_count(self) -> int:
        return sum(h.count for h in self._live())

    def merged(self) -> LogBucketHistogram:
        """One histogram over the live horizon (exact bucket-wise merge)."""
        out = LogBucketHistogram(self.rel_err)
        for h in self._live():
            out.merge(h)
        return out

    def quantile(self, q: float) -> float:
        return self.merged().quantile(q)

    def summary(self) -> Dict[str, Optional[float]]:
        s = self.merged().summary()
        s["window_s"] = self.window * self.n_windows
        s["lifetime_count"] = self.total.count
        return s


class GaugeSeries:
    """One gauge sampled on the virtual clock: parallel ``(t, value)``
    arrays, append-only.  Memory is one float pair per sample — bounded by
    the run length, and the exporter downsamples, never the collector."""

    __slots__ = ("name", "ts", "vs")

    def __init__(self, name: str):
        self.name = name
        self.ts: List[float] = []
        self.vs: List[float] = []

    def sample(self, t: float, value: float) -> None:
        self.ts.append(float(t))
        self.vs.append(float(value))

    def __len__(self) -> int:
        return len(self.ts)

    def last(self) -> Optional[float]:
        return self.vs[-1] if self.vs else None

    def between(self, t0: float, t1: float) -> List[float]:
        """Values sampled in ``[t0, t1)``."""
        return [v for t, v in zip(self.ts, self.vs) if t0 <= t < t1]

    def export(self, max_points: int = 0) -> Dict:
        """JSON-safe form; ``max_points`` > 0 downsamples with a
        deterministic stride (first-of-every-k plus the final sample) so
        artifacts stay diffable and bounded."""
        ts, vs = self.ts, self.vs
        n = len(ts)
        if max_points and n > max_points:
            step = -(-n // max_points)  # ceil
            idx = list(range(0, n, step))
            if idx[-1] != n - 1:
                idx.append(n - 1)
            ts = [ts[i] for i in idx]
            vs = [vs[i] for i in idx]
        return {"t": [round(t, 9) for t in ts],
                "v": [round(v, 9) for v in vs],
                "n_samples": n}


class MetricsPlane:
    """The live plane: gauge series + windowed latency histograms + a
    counter registry, all on the virtual clock.

    Zero-cost contract (mirrors the tracer): the disabled plane is the
    shared :data:`NULL_PLANE` singleton; every collection method returns
    before allocating, so instrumented code needs no ``if``.  An enabled
    plane is purely observational — it reads simulation state, it never
    steers it (priced times and logical IOPS/bytes are bit-identical with
    sampling on, tested).
    """

    def __init__(self, enabled: bool = True, window: float = 1.0,
                 n_windows: int = 8, rel_err: float = 0.01):
        self.enabled = bool(enabled)
        self.window = float(window)
        self.n_windows = int(n_windows)
        self.rel_err = float(rel_err)
        self.series: Dict[str, GaugeSeries] = {}
        self.latency: Dict[str, WindowedHistogram] = {}
        self.registry = MetricsRegistry()

    # -- collection ----------------------------------------------------------
    def gauge(self, name: str) -> GaugeSeries:
        g = self.series.get(name)
        if g is None:
            g = self.series[name] = GaugeSeries(name)
        return g

    def sample(self, name: str, t: float, value: float) -> None:
        """One gauge sample at virtual time ``t``; no-op when disabled."""
        if not self.enabled:
            return
        self.gauge(name).sample(t, value)

    def observe_latency(self, name: str, t: float, value: float) -> None:
        """One latency observation into the named windowed histogram."""
        if not self.enabled:
            return
        h = self.latency.get(name)
        if h is None:
            h = self.latency[name] = WindowedHistogram(
                self.window, self.n_windows, self.rel_err)
        h.observe(t, value)

    def counter(self, name: str):
        return self.registry.counter(name)

    # -- exporters -----------------------------------------------------------
    def to_trace(self, tracer, scale: float = 1e6) -> int:
        """Emit every gauge series as Perfetto counter-track (``"C"``)
        events into ``tracer``, timestamped on the *virtual* clock
        (``t * scale`` microseconds).  Returns the number of events."""
        n = 0
        for name in sorted(self.series):
            g = self.series[name]
            for t, v in zip(g.ts, g.vs):
                tracer.counter(name, {"value": v}, ts=t * scale)
                n += 1
        return n

    def prometheus_text(self) -> str:
        """Prometheus text exposition: registry counters/histograms, plus
        each gauge's last value and each windowed latency histogram as a
        cumulative-bucket ``histogram`` family."""
        from .metrics import _prom_name
        out = [prometheus_text(self.registry)]
        for name in sorted(self.series):
            g = self.series[name]
            if not g.vs:
                continue
            pn = _prom_name(name)
            out.append(f"# TYPE {pn} gauge\n{pn} {g.vs[-1]!r}\n")
        for name in sorted(self.latency):
            h = self.latency[name].merged()
            pn = _prom_name(name)
            lines = [f"# TYPE {pn} histogram"]
            cum = 0
            for ub, cnt in h.bucket_bounds():
                cum += cnt
                lines.append(f'{pn}_bucket{{le="{ub!r}"}} {cum}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{pn}_sum {h.sum!r}")
            lines.append(f"{pn}_count {h.count}")
            out.append("\n".join(lines) + "\n")
        return "".join(out)

    def export(self, max_points: int = 256) -> Dict:
        """The JSON form embedded in bench artifacts (NaN-free by
        construction) and rendered by ``tools/obs_report.py``."""
        return {
            "series": {name: g.export(max_points)
                       for name, g in sorted(self.series.items())},
            "latency": {name: h.summary()
                        for name, h in sorted(self.latency.items())},
            "counters": self.registry.counter_values(),
        }


NULL_PLANE = MetricsPlane(enabled=False)
