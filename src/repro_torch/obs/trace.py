"""Lightweight span tracer with a Chrome/Perfetto trace-event exporter.

The observability layer's data plane: every layer of the read/write stack
(``FileReader``/``DatasetReader``/``DatasetWriter`` at the top, the
``IOScheduler``'s open -> coalesce -> classify -> dispatch -> drain pipeline,
``FlushPolicy`` drains, the kernel decode route) opens spans on the tracer
threaded through the :class:`~repro_torch.store.IOScheduler`.  Three event kinds:

* **spans** (``ph: "X"`` complete events) — timed regions, context-manager
  API, nestable;
* **instants** (``ph: "i"``) — structured point events: admission-policy
  flips, flush-on-evict writes, and the *fallback-reason* telemetry (a
  ``pallas_fallback`` event, the JAX package's name, whenever
  ``decode="device"`` routes a decode to the host, with the reason — float
  values, variable-width leaf, >31-bit packing, opaque codec — in
  ``args``);
* **counters** (``ph: "C"``) — counter tracks sampled at batch close: queue
  depth, per-tier hit rate, resident/dirty bytes.

Zero-cost when disabled: the default tracer is the module singleton
:data:`NULL_TRACER` (``enabled=False``); its ``span()`` returns the shared
:data:`NULL_SPAN` singleton, so a disabled trace allocates **no span
objects** and appends nothing.  Instrumented code never needs an ``if``:
``with tracer.span(...)`` is safe and free either way.  The hard contract
(tested): logical IOPS/bytes and every priced time are bit-identical whether
tracing is on or off — the tracer observes the pipeline, it never steers it.

Timestamps are host-wall microseconds since tracer construction
(``time.perf_counter``): they time the *simulation's* orchestration work.
The modelled device time lives in span ``args`` where the instrumentation
site provides it.  :meth:`Tracer.export` writes the standard
``{"traceEvents": [...]}`` JSON object form — open it at
https://ui.perfetto.dev or ``chrome://tracing``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from .metrics import MetricsRegistry

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN"]


class _NullSpan:
    """Shared no-op span: entering/exiting does nothing, setting args is
    swallowed.  A module singleton — disabled tracing allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """One open span; appended to the tracer's event list on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_ts", "tid")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict,
                 tid: Optional[int] = None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.tid = tid
        self._ts = tracer._now_us()

    def set(self, **args) -> None:
        """Attach/overwrite span args from inside the region."""
        self.args.update(args)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        tr.events.append({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self._ts, "dur": tr._now_us() - self._ts,
            "pid": tr.pid,
            "tid": self.tid if self.tid is not None else tr.tid,
            "args": self.args,
        })
        return False


class Tracer:
    """Collects Chrome-trace events; ``enabled=False`` is a strict no-op.

    One tracer per IO path: pass it to ``FileReader``/``DatasetReader``/
    ``DatasetWriter`` (or directly to ``IOScheduler``) and every layer below
    shares it.  ``metrics`` is a :class:`~repro_torch.obs.metrics.MetricsRegistry`
    fed alongside the event list (fallback-reason counters, span-less
    counts) so tests can query aggregates without parsing the trace.
    """

    def __init__(self, enabled: bool = True, pid: int = 1, tid: int = 1):
        self.enabled = bool(enabled)
        self.pid = pid
        self.tid = tid
        self.events: List[Dict] = []
        self.metrics = MetricsRegistry()
        self._tracks: Dict[str, int] = {}
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- event API -----------------------------------------------------------
    def span(self, name: str, cat: str = "io", tid: Optional[int] = None,
             **args):
        """Open a timed span (context manager).  ``tid`` overrides the
        tracer's default track — the scheduler uses one track per request so
        concurrent takers render as separate Perfetto lanes.  Returns the
        shared :data:`NULL_SPAN` when disabled — no allocation, no
        recording."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args, tid=tid)

    def track(self, key: Optional[str]) -> int:
        """Intern ``key`` as a stable per-request track id (tid).

        The first time a key is seen a Chrome ``thread_name`` metadata event
        is emitted so Perfetto labels the lane with the request id; repeat
        calls return the same tid.  ``None`` (or disabled) falls back to the
        tracer's default track."""
        if not self.enabled or key is None:
            return self.tid
        tid = self._tracks.get(key)
        if tid is None:
            tid = self.tid + 1 + len(self._tracks)
            self._tracks[key] = tid
            self.events.append({
                "name": "thread_name", "ph": "M", "ts": self._now_us(),
                "pid": self.pid, "tid": tid, "args": {"name": str(key)},
            })
        return tid

    def instant(self, name: str, cat: str = "event", **args) -> None:
        """A structured point event (thread-scoped instant)."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._now_us(), "pid": self.pid, "tid": self.tid,
            "args": args,
        })

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "counter", ts: Optional[float] = None) -> None:
        """One sample on a counter track (Perfetto renders each key as a
        series under the track ``name``).  ``ts`` overrides the host-clock
        timestamp with an explicit microsecond value — the metrics plane
        uses this to replay virtual-clock gauge series as counter tracks
        (``MetricsPlane.to_trace``) so they line up with the simulated
        timeline rather than orchestration wall time."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "C",
            "ts": self._now_us() if ts is None else float(ts),
            "pid": self.pid, "tid": self.tid,
            "args": dict(values),
        })

    def fallback(self, encoding: str, reason: str, **args) -> None:
        """The structured *fallback-reason* event: ``decode="device"`` routed
        (part of) a decode to the host.  ``encoding`` is the route
        (``miniblock``/``fullzip``), ``reason`` a stable slug
        (``float-values``, ``variable-width-leaf``, ``>31-bit``,
        ``opaque-codec:<name>``, ...).  Counted in ``metrics`` under
        ``decode.fallback.<encoding>.<reason>`` for test/CI queries."""
        if not self.enabled:
            return
        self.metrics.counter(f"decode.fallback.{encoding}.{reason}").inc()
        self.instant("pallas_fallback", cat="decode",
                     encoding=encoding, reason=reason, **args)

    # -- export --------------------------------------------------------------
    def trace_events(self) -> Dict:
        """The Chrome trace-event JSON object form."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the trace to ``path``; returns the number of events.
        ``allow_nan=False`` — a NaN in any event is a bug, not an artifact
        feature (see the bench NaN-leak fix)."""
        with open(path, "w") as f:
            json.dump(self.trace_events(), f, allow_nan=False)
        return len(self.events)

    def reset(self) -> None:
        self.events = []
        self.metrics = MetricsRegistry()
        self._tracks = {}
        self._t0 = time.perf_counter()


class NullTracer(Tracer):
    """The always-disabled tracer; :data:`NULL_TRACER` is the one instance
    instrumented objects default to."""

    def __init__(self):
        super().__init__(enabled=False)


NULL_TRACER = NullTracer()
