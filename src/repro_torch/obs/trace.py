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

The tracer's own events carry host-wall microseconds since tracer
construction (``time.perf_counter``), which order and time the host's work
but line up with no profiler.  Under ``steps=True`` the same boundaries are
also ``torch.profiler.record_function`` ranges, which a running profiler
records on its own clock beside the device's kernels and copies (see
*Steps* below).  :meth:`Tracer.export` writes the standard
``{"traceEvents": [...]}`` JSON object form — open it at
https://ui.perfetto.dev or ``chrome://tracing``.

**Steps** (``Tracer(steps=True)``, off by default): :meth:`Tracer.step`
opens a ``<module>.<step>`` region inside a layer (``miniblock.pack``,
``store.gather``, ``device.h2d``, ...), recorded as an ``"X"`` event of
``cat="step"`` and summed by name into :meth:`Tracer.step_totals` (calls,
total and self seconds, self time being the duration less the part covered
by nested steps and spans).  Under ``steps=True`` every step *and every
span* is also a ``torch.profiler.record_function`` range of the same name,
so a profiler running over the program sees the program's own boundaries
on the profiler's clock and can name each device idle gap by what the host
was doing.  :meth:`Tracer.tally`
and :meth:`Tracer.usage` feed step-level counters into ``metrics``.

A tracer without steps (``steps=False``, and :data:`NULL_TRACER`, which
every path without a tracer of its own uses) hands its steps and step
counters to the process's recorder, :data:`PROFILER_STEPS`, while a
``torch.profiler`` records in the process, and drops them otherwise: then
``step()`` and ``usage()`` return :data:`NULL_SPAN` and ``tally()`` does
nothing.  So a profile of a program that opened no tracer still holds the
program's steps, and its events are never touched: the default event
stream is the same with or without a profiler.  The recorder keeps the
totals and counters of one recording at a time (see :class:`ProfilerSteps`)
and no events of its own, the profiler's trace being their record.  One
stack of open regions is kept a tracer: the read path is one thread, and
steps are for one thread.
"""

from __future__ import annotations

import json
import resource
import time
from typing import Dict, List, Optional, Tuple

from .metrics import MetricsRegistry

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN", "ProfilerSteps",
           "PROFILER_STEPS"]


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

    __slots__ = ("_tracer", "name", "cat", "args", "_ts", "tid", "_range")

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
        if self._tracer.steps:
            self._range = self._tracer._open(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        dur = tr._now_us() - self._ts
        tr.events.append({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self._ts, "dur": dur,
            "pid": tr.pid,
            "tid": self.tid if self.tid is not None else tr.tid,
            "args": self.args,
        })
        if tr.steps:
            tr._close(self._range, dur * 1e-6)
        return False


class _Step:
    """One open step of a tracer with steps; on exit it is added to the
    tracer's per-name totals and, where the tracer keeps events, appended as
    a ``cat="step"`` event."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **args) -> None:
        """Attach/overwrite step args from inside the region."""
        self.args.update(args)

    def __enter__(self) -> "_Step":
        self._range = self._tracer._open(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        dur = time.perf_counter() - self._t0
        own = tr._close(self._range, dur)
        tot = tr._totals.get(self.name)
        if tot is None:
            tot = tr._totals[self.name] = [0, 0.0, 0.0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += own
        if tr.keeps_events:
            tr.events.append({
                "name": self.name, "cat": "step", "ph": "X",
                "ts": (self._t0 - tr._t0) * 1e6, "dur": dur * 1e6,
                "pid": tr.pid, "tid": tr.tid, "args": self.args,
            })
        return False


def _thread_usage():
    return resource.getrusage(getattr(resource, "RUSAGE_THREAD",
                                      resource.RUSAGE_SELF))


class _Usage:
    """System time of the calling thread across a region (a tracer with
    steps only)."""

    __slots__ = ("_tracer", "_prefix", "_span", "_t0")

    def __init__(self, tracer: "Tracer", prefix: str, span):
        self._tracer = tracer
        self._prefix = prefix
        self._span = span

    def __enter__(self) -> "_Usage":
        self._t0 = _thread_usage().ru_stime
        return self

    def __exit__(self, *exc) -> bool:
        sys_us = round((_thread_usage().ru_stime - self._t0) * 1e6)
        self._tracer.tally(f"{self._prefix}.sys_us", sys_us)
        self._span.set(sys_us=sys_us)
        return False


class Tracer:
    """Collects Chrome-trace events; ``enabled=False`` is a strict no-op.

    One tracer per IO path: pass it to ``FileReader``/``DatasetReader``/
    ``DatasetWriter`` (or directly to ``IOScheduler``) and every layer below
    shares it.  ``metrics`` is a :class:`~repro_torch.obs.metrics.MetricsRegistry`
    fed alongside the event list (fallback-reason counters, span-less
    counts) so tests can query aggregates without parsing the trace.

    ``steps=True`` (with ``enabled``) turns on :meth:`step`, the per-name
    step totals, the step counters and a ``torch.profiler.record_function``
    range around every span and step (see the module docstring).  Without
    it, steps and step counters go to :data:`PROFILER_STEPS` while a
    profiler records.  The read path that opens them is one thread: one
    stack of open regions is kept.
    """

    keeps_events = True  # False for the process's step recorder alone

    def __init__(self, enabled: bool = True, pid: int = 1, tid: int = 1,
                 steps: bool = False):
        self.enabled = bool(enabled)
        self.steps = self.enabled and bool(steps)
        self.pid = pid
        self.tid = tid
        self.events: List[Dict] = []
        self.metrics = MetricsRegistry()
        self._tracks: Dict[str, int] = {}
        self._t0 = time.perf_counter()
        self._totals: Dict[str, list] = {}  # step name -> [calls, total_s, self_s]
        self._stack: List[float] = []  # seconds covered by nested regions

    def _open(self, name: str):
        """Enter a nested region (a span or step under ``steps``): its
        profiler range, and a frame on the stack for its self time."""
        rf = _torch_profiler()[1](name)
        rf.__enter__()
        self._stack.append(0.0)
        return rf

    def _close(self, rf, dur_s: float) -> float:
        """Leave the region :meth:`_open` entered; returns its self time."""
        covered = self._stack.pop()
        if self._stack:
            self._stack[-1] += dur_s
        rf.__exit__(None, None, None)
        return dur_s - covered

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

    def _steps_to(self) -> Optional["Tracer"]:
        """Where this tracer's steps go: itself under ``steps=True``, else
        :data:`PROFILER_STEPS` while a profiler records, else nowhere."""
        if self.steps:
            return self
        return PROFILER_STEPS if PROFILER_STEPS.recording() else None

    def step(self, name: str, **args):
        """Open a step (context manager) named ``<module>.<step>``: one per
        call of a phase, never inside a per-row loop.  Returns the shared
        :data:`NULL_SPAN` unless the tracer was built with ``steps=True`` or
        a profiler records (then the step is :data:`PROFILER_STEPS`')."""
        to = self._steps_to()
        return NULL_SPAN if to is None else _Step(to, name, args)

    def step_totals(self) -> Dict[str, Tuple[int, float, float]]:
        """``{name: (calls, total_s, self_s)}`` of every step since
        construction or :meth:`reset`."""
        return {k: (v[0], v[1], v[2]) for k, v in self._totals.items()}

    def tally(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` in the ``metrics`` of where the steps
        go (a step-level count, such as chunks decoded); nothing where they
        go nowhere."""
        to = self._steps_to()
        if to is not None:
            to.metrics.counter(name).inc(n)

    def usage(self, prefix: str, span=NULL_SPAN):
        """Context manager: the calling thread's system time
        (``getrusage(RUSAGE_THREAD)``'s ``ru_stime``) across the region, in
        µs, added to the counter ``<prefix>.sys_us`` and set as ``span``'s
        ``sys_us`` arg.  :data:`NULL_SPAN` where the steps go nowhere."""
        to = self._steps_to()
        return NULL_SPAN if to is None else _Usage(to, prefix, span)

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
        self._totals = {}
        self._t0 = time.perf_counter()


class NullTracer(Tracer):
    """The always-disabled tracer; :data:`NULL_TRACER` is the one instance
    instrumented objects default to."""

    def __init__(self):
        super().__init__(enabled=False)


NULL_TRACER = NullTracer()


_PROFILER = None  # (torch.autograd._profiler_enabled, record_function)


def _torch_profiler():
    """torch's profiler state query and ``record_function``, imported at
    first use (``obs`` imports no package at module level)."""
    global _PROFILER
    if _PROFILER is None:
        from torch.autograd import _profiler_enabled
        from torch.profiler import record_function

        _PROFILER = (_profiler_enabled, record_function)
    return _PROFILER


class ProfilerSteps(Tracer):
    """The process's step recorder: the steps and step counters of every
    tracer without steps, while a ``torch.profiler`` records in the process
    (each step also a ``record_function`` range in that profile).  It keeps
    :meth:`step_totals` and ``metrics`` and no events.

    Its totals and counters are reset by the first :meth:`recording` call
    that finds a profiler recording after one found none, so they hold the
    recording under way or the last one: read them after the profiler has
    stopped and before the next recording's first step.  Two recordings
    with no step, tally or usage between them are summed as one.
    """

    keeps_events = False

    def __init__(self):
        super().__init__(steps=True)
        self._was_recording = False

    def recording(self) -> bool:
        """Whether a profiler records now (and the reset described above)."""
        on = _torch_profiler()[0]()
        if on and not self._was_recording:
            self.reset()
        self._was_recording = on
        return on


PROFILER_STEPS = ProfilerSteps()
