"""The port's own steps and counters in a traced run's window, for the
metric readers.  The window is the one stretch of the run under
``torch.profiler``, and while a profiler records, the port's read path
(opened with no tracer of its own) gives its steps and step counters to
its process-wide recorder, ``repro_torch.obs.trace.PROFILER_STEPS``, which
starts afresh with each recording.  So after the window the recorder holds
the window's steps and counts alone.

Each function returns None for an untraced run, a window of no request, or
a port without the recorder (one older than it); else a number, 0 where
the window took no such step or count.
"""

from __future__ import annotations

from typing import Optional


def recorder(record):
    """The port's step recorder, or None (see above)."""
    if record.layer_s is None or not record.requests:
        return None
    try:
        from repro_torch.obs.trace import PROFILER_STEPS
    except ImportError:
        return None
    return PROFILER_STEPS


def self_ms(record, *steps: str) -> Optional[float]:
    """The summed self time of ``steps`` (each step's time less the steps
    nested in it), a request; ms."""
    rec = recorder(record)
    if rec is None:
        return None
    totals = rec.step_totals()
    own = sum(totals[name][2] for name in steps if name in totals)
    return own / record.requests * 1e3


def per_request(record, counter: str, scale: float = 1.0) -> Optional[float]:
    """The recorder's ``counter``, a request, times ``scale``."""
    rec = recorder(record)
    if rec is None:
        return None
    return rec.metrics.counter_values().get(counter, 0) / record.requests * scale
