"""Observability for the tiered IO stack: tracing, metrics, attribution.

Three pieces, layered below everything else in the package (no ``repro_torch``
imports at module level, so any layer can depend on ``obs``):

* :mod:`repro_torch.obs.trace` — span :class:`Tracer` with a Chrome/Perfetto
  trace-event exporter; zero-cost no-op when disabled (:data:`NULL_TRACER`).
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` of counters and
  histograms queryable from tests and the bench harness.
* :mod:`repro_torch.obs.attrib` — :func:`attribute` decomposes each tier's
  ``model_time`` onto the logical requests that occupied each queue drain,
  yielding per-request modeled latencies and p50/p99/p999 summaries.
* :mod:`repro_torch.obs.timeseries` — the live plane: mergeable log-bucket
  histograms, virtual-clock gauge series, and the :class:`MetricsPlane`
  container (zero-cost when disabled: :data:`NULL_PLANE`).
* :mod:`repro_torch.obs.slo` — per-tenant latency objectives and rolling
  multi-window error-budget burn-rate alerts (:class:`SLOMonitor`), plus
  the burn-driven admission :class:`Shedder` the event loop consults.
"""

from .attrib import Attribution, DrainCost, attribute
from .metrics import (Counter, Histogram, MetricsRegistry, percentile,
                      prometheus_text)
from .slo import (DEFAULT_WINDOWS, BurnWindow, Shedder, SLOAlert,
                  SLObjective, SLOMonitor)
from .timeseries import (NULL_PLANE, GaugeSeries, LogBucketHistogram,
                         MetricsPlane, WindowedHistogram)
from .trace import NULL_SPAN, NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Attribution",
    "BurnWindow",
    "Counter",
    "DEFAULT_WINDOWS",
    "DrainCost",
    "GaugeSeries",
    "Histogram",
    "LogBucketHistogram",
    "MetricsPlane",
    "MetricsRegistry",
    "NULL_PLANE",
    "NULL_SPAN",
    "NULL_TRACER",
    "NullTracer",
    "SLOAlert",
    "SLObjective",
    "SLOMonitor",
    "Shedder",
    "Tracer",
    "WindowedHistogram",
    "attribute",
    "percentile",
    "prometheus_text",
]
