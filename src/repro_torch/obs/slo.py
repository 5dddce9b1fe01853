"""Per-tenant SLO monitoring: latency objectives, rolling error budgets,
multi-window burn-rate alerts — all on the virtual clock.

The SLO model is the standard serving one.  A tenant's objective is
"fraction ``target`` of requests complete under ``latency_s``"; the
**error budget** is the allowed bad fraction ``1 - target``.  The **burn
rate** over a window is how fast that budget is being consumed::

    burn(window) = bad_fraction(window) / (1 - target)

Burn 1.0 means "exactly on budget"; burn 14 on a 99.9% objective means the
month's budget burns in ~2 days.  Single-window alerts are either slow
(long window → detection lag) or noisy (short window → one straggler
pages), so we use the multi-window form: alert only when **both** a long
and a short window exceed the threshold — the long window proves the
problem is material, the short window proves it is *still happening*
(and resets the alert promptly once the incident ends).

Everything is evaluated incrementally as completions land in the event
loop: :meth:`SLOMonitor.observe` is O(window occupancy) amortized, keeps a
per-tenant deque of ``(t, bad)`` pairs pruned to the longest window, and
emits on the *rising edge* only — one :class:`SLOAlert` per incident, an
``slo.breach.<tenant>`` counter increment, and an instant into the tracer
so the breach lands on the Perfetto timeline next to the utilization
counter tracks that explain it.  Times are virtual seconds throughout;
the monitor never touches the host clock, so alert timing is exactly
reproducible and the serve benchmark can *gate* detection latency.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry
from .timeseries import MetricsPlane, NULL_PLANE
from .trace import NULL_TRACER

__all__ = ["SLObjective", "BurnWindow", "SLOAlert", "SLOMonitor", "Shedder",
           "DEFAULT_WINDOWS"]


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """"``target`` of requests under ``latency_s`` virtual seconds"."""

    latency_s: float
    target: float = 0.99

    def __post_init__(self):
        if self.latency_s <= 0:
            raise ValueError("latency_s must be positive")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")

    @property
    def budget(self) -> float:
        """Allowed bad fraction (the error budget)."""
        return 1.0 - self.target


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """A long/short window pair with a shared burn-rate threshold."""

    long_s: float
    short_s: float
    burn_threshold: float = 2.0

    def __post_init__(self):
        if not 0 < self.short_s <= self.long_s:
            raise ValueError("need 0 < short_s <= long_s")
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be positive")


# Scaled-down analogue of the classic 1h/5m + 6h/30m page pairs: virtual
# serving runs span seconds, not hours, so windows do too.
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(long_s=2.0, short_s=0.25, burn_threshold=2.0),
)


@dataclasses.dataclass(frozen=True)
class SLOAlert:
    """One rising-edge burn alert (an incident start, not a sample)."""

    tenant: str
    at: float               # virtual time of the triggering completion
    window: BurnWindow
    burn_long: float
    burn_short: float


class _TenantState:
    __slots__ = ("events", "bad_total", "n_total", "active")

    def __init__(self, n_windows: int):
        # (t, bad) completions, pruned to the longest window
        self.events: Deque[Tuple[float, bool]] = deque()
        self.bad_total = 0
        self.n_total = 0
        self.active = [False] * n_windows  # per-BurnWindow rising-edge latch


class SLOMonitor:
    """Evaluates burn-rate objectives as completions land.

    ``objectives`` maps tenant name -> :class:`SLObjective`; tenants
    without an objective are ignored (observe is a cheap no-op for them).
    Counters land in ``registry`` (``slo.requests.<t>``, ``slo.bad.<t>``,
    ``slo.breach.<t>``), burn gauges in ``plane``
    (``slo.<t>.burn.<long_s>s``), alert instants in ``tracer``.
    """

    def __init__(self, objectives: Dict[str, SLObjective],
                 windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS,
                 tracer=NULL_TRACER, registry: Optional[MetricsRegistry] = None,
                 plane: MetricsPlane = NULL_PLANE):
        if not windows:
            raise ValueError("need at least one BurnWindow")
        self.objectives = dict(objectives)
        self.windows = tuple(windows)
        self.tracer = tracer
        self.registry = registry if registry is not None else MetricsRegistry()
        self.plane = plane
        self.alerts: List[SLOAlert] = []
        self._horizon = max(w.long_s for w in self.windows)
        self._tenants: Dict[str, _TenantState] = {}

    # -- core ----------------------------------------------------------------
    def observe(self, tenant: str, t: float, latency: float,
                error: bool = False) -> None:
        """Record one completion at virtual time ``t`` and re-evaluate the
        tenant's burn windows.  ``error=True`` marks a *failed* request
        (retries exhausted, no failover target): it consumes error budget
        unconditionally, whatever its latency — a fast failure is still a
        failure."""
        obj = self.objectives.get(tenant)
        if obj is None:
            return
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(len(self.windows))
        bad = error or latency > obj.latency_s
        st.events.append((t, bad))
        st.n_total += 1
        self.registry.counter(f"slo.requests.{tenant}").inc()
        if error:
            self.registry.counter(f"slo.errors.{tenant}").inc()
        if bad:
            st.bad_total += 1
            self.registry.counter(f"slo.bad.{tenant}").inc()
        # prune to the longest window (events arrive in completion order,
        # which the event loop emits with non-decreasing t)
        floor = t - self._horizon
        ev = st.events
        while ev and ev[0][0] < floor:
            ev.popleft()

        for wi, w in enumerate(self.windows):
            burn_long = self._burn(st, t, w.long_s, obj)
            burn_short = self._burn(st, t, w.short_s, obj)
            self.plane.sample(f"slo.{tenant}.burn.{w.long_s:g}s", t, burn_long)
            firing = (burn_long >= w.burn_threshold
                      and burn_short >= w.burn_threshold)
            if firing and not st.active[wi]:
                st.active[wi] = True  # rising edge: one alert per incident
                alert = SLOAlert(tenant=tenant, at=t, window=w,
                                 burn_long=burn_long, burn_short=burn_short)
                self.alerts.append(alert)
                self.registry.counter(f"slo.breach.{tenant}").inc()
                self.tracer.instant(
                    f"slo_breach:{tenant}", cat="slo",
                    args={"tenant": tenant, "t_virtual": t,
                          "burn_long": burn_long, "burn_short": burn_short,
                          "window_s": w.long_s,
                          "threshold": w.burn_threshold})
            elif not firing:
                st.active[wi] = False
        return None

    def _burn(self, st: _TenantState, t: float, window_s: float,
              obj: SLObjective) -> float:
        lo = t - window_s
        n = bad = 0
        # events is pruned to the longest window; scan newest-first and
        # stop at the window edge so short windows cost their occupancy
        for et, ebad in reversed(st.events):
            if et < lo:
                break
            n += 1
            bad += ebad
        if n == 0:
            return 0.0
        return (bad / n) / obj.budget

    # -- queries -------------------------------------------------------------
    def current_burn(self, tenant: str, t: float,
                     window_s: Optional[float] = None) -> float:
        """The tenant's burn rate over the trailing ``window_s`` seconds
        ending at virtual time ``t`` (default: the first configured long
        window).  0.0 for unknown tenants or empty windows — the query a
        :class:`Shedder` polls at admission time."""
        obj = self.objectives.get(tenant)
        st = self._tenants.get(tenant)
        if obj is None or st is None:
            return 0.0
        if window_s is None:
            window_s = self.windows[0].long_s
        return self._burn(st, t, float(window_s), obj)

    def first_alert(self, tenant: str) -> Optional[SLOAlert]:
        for a in self.alerts:
            if a.tenant == tenant:
                return a
        return None

    def breach_counts(self) -> Dict[str, int]:
        return self.registry.counter_values("slo.breach.")

    def table(self) -> List[Dict]:
        """Per-tenant summary rows (the obs_report SLO table)."""
        rows = []
        for tenant in sorted(self.objectives):
            obj = self.objectives[tenant]
            st = self._tenants.get(tenant)
            n = st.n_total if st else 0
            bad = st.bad_total if st else 0
            first = self.first_alert(tenant)
            rows.append({
                "tenant": tenant,
                "objective_ms": obj.latency_s * 1e3,
                "target": obj.target,
                "requests": n,
                "bad": bad,
                "bad_fraction": (bad / n) if n else None,
                "budget": obj.budget,
                "breaches": self.registry.counter(
                    f"slo.breach.{tenant}").value,
                "first_alert_t": first.at if first else None,
            })
        return rows


class Shedder:
    """SLO-driven load shedding with hysteresis.

    Watches the *protected* tenants' multi-window burn through a
    :class:`SLOMonitor` and, while any of them is burning budget faster
    than ``on_burn`` on **both** the long and short window (the same
    both-windows rule the alerts use: the long window proves the problem
    is material, the short one that it is still happening), rejects
    incoming requests from the ``shed`` tenants.  Shedding stays engaged
    until the worst protected burn falls below ``off_burn`` — the
    hysteresis band keeps the policy from flapping at the threshold as
    shed load itself relieves the burn.

    The event loop calls :meth:`admit` once per job arrival (on the
    virtual clock, before the job consumes any queue slot); a rejected
    job completes immediately with ``error="shed"`` and is *not* fed to
    the SLO monitor — rejections are the policy's output, not evidence
    about the protected tenants' service.  Stateful across one run: call
    :meth:`reset` (or build a fresh instance) before re-running a window
    so repeated runs stay pure.
    """

    def __init__(self, monitor: SLOMonitor, protect, shed,
                 on_burn: float = 4.0, off_burn: float = 1.0,
                 hold_s: float = 0.0,
                 window: Optional[BurnWindow] = None):
        if on_burn <= off_burn:
            raise ValueError("need on_burn > off_burn (hysteresis band)")
        if hold_s < 0:
            raise ValueError("hold_s must be >= 0")
        self.monitor = monitor
        self.protect = tuple(protect)
        self.shed = frozenset(shed)
        if self.shed & set(self.protect):
            raise ValueError("a tenant cannot be both protected and shed")
        self.on_burn = float(on_burn)
        self.off_burn = float(off_burn)
        # hold-down: release only after the burn has stayed below off_burn
        # for hold_s seconds.  The level band alone cannot prevent limit
        # cycling — successful shedding drives the burn to zero while the
        # underlying fault persists, so a pure level release re-admits the
        # flood and re-trips; the timer makes the controller wait out the
        # dip before trusting it.
        self.hold_s = float(hold_s)
        self.window = window if window is not None else monitor.windows[0]
        self.active = False
        self.trips = 0          # rising edges (shedding engagements)
        self.engaged_at: List[float] = []
        self.released_at: List[float] = []
        self._below_since: Optional[float] = None

    def reset(self) -> None:
        """Forget the hysteresis state (for pure re-runs)."""
        self.active = False
        self.trips = 0
        self.engaged_at = []
        self.released_at = []
        self._below_since = None

    def _worst_burn(self, t: float) -> float:
        w = self.window
        worst = 0.0
        for tenant in self.protect:
            # both-windows firing burn: min(long, short) >= threshold
            # iff both exceed it
            b = min(self.monitor.current_burn(tenant, t, w.long_s),
                    self.monitor.current_burn(tenant, t, w.short_s))
            if b > worst:
                worst = b
        return worst

    def admit(self, tenant: str, t: float) -> bool:
        """Admission decision for one arrival at virtual time ``t``;
        updates the hysteresis state machine as a side effect."""
        burn = self._worst_burn(t)
        if self.active:
            if burn < self.off_burn:
                if self._below_since is None:
                    self._below_since = t
                if t - self._below_since >= self.hold_s:
                    self.active = False
                    self._below_since = None
                    self.released_at.append(t)
            else:
                self._below_since = None
        elif burn >= self.on_burn:
            self.active = True
            self._below_since = None
            self.trips += 1
            self.engaged_at.append(t)
        return not (self.active and tenant in self.shed)
