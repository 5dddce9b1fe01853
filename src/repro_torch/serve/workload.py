"""Multi-tenant Zipf serving workload over the dataset layer.

The "millions of users" shape from the ROADMAP: many concurrent takers with
Zipf-skewed row popularity (a small hot set absorbs most of the traffic,
a long cold tail keeps missing) driving ``DatasetReader.take`` through one
shared tiered store, optionally mixed with an ingest tenant whose appends
and flush runs compete for the same device queues.

This module only *generates and drives* the workload; the timing comes from
the scheduler's event-loop serving plane (:mod:`repro_torch.store.evloop`).  The
driver executes every request inside one :class:`~repro_torch.store.ServiceWindow`
so the same executed trace can be priced under interleaved event-loop
dispatch and under the old serial batch-drain, and per-tenant
p50/p99/p999 latency compared between the two — the serving benchmark's
headline gate.

Two arrival models (``ZipfWorkload(arrival=...)``):

* ``"open"`` (default, the seed behaviour) — a Poisson process at
  ``arrival_rate`` requests per virtual second.  Arrivals do not wait for
  responses, so queueing delay piles onto latency exactly as a loadgen
  firing on a schedule would measure it.
* ``"closed"`` — a fixed population of ``clients_per_tenant`` clients per
  tenant; each client issues its next request ``think_time`` virtual
  seconds after its previous response completes.  **Coordinated-omission
  caveat**: a closed loop *slows its own arrival process down* when the
  server degrades — queueing delay that an open-loop client would have
  measured simply never happens, because the stalled client isn't sending.
  Closed-loop percentiles therefore look flattering under saturation and
  must never be compared against open-loop ones as if they measured the
  same thing; the serve bench reports both side by side for exactly this
  contrast (see Schroeder et al., "Open Versus Closed", NSDI'06).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.slo import SLObjective
from ..store import (QoS, RetryPolicy, ServiceResult, ServiceWindow,
                     latency_percentiles)

__all__ = ["TenantSpec", "ServeRequest", "ZipfWorkload", "drive",
           "tenant_summary", "FaultScenario", "run_scenario"]


@dataclasses.dataclass
class TenantSpec:
    """One serving tenant: its share of the request stream and its QoS
    standing (weight feeds the event loop's weighted-fair round packing,
    priority its strict classes).

    ``slo_ms`` opts the tenant into SLO monitoring: "``slo_target`` of
    requests complete under ``slo_ms`` milliseconds of virtual time" —
    :meth:`ZipfWorkload.slo_objectives` lifts these into the
    :class:`~repro_torch.obs.SLOMonitor`'s objective map.  ``None`` (default)
    means no objective, and the monitor ignores the tenant."""

    name: str
    share: float = 1.0
    weight: float = 1.0
    priority: int = 0
    rows_per_request: int = 32
    slo_ms: Optional[float] = None
    slo_target: float = 0.99


@dataclasses.dataclass
class ServeRequest:
    """One arrival: a tenant asks for ``rows`` at virtual time ``at``.

    ``client`` is set only by the closed-loop generator: requests of one
    client form a chain (each issues after the previous one's response
    plus think time), and ``at`` is only the chain's starting offset."""

    tenant: str
    at: float
    rows: np.ndarray
    client: Optional[str] = None


class ZipfWorkload:
    """Deterministic multi-tenant request generator.

    Row popularity is bounded Zipf over the global row ids: row rank k is
    drawn with probability proportional to ``1 / k**zipf_s``, so low ids
    are hot (they share fragments, so the cache's sector granularity gets
    real spatial locality) and the tail stays cold.  Arrivals are a Poisson
    process at ``arrival_rate`` requests per virtual second (``arrival=
    "open"``) or a fixed-population think-time loop (``arrival="closed"``
    — see the module docstring's coordinated-omission caveat), tenants
    drawn by their ``share``.  Everything derives from ``seed`` — two
    instances with equal parameters generate identical request streams,
    which is what lets the benchmark compare dispatch models on the same
    workload.  The open-loop stream for a given (seed, n_requests, ...) is
    bit-identical to the seed behaviour regardless of the new knobs: the
    closed-loop parameters draw nothing from the generator in open mode."""

    def __init__(self, n_rows: int, tenants: Sequence[TenantSpec],
                 n_requests: int, zipf_s: float = 1.1,
                 arrival_rate: float = 50.0, seed: int = 0,
                 arrival: str = "open", think_time: float = 0.0,
                 clients_per_tenant: int = 4):
        if n_rows <= 0 or n_requests <= 0:
            raise ValueError("n_rows and n_requests must be positive")
        if arrival not in ("open", "closed"):
            raise ValueError(f"unknown arrival model {arrival!r}")
        self.n_rows = int(n_rows)
        self.tenants = list(tenants)
        self.n_requests = int(n_requests)
        self.zipf_s = float(zipf_s)
        self.arrival_rate = float(arrival_rate)
        self.seed = int(seed)
        self.arrival = arrival
        self.think_time = float(think_time)
        self.clients_per_tenant = max(1, int(clients_per_tenant))
        ranks = np.arange(1, self.n_rows + 1, dtype=np.float64)
        p = ranks ** -self.zipf_s
        self._popularity = p / p.sum()

    def qos(self, starvation_rounds: int = 16) -> QoS:
        """The QoS knobs implied by the tenant specs."""
        return QoS(weights={t.name: t.weight for t in self.tenants},
                   priority={t.name: t.priority for t in self.tenants},
                   starvation_rounds=starvation_rounds)

    def slo_objectives(self) -> Dict[str, SLObjective]:
        """Tenant name -> :class:`SLObjective` for every tenant that set
        ``slo_ms`` (the SLO monitor's objective map)."""
        return {t.name: SLObjective(latency_s=t.slo_ms / 1e3,
                                    target=t.slo_target)
                for t in self.tenants if t.slo_ms is not None}

    def generate(self) -> List[ServeRequest]:
        rng = np.random.default_rng(self.seed)
        shares = np.array([t.share for t in self.tenants], dtype=np.float64)
        shares /= shares.sum()
        who = rng.choice(len(self.tenants), size=self.n_requests, p=shares)
        if self.arrival == "open":
            gaps = rng.exponential(1.0 / self.arrival_rate,
                                   size=self.n_requests)
            arrivals = np.cumsum(gaps)
        out: List[ServeRequest] = []
        client_rr: Dict[str, int] = {}
        for k in range(self.n_requests):
            spec = self.tenants[int(who[k])]
            rows = rng.choice(self.n_rows, size=spec.rows_per_request,
                              p=self._popularity)
            rows = np.asarray(rows, dtype=np.int64)
            if self.arrival == "open":
                out.append(ServeRequest(spec.name, float(arrivals[k]), rows))
            else:
                # closed loop: round-robin the tenant's requests over its
                # client population; the driver chains each client's
                # requests on completion + think time, so `at` is just the
                # chain origin (everything starts "now")
                i = client_rr.get(spec.name, 0)
                client_rr[spec.name] = i + 1
                client = f"{spec.name}/c{i % self.clients_per_tenant}"
                out.append(ServeRequest(spec.name, 0.0, rows, client=client))
        return out


def drive(
    writer,
    column: str,
    requests: Sequence[ServeRequest],
    qos: Optional[QoS] = None,
    append_table=None,
    append_every: int = 0,
    commit_every: int = 4,
    think_time: float = 0.0,
) -> Tuple[ServiceResult, ServiceResult, ServiceWindow]:
    """Execute the request stream through ``writer``'s shared scheduler and
    price it under both dispatch models.

    Every take runs inside ``window.request`` (tenant + arrival tag); with
    ``append_table`` (a zero-arg callable returning a table) the ``ingest``
    tenant appends a fragment every ``append_every`` requests, committing
    every ``commit_every`` appends — so write-back flush runs land inside
    the window and share the queues with the reads, which is precisely the
    interleaving the tentpole is about.  Requests carrying a ``client``
    (closed-loop streams) are chained per client with ``think_time``
    virtual seconds between a response and the next issue.

    Returns ``(interleaved, serial, window)`` over the *same* executed
    workload: classification, cache state and accounting are identical,
    only the dispatch timing differs.  The window is returned so callers
    can re-price the captured jobs with a metrics plane, an SLO monitor,
    degraded devices, or different queue depths attached
    (``window.run(...)`` is pure)."""
    sch = writer.scheduler
    n_appends = 0
    with sch.service_window(qos) as win:
        for i, req in enumerate(requests):
            with win.request(tenant=req.tenant, at=req.at,
                             request=f"{req.tenant}/{i}",
                             client=req.client, think=think_time):
                writer.take(column, req.rows)
            if append_table is not None and append_every \
                    and (i + 1) % append_every == 0:
                n_appends += 1
                with win.request(tenant="ingest", at=req.at,
                                 request=f"ingest/{n_appends}"):
                    writer.append(append_table(),
                                  commit=(n_appends % commit_every == 0))
        interleaved = win.run("interleaved")
        serial = win.run("serial")
    return interleaved, serial, win


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One scripted chaos scenario: fault windows stamped onto named tiers
    of an already-executed :class:`~repro_torch.store.ServiceWindow`, plus the
    recovery knobs to price it with.

    ``faults`` maps device name -> fault schedule (``TransientErrors``,
    ``Blackout``, ``Degradation``, ...); a :class:`CorrelatedFault` is the
    one-window-many-tiers convenience for the same thing.  ``retry=None``
    keeps the window's compiled-in policy (the scheduler default);
    ``RetryPolicy(failover=False)`` is the ablation that shows failover
    earning its keep."""

    name: str
    faults: Tuple[Tuple[str, object], ...] = ()
    retry: Optional[RetryPolicy] = None
    description: str = ""

    def apply(self, devices) -> List:
        """Stamp the scenario's fault windows onto a device list (returned
        re-built; the input models are immutable and shared)."""
        by_name = {}
        for name, fault in self.faults:
            by_name.setdefault(name, []).append(fault)
        unknown = set(by_name) - {d.name for d in devices}
        if unknown:
            raise ValueError(f"unknown device(s) {sorted(unknown)}")
        out = []
        for d in devices:
            for fault in by_name.get(d.name, ()):
                d = d.with_fault(fault)
            out.append(d)
        return out


def run_scenario(window: ServiceWindow, scenario: FaultScenario,
                 qos: Optional[QoS] = None, slo=None,
                 shedder=None) -> ServiceResult:
    """Re-price a captured service window under one fault scenario.

    Pure in the window (``window.run`` never mutates captured jobs), so one
    executed trace can be driven through a whole scenario script; the
    ``shedder`` carries hysteresis state across a single run — rebuild or
    ``reset()`` it per scenario."""
    devices = scenario.apply(window.scheduler._devices())
    return window.run("interleaved", qos=qos, devices=devices,
                      retry=scenario.retry, slo=slo, shedder=shedder)


def tenant_summary(result: ServiceResult, tenants: Sequence[str],
                   scale: float = 1e3) -> Dict[str, Dict]:
    """Per-tenant nearest-rank latency summaries (default milliseconds),
    plus the whole-population row under ``"all"``."""
    out: Dict[str, Dict] = {}
    pops = {name: [] for name in tenants}
    everything = []
    for c in result.completions:
        everything.append(c.latency * scale)
        if c.tenant in pops:
            pops[c.tenant].append(c.latency * scale)
    for name in tenants:
        summary = latency_percentiles(pops[name])
        if summary is not None:
            out[name] = summary
    out["all"] = latency_percentiles(everything)
    return out
