"""Event-loop dispatch simulation over the tiered store's drain log.

The scheduler's accounting model (PR 6) archives every completed queue drain
as a :class:`~repro_torch.store.stats.DrainRecord`: per tier, per dependency phase,
the op and byte buckets the drain moved.  Until now those drains were priced
*serially* — each batch paid its full queue-depth-limited round-trip cost
before the next batch started, so flushes stalled between read batches and
concurrent takers queued end to end.  This module replaces that timing model
with an event-loop simulation while leaving the accounting plane untouched:

* every drain record becomes a :class:`Job` — an ordered chain of per
  (phase, tier) *units*, each carrying its latency rounds (``ceil(ops/qd)``
  round trips) and its share of the tier's throughput-pipe time;
* each tier keeps an **outstanding-request table** bounded by the queue
  depth: when a tier starts a round it packs up to ``queue_depth`` ops from
  *all* pending units — read batches from many concurrent requests and
  ``FlushPolicy`` write runs share the same queue, so round-trip latency
  amortizes across jobs exactly the way the paper's deep-queue NVMe argument
  says it should;
* a **virtual-clock completion heap** orders round completions, pipe drains
  and job arrivals; completions are naturally *reordered* — a small warm job
  submitted after a large cold one can finish first;
* **QoS knobs** (:class:`QoS`): per-tenant weighted queue admission
  (weighted-fair round packing by served-ops/weight), strict priority
  classes, and a starvation guard that front-runs any unit that has been
  overtaken by later-arriving work for ``starvation_rounds`` rounds.

Hard contract — *lone-job degeneration*: a job simulated alone completes in
exactly its serial-drain price, i.e. the same per-(batch, phase) arithmetic
as :meth:`TierStats.model_time <repro_torch.store.stats.TierStats.model_time>`
applied to that one drain.  The per-tier throughput term is split across the
job's phase units byte-proportionally with exact remainder assignment (the
same scheme as :func:`repro_torch.obs.attribute`), so the unit chain telescopes
back to ``tp + sum(ceil(ops/qd) * latency)`` per tier.  With no concurrency
the event loop *is* the old serial drain; concurrency only shares rounds, it
never invents bandwidth (the pipe is FCFS and work-conserving).

Nothing here feeds back into pricing or classification: the event loop is a
timing overlay over drains that already happened, which is what keeps the
logical trace and the per-tier accounting bit-identical whether or not a
service window is open.

PR 8 additions, all on the interleaved path and all observational or
explicitly opted into:

* **per-tier queue depths** — ``queue_depths={"nvme": 64, "s3": 8}``
  overrides the shared depth per device name (serial pricing and the
  lone-job degeneration contract hold per tier);
* **live metrics plane** — pass a :class:`~repro_torch.obs.MetricsPlane` and the
  loop samples per-tier utilization / outstanding-window occupancy /
  pipe-backlog gauges at round boundaries and ``jobs.in_flight`` at
  arrival/completion, all on the virtual clock.  Sampling is read-only:
  completions are bit-identical with the plane on or off (tested);
* **SLO hook** — pass a :class:`~repro_torch.obs.SLOMonitor` and every job
  completion feeds its tenant's burn-rate windows as it lands;
* **fault injection** — :class:`~repro_torch.core.io_sim.Degradation` entries on
  a tier's :class:`DeviceModel` stretch that tier's round latency and pipe
  drain while active.  Only the interleaved loop consults the fault
  schedule; serial pricing and the accounting plane never see it, so
  committed baselines stay bit-identical while the serve bench degrades
  NVMe mid-run and gates the SLO alert;
* **closed-loop arrivals** — a job with ``after=<job>`` is held until its
  dependency completes, then arrives ``think`` virtual seconds later
  (the :class:`ServiceWindow` wires per-client chains; see
  ``repro_torch.serve.workload`` for the coordinated-omission caveat).

PR 9 adds the failure/recovery layer, again interleaved-only and again
invisible on the healthy path:

* **transient errors** — :class:`~repro_torch.core.io_sim.TransientErrors` /
  :class:`~repro_torch.core.io_sim.Blackout` entries on a tier's fault schedule
  fail individual ops *after they consume their round trip* (window
  membership judged at round-completion time, draws deterministic in the
  fault seed);
* **retry / timeout / backoff** — a unit whose round loses ops re-queues
  the failed slots and re-arms after a deterministic exponential backoff
  with seeded jitter (heap kind 3), bounded by
  :class:`RetryPolicy.max_retries` and a per-unit deadline of
  ``timeout_k ×`` its healthy expected service time;
* **tier failover** — a unit that exhausts retries against a faulted tier
  is re-dispatched against the next (slower) tier, re-priced at that
  tier's device model for the surviving slots; a unit that exhausts on
  the last tier (or with failover disabled) fails its whole job, which
  surfaces as a :class:`JobCompletion` with ``error`` set — never an
  exception;
* **load shedding** — an :class:`~repro_torch.obs.slo.Shedder` consulted at
  arrival can reject a job outright (``error="shed"``), trading the
  lowest-priority tenants' admissions for the protected tenants' burn
  rate;
* **counters** — ``retry.<dev>``, ``failover.<dev>``, ``error.<tenant>``,
  ``shed.<tenant>`` land in :attr:`ServiceResult.counters` (and on the
  metrics plane when attached).

The retry machinery only allocates state on tiers whose device schedule
*can* fail ops (``DeviceModel.has_error_faults``): with no error faults —
including ``TransientErrors(error_prob=0)`` — every run is bit-identical
to the pre-recovery loop, which is what keeps all committed baselines
pinned with the recovery layer compiled in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.io_sim import DeviceModel, _splitmix_uniform
from ..obs.metrics import percentile
from ..obs.timeseries import NULL_PLANE, MetricsPlane
from .stats import DrainRecord

__all__ = ["QoS", "RetryPolicy", "Job", "JobCompletion", "ServiceResult",
           "ServiceWindow", "EventLoop", "build_job", "latency_percentiles"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Recovery knobs for the interleaved loop.

    A unit whose round loses ops to an error fault re-queues the failed
    slots and re-arms after ``backoff_base * backoff_factor**k`` seconds
    (k = completed backoffs), stretched by up to ``jitter`` relative
    seeded jitter — the delay is priced purely as virtual-clock time, it
    occupies no queue slot.  The unit gives up when it has burned
    ``max_retries`` backoffs *or* blows its deadline of ``timeout_k ×``
    its healthy expected service time (``ceil(ops/qd)·latency + pipe``),
    whichever comes first; deadlines are only ever checked when a failure
    actually occurred, so they cannot perturb healthy runs.  On give-up,
    ``failover=True`` re-dispatches the surviving slots against the next
    (slower) tier, re-priced at that tier's model; otherwise — or when
    already on the last tier — the whole job fails with a per-request
    ``error``.  All draws key off ``seed``: same policy + same fault
    schedule ⇒ bit-identical replay."""

    max_retries: int = 4
    backoff_base: float = 1e-3
    backoff_factor: float = 2.0
    jitter: float = 0.5
    timeout_k: float = 8.0
    failover: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base < 0 or self.backoff_factor < 1.0:
            raise ValueError("need backoff_base >= 0 and backoff_factor >= 1")
        if self.jitter < 0:
            raise ValueError("jitter must be >= 0")
        if self.timeout_k <= 0:
            raise ValueError("timeout_k must be positive")


@dataclasses.dataclass
class QoS:
    """Fairness/priority knobs for interleaved round packing.

    ``weights`` biases the weighted-fair share (a tenant with weight 4 gets
    ~4x the round slots of a weight-1 tenant under contention); ``priority``
    maps tenants to strict classes (higher served first — a lower class only
    gets slots the higher classes left free); ``starvation_rounds`` bounds
    how long strict priority can starve anyone: a unit *overtaken by
    later-arriving work* for that many rounds jumps the whole order
    (waiting behind earlier arrivals is ordinary queueing and does not
    age)."""

    weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    priority: Dict[str, int] = dataclasses.field(default_factory=dict)
    default_weight: float = 1.0
    starvation_rounds: int = 16

    def weight_for(self, tenant: str) -> float:
        w = float(self.weights.get(tenant, self.default_weight))
        return w if w > 0.0 else 1e-9

    def priority_for(self, tenant: str) -> int:
        return int(self.priority.get(tenant, 0))


class _Unit:
    """One (phase, tier) slice of a job: ``ops`` queue slots to win plus a
    ``pipe`` share of the tier's throughput term."""

    __slots__ = ("job", "tier", "phase", "dev", "ops", "nbytes", "pipe",
                 "seq", "ops_left", "wait_rounds", "retry_q", "backoffs",
                 "deadline")

    def __init__(self, job: "Job", tier: int, phase: int, dev: DeviceModel,
                 ops: int, nbytes: int, pipe: float):
        self.job = job
        self.tier = tier
        self.phase = phase
        self.dev = dev
        self.ops = int(ops)
        self.nbytes = int(nbytes)
        self.pipe = float(pipe)
        self.seq = 0          # global arrival order, assigned at run time
        self.ops_left = 0     # per-run state (reset by EventLoop.run)
        self.wait_rounds = 0
        # recovery state, allocated only on error-faulted tiers:
        # (slot, attempt) pairs still owed, backoffs burned, give-up time
        self.retry_q: Optional[List[Tuple[int, int]]] = None
        self.backoffs = 0
        self.deadline: Optional[float] = None


class Job:
    """One drain record lifted into the event loop: an ordered unit chain
    (phase-major, fastest tier first within a phase) plus serving metadata."""

    __slots__ = ("label", "tenant", "weight", "request", "n_requests",
                 "submit", "seq", "units", "_next", "after", "think")

    def __init__(self, label: str, tenant: str = "default",
                 weight: Optional[float] = None,
                 request: Optional[str] = None, n_requests: int = 0,
                 submit: float = 0.0, seq: int = 0,
                 after: Optional["Job"] = None, think: float = 0.0):
        self.label = label
        self.tenant = tenant
        self.weight = weight
        self.request = request
        self.n_requests = int(n_requests)
        self.submit = float(submit)
        self.seq = int(seq)
        self.units: List[_Unit] = []
        self._next = 0
        # closed-loop dependency: this job arrives `think` virtual seconds
        # after `after` completes (if `after` is in the same run), instead
        # of at its nominal `submit` time.
        self.after = after
        self.think = float(think)

    def serial_time(self, queue_depth: int,
                    queue_depths: Optional[Dict[str, int]] = None) -> float:
        """The job's old-world price: every unit strictly sequential —
        ``sum(ceil(ops/qd) * latency + pipe)`` over the chain, which is
        exactly ``TierStats.model_time`` restricted to this one drain.
        ``queue_depths`` overrides the shared depth per device name, the
        same per-tier fallback rule as the event loop."""
        qd0 = max(1, int(queue_depth))
        t = 0.0
        # accumulate per tier in chain order so the float summation order
        # matches model_time's (tp first, then the phase latency terms)
        per_tier: Dict[int, Tuple[float, float]] = {}
        for u in self.units:
            qd = qd0
            if queue_depths:
                qd = max(1, int(queue_depths.get(u.dev.name, qd0)))
            tp, lat = per_tier.get(u.tier, (0.0, 0.0))
            per_tier[u.tier] = (tp + u.pipe,
                                lat + math.ceil(u.ops / qd) * u.dev.latency)
        for tp, lat in per_tier.values():
            t += tp + lat
        return t


@dataclasses.dataclass
class JobCompletion:
    """One job's completion record on the virtual clock.  ``error`` is
    ``None`` for a served request, ``"shed"`` for an admission rejection,
    or ``"io:<device>"`` when retries + failover were exhausted — failures
    are data, never exceptions."""

    label: str
    tenant: str
    request: Optional[str]
    n_requests: int
    submit: float
    done: float
    error: Optional[str] = None

    @property
    def latency(self) -> float:
        return self.done - self.submit

    @property
    def ok(self) -> bool:
        return self.error is None


def build_job(
    record: DrainRecord,
    devices: Sequence[DeviceModel],
    *,
    tenant: str = "default",
    weight: Optional[float] = None,
    request: Optional[str] = None,
    submit: float = 0.0,
    seq: int = 0,
) -> Job:
    """Lift one drain record into a :class:`Job`.

    ``devices`` is the store's tier order (fastest level first, backing
    last) — the same indexing the record's ``tiers`` dict uses.  Per tier,
    the throughput term is computed with the *identical* arithmetic as
    ``TierStats.model_time`` over that tier's slice of the drain (average op
    size clamped to ``min_read``, IOPS- or bandwidth-limited, whichever
    binds) and then split across the tier's phase units byte-proportionally
    with the remainder assigned exactly to the last unit, so the per-tier
    pipe shares sum to the tier's throughput term bit-for-bit."""
    job = Job(record.label, tenant=tenant, weight=weight, request=request,
              n_requests=record.n_requests, submit=submit, seq=seq)
    staged: List[Tuple[int, int, _Unit]] = []
    for tier in sorted(record.tiers):
        phase_ops, phase_bytes = record.tiers[tier]
        dev = devices[tier]
        total_ops = sum(phase_ops.values())
        if total_ops == 0:
            continue
        total_bytes = sum(phase_bytes.get(p, 0) for p in phase_ops)
        avg = max(total_bytes / total_ops, 1.0)
        eff = max(avg, dev.min_read)
        iops_limit = min(dev.iops_4k, dev.seq_bw / eff)
        tp = max(total_ops / iops_limit, total_bytes / dev.seq_bw)
        phases = sorted(phase_ops)
        assigned = 0.0
        for k, p in enumerate(phases):
            nb = phase_bytes.get(p, 0)
            if k == len(phases) - 1:
                pipe = tp - assigned  # exact remainder: shares sum to tp
            elif total_bytes:
                pipe = tp * (nb / total_bytes)
                assigned += pipe
            else:
                pipe = tp * (phase_ops[p] / total_ops)
                assigned += pipe
            staged.append((p, tier, _Unit(job, tier, p, dev,
                                          phase_ops[p], nb, pipe)))
    # phase-major chain: phase p on every tier completes before phase p+1
    # starts (the dependency the phases encode), fastest tier first within a
    # phase (the classify order).
    staged.sort(key=lambda t: (t[0], t[1]))
    job.units = [u for _, _, u in staged]
    return job


@dataclasses.dataclass
class ServiceResult:
    """One event-loop (or serial-baseline) run over a set of jobs.

    ``counters`` carries the recovery layer's tallies (``retry.<dev>``,
    ``failover.<dev>``, ``error.<tenant>``, ``shed.<tenant>``) — empty on
    healthy runs and in serial mode."""

    mode: str
    completions: List[JobCompletion]
    tiers: Dict[str, Dict[str, int]]
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def makespan(self) -> float:
        return max((c.done for c in self.completions), default=0.0)

    @property
    def errors(self) -> List[JobCompletion]:
        """Failed completions (shed and io-exhausted), submission order."""
        return [c for c in self.completions if c.error is not None]

    def availability(self, tenant: Optional[str] = None) -> float:
        """Served fraction — completions without an error over all
        completions (shed rejections count against availability), overall
        or for one tenant.  1.0 when the filter matches nothing."""
        tot = ok = 0
        for c in self.completions:
            if tenant is not None and c.tenant != tenant:
                continue
            tot += 1
            ok += c.error is None
        return ok / tot if tot else 1.0

    def percentiles(self, tenant: Optional[str] = None,
                    label_prefix: Optional[str] = None) -> Optional[Dict]:
        """Nearest-rank per-request latency summary (seconds) over *served*
        completions (errors excluded — an error is not a latency),
        optionally filtered by tenant and/or drain-label prefix."""
        lats = [c.latency for c in self.completions
                if c.error is None
                and (tenant is None or c.tenant == tenant)
                and (label_prefix is None or c.label.startswith(label_prefix))]
        return latency_percentiles(lats)


def latency_percentiles(latencies: Sequence[float]) -> Optional[Dict]:
    """count/mean/p50/p99/p999/max over a latency population (nearest-rank,
    the same estimator as :mod:`repro_torch.obs.metrics`); ``None`` when empty."""
    lats = sorted(float(x) for x in latencies)
    if not lats:
        return None
    return {
        "count": len(lats),
        "mean": sum(lats) / len(lats),
        "p50": percentile(lats, 50.0),
        "p99": percentile(lats, 99.0),
        "p999": percentile(lats, 99.9),
        "max": lats[-1],
    }


class _TierState:
    """Per-tier run state: the outstanding-request table and the FCFS
    bandwidth pipe."""

    __slots__ = ("dev", "pending", "in_round", "granted", "granted_slots",
                 "busy", "pipe_free", "rounds", "max_outstanding", "served",
                 "busy_time", "round_start", "last_t", "last_busy")

    def __init__(self, dev: DeviceModel):
        self.dev = dev
        self.pending: List[_Unit] = []
        self.in_round: List[_Unit] = []
        self.granted: Dict[int, int] = {}   # unit seq -> ops in this round
        # unit seq -> (slot, attempt) pairs in this round; only populated
        # on error-faulted tiers under a RetryPolicy
        self.granted_slots: Dict[int, List[Tuple[int, int]]] = {}
        self.busy = False
        self.pipe_free = 0.0
        self.rounds = 0
        self.max_outstanding = 0
        self.served: Dict[str, int] = {}    # tenant -> ops served (for WFQ)
        self.busy_time = 0.0                # cumulative round-in-flight time
        self.round_start = 0.0
        self.last_t = 0.0                   # utilization-sampling anchors
        self.last_busy = 0.0


class EventLoop:
    """Virtual-clock simulation of interleaved dispatch across the tiers.

    ``run(jobs, mode="interleaved")`` shares each tier's latency rounds
    across all pending jobs (bounded by the queue depth) and drains bytes
    through a work-conserving FCFS pipe; ``mode="serial"`` prices the same
    job list the old way — one batch fully drained before the next starts —
    which is the baseline the serving benchmark's p99 gate compares against.
    Both modes are pure functions of (jobs, queue_depth, qos): they mutate
    no accounting state and can be re-run on the same job list."""

    def __init__(self, devices: Sequence[DeviceModel], queue_depth: int = 256,
                 qos: Optional[QoS] = None,
                 queue_depths: Optional[Dict[str, int]] = None,
                 plane: MetricsPlane = NULL_PLANE, slo=None,
                 retry: Optional[RetryPolicy] = None, shedder=None):
        self.devices = list(devices)
        self.queue_depth = max(1, int(queue_depth))
        self.qos = qos or QoS()
        # per-device-name depth overrides; any device not named falls back
        # to the shared queue_depth
        self.queue_depths = ({name: max(1, int(v))
                              for name, v in queue_depths.items()}
                             if queue_depths else None)
        self.plane = plane if plane is not None else NULL_PLANE
        self.slo = slo
        # recovery knobs; only consulted on tiers whose fault schedule can
        # fail ops, so a policy on a healthy device list costs nothing
        self.retry = retry
        self.shedder = shedder

    def qd_for(self, dev: DeviceModel) -> int:
        if self.queue_depths:
            return self.queue_depths.get(dev.name, self.queue_depth)
        return self.queue_depth

    # -- public entry points --------------------------------------------------
    def run(self, jobs: Sequence[Job], mode: str = "interleaved") -> ServiceResult:
        if mode == "serial":
            return self._run_serial(jobs)
        if mode != "interleaved":
            raise ValueError(f"unknown event-loop mode {mode!r}")
        return self._run_interleaved(jobs)

    # -- serial baseline ------------------------------------------------------
    def _run_serial(self, jobs: Sequence[Job]) -> ServiceResult:
        """The old drain-the-whole-batch-then-return world: jobs run FIFO in
        (submit, seq) order, each paying its full serial-drain price.

        Deliberately blind to device fault schedules and to the metrics
        plane: serial pricing is the accounting baseline the bench gate
        pins, so it must stay bit-identical regardless of injected
        degradations or sampling.  Closed-loop dependencies are honoured
        (the dependent issues when its dependency completes plus think
        time) so both modes price the same arrival process."""
        clock = 0.0
        completions: List[JobCompletion] = []
        ordered = sorted(jobs, key=lambda j: (j.submit, j.seq))
        ids = {id(j) for j in ordered}
        done: Dict[int, float] = {}
        for job in ordered:
            submit = job.submit
            if job.after is not None and id(job.after) in ids:
                # the window submits dependencies before dependents, so the
                # dependency sorts first and its completion time is known
                submit = max(submit, done.get(id(job.after), 0.0) + job.think)
            start = max(clock, submit)
            clock = start + job.serial_time(self.queue_depth,
                                            self.queue_depths)
            done[id(job)] = clock
            completions.append(JobCompletion(
                job.label, job.tenant, job.request, job.n_requests,
                submit, clock))
        return ServiceResult("serial", completions, {})

    # -- interleaved event loop -----------------------------------------------
    def _run_interleaved(self, jobs: Sequence[Job]) -> ServiceResult:
        tiers = [_TierState(dev) for dev in self.devices]
        heap: List[Tuple[float, int, int, object]] = []
        eseq = 0  # heap tie-break: deterministic FIFO among equal timestamps
        plane, slo = self.plane, self.slo
        policy, shedder = self.retry, self.shedder
        counters: Dict[str, int] = {}

        def push(t: float, kind: int, payload) -> None:
            nonlocal eseq
            eseq += 1
            heapq.heappush(heap, (t, kind, eseq, payload))

        def bump(key: str, n: int = 1) -> None:
            counters[key] = counters.get(key, 0) + n
            if plane.enabled:
                plane.counter(key).inc(n)

        ordered = sorted(jobs, key=lambda j: (j.submit, j.seq))
        ids = {id(j) for j in ordered}
        # closed-loop dependents wait for their dependency's completion
        # instead of arriving at their nominal submit time
        deps: Dict[int, List[Job]] = {}
        # effective issue time per job (dependents: dep completion + think);
        # kept out of Job.submit so repeated runs stay pure
        esub: Dict[int, float] = {}
        useq = 0
        for job in ordered:
            job._next = 0
            for u in job.units:
                useq += 1
                u.seq = useq
                u.ops_left = u.ops
                u.wait_rounds = 0
                u.retry_q = None       # recovery state is strictly per-run:
                u.backoffs = 0         # resetting it keeps repeated runs
                u.deadline = None      # over the same jobs pure
            if job.after is not None and id(job.after) in ids:
                deps.setdefault(id(job.after), []).append(job)
            else:
                esub[id(job)] = job.submit
                push(job.submit, 0, job)  # kind 0: arrival

        completions: List[JobCompletion] = []
        in_flight = 0

        def complete(job: Job, t: float, error: Optional[str] = None) -> None:
            nonlocal in_flight
            submit = esub[id(job)]
            completions.append(JobCompletion(
                job.label, job.tenant, job.request, job.n_requests,
                submit, t, error))
            in_flight -= 1
            plane.sample("jobs.in_flight", t, in_flight)
            if error is None:
                plane.observe_latency(f"latency.{job.tenant}", t, t - submit)
                if slo is not None:
                    slo.observe(job.tenant, t, t - submit)
            else:
                bump(f"error.{job.tenant}")
                if slo is not None:
                    # a failure consumes error budget whatever its latency
                    slo.observe(job.tenant, t, t - submit, error=True)
            for d in deps.pop(id(job), ()):
                at = esub[id(d)] = max(d.submit, t + d.think)
                push(at, 0, d)

        def activate(unit: _Unit, t: float) -> None:
            ts = tiers[unit.tier]
            if policy is not None and unit.retry_q is None \
                    and ts.dev.has_error_faults:
                # first dispatch against an error-faulted tier: materialize
                # the slot queue and stamp the give-up deadline off the
                # unit's *healthy* expected service time
                unit.retry_q = [(s, 0) for s in range(unit.ops)]
                qd = self.qd_for(ts.dev)
                unit.deadline = t + policy.timeout_k * (
                    math.ceil(unit.ops / qd) * ts.dev.latency + unit.pipe)
            ts.pending.append(unit)
            if not ts.busy:
                start_round(ts, t)

        def exhaust(unit: _Unit, ts: _TierState, t: float) -> None:
            """Retries/deadline exhausted on this tier: fail over the
            surviving slots to the next (slower) tier, re-priced at that
            tier's model — or fail the whole job if there is nowhere left
            to go."""
            nonlocal useq
            job = unit.job
            nxt = unit.tier + 1
            if policy.failover and nxt < len(self.devices):
                bump(f"failover.{ts.dev.name}")
                r = len(unit.retry_q)
                dev2 = self.devices[nxt]
                # prorate the unit's bytes over the surviving slots and
                # price them with the target tier's model arithmetic (the
                # same formula as build_job); cache admission is implicitly
                # skipped — this is a timing re-dispatch, the accounting
                # plane never sees it
                nb = int(round(unit.nbytes * (r / unit.ops))) \
                    if unit.ops else 0
                avg = max(nb / r, 1.0)
                eff = max(avg, dev2.min_read)
                iops_limit = min(dev2.iops_4k, dev2.seq_bw / eff)
                tp = max(r / iops_limit, nb / dev2.seq_bw)
                v = _Unit(job, nxt, unit.phase, dev2, r, nb, tp)
                useq += 1
                v.seq = useq
                v.ops_left = r
                # v substitutes for `unit` positionally: when it drains,
                # finish_unit advances job._next past the abandoned unit.
                # If the target tier is itself error-faulted, activate()
                # arms fresh retry state there (cascading failover).
                activate(v, t)
            else:
                complete(job, t, error=f"io:{ts.dev.name}")

        def order_key(ts: _TierState):
            qos = self.qos

            def key(u: _Unit):
                tenant = u.job.tenant
                w = u.job.weight if u.job.weight is not None \
                    else qos.weight_for(tenant)
                starved = 0 if u.wait_rounds >= qos.starvation_rounds else 1
                return (starved, -qos.priority_for(tenant),
                        ts.served.get(tenant, 0) / max(w, 1e-9), u.seq)
            return key

        def start_round(ts: _TierState, t: float) -> None:
            """Pack the next outstanding window: up to the tier's queue
            depth ops drawn from all pending units in QoS order."""
            if not ts.pending:
                ts.busy = False
                return
            order = sorted(ts.pending, key=order_key(ts))
            qd = self.qd_for(ts.dev)
            err = policy is not None and ts.dev.has_error_faults
            slots = qd
            chosen: List[_Unit] = []
            passed: List[_Unit] = []
            granted: Dict[int, int] = {}
            for u in order:
                if slots <= 0:
                    passed.append(u)
                    continue
                g = min(u.ops_left, slots)
                granted[u.seq] = g
                if err and g:
                    # remember which (slot, attempt) pairs ride this round
                    # so finish_round can judge each op individually
                    ts.granted_slots[u.seq] = u.retry_q[:g]
                    del u.retry_q[:g]
                u.ops_left -= g
                u.wait_rounds = 0
                slots -= g
                ts.served[u.job.tenant] = ts.served.get(u.job.tenant, 0) + g
                chosen.append(u)
            # aging: a passed-over unit only moves toward the starvation
            # threshold when *later-arriving* work jumped ahead of it.
            # Waiting behind earlier arrivals is plain FIFO queueing; being
            # overtaken is what strict priority classes inflict, and that is
            # what the guard bounds — under a sustained high-class flood
            # every victim would otherwise cross the threshold in lockstep
            # with the flood itself and priority would just re-decide.
            max_seq = max((u.seq for u in chosen), default=0)
            for u in passed:
                if u.seq < max_seq:
                    u.wait_rounds += 1
            ts.pending = [u for u in ts.pending if u.seq not in granted]
            ts.in_round = chosen
            ts.granted = granted
            ts.busy = True
            ts.rounds += 1
            outstanding = qd - slots
            ts.max_outstanding = max(ts.max_outstanding, outstanding)
            ts.round_start = t
            # fault schedule: an active degradation stretches this round's
            # trip time; healthy devices take the branch-free path
            lat = ts.dev.latency
            if ts.dev.faults:
                lat *= ts.dev.latency_factor_at(t)
            if plane.enabled:
                plane.sample(f"tier.{ts.dev.name}.outstanding", t,
                             outstanding)
            push(t + lat, 1, ts)  # kind 1: round completion

        def finish_round(ts: _TierState, t: float) -> None:
            ts.busy_time += t - ts.round_start
            faulted = bool(ts.dev.faults)
            err = policy is not None and ts.dev.has_error_faults
            for u in ts.in_round:
                if err:
                    # judge each op that rode this round at its completion
                    # time: window membership + an independent seeded draw
                    # per (tier, unit, slot, attempt)
                    failed = [(s, a)
                              for s, a in ts.granted_slots.get(u.seq, ())
                              if ts.dev.op_fails_at(t, u.tier, u.seq, s, a)]
                    if failed:
                        u.retry_q.extend((s, a + 1) for s, a in failed)
                        u.ops_left = len(u.retry_q)
                        if u.backoffs >= policy.max_retries \
                                or t >= u.deadline:
                            exhaust(u, ts, t)
                        else:
                            bump(f"retry.{ts.dev.name}", len(failed))
                            u.backoffs += 1
                            jit = 1.0 + policy.jitter * _splitmix_uniform(
                                policy.seed, u.tier, u.seq, u.backoffs)
                            delay = (policy.backoff_base
                                     * policy.backoff_factor
                                     ** (u.backoffs - 1) * jit)
                            push(t + delay, 3, u)  # kind 3: backoff re-arm
                        continue
                if u.ops_left == 0:
                    # all this unit's ops have completed their round trips;
                    # its bytes drain through the FCFS bandwidth pipe
                    pipe = u.pipe
                    if faulted:
                        pipe /= ts.dev.bandwidth_factor_at(t)
                    ts.pipe_free = max(ts.pipe_free, t) + pipe
                    push(ts.pipe_free, 2, u)  # kind 2: unit completion
                else:
                    ts.pending.append(u)
            ts.in_round = []
            ts.granted = {}
            if err:
                ts.granted_slots = {}
            ts.busy = False
            if plane.enabled:
                # utilization = fraction of virtual time this tier had a
                # round in flight since the last sample; pipe backlog is the
                # queued-bytes drain horizon in virtual seconds
                dt = t - ts.last_t
                if dt > 0:
                    plane.sample(f"tier.{ts.dev.name}.utilization", t,
                                 min(1.0, (ts.busy_time - ts.last_busy) / dt))
                    ts.last_t = t
                    ts.last_busy = ts.busy_time
                plane.sample(f"tier.{ts.dev.name}.pipe_backlog", t,
                             max(0.0, ts.pipe_free - t))
            if ts.pending:
                start_round(ts, t)

        def finish_unit(unit: _Unit, t: float) -> None:
            job = unit.job
            job._next += 1
            if job._next < len(job.units):
                activate(job.units[job._next], t)
            else:
                complete(job, t)

        while heap:
            t, kind, _, payload = heapq.heappop(heap)
            if kind == 0:
                job = payload
                if shedder is not None and not shedder.admit(job.tenant, t):
                    # admission rejection: the job completes immediately as
                    # shed, consumes no queue slot, and is not fed to the
                    # SLO monitor (rejections are the policy's output, not
                    # evidence about the protected tenants' service);
                    # closed-loop dependents still release — a real client
                    # retries or moves on after a 429
                    bump(f"shed.{job.tenant}")
                    completions.append(JobCompletion(
                        job.label, job.tenant, job.request, job.n_requests,
                        esub[id(job)], t, "shed"))
                    for d in deps.pop(id(job), ()):
                        at = esub[id(d)] = max(d.submit, t + d.think)
                        push(at, 0, d)
                    continue
                in_flight += 1
                plane.sample("jobs.in_flight", t, in_flight)
                if job.units:
                    activate(job.units[0], t)
                else:
                    complete(job, t)
            elif kind == 1:
                finish_round(payload, t)
            elif kind == 2:
                finish_unit(payload, t)
            else:
                activate(payload, t)  # kind 3: backoff elapsed, re-queue

        report = {ts.dev.name: {"rounds": ts.rounds,
                                "max_outstanding": ts.max_outstanding}
                  for ts in tiers if ts.rounds}
        return ServiceResult("interleaved", completions, report, counters)


@dataclasses.dataclass
class _RequestCtx:
    tenant: str
    at: Optional[float]
    weight: Optional[float]
    request: Optional[str]
    client: Optional[str] = None
    think: float = 0.0
    dep: Optional[Job] = None  # the client's previous request's last job


class ServiceWindow:
    """Collects the drains of many concurrent requests for one shared
    event-loop run.

    Opened via ``IOScheduler.service_window()``.  While the window is open,
    every completed drain (read batches, write batches, and the flush runs
    they trigger) is lifted into a :class:`Job` instead of advancing the
    scheduler's immediate virtual clock; :meth:`request` tags the jobs a
    block of calls produces with a tenant, an arrival time and an optional
    weight.  ``run("interleaved")`` and ``run("serial")`` then price the
    *same executed workload* under both dispatch models — cache state and
    accounting are identical by construction, only the timing differs."""

    def __init__(self, scheduler, qos: Optional[QoS] = None):
        self.scheduler = scheduler
        self.qos = qos
        self.jobs: List[Job] = []
        self._cur: Optional[_RequestCtx] = None
        self._arrival = 0.0  # default submit time for untagged drains
        self._last_by_client: Dict[str, Job] = {}  # closed-loop chain heads

    def __enter__(self) -> "ServiceWindow":
        if self.scheduler._window is not None:
            raise RuntimeError("service windows do not nest")
        self.scheduler._window = self
        return self

    def __exit__(self, *exc) -> None:
        self.scheduler._window = None

    @contextlib.contextmanager
    def request(self, tenant: str = "default", at: Optional[float] = None,
                weight: Optional[float] = None,
                request: Optional[str] = None,
                client: Optional[str] = None, think: float = 0.0):
        """Tag every drain produced inside the block as one tenant request
        arriving at virtual time ``at`` (defaults to the latest arrival seen,
        so untimed requests land back to back).

        ``client`` opts the request into the closed-loop arrival model: its
        jobs depend on the *last job of the same client's previous request*
        and arrive ``think`` virtual seconds after that job completes (a
        client issues its next request only after the previous response
        lands — the chain approximates request completion by its last
        submitted drain).  Open-loop requests just set ``at``."""
        if at is not None:
            self._arrival = float(at)
        prev = self._cur
        dep = self._last_by_client.get(client) if client else None
        self._cur = _RequestCtx(tenant, self._arrival, weight, request,
                                client=client, think=float(think), dep=dep)
        try:
            yield
        finally:
            self._cur = prev

    def _submit(self, job: Job) -> None:
        ctx = self._cur
        if ctx is not None:
            job.tenant = ctx.tenant
            job.weight = ctx.weight
            job.submit = ctx.at if ctx.at is not None else self._arrival
            if ctx.request is not None:
                job.request = ctx.request
            if ctx.client is not None:
                job.after = ctx.dep
                job.think = ctx.think
                self._last_by_client[ctx.client] = job
        else:
            job.submit = self._arrival
        self.jobs.append(job)

    def run(self, mode: str = "interleaved", qos: Optional[QoS] = None,
            queue_depth: Optional[int] = None,
            queue_depths: Optional[Dict[str, int]] = None,
            plane: MetricsPlane = NULL_PLANE, slo=None,
            retry: Optional[RetryPolicy] = None, shedder=None,
            devices: Optional[Sequence[DeviceModel]] = None) -> ServiceResult:
        """Price the captured jobs; pure — callable repeatedly, with either
        mode, without touching scheduler or store state.  ``plane``/``slo``
        attach the live metrics plane and SLO monitor to the interleaved
        run; ``queue_depths`` overrides depth per device name (defaulting
        to the scheduler's per-tier map, if it has one); ``retry`` falls
        back to the scheduler's ``retry_policy``; ``devices`` substitutes a
        (possibly fault-injected) device list for the scheduler's — the
        chaos bench re-prices one captured workload under many fault
        schedules this way.  A ``shedder`` carries hysteresis state across
        a run: reset or rebuild it between runs to keep them pure."""
        loop = EventLoop(devices if devices is not None
                         else self.scheduler._devices(),
                         queue_depth or self.scheduler.queue_depth,
                         qos or self.qos,
                         queue_depths=(queue_depths if queue_depths is not None
                                       else getattr(self.scheduler,
                                                    "queue_depths", None)),
                         plane=plane, slo=slo,
                         retry=(retry if retry is not None
                                else getattr(self.scheduler,
                                             "retry_policy", None)),
                         shedder=shedder)
        return loop.run(self.jobs, mode=mode)
