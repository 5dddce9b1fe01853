"""The port's fault models (``repro_torch.core.io_sim``), the event loop's
recovery layer (retry, backoff, failover, SLO-driven shedding) and
fault-aware cache admission against the JAX package's, in lockstep on the
CPU.

Each case is the body of a test of ``tests/test_faults.py`` or
``tests/test_faults_properties.py``, written once over a namespace of one
package's names (``tests/_torch_port.py``).  It runs on the reference and
on the port: its assertions must hold on both, and the log of every
completion, recovery counter, failure draw, SLO table and admission counter
it records must be identical (tolerance 0).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _torch_port import job_shape, lockstep_packages, package

REF = package("repro")
PORT = package("repro_torch", device="cpu")


def lockstep(case, *args):
    lockstep_packages(REF, PORT, case, *args)


def _devices(m):
    return [m.NVME, m.S3]


def _rec(m, label, ops=64, nb=64 * 4096, tier=0, phase=0):
    return m.DrainRecord(label, 1, {tier: ({phase: ops}, {phase: nb})})


def _jobs(m, n=40, spacing=1e-4, tenant="t", ops=64):
    return [m.build_job(_rec(m, f"j{i}", ops=ops), _devices(m), tenant=tenant,
                        submit=i * spacing, seq=i) for i in range(n)]


# ---------------------------------------------------------------------------
# Fault models
# ---------------------------------------------------------------------------


def test_transient_errors_validation_and_window():
    def case(m, log):
        for make in (lambda: m.TransientErrors(0.0, error_prob=1.5),
                     lambda: m.TransientErrors(2.0, 1.0),
                     lambda: m.Blackout(2.0, 1.0)):
            with pytest.raises(ValueError) as err:
                make()
            log(str(err.value))
        f = m.TransientErrors(1.0, 2.0, 0.5, seed=7)
        assert f.active(1.0) and f.active(1.999) and not f.active(2.0)
        assert not f.active(0.999)
        log(f)
    lockstep(case)


def test_op_fails_at_is_deterministic_and_seeded():
    def case(m, log):
        d = m.NVME.with_fault(m.TransientErrors(1.0, 2.0, 0.5, seed=7))
        draws = [d.op_fails_at(1.5, 0, i, 0, 0) for i in range(500)]
        assert draws == [d.op_fails_at(1.5, 0, i, 0, 0) for i in range(500)]
        frac = sum(draws) / len(draws)
        assert 0.4 < frac < 0.6
        d2 = m.NVME.with_fault(m.TransientErrors(1.0, 2.0, 0.5, seed=8))
        draws2 = [d2.op_fails_at(1.5, 0, i, 0, 0) for i in range(500)]
        assert draws != draws2
        assert not any(d.op_fails_at(0.5, 0, i, 0, 0) for i in range(100))
        assert not any(d.op_fails_at(2.5, 0, i, 0, 0) for i in range(100))
        log((draws, draws2))
    lockstep(case)


def test_failure_sets_nest_in_error_prob():
    def case(m, log):
        lo = m.NVME.with_fault(m.TransientErrors(0.0, 1.0, 0.1, seed=3))
        hi = m.NVME.with_fault(m.TransientErrors(0.0, 1.0, 0.4, seed=3))
        keys = [(0, i, s, a) for i in range(50) for s in range(4)
                for a in range(2)]
        for k in keys:
            if lo.op_fails_at(0.5, *k):
                assert hi.op_fails_at(0.5, *k)
        log([(lo.op_fails_at(0.5, *k), hi.op_fails_at(0.5, *k)) for k in keys])
    lockstep(case)


def test_blackout_fails_everything_and_error_fault_flags():
    def case(m, log):
        b = m.NVME.with_fault(m.Blackout(1.0, 2.0))
        assert all(b.op_fails_at(1.5, 0, i, 0, 0) for i in range(50))
        assert b.has_error_faults
        assert not m.NVME.has_error_faults
        deg = m.NVME.with_fault(m.Degradation(0.0, 1.0))
        assert not deg.has_error_faults
        assert b.latency_factor_at(1.5) == 1.0
        assert b.bandwidth_factor_at(1.5) == 1.0
        log((b, deg, b.fault_active_at(1.5), deg.fault_active_at(1.5)))
    lockstep(case)


def test_correlated_fault_stamps_named_tiers():
    def case(m, log):
        cf = m.CorrelatedFault(m.Blackout(1.0, 2.0), (m.NVME.name, m.S3.name))
        out = cf.apply([m.NVME, m.S3, m.DRAM])
        assert len(out[0].faults) == 1 and len(out[1].faults) == 1
        assert not out[2].faults
        assert out[0].faults[0] is out[1].faults[0]
        with pytest.raises(ValueError) as err:
            m.CorrelatedFault(m.Blackout(0.0), ("nope",)).apply([m.NVME, m.S3])
        log((out, str(err.value)))
    lockstep(case)


def test_retry_policy_validation():
    def case(m, log):
        for kw in ({"max_retries": -1}, {"backoff_factor": 0.5},
                   {"timeout_k": 0.0}, {"jitter": -0.1}):
            with pytest.raises(ValueError) as err:
                m.RetryPolicy(**kw)
            log(str(err.value))
        log(m.RetryPolicy())
    lockstep(case)


# ---------------------------------------------------------------------------
# Healthy-path bit-identity (contract #8)
# ---------------------------------------------------------------------------


def test_policy_on_healthy_devices_is_bit_identical():
    def case(m, log):
        jobs = _jobs(m)
        base = m.EventLoop(_devices(m), queue_depth=64).run(jobs)
        armed = m.EventLoop(_devices(m), queue_depth=64,
                            retry=m.RetryPolicy()).run(jobs)
        assert base.completions == armed.completions
        assert armed.counters == {}
        log((base, armed))
    lockstep(case)


def test_zero_prob_transient_errors_is_bit_identical_to_healthy():
    def case(m, log):
        jobs = _jobs(m)
        base = m.EventLoop(_devices(m), queue_depth=64).run(jobs)
        d0 = [m.NVME.with_fault(m.TransientErrors(0.0, error_prob=0.0)), m.S3]
        out = m.EventLoop(d0, queue_depth=64, retry=m.RetryPolicy()).run(jobs)
        assert base.completions == out.completions
        assert out.counters == {}
        log((base, out))
    lockstep(case)


def test_serial_mode_is_blind_to_error_faults():
    def case(m, log):
        jobs = _jobs(m)
        base = m.EventLoop(_devices(m), queue_depth=64).run(jobs, mode="serial")
        db = [m.NVME.with_fault(m.Blackout(0.0)), m.S3]
        out = m.EventLoop(db, queue_depth=64, retry=m.RetryPolicy()).run(
            jobs, mode="serial")
        assert base.completions == out.completions
        log((base, out))
    lockstep(case)


# ---------------------------------------------------------------------------
# Retry / backoff / deadline
# ---------------------------------------------------------------------------


def _transient_run(m, error_prob=0.05, seed=3, policy=None, jobs=None):
    jobs = jobs if jobs is not None else _jobs(m)
    M = m.EventLoop(_devices(m), queue_depth=64).run(jobs).makespan
    dev = [m.NVME.with_fault(
        m.TransientErrors(0.25 * M, 0.75 * M, error_prob, seed=seed)), m.S3]
    loop = m.EventLoop(dev, queue_depth=64, retry=policy or m.RetryPolicy())
    return loop.run(jobs), M


def test_transient_errors_retry_and_stretch_makespan():
    def case(m, log):
        out, M = _transient_run(m)
        assert out.counters.get("retry.nvme_970evo", 0) > 0
        assert out.makespan >= M
        assert len(out.completions) == 40
        assert not out.errors
        assert out.availability() == 1.0
        log((out, M))
    lockstep(case)


def test_faulted_run_is_replayable_bit_identical():
    def case(m, log):
        jobs = _jobs(m)
        a, _ = _transient_run(m, jobs=jobs)
        b, _ = _transient_run(m, jobs=jobs)
        assert a.completions == b.completions
        assert a.counters == b.counters
        assert [c.label for c in a.errors] == [c.label for c in b.errors]
        log(a)
    lockstep(case)


def test_different_fault_seed_changes_schedule():
    def case(m, log):
        jobs = _jobs(m)
        a, _ = _transient_run(m, seed=3, jobs=jobs)
        b, _ = _transient_run(m, seed=4, jobs=jobs)
        assert a.completions != b.completions
        log((a, b))
    lockstep(case)


def test_backoff_delays_are_priced_on_the_virtual_clock():
    def case(m, log):
        jobs = _jobs(m, n=1)
        healthy = m.EventLoop(_devices(m), queue_depth=64).run(jobs)
        assert healthy.makespan < 0.4
        pol = m.RetryPolicy(backoff_base=0.5, jitter=0.0)
        dev = [m.NVME.with_fault(m.Blackout(0.0, 0.4)), m.S3]
        out = m.EventLoop(dev, queue_depth=64, retry=pol).run(jobs)
        assert not out.errors
        assert out.makespan >= 0.5
        log((healthy, out))
    lockstep(case)


def test_max_retries_bounds_attempts_then_fails_without_failover():
    def case(m, log):
        jobs = _jobs(m, n=5)
        pol = m.RetryPolicy(max_retries=2, failover=False, jitter=0.0)
        dev = [m.NVME.with_fault(m.Blackout(0.0)), m.S3]
        out = m.EventLoop(dev, queue_depth=64, retry=pol).run(jobs)
        assert len(out.errors) == 5
        assert all(c.error == "io:nvme_970evo" for c in out.errors)
        assert out.availability() == 0.0
        assert out.counters["retry.nvme_970evo"] == 5 * 64 * 2
        assert out.counters["error.t"] == 5
        log(out)
    lockstep(case)


def test_deadline_exhausts_before_max_retries():
    def case(m, log):
        jobs = _jobs(m, n=1)
        pol = m.RetryPolicy(max_retries=50, backoff_base=10.0, timeout_k=1.0,
                            failover=False, jitter=0.0)
        dev = [m.NVME.with_fault(m.Blackout(0.0)), m.S3]
        out = m.EventLoop(dev, queue_depth=64, retry=pol).run(jobs)
        assert len(out.errors) == 1
        assert out.counters["retry.nvme_970evo"] <= 64 * 3
        log(out)
    lockstep(case)


# ---------------------------------------------------------------------------
# Failover
# ---------------------------------------------------------------------------


def test_blackout_with_failover_degrades_latency_not_availability():
    def case(m, log):
        jobs = _jobs(m)
        M = m.EventLoop(_devices(m), queue_depth=64).run(jobs).makespan
        dev = [m.NVME.with_fault(m.Blackout(0.3 * M)), m.S3]
        on = m.EventLoop(dev, queue_depth=64, retry=m.RetryPolicy()).run(jobs)
        off = m.EventLoop(dev, queue_depth=64,
                          retry=m.RetryPolicy(failover=False)).run(jobs)
        assert not on.errors
        assert on.counters.get("failover.nvme_970evo", 0) > 0
        assert on.makespan > M
        assert off.errors
        assert off.availability("t") < 1.0
        assert len(on.completions) == len(jobs)
        assert len(off.completions) == len(jobs)
        log((on, off, M))
    lockstep(case)


def test_failover_exhausts_on_last_tier():
    def case(m, log):
        dev = [m.NVME, m.S3.with_fault(m.Blackout(0.0))]
        rec = m.DrainRecord("s3only", 1, {1: ({0: 8}, {0: 8 << 20})})
        job = m.build_job(rec, dev, tenant="t")
        out = m.EventLoop(dev, queue_depth=64, retry=m.RetryPolicy()).run([job])
        assert len(out.errors) == 1
        assert out.errors[0].error == "io:s3"
        log(out)
    lockstep(case)


def test_correlated_blackout_rides_out_short_window():
    def case(m, log):
        jobs = _jobs(m)
        M = m.EventLoop(_devices(m), queue_depth=64).run(jobs).makespan
        cf = m.CorrelatedFault(m.Blackout(0.3 * M, 0.5 * M),
                               (m.NVME.name, m.S3.name))
        out = m.EventLoop(cf.apply(_devices(m)), queue_depth=64,
                          retry=m.RetryPolicy()).run(jobs)
        assert not out.errors
        assert out.counters.get("retry.nvme_970evo", 0) > 0
        log(out)
    lockstep(case)


def test_accounting_plane_is_fault_blind():
    def case(m, log):
        rec = _rec(m, "j", ops=64)
        a = m.build_job(rec, _devices(m))
        dev = [m.NVME.with_fault(m.Blackout(0.0)), m.S3]
        m.EventLoop(dev, queue_depth=64, retry=m.RetryPolicy()).run([a])
        b = m.build_job(rec, _devices(m))
        assert [(u.ops, u.nbytes, u.pipe) for u in a.units] == \
               [(u.ops, u.nbytes, u.pipe) for u in b.units]
        log((job_shape(a), job_shape(b)))
    lockstep(case)


# ---------------------------------------------------------------------------
# SLO-driven load shedding
# ---------------------------------------------------------------------------


def _shed_setup(m, n=200, spacing=3e-4):
    jobs = []
    seq = 0
    for i in range(n):
        for tenant in ("premium", "standard", "standard"):
            seq += 1
            jobs.append(m.build_job(_rec(m, f"{tenant}{i}"), _devices(m),
                                    tenant=tenant, submit=i * spacing,
                                    seq=seq))
    qos = m.QoS(priority={"premium": 1})
    healthy = m.EventLoop(_devices(m), queue_depth=64, qos=qos).run(jobs)
    return jobs, qos, healthy


def test_shedder_validation():
    def case(m, log):
        mon = m.SLOMonitor({"p": m.SLObjective(1.0)})
        for args, kw in ((("p",), ("p",)), {}), \
                        ((("p",), ("s",)), {"on_burn": 1.0, "off_burn": 2.0}), \
                        ((("p",), ("s",)), {"hold_s": -1.0}):
            with pytest.raises(ValueError) as err:
                m.Shedder(mon, *args, **kw)
            log(str(err.value))
    lockstep(case)


def test_shedding_engages_with_hysteresis_and_protects_premium():
    def case(m, log):
        jobs, qos, healthy = _shed_setup(m)
        M = healthy.makespan
        obj = m.SLObjective(
            latency_s=healthy.percentiles("premium")["p99"] * 5, target=0.99)
        win = m.BurnWindow(long_s=M / 8, short_s=M / 64)
        dev = [m.NVME.with_fault(m.Degradation(0.2 * M, 0.8 * M,
                                               latency_factor=2.0,
                                               throughput_factor=1.0)), m.S3]

        def run(shed_on):
            mon = m.SLOMonitor({"premium": obj}, windows=(win,))
            sh = m.Shedder(mon, protect=("premium",), shed=("standard",),
                           on_burn=4.0, off_burn=1.0,
                           hold_s=M / 4) if shed_on else None
            res = m.EventLoop(dev, queue_depth=64, qos=qos,
                              retry=m.RetryPolicy(), slo=mon,
                              shedder=sh).run(jobs)
            return res, sh, mon

        on, sh, mon_on = run(True)
        off, _, mon_off = run(False)
        assert sh.trips == 1
        assert on.counters["shed.standard"] > 0
        assert "shed.premium" not in on.counters
        assert on.availability("premium") == 1.0
        assert on.percentiles("premium")["p99"] < \
            off.percentiles("premium")["p99"]
        assert on.makespan < off.makespan
        assert len(on.completions) == len(jobs)
        shed = [c for c in on.completions if c.error == "shed"]
        assert len(shed) == on.counters["shed.standard"]
        assert all(c.tenant == "standard" for c in shed)
        log((on, off, sh.trips, mon_on.table(), mon_off.table(),
             mon_on.alerts))
    lockstep(case)


def test_shedder_reset_restores_purity():
    def case(m, log):
        jobs, qos, healthy = _shed_setup(m, n=120)
        M = healthy.makespan
        obj = m.SLObjective(latency_s=healthy.percentiles("premium")["p99"] * 5)
        win = m.BurnWindow(long_s=M / 8, short_s=M / 64)
        dev = [m.NVME.with_fault(m.Degradation(0.2 * M, 0.8 * M,
                                               latency_factor=2.0)), m.S3]

        def once():
            mon = m.SLOMonitor({"premium": obj}, windows=(win,))
            sh = m.Shedder(mon, ("premium",), ("standard",), hold_s=M / 4)
            return m.EventLoop(dev, queue_depth=64, qos=qos,
                               retry=m.RetryPolicy(), slo=mon,
                               shedder=sh).run(jobs)

        a = once()
        assert a.completions == once().completions
        log(a)
    lockstep(case)


def test_shed_requests_do_not_feed_slo_monitor():
    def case(m, log):
        mon = m.SLOMonitor({"standard": m.SLObjective(latency_s=1e-9)})
        sh = m.Shedder(mon, protect=(), shed=("standard",), hold_s=1e9)
        sh.active = True
        jobs = _jobs(m, n=10, tenant="standard")
        out = m.EventLoop(_devices(m), queue_depth=64, slo=mon,
                          shedder=sh).run(jobs)
        assert len(out.errors) == 10
        assert mon.table()[0]["requests"] == 0
        log((out, mon.table()))
    lockstep(case)


def test_slo_observe_error_counts_against_budget():
    def case(m, log):
        mon = m.SLOMonitor({"t": m.SLObjective(latency_s=100.0)})
        mon.observe("t", 1.0, 0.001, error=True)
        row = mon.table()[0]
        assert row["bad"] == 1
        assert mon.registry.counter("slo.errors.t").value == 1
        log((mon.table(), mon.registry.counter_values()))
    lockstep(case)


def test_current_burn_query():
    def case(m, log):
        mon = m.SLOMonitor({"t": m.SLObjective(latency_s=1.0, target=0.9)})
        for i in range(10):
            mon.observe("t", 1.0 + i * 0.01, 2.0)
        assert mon.current_burn("t", 1.1) == pytest.approx(10.0)
        assert mon.current_burn("nope", 1.1) == 0.0
        log((mon.current_burn("t", 1.1), mon.table()))
    lockstep(case)


# ---------------------------------------------------------------------------
# Window integration
# ---------------------------------------------------------------------------


def test_service_window_run_accepts_fault_devices_and_retry():
    def case(m, log):
        rng = np.random.default_rng(0)
        arr = m.A.PrimitiveArray.build(rng.integers(0, 1 << 20, 20_000)
                                       .astype(np.int64))
        fb = m.write_table({"c": arr}, m.WriteOptions("lance-miniblock"))
        reader = m.FileReader(fb, store="tiered")
        sched = reader.scheduler
        assert isinstance(sched.retry_policy, m.RetryPolicy)
        with sched.service_window() as win:
            for i in range(6):
                with win.request(tenant="t", at=i * 1e-3, request=f"r{i}"):
                    reader.take("c", rng.integers(0, 20_000, 64))
        healthy = win.run("interleaved")
        assert not healthy.errors
        faulted = [d.with_fault(m.Blackout(0.0)) if d.name == m.NVME.name
                   else d for d in sched._devices()]
        out = win.run("interleaved", devices=faulted)
        again = win.run("interleaved", devices=faulted)
        assert out.completions == again.completions
        assert len(out.completions) == len(healthy.completions)
        assert not out.errors
        assert win.run("interleaved").completions == healthy.completions
        log((healthy, out))
    lockstep(case)


# ---------------------------------------------------------------------------
# Fault-aware cache admission
# ---------------------------------------------------------------------------


def _tiered(m, backing):
    disk = m.Disk(np.arange(1 << 16, dtype=np.uint8) % 251)
    store = m.TieredStore.cached(disk, backing=backing, cache_bytes=1 << 20)
    return store, m.IOScheduler(store, queue_depth=64)


def test_brownout_blocks_are_not_admitted():
    def case(m, log):
        store, sch = _tiered(m, m.S3.with_fault(
            m.Degradation(0.0, latency_factor=8.0)))
        with sch.batch("take") as io:
            io.read(0, 4096 * 4)
        assert len(store.levels[0].cache) == 0
        assert store.admission_fault_skips == 4
        assert store.backing_stats.n_iops > 0
        store_b, sch_b = _tiered(m, m.S3.with_fault(m.Blackout(0.0)))
        with sch_b.batch("take") as io:
            io.read(0, 4096 * 2)
        assert len(store_b.levels[0].cache) == 0
        assert store_b.admission_fault_skips == 2
        log((store.tier_stats(), store_b.tier_stats(), sch.completions,
             sch_b.completions))
    lockstep(case)


def test_admission_resumes_outside_the_fault_window():
    def case(m, log):
        store, sch = _tiered(m, m.S3.with_fault(m.Degradation(start=1e9)))
        with sch.batch("take") as io:
            io.read(0, 4096 * 4)
        assert len(store.levels[0].cache) == 4
        assert store.admission_fault_skips == 0
        store2, sch2 = _tiered(m, m.S3.with_fault(m.Degradation(start=1e-9)))
        with sch2.batch("warmup") as io:
            io.read(0, 4096)
        assert len(store2.levels[0].cache) == 1
        assert sch2.vclock > 1e-9
        with sch2.batch("take") as io:
            io.read(4096 * 8, 4096 * 2)
        assert len(store2.levels[0].cache) == 1
        assert store2.admission_fault_skips == 2
        log((store2.tier_stats(), sch2.completions, sch2.vclock))
        store2.reset_stats()
        assert store2.admission_fault_skips == 0
    lockstep(case)


def test_healthy_store_admission_is_unchanged():
    def case(m, log):
        store, sch = _tiered(m, m.S3)
        with sch.batch("take") as io:
            io.read(0, 4096 * 4)
        assert len(store.levels[0].cache) == 4
        assert store.admission_fault_skips == 0
        log((store.tier_stats(), sch.completions))
    lockstep(case)


# ---------------------------------------------------------------------------
# tests/test_faults_properties.py
# ---------------------------------------------------------------------------

_PHASE = st.integers(0, 2)
_BUCKET = st.tuples(_PHASE, st.integers(1, 64), st.integers(0, 1 << 20))


def _record(m, buckets_by_tier):
    tiers = {}
    for tier, buckets in buckets_by_tier.items():
        phase_ops, phase_bytes = {}, {}
        for phase, ops, nbytes in buckets:
            phase_ops[phase] = phase_ops.get(phase, 0) + ops
            phase_bytes[phase] = phase_bytes.get(phase, 0) + nbytes
        if phase_ops:
            tiers[tier] = (phase_ops, phase_bytes)
    return m.DrainRecord("take:p", 1, tiers)


_JOBS = st.lists(
    st.tuples(st.dictionaries(st.integers(0, 1),
                              st.lists(_BUCKET, min_size=1, max_size=2),
                              min_size=1, max_size=2),
              st.floats(0.0, 0.01)),
    min_size=1, max_size=6)


def _build(m, jobs_spec, tenant="t"):
    return [m.build_job(_record(m, buckets), _devices(m), tenant=tenant,
                        submit=at, seq=i)
            for i, (buckets, at) in enumerate(jobs_spec)]


@settings(max_examples=100, deadline=None)
@given(jobs_spec=_JOBS, queue_depth=st.integers(1, 64),
       seed=st.integers(0, 2**32))
def test_zero_error_prob_is_bit_identical_to_healthy(jobs_spec, queue_depth,
                                                     seed):
    def case(m, log):
        jobs = _build(m, jobs_spec)
        healthy = m.EventLoop(_devices(m), queue_depth).run(jobs)
        dev = [m.NVME.with_fault(m.TransientErrors(0.0, error_prob=0.0,
                                                   seed=seed)),
               m.S3.with_fault(m.TransientErrors(0.0, error_prob=0.0,
                                                 seed=seed))]
        out = m.EventLoop(dev, queue_depth,
                          retry=m.RetryPolicy(seed=seed)).run(jobs)
        assert out.completions == healthy.completions
        assert out.counters == {}
        log(out)
    lockstep(case)


@settings(max_examples=100, deadline=None)
@given(jobs_spec=_JOBS, queue_depth=st.integers(1, 64),
       error_prob=st.floats(0.0, 0.5), seed=st.integers(0, 2**32))
def test_retries_never_change_logical_accounting(jobs_spec, queue_depth,
                                                 error_prob, seed):
    def case(m, log):
        jobs = _build(m, jobs_spec)
        loads = [[(u.tier, u.phase, u.ops, u.nbytes) for u in j.units]
                 for j in jobs]
        dev = [m.NVME.with_fault(m.TransientErrors(0.0, error_prob=error_prob,
                                                   seed=seed)), m.S3]
        out = m.EventLoop(dev, queue_depth,
                          retry=m.RetryPolicy(seed=seed)).run(jobs)
        assert [[(u.tier, u.phase, u.ops, u.nbytes) for u in j.units]
                for j in jobs] == loads
        assert len(out.completions) == len(jobs)
        again = m.EventLoop(dev, queue_depth,
                            retry=m.RetryPolicy(seed=seed)).run(jobs)
        assert again.completions == out.completions
        assert again.counters == out.counters
        log((loads, out))
    lockstep(case)


@settings(max_examples=60, deadline=None)
@given(ops=st.integers(1, 200), nbytes=st.integers(0, 1 << 20),
       phase=_PHASE, queue_depth=st.integers(1, 256),
       probs=st.tuples(st.floats(0.0, 0.9), st.floats(0.0, 0.9)),
       seed=st.integers(0, 2**32))
def test_makespan_monotone_in_error_prob(ops, nbytes, phase, queue_depth,
                                         probs, seed):
    lo, hi = sorted(probs)

    def case(m, log):
        rec = m.DrainRecord("take:p", 1, {0: ({phase: ops}, {phase: nbytes})})
        jobs = [m.build_job(rec, _devices(m), seq=0)]

        def run(p):
            dev = [m.NVME.with_fault(m.TransientErrors(0.0, error_prob=p,
                                                       seed=seed)), m.S3]
            return m.EventLoop(dev, queue_depth,
                               retry=m.RetryPolicy(jitter=0.0)).run(jobs)

        r_lo, r_hi = run(lo), run(hi)
        assert r_hi.makespan >= r_lo.makespan * (1 - 1e-3) - 1e-3
        log((r_lo, r_hi))
    lockstep(case)


@settings(max_examples=60, deadline=None)
@given(jobs_spec=_JOBS, error_prob=st.floats(0.0, 1.0),
       seed=st.integers(0, 2**32), shed_every=st.integers(0, 3),
       failover=st.booleans())
def test_failover_conserves_requests(jobs_spec, error_prob, seed, shed_every,
                                     failover):
    def case(m, log):
        jobs = []
        for i, (buckets, at) in enumerate(jobs_spec):
            tenant = "shed" if shed_every and i % shed_every == 0 else "keep"
            jobs.append(m.build_job(_record(m, buckets), _devices(m),
                                    tenant=tenant, submit=at, seq=i))
        dev = [m.NVME.with_fault(m.TransientErrors(0.0, error_prob=error_prob,
                                                   seed=seed)),
               m.S3.with_fault(m.Blackout(0.02, 0.06))]
        mon = m.SLOMonitor({"keep": m.SLObjective(1.0)})
        sh = m.Shedder(mon, protect=("keep",), shed=("shed",), hold_s=1e9)
        sh.active = True
        pol = m.RetryPolicy(max_retries=2, failover=failover, seed=seed)
        out = m.EventLoop(dev, 32, retry=pol, shedder=sh).run(jobs)
        assert len(out.completions) == len(jobs)
        assert sorted(c.label for c in out.completions) == \
            sorted(j.label for j in jobs)
        done = sum(1 for c in out.completions if c.error is None)
        shed = sum(1 for c in out.completions if c.error == "shed")
        failed = sum(1 for c in out.completions
                     if c.error and c.error.startswith("io:"))
        assert done + shed + failed == len(jobs)
        assert shed == sum(1 for j in jobs if j.tenant == "shed")
        assert all(c.error in (None, "shed", "io:nvme_970evo", "io:s3")
                   for c in out.completions)
        log(out)
    lockstep(case)


def test_correlated_brownout_under_s3_overload_fails_by_deadline():
    """Not a reference case: the chaos bench's correlated brownout (3% op
    errors on NVMe and S3 over 0.25-0.6 of the makespan) on a window whose
    S3 queue is saturated.  A unit's retry deadline is stamped when it
    queues on the faulted tier, so after seconds of queueing an S3 op error
    exhausts it at once, and S3 has no tier to fail over to: requests fail
    as ``io:s3`` with no S3 retry.  Both packages give the same result."""
    def case(m, log):
        devices = _devices(m)
        jobs = [m.build_job(m.DrainRecord(f"j{i}", 1, {0: ({0: 16}, {0: 16 * 4096}),
                                                      1: ({1: 8}, {1: 8 << 20})}),
                            devices, tenant="t", submit=i * 1e-3, seq=i)
                for i in range(200)]
        healthy = m.EventLoop(devices, queue_depth=32).run(jobs)
        M = healthy.makespan
        assert M > 5 * 200 * 1e-3  # arrivals end at 0.2 s: S3 is saturated
        cf = m.CorrelatedFault(m.TransientErrors(0.25 * M, 0.6 * M,
                                                 error_prob=0.03, seed=5),
                               (m.NVME.name, m.S3.name))
        out = m.EventLoop(cf.apply(devices), queue_depth=32,
                          retry=m.RetryPolicy()).run(jobs)
        assert len(out.completions) == len(jobs)
        assert out.availability() < 0.999
        assert {c.error for c in out.errors} == {"io:s3"}
        assert "retry.s3" not in out.counters
        log((M, out))
    lockstep(case)
