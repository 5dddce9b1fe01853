"""The port's event-loop serving plane (``repro_torch.store.evloop``, the
scheduler's service windows and virtual clock, the Zipf serve workload)
against the JAX package's, in lockstep on the CPU.

Each case is the body of a test of ``tests/test_evloop.py`` or
``tests/test_evloop_properties.py``, written once over a namespace of one
package's names (``tests/_torch_port.py``).  It runs on the reference and
on the port: its assertions must hold on both, and the log of every job,
completion time, occupancy counter, virtual-clock reading and tier counter
it records must be identical (tolerance 0).
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _torch_port import (assert_same_writer_io, job_shape, lockstep_packages,
                         package, snap)
from _torch_serve import serve_smoke

REF = package("repro")
PORT = package("repro_torch", device="cpu")


def lockstep(case, *args):
    lockstep_packages(REF, PORT, case, *args)


def _reader(m, n=20_000, seed=0, **kw):
    rng = np.random.default_rng(seed)
    arr = m.A.PrimitiveArray.build(
        rng.integers(0, 1 << 20, n).astype(np.int64),
        validity=rng.random(n) > 0.03)
    fb = m.write_table({"c": arr}, m.WriteOptions("lance-miniblock"))
    return m.FileReader(fb, **kw), n


def _rec(m, label, tiers, n_requests=1):
    """Shorthand synthetic drain: tiers = {tier: (ops, nbytes, phase)}."""
    return m.DrainRecord(label, n_requests,
                         {t: ({p: ops}, {p: nb})
                          for t, (ops, nb, p) in tiers.items()})


# ---------------------------------------------------------------------------
# Job construction + lone-job degeneration
# ---------------------------------------------------------------------------


def test_build_job_pipe_shares_sum_to_throughput_term():
    def case(m, log):
        rec = m.DrainRecord("take:c", 3,
                            {0: ({0: 5, 1: 3}, {0: 40_000, 1: 24_000}),
                             1: ({1: 2}, {1: 8_000_000})})
        job = m.build_job(rec, [m.NVME, m.S3])
        assert [(u.phase, u.tier) for u in job.units] == \
            [(0, 0), (1, 0), (1, 1)]
        tp_nvme = sum(u.pipe for u in job.units if u.tier == 0)
        total_ops, total_bytes = 8, 64_000
        avg = max(total_bytes / total_ops, 1.0)
        eff = max(avg, m.NVME.min_read)
        tp = max(total_ops / min(m.NVME.iops_4k, m.NVME.seq_bw / eff),
                 total_bytes / m.NVME.seq_bw)
        assert tp_nvme == tp
        log(job_shape(job))
    lockstep(case)


def test_lone_job_interleaved_equals_serial_price():
    def case(m, log):
        fr, n = _reader(m, store="tiered")
        fr.take("c", np.arange(64))
        fr.scan("c")
        devices = [lvl.device for lvl in fr.store.levels] + [fr.store.backing]
        qd = fr.scheduler.queue_depth
        for rec in fr.store.drain_log:
            job = m.build_job(rec, devices)
            serial = job.serial_time(qd)
            res = m.EventLoop(devices, qd).run([job], mode="interleaved")
            assert res.completions[0].done == pytest.approx(serial, rel=1e-12)
            res_s = m.EventLoop(devices, qd).run([job], mode="serial")
            assert res_s.completions[0].done == serial
            log((job_shape(job), serial, res, res_s))
    lockstep(case)


def test_immediate_mode_completion_is_bit_identical_to_model_time():
    def case(m, log):
        fr, n = _reader(m, store="tiered")
        fr.take("c", np.arange(128))
        sch = fr.scheduler
        assert len(sch.completions) == 1
        c = sch.completions[0]
        assert c.label == "take:c" and c.submit == 0.0
        assert c.latency == fr.modelled_time()
        assert sch.vclock == c.done
        fr.take("c", np.arange(128, 256))
        assert len(sch.completions) == 2
        assert sch.completions[1].done > c.done
        log((sch.completions, sch.vclock, fr.modelled_time()))
    lockstep(case)


def test_interleaved_makespan_never_worse_than_serial():
    def case(m, log):
        devices = [m.NVME, m.S3]
        jobs = []
        rng = np.random.default_rng(5)
        for i in range(30):
            tiers = {0: (int(rng.integers(1, 40)),
                         int(rng.integers(1, 9)) * 4096, 0)}
            if i % 3 == 0:
                tiers[1] = (int(rng.integers(1, 6)), 200_000, 1)
            jobs.append(m.build_job(_rec(m, f"take:{i}", tiers), devices,
                                    submit=float(i) * 1e-4, seq=i))
        for qd in (1, 4, 64):
            loop = m.EventLoop(devices, qd)
            inter = loop.run(jobs, mode="interleaved")
            serial = loop.run(jobs, mode="serial")
            assert len(inter.completions) == len(serial.completions) == 30
            assert inter.makespan <= serial.makespan * (1 + 1e-12)
            log((inter, serial))
    lockstep(case)


def test_completion_reordering_small_warm_beats_large_cold():
    def case(m, log):
        devices = [m.NVME, m.S3]
        cold = m.build_job(_rec(m, "take:cold", {1: (4, 400_000, 0)}),
                           devices, seq=0)
        warm = m.build_job(_rec(m, "take:warm", {0: (1, 4096, 0)}),
                           devices, seq=1)
        loop = m.EventLoop(devices, queue_depth=64)
        inter = loop.run([cold, warm], mode="interleaved")
        order = [c.label for c in sorted(inter.completions,
                                         key=lambda c: c.done)]
        assert order == ["take:warm", "take:cold"]
        serial = loop.run([cold, warm], mode="serial")
        order_s = [c.label for c in sorted(serial.completions,
                                           key=lambda c: c.done)]
        assert order_s == ["take:cold", "take:warm"]
        assert set(inter.tiers) == {"nvme_970evo", "s3"}
        assert inter.tiers["s3"]["max_outstanding"] == 4
        log((inter, serial))
    lockstep(case)


def test_rounds_amortize_across_concurrent_jobs():
    def case(m, log):
        devices = [m.NVME]
        jobs = [m.build_job(_rec(m, f"take:{i}", {0: (1, 4096, 0)}), devices,
                            seq=i) for i in range(10)]
        loop = m.EventLoop(devices, queue_depth=16)
        inter = loop.run(jobs, mode="interleaved")
        assert inter.tiers["nvme_970evo"]["rounds"] == 2
        assert inter.tiers["nvme_970evo"]["max_outstanding"] == 9
        serial = loop.run(jobs, mode="serial")
        assert serial.makespan >= 10 * m.NVME.latency
        assert inter.makespan < 3 * m.NVME.latency
        log((inter, serial))
    lockstep(case)


# ---------------------------------------------------------------------------
# QoS: weighted fairness, strict priority, starvation guard
# ---------------------------------------------------------------------------


def _contended_jobs(m, devices, n_per_tenant=16, tenants=("gold", "bronze")):
    jobs, seq = [], 0
    for i in range(n_per_tenant):
        for t in tenants:
            jobs.append(m.build_job(
                _rec(m, f"take:{t}:{i}", {0: (8, 8 * 4096, 0)}), devices,
                tenant=t, seq=seq))
            seq += 1
    return jobs


def test_qos_weights_bias_round_admission():
    def case(m, log):
        devices = [m.NVME]
        jobs = _contended_jobs(m, devices)
        qos = m.QoS(weights={"gold": 8.0, "bronze": 1.0})
        res = m.EventLoop(devices, queue_depth=8, qos=qos).run(jobs)
        mean = {t: np.mean([c.latency for c in res.completions
                            if c.tenant == t]) for t in ("gold", "bronze")}
        assert mean["gold"] < mean["bronze"]
        flat = m.EventLoop(devices, queue_depth=8, qos=m.QoS()).run(jobs)
        mean_flat = {t: np.mean([c.latency for c in flat.completions
                                 if c.tenant == t])
                     for t in ("gold", "bronze")}
        assert mean_flat["gold"] == pytest.approx(mean_flat["bronze"], rel=0.2)
        log((res, flat))
    lockstep(case)


def test_qos_strict_priority_and_starvation_guard():
    def case(m, log):
        devices = [m.NVME]
        jobs = _contended_jobs(m, devices, n_per_tenant=64)
        guarded = m.QoS(priority={"gold": 1, "bronze": 0}, starvation_rounds=4)
        res = m.EventLoop(devices, queue_depth=8, qos=guarded).run(jobs)
        done = {t: max(c.done for c in res.completions if c.tenant == t)
                for t in ("gold", "bronze")}
        first_bronze = min(c.done for c in res.completions
                           if c.tenant == "bronze")
        assert first_bronze < done["gold"]
        starved = m.QoS(priority={"gold": 1, "bronze": 0},
                        starvation_rounds=10**9)
        res2 = m.EventLoop(devices, queue_depth=8, qos=starved).run(jobs)
        first_bronze2 = min(c.done for c in res2.completions
                            if c.tenant == "bronze")
        gold_done2 = max(c.done for c in res2.completions if c.tenant == "gold")
        assert first_bronze2 >= gold_done2 - m.NVME.latency
        assert first_bronze < first_bronze2
        log((res, res2))
    lockstep(case)


def test_latency_percentiles_shape():
    def case(m, log):
        assert m.latency_percentiles([]) is None
        p = m.latency_percentiles([3.0, 1.0, 2.0])
        assert p["count"] == 3 and p["p50"] == 2.0 and p["max"] == 3.0
        assert p["p50"] <= p["p99"] <= p["p999"] <= p["max"]
        log(p)
    lockstep(case)


# ---------------------------------------------------------------------------
# ServiceWindow: capture, purity, nesting, flush interleaving
# ---------------------------------------------------------------------------


def test_service_window_captures_instead_of_advancing_vclock():
    def case(m, log):
        fr, n = _reader(m, store="tiered")
        sch = fr.scheduler
        with sch.service_window() as win:
            with win.request(tenant="a", at=0.0):
                fr.take("c", np.arange(50))
            with win.request(tenant="b", at=0.001):
                fr.take("c", np.arange(50, 90))
        assert sch.vclock == 0.0 and sch.completions == []
        assert [j.tenant for j in win.jobs] == ["a", "b"]
        assert [j.submit for j in win.jobs] == [0.0, 0.001]
        inter = win.run("interleaved")
        serial = win.run("serial")
        assert len(inter.completions) == len(serial.completions) == 2
        again = win.run("interleaved")
        assert [c.done for c in again.completions] == \
            [c.done for c in inter.completions]
        assert inter.completions[0].done <= serial.completions[-1].done
        log(([job_shape(j) for j in win.jobs], inter, serial))
    lockstep(case)


def test_service_window_accounting_is_identical_to_no_window():
    rows = np.arange(0, 2000, 7)

    def case(m, log):
        def run(windowed):
            fr, _ = _reader(m, store="tiered")
            if windowed:
                with fr.scheduler.service_window() as win:
                    with win.request(tenant="t"):
                        fr.take("c", rows)
            else:
                fr.take("c", rows)
            st = fr.io_stats()
            tiers = [(s.n_iops, s.bytes_read, s.write_iops) for s in
                     fr.store.tier_stats()]
            return (st.n_iops, st.bytes_read, tiers)

        assert run(False) == run(True)
        log(run(True))
    lockstep(case)


def test_service_windows_do_not_nest():
    def case(m, log):
        fr, _ = _reader(m, store="tiered")
        with fr.scheduler.service_window():
            with pytest.raises(RuntimeError, match="nest") as err:
                with fr.scheduler.service_window():
                    pass
        with fr.scheduler.service_window():
            pass
        log(str(err.value))
    lockstep(case)


def test_window_captures_flush_drains_as_jobs():
    def case(m, log):
        rng = np.random.default_rng(2)
        arr = m.A.PrimitiveArray.build(
            rng.integers(0, 1000, 500).astype(np.int64))
        fb = m.write_table({"c": arr}, m.WriteOptions("lance-fullzip"))
        w = m.DatasetWriter(files=[fb], flush="write-back")
        with w.scheduler.service_window() as win:
            with win.request(tenant="reader", at=0.0):
                w.take("c", np.arange(20))
            with win.request(tenant="ingest", at=0.0005):
                w.append({"c": m.A.PrimitiveArray.build(
                    rng.integers(0, 1000, 200).astype(np.int64))}, commit=True)
        labels = [j.label for j in win.jobs]
        assert any(lab.startswith("take:") for lab in labels)
        assert any(lab.startswith("flush:") for lab in labels)
        flush_jobs = [j for j in win.jobs if j.label.startswith("flush:")]
        assert all(j.tenant == "ingest" for j in flush_jobs)
        res = win.run("interleaved")
        assert len(res.completions) == len(win.jobs)
        log(([job_shape(j) for j in win.jobs], res))
    lockstep(case)


def test_event_loop_rejects_unknown_mode():
    def case(m, log):
        with pytest.raises(ValueError, match="mode") as err:
            m.EventLoop([m.NVME]).run([], mode="warp")
        log(str(err.value))
    lockstep(case)


def test_scheduler_reset_clears_serving_state():
    def case(m, log):
        fr, _ = _reader(m, store="tiered")
        fr.take("c", np.arange(10))
        sch = fr.scheduler
        assert sch.vclock > 0 and sch.completions
        log((sch.vclock, sch.completions))
        sch.reset()
        assert sch.vclock == 0.0 and sch.completions == []
    lockstep(case)


# ---------------------------------------------------------------------------
# Zipf multi-tenant serve workload
# ---------------------------------------------------------------------------


def test_zipf_workload_deterministic_and_skewed():
    def case(m, log):
        tenants = [m.TenantSpec("a", share=1.0, weight=2.0),
                   m.TenantSpec("b", share=3.0)]
        wl1 = m.ZipfWorkload(5000, tenants, n_requests=400, zipf_s=1.2, seed=9)
        wl2 = m.ZipfWorkload(5000, tenants, n_requests=400, zipf_s=1.2, seed=9)
        r1, r2 = wl1.generate(), wl2.generate()
        assert [r.tenant for r in r1] == [r.tenant for r in r2]
        assert all(np.array_equal(x.rows, y.rows) for x, y in zip(r1, r2))
        assert [r.at for r in r1] == [r.at for r in r2]
        ats = [r.at for r in r1]
        assert all(x < y for x, y in zip(ats, ats[1:]))
        n_b = sum(r.tenant == "b" for r in r1)
        assert 2.0 < n_b / (400 - n_b) < 4.5
        rows = np.concatenate([r.rows for r in r1])
        hot = np.mean(rows < 50)
        assert hot > 0.15
        q = wl1.qos()
        assert q.weight_for("a") == 2.0 and q.weight_for("b") == 1.0
        log((r1, q))
    lockstep(case)


def test_zipf_workload_validation():
    def case(m, log):
        for n_rows, n_requests in ((0, 5), (10, 0)):
            with pytest.raises(ValueError) as err:
                m.ZipfWorkload(n_rows, [m.TenantSpec("a")],
                               n_requests=n_requests)
            log(str(err.value))
    lockstep(case)


def test_drive_prices_same_workload_under_both_models():
    def case(m, log):
        rng = np.random.default_rng(11)
        arr = m.A.PrimitiveArray.build(
            rng.integers(0, 1 << 16, 3000).astype(np.int64))
        fb = m.write_table({"c": arr}, m.WriteOptions("lance-fullzip"))
        w = m.DatasetWriter(
            files=[fb],
            store=lambda d: m.TieredStore.cached(d, cache_bytes=8 * 4096),
            flush="write-back")
        tenants = [m.TenantSpec("p", share=1.0, weight=4.0,
                                rows_per_request=16),
                   m.TenantSpec("s", share=2.0, rows_per_request=16)]
        wl = m.ZipfWorkload(w.n_rows, tenants, n_requests=40,
                            arrival_rate=500.0, seed=4)
        inter, serial, _win = m.drive(w, "c", wl.generate(), qos=wl.qos())
        assert len(inter.completions) == len(serial.completions) == 40
        assert inter.makespan <= serial.makespan * (1 + 1e-12)
        summ = m.tenant_summary(inter, ["p", "s"])
        assert {"p", "s", "all"} <= set(summ)
        assert summ["all"]["count"] == 40
        assert summ["all"]["p50"] <= summ["all"]["p99"] <= summ["all"]["p999"]
        log((inter, serial, summ, w.tier_stats(), w.io_stats()))
    lockstep(case)


# ---------------------------------------------------------------------------
# tests/test_evloop_properties.py
# ---------------------------------------------------------------------------

_PHASE = st.integers(0, 3)
_BUCKET = st.tuples(_PHASE, st.integers(1, 500), st.integers(0, 4 << 20))


def _devices(m):
    return [m.DRAM, m.NVME, m.S3]


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


@settings(max_examples=200, deadline=None)
@given(
    buckets_by_tier=st.dictionaries(
        st.integers(0, 2), st.lists(_BUCKET, min_size=1, max_size=4),
        min_size=1, max_size=3),
    queue_depth=st.integers(1, 256),
)
def test_single_outstanding_batch_degenerates_to_serial_drain_price(
        buckets_by_tier, queue_depth):
    def case(m, log):
        devices = _devices(m)
        rec = _record(m, buckets_by_tier)
        job = m.build_job(rec, devices)
        expect = 0.0
        for tier in sorted(rec.tiers):
            phase_ops, phase_bytes = rec.tiers[tier]
            ts = m.TierStats(name="t")
            for phase in sorted(phase_ops):
                ts.add_op(phase_bytes.get(phase, 0), phase)
                for _ in range(phase_ops[phase] - 1):
                    ts.add_op(0, phase)
            expect += ts.model_time(devices[tier], queue_depth)
        serial = job.serial_time(queue_depth)
        assert serial == pytest.approx(expect, rel=1e-12, abs=1e-15)
        loop = m.EventLoop(devices, queue_depth)
        inter = loop.run([job], mode="interleaved")
        assert len(inter.completions) == 1
        assert inter.completions[0].done == pytest.approx(serial, rel=1e-12,
                                                          abs=1e-15)
        res_s = loop.run([job], mode="serial")
        assert res_s.completions[0].done == serial
        log((expect, serial, inter, res_s))
    lockstep(case)


@settings(max_examples=60, deadline=None)
@given(
    jobs_spec=st.lists(
        st.tuples(st.dictionaries(st.integers(0, 2),
                                  st.lists(_BUCKET, min_size=1, max_size=2),
                                  min_size=1, max_size=2),
                  st.floats(0.0, 0.01)),
        min_size=1, max_size=8),
    queue_depth=st.integers(1, 64),
)
def test_interleaving_never_worse_than_serial_and_conserves_jobs(
        jobs_spec, queue_depth):
    def case(m, log):
        devices = _devices(m)
        jobs = [m.build_job(_record(m, buckets), devices, submit=at, seq=i)
                for i, (buckets, at) in enumerate(jobs_spec)]
        loop = m.EventLoop(devices, queue_depth)
        inter = loop.run(jobs, mode="interleaved")
        serial = loop.run(jobs, mode="serial")
        assert len(inter.completions) == len(serial.completions) == len(jobs)
        assert inter.makespan <= serial.makespan * (1 + 1e-9)
        for c in inter.completions:
            assert c.done >= c.submit
            assert not math.isnan(c.latency)
        log((inter, serial))
    lockstep(case)


# ---------------------------------------------------------------------------
# the slice: the serve bench's smoke run on both packages
# ---------------------------------------------------------------------------


def test_serve_drive_smoke_matches_reference():
    """``serve.workload.drive`` at the serve bench's smoke size
    (``tests/_torch_serve.py``) on the reference and on the port's device
    route (on the CPU): identical interleaved and serial completions, tier
    stats, IO, write trace, modelled time and take values, and every take
    equals its source rows."""
    runs = [serve_smoke(REF), serve_smoke(PORT, decode="device")]
    (rw, rrec, rinter, rserial, rwin, source), (pw, prec, pinter, pserial, pwin, _) = runs
    assert pw.device.type == "cpu" and pw._decode == "device"
    assert len(rrec.takes) == len(prec.takes) == 96
    assert snap(rinter) == snap(pinter)
    assert snap(rserial) == snap(pserial)
    assert [job_shape(j) for j in rwin.jobs] == [job_shape(j) for j in pwin.jobs]
    assert_same_writer_io(rw, pw)
    for (rows, want), (prows, got) in zip(rrec.takes, prec.takes):
        assert np.array_equal(rows, prows)
        np.testing.assert_array_equal(want.values, got.values)
        np.testing.assert_array_equal(got.values, source[rows])
    assert pinter.makespan <= pserial.makespan * (1 + 1e-12)
