"""The port's live metrics plane and SLO subsystem (log-bucket and windowed
histograms, virtual-clock gauges, burn-rate alerts, degradations, per-tier
queue depths, closed-loop arrivals) against the JAX package's, in lockstep
on the CPU.

Each case is the body of a test of ``tests/test_metrics_plane.py``, written
once over a namespace of one package's names (``tests/_torch_port.py``).
It runs on the reference and on the port: its assertions must hold on both,
and the log of every quantile, gauge series, exported plane, Prometheus
dump, alert and completion it records must be identical (tolerance 0).

Cases of ``tests/test_metrics_plane.py`` left out, because they test the
benchmark harness's tools (``tools/bench_gate.py``, ``tools/bench_history.py``
and ``tools/obs_report.py``), which wait for ROADMAP.md, Queue 1 item 11:
``test_bench_gate_slo_keys_always_strict``,
``test_bench_history_collect_and_idempotent_append`` and
``test_obs_report_renders_sparklines_and_slo_table``.
"""

import json
import random

import pytest

from _torch_port import job_shape, lockstep_packages, package, trace_shape

REF = package("repro")
PORT = package("repro_torch", device="cpu")


def lockstep(case, *args):
    lockstep_packages(REF, PORT, case, *args)


def _rec(m, label, tiers, n_requests=1):
    """Shorthand synthetic drain: tiers = {tier: (ops, nbytes, phase)}."""
    return m.DrainRecord(label, n_requests,
                         {t: ({p: ops}, {p: nb})
                          for t, (ops, nb, p) in tiers.items()})


def _hist_state(h):
    return (sorted(h.buckets.items()), h.zero_count, h.count, h.sum, h.min,
            h.max)


# ---------------------------------------------------------------------------
# log-bucket histogram
# ---------------------------------------------------------------------------


def test_log_bucket_quantiles_within_relative_error():
    def case(m, log):
        rng = random.Random(42)
        for rel_err in (0.05, 0.01):
            h = m.LogBucketHistogram(rel_err)
            xs = [rng.lognormvariate(0.0, 2.0) for _ in range(4000)]
            for x in xs:
                h.observe(x)
            for q in (1, 10, 25, 50, 75, 90, 99, 99.9):
                exact = m.percentile(xs, q)
                approx = h.quantile(q)
                assert abs(approx - exact) <= rel_err * exact * 1.0001, \
                    (rel_err, q, exact, approx)
                log((rel_err, q, exact, approx))
    lockstep(case)


def test_log_bucket_extremes_and_zeros_exact():
    def case(m, log):
        h = m.LogBucketHistogram(0.01)
        for v in (0.0, 0.0, 3.5, 700.25):
            h.observe(v)
        assert h.min == 0.0 and h.max == 700.25
        assert h.quantile(0) == 0.0 and h.quantile(100) == 700.25
        assert h.quantile(50) == 0.0
        assert h.count == 4 and h.sum == pytest.approx(703.75)
        with pytest.raises(ValueError):
            h.observe(-1.0)
        log((_hist_state(h), [h.quantile(q) for q in (0, 25, 50, 75, 100)]))
    lockstep(case)


def test_log_bucket_merge_is_exact():
    def case(m, log):
        rng = random.Random(7)
        xs = [rng.expovariate(1.0) for _ in range(500)]
        ys = [rng.expovariate(0.1) for _ in range(300)]
        both = m.LogBucketHistogram(0.02)
        for v in xs + ys:
            both.observe(v)
        a = m.LogBucketHistogram(0.02)
        b = m.LogBucketHistogram(0.02)
        for v in xs:
            a.observe(v)
        for v in ys:
            b.observe(v)
        a.merge(b)
        assert a.buckets == both.buckets
        assert a.count == both.count and a.sum == pytest.approx(both.sum)
        assert a.min == both.min and a.max == both.max
        with pytest.raises(ValueError):
            a.merge(m.LogBucketHistogram(0.01))
        log((_hist_state(a), _hist_state(both)))
    lockstep(case)


def test_log_bucket_empty_summary_and_quantile():
    def case(m, log):
        h = m.LogBucketHistogram()
        s = h.summary()
        assert s == {"count": 0, "mean": None, "p50": None, "p99": None,
                     "p999": None, "max": None}
        with pytest.raises(ValueError):
            h.quantile(50)
        log(s)
    lockstep(case)


# ---------------------------------------------------------------------------
# windowed histogram
# ---------------------------------------------------------------------------


def test_window_rotation_never_loses_counts():
    def case(m, log):
        w = m.WindowedHistogram(window=1.0, n_windows=4, rel_err=0.01)
        rng = random.Random(0)
        n = 0
        for _ in range(500):
            t = rng.uniform(0, 40)
            w.observe(t, rng.uniform(0.1, 10))
            n += 1
            live = w.live_count
            assert w.total.count == w.dropped + live
            log((w.dropped, live))
        assert w.total.count == n
        log(w.summary())
    lockstep(case)


def test_window_live_horizon_and_straggler():
    def case(m, log):
        w = m.WindowedHistogram(window=1.0, n_windows=2, rel_err=0.01)
        w.observe(0.5, 1.0)
        w.observe(1.5, 2.0)
        assert w.live_count == 2
        w.observe(2.5, 3.0)
        assert w.live_count == 2 and w.dropped == 1
        w.observe(0.1, 9.0)
        assert w.live_count == 2 and w.dropped == 2
        assert w.total.count == 4
        merged = w.merged()
        assert merged.count == 2
        assert w.quantile(100) == pytest.approx(3.0, rel=0.01)
        log((_hist_state(merged), w.quantile(100), w.summary()))
    lockstep(case)


def test_window_summary_shape():
    def case(m, log):
        w = m.WindowedHistogram(window=0.5, n_windows=4)
        w.observe(0.1, 0.25)
        s = w.summary()
        assert s["count"] == 1 and s["lifetime_count"] == 1
        assert s["window_s"] == pytest.approx(2.0)
        log(s)
    lockstep(case)


# ---------------------------------------------------------------------------
# gauges + plane
# ---------------------------------------------------------------------------


def test_gauge_series_export_downsamples_deterministically():
    def case(m, log):
        g = m.GaugeSeries("x")
        for i in range(100):
            g.sample(i * 0.1, float(i))
        full = g.export()
        assert full["n_samples"] == 100 and len(full["t"]) == 100
        small = g.export(max_points=10)
        assert len(small["t"]) <= 11 and small["v"][-1] == 99.0
        assert small == g.export(max_points=10)
        assert g.between(1.0, 2.0) == [10.0 + k for k in range(10)]
        log((full, small))
    lockstep(case)


def test_disabled_plane_allocates_nothing():
    def case(m, log):
        assert not m.NULL_PLANE.enabled
        m.NULL_PLANE.sample("tier.x.utilization", 1.0, 0.5)
        m.NULL_PLANE.observe_latency("lat.t", 1.0, 0.1)
        assert m.NULL_PLANE.series == {} and m.NULL_PLANE.latency == {}
        log((m.NULL_PLANE.series, m.NULL_PLANE.latency))
    lockstep(case)


def test_plane_prometheus_and_export_are_json_safe():
    def case(m, log):
        p = m.MetricsPlane(window=0.5, n_windows=4)
        p.counter("slo.breach.premium").inc(2)
        p.sample("tier.nvme.utilization", 0.5, 0.75)
        p.observe_latency("latency.premium", 0.5, 0.004)
        text = p.prometheus_text()
        assert "# TYPE slo_breach_premium counter" in text
        assert "slo_breach_premium 2" in text
        assert "# TYPE tier_nvme_utilization gauge" in text
        assert "latency_premium_bucket" in text and 'le="+Inf"' in text
        assert "latency_premium_count 1" in text
        blob = json.dumps(p.export(), allow_nan=False)
        back = json.loads(blob)
        assert back["counters"] == {"slo.breach.premium": 2}
        assert back["series"]["tier.nvme.utilization"]["v"] == [0.75]
        log((text, blob))
    lockstep(case)


def test_plane_to_trace_emits_virtual_clock_counters():
    def case(m, log):
        p = m.MetricsPlane()
        p.sample("tier.nvme.utilization", 0.25, 0.5)
        p.sample("tier.nvme.utilization", 0.75, 1.0)
        tr = m.Tracer()
        n = p.to_trace(tr)
        assert n == 2
        evs = [e for e in tr.events if e["ph"] == "C"]
        assert [e["ts"] for e in evs] == [0.25e6, 0.75e6]
        assert evs[0]["args"] == {"value": 0.5}
        # these timestamps are the virtual clock's, so they are compared too
        log(([e["ts"] for e in evs], trace_shape(tr.events)))
    lockstep(case)


def test_tracer_counter_ts_override():
    def case(m, log):
        tr = m.Tracer()
        tr.counter("c", {"v": 1.0}, ts=123.0)
        tr.counter("c", {"v": 2.0})
        assert tr.events[0]["ts"] == 123.0
        assert tr.events[1]["ts"] != 123.0
        log((tr.events[0]["ts"], trace_shape(tr.events)))
    lockstep(case)


# ---------------------------------------------------------------------------
# registry satellites: empty-histogram summary, summaries(), prometheus_text
# ---------------------------------------------------------------------------


def test_empty_histogram_summary_is_none_valued():
    def case(m, log):
        reg = m.MetricsRegistry()
        h = reg.histogram("lat")
        assert h.summary() == {"count": 0, "mean": None, "p50": None,
                               "p99": None, "p999": None, "max": None}
        log(json.dumps(h.summary(), allow_nan=False))
    lockstep(case)


def test_registry_summaries_prefix_snapshot():
    def case(m, log):
        reg = m.MetricsRegistry()
        reg.histogram("a.x").observe(1.0)
        reg.histogram("a.y")
        reg.histogram("b.z").observe(2.0)
        snap = reg.summaries("a.")
        assert sorted(snap) == ["a.x", "a.y"]
        assert snap["a.x"]["count"] == 1 and snap["a.y"]["count"] == 0
        log(snap)
    lockstep(case)


def test_prometheus_text_from_registry():
    def case(m, log):
        reg = m.MetricsRegistry()
        reg.counter("decode.fallback.fullzip.float-values").inc(3)
        reg.histogram("take.lat").observe_many([1.0, 2.0, 3.0])
        text = m.prometheus_text(reg)
        assert "# TYPE decode_fallback_fullzip_float_values counter" in text
        assert "decode_fallback_fullzip_float_values 3" in text
        assert 'take_lat{quantile="0.5"} 2.0' in text
        assert "take_lat_count 3" in text
        log(text)
    lockstep(case)


# ---------------------------------------------------------------------------
# Degradation model
# ---------------------------------------------------------------------------


def test_degradation_schedule_and_compounding():
    def case(m, log):
        d1 = m.Degradation(start=1.0, end=2.0, latency_factor=4.0)
        d2 = m.Degradation(start=1.5, latency_factor=2.0, throughput_factor=0.5)
        dev = m.NVME.with_fault(d1).with_fault(d2)
        assert m.NVME.faults == ()
        assert dev.latency_factor_at(0.5) == 1.0
        assert dev.latency_factor_at(1.2) == 4.0
        assert dev.latency_factor_at(1.7) == 8.0
        assert dev.latency_factor_at(2.5) == 2.0
        assert dev.bandwidth_factor_at(1.7) == 0.5
        for kw in ({"start": 0.0, "latency_factor": 0.0},
                   {"start": 2.0, "end": 1.0}):
            with pytest.raises(ValueError) as err:
                m.Degradation(**kw)
            log(str(err.value))
        log((dev, [(dev.latency_factor_at(t), dev.bandwidth_factor_at(t))
                   for t in (0.5, 1.2, 1.7, 2.5)]))
    lockstep(case)


def test_fault_stretches_interleaved_only_after_start():
    def case(m, log):
        rec = _rec(m, "take", {0: (64, 1 << 20, 0)})
        dev_ok = m.NVME
        dev_bad = m.NVME.with_fault(m.Degradation(
            start=100.0, latency_factor=50.0, throughput_factor=0.1))
        job_a = m.build_job(rec, [dev_ok])
        job_b = m.build_job(rec, [dev_ok])
        base = m.EventLoop([dev_ok], queue_depth=8).run([job_a]).makespan
        pre = m.EventLoop([dev_bad], queue_depth=8).run([job_b]).makespan
        assert pre == base
        dev_now = m.NVME.with_fault(m.Degradation(
            start=0.0, latency_factor=50.0, throughput_factor=0.1))
        job_c = m.build_job(rec, [dev_ok])
        hot = m.EventLoop([dev_now], queue_depth=8).run([job_c]).makespan
        assert hot > base
        job_d = m.build_job(rec, [dev_ok])
        s_ok = m.EventLoop([dev_ok], queue_depth=8).run([job_d], mode="serial")
        s_bad = m.EventLoop([dev_now], queue_depth=8).run([job_d],
                                                          mode="serial")
        assert s_ok.completions == s_bad.completions
        log((base, pre, hot, s_ok, s_bad))
    lockstep(case)


# ---------------------------------------------------------------------------
# event-loop sampling: bit-identity + utilization saturation
# ---------------------------------------------------------------------------


def _jobs(m, n=20, submit_gap=0.001):
    jobs = []
    for i in range(n):
        rec = _rec(m, f"take#{i}", {0: (16, 256 << 10, 0), 1: (2, 64 << 10, 0)})
        jobs.append(m.build_job(rec, [m.NVME, m.S3], tenant="t",
                                submit=i * submit_gap, seq=i))
    return jobs


def test_plane_sampling_leaves_completions_bit_identical():
    def case(m, log):
        plain = m.EventLoop([m.NVME, m.S3], queue_depth=8).run(_jobs(m))
        plane = m.MetricsPlane(window=0.01, n_windows=8)
        slo = m.SLOMonitor({"t": m.SLObjective(0.5)}, registry=plane.registry,
                           plane=plane)
        sampled = m.EventLoop([m.NVME, m.S3], queue_depth=8, plane=plane,
                              slo=slo).run(_jobs(m))
        assert sampled.completions == plain.completions
        assert sampled.tiers == plain.tiers
        names = set(plane.series)
        assert f"tier.{m.NVME.name}.utilization" in names
        assert f"tier.{m.NVME.name}.outstanding" in names
        assert f"tier.{m.NVME.name}.pipe_backlog" in names
        assert "jobs.in_flight" in names
        assert plane.latency["latency.t"].total.count == len(plain.completions)
        log((plain, plane.export(), slo.table()))
    lockstep(case)


def test_degraded_utilization_saturates_and_slo_fires():
    def case(m, log):
        jobs = _jobs(m, n=60, submit_gap=0.01)
        healthy = m.EventLoop([m.NVME, m.S3], queue_depth=8).run(
            _jobs(m, 60, 0.01))
        t_deg = 0.2
        bad = m.NVME.with_fault(m.Degradation(start=t_deg, latency_factor=300.0,
                                              throughput_factor=0.01))
        plane = m.MetricsPlane(window=0.05, n_windows=8)
        lat = [c.latency for c in healthy.completions]
        obj = m.SLObjective(latency_s=max(lat) * 1.1, target=0.99)
        slo = m.SLOMonitor({"t": obj},
                           windows=(m.BurnWindow(0.2, 0.025, 2.0),),
                           registry=plane.registry, plane=plane)
        res = m.EventLoop([bad, m.S3], queue_depth=8, plane=plane,
                          slo=slo).run(jobs)
        util = plane.series[f"tier.{m.NVME.name}.utilization"]
        post = util.between(t_deg, float("inf"))
        assert post and max(post) > 0.9
        alert = slo.first_alert("t")
        assert alert is not None and alert.at >= t_deg
        assert plane.registry.counter("slo.breach.t").value >= 1
        log((res, plane.export(), slo.alerts, slo.table()))
    lockstep(case)


# ---------------------------------------------------------------------------
# per-tier queue depths
# ---------------------------------------------------------------------------


def test_per_tier_queue_depth_lone_job_degeneration():
    def case(m, log):
        rec = _rec(m, "take", {0: (64, 1 << 20, 0), 1: (10, 2 << 20, 1)})
        depths = {m.NVME.name: 4, m.S3.name: 2}
        job = m.build_job(rec, [m.NVME, m.S3])
        serial = job.serial_time(256, depths)
        lone = m.EventLoop([m.NVME, m.S3], queue_depth=256,
                           queue_depths=depths).run(
                               [m.build_job(rec, [m.NVME, m.S3])])
        assert lone.completions[0].done == pytest.approx(serial, rel=1e-12)
        assert serial > job.serial_time(256)
        log((serial, job.serial_time(256), lone))
    lockstep(case)


def test_per_tier_depth_falls_back_to_shared():
    def case(m, log):
        rec = _rec(m, "take", {0: (64, 1 << 20, 0)})
        job = m.build_job(rec, [m.NVME])
        assert job.serial_time(8, {"some_other_dev": 2}) == job.serial_time(8)
        loop = m.EventLoop([m.NVME, m.S3], queue_depth=8,
                           queue_depths={m.S3.name: 2})
        assert loop.qd_for(m.NVME) == 8 and loop.qd_for(m.S3) == 2
        log((job.serial_time(8), job_shape(job)))
    lockstep(case)


# ---------------------------------------------------------------------------
# SLO monitor semantics
# ---------------------------------------------------------------------------


def test_burn_rate_math_and_rising_edge():
    def case(m, log):
        reg = m.MetricsRegistry()
        tr = m.Tracer()
        mon = m.SLOMonitor({"t": m.SLObjective(latency_s=0.01, target=0.9)},
                           windows=(m.BurnWindow(1.0, 0.25, 2.0),),
                           tracer=tr, registry=reg)
        t = 0.0
        for _ in range(20):
            t += 0.01
            mon.observe("t", t, 0.001)
        assert mon.alerts == []
        for _ in range(20):
            t += 0.01
            mon.observe("t", t, 0.05)
        assert len(mon.alerts) == 1
        a = mon.alerts[0]
        assert a.burn_long >= 2.0 and a.burn_short >= 2.0
        assert reg.counter("slo.breach.t").value == 1
        assert any(e["name"] == "slo_breach:t" for e in tr.events)
        for _ in range(200):
            t += 0.01
            mon.observe("t", t, 0.001)
        for _ in range(40):
            t += 0.01
            mon.observe("t", t, 0.05)
        assert len(mon.alerts) == 2
        assert reg.counter("slo.requests.t").value == 280
        assert reg.counter("slo.bad.t").value == 60
        log((mon.alerts, reg.counter_values(), mon.table(),
             trace_shape(tr.events)))
    lockstep(case)


def test_slo_monitor_ignores_tenants_without_objective():
    def case(m, log):
        mon = m.SLOMonitor({"premium": m.SLObjective(0.01)})
        mon.observe("standard", 1.0, 99.0)
        assert mon.alerts == [] and mon.table()[0]["requests"] == 0
        log(mon.table())
    lockstep(case)


def test_slo_table_shape():
    def case(m, log):
        mon = m.SLOMonitor({"p": m.SLObjective(0.02, 0.95)})
        mon.observe("p", 0.1, 0.001)
        mon.observe("p", 0.2, 0.5)
        (row,) = mon.table()
        assert row["tenant"] == "p" and row["requests"] == 2 \
            and row["bad"] == 1
        assert row["bad_fraction"] == pytest.approx(0.5)
        assert row["objective_ms"] == pytest.approx(20.0)
        log(json.dumps(mon.table(), allow_nan=False))
    lockstep(case)


# ---------------------------------------------------------------------------
# closed-loop arrivals
# ---------------------------------------------------------------------------


def test_closed_loop_chain_orders_requests_per_client():
    def case(m, log):
        rec = _rec(m, "take", {0: (16, 256 << 10, 0)})
        a = m.build_job(rec, [m.NVME], seq=1)
        b = m.build_job(rec, [m.NVME], seq=2)
        b.after, b.think = a, 0.5
        for mode in ("interleaved", "serial"):
            res = m.EventLoop([m.NVME], queue_depth=8).run([a, b], mode=mode)
            ca = next(c for c in res.completions if c.submit < 0.5)
            cb = next(c for c in res.completions if c.submit >= 0.5)
            assert cb.submit == pytest.approx(ca.done + 0.5)
            assert cb.latency == pytest.approx(ca.latency)
            log(res)
    lockstep(case)


def test_closed_loop_dependency_outside_run_is_ignored():
    def case(m, log):
        rec = _rec(m, "take", {0: (4, 4096, 0)})
        ghost = m.build_job(rec, [m.NVME], seq=1)
        dep = m.build_job(rec, [m.NVME], seq=2)
        dep.after, dep.think = ghost, 99.0
        res = m.EventLoop([m.NVME], queue_depth=8).run([dep])
        assert len(res.completions) == 1 and res.completions[0].submit == 0.0
        log(res)
    lockstep(case)


def test_zipf_closed_generation_and_open_bit_identity():
    def case(m, log):
        tenants = [m.TenantSpec("a", share=1.0), m.TenantSpec("b", share=1.0)]
        base = m.ZipfWorkload(1000, tenants, 50, seed=5).generate()
        same = m.ZipfWorkload(1000, tenants, 50, seed=5, arrival="open",
                              think_time=9.0, clients_per_tenant=7).generate()
        assert [(r.tenant, r.at, r.rows.tolist()) for r in base] \
            == [(r.tenant, r.at, r.rows.tolist()) for r in same]
        assert all(r.client is None for r in base)
        closed = m.ZipfWorkload(1000, tenants, 50, seed=5, arrival="closed",
                                clients_per_tenant=3).generate()
        assert all(r.at == 0.0 and r.client for r in closed)
        a_clients = [r.client for r in closed if r.tenant == "a"]
        assert a_clients[:4] == \
            ["a/c0", "a/c1", "a/c2", "a/c0"][:len(a_clients)]
        with pytest.raises(ValueError) as err:
            m.ZipfWorkload(1000, tenants, 5, arrival="drip")
        log((base, closed, str(err.value)))
    lockstep(case)


def test_zipf_slo_objectives_from_tenant_spec():
    def case(m, log):
        tenants = [m.TenantSpec("p", slo_ms=5.0, slo_target=0.999),
                   m.TenantSpec("s")]
        wl = m.ZipfWorkload(100, tenants, 5)
        objs = wl.slo_objectives()
        assert set(objs) == {"p"}
        assert objs["p"].latency_s == pytest.approx(0.005)
        assert objs["p"].target == 0.999
        log(objs)
    lockstep(case)
