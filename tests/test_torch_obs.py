"""The port's observability layer (``repro_torch.obs``: tracer, metrics
registry, attribution, the live plane's histograms) against the JAX
package's, in lockstep on the CPU.

Each case is the body of a test of ``tests/test_obs.py`` or
``tests/test_timeseries_properties.py``, written once over a namespace of
one package's names (``tests/_torch_port.py``).  It runs on the reference
and on the port: its assertions must hold on both, and the log of every
counter, modelled time, attribution sum and trace event (name, category,
track and args; never a wall-clock timestamp) it records must be identical
(tolerance 0).

Cases of ``tests/test_obs.py`` left out, because they test the benchmark
harness (``benchmarks/run.py`` and ``tools/bench_gate.py``), which waits for
ROADMAP.md, Queue 1 item 11: ``test_bench_gate_compare_rules``,
``test_bench_gate_exit_codes``, ``test_committed_smoke_baselines_exist``,
``test_run_name_validation``, ``test_run_meta_and_nan_refusal`` and
``test_bench_gate_percentile_keys_are_strict``.

One deliberate difference: at a ``q`` so small that ``q / 100 * n``
underflows, the nearest rank is clamped to 1 in the port (the minimum),
where the reference's ``percentile`` returns ``xs[-1]`` and its
``LogBucketHistogram.quantile`` 0.0.  The port-only tests at the end show
it; the quantile property compares the two packages everywhere else.
"""

import json
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _torch_port import lockstep_packages, package, trace_shape

REF = package("repro")
PORT = package("repro_torch", device="cpu")


def lockstep(case, *args):
    lockstep_packages(REF, PORT, case, *args)


def _mb_reader(m, n=20_000, seed=0, **kw):
    rng = np.random.default_rng(seed)
    arr = m.A.PrimitiveArray.build(
        rng.integers(0, 1 << 20, n).astype(np.int64),
        validity=rng.random(n) > 0.03)
    fb = m.write_table({"c": arr}, m.WriteOptions("lance-miniblock"))
    return m.FileReader(fb, **kw), n


def _tier_model_times(store, queue_depth):
    devices = [lvl.device for lvl in store.levels] + [store.backing]
    return [(s.name, s.model_time(d, queue_depth))
            for s, d in zip(store.tier_stats(), devices)]


# ---------------------------------------------------------------------------
# TierStats / WorkloadStats direct coverage
# ---------------------------------------------------------------------------


def test_tier_stats_phase_buckets_roundtrip():
    def case(m, log):
        s = m.TierStats("t")
        s.add_op(4096, phase=0)
        s.add_op(8192, phase=0, prefetch=True)
        s.add_write_op(4096, phase=1, flush=True)
        assert s.phase_ops == {0: 2, 1: 1}
        assert s.phase_bytes == {0: 12288, 1: 4096}
        assert (s.n_iops, s.write_iops) == (2, 1)
        assert (s.prefetch_bytes, s.flush_bytes) == (8192, 4096)
        drained = s.end_batch()
        assert drained == ({0: 2, 1: 1}, {0: 12288, 1: 4096})
        assert s.phase_ops == {} and s.phase_bytes == {}
        assert s.batch_phases == [{0: 2, 1: 1}]
        assert s.end_batch() is None
        snap = s.snapshot()
        s.reset()
        assert snap.batch_phases == [{0: 2, 1: 1}] and s.batch_phases == []
        log((drained, snap))
    lockstep(case)


def test_tier_stats_hit_rate_never_nan():
    def case(m, log):
        s = m.TierStats("t")
        assert s.hit_rate is None
        s.hits, s.misses = 3, 1
        assert s.hit_rate == 0.75
        log(s.hit_rate)
    lockstep(case)


def test_more_phases_cost_strictly_more_latency():
    def case(m, log):
        flat, deep = m.TierStats("flat"), m.TierStats("deep")
        for i in range(8):
            flat.add_op(4096, phase=0)
            deep.add_op(4096, phase=i)
        flat.end_batch()
        deep.end_batch()
        assert deep.model_time(m.NVME) > flat.model_time(m.NVME)
        assert deep.model_time(m.NVME) - flat.model_time(m.NVME) == \
            pytest.approx(7 * m.NVME.latency)
        log((flat.model_time(m.NVME), deep.model_time(m.NVME)))
    lockstep(case)


def test_workload_scan_fraction_none_and_bias_flip():
    def case(m, log):
        w = m.WorkloadStats()
        assert w.scan_fraction is None
        assert w.preferred_admission() == "always"
        w.note_batch("scan:c", prefetch=True, n_ops=4, nbytes=1100)
        w.note_batch("take:c", prefetch=False, n_ops=4, nbytes=999)
        assert w.scan_fraction == pytest.approx(1100 / 2099)
        assert w.preferred_admission() == "second_touch"
        w2 = m.WorkloadStats(scan_bias=0.5)
        w2.note_batch("scan:c", prefetch=True, n_ops=4, nbytes=1100)
        w2.note_batch("take:c", prefetch=False, n_ops=4, nbytes=999)
        assert w2.preferred_admission() == "always"
        log((w.scan_fraction, w.preferred_admission(),
             w2.scan_fraction, w2.preferred_admission()))
    lockstep(case)


# ---------------------------------------------------------------------------
# Attribution exactness
# ---------------------------------------------------------------------------


def test_attribution_sums_match_model_time_1e9():
    def case(m, log):
        fr, n = _mb_reader(m, store="tiered")
        rng = np.random.default_rng(3)
        for _ in range(6):
            fr.take("c", rng.integers(0, n, 64))
        fr.scan("c")
        att = m.attribute(fr.store, queue_depth=fr.scheduler.queue_depth)
        sums = att.tier_sums()
        checked = 0
        for name, mt in _tier_model_times(fr.store, fr.scheduler.queue_depth):
            if mt:
                assert abs(sums[name] - mt) / mt < 1e-9
                checked += 1
        assert checked >= 2
        assert att.total == pytest.approx(fr.modelled_time(), rel=1e-9)
        log((sums, att.total, fr.modelled_time()))
    lockstep(case)


def test_attribution_per_request_population():
    def case(m, log):
        fr, n = _mb_reader(m, store="tiered")
        rng = np.random.default_rng(4)
        for _ in range(5):
            fr.take("c", rng.integers(0, n, 32))
        att = m.attribute(fr.store, queue_depth=fr.scheduler.queue_depth)
        lats = att.per_request_latencies("take:c")
        assert len(lats) == 5 * 32
        assert all(x >= 0 for x in lats)
        pct = att.percentiles("take:c")
        assert pct["count"] == 160
        assert pct["p50"] <= pct["p99"] <= pct["p999"] <= pct["max"]
        assert att.percentiles("no-such-label") is None
        log((lats, pct))
    lockstep(case)


def test_attribution_drain_log_labels_and_requests():
    def case(m, log):
        fr, n = _mb_reader(m, store="tiered")
        fr.take("c", np.arange(10))
        fr.scan("c")
        dlog = fr.store.drain_log
        assert [r.label for r in dlog] == ["take:c", "scan:c"]
        assert isinstance(dlog[0], m.DrainRecord)
        assert dlog[0].n_requests == 10 and dlog[1].n_requests == 0
        for rec in dlog:
            for ops, nbytes in rec.tiers.values():
                assert set(ops) == set(nbytes)
                assert all(v > 0 for v in ops.values())
        log(dlog)
    lockstep(case)


# ---------------------------------------------------------------------------
# Tracer: zero-cost disabled, schema, bit-identity
# ---------------------------------------------------------------------------


def test_disabled_tracer_allocates_no_spans():
    def case(m, log):
        tr = m.NullTracer()
        s1 = tr.span("a", x=1)
        s2 = tr.span("b")
        assert s1 is m.NULL_SPAN and s2 is m.NULL_SPAN
        assert m.NULL_TRACER.span("c") is m.NULL_SPAN
        with s1 as sp:
            sp.set(ignored=True)
        tr.instant("i")
        tr.counter("c", {"v": 1})
        assert tr.events == []
        log((tr.enabled, tr.events))
    lockstep(case)


def test_traced_vs_untraced_bit_identical():
    def case(m, log):
        plain, n = _mb_reader(m, store="tiered")
        traced, _ = _mb_reader(m, store="tiered", tracer=m.Tracer())
        rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(4):
            plain.take("c", rng_a.integers(0, n, 48))
            traced.take("c", rng_b.integers(0, n, 48))
        plain.scan("c")
        traced.scan("c")
        sa, sb = plain.io_stats(), traced.io_stats()
        assert (sa.n_iops, sa.bytes_read) == (sb.n_iops, sb.bytes_read)
        assert plain.modelled_time() == traced.modelled_time()
        for ta, tb in zip(plain.tier_stats(), traced.tier_stats()):
            assert (ta.n_iops, ta.bytes_read, ta.hits, ta.misses) == \
                (tb.n_iops, tb.bytes_read, tb.hits, tb.misses)
        assert len(traced.tracer.events) > 0 and plain.tracer.events == []
        log((sa, plain.tier_stats(), plain.modelled_time()))
        log(trace_shape(traced.tracer.events))
    lockstep(case)


def test_trace_export_chrome_schema(tmp_path):
    def case(m, log):
        tr = m.Tracer()
        fr, n = _mb_reader(m, store="tiered", tracer=tr)
        fr.take("c", np.random.default_rng(1).integers(0, n, 32))
        doc = tr.trace_events()
        assert set(doc) == {"traceEvents", "displayTimeUnit"}
        assert doc["traceEvents"]
        for ev in doc["traceEvents"]:
            assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
            assert ev["ph"] in ("X", "i", "C", "M")
            if ev["ph"] == "X":
                assert ev["dur"] >= 0
            if ev["ph"] == "i":
                assert ev["s"] == "t"
        names = {e["name"] for e in doc["traceEvents"]}
        assert any(nm.startswith("take:") for nm in names)
        assert any(nm.startswith("drain:") for nm in names)
        out = tmp_path / f"{m.name}.json"
        n_events = tr.export(str(out))
        loaded = json.loads(out.read_text())
        assert len(loaded["traceEvents"]) == n_events
        log((doc["displayTimeUnit"], n_events,
             trace_shape(loaded["traceEvents"])))
    lockstep(case)


def test_trace_export_refuses_nan(tmp_path):
    def case(m, log):
        tr = m.Tracer()
        tr.instant("bad", value=float("nan"))
        with pytest.raises(ValueError):
            tr.export(str(tmp_path / f"{m.name}.json"))
        log(trace_shape(tr.events))
    lockstep(case)


def test_pallas_fallback_reason_event():
    def case(m, log):
        tr = m.Tracer()
        rng = np.random.default_rng(0)
        arr = m.A.PrimitiveArray.build(rng.standard_normal(512).astype(np.float32))
        fb = m.write_table({"c": arr}, m.WriteOptions("lance-miniblock"))
        fr = m.FileReader(fb, decode=m.route, tracer=tr)
        fr.take("c", rng.integers(0, 512, 16))
        evs = [e for e in tr.events if e["name"] == "pallas_fallback"]
        assert evs and evs[0]["args"]["reason"] == "float-values"
        assert tr.metrics.counter_values("decode.fallback") == \
            {"decode.fallback.miniblock.float-values": 1}
        log(trace_shape(tr.events))
    lockstep(case)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def test_percentile_nearest_rank():
    def case(m, log):
        xs = list(range(1, 101))
        assert m.percentile(xs, 50) == 50
        assert m.percentile(xs, 99) == 99
        assert m.percentile(xs, 99.9) == 100
        assert m.percentile(xs, 100) == 100
        assert m.percentile([7.0], 50) == 7.0
        with pytest.raises(ValueError):
            m.percentile([], 50)
        log([m.percentile(xs, q) for q in (0, 1, 25, 50, 99, 99.9, 100)])
    lockstep(case)


def test_metrics_registry_counters_and_histograms():
    def case(m, log):
        reg = m.MetricsRegistry()
        reg.counter("a.b").inc()
        reg.counter("a.b").inc(2)
        reg.counter("a.c").inc()
        assert reg.counter_values("a.") == {"a.b": 3, "a.c": 1}
        h = reg.histogram("lat")
        h.observe_many([1.0, 2.0, 3.0, 4.0])
        s = h.summary()
        assert s["count"] == 4 and s["mean"] == pytest.approx(2.5)
        assert s["p50"] == 2.0 and s["max"] == 4.0
        log((reg.counter_values(), s, m.prometheus_text(reg)))
        reg.reset()
        assert reg.counter_values() == {}
    lockstep(case)


# ---------------------------------------------------------------------------
# Attribution under a service window; per-request trace tracks
# ---------------------------------------------------------------------------


def test_attribution_exact_with_reads_and_flushes_in_flight():
    def case(m, log):
        rng = np.random.default_rng(6)
        arr = m.A.PrimitiveArray.build(
            rng.integers(0, 1 << 16, 4000).astype(np.int64))
        fb = m.write_table({"c": arr}, m.WriteOptions("lance-fullzip"))
        w = m.DatasetWriter(
            files=[fb],
            store=lambda d: m.TieredStore.cached(d, cache_bytes=16 * 4096),
            flush="write-back")
        with w.scheduler.service_window() as win:
            for i in range(4):
                with win.request(tenant="reader", at=i * 1e-4):
                    w.take("c", rng.integers(0, 4000, 64))
                with win.request(tenant="ingest", at=i * 1e-4):
                    w.append({"c": m.A.PrimitiveArray.build(
                        rng.integers(0, 100, 300).astype(np.int64))},
                        commit=(i % 2 == 1))
            res = win.run("interleaved")
        labels = {c.label for c in res.completions}
        assert any(lab.startswith("take:") for lab in labels)
        assert any(lab.startswith("flush:") for lab in labels)
        qd = w.scheduler.queue_depth
        att = m.attribute(w.store, queue_depth=qd)
        sums = att.tier_sums()
        checked = 0
        for name, mt in _tier_model_times(w.store, qd):
            if mt:
                assert abs(sums[name] - mt) / mt < 1e-9
                checked += 1
        assert checked >= 2
        log((res, sums, w.tier_stats()))
    lockstep(case)


def test_trace_per_request_tracks_for_concurrent_takers():
    def case(m, log):
        tr = m.Tracer()
        fr, n = _mb_reader(m, store="tiered", tracer=tr)
        with fr.scheduler.service_window() as win:
            with win.request(tenant="a", request="a/0"):
                fr.take("c", np.arange(40))
            with win.request(tenant="b", request="b/0"):
                fr.take("c", np.arange(40, 80))
        drains = [e for e in tr.events
                  if e["ph"] == "X" and e["name"].startswith("drain:")]
        assert len(drains) == 2
        assert drains[0]["tid"] != drains[1]["tid"]
        assert {d["args"]["request"] for d in drains} == {"a/0", "b/0"}
        meta = {e["tid"]: e["args"]["name"] for e in tr.events
                if e["ph"] == "M" and e["name"] == "thread_name"}
        for d in drains:
            assert meta[d["tid"]] == d["args"]["request"]
        children = [e for e in tr.events if e["ph"] == "X"
                    and e["name"].startswith(("coalesce", "dispatch:"))]
        assert children and all(e["tid"] in meta for e in children)
        tr2 = m.Tracer()
        fr2, _ = _mb_reader(m, store="tiered", tracer=tr2)
        fr2.take("c", np.arange(10))
        fr2.take("c", np.arange(10, 20))
        d2 = [e for e in tr2.events
              if e["ph"] == "X" and e["name"].startswith("drain:")]
        assert d2[0]["tid"] != d2[1]["tid"]
        log(trace_shape(tr.events))
        log(trace_shape(tr2.events))
    lockstep(case)


# ---------------------------------------------------------------------------
# tests/test_timeseries_properties.py: the log-bucket histogram's laws
# ---------------------------------------------------------------------------

values = st.floats(min_value=0.0, max_value=1e6, allow_nan=False,
                   allow_infinity=False)
value_lists = st.lists(values, min_size=0, max_size=200)
rel_errs = st.sampled_from([0.05, 0.01, 0.001])


def _fill(m, xs, rel_err):
    h = m.LogBucketHistogram(rel_err)
    for x in xs:
        h.observe(x)
    return h


def _same(a, b):
    return (a.buckets == b.buckets and a.zero_count == b.zero_count
            and a.count == b.count and a.min == b.min and a.max == b.max
            and abs(a.sum - b.sum) <= 1e-9 * max(abs(a.sum), abs(b.sum), 1.0))


def _hist_state(h):
    return (sorted(h.buckets.items()), h.zero_count, h.count, h.sum, h.min,
            h.max)


@settings(max_examples=100, deadline=None)
@given(xs=value_lists, ys=value_lists, rel_err=rel_errs)
def test_merge_commutes_and_equals_concatenation(xs, ys, rel_err):
    def case(m, log):
        ab = _fill(m, xs, rel_err).merge(_fill(m, ys, rel_err))
        ba = _fill(m, ys, rel_err).merge(_fill(m, xs, rel_err))
        cat = _fill(m, xs + ys, rel_err)
        assert _same(ab, ba)
        assert _same(ab, cat)
        log((_hist_state(ab), _hist_state(ba), _hist_state(cat)))
    lockstep(case)


@settings(max_examples=100, deadline=None)
@given(xs=value_lists, ys=value_lists, zs=value_lists, rel_err=rel_errs)
def test_merge_is_associative(xs, ys, zs, rel_err):
    def case(m, log):
        left = _fill(m, xs, rel_err).merge(_fill(m, ys, rel_err)) \
                                    .merge(_fill(m, zs, rel_err))
        right_inner = _fill(m, ys, rel_err).merge(_fill(m, zs, rel_err))
        right = _fill(m, xs, rel_err).merge(right_inner)
        assert _same(left, right)
        log((_hist_state(left), _hist_state(right)))
    lockstep(case)


@settings(max_examples=100, deadline=None)
@given(xs=st.lists(values, min_size=1, max_size=200),
       q=st.floats(min_value=0.0, max_value=100.0),
       rel_err=rel_errs)
def test_quantile_within_relative_error_of_nearest_rank(xs, q, rel_err):
    def case(m, log):
        h = _fill(m, xs, rel_err)
        exact = m.percentile(xs, q)
        approx = h.quantile(q)
        assert abs(approx - exact) <= rel_err * abs(exact) + 1e-9
        log((exact, approx))

    if 0 < q < 100 and math.ceil(q / 100.0 * len(xs)) == 0:
        # the rank underflows: the deliberate difference (module docstring);
        # the port alone holds the property, at the minimum
        log = []
        case(PORT, log.append)
        assert log[0][0] == min(xs)
    else:
        lockstep(case)


@settings(max_examples=100, deadline=None)
@given(obs=st.lists(st.tuples(st.floats(min_value=0.0, max_value=100.0,
                                        allow_nan=False),
                              values),
                    min_size=0, max_size=300),
       window=st.sampled_from([0.25, 1.0, 3.0]),
       n_windows=st.integers(min_value=1, max_value=8))
def test_window_rotation_never_loses_counts(obs, window, n_windows):
    def case(m, log):
        w = m.WindowedHistogram(window=window, n_windows=n_windows,
                                rel_err=0.01)
        for i, (t, v) in enumerate(obs):
            w.observe(t, v)
            live = w.live_count
            assert w.total.count == w.dropped + live == i + 1
            log((w.dropped, live))
        log(_hist_state(w.total))
    lockstep(case)


@settings(max_examples=50, deadline=None)
@given(obs=st.lists(st.tuples(st.floats(min_value=0.0, max_value=10.0,
                                        allow_nan=False),
                              values),
                    min_size=1, max_size=200))
def test_windowed_quantile_matches_merged_population(obs):
    def case(m, log):
        w = m.WindowedHistogram(window=1.0, n_windows=11, rel_err=0.01)
        for t, v in obs:
            w.observe(t, v)
        assert w.dropped == 0 and w.live_count == len(obs)
        xs = [v for _, v in obs]
        exact = m.percentile(xs, 99)
        assert abs(w.quantile(99) - exact) <= 0.01 * abs(exact) + 1e-9
        log((exact, w.quantile(99)))
    lockstep(case)


# ---------------------------------------------------------------------------
# the port's rank clamp (a deliberate difference from the reference)
# ---------------------------------------------------------------------------

_TINY_Q = 5e-324  # the smallest positive float: q / 100 * n underflows to 0


@pytest.mark.parametrize("xs", [[1.0], [3.0, 1.0, 2.0]])
def test_percentile_rank_clamp_returns_minimum(xs):
    assert math.ceil(_TINY_Q / 100.0 * len(xs)) == 0
    assert PORT.percentile(xs, _TINY_Q) == min(xs)
    # the reference takes rank 0 as xs[-1]: the maximum
    assert REF.percentile(xs, _TINY_Q) == max(xs)


@pytest.mark.parametrize("xs", [[1.0], [3.0, 1.0, 2.0]])
def test_log_bucket_quantile_rank_clamp_returns_minimum(xs):
    for rel_err in (0.05, 0.01, 0.001):
        got = _fill(PORT, xs, rel_err).quantile(_TINY_Q)
        assert abs(got - min(xs)) <= rel_err * min(xs)
        assert _fill(REF, xs, rel_err).quantile(_TINY_Q) == 0.0


def test_ivf_topk_fallback_reaches_the_tracer_and_the_global_count():
    """``ops.ivf_topk(..., tracer=)`` reports a counted fallback to the
    tracer under the reference's name and event, and still counts it in the
    process-wide ``ops.fallbacks`` that ``chip_smoke.py`` checks."""
    from repro.kernels import ops as r_ops
    from repro_torch.kernels import ops as p_ops

    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 8))                      # float64: ineligible
    c = rng.standard_normal((40, 8)).astype(np.float32)
    ids = np.arange(40, dtype=np.int32)
    traces, results = [], []
    for ivf, kw in ((r_ops.ivf_topk, {"use_pallas": True}),
                    (p_ops.ivf_topk, {"device": "cpu"})):
        tr = (REF if ivf is r_ops.ivf_topk else PORT).Tracer()
        d, w = ivf(q, c, ids, 5, tracer=tr, **kw)
        results.append((np.asarray(d).tolist(), np.asarray(w).tolist()))
        assert tr.metrics.counter_values("decode.fallback") == \
            {"decode.fallback.ivf.non-float32": 1}
        traces.append(trace_shape(tr.events))
    assert traces[0] == traces[1]
    assert results[0][1] == results[1][1]
    p_ops.reset_counts()
    p_ops.ivf_topk(q, c, ids, 5, device="cpu")           # no tracer attached
    assert p_ops.fallbacks == {"decode.fallback.ivf.non-float32": 1}
