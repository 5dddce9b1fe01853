"""The port's full store (cache tiers, readahead, admission, flush policies)
against the JAX package's, in lockstep on the CPU.

Each case is the body of a test of ``tests/test_store.py``,
``tests/test_ingest.py``, ``tests/test_dataset.py`` or
``tests/test_io_model.py``, written once over a namespace of one package's
classes.  It runs on the reference and on the port: its assertions must hold
on both, and the log of every counter, byte, tier snapshot, decoded value and
modelled time it records must be identical (tolerance 0).

The cases take the reference's own parameters and data: the Parquet and
Arrow encodings, each package's ``data.synth`` embeddings, the file-backed
``Disk``.  ``test_scheduler_trace_matches_legacy_tracker`` and
``test_dataset_take_matches_single_file`` also run on more Lance encodings
and shapes than the reference's.  One case differs:
``test_hbm_model_is_dma_shaped`` prices on the reference's ``HBM``, which
the port does not carry (a TPU's model); both packages price on a
``DeviceModel`` of each package built from the reference constant's fields.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

import repro.core.arrays as RA
import repro.core.io_sim as RIO
import repro.core.types as RT
import repro.data.synth as RSYNTH
import repro.dataset as RDS
import repro.store as RS
from repro.core.file import FileReader as RFileReader
from repro.core.file import WriteOptions as RWriteOptions
from repro.core.file import write_table as r_write_table
from repro.serve.engine import Retriever as RRetriever

import repro_torch.core.arrays as PA
import repro_torch.core.io_sim as PIO
import repro_torch.core.types as PT
import repro_torch.data.synth as PSYNTH
import repro_torch.dataset as PDS
import repro_torch.store as PS
from repro_torch.core.file import FileReader as PFileReader
from repro_torch.core.file import WriteOptions as PWriteOptions
from repro_torch.core.file import write_table as p_write_table
from repro_torch.serve import Retriever as PRetriever


def _namespace(A, T, io, store, ds, FileReader, write_table, WriteOptions,
               Retriever, synth, **port_kw):
    on = functools.partial
    return types.SimpleNamespace(
        A=A, T=T, synth=synth, Disk=io.Disk, DiskView=io.DiskView, IOTracker=io.IOTracker,
        IOStats=io.IOStats, DeviceModel=io.DeviceModel, NVME=io.NVME, S3=io.S3,
        model_time=io.model_time, BlockCache=store.BlockCache,
        FlushPolicy=store.FlushPolicy, IOScheduler=store.IOScheduler,
        SequentialReadahead=store.SequentialReadahead,
        SimulatedCrash=store.SimulatedCrash, TieredStore=store.TieredStore,
        WorkloadStats=store.WorkloadStats, make_store=store.make_store,
        FileReader=on(FileReader, **port_kw), write_table=write_table,
        WriteOptions=WriteOptions, DatasetReader=on(ds.DatasetReader, **port_kw),
        DatasetWriter=on(ds.DatasetWriter, **port_kw),
        write_fragments=ds.write_fragments, Manifest=ds.Manifest,
        Retriever=on(Retriever, **port_kw))


REF = _namespace(RA, RT, RIO, RS, RDS, RFileReader, r_write_table, RWriteOptions,
                 RRetriever, RSYNTH)
PORT = _namespace(PA, PT, PIO, PS, PDS, PFileReader, p_write_table, PWriteOptions,
                  PRetriever, PSYNTH, device="cpu")


def snap(x):
    """A comparable form of what a case logs: dataclasses (TierStats,
    IOStats) as tuples, numpy arrays as lists, recursively."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.astuple(x)
    if isinstance(x, (list, tuple)):
        return [snap(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def lockstep(case, *args):
    """Run ``case`` on the reference and on the port; their logs must be
    identical."""
    logs = []
    for m in (REF, PORT):
        log = []
        case(m, log.append, *args)
        logs.append([snap(v) for v in log])
    assert len(logs[0]) > 0
    assert logs[0] == logs[1]


def values(m, arr):
    return m.A.to_pylist(arr)


def _strings(m, n):
    return m.A.from_pylist([f"value-{i:06d}" * 3 for i in range(n)], m.T.Utf8(False))


def _ints(m, lo, n):
    return {"c": m.A.PrimitiveArray.build(np.arange(lo, lo + n, dtype=np.int64),
                                          nullable=False)}


def _mixed(m, lo, n):
    ints = m.A.PrimitiveArray.build(np.arange(lo, lo + n, dtype=np.int64),
                                    validity=(np.arange(lo, lo + n) % 7 != 0))
    strs = m.A.from_pylist([None if i % 5 == 0 else f"s{lo + i}" for i in range(n)],
                           m.T.Utf8(True))
    return {"i": ints, "s": strs}


def _ds_table(m, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    ints = m.A.PrimitiveArray.build(rng.integers(0, 1 << 20, n).astype(np.int64),
                                    validity=rng.random(n) > 0.05)
    strs = m.A.from_pylist([None if i % 17 == 0 else f"v{i}" * (i % 5 + 1)
                            for i in range(n)], m.T.Utf8(True))
    lists = m.A.from_pylist([None if i % 13 == 0 else list(range(i % 4)) for i in range(n)],
                            m.T.List(m.T.int64(), True))
    return {"i": ints, "s": strs, "l": lists}


def _messy_rows(n, seed=1):
    rng = np.random.default_rng(seed)
    half = n // 2
    return np.concatenate([rng.integers(0, n, 300),
                           [0, n - 1, half - 1, half, half + 1, half, 0, n - 1]])


# ---------------------------------------------------------------------------
# BlockCache
# ---------------------------------------------------------------------------


def test_cache_lru_hit_miss_evict():
    def case(m, log):
        c = m.BlockCache(3 * 4096, policy="lru")
        for b in (0, 1, 2):
            assert not c.lookup(b)
            c.admit(b)
        assert c.lookup(0) and c.lookup(1) and c.lookup(2)
        assert (c.hits, c.misses, c.evictions) == (3, 3, 0)
        c.lookup(0)
        assert not c.lookup(3)
        c.admit(3)
        assert c.evictions == 1
        assert 1 not in c and 0 in c and 2 in c and 3 in c
        log((c.hits, c.misses, c.evictions, c.resident_bytes, len(c)))
    lockstep(case)


def test_cache_clock_second_chance():
    def case(m, log):
        c = m.BlockCache(2 * 4096, policy="clock")
        c.admit(0)
        c.admit(1)
        c.lookup(0)
        c.admit(2)
        assert 0 in c and 2 in c and 1 not in c
        log((c.evictions, len(c), c.hits, c.misses))
    lockstep(case)


def test_cache_second_touch_admission():
    def case(m, log):
        c = m.BlockCache(4 * 4096, admission="second_touch")
        c.lookup(7)
        assert not c.admit(7)
        assert 7 not in c
        c.lookup(7)
        assert c.admit(7)
        log((7 in c, c.hits, c.misses, c.active_admission))
    lockstep(case)


def test_second_touch_holds_through_dispatch():
    def case(m, log):
        disk = m.Disk(np.zeros(64 * 4096, np.uint8))
        store = m.TieredStore.cached(disk, cache_bytes=16 * 4096, admission="second_touch")
        store.dispatch_extent(0, 4096, phase=0)
        assert len(store.levels[0].cache) == 0
        store.dispatch_extent(0, 4096, phase=0)
        assert len(store.levels[0].cache) == 1
        assert store.backing_stats.n_iops == 2
        store.dispatch_extent(0, 4096, phase=0)
        assert store.levels[0].cache.hits == 1
        store.dispatch_extent(8 * 4096, 9 * 4096, phase=0, prefetch=True)
        assert store.backing_stats.prefetch_iops == 0
        assert len(store.levels[0].cache) == 1
        log(store.tier_stats())
        log(store.model_time())
    lockstep(case)


def test_cache_rejects_bad_config():
    def case(m, log):
        for kw in ({"capacity_bytes": 100, "block_bytes": 4096},
                   {"capacity_bytes": 1 << 20, "policy": "marvellous"},
                   {"capacity_bytes": 1 << 20, "admission": "never"},
                   {"capacity_bytes": 1 << 20, "block_bytes": 0}):
            with pytest.raises(ValueError):
                m.BlockCache(**kw)
            log(sorted(kw))
    lockstep(case)


def test_cache_dirty_state_and_force_insert():
    def case(m, log):
        c = m.BlockCache(4 * 4096, admission="second_touch")
        c.mark_dirty(7)
        assert 7 in c and c.is_dirty(7)
        assert c.dirty_bytes == 4096 and c.dirty_blocks == [7]
        c.clean(7)
        assert not c.is_dirty(7) and 7 in c
        log((c.dirty_bytes, c.dirty_blocks, len(c)))
    lockstep(case)


def test_cache_invalidate_reuses_slot_without_eviction():
    def case(m, log):
        c = m.BlockCache(2 * 4096, policy="clock")
        c.admit(0)
        c.admit(1)
        assert c.invalidate(0) and 0 not in c and len(c) == 1
        assert not c.invalidate(0)
        c.admit(2)
        assert len(c) == 2 and c.evictions == 0
        lru = m.BlockCache(2 * 4096, policy="lru")
        lru.admit(5)
        assert lru.invalidate(5) and 5 not in lru and lru.evictions == 0
        log((len(c), c.evictions, len(lru), c.gauges(), lru.gauges()))
    lockstep(case)


# ---------------------------------------------------------------------------
# workload-driven admission ("auto") and its hysteresis
# ---------------------------------------------------------------------------


def test_workload_stats_mix_and_preference():
    def case(m, log):
        ws = m.WorkloadStats()
        assert ws.preferred_admission() == "always"
        assert ws.scan_fraction is None
        ws.note_batch("scan:c", prefetch=True, n_ops=4, nbytes=1 << 20)
        assert ws.preferred_admission() == "second_touch"
        assert ws.n_scan_batches == 1 and ws.scan_bytes == 1 << 20
        for _ in range(3):
            ws.note_batch("take:c", prefetch=False, n_ops=100, nbytes=1 << 19)
        assert ws.preferred_admission() == "always"
        assert 0.0 < ws.scan_fraction < 0.5
        log((ws.scan_fraction, ws.scan_ops, ws.take_ops, ws.take_bytes))
        ws.reset()
        assert ws.n_scan_batches == ws.n_take_batches == 0
    lockstep(case)


def test_admission_auto_flips_with_trace():
    def case(m, log):
        disk = m.Disk(np.zeros(1 << 22, np.uint8))
        store = m.TieredStore.cached(disk, admission="auto")
        cache = store.levels[0].cache
        sched = m.IOScheduler(store)
        assert cache.admission == "auto" and cache.active_admission == "always"
        with sched.batch("scan:c", prefetch=True) as io:
            io.read(0, 1 << 20)
        assert cache.active_admission == "second_touch"
        assert cache.admission_flips == 1 and len(cache) == 0
        log(store.tier_stats())
        for i in range(0, 3 << 20, 4096):
            with sched.batch("take:c") as io:
                io.read(i % (1 << 20), 4096)
        assert cache.active_admission == "always" and cache.admission_flips == 2
        log((cache.admission_flips, len(cache)))
        log(store.tier_stats())
        log(sched.model_time())
    lockstep(case)


def test_admission_pinned_policies_do_not_flip():
    def case(m, log):
        c = m.BlockCache(1 << 20, admission="second_touch")
        c.set_active_admission("always")
        assert c.active_admission == "second_touch"
        with pytest.raises(ValueError):
            c.set_active_admission("auto")
        log((c.active_admission, c.admission_flips))
    lockstep(case)


def test_admission_hysteresis_no_thrash_on_alternating_mix():
    def case(m, log):
        ws = m.WorkloadStats()
        ws.note_batch("scan:c", prefetch=True, n_ops=4, nbytes=150_000)
        assert ws.preferred_admission() == "second_touch"
        ws.note_batch("take:c", prefetch=False, n_ops=40, nbytes=145_000)
        assert ws.preferred_admission() == "second_touch"
        prefs, sign_changes = [], 0
        for i in range(20):
            if i % 2:
                ws.note_batch("scan:c", prefetch=True, n_ops=1, nbytes=10_000)
            else:
                ws.note_batch("take:c", prefetch=False, n_ops=10, nbytes=10_000)
            prefs.append(ws.preferred_admission())
            assert 1.0 / 1.1 <= ws.scan_bytes / ws.take_bytes <= 1.1
            if (ws.scan_bytes > ws.take_bytes) != (i % 2 == 0):
                sign_changes += 1
        assert sign_changes >= 8 and set(prefs) == {"second_touch"}
        ws.note_batch("take:c", prefetch=False, n_ops=100, nbytes=300_000)
        assert ws.preferred_admission() == "always"
        log((prefs, sign_changes, ws.scan_bytes, ws.take_bytes))
    lockstep(case)


def test_admission_hysteresis_zero_restores_majority_test():
    def case(m, log):
        ws = m.WorkloadStats(hysteresis=0.0)
        ws.note_batch("scan:c", prefetch=True, n_ops=1, nbytes=1001)
        ws.note_batch("take:c", prefetch=False, n_ops=1, nbytes=1000)
        assert ws.preferred_admission() == "second_touch"
        ws.note_batch("take:c", prefetch=False, n_ops=1, nbytes=2)
        assert ws.preferred_admission() == "always"
        with pytest.raises(ValueError):
            m.WorkloadStats(hysteresis=-0.1)
        log(ws.scan_fraction)
    lockstep(case)


# ---------------------------------------------------------------------------
# stores, specs, scheduler accounting
# ---------------------------------------------------------------------------


def test_make_store_specs():
    def case(m, log):
        disk = m.Disk(np.zeros(1 << 16, np.uint8))
        assert m.make_store(None, disk).backing is m.NVME
        assert m.make_store("flat-s3", disk).backing is m.S3
        auto = m.make_store("tiered-auto", disk)
        assert auto.levels[0].cache.admission == "auto"
        assert auto.levels[0].cache.active_admission == "always"
        ready = m.TieredStore.cached(disk, cache_bytes=8 * 4096)
        assert m.make_store(ready, disk) is ready
        built = m.make_store(lambda d: m.TieredStore.hot(d, ram_bytes=4 * 4096), disk)
        for spec in (None, "flat", "flat-s3", "tiered", "tiered-auto", "hot"):
            st = m.make_store(spec, disk)
            log((spec, st.backing.name, [(lvl.device.name, lvl.cache.capacity_blocks,
                                          lvl.cache.policy, lvl.cache.admission)
                                         for lvl in st.levels]))
        log([lvl.cache.capacity_blocks for lvl in built.levels])
        with pytest.raises(ValueError):
            m.make_store("warmish", disk)
        with pytest.raises(ValueError):
            m.make_store(m.TieredStore.flat(m.Disk(np.zeros(8, np.uint8))), disk)
        with pytest.raises(TypeError):
            m.make_store(lambda d: None, disk)
    lockstep(case)


def test_tiered_store_accepts_shared_cache():
    def case(m, log):
        disk = m.Disk(np.zeros(64 * 4096, np.uint8))
        cache = m.BlockCache(16 * 4096)
        s1 = m.TieredStore.cached(disk, cache=cache)
        s2 = m.TieredStore.cached(disk, cache=cache)
        assert s1.levels[0].cache is s2.levels[0].cache
        s1.dispatch_extent(0, 4096, phase=0)
        s2.dispatch_extent(0, 4096, phase=0)
        assert cache.hits == 1 and cache.misses == 1
        assert s2.backing_stats.n_iops == 0
        with pytest.raises(ValueError):
            m.TieredStore.cached(disk, sector=8192, cache=cache)
        log(s1.tier_stats())
        log(s2.tier_stats())
    lockstep(case)


def _legacy_data(m, kind):
    if kind == "strings":
        return _strings(m, 2000)
    return m.A.from_pylist([None if i % 9 == 0 else [f"s{i}"] * (i % 4) for i in range(2000)],
                           m.T.List(m.T.utf8()))


@pytest.mark.parametrize("enc,kind", [("lance-miniblock", "strings"),
                                      ("lance-fullzip", "strings"),
                                      ("parquet", "strings"),
                                      ("arrow", "strings"),
                                      ("lance", "strings"),
                                      ("lance-fullzip", "string-lists")])
def test_scheduler_trace_matches_legacy_tracker(enc, kind):
    def case(m, log):
        fb = m.write_table({"c": _legacy_data(m, kind)}, m.WriteOptions(enc))
        fr = m.FileReader(fb)
        fr.take("c", np.arange(0, 2000, 37))
        fr.scan("c")
        tr = m.IOTracker(fr.disk)
        for o, sz, p in fr.scheduler.ops:
            tr.read(o, sz, p)
        for gap in (0, 64, 4096):
            a, b = fr.io_stats(gap), tr.stats(gap)
            assert (a.n_iops, a.bytes_read, a.max_phase, a.n_coalesced) == \
                (b.n_iops, b.bytes_read, b.max_phase, b.n_coalesced)
            log(b)
        log(fr.tier_stats())
    lockstep(case)


def test_flat_dispatch_count_equals_coalesced():
    def case(m, log):
        arr = m.A.PrimitiveArray.build(np.arange(4000, dtype=np.int64), nullable=False)
        fr = m.FileReader(m.write_table({"c": arr}, m.WriteOptions("lance-fullzip")))
        fr.take("c", np.random.default_rng(0).choice(4000, 128, replace=False))
        st, backing = fr.io_stats(), fr.tier_stats()[-1]
        assert backing.n_iops == st.n_coalesced
        assert backing.bytes_read >= st.bytes_read and backing.max_phase == st.max_phase
        log(st)
        log(backing)
    lockstep(case)


def test_batch_rejects_use_after_close():
    def case(m, log):
        disk = m.Disk(np.zeros(1 << 16, np.uint8))
        sched = m.IOScheduler(m.TieredStore.flat(disk))
        with sched.batch("t") as io:
            io.read(0, 16)
        with pytest.raises(RuntimeError):
            io.read(0, 16)
        log(sched.stats())
    lockstep(case)


# ---------------------------------------------------------------------------
# tiered end to end
# ---------------------------------------------------------------------------


def test_tiered_take_cold_then_warm():
    def case(m, log):
        arr = _strings(m, 3000)
        fb = m.write_table({"c": arr}, m.WriteOptions("lance"))
        rows = np.random.default_rng(1).choice(3000, 200, replace=False)
        want = [values(m, arr)[i] for i in rows]
        cold = m.FileReader(fb, store="flat-s3")
        cold.take("c", rows)
        t_cold = cold.modelled_time()
        fr = m.FileReader(fb, store="tiered")
        assert values(m, fr.take("c", rows)) == want
        nvme, s3 = fr.tier_stats()
        assert s3.n_iops > 0 and nvme.misses > 0
        log(fr.tier_stats())
        fr.reset_io()
        assert values(m, fr.take("c", rows)) == want
        t_warm = fr.modelled_time()
        nvme, s3 = fr.tier_stats()
        assert s3.n_iops == 0 and nvme.hit_rate == 1.0 and t_warm < t_cold
        log((t_cold, t_warm, nvme.hit_rate))
        fr.drop_caches()
        fr.reset_io()
        fr.take("c", rows)
        assert fr.tier_stats()[1].n_iops > 0
        log(fr.tier_stats())
        log(fr.modelled_time())
    lockstep(case)


def test_tiered_eviction_under_pressure():
    def case(m, log):
        arr = m.A.PrimitiveArray.build(np.arange(200_000, dtype=np.int64), nullable=False)
        fb = m.write_table({"c": arr}, m.WriteOptions("lance-fullzip"))
        fr = m.FileReader(fb, store=lambda d: m.TieredStore.cached(d, cache_bytes=8 * 4096))
        fr.take("c", np.arange(0, 200_000, 997))
        assert fr.tier_stats()[0].evictions > 0
        assert len(fr.store.levels[0].cache) <= 8
        log(fr.tier_stats())
        log(fr.modelled_time())
    lockstep(case)


def test_hot_store_promotes_through_levels():
    def case(m, log):
        fr = m.FileReader(m.write_table({"c": _strings(m, 1000)}, m.WriteOptions("lance")),
                          store="hot")
        rows = np.arange(0, 1000, 13)
        fr.take("c", rows)
        log(fr.tier_stats())
        fr.reset_io()
        fr.take("c", rows)
        ram, nvme, s3 = fr.tier_stats()
        assert s3.n_iops == 0 and ram.hits > 0 and fr.modelled_time() < 1e-3
        log(fr.tier_stats())
        log(fr.modelled_time())
    lockstep(case)


def test_prefetch_on_full_scan():
    def case(m, log):
        arr = _strings(m, 20_000)
        fb = m.write_table({"c": arr}, m.WriteOptions("lance-miniblock"))
        fr = m.FileReader(fb, store="tiered")
        assert values(m, fr.scan("c", io_chunk=16 * 1024)) == values(m, arr)
        nvme, s3 = fr.tier_stats()
        assert s3.prefetch_iops > 0 and s3.prefetch_bytes > 0 and nvme.hits > 0
        no_ra = m.FileReader(fb, store="tiered", readahead=None)
        no_ra.scan("c", io_chunk=16 * 1024)
        s3_no_ra = no_ra.tier_stats()[1]
        assert s3_no_ra.prefetch_iops == 0 and s3_no_ra.hits == 0
        assert s3.bytes_read <= s3_no_ra.bytes_read + (1 << 20)
        log(fr.tier_stats())
        log(no_ra.tier_stats())
        log((fr.modelled_time(), no_ra.modelled_time()))
    lockstep(case)


def test_readahead_policy_unit():
    def case(m, log):
        ra = m.SequentialReadahead(window_bytes=1 << 16, min_run=2)
        assert ra.observe(0, 4096) is None
        assert ra.observe(4096, 8192) == (8192, 8192 + (1 << 16))
        assert ra.observe(8192, 12_288) == (8192 + (1 << 16), 12_288 + (1 << 16))
        log(ra.observe(12_288, 16_384))  # covered by the window: nothing new
        log(ra.observe(20_480, 24_576))  # a strided step of the same gap
        ra.reset()
        assert ra.observe(0, 4096) is None
        assert ra.observe(1 << 30, (1 << 30) + 4096) is None
        with pytest.raises(ValueError):
            m.SequentialReadahead(window_bytes=0)
    lockstep(case)


def test_sequential_batches_each_pay_round_trips():
    def case(m, log):
        arr = m.A.PrimitiveArray.build(np.arange(4000, dtype=np.int64), nullable=False)
        fr = m.FileReader(m.write_table({"c": arr}, m.WriteOptions("lance-fullzip")),
                          store="flat-s3")
        rows = np.arange(0, 4000, 31)
        fr.take("c", rows)
        t1 = fr.modelled_time()
        fr.take("c", rows)
        t2 = fr.modelled_time()
        assert t2 > 1.8 * t1
        log((t1, t2))
    lockstep(case)


def test_tier_stats_snapshots_survive_reset():
    def case(m, log):
        fr = m.FileReader(m.write_table({"c": _strings(m, 500)}, m.WriteOptions("lance")),
                          store="tiered")
        fr.take("c", np.arange(0, 500, 7))
        before = fr.tier_stats()
        saved = before[-1].n_iops
        assert saved > 0
        fr.reset_io()
        assert before[-1].n_iops == saved and fr.tier_stats()[-1].n_iops == 0
        log(before)
        log(fr.tier_stats())
    lockstep(case)


def test_retriever_tiered():
    def case(m, log):
        emb = m.synth.scenario("embeddings", 1500)
        r = m.Retriever(m.write_table({"embedding": emb}, m.WriteOptions("lance")),
                        "embedding", store="tiered")
        ids = np.array([5, 900, 1400])
        r.fetch(ids)
        cold = r.modelled_time()
        out, st = r.fetch(ids)
        assert st.n_iops == len(ids) and r.modelled_time() < cold
        assert r.tier_stats()[1].n_iops == 0
        assert values(m, out) == [values(m, emb)[i] for i in ids]
        log((cold, r.modelled_time()))
        log(st)
        log(r.tier_stats())
    lockstep(case)


# ---------------------------------------------------------------------------
# write path: dirty blocks, flush policies, durability accounting
# ---------------------------------------------------------------------------


def _wb_store(m, disk, mode="write-back", cache_blocks=16, **kw):
    store = m.TieredStore.cached(disk, cache_bytes=cache_blocks * 4096)
    store.set_flush_policy(m.FlushPolicy(mode, **kw))
    return store


def test_write_back_dirty_accounting_invariants():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)))
        sched = m.IOScheduler(store)
        with sched.write_batch("append:0") as wb:
            wb.write(0, b"x" * 10_000)
        nvme, s3 = store.tier_stats()
        assert nvme.write_iops == 1 and nvme.bytes_written == 3 * 4096
        assert nvme.dirty_bytes == 3 * 4096 and s3.write_iops == 0
        assert store.dirty_extents() == [(0, 3 * 4096)]
        log(store.tier_stats())
        assert store.flush_all() == 3
        nvme, s3 = store.tier_stats()
        assert nvme.dirty_bytes == 0 and s3.write_iops == 1 and s3.flush_iops == 1
        assert s3.bytes_written == s3.flush_bytes == 3 * 4096
        assert sched.write_stats().n_iops == 1 and sched.write_stats().bytes_read == 10_000
        log(store.tier_stats())
        log(sched.write_stats())
        log(sched.model_time())
        log([(d.label, d.n_requests, d.tiers) for d in store.drain_log])
    lockstep(case)


def test_write_through_is_immediately_durable():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)), mode="write-through")
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(4096, b"y" * 4096)
        nvme, s3 = store.tier_stats()
        assert s3.write_iops == 1 and s3.flush_iops == 0
        assert nvme.dirty_bytes == 0 and store.dirty_extents() == []
        with sched.batch("take:c") as io:
            io.read(4096, 100)
        assert store.levels[0].cache.hits == 1 and store.tier_stats()[1].n_iops == 0
        log(store.tier_stats())
        log(sched.model_time())
    lockstep(case)


def test_write_through_fill_bypasses_admission_filter():
    def case(m, log):
        disk = m.Disk(np.zeros(64 * 4096, np.uint8))
        store = m.TieredStore.cached(disk, admission="second_touch")
        store.set_flush_policy(m.FlushPolicy("write-through"))
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(0, b"w" * 4096)
        assert 0 in store.levels[0].cache
        with sched.batch("take:c") as io:
            io.read(0, 100)
        assert store.levels[0].cache.hits == 1 and store.tier_stats()[1].n_iops == 0
        log(store.tier_stats())
    lockstep(case)


def test_unattached_store_defaults_to_write_through():
    def case(m, log):
        store = m.TieredStore.cached(m.Disk(np.zeros(16 * 4096, np.uint8)))
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(0, b"z" * 4096)
        assert store.tier_stats()[1].write_iops == 1 and store.dirty_extents() == []
        log(store.tier_stats())
    lockstep(case)


def test_flush_on_evict_writes_back_dirty_victim():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)), mode="flush-on-evict",
                          cache_blocks=2)
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(0, b"a" * (3 * 4096))
        nvme, s3 = store.tier_stats()
        assert s3.flush_iops == 1 and nvme.dirty_bytes == 2 * 4096 and nvme.evictions == 1
        log(store.tier_stats())
        log(store.flush_policy.n_flush_events)
    lockstep(case)


def test_write_back_high_watermark_flushes_down():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(256 * 4096, np.uint8)), cache_blocks=16,
                          high_watermark=0.5, low_watermark=0.25, deadline_batches=1000)
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(0, b"b" * (10 * 4096))
        assert store.levels[0].cache.dirty_bytes <= int(0.25 * 16 * 4096) + 4096
        assert store.tier_stats()[1].flush_iops >= 1
        assert store.flush_policy.n_flush_events >= 1
        log(store.tier_stats())
        log((store.flush_policy.n_flush_events, store.dirty_extents()))
    lockstep(case)


def test_write_back_deadline_flushes_aged_blocks():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)), deadline_batches=2)
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(0, b"c" * 4096)
        assert store.levels[0].cache.dirty_bytes == 4096
        with sched.batch("take:c") as io:
            io.read(8 * 4096, 64)
        assert store.tier_stats()[1].flush_iops == 1
        assert store.levels[0].cache.dirty_bytes == 0
        log(store.tier_stats())
        log([d.label for d in store.drain_log])
    lockstep(case)


def test_discard_dirty_counts_lost_bytes():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)))
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(0, b"d" * (2 * 4096))
            wb.write(8 * 4096, b"d" * 4096)
        lost = store.discard_dirty()
        assert lost == [(0, 2 * 4096), (8 * 4096, 9 * 4096)]
        nvme, s3 = store.tier_stats()
        assert nvme.lost_bytes == 3 * 4096 and nvme.dirty_bytes == 0 and s3.write_iops == 0
        assert len(store.levels[0].cache) == 0
        log(lost)
        log(store.tier_stats())
    lockstep(case)


def test_flush_fault_injection_is_a_clean_prefix():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)))
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(0, b"e" * 4096)
            wb.write(8 * 4096, b"e" * 4096)
        store.flush_policy.fail_after = 1
        with pytest.raises(m.SimulatedCrash):
            store.flush_all()
        store.flush_policy.fail_after = None
        cache = store.levels[0].cache
        assert not cache.is_dirty(0) and cache.is_dirty(8)
        assert store.tier_stats()[1].flush_iops == 1
        log(store.tier_stats())
        log(store.dirty_extents())
    lockstep(case)


def test_model_time_prices_writes():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)))
        sched = m.IOScheduler(store)
        t0 = sched.model_time()
        with sched.write_batch() as wb:
            wb.write(0, b"f" * (4 * 4096))
        t_dirty = sched.model_time()
        assert t_dirty > t0
        store.flush_all()
        assert sched.model_time() > t_dirty + 0.9 * m.S3.latency
        log((t0, t_dirty, sched.model_time()))
    lockstep(case)


def test_write_batch_rejects_use_after_close():
    def case(m, log):
        sched = m.IOScheduler(m.TieredStore.flat(m.Disk(np.zeros(16 * 4096, np.uint8))))
        with sched.write_batch() as wb:
            wb.write(0, b"g" * 16)
        with pytest.raises(RuntimeError):
            wb.write(0, b"g")
        assert sched.n_write_batches == 1
        assert sched.stats().n_iops == 0 and sched.write_stats().n_iops == 1
        log(sched.write_stats())
    lockstep(case)


def test_flush_policy_validation():
    def case(m, log):
        for kw in ({"mode": "write-sideways"}, {"high_watermark": 0.0},
                   {"low_watermark": 0.9, "high_watermark": 0.5},
                   {"deadline_batches": 0}):
            with pytest.raises(ValueError):
                m.FlushPolicy(**kw)
            log(sorted(kw))
        p = m.FlushPolicy()
        log((p.mode, p.high_watermark, p.low_watermark, p.deadline_batches))
    lockstep(case)


def test_disk_write_grow_zero():
    def case(m, log):
        disk = m.Disk(np.zeros(8, np.uint8))
        disk.write(2, b"\x05\x06")
        assert disk.read(0, 5).tolist() == [0, 0, 5, 6, 0]
        assert disk.grow(8) == 16
        assert disk.read(2, 2).tolist() == [5, 6]
        disk.zero(2, 4)
        assert disk.read(2, 2).tolist() == [0, 0]
        with pytest.raises(ValueError):
            disk.write(15, b"ab")
        with pytest.raises(ValueError):
            disk.grow(-1)
        log(disk.read(0, 16))
    lockstep(case)


def test_rmw_sub_sector_write_charges_backing_read():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)), mode="write-through")
        sched = m.IOScheduler(store)
        with sched.write_batch("append:0") as wb:
            wb.write(100, b"z" * 1000)
        nvme, s3 = store.tier_stats()
        assert s3.rmw_iops == 1 and s3.rmw_bytes == 4096 and s3.n_iops == 1
        assert s3.write_iops == 1 and sched.write_stats().n_iops == 1
        assert sched.write_stats().bytes_read == 1000 and sched.stats().n_iops == 0
        with sched.write_batch("append:1") as wb:
            wb.write(1100, b"z" * 500)
        assert store.tier_stats()[1].rmw_iops == 1
        log(store.tier_stats())
        log(sched.model_time())
    lockstep(case)


def test_rmw_aligned_and_eof_writes_are_free():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)), mode="write-through")
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(4096, b"a" * 8192)
        assert store.tier_stats()[1].rmw_iops == 0
        with sched.write_batch() as wb:
            wb.write(64 * 4096 - 1000, b"b" * 1000)
        s3 = store.tier_stats()[1]
        assert s3.rmw_iops == 1 and s3.rmw_bytes == 4096
        log(store.tier_stats())
    lockstep(case)


def test_rmw_write_back_flush_path():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(64 * 4096, np.uint8)))
        sched = m.IOScheduler(store)
        with sched.write_batch("append:0") as wb:
            wb.write(100, b"z" * 1000)
        nvme, s3 = store.tier_stats()
        assert s3.rmw_iops == 1 and nvme.dirty_bytes == 4096
        with sched.write_batch("append:1") as wb:
            wb.write(1100, b"z" * 500)
        assert store.tier_stats()[1].rmw_iops == 1
        store.flush_all()
        s3 = store.tier_stats()[1]
        assert s3.rmw_iops == 1 and s3.flush_iops == 1
        log(store.tier_stats())
    lockstep(case)


def test_rmw_counters_survive_snapshot_and_reset():
    def case(m, log):
        store = _wb_store(m, m.Disk(np.zeros(16 * 4096, np.uint8)), mode="write-through")
        sched = m.IOScheduler(store)
        with sched.write_batch() as wb:
            wb.write(50, b"q" * 100)
        snap_ = store.tier_stats()[1]
        assert snap_.rmw_iops == 1 and snap_.rmw_bytes == 4096
        store.reset_stats()
        live = store.backing_stats
        assert live.rmw_iops == 0 and live.rmw_bytes == 0 and snap_.rmw_iops == 1
        log(snap_)
        log(store.tier_stats())
    lockstep(case)


# ---------------------------------------------------------------------------
# ingest: versions, crash consistency, compaction, write-back vs write-through
# ---------------------------------------------------------------------------


def test_append_then_read_every_version():
    def case(m, log):
        w = m.DatasetWriter(opts=m.WriteOptions("lance"))
        sizes = [50, 80, 30, 120]
        for k, n in enumerate(sizes):
            assert w.append(_ints(m, sum(sizes[:k]), n)).version == k + 1
        for v in range(1, len(sizes) + 1):
            r = w.reader(v)
            want = sum(sizes[:v])
            assert r.n_rows == want
            assert values(m, r.scan("c")) == list(range(want))
            rows = np.array([0, want - 1, want // 2, 0])
            assert values(m, r.take("c", rows)) == rows.tolist()
            log(w.tier_stats())
        with pytest.raises(IndexError):
            w.reader(1).take("c", np.array([sizes[0]]))
        log((w.io_stats(), w.write_stats(), w.modelled_time(), w.dirty_bytes))
    lockstep(case)


def test_append_matches_single_file_reader():
    def case(m, log):
        w = m.DatasetWriter(opts=m.WriteOptions("lance"))
        n = 600
        for lo in range(0, n, 200):
            w.append(_mixed(m, lo, 200))
        single = m.FileReader(m.write_table(_mixed(m, 0, n), m.WriteOptions("lance")))
        rng = np.random.default_rng(0)
        rows = np.concatenate([rng.integers(0, n, 100), [0, n - 1, 199, 200, 201, 0]])
        for col in ("i", "s"):
            got = values(m, w.take(col, rows))
            assert got == values(m, single.take(col, rows))
            log(got)
        log(w.tier_stats())
    lockstep(case)


def test_writer_seeds_from_existing_files():
    def case(m, log):
        files = m.write_fragments(_ints(m, 0, 300), 3, m.WriteOptions("lance"))
        w = m.DatasetWriter(files=files)
        assert w.version == 1 and w.n_rows == 300
        assert values(m, w.take("c", np.array([0, 150, 299]))) == [0, 150, 299]
        ds = m.DatasetReader(files)
        assert values(m, ds.scan("c")) == values(m, w.scan("c"))
        log(w.tier_stats())
        log(w.write_stats())
    lockstep(case)


def test_append_rejects_schema_mismatch():
    def case(m, log):
        w = m.DatasetWriter()
        w.append(_ints(m, 0, 10))
        with pytest.raises(ValueError):
            w.append({"other": m.A.PrimitiveArray.build(np.arange(5, dtype=np.int64),
                                                        nullable=False)})
        with pytest.raises(ValueError):
            w.reader(2)
        with pytest.raises(ValueError):
            m.DatasetWriter().reader()
        log(w.tier_stats())
    lockstep(case)


def test_uncommitted_rows_are_invisible():
    def case(m, log):
        w = m.DatasetWriter()
        w.append(_ints(m, 0, 40))
        w.append(_ints(m, 40, 40), commit=False)
        assert w.n_rows == 40 and w.version == 1 and w.dirty_bytes > 0
        with pytest.raises(IndexError):
            w.take("c", np.array([40]))
        log(w.tier_stats())
        assert w.commit().version == 2 and w.n_rows == 80 and w.dirty_bytes == 0
        assert values(m, w.take("c", np.array([79]))) == [79]
        assert w.commit().version == 2
        log(w.tier_stats())
    lockstep(case)


def test_crash_discards_pending_keeps_committed():
    def case(m, log):
        w = m.DatasetWriter(flush="write-back")
        w.append(_ints(m, 0, 100))
        w.append(_ints(m, 100, 60), commit=False)
        assert w.dirty_bytes > 0
        torn = w.simulate_crash()
        assert torn > 0 and w.version == 1 and w.n_rows == 100
        assert values(m, w.scan("c")) == list(range(100))
        assert w.tier_stats()[0].lost_bytes > 0
        log(torn)
        log(w.tier_stats())
        w.append(_ints(m, 100, 50))
        assert w.n_rows == 150 and w.version == 2
        assert values(m, w.take("c", np.array([149, 0]))) == [149, 0]
        log(w.tier_stats())
    lockstep(case)


def test_crash_before_first_commit_leaves_empty_dataset():
    def case(m, log):
        w = m.DatasetWriter(flush="write-back")
        w.append(_ints(m, 0, 30), commit=False)
        log(w.simulate_crash())
        assert w.version == 0 and w.n_rows == 0
        with pytest.raises(ValueError):
            w.reader()
        w.append(_ints(m, 0, 10))
        assert w.n_rows == 10
        log(w.tier_stats())
    lockstep(case)


def test_interrupted_flush_never_corrupts_committed_version():
    def case(m, log):
        w = m.DatasetWriter(flush=m.FlushPolicy("flush-on-evict"))
        w.append(_ints(m, 0, 200))
        w.append(_ints(m, 200, 200), commit=False)
        w.flush_policy.fail_after = 0
        with pytest.raises(m.SimulatedCrash):
            w.commit()
        w.flush_policy.fail_after = None
        log(w.tier_stats())
        log(w.simulate_crash())
        assert w.version == 1
        assert values(m, w.scan("c")) == list(range(200))
        assert values(m, w.reader(1).take("c", np.array([199, 0]))) == [199, 0]
        log(w.tier_stats())
    lockstep(case)


def test_commit_fence_makes_bytes_durable_before_manifest():
    def case(m, log):
        w = m.DatasetWriter(flush="write-back")
        for lo in range(0, 300, 100):
            w.append(_ints(m, lo, 100))
            assert w.dirty_bytes == 0 and w.simulate_crash() == 0
            assert w.n_rows == lo + 100
            log(w.tier_stats())
    lockstep(case)


def test_compact_merges_small_fragments():
    def case(m, log):
        w = m.DatasetWriter(opts=m.WriteOptions("lance"))
        for lo in range(0, 500, 50):
            w.append(_mixed(m, lo, 50))
        v_before = w.version
        before_i = values(m, w.scan("i"))
        log(w.tier_stats())
        c = w.compact(max_rows=250)
        assert c.version == v_before + 1 and len(c.fragments) == 2 and c.n_rows == 500
        log(w.tier_stats())
        assert values(m, w.scan("i")) == before_i
        rows = np.random.default_rng(1).integers(0, 500, 64)
        assert values(m, w.take("s", rows)) == [values(m, _mixed(m, 0, 500)["s"])[i]
                                                for i in rows]
        assert w.reader(3).n_rows == 150
        assert values(m, w.reader(3).scan("i")) == before_i[:150]
        assert w.compact(max_rows=100).version == c.version
        log(w.tier_stats())
        log(w.modelled_time())
    lockstep(case)


def test_compact_requires_rows_and_commits_pending():
    def case(m, log):
        w = m.DatasetWriter()
        with pytest.raises(ValueError):
            w.compact(0)
        with pytest.raises(ValueError):
            w.compact(10)
        w.append(_ints(m, 0, 20), commit=False)
        w.append(_ints(m, 20, 20), commit=False)
        c = w.compact(max_rows=100)
        assert w.n_rows == 40 and len(c.fragments) == 1
        assert values(m, w.scan("c")) == list(range(40))
        log(w.tier_stats())
    lockstep(case)


def test_write_back_batches_backing_writes():
    def case(m, log):
        def ingest(policy):
            w = m.DatasetWriter(store=lambda d: m.TieredStore.cached(d, cache_bytes=8 << 20),
                                flush=policy)
            for i in range(6):
                w.append(_ints(m, i * 50, 50), commit=(i % 3 == 2))
            return w

        wt, wb = ingest("write-through"), ingest("write-back")
        assert wt.n_rows == wb.n_rows == 300
        s3_wt = {s.name: s for s in wt.tier_stats()}["s3"]
        s3_wb = {s.name: s for s in wb.tier_stats()}["s3"]
        assert s3_wb.write_iops < s3_wt.write_iops
        assert s3_wb.flush_iops == s3_wb.write_iops and s3_wt.flush_iops == 0
        assert values(m, wt.scan("c")) == values(m, wb.scan("c"))
        log(wt.tier_stats())
        log(wb.tier_stats())
        log((wt.modelled_time(), wb.modelled_time()))
    lockstep(case)


def test_ingested_rows_are_nvme_warm():
    def case(m, log):
        for policy in ("write-through", "write-back"):
            w = m.DatasetWriter(flush=policy)
            w.append(_ints(m, 0, 400))
            w.reset_io()
            w.take("c", np.arange(0, 400, 7))
            tiers = {s.name: s for s in w.tier_stats()}
            assert tiers["s3"].n_iops == 0
            assert tiers["nvme_970evo"].hit_rate == 1.0
            log(w.tier_stats())
    lockstep(case)


# ---------------------------------------------------------------------------
# dataset: one shared cache across fragments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc", ["lance-miniblock", "lance-fullzip", "parquet", "arrow",
                                 "lance", "lance-numpy"])
def test_dataset_take_matches_single_file(enc):
    def case(m, log):
        table, n = _ds_table(m), 2000
        if enc == "lance-numpy":
            opts = m.WriteOptions("lance", decode="numpy")
        elif enc in ("parquet", "arrow"):
            opts = m.WriteOptions(enc)
        else:
            opts = m.WriteOptions(enc, decode="pallas" if m is REF else "device")
        files = m.write_fragments(table, 4, opts)
        ds = m.DatasetReader(files, store="tiered")
        single = m.FileReader(m.write_table(table, opts))
        rows = _messy_rows(n)
        for col in table:
            got = values(m, ds.take(col, rows))
            assert got == values(m, single.take(col, rows))
            assert values(m, ds.scan(col)) == values(m, table[col])
            log(got)
            log(ds.tier_stats())
        log(ds.modelled_time())
    lockstep(case)


def test_dataset_take_is_one_dispatch_per_phase():
    def case(m, log):
        arr = m.A.PrimitiveArray.build(np.arange(4000, dtype=np.int64), nullable=False)
        ds = m.DatasetReader(m.write_fragments({"c": arr}, 2, m.WriteOptions("lance-fullzip")),
                             store="tiered")
        rows = np.array([1, 3999, 2001, 7, 1999, 2000])
        assert values(m, ds.take("c", rows)) == rows.tolist()
        assert ds.scheduler.n_batches == 1
        backing = ds.store.backing_stats
        assert len(backing.batch_phases) == 1 and list(backing.batch_phases[0]) == [0]
        log(ds.tier_stats())
    lockstep(case)


def test_cross_file_coalescing_reduces_backing_iops():
    def case(m, log):
        arr = m.A.PrimitiveArray.build(np.arange(200, dtype=np.int64), nullable=False)
        files = m.write_fragments({"c": arr}, 2, m.WriteOptions("lance-fullzip"))
        assert sum(len(f) for f in files) <= 4096
        ds = m.DatasetReader(files, store="tiered")
        ds.take("c", np.array([99, 100, 5, 199]))
        shared_s3 = ds.tier_stats()[-1].n_iops
        per_file = [m.FileReader(fb, store="tiered") for fb in files]
        per_file[0].take("c", np.array([99, 5]))
        per_file[1].take("c", np.array([0, 99]))
        split_s3 = sum(fr.tier_stats()[-1].n_iops for fr in per_file)
        assert shared_s3 < split_s3 and shared_s3 == 1
        log((shared_s3, split_s3))
        log(ds.tier_stats())
    lockstep(case)


def test_shared_cache_second_reader_hits_warm_blocks():
    def case(m, log):
        arr = m.A.PrimitiveArray.build(np.arange(5000, dtype=np.int64), nullable=False)
        disk = m.Disk.from_bytes(m.write_table({"c": arr}, m.WriteOptions("lance-fullzip")))
        store = m.TieredStore.cached(disk)
        fr1 = m.FileReader(disk, store=store)
        fr2 = m.FileReader(disk, store=store)
        rows = np.arange(0, 5000, 11)
        fr1.take("c", rows)
        s3_after_warm = store.backing_stats.n_iops
        hits_before = store.levels[0].cache.hits
        assert s3_after_warm > 0
        fr2.take("c", rows)
        assert store.levels[0].cache.hits > hits_before
        assert store.backing_stats.n_iops == s3_after_warm
        log(store.tier_stats())
    lockstep(case)


def test_dataset_second_pass_warm():
    def case(m, log):
        ds = m.DatasetReader(m.write_fragments(_ds_table(m, 1600), 4, m.WriteOptions("lance")),
                             store="tiered")
        rows = _messy_rows(1600)
        ds.take("i", rows)
        t_cold = ds.modelled_time()
        log(ds.tier_stats())
        ds.reset_io()
        ds.take("i", rows)
        nvme, s3 = ds.tier_stats()
        assert s3.n_iops == 0 and nvme.hit_rate == 1.0 and ds.modelled_time() < t_cold
        log((t_cold, ds.modelled_time()))
    lockstep(case)


def test_dataset_scan_readahead_crosses_fragments():
    def case(m, log):
        table = {"s": m.A.from_pylist([f"value-{i:06d}" * 3 for i in range(8000)],
                                      m.T.Utf8(False))}
        ds = m.DatasetReader(m.write_fragments(table, 2, m.WriteOptions("lance-miniblock")),
                             store="tiered")
        assert values(m, ds.scan("s", io_chunk=16 * 1024)) == values(m, table["s"])
        assert ds.scheduler.n_batches == 1
        nvme, s3 = ds.tier_stats()
        assert s3.prefetch_iops > 0 and nvme.hits > 0
        assert ds.scheduler.readahead._ra_until > ds.manifest.fragments[1].base
        log(ds.tier_stats())
        log(ds.scheduler.readahead._ra_until)
        w = ds.workload_stats()
        log((w.n_scan_batches, w.scan_bytes, w.preferred_admission()))
    lockstep(case)


def test_file_reader_injection_validation():
    def case(m, log):
        fb = m.write_table({"c": m.A.PrimitiveArray.build(np.arange(10, dtype=np.int64),
                                                          nullable=False)})
        with pytest.raises(ValueError):
            m.FileReader(fb, base=8)
        ds = m.DatasetReader([fb], store="tiered")
        with pytest.raises(ValueError):
            m.FileReader(fb, store="tiered", scheduler=ds.scheduler)
        with pytest.raises(ValueError):
            m.FileReader(fb, scheduler=ds.scheduler, readahead=None)
        with pytest.raises(ValueError):
            m.FileReader(fb, scheduler=ds.scheduler, base=1 << 30)
        log(ds.n_rows)
    lockstep(case)


def test_retriever_over_dataset():
    def case(m, log):
        emb = m.synth.scenario("embeddings", 900)
        r = m.Retriever(m.write_fragments({"embedding": emb}, 3, m.WriteOptions("lance")),
                        "embedding", store="tiered")
        ids = np.array([5, 299, 300, 899, 450])
        out, st = r.fetch(ids)
        assert values(m, out) == [values(m, emb)[i] for i in ids]
        assert st.n_iops == len(ids)
        cold = r.modelled_time()
        r.fetch(ids)
        assert r.modelled_time() < cold and r.tier_stats()[-1].n_iops == 0
        log((cold, r.modelled_time()))
        log(r.tier_stats())
    lockstep(case)


# ---------------------------------------------------------------------------
# device models and the legacy tracker
# ---------------------------------------------------------------------------


def test_device_model_shapes():
    def case(m, log):
        small = m.IOStats(n_iops=1000, bytes_read=1000 * 4096, useful_bytes=1000 * 4096,
                          max_phase=1)
        big = m.IOStats(n_iops=1000, bytes_read=1000 * (1 << 20),
                        useful_bytes=1000 * (1 << 20), max_phase=1)
        assert m.model_time(small, m.NVME) < m.model_time(small, m.S3) / 50
        assert m.model_time(big, m.S3) / m.model_time(big, m.NVME) < 5
        log([m.model_time(s, d) for s in (small, big) for d in (m.NVME, m.S3)])
    lockstep(case)


def test_phases_hurt_more_on_s3():
    def case(m, log):
        arr = m.A.from_pylist([["ab", None, "cd"], None, ["xyz"], []] * 100,
                              m.T.List(m.T.utf8()))
        rows = np.arange(0, 400, 13)

        def stats_for(opts):
            fr = m.FileReader(m.write_table({"c": arr}, opts))
            fr.reset_io()
            fr.take("c", rows)
            return fr.io_stats()

        deep = stats_for(m.WriteOptions("arrow"))
        shallow = stats_for(m.WriteOptions("lance-fullzip"))
        assert deep.max_phase > shallow.max_phase
        nvme_extra = m.model_time(deep, m.NVME) - m.model_time(shallow, m.NVME)
        s3_extra = m.model_time(deep, m.S3) - m.model_time(shallow, m.S3)
        assert s3_extra > 100 * max(nvme_extra, 1e-9) and s3_extra > 0
        log((deep, shallow, nvme_extra, s3_extra))
    lockstep(case)


def test_hbm_model_is_dma_shaped():
    def case(m, log):
        h = RIO.HBM
        hbm = m.DeviceModel(h.name, h.iops_4k, h.seq_bw, h.latency, h.min_read)
        tiny = m.IOStats(n_iops=10_000, bytes_read=10_000 * 8, useful_bytes=10_000 * 8,
                         max_phase=1)
        padded = m.IOStats(n_iops=10_000, bytes_read=10_000 * 512,
                           useful_bytes=10_000 * 512, max_phase=1)
        t, p = m.model_time(tiny, hbm), m.model_time(padded, hbm)
        assert abs(t - p) / p < 0.01
        log((t, p))
    lockstep(case)


def test_coalescing_counter():
    def case(m, log):
        tr = m.IOTracker(m.Disk(np.zeros(10_000, np.uint8)))
        tr.read(0, 100)
        tr.read(50, 100)
        tr.read(500, 100)
        st = tr.stats()
        assert st.n_iops == 3 and st.n_coalesced == 2
        log(st)
    lockstep(case)


def test_coalescing_is_per_phase():
    def case(m, log):
        tr = m.IOTracker(m.Disk(np.zeros(10_000, np.uint8)))
        tr.read(0, 100, phase=0)
        tr.read(100, 100, phase=1)
        st = tr.stats()
        assert st.n_coalesced == 2 and st.max_phase == 2
        log(st)
        tr.reset()
        tr.read(0, 100, phase=1)
        tr.read(100, 100, phase=1)
        assert tr.stats().n_coalesced == 1
        log(tr.stats())
    lockstep(case)


def test_empty_trace_stats():
    def case(m, log):
        st = m.IOTracker(m.Disk(np.zeros(10, np.uint8))).stats()
        assert st.n_iops == 0 and st.n_coalesced == 0 and st.max_phase == 0
        assert np.isnan(st.read_amplification)
        log((st.n_iops, st.bytes_read, st.max_phase, st.n_coalesced))
    lockstep(case)


def test_disk_read_bounds_and_copies(tmp_path):
    payload = np.arange(64, dtype=np.uint8)
    fpath = tmp_path / "blob.bin"
    fpath.write_bytes(payload.tobytes())

    def case(m, log):
        for disk in (m.Disk(payload.copy()), m.Disk(path=str(fpath))):
            for off, size in ((60, 8), (64, 1), (-1, 4), (0, -4)):
                with pytest.raises(ValueError):
                    disk.read(off, size)
            got = disk.read(8, 8)
            np.testing.assert_array_equal(got, payload[8:16])
            got[:] = 0
            np.testing.assert_array_equal(disk.read(8, 8), payload[8:16])
            assert disk.read(64, 0).size == 0
            log((len(disk), disk.read(0, 64)))
            log(disk.read_gather([60, 0, 8], [4, 2, 0]))
    lockstep(case)
