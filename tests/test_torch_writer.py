"""The port's DatasetWriter against the JAX package's: on the flat store with
write-through writes (``store="flat", flush=None``), at the reference's
defaults (``store="tiered", flush="write-back"``), and on every cached store
spec under every flush policy.

The same appends, commits, compactions and crashes run on both packages; every
take and scan must give the same buffers, at every committed version, and the
read trace, write trace, every tier's counters (hits, misses, evictions,
prefetch, dirty, lost, RMW), dirty bytes and modelled time must be identical.
Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

from repro.core.file import WriteOptions as RWriteOptions
from repro.dataset import DatasetWriter as RDatasetWriter
from repro.dataset import write_fragments as r_write_fragments
from repro.store import TieredStore as RTieredStore
from repro_torch.core.file import WriteOptions
from repro_torch.core.io_sim import Disk, DiskView
from repro_torch.dataset import DatasetWriter
from repro_torch.kernels import ops
from repro_torch.store import TieredStore

from _torch_port import (assert_same_array, assert_same_writer_io, make_array,
                         messy_rows, to_port)

COLUMNS = ("i", "s", "tags", "emb")


def _table(lo: int, n: int):
    rng = np.random.default_rng(lo * 7919 + n)
    return {"i": make_array("nullable", n, rng), "s": make_array("utf8", n, rng),
            "tags": make_array("nested-list", n, rng),
            "emb": make_array("float-fsl", n, rng)}


class Pair:
    """A reference writer and a port writer driven in lockstep."""

    def __init__(self, files=(), store="flat", encoding="lance", flush=None,
                 decode=None):
        """``store`` is a spec string, or ``f(TieredStore, disk)`` building
        each package's store with its own ``TieredStore`` class."""
        r_decode = {"device": "pallas"}.get(decode, decode)
        r_store, p_store = store, store
        if callable(store):
            r_store = lambda d: store(RTieredStore, d)  # noqa: E731
            p_store = lambda d: store(TieredStore, d)  # noqa: E731
        self.want = RDatasetWriter(files=files, store=r_store, flush=flush,
                                   opts=RWriteOptions(encoding), decode=r_decode)
        self.got = DatasetWriter(files=files, store=p_store, flush=flush,
                                 opts=WriteOptions(encoding), decode=decode,
                                 device="cpu")

    def append(self, table, commit=True):
        a = self.want.append(table, commit=commit)
        b = self.got.append({k: to_port(v) for k, v in table.items()}, commit=commit)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.version == b.version and a.n_rows == b.n_rows
        return b

    def both(self, fn):
        return fn(self.want), fn(self.got)

    def check_reads(self, version=None, rows_seed=0):
        rw, rg = self.want.reader(version), self.got.reader(version)
        assert rw.n_rows == rg.n_rows and rw.n_fragments == rg.n_fragments
        rows = messy_rows(rg.n_rows, 50, np.random.default_rng(rows_seed))
        for col in COLUMNS:
            assert_same_array(rw.scan(col), rg.scan(col))
            assert_same_array(rw.take(col, rows), rg.take(col, rows))

    def check_io(self):
        assert_same_writer_io(self.want, self.got)


@pytest.mark.parametrize("encoding", ["lance", "lance-miniblock", "lance-fullzip"])
def test_append_commit_every_version_matches_reference(encoding):
    p = Pair(encoding=encoding)
    sizes = [50, 80, 30, 120]
    for k, n in enumerate(sizes):
        m = p.append(_table(sum(sizes[:k]), n))
        assert m.version == k + 1
    p.check_io()
    assert p.got.version == len(sizes) and p.got.n_rows == sum(sizes)
    for v in range(1, len(sizes) + 1):
        p.want.reset_io()
        p.got.reset_io()
        p.check_reads(v, rows_seed=v)
        p.check_io()
    with pytest.raises(IndexError):  # old versions cannot see new rows
        p.got.reader(1).take("i", np.array([sizes[0]]))


@pytest.mark.parametrize("store", ["flat", "flat-s3"])
def test_seeded_writer_matches_reference(store):
    table = _table(0, 900)
    files = r_write_fragments(table, 3, RWriteOptions("lance"))
    p = Pair(files=files, store=store)
    assert p.got.version == 1 and p.got.n_rows == 900
    p.check_io()
    p.check_reads()
    p.check_io()
    for col in COLUMNS:  # writer.take/scan serve the latest version
        assert_same_array(p.want.take(col, [0, 899, 300]), p.got.take(col, [0, 899, 300]))
        assert_same_array(p.want.scan(col), p.got.scan(col))
    p.check_io()


def test_uncommitted_rows_are_invisible_until_commit():
    p = Pair()
    p.append(_table(0, 40))
    assert p.append(_table(40, 40), commit=False) is None
    assert p.got.n_rows == 40 and p.got.version == 1
    with pytest.raises(IndexError):
        p.got.take("i", np.array([40]))
    a, b = p.both(lambda w: w.commit())
    assert a.version == b.version == 2 and p.got.n_rows == 80
    assert p.got.commit().version == 2  # nothing staged: no empty version
    p.want.commit()
    p.check_reads()
    p.check_io()


def test_compact_matches_reference():
    p = Pair()
    for lo in range(0, 500, 50):  # 10 small fragments
        p.append(_table(lo, 50))
    v_before = p.got.version
    a, b = p.both(lambda w: w.compact(max_rows=250))
    assert a.version == b.version == v_before + 1
    assert len(b.fragments) == 2 and b.n_rows == 500
    assert [(f.base, f.nbytes, f.n_rows, f.row_start) for f in a.fragments] == \
        [(f.base, f.nbytes, f.n_rows, f.row_start) for f in b.fragments]
    p.check_io()
    p.check_reads()
    p.check_reads(3)  # time travel: pre-compaction versions read old fragments
    assert p.got.reader(3).n_rows == 150
    a, b = p.both(lambda w: w.compact(max_rows=100))  # nothing to merge
    assert a.version == b.version == v_before + 1
    p.check_io()


def test_compact_requires_rows_and_commits_pending():
    p = Pair()
    for w in (p.want, p.got):
        with pytest.raises(ValueError):
            w.compact(0)
        with pytest.raises(ValueError):
            w.compact(10)
    p.append(_table(0, 20), commit=False)
    p.append(_table(20, 20), commit=False)
    a, b = p.both(lambda w: w.compact(max_rows=100))
    assert p.got.n_rows == 40 and len(b.fragments) == len(a.fragments) == 1
    p.check_reads()
    p.check_io()


def test_simulate_crash_matches_reference():
    """Write-through leaves nothing dirty: a crash tears no bytes, drops the
    uncommitted fragment and rewinds to the last committed version."""
    p = Pair()
    p.append(_table(0, 60))
    p.append(_table(60, 40), commit=False)
    assert p.both(lambda w: w.flush()) == (0, 0)
    assert p.both(lambda w: w.simulate_crash()) == (0, 0)
    assert p.got.n_rows == 60 and len(p.got.fragments) == 1
    p.check_reads()
    p.append(_table(100, 30))  # the dataset keeps appending after a crash
    assert p.got.version == 2 and p.got.n_rows == 90
    p.check_reads()
    p.check_io()
    assert [s.lost_bytes for s in p.got.tier_stats()] == [0]


def test_crash_before_first_commit_leaves_an_empty_dataset():
    p = Pair()
    p.append(_table(0, 30), commit=False)
    assert p.both(lambda w: w.simulate_crash()) == (0, 0)
    assert p.got.version == 0 and p.got.fragments == [] and p.got.commit() is None
    with pytest.raises(ValueError):
        p.got.reader()
    p.append(_table(0, 30))
    p.check_reads()
    p.check_io()


def test_attached_writer_shares_the_address_space():
    p = Pair()
    p.append(_table(0, 100))
    aw = RDatasetWriter.attached(p.want)
    ag = DatasetWriter.attached(p.got)
    assert ag.disk is p.got.disk and ag.scheduler is p.got.scheduler
    side = _table(1000, 20)
    aw.append({"s": side["s"]})
    ag.append({"s": to_port(side["s"])})
    assert ag.version == 1 and p.got.version == 1
    assert ag.fragments[0].base == aw.fragments[0].base > p.got.fragments[0].base
    assert_same_array(aw.scan("s"), ag.scan("s"))
    p.check_reads()
    p.check_io()


def test_schema_mismatch_and_bad_versions():
    w = DatasetWriter(store="flat", flush=None, device="cpu")
    with pytest.raises(ValueError):
        w.reader()
    w.append({"i": to_port(_table(0, 10)["i"])})
    with pytest.raises(ValueError):
        w.append({"other": to_port(_table(0, 5)["i"])})
    with pytest.raises(ValueError):
        w.reader(2)


@pytest.mark.parametrize("kw", [{}, {"store": "flat"}, {"store": "tiered", "flush": None},
                                {"store": "flat", "flush": "write-through"},
                                {"store": "hot", "flush": None}])
def test_reference_defaults_raise_not_implemented(kw):
    """The reference's defaults and the specs that once raised (the name is
    from then): appends, commits, an uncommitted append and a crash behave
    as the reference's, with identical stats after every step."""
    want = RDatasetWriter(opts=RWriteOptions("lance"), **kw)
    got = DatasetWriter(opts=WriteOptions("lance"), device="cpu", **kw)
    assert len(got.store.levels) == len(want.store.levels)
    assert (got.flush_policy is None) == (want.flush_policy is None)
    if got.flush_policy is not None:
        assert got.flush_policy.mode == want.flush_policy.mode
    for lo, n, commit in ((0, 60, True), (60, 50, True), (110, 40, False)):
        t = _table(lo, n)
        want.append(t, commit=commit)
        got.append({k: to_port(v) for k, v in t.items()}, commit=commit)
        assert_same_writer_io(want, got)
    rows = messy_rows(110, 40, np.random.default_rng(3))
    for col in COLUMNS:
        assert_same_array(want.take(col, rows), got.take(col, rows))
        assert_same_writer_io(want, got)
    assert want.simulate_crash() == got.simulate_crash()
    assert_same_writer_io(want, got)
    for col in COLUMNS:
        assert_same_array(want.scan(col), got.scan(col))
    assert_same_writer_io(want, got)


def _tiered_steps(p):
    """Appends (one uncommitted, then committed), reads at every version
    cold and warm, a compaction that retargets the cache, a crash with an
    uncommitted append in flight, and appends after it — the stats compared
    after every step."""
    p.append(_table(0, 90))
    p.check_io()
    p.append(_table(90, 70), commit=False)
    p.check_io()
    a, b = p.both(lambda w: w.commit())
    assert a.version == b.version == 2
    p.check_io()
    for lo in (160, 200, 240):
        p.append(_table(lo, 40))
    p.check_io()
    p.check_reads(rows_seed=1)
    p.check_io()
    p.both(lambda w: w.drop_caches())
    p.check_reads(2, rows_seed=2)  # cold again, an older version
    p.check_io()
    a, b = p.both(lambda w: w.compact(max_rows=200))
    assert a.version == b.version and len(b.fragments) == len(a.fragments)
    p.check_io()
    p.check_reads(rows_seed=3)
    p.check_io()
    p.append(_table(280, 50), commit=False)
    p.check_io()
    torn = p.both(lambda w: w.simulate_crash())
    assert torn[0] == torn[1]
    p.check_io()
    p.check_reads(rows_seed=4)
    p.append(_table(280, 30))
    p.check_reads(rows_seed=5)
    p.check_io()
    return torn[1]


@pytest.mark.parametrize("flush", ["write-back", "flush-on-evict", "write-through"])
@pytest.mark.parametrize("store", ["tiered", "hot", "tiered-auto"])
def test_tiered_writer_matches_reference(store, flush):
    p = Pair(store=store, flush=flush)
    torn = _tiered_steps(p)
    lost = sum(t.lost_bytes for t in p.got.tier_stats())
    if flush == "write-through":
        assert torn == 0 and lost == 0
    else:  # the uncommitted append was still dirty when it crashed
        assert torn > 0 and lost > 0


@pytest.mark.parametrize("flush", ["write-back", "flush-on-evict"])
def test_tiered_writer_under_cache_pressure_matches_reference(flush):
    """A 16-block cache: write-back's watermark and deadline flushes and
    flush-on-evict's evictions all fire, in the same drains as the
    reference's."""
    small = lambda cls, d: cls.cached(d, cache_bytes=16 * 4096)  # noqa: E731
    p = Pair(store=small, flush=flush)
    _tiered_steps(p)
    s3 = p.got.tier_stats()[-1]
    assert p.got.tier_stats()[0].evictions > 0 and s3.flush_iops > 0
    policy = p.got.flush_policy
    assert policy.n_flush_events == p.want.flush_policy.n_flush_events > 0


def test_flush_fault_injection_prefix_matches_reference():
    """A commit whose flush dies after one extent: both packages keep the
    same durable prefix, raise, and after the crash read the last committed
    version back."""
    from repro.store import SimulatedCrash as RSimulatedCrash
    from repro_torch.store import SimulatedCrash

    p = Pair(store="tiered", flush="flush-on-evict")
    p.append(_table(0, 80))
    p.append(_table(80, 80), commit=False)
    p.append(_table(160, 80), commit=False)
    for w, exc in ((p.want, RSimulatedCrash), (p.got, SimulatedCrash)):
        w.flush_policy.fail_after = 0
        with pytest.raises(exc):
            w.commit()
        w.flush_policy.fail_after = None
    p.check_io()
    assert p.both(lambda w: w.simulate_crash())[0] > 0
    assert p.got.version == 1 and p.got.n_rows == 80
    p.check_reads()
    p.check_io()


@pytest.mark.parametrize("store", ["tiered", "hot", "tiered-auto"])
def test_tiered_writer_device_and_numpy_routes_agree(store):
    """The arrival-order check: the device route (plain kernels on the CPU)
    leaves the tier trace — readahead fills, hits, evictions, flushes — as
    the numpy route leaves it, on takes and readahead scans."""
    small = lambda cls, d: cls.cached(d, cache_bytes=32 * 4096)  # noqa: E731
    for spec in (store, small):
        dev, host = Pair(store=spec, decode="device"), Pair(store=spec, decode="numpy")
        for p in (dev, host):
            for lo in range(0, 400, 100):
                p.append(_table(lo, 100))
        rows = messy_rows(400, 120, np.random.default_rng(9))
        for col in COLUMNS:
            for p in (dev, host):
                assert_same_array(p.want.scan(col, io_chunk=4096),
                                  p.got.scan(col, io_chunk=4096))
            assert_same_writer_io(dev.got, host.got)
            for p in (dev, host):
                assert_same_array(p.want.take(col, rows), p.got.take(col, rows))
            assert_same_writer_io(dev.got, host.got)
        dev.check_io()
        host.check_io()


def test_writer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DatasetWriter(store="flat", flush=None)
    w = DatasetWriter(store="flat", flush=None, device="cpu")
    assert w.device == torch.device("cpu")


def test_disk_grows_under_live_views():
    d = Disk()
    assert d.grow(10) == 10
    d.write(2, b"abc")
    v = DiskView(d, 2, 3)
    for _ in range(5):  # geometric growth reallocates the buffer
        d.grow(5000)
    assert bytes(v.read(0, 3)) == b"abc" and len(d) == 25010
    assert not d.read(10, 25000).any()
    d.zero(3, 100)
    assert bytes(v.read(0, 3)) == b"a\x00\x00"
    with pytest.raises(ValueError):
        d.write(25009, b"xy")
    with pytest.raises(ValueError):
        d.grow(-1)


def test_writer_reads_launch_nothing_on_the_cpu():
    ops.reset_counts()
    p = Pair()
    p.append(_table(0, 70))
    p.check_reads()
    assert set(ops.launches.values()) == {0}
