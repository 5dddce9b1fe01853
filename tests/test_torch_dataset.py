"""The port's DatasetReader against the JAX package's, over 3 fragments.

Takes (global rows, unsorted, duplicated, crossing fragment boundaries) and
scans give the same values, logical IO, per-tier stats and modelled time as
the reference's ``decode="pallas"`` route, on the flat store and on every
cached store spec (cold, warm, readahead scans, cold restarts, a cache small
enough to evict); the device and numpy routes leave the same tier trace;
``write_fragments`` writes the same files.  Tolerance 0 throughout.
"""

import numpy as np
import pytest

from repro.dataset import DatasetReader as RDatasetReader
from repro.dataset import write_fragments as r_write_fragments
from repro.store import TieredStore as RTieredStore
from repro_torch.core.file import WriteOptions
from repro_torch.dataset import DatasetReader, Manifest, write_fragments
from repro_torch.kernels import ops
from repro_torch.store import TieredStore

from _torch_port import (assert_same_array, assert_same_io, make_array,
                         messy_rows, r_opts, to_port)

COLUMNS = ("id", "score", "tags", "name", "emb", "quad")

N_ROWS = 6000


def _table(rng):
    return {
        "id": make_array("primitive", N_ROWS, rng),
        "score": make_array("nullable", N_ROWS, rng),
        "tags": make_array("nested-list", N_ROWS, rng),
        "name": make_array("utf8", N_ROWS, rng),
        "emb": make_array("float-fsl", N_ROWS, rng),
        "quad": make_array("fixed-size-list", N_ROWS, rng),
    }


@pytest.fixture(scope="module")
def fragments():
    table = _table(np.random.default_rng(20))
    files = r_write_fragments(table, 3, r_opts("lance", decode="pallas"))
    return table, files


def test_write_fragments_is_byte_identical(fragments):
    table, files = fragments
    got = write_fragments({k: to_port(v) for k, v in table.items()}, 3,
                          WriteOptions("lance", decode="device"))
    assert got == files


@pytest.mark.parametrize("column", ["id", "score", "tags", "name", "emb", "quad"])
@pytest.mark.parametrize("n_take", [1, 97, 2500])
def test_take_matches_reference(fragments, column, n_take):
    _, files = fragments
    rng = np.random.default_rng(n_take)
    rows = messy_rows(N_ROWS, n_take, rng)
    want = RDatasetReader(files)
    ops.reset_counts()
    got = DatasetReader(files, device="cpu")
    assert got.n_fragments == 3 and got.n_rows == N_ROWS
    assert_same_array(want.take(column, rows), got.take(column, rows))
    assert_same_io(want, got)
    assert ops.launches == {"miniblock_decode": 0, "fullzip_gather": 0,
                            "ivf_topk": 0, "bitunpack": 0,
                            "miniblock_take": 0}


@pytest.mark.parametrize("column", ["id", "score", "tags", "name", "emb", "quad"])
def test_scan_matches_reference(fragments, column):
    _, files = fragments
    want, got = RDatasetReader(files), DatasetReader(files, device="cpu")
    assert_same_array(want.scan(column), got.scan(column))
    assert_same_io(want, got)


def test_device_and_numpy_routes_agree(fragments):
    table, files = fragments
    want = RDatasetReader(files, decode="numpy")
    dev = DatasetReader(files, device="cpu")
    host = DatasetReader(files, decode="numpy", device="cpu")
    assert dev.fragments[0].decode == "device"
    rows = messy_rows(N_ROWS, 300, np.random.default_rng(5))
    for column in table:
        ref_take = want.take(column, rows)
        assert_same_array(ref_take, dev.take(column, rows))
        assert_same_array(ref_take, host.take(column, rows))
    assert_same_io(want, dev)
    assert_same_io(want, host)


def test_empty_take_and_bounds(fragments):
    _, files = fragments
    want, got = RDatasetReader(files), DatasetReader(files, device="cpu")
    assert_same_array(want.take("tags", np.zeros(0, np.int64)),
                      got.take("tags", np.zeros(0, np.int64)))
    with pytest.raises(IndexError):
        got.take("id", np.array([N_ROWS]))
    fi, local = got.locate(np.array([0, 1999, 2000, N_ROWS - 1]))
    rfi, rlocal = want.locate(np.array([0, 1999, 2000, N_ROWS - 1]))
    np.testing.assert_array_equal(fi, rfi)
    np.testing.assert_array_equal(local, rlocal)


def test_manifest_rejects_mismatched_schemas(fragments):
    table, files = fragments
    other = write_fragments({"id": to_port(table["id"])}, 1)
    with pytest.raises(ValueError):
        Manifest.from_files([files[0], other[0]])
    with pytest.raises(ValueError):
        Manifest.from_files([])


def _stores(spec):
    """(reference spec, port spec): a spec string, or a 24-block NVMe cache
    over S3 built by each package's own TieredStore."""
    if spec != "small":
        return spec, spec
    return (lambda d: RTieredStore.cached(d, cache_bytes=24 * 4096),
            lambda d: TieredStore.cached(d, cache_bytes=24 * 4096))


@pytest.mark.parametrize("spec", ["tiered", "hot", "tiered-auto", "small"])
def test_tiered_dataset_matches_reference(fragments, spec):
    """Cold takes, warm repeats, readahead scans crossing the fragments and
    a cold restart: the reference, the port's device route and its numpy
    route give the same values, and identical logical IO, tier stats
    (hits, misses, evictions, prefetch) and modelled time after every
    step."""
    _, files = fragments
    r_spec, p_spec = _stores(spec)
    want = RDatasetReader(files, store=r_spec)
    dev = DatasetReader(files, store=p_spec, device="cpu")
    host = DatasetReader(files, store=p_spec, decode="numpy", device="cpu")
    rows = messy_rows(N_ROWS, 700, np.random.default_rng(17))
    ops.reset_counts()
    evictions = 0
    for step in ("cold", "warm", "scan", "dropped"):
        for col in COLUMNS:
            for r in (want, dev, host):
                r.reset_io()
                if step == "dropped":
                    r.drop_caches()
            if step == "scan":
                ref_val = want.scan(col, io_chunk=16 * 1024)
                got = [r.scan(col, io_chunk=16 * 1024) for r in (dev, host)]
            else:
                ref_val = want.take(col, rows)
                got = [r.take(col, rows) for r in (dev, host)]
            for g in got:
                assert_same_array(ref_val, g)
            assert_same_io(want, dev)
            assert_same_io(dev, host)
            w, d = want.workload_stats(), dev.workload_stats()
            assert (w.scan_bytes, w.take_bytes, w.preferred_admission()) == \
                (d.scan_bytes, d.take_bytes, d.preferred_admission())
            evictions += dev.tier_stats()[0].evictions
    assert (evictions > 0) == (spec == "small")
    assert ops.launches == {"miniblock_decode": 0, "fullzip_gather": 0,
                            "ivf_topk": 0, "bitunpack": 0,
                            "miniblock_take": 0}


def test_tiered_dataset_scan_readahead_crosses_fragments(fragments):
    """One prefetch-flagged batch per dataset scan: readahead's high-water
    mark passes into the next fragment, as the reference's does."""
    _, files = fragments
    want = RDatasetReader(files, store="tiered")
    got = DatasetReader(files, store="tiered", device="cpu")
    assert_same_array(want.scan("name", io_chunk=4096), got.scan("name", io_chunk=4096))
    assert got.scheduler.n_batches == 1
    assert got.scheduler.readahead._ra_until == want.scheduler.readahead._ra_until \
        > got.manifest.fragments[1].base
    nvme, s3 = got.tier_stats()
    assert s3.prefetch_iops > 0 and nvme.hits > 0
    assert_same_io(want, got)


# ---------------------------------------------------------------------------
# dict_cached (§6.1.1): a Parquet dictionary page fetched once, not per take
# ---------------------------------------------------------------------------


def _dict_files():
    strings = make_array("utf8", 4000, np.random.default_rng(31))
    return r_write_fragments({"c": strings}, 2, r_opts("parquet", dict_encode=True))


@pytest.mark.parametrize("dict_cached", [False, True])
@pytest.mark.parametrize("via", ["reader", "writer"])
def test_dict_cached_take_iops_equal_the_reference(dict_cached, via):
    """Two dict-encoded Parquet fragments: a cold take of one row in each,
    then a warm one, through ``DatasetReader`` or ``DatasetWriter``; values,
    IO and modelled time equal the reference's.  With ``dict_cached`` the
    warm take skips both dictionary pages (tests/test_system.py::
    test_parquet_dict_needs_extra_fetch, per fragment)."""
    from repro.dataset import DatasetWriter as RDatasetWriter
    from repro_torch.dataset import DatasetWriter

    files = _dict_files()
    if via == "reader":
        want = RDatasetReader(files, dict_cached=dict_cached)
        got = DatasetReader(files, dict_cached=dict_cached, device="cpu")
    else:
        want = RDatasetWriter(files, store="flat", flush=None, dict_cached=dict_cached)
        got = DatasetWriter(files, store="flat", flush=None, dict_cached=dict_cached,
                            device="cpu")
    iops = []
    for rows in (np.array([3, 2500]), np.array([4, 2501])):  # cold, then warm
        want.reset_io()
        got.reset_io()
        assert_same_array(want.take("c", rows), got.take("c", rows))
        assert_same_io(want, got)
        iops.append(got.io_stats().n_iops)
    assert iops == ([4, 2] if dict_cached else [4, 4])


def test_a_positional_dict_cached_binds_dict_cached_not_device():
    files = _dict_files()
    # the reference's positional order: files, store, queue_depth,
    # readahead, decode, dict_cached, tracer; device is keyword-only
    ds = DatasetReader(files, None, 256, "auto", None, True, device="cpu")
    assert all(f.dict_cached is True for f in ds.fragments) and ds.device.type == "cpu"
    with pytest.raises(TypeError):
        DatasetReader(files, None, 256, "auto", None, False, None, "cpu")
