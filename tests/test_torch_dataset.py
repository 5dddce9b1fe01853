"""The port's DatasetReader against the JAX package's, over 3 fragments.

Takes (global rows, unsorted, duplicated, crossing fragment boundaries) and
scans give the same values, logical IO and modelled time as the reference's
``decode="pallas"`` route; ``write_fragments`` writes the same files.
Tolerance 0 throughout.
"""

import numpy as np
import pytest

from repro.dataset import DatasetReader as RDatasetReader
from repro.dataset import write_fragments as r_write_fragments
from repro_torch.core.file import WriteOptions
from repro_torch.dataset import DatasetReader, Manifest, write_fragments
from repro_torch.kernels import ops

from _torch_port import (assert_same_array, assert_same_io, make_array,
                         messy_rows, r_opts, to_port)

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
                            "ivf_topk": 0, "bitunpack": 0}


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
