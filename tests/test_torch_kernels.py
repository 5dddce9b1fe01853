"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it must match the
Pallas kernel (interpret mode) bit for bit over the sweeps of
tests/test_kernels.py.  (The CUDA kernels against their plain versions, on a
card: tests/test_torch_cuda.py.)  Tolerance 0 throughout: all outputs are
integers or bytes.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref


def _miniblock_case(seed: int, *args, **kw):
    """The port's sweep generator (``ref.miniblock_case``) from a seed."""
    return ref.miniblock_case(np.random.default_rng(seed), *args, **kw)


def _torch_args(case, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in case]


@pytest.mark.parametrize("rep_bits,def_bits", [(0, 0), (0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("vpe", [1, 4])
@pytest.mark.parametrize("n_chunks", [1, 4])
def test_miniblock_decode_matches_pallas(rep_bits, def_bits, vpe, n_chunks):
    case = _miniblock_case(100 * rep_bits + 10 * def_bits + vpe + n_chunks,
                           rep_bits, def_bits, vpe, n_chunks)
    kw = dict(rep_bits=rep_bits, def_bits=def_bits, vpe=vpe, tile_entries=1024)
    want = jops.miniblock_decode(*(jnp.asarray(a) for a in case), use_pallas=True, **kw)
    got = ops.miniblock_decode(*_torch_args(case), **kw)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("fill", [0, -7])
def test_miniblock_decode_wraps_like_pallas(fill):
    """31-bit values plus a large frame of reference wrap around in int32
    exactly as the Pallas kernel's arithmetic does; nulls read ``fill``."""
    case = _miniblock_case(7, 0, 1, 2, 3, tile=512, max_bits=31,
                           ref_range=(1 << 30, (1 << 31) - 1))
    kw = dict(rep_bits=0, def_bits=1, vpe=2, tile_entries=512, fill=fill)
    want = jops.miniblock_decode(*(jnp.asarray(a) for a in case), use_pallas=True, **kw)
    got = ops.miniblock_decode(*_torch_args(case), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("stride", [8, 24, 33, 129, 136, 512, 1536])
@pytest.mark.parametrize("n_take", [1, 7, 64])
def test_fullzip_gather_matches_pallas(stride, n_take):
    rng = np.random.default_rng(stride * 1000 + n_take)
    zipped = rng.integers(0, 256, (300, stride), dtype=np.uint8)
    rows = rng.integers(0, 300, n_take).astype(np.int32)
    want = np.asarray(jops.fullzip_gather(jnp.asarray(zipped), jnp.asarray(rows),
                                          use_pallas=True))
    got = ops.fullzip_gather(torch.from_numpy(zipped), torch.from_numpy(rows))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(want, got.numpy())


def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    ops.reset_counts()
    case = _miniblock_case(3, 1, 2, 1, 2)
    ops.miniblock_decode(*_torch_args(case), rep_bits=1, def_bits=2, tile_entries=1024)
    z = torch.zeros((5, 9), dtype=torch.uint8)
    assert ops.fullzip_gather(z, torch.zeros(0, dtype=torch.int32)).shape == (0, 9)
    ops.fullzip_gather(z, torch.tensor([4, 0, 4], dtype=torch.int32))
    ops.bitunpack(torch.arange(4, dtype=torch.int32).view(torch.uint32), 9, 7)
    ops.ivf_topk_tensors(torch.ones((2, 3)), torch.zeros((4, 3)),
                         torch.arange(4, dtype=torch.int32), 2)
    assert ops.launches == {"miniblock_decode": 0, "fullzip_gather": 0,
                            "ivf_topk": 0, "bitunpack": 0}


def test_wrappers_reject_bad_inputs():
    rw, dw, vw, p = _torch_args(_miniblock_case(5, 0, 1, 1, 2))
    kw = dict(rep_bits=0, def_bits=1, tile_entries=1024)
    with pytest.raises(TypeError):
        ops.miniblock_decode(rw, dw, vw.to(torch.int32), p, **kw)
    with pytest.raises(ValueError):
        ops.miniblock_decode(rw, dw, vw, p[:1], **kw)
    with pytest.raises(ValueError):
        ops.miniblock_decode(rw, dw, vw, p, rep_bits=0, def_bits=1, tile_entries=1000)
    with pytest.raises(ValueError):
        ops.miniblock_decode(rw, dw, vw, p, rep_bits=0, def_bits=1, vpe=64,
                             tile_entries=4096)
    z = torch.zeros((5, 9), dtype=torch.uint8)
    with pytest.raises(IndexError):
        ops.fullzip_gather(z, torch.tensor([5], dtype=torch.int32))
    with pytest.raises(IndexError):
        ops.fullzip_gather(z, torch.tensor([-1], dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.fullzip_gather(z, torch.tensor([1], dtype=torch.int64))


def test_pack_words_matches_reference():
    rng = np.random.default_rng(11)
    for n in (0, 1, 3, 4, 5, 33):
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        for pad in (0, 1):
            np.testing.assert_array_equal(ops.pack_words(buf, pad), jops.pack_words(buf, pad))


def test_kernel_sources_declare_their_entry_points():
    """The CUDA sources cannot compile here; check statically that each one
    exists, exports the C symbol the loader binds with the declared number
    of arguments, and names the TPU kernel it replaces."""
    for src, (symbol, argtypes) in build._ENTRY.items():
        assert src in build.SOURCES
        text = (build.CSRC / src).read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
        assert m, f"{src} does not export {symbol}"
        assert len(m.group(1).split(",")) == len(argtypes)
        assert "Replaces the TPU kernel src/repro/kernels/" in text
        assert "What bounds it:" in text


# ---------------------------------------------------------------------------
# bitunpack and ivf_topk (the search path's kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 3, 5, 8, 11, 16, 21, 32])
@pytest.mark.parametrize("n", [1, 100, 8192, 20_000])
def test_bitunpack_matches_pallas(bits, n):
    """The grid of tests/test_kernels.py::test_bitunpack_sweep, tolerance 0."""
    from repro.core.compression import bitpack

    v = np.random.default_rng(bits * 100_000 + n).integers(
        0, 2 ** min(bits, 62), n, dtype=np.uint64)
    words = jops.pack_words(bitpack(v, bits))
    want = np.asarray(jops.bitunpack(jnp.asarray(words), n, bits, use_pallas=True))
    got = ops.bitunpack(torch.from_numpy(words), n, bits)
    assert got.dtype == torch.uint32 and got.shape == (n,)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(v, got.numpy())


def test_bitunpack_rejects_bad_inputs():
    words = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(ValueError):
        ops.bitunpack(words, 5, 33)
    with pytest.raises(ValueError):
        ops.bitunpack(words, 5, 0)
    with pytest.raises(ValueError):  # 5 values of 32 bits need 5 words
        ops.bitunpack(words, 5, 32)
    with pytest.raises(TypeError):
        ops.bitunpack(words.view(torch.int32), 4, 8)
    assert ops.bitunpack(words, 0, 7).shape == (0,)


def _ivf_both_routes(q, c, ids, k, mask=None):
    """The JAX package's Pallas (interpret) and oracle routes."""
    return [tuple(np.asarray(a) for a in jops.ivf_topk(q, c, ids, k, mask=mask,
                                                       use_pallas=up))
            for up in (True, False)]


@pytest.mark.parametrize("dim", [3, 64, 128, 200])
@pytest.mark.parametrize("nq,nc,k", [(1, 7, 3), (5, 300, 10), (9, 129, 1)])
def test_ivf_topk_matches_both_jax_routes(dim, nq, nc, k):
    """The grid of tests/test_kernels.py::test_ivf_topk_parity_sweep: winner
    ids exact, distances within rtol 1e-6 (the two JAX routes themselves
    differ by about an ulp at dim >= 128)."""
    r = np.random.default_rng(dim * 1000 + nq)
    q = r.standard_normal((nq, dim)).astype(np.float32)
    c = r.standard_normal((nc, dim)).astype(np.float32)
    ids = r.permutation(nc).astype(np.int64)
    mask = r.integers(0, 2, (nq, nc)).astype(np.int32)
    ops.reset_counts()
    for m in (None, mask):
        d, w = ops.ivf_topk(q, c, ids, k, mask=m, device="cpu")
        assert d.shape == w.shape == (nq, k)
        assert d.dtype == np.float32 and w.dtype == np.int32
        for wd, ww in _ivf_both_routes(q, c, ids, k, m):
            np.testing.assert_array_equal(ww, w)
            np.testing.assert_allclose(d, wd, rtol=1e-6)
    assert ops.fallbacks == {} and ops.launches["ivf_topk"] == 0


def test_ivf_topk_ties_break_by_row_id():
    q = np.zeros((1, 8), np.float32)
    c = np.zeros((6, 8), np.float32)  # all distance 0: pure tie
    ids = np.array([40, 5, 99, 17, 3, 60], np.int64)
    _, w = ops.ivf_topk(q, c, ids, 4, device="cpu")
    for _, ww in _ivf_both_routes(q, c, ids, 4):
        np.testing.assert_array_equal(ww, w)
    np.testing.assert_array_equal(w[0], [3, 5, 17, 40])


def test_ivf_topk_exhaustion_pads_with_sentinels():
    r = np.random.default_rng(3)
    q = r.standard_normal((2, 16)).astype(np.float32)
    c = r.standard_normal((3, 16)).astype(np.float32)
    mask = np.array([[1, 1, 1], [0, 1, 0]], np.int32)
    for m in (None, mask):
        d, w = ops.ivf_topk(q, c, np.arange(3), 6, mask=m, device="cpu")
        for wd, ww in _ivf_both_routes(q, c, np.arange(3), 6, m):
            np.testing.assert_array_equal(ww, w)
            np.testing.assert_allclose(d, wd, rtol=1e-6)
    assert (w[0, 3:] == ops.IVF_ID_SENTINEL).all() and np.isinf(d[0, 3:]).all()
    assert (w[1, 1:] == ops.IVF_ID_SENTINEL).all() and np.isinf(d[1, 1:]).all()


def test_ivf_topk_duplicate_ids():
    """A duplicated (distance, id) pair is selected once; the same id at a
    different distance is selected again."""
    r = np.random.default_rng(4)
    q = r.standard_normal((2, 8)).astype(np.float32)
    c = r.standard_normal((6, 8)).astype(np.float32)
    c = np.concatenate([c, c[:2], c[:1] + 1])
    ids = np.array([5, 3, 9, 1, 7, 2, 5, 3, 5])
    d, w = ops.ivf_topk(q, c, ids, 8, device="cpu")
    for wd, ww in _ivf_both_routes(q, c, ids, 8):
        np.testing.assert_array_equal(ww, w)
        np.testing.assert_allclose(d, wd, rtol=1e-6)
    for row_d, row_w in zip(d, w):
        pairs = list(zip(row_d.tolist(), row_w.tolist()))
        real = [p for p in pairs if p[1] != ops.IVF_ID_SENTINEL]
        assert len(set(real)) == len(real) == 7  # 9 rows, 2 exact duplicates
    assert (w == 5).sum(axis=1).tolist() == [2, 2]


def test_ivf_topk_nan_distance_poisons_its_query():
    """An eligible NaN distance makes the query's row (nan, sentinel), as
    in the reference; a masked-out NaN is ignored."""
    r = np.random.default_rng(0)
    q = r.standard_normal((2, 8)).astype(np.float32)
    c = r.standard_normal((6, 8)).astype(np.float32)
    c[2, 0] = np.nan
    mask = np.ones((2, 6), np.int32)
    mask[0, 2] = 0
    d, w = ops.ivf_topk(q, c, np.arange(6), 4, mask=mask, device="cpu")
    for wd, ww in _ivf_both_routes(q, c, np.arange(6), 4, mask):
        np.testing.assert_array_equal(ww, w)
        np.testing.assert_allclose(d, wd, rtol=1e-6)
    assert np.isfinite(d[0]).all() and 2 not in w[0]
    assert np.isnan(d[1]).all() and (w[1] == ops.IVF_ID_SENTINEL).all()


def test_ivf_topk_fallback_reasons_and_counts():
    r = np.random.default_rng(0)
    q64, c64 = r.standard_normal((2, 8)), r.standard_normal((10, 8))
    q32, c32 = q64.astype(np.float32), c64.astype(np.float32)
    ops.reset_counts()
    d, w = ops.ivf_topk(q64, c64, np.arange(10), 3, device="cpu")
    for wd, ww in _ivf_both_routes(q64, c64, np.arange(10), 3):
        np.testing.assert_array_equal(ww, w)
        np.testing.assert_allclose(d, wd, rtol=1e-6)
    d, w = ops.ivf_topk(q32, np.zeros((0, 8), np.float32), np.zeros(0, np.int64), 3,
                        device="cpu")
    assert np.isinf(d).all() and (w == ops.IVF_ID_SENTINEL).all()
    big = ops.IVF_K_MAX + 1
    cb = r.standard_normal((big + 5, 8)).astype(np.float32)
    d, w = ops.ivf_topk(q32, cb, np.arange(big + 5), big, device="cpu")
    want = ((cb[None].astype(np.float64) - q32[:, None]) ** 2).sum(-1).argsort(1)[:, :big]
    assert (w[:, :20] == want[:, :20]).all()
    ops.ivf_topk(q32, c32, np.arange(10, dtype=np.int64) + (1 << 31), 3, device="cpu")
    ops.ivf_topk(q32, c32, np.arange(10), 3, device="cpu")  # eligible: not counted
    assert ops.fallbacks == {
        "decode.fallback.ivf.non-float32": 1,
        "decode.fallback.ivf.no-candidates": 1,
        f"decode.fallback.ivf.>{ops.IVF_K_MAX}-k": 1,
        "decode.fallback.ivf.>31-bit-ids": 1,
    }
    with pytest.raises(ValueError):
        ops.ivf_topk(q32, c32, np.arange(10), 0, device="cpu")


def test_ivf_topk_wide_ids_are_remapped():
    """Ids past 31 bits select over positions in id order and map back."""
    r = np.random.default_rng(1)
    q = r.standard_normal((3, 8)).astype(np.float32)
    c = r.standard_normal((40, 8)).astype(np.float32)
    ids = (r.permutation(40).astype(np.int64) * 7) + (1 << 33)
    mask = r.integers(0, 2, (3, 40)).astype(np.int32)
    for m in (None, mask):
        d, w = ops.ivf_topk(q, c, ids, 5, mask=m, device="cpu")
        assert w.dtype == np.int64
        for wd, ww in _ivf_both_routes(q, c, ids, 5, m):
            np.testing.assert_array_equal(ww, w)
            np.testing.assert_allclose(d, wd, rtol=1e-6)
    c[5] = c[9]  # a tie between two wide ids goes to the lower one
    q[0] = c[5]
    _, w = ops.ivf_topk(q, c, ids, 2, device="cpu")
    assert w[0].tolist() == sorted([ids[5], ids[9]])


def test_ivf_topk_large_k_runs_the_plain_version_on_the_cpu():
    """k up to IVF_K_MAX is eligible here, where the reference's kernel
    stops at 128 and counts a fallback; the results agree."""
    r = np.random.default_rng(2)
    q = r.standard_normal((2, 8)).astype(np.float32)
    c = r.standard_normal((300, 8)).astype(np.float32)
    ops.reset_counts()
    d, w = ops.ivf_topk(q, c, np.arange(300), 200, device="cpu")
    assert ops.fallbacks == {}
    wd, ww = (np.asarray(a) for a in jops.ivf_topk(q, c, np.arange(300), 200))
    np.testing.assert_array_equal(ww, w)
    np.testing.assert_allclose(d, wd, rtol=1e-6)


def test_ivf_topk_tensors_rejects_bad_inputs():
    q = torch.zeros((2, 4))
    c = torch.zeros((3, 4))
    ids = torch.arange(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.ivf_topk_tensors(q.double(), c, ids, 1)
    with pytest.raises(ValueError):
        ops.ivf_topk_tensors(q, torch.zeros((3, 5)), ids, 1)
    with pytest.raises(ValueError):
        ops.ivf_topk_tensors(q, c, ids, 1, mask=torch.ones((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.ivf_topk_tensors(q, c, ids, ops.IVF_K_MAX + 1)
    with pytest.raises(ValueError):
        ops.ivf_topk_tensors(q, c[:0], ids[:0], 1)


def test_ivf_kernel_constants_match_the_launcher():
    """The launcher sizes the kernel's per-tile lists with csrc/ivf_topk.cu's
    tile and sort sizes, and IVF_K_MAX is what the kernel accepts."""
    text = (build.CSRC / "ivf_topk.cu").read_text()
    tile = int(re.search(r"constexpr int kTile = (\d+);", text).group(1))
    sort = int(re.search(r"constexpr int kSort = (\d+);", text).group(1))
    assert (tile, sort) == (ops._IVF_TILE, ops._IVF_SORT)
    assert "4 * k > kSort" in text and ops.IVF_K_MAX == sort // 4


def test_ivf_topk_mismatch_rule():
    """Ids may swap only inside a near tie; distances are held to rtol,
    scaled by the expanded form's terms where a scale is given."""
    want_d = np.array([[1.0, 2.0, 2.0000005, 3.0, np.inf]], np.float32)
    want_w = np.array([[4, 8, 9, 1, ref.IVF_ID_SENTINEL]], np.int32)
    assert ref.ivf_topk_mismatches(want_d, want_w, want_d, want_w) == (0, 1)
    swapped = want_w[:, [0, 2, 1, 3, 4]]
    assert ref.ivf_topk_mismatches(want_d, swapped, want_d, want_w) == (0, 1)
    assert ref.ivf_topk_mismatches(want_d, want_w[:, [1, 0, 2, 3, 4]], want_d,
                                   want_w)[0] == 3
    off = want_d.copy()
    off[0, 0] = 1.00001
    assert ref.ivf_topk_mismatches(off, want_w, want_d, want_w)[0] == 1
    assert ref.ivf_topk_mismatches(off, want_w, want_d, want_w, scale=[100.0])[0] == 0
    nan = np.full_like(want_d, np.nan)
    assert ref.ivf_topk_mismatches(nan, want_w, nan, want_w) == (0, 0)
