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
    _, dw, vw, params = _torch_args(case)
    ops.miniblock_take(dw, vw, params, torch.tensor([0, 4097], dtype=torch.int32), def_bits=2)
    z = torch.zeros((5, 9), dtype=torch.uint8)
    assert ops.fullzip_gather(z, torch.zeros(0, dtype=torch.int32)).shape == (0, 9)
    ops.fullzip_gather(z, torch.tensor([4, 0, 4], dtype=torch.int32))
    ops.bitunpack(torch.arange(4, dtype=torch.int32).view(torch.uint32), 9, 7)
    ops.ivf_topk_tensors(torch.ones((2, 3)), torch.zeros((4, 3)),
                         torch.arange(4, dtype=torch.int32), 2)
    assert ops.launches == {"miniblock_decode": 0, "fullzip_gather": 0,
                            "ivf_topk": 0, "bitunpack": 0,
                            "miniblock_take": 0}


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
    of arguments, and names the TPU kernel it replaces (or says that it
    replaces none)."""
    for src, (symbol, argtypes) in build._ENTRY.items():
        assert src in build.SOURCES
        text = (build.CSRC / src).read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
        assert m, f"{src} does not export {symbol}"
        assert len(m.group(1).split(",")) == len(argtypes)
        assert ("Replaces the TPU kernel src/repro/kernels/" in text
                or "Replaces no TPU kernel." in text)
        assert "What bounds it:" in text
        # each launcher takes the device index before the stream
        assert [a.strip() for a in m.group(1).split(",")[-2:]] == ["int device",
                                                                   "void* stream"]
    for header in build.HEADERS:
        assert (build.CSRC / header).exists()


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


def _cu_constants(src: str) -> dict:
    """``{name: value text}`` of a CUDA source's ``constexpr int`` constants
    (``"_text"``: the source)."""
    text = (build.CSRC / src).read_text()
    out = {"_text": text}
    for decl in re.finditer(r"constexpr int ([^;]+);", text):
        for part in decl.group(1).split(","):
            name, value = part.split("=")
            out[name.strip()] = value.strip()
    return out


def test_ivf_kernel_constants_match_the_launcher():
    """ivf_plan sizes a launch with csrc/ivf_topk.cu's tile, stage, ring,
    group, shared-memory and sort sizes, and IVF_K_MAX is what the kernel
    accepts."""
    c = _cu_constants("ivf_topk.cu")
    rows, chunk, qmax = int(c["kThreads"]), int(c["kChunk"]), int(c["kQMax"])
    assert c["kTileRows"] == "kThreads" and c["kRowStride"] == "kChunk + 4"
    assert c["kStageFloats"] == "kTileRows * kRowStride + kChunk * kQMax"
    assert (rows, qmax) == (ops._IVF_TILE, ops._IVF_QMAX)
    assert ops._IVF_STAGE_FLOATS == rows * (chunk + 4) + chunk * qmax
    assert (int(c["kMinStages"]), int(c["kMaxStages"])) == (ops._IVF_MIN_STAGES,
                                                          ops._IVF_MAX_STAGES)
    assert c["kSmemMax"] == "227 * 1024" and ops._IVF_SMEM == 227 * 1024 - 1024
    assert "smem > kSmemMax - 1024" in c["_text"]
    assert int(c["kSort"]) == ops._IVF_SORT
    assert "4 * k > kSort" in c["_text"] and ops.IVF_K_MAX == ops._IVF_SORT // 4


def test_gather_kernel_constants_match_the_launcher():
    c = _cu_constants("fullzip_gather.cu")
    assert (int(c["kStageBytes"]), int(c["kStages"]), int(c["kMaxRowsPerUnit"])) == (
        ops._GATHER_STAGE_BYTES, ops._GATHER_STAGES, ops._GATHER_MAX_ROWS)
    assert {"bulk": int(c["kRouteBulk"]), "register": int(c["kRouteRegister"])} == \
        ops._GATHER_ROUTES
    # the bulk route's work counter is the launch's own: the source keeps no
    # __device__ variable that two launches could share
    text = (build.CSRC / "fullzip_gather.cu").read_text()
    assert "kTicketSlots" not in c
    assert not re.search(r"^\s*__device__\s+(?!__forceinline__)[^(]*;", text, re.M)
    # the bulk ring of the blocks an SM holds fits its 228 KB of shared memory
    per_block = ops._GATHER_STAGES * ops._GATHER_STAGE_BYTES + 1024
    assert ops._GATHER_BLOCKS_PER_SM["bulk"] * per_block <= 228 * 1024


_PLAN_NS = sorted({*range(1, 300), *(2 ** e + d for e in range(9, 22) for d in (-1, 0, 1)),
                   694_907, 1_048_576, 133_003})


@pytest.mark.parametrize("qn", [1, 4, 8, 9])
@pytest.mark.parametrize("sms", [1, 132])
def test_ivf_plan_covers_every_k_and_n(qn, sms):
    """ivf_plan is a pure function of (Q, N, k, SM count) whose plan the
    kernel accepts, for every k <= IVF_K_MAX and N from 1 to 2**21: every
    block gets at least one 256-row tile and the tiles are covered; about
    one block per SM; survivor buffers hold k kept pairs plus a tile; the
    ring fits beside them; the merge passes end with one list per query
    and the list buffers hold every pass."""
    for k in range(1, ops.IVF_K_MAX + 1):
        for n in _PLAN_NS:
            p = ops.ivf_plan(qn, n, k, sms)
            tiles = -(-n // 256)
            assert p["qg"] in (1, 2, 4, 8) and p["qg"] >= min(qn, 8) > p["qg"] // 2
            assert p["groups"] * p["qg"] >= qn > (p["groups"] - 1) * p["qg"]
            assert p["blocks"] * p["tiles_per_block"] >= tiles
            assert (p["blocks"] - 1) * p["tiles_per_block"] < tiles
            assert p["blocks"] <= max(1, sms // p["groups"])
            buf = p["buf"]
            assert buf & (buf - 1) == 0 and k + 256 <= buf < 2 * (k + 256)
            assert 2 <= p["stages"] <= 4
            assert p["smem"] == 4 * p["stages"] * ops._IVF_STAGE_FLOATS + 8 * p["qg"] * buf
            assert p["smem"] <= ops._IVF_SMEM
            # the score pass writes list a; pass i writes list b, a, b, ...
            # (the last pass writes the output), each smaller than the one before
            lists, passes, fan_in = p["blocks"], 0, ops._IVF_SORT // k
            while lists > 1:
                lists = -(-lists // fan_in)
                passes += 1
            assert p["merge_passes"] == passes
            if p["blocks"] > 1:
                assert p["list_a_pairs"] >= qn * p["blocks"] * k
            if passes > 1:
                assert p["list_b_pairs"] >= qn * -(-p["blocks"] // fan_in) * k
            assert ops.ivf_plan(qn, n, k, sms) == p


def test_fullzip_gather_counter_is_per_launch(monkeypatch):
    """The bulk route gets a work counter of its own at every launch: an
    8-byte block allocated on the launch's device, passed to the C launcher
    (which zeroes it on the launch's stream); the register route gets none.
    No slot table is kept between launches."""
    calls = []

    class Lib:
        def fullzip_gather_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ops, "_lib", lambda: Lib())
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ops, "_stream", lambda device: 0)
    allocated = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        allocated.append((tuple(t.shape), t.dtype, t.device))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    rows = torch.tensor([3, 0, 3, 1], dtype=torch.int32)
    n0 = ops.launches["fullzip_gather"]
    for stride in (1536, 1536, 33):
        zipped = real_empty((4, stride), dtype=torch.uint8)
        out = real_empty((4, stride), dtype=torch.uint8)
        route = ops.fullzip_plan(4, stride, zipped.data_ptr(), out.data_ptr(), 132)["route"]
        ops.launch_fullzip_gather(zipped, rows, out)
        counter = calls[-1][8]
        assert (counter is None) == (route == "register")
    assert allocated == [((1,), torch.int64, torch.device("cpu"))] * 2
    assert ops.launches["fullzip_gather"] == n0 + 3
    assert not hasattr(ops, "fullzip_gather_slot") and not hasattr(ops, "_gather_slots")


def test_ivf_plan_at_the_main_path_shapes():
    """The search's shapes on a 132-SM card: the candidate steps run one
    block per SM and merge in one pass; the probe step (256 centroids) is
    one block that writes its rows itself."""
    for qn, n in ((1, 133_003), (8, 694_907), (4, 1_048_576)):
        p = ops.ivf_plan(qn, n, 10, 132)
        assert p["blocks"] <= 132 and p["merge_passes"] == 1 and p["stages"] == 4
        assert p["qg"] == qn and p["buf"] == 512
    p = ops.ivf_plan(4, 256, 256, 132)
    assert p["blocks"] == 1 and p["merge_passes"] == 0 and p["list_a_pairs"] == 0
    assert ops.ivf_plan(8, 5000, 1024, 132)["stages"] == 2
    with pytest.raises(ValueError):
        ops.ivf_plan(1, 10, ops.IVF_K_MAX + 1, 132)


@pytest.mark.parametrize("stride,zipped_ptr,out_ptr,route,word", [
    (1536, 0, 512, "bulk", 16),        # the main path: 16-byte aligned rows
    (16, 1024, 2048, "bulk", 16),
    (40000, 0, 0, "bulk", 16),         # rows larger than a ring slot
    (1536, 1, 0, "register", 1),       # a zipped view one byte past its base
    (1536, 8, 0, "register", 8),
    (1536, 0, 4, "register", 4),
    (24, 0, 0, "register", 8),
    (33, 0, 0, "register", 1),
    (129, 512, 512, "register", 1),
    (2, 0, 0, "register", 2),
])
def test_fullzip_plan_routes(stride, zipped_ptr, out_ptr, route, word):
    """The bulk route needs the stride and both base addresses on 16 bytes;
    otherwise the register route takes the widest word dividing all three."""
    for n_take in (1, 7, 10, 11, 1000, 16_429, 262_144):
        p = ops.fullzip_plan(n_take, stride, zipped_ptr, out_ptr, 132)
        assert (p["route"], p["word"]) == (route, word)
        if route == "bulk" and stride <= ops._GATHER_STAGE_BYTES:
            per = min(32, ops._GATHER_STAGE_BYTES // stride)
            assert p["units"] == -(-n_take // per)
        elif route == "bulk":
            assert p["units"] == n_take * -(-stride // ops._GATHER_STAGE_BYTES)
        else:
            assert p["units"] == n_take
        assert 1 <= p["grid"] <= min(p["units"], 132 * ops._GATHER_BLOCKS_PER_SM[route])


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


# ---------------------------------------------------------------------------
# miniblock_decode's slices and bitunpack's runs (the plans the kernels
# launch from, and the edge cases of their designs)
# ---------------------------------------------------------------------------


_MB_EDGES = [label for label, *_ in ref.miniblock_edge_cases(np.random.default_rng(0))]


@pytest.mark.parametrize("index", range(len(_MB_EDGES)), ids=_MB_EDGES)
def test_miniblock_edge_cases_match_pallas(index):
    """ref.miniblock_edge_cases (the card's sweep of slices, runs and slot
    tables) through the Pallas kernel and the port's CPU route."""
    label, case, kw = next(x for i, x in enumerate(
        ref.miniblock_edge_cases(np.random.default_rng(0))) if i == index)
    want = jops.miniblock_decode(*(jnp.asarray(a) for a in case), use_pallas=True, **kw)
    got = ops.miniblock_decode(*_torch_args(case), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=label)


@pytest.mark.parametrize("bits", [1, 2, 3, 7, 11, 16, 25, 31, 32])
def test_bitunpack_edge_cases_match_pallas(bits):
    """ref.bitunpack_cases at one width: tails off 4 and off 128, words
    given as exactly ceil(n * bits / 32)."""
    for label, v, words, b, offset in ref.bitunpack_cases(np.random.default_rng(bits)):
        if b != bits or offset:
            continue
        want = np.asarray(jops.bitunpack(jnp.asarray(words), len(v), bits, use_pallas=True))
        got = ops.bitunpack(torch.from_numpy(words), len(v), bits)
        np.testing.assert_array_equal(want, got.numpy(), err_msg=label)
        np.testing.assert_array_equal(v, got.numpy(), err_msg=label)


@pytest.mark.parametrize("def_bits", [0, 1, 2, 3, 4, 5, 7, 8, 16])
@pytest.mark.parametrize("slice_entries", [256, 1024])
def test_miniblock_slice_slots_match_cumsum(def_bits, slice_entries):
    """The kernel's count of valid entries before each slice (whole def
    words with popcounts for power-of-two widths, field by field otherwise:
    ref.miniblock_slice_slots) equals the plain version's cumsum(valid)."""
    tile = 4096
    rng = np.random.default_rng(def_bits * 10 + slice_entries)
    for nulls in (None, "none", "all"):
        rw, dw, vw, p = _torch_args(ref.miniblock_case(
            rng, 0, def_bits, 1, 6, tile, nulls=nulls, n_range=(1, tile)))
        _, d, _ = ref.miniblock_decode_ref(rw, dw, vw, p[:, 0], p[:, 1], p[:, 2], tile, 0,
                                           def_bits, 1, 0)
        j = torch.arange(tile)
        valid = (d == 0) & (j < p[:, :1])
        before = torch.cumsum(valid.to(torch.int64), 1) - valid.to(torch.int64)
        starts = torch.arange(0, tile, slice_entries)
        want = torch.where(p[:, :1] > starts, before[:, starts], torch.zeros(()).long())
        got = ref.miniblock_slice_slots(dw, p[:, 0], def_bits, tile, slice_entries)
        assert torch.equal(got, want)


def test_miniblock_kernel_constants_match_the_plan():
    """miniblock_plan sizes a launch with csrc/miniblock_decode.cu's runs,
    slice alignment and limit, and slot table."""
    c = _cu_constants("miniblock_decode.cu")
    assert int(c["kRun"]) * int(c["kRuns"]) == ops._MB_PER_THREAD
    assert c["kSliceAlign"] == "32 * kRun * kRuns" and ops._MB_SLICE_ALIGN == 32 * 8
    assert int(c["kMaxSlice"]) == ops.miniblock_plan(1, ops.MAX_ENTRIES, 1)["slice"]
    assert "sizeof(int32_t) * static_cast<size_t>(slice)" in c["_text"]


@pytest.mark.parametrize("C", [1, 457])
def test_miniblock_plan_covers_every_shape(C):
    """For every tile the wrapper takes (multiples of 128 up to 4,096) and
    every vpe with tile * vpe <= MAX_TILE_VALUES: the slices cover every
    entry once and start at multiples of 32 entries; CTAs are whole warps of
    at most 128 threads; the shared memory (a slot table at vpe > 1) stays
    below the 48 KB a launch takes unasked (and the SM's 227 KB)."""
    for tile in range(128, ops.MAX_ENTRIES + 1, 128):
        for vpe in range(1, ops.MAX_TILE_VALUES // tile + 1):
            p = ops.miniblock_plan(C, tile, vpe)
            sl = p["slice"]
            assert sl % 256 == 0 and sl * vpe <= 1024 or sl == 256
            assert p["slices"] * sl >= tile > (p["slices"] - 1) * sl
            assert p["blocks"] == C * p["slices"] <= (1 << 31) - 1
            assert p["threads"] * 8 == sl and p["threads"] % 32 == 0
            assert 32 <= p["threads"] <= 128
            assert p["smem"] <= 48 * 1024 <= 227 * 1024
            if vpe == 1:
                assert sl == 1024 and p["smem"] == 0
            else:
                assert p["smem"] == 4 * sl
    with pytest.raises(ValueError):
        ops.miniblock_plan(C, 4096, 64)  # past MAX_TILE_VALUES
    with pytest.raises(ValueError):
        ops.miniblock_plan(C, 1000, 1)
