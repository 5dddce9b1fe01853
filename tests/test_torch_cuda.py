"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip without an NVIDIA GPU (a CUDA kernel has no CPU
mode).  On a machine with one, with or without JAX installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0 for the integer and byte outputs.  ``ivf_topk`` distances are
held within 1e-6 of ``|d| + |q|^2 + max |c|^2`` (the expanded form rounds at
the scale of its terms) and its ids exactly outside near ties
(``ref.ivf_topk_mismatches``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("rep_bits,def_bits", [(0, 0), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("vpe", [1, 4])
@pytest.mark.parametrize("tile,max_bits,ref_range", [(1024, 24, (-100, 100)),
                                                     (4096, 31, (1 << 30, (1 << 31) - 1))])
def test_cuda_miniblock_decode_matches_plain(cuda_device, rep_bits, def_bits, vpe, tile,
                                             max_bits, ref_range):
    rng = np.random.default_rng(rep_bits + 7 * def_bits + vpe + tile)
    case = ref.miniblock_case(rng, rep_bits, def_bits, vpe, 6, tile, max_bits, ref_range)
    args = [torch.from_numpy(a).to(cuda_device) for a in case]
    n0 = ops.launches["miniblock_decode"]
    got = ops.miniblock_decode(*args, rep_bits=rep_bits, def_bits=def_bits, vpe=vpe,
                               tile_entries=tile, fill=-3)
    torch.cuda.synchronize()
    assert ops.launches["miniblock_decode"] == n0 + 1
    want = ref.miniblock_decode_ref(args[0], args[1], args[2], args[3][:, 0], args[3][:, 1],
                                    args[3][:, 2], tile, rep_bits, def_bits, vpe, -3)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


_MB_EDGES = [label for label, *_ in ref.miniblock_edge_cases(np.random.default_rng(0))]


@pytest.mark.parametrize("index", range(len(_MB_EDGES)), ids=_MB_EDGES)
def test_cuda_miniblock_decode_edges(cuda_device, index):
    """The shapes the slices, runs, prefix counts and slot tables meet
    (ref.miniblock_edge_cases), through the launcher and the wrapper,
    tolerance 0."""
    label, case, kw = next(x for i, x in enumerate(
        ref.miniblock_edge_cases(np.random.default_rng(0))) if i == index)
    t = [torch.from_numpy(a).to(cuda_device) for a in case]
    tile, vpe, fill = kw["tile_entries"], kw["vpe"], kw["fill"]
    want = ref.miniblock_decode_ref(t[0], t[1], t[2], t[3][:, 0], t[3][:, 1], t[3][:, 2],
                                    tile, kw["rep_bits"], kw["def_bits"], vpe, fill)
    out = [torch.empty_like(w) for w in want]
    n0 = ops.launches["miniblock_decode"]
    ops.launch_miniblock_decode(*t, *out, rep_bits=kw["rep_bits"], def_bits=kw["def_bits"],
                                vpe=vpe, fill=fill)
    torch.cuda.synchronize()
    assert ops.launches["miniblock_decode"] == n0 + 1
    for w, g in zip(want, out):
        assert torch.equal(w, g), label
    for w, g in zip(want, ops.miniblock_decode(*t, **kw)):
        assert torch.equal(w, g), label


def test_cuda_miniblock_decode_refuses_misaligned_outputs(cuda_device):
    case = ref.miniblock_case(np.random.default_rng(1), 0, 1, 1, 2, 128)
    t = [torch.from_numpy(a).to(cuda_device) for a in case]
    flat = torch.empty(2 * 128 * 3 + 1, dtype=torch.int32, device=cuda_device)
    rep, dfs, vals = flat[1:].view(3, 2, 128)  # 4 bytes past a 16-byte boundary
    with pytest.raises(RuntimeError, match="miniblock_decode kernel launch failed"):
        ops.launch_miniblock_decode(*t, rep, dfs, vals, rep_bits=0, def_bits=1, vpe=1, fill=0)


@pytest.mark.parametrize("stride", [1, 8, 16, 33, 129, 1536, 16400, 40000])
@pytest.mark.parametrize("n_take", [1, 7, 257, 1001])
def test_cuda_fullzip_gather_matches_plain(cuda_device, stride, n_take):
    """Both routes (bulk for 16-byte strides, register otherwise), rows
    larger than a ring slot, n_take below the SM count and off any stage
    depth."""
    rng = np.random.default_rng(stride + n_take)
    zipped = torch.from_numpy(rng.integers(0, 256, (300, stride), dtype=np.uint8)).to(cuda_device)
    rows = torch.from_numpy(rng.integers(0, 300, n_take).astype(np.int32)).to(cuda_device)
    n0 = ops.launches["fullzip_gather"]
    got = ops.fullzip_gather(zipped, rows)
    torch.cuda.synchronize()
    assert ops.launches["fullzip_gather"] == n0 + 1
    assert torch.equal(got, ref.fullzip_gather_ref(zipped, rows))


@pytest.mark.parametrize("stride", [129, 1536])
@pytest.mark.parametrize("offset", [1, 4, 8, 16])
def test_cuda_fullzip_gather_misaligned_views(cuda_device, stride, offset):
    """A zipped view whose base is not 16-byte aligned takes the register
    route with the widest word its addresses allow, byte for byte."""
    rng = np.random.default_rng(offset)
    zipped = ref.at_offset(rng.integers(0, 256, (300, stride), dtype=np.uint8), cuda_device,
                           offset)
    assert zipped.data_ptr() % 16 == offset % 16
    rows = torch.from_numpy(rng.integers(0, 300, 257).astype(np.int32)).to(cuda_device)
    assert torch.equal(ops.fullzip_gather(zipped, rows), ref.fullzip_gather_ref(zipped, rows))


def test_cuda_fullzip_gather_heavy_duplication(cuda_device):
    rng = np.random.default_rng(9)
    zipped = torch.from_numpy(rng.integers(0, 256, (300, 1536), dtype=np.uint8)).to(cuda_device)
    for rows in (np.full(5000, 5, np.int32), np.tile(np.arange(3, dtype=np.int32), 3001)):
        rows = torch.from_numpy(rows).to(cuda_device)
        assert torch.equal(ops.fullzip_gather(zipped, rows), ref.fullzip_gather_ref(zipped, rows))


def test_cuda_fullzip_gather_sweep(cuda_device):
    """chip_smoke.py's gather sweep (ref.gather_cases), tolerance 0."""
    for label, zipped, rows, offset in ref.gather_cases(np.random.default_rng(0)):
        z = ref.at_offset(zipped, cuda_device, offset)
        r = torch.from_numpy(rows).to(cuda_device)
        assert torch.equal(ops.fullzip_gather(z, r), ref.fullzip_gather_ref(z, r)), label


def _gather_input(dev, rng, n=16429, stride=1536):
    """The take path's gather shape: ``n`` zipped rows of ``stride`` bytes."""
    return torch.from_numpy(rng.integers(0, 256, (n, stride), dtype=np.uint8)).to(dev)


def _gather_rows(dev, rng, n):
    return torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(dev)


def test_cuda_fullzip_gather_on_65_streams_at_once(cuda_device):
    """More streams than the bulk route once had work counters (64): every
    launch has its own, so no output misses or repeats a unit of rows.
    Outputs start as a sentinel, so a skipped unit shows."""
    rng = np.random.default_rng(65)
    zipped = _gather_input(cuda_device, rng)
    n = zipped.shape[0]
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in range(65)]
    for _ in range(2):
        rows = [_gather_rows(cuda_device, rng, n) for _ in streams]
        outs = [torch.full_like(zipped, 0xA5) for _ in streams]
        for st in streams:
            st.wait_stream(main)
        for st, r, o in zip(streams, rows, outs):
            with torch.cuda.stream(st):
                ops.launch_fullzip_gather(zipped, r, o)
        for st in streams:
            main.wait_stream(st)
        torch.cuda.synchronize()
        for r, o in zip(rows, outs):
            assert torch.equal(o, ref.fullzip_gather_ref(zipped, r))


def test_cuda_fullzip_gather_graph_replayed_on_another_stream(cuda_device):
    """A CUDA graph captured on stream A replays on stream B while a direct
    launch runs on A: the graph's counter is its own (captured with its
    memset from the graph's pool), so both outputs are exact, 20 times."""
    rng = np.random.default_rng(66)
    zipped = _gather_input(cuda_device, rng)
    n = zipped.shape[0]
    rows_g, rows_d = _gather_rows(cuda_device, rng, n), _gather_rows(cuda_device, rng, n)
    want_g = ref.fullzip_gather_ref(zipped, rows_g)
    want_d = ref.fullzip_gather_ref(zipped, rows_d)
    out_g, out_d = torch.full_like(zipped, 0xA5), torch.full_like(zipped, 0xA5)
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    for st in (a, b):
        st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(a):
        ops.launch_fullzip_gather(zipped, rows_g, out_g)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=a):
        out_g.fill_(0xA5)
        ops.launch_fullzip_gather(zipped, rows_g, out_g)
    torch.cuda.synchronize()
    for _ in range(20):
        with torch.cuda.stream(b):
            graph.replay()
        with torch.cuda.stream(a):
            out_d.fill_(0xA5)
            ops.launch_fullzip_gather(zipped, rows_d, out_d)
        torch.cuda.synchronize()
        assert torch.equal(out_g, want_g) and torch.equal(out_d, want_d)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    z = torch.zeros((5, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(IndexError):
        ops.fullzip_gather(z, torch.tensor([5], dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):  # mixed devices are refused, not copied
        ops.fullzip_gather(z, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(IndexError):  # the one host read sees a bad id anywhere
        ops.fullzip_gather(z, torch.tensor([0, 4, -1, 2], dtype=torch.int32, device=cuda_device))
    n0 = dict(ops.launches)
    assert ops.fullzip_gather(z, torch.zeros(0, dtype=torch.int32, device=cuda_device)).shape == (0, 16)
    assert ops.launches == n0  # an empty gather launches nothing


@pytest.mark.parametrize("bits", [1, 3, 5, 8, 11, 16, 21, 32])
@pytest.mark.parametrize("n", [1, 100, 8192, 20_000])
def test_cuda_bitunpack_matches_plain(cuda_device, bits, n):
    from repro_torch.core.compression import bitpack

    v = np.random.default_rng(bits * 100_000 + n).integers(
        0, 2 ** min(bits, 62), n, dtype=np.uint64)
    words = torch.from_numpy(ops.pack_words(bitpack(v, bits))).to(cuda_device)
    n0 = ops.launches["bitunpack"]
    got = ops.bitunpack(words, n, bits)
    torch.cuda.synchronize()
    assert ops.launches["bitunpack"] == n0 + 1
    assert torch.equal(got, ref.bitunpack_ref(words, n, bits))
    np.testing.assert_array_equal(got.cpu().numpy(), v)


@pytest.mark.parametrize("bits", range(1, 33))
def test_cuda_bitunpack_edges(cuda_device, bits):
    """Every width at n = 1, 3, 31, 33, 4,097 with exactly ceil(n * bits /
    32) words, and a words view 4 bytes past an aligned base
    (ref.bitunpack_cases), tolerance 0."""
    for label, v, words, b, offset in ref.bitunpack_cases(np.random.default_rng(bits)):
        if b != bits:
            continue
        w = ref.at_offset(words, cuda_device, offset)
        assert w.data_ptr() % 16 == offset
        n = len(v)
        got = ops.bitunpack(w, n, bits)
        assert torch.equal(got, ref.bitunpack_ref(w, n, bits)), label
        np.testing.assert_array_equal(got.cpu().numpy(), v)


def test_cuda_bitunpack_refuses_a_misaligned_output(cuda_device):
    words = torch.zeros(8, dtype=torch.uint32, device=cuda_device)
    out = torch.empty(9, dtype=torch.uint32, device=cuda_device)[1:]
    with pytest.raises(RuntimeError, match="bitunpack kernel launch failed"):
        ops.launch_bitunpack(words, out, bits=7)


@pytest.mark.parametrize("dim", [3, 64, 128, 200, 384])
@pytest.mark.parametrize("nq,nc,k", [(1, 7, 3), (5, 300, 10), (9, 129, 1), (8, 5000, 64),
                                     (3, 2000, 1024)])
def test_cuda_ivf_topk_matches_plain(cuda_device, dim, nq, nc, k):
    """Distances within 1e-6 of |d| + |q|^2 + max |c|^2; ids exact except
    inside a near tie (consecutive plain distances within that tolerance),
    where the id sets match."""
    r = np.random.default_rng(dim * 1000 + nq)
    q = torch.from_numpy(r.standard_normal((nq, dim)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(r.standard_normal((nc, dim)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(r.permutation(nc).astype(np.int32)).to(cuda_device)
    mask = torch.from_numpy(r.integers(0, 2, (nq, nc)).astype(np.uint8)).to(cuda_device)
    for m in (None, mask):
        n0 = ops.launches["ivf_topk"]
        d, w = ops.ivf_topk_tensors(q, c, ids, k, m)
        torch.cuda.synchronize()
        assert ops.launches["ivf_topk"] == n0 + 1
        wd, ww = ref.ivf_topk_ref(q, c, ids, k, m)
        mism, _ = ref.ivf_topk_mismatches(d.cpu().numpy(), w.cpu().numpy(),
                                          wd.cpu().numpy(), ww.cpu().numpy(),
                                          scale=ref.ivf_topk_scale(q, c))
        assert mism == 0


def test_cuda_ivf_topk_ties_duplicates_and_nan(cuda_device):
    dev = cuda_device
    q = torch.zeros((2, 8), device=dev)
    c = torch.zeros((1500, 8), device=dev)  # one tie across three tiles
    ids = torch.from_numpy(np.random.default_rng(0).permutation(1500).astype(np.int32)).to(dev)
    d, w = ops.ivf_topk_tensors(q, c, ids, 5)
    assert w.cpu().tolist() == [[0, 1, 2, 3, 4]] * 2 and not d.cpu().any()
    c = torch.randn((1200, 8), generator=torch.Generator().manual_seed(1)).to(dev)
    c = torch.cat([c, c[:700]])  # duplicate rows and ids in other tiles
    ids = torch.cat([torch.arange(1200), torch.arange(700)]).to(torch.int32).to(dev)
    q = torch.randn((3, 8), generator=torch.Generator().manual_seed(2)).to(dev)
    got, want = ops.ivf_topk_tensors(q, c, ids, 40), ref.ivf_topk_ref(q, c, ids, 40)
    assert ref.ivf_topk_mismatches(*(t.cpu().numpy() for t in got + want),
                                   scale=ref.ivf_topk_scale(q, c))[0] == 0
    for row in got[1].cpu().tolist():
        assert len(set(row)) == 40  # each duplicated (distance, id) pair once
    c[5, 0] = float("nan")
    mask = torch.ones((3, 1900), dtype=torch.uint8, device=dev)
    mask[0, 5] = 0
    d, w = ops.ivf_topk_tensors(q, c, ids, 7, mask)
    wd, ww = ref.ivf_topk_ref(q, c, ids, 7, mask)
    assert ref.ivf_topk_mismatches(*(t.cpu().numpy() for t in (d, w, wd, ww)),
                                   scale=ref.ivf_topk_scale(q, c[:5]))[0] == 0
    assert torch.isnan(d[1:]).all() and torch.isfinite(d[0]).all()
    mask[0, 1] = 0
    few = ops.ivf_topk_tensors(q, c[:3], ids[:3], 6, mask[:, :3])  # 2 eligible for q0
    assert (few[1][0, 2:] == ops.IVF_ID_SENTINEL).all() and torch.isinf(few[0][0, 2:]).all()
    assert (few[1][0, :2] != ops.IVF_ID_SENTINEL).all()


def test_cuda_ivf_topk_search_route_launches_the_kernel(cuda_device):
    r = np.random.default_rng(5)
    q = r.standard_normal((4, 16)).astype(np.float32)
    c = r.standard_normal((900, 16)).astype(np.float32)
    mask = r.integers(0, 2, (4, 900)).astype(bool)
    ops.reset_counts()
    d, w = ops.ivf_topk(q, c, np.arange(900) * 3, 10, mask=mask, device=cuda_device)
    assert ops.launches["ivf_topk"] == 1 and ops.fallbacks == {}
    wd, ww = ops.ivf_topk(q, c, np.arange(900) * 3, 10, mask=mask, device="cpu")
    mism, _ = ref.ivf_topk_mismatches(d, w, wd, ww, scale=ref.ivf_topk_scale(q, c))
    assert mism == 0
    ops.ivf_topk(q.astype(np.float64), c, np.arange(900), 3, device=cuda_device)
    assert ops.launches["ivf_topk"] == 1  # a counted fallback runs on the host
    assert ops.fallbacks == {"decode.fallback.ivf.non-float32": 1}


_HAZARDS = [label for label, *_ in ref.ivf_hazard_cases(np.random.default_rng(0), n=16, dim=2)]


@pytest.mark.parametrize("index", range(len(_HAZARDS)), ids=_HAZARDS)
def test_cuda_ivf_topk_threshold_hazards(cuda_device, index):
    """The threshold filter's hazards (ref.ivf_hazard_cases): candidates in
    descending distance, duplicate pairs in different blocks, queries with
    no or few eligible candidates, N below a block and off any tile, at
    k = 1, 10, 64, 256 and 1,024."""
    cases = ref.ivf_hazard_cases(np.random.default_rng(0))
    label, q, c, ids, k, mask = next(x for i, x in enumerate(cases) if i == index)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, c, ids)]
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    d, w = ops.ivf_topk_tensors(*t, k, m)
    wd, ww = ref.ivf_topk_ref(*t, k, m)
    mism, _ = ref.ivf_topk_mismatches(d.cpu().numpy(), w.cpu().numpy(), wd.cpu().numpy(),
                                      ww.cpu().numpy(), scale=ref.ivf_topk_scale(q, c))
    assert mism == 0, label
    if label.startswith("descending"):  # the k nearest are the last k rows
        assert w[0].cpu().tolist() == list(range(len(c) - 1, len(c) - 1 - min(k, len(c)), -1))
    if label.startswith("NaN row"):  # it poisons the queries it is eligible for
        assert torch.isnan(d[1:]).all() and (w[1:] == ops.IVF_ID_SENTINEL).all()
        assert torch.isfinite(d[0]).all()
    if label.startswith("no / 5 eligible"):
        assert (w[1] == ops.IVF_ID_SENTINEL).all() and torch.isinf(d[1]).all()
        assert (w[2, :5] != ops.IVF_ID_SENTINEL).all()
        assert (w[2, 5:] == ops.IVF_ID_SENTINEL).all()


def test_cuda_serve_smoke_matches_numpy_route(cuda_device):
    """The serve bench's smoke run (``tests/_torch_serve.py``) on the traced
    device route against the untraced numpy route: identical completions,
    tier stats, IO, write trace, modelled time and values; the gather
    launched; no fallback in ``ops.fallbacks`` or in the tracer."""
    import dataclasses
    import types

    import repro_torch.core.arrays as A
    import repro_torch.core.types as T
    from repro_torch.core.file import WriteOptions, write_table
    from repro_torch.dataset import DatasetWriter
    from repro_torch.obs import Tracer
    from repro_torch.serve import TenantSpec, ZipfWorkload, drive
    from repro_torch.store import TieredStore

    from _torch_serve import serve_smoke

    m = types.SimpleNamespace(A=A, T=T, WriteOptions=WriteOptions, write_table=write_table,
                              DatasetWriter=DatasetWriter, TieredStore=TieredStore,
                              TenantSpec=TenantSpec, ZipfWorkload=ZipfWorkload, drive=drive)
    tracer = Tracer()
    ops.reset_counts()
    dw, drec, dinter, dserial, _, source = serve_smoke(m, decode="device", device=cuda_device,
                                                       tracer=tracer)
    assert ops.launches["fullzip_gather"] > 0
    assert ops.fallbacks == {}
    assert tracer.metrics.counter_values("decode.fallback") == {} and tracer.events
    hw, hrec, hinter, hserial, _, _ = serve_smoke(m, decode="numpy", device="cpu")
    assert dinter.completions == hinter.completions
    assert dserial.completions == hserial.completions
    for state in (lambda w: [dataclasses.astuple(t) for t in w.tier_stats()],
                  lambda w: dataclasses.astuple(w.io_stats()),
                  lambda w: dataclasses.astuple(w.write_stats()), lambda w: w.modelled_time()):
        assert state(dw) == state(hw)
    for (rows, got), (hrows, want) in zip(drec.takes, hrec.takes):
        assert np.array_equal(rows, hrows)
        assert np.array_equal(got.values, want.values)
        assert np.array_equal(got.values, source[rows])
