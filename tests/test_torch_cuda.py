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


_TAKES = [label for label, *_ in ref.miniblock_take_cases(np.random.default_rng(0))]


@pytest.mark.parametrize("index", range(len(_TAKES)), ids=_TAKES)
def test_cuda_miniblock_take_matches_plain(cuda_device, index):
    """The kernel against its plain version over ``ref.miniblock_take_cases``
    (def widths counted word by word and field by field, value widths 1 to
    31, FoR wrap-around, vpe up to 32, chunk ends, duplicates, one row, rows
    past their chunk), tolerance 0."""
    label, case, kw = list(ref.miniblock_take_cases(np.random.default_rng(0)))[index]
    t = [torch.from_numpy(a).to(cuda_device) for a in case]
    n0 = ops.launches["miniblock_take"]
    got = ops.miniblock_take(*t, **kw)
    torch.cuda.synchronize()
    assert ops.launches["miniblock_take"] == n0 + 1
    want = ref.miniblock_take_words_ref(*t, kw["def_bits"], kw["vpe"], kw["fill"])
    assert torch.equal(got, want), label
    with pytest.raises(ValueError):  # mixed devices are refused, not copied
        ops.miniblock_take(*t[:3], t[3].cpu(), **kw)


def test_cuda_dataset_take_selects_flat_dates_on_the_card(cuda_device):
    """A device-route take of 256 rows over 6 fragments of flat int32 dates
    equals the numpy route; each fragment launches ``miniblock_take`` once,
    decodes no chunk whole and copies one tensor back."""
    from repro_torch.core import arrays as A
    from repro_torch.core import types as T
    from repro_torch.core.file import WriteOptions
    from repro_torch.dataset.manifest import write_fragments
    from repro_torch.dataset.reader import DatasetReader

    rng = np.random.default_rng(26)
    n, frags = 600_000, 6
    col = A.PrimitiveArray(T.Primitive("int32", nullable=False), np.ones(n, bool),
                           rng.integers(8036, 10561, n).astype(np.int32))
    files = write_fragments({"c": col}, frags, WriteOptions("lance", decode="device"))
    rows = rng.choice(n, 256, replace=False)
    want = DatasetReader(files, decode="numpy", device="cpu").take("c", rows)
    reader = DatasetReader(files, device=cuda_device)
    reader.take("c", rows[:8])  # first launches
    ops.reset_counts()
    got = reader.take("c", rows)
    assert ops.launches["miniblock_take"] == frags and ops.launches["miniblock_decode"] == 0
    assert ops.copies["d2h"] == frags and ops.fallbacks == {}
    assert np.array_equal(want.validity, got.validity)
    assert np.array_equal(want.values, got.values) and np.array_equal(got.values, col.values[rows])


def test_cuda_miniblock_decode_refuses_misaligned_outputs(cuda_device):
    case = ref.miniblock_case(np.random.default_rng(1), 0, 1, 1, 2, 128)
    t = [torch.from_numpy(a).to(cuda_device) for a in case]
    flat = torch.empty(2 * 128 * 3 + 1, dtype=torch.int32, device=cuda_device)
    rep, dfs, vals = flat[1:].view(3, 2, 128)  # 4 bytes past a 16-byte boundary
    with pytest.raises(RuntimeError, match="miniblock_decode kernel launch failed"):
        ops.launch_miniblock_decode(*t, rep, dfs, vals, rep_bits=0, def_bits=1, vpe=1, fill=0)


@pytest.mark.parametrize("stride", [1, 8, 16, 33, 129, 1536, 16400, 40000, 81920])
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


def test_cuda_paged_kv_cache_gathers_81920_byte_rows(cuda_device):
    """smollm-360m's K pool (320 bf16 features: 81,920-byte block rows,
    five 16 KB ring slots each, the gather's chunked bulk route): every
    gather launches the kernel once and equals the plain version on the same
    store and the appended values rounded to bf16, tolerance 0."""
    from repro_torch.serve import PagedKVCache

    rng = np.random.default_rng(11)
    kv = PagedKVCache(n_blocks=64, kv_features=320, device=cuda_device)
    assert kv.store.view(torch.uint8).shape[1] == 81920
    plan = ops.fullzip_plan(7, 81920, kv.store.data_ptr(), 0,
                            torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert plan["route"] == "bulk" and plan["units"] == 7 * 5
    mirror = {}
    for rid, n in enumerate((1, 127, 128, 129, 900, 2000)):
        x = rng.standard_normal((n, 320)).astype(np.float32)
        kv.add_request(rid)
        kv.append(rid, x)
        mirror[rid] = torch.from_numpy(x).to(torch.bfloat16)
    kv.release(2)
    del mirror[2]
    kv.add_request(9)
    x = rng.standard_normal((300, 320)).astype(np.float32)
    kv.append(9, x)
    mirror[9] = torch.from_numpy(x).to(torch.bfloat16)
    for rid, want in mirror.items():
        n0 = ops.launches["fullzip_gather"]
        got = kv.gather(rid)
        assert ops.launches["fullzip_gather"] == n0 + 1
        table = torch.from_numpy(kv.block_table(rid)).to(cuda_device)
        plain = ref.fullzip_gather_ref(kv.store.view(torch.uint8), table)
        assert torch.equal(plain.view(torch.bfloat16).reshape(-1, 320)[: len(want)], got)
        assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def test_cuda_token_loader_scans_through_the_decode_kernel(cuda_device):
    """A token file written for the device route scans through
    ``miniblock_decode`` on the card with no fallback; the batches equal
    the numpy route's."""
    from repro_torch.core.file import WriteOptions, write_table
    from repro_torch.data import TokenLoader, synth

    corpus = synth.token_corpus(256, 2048, 49_152, seed=4)
    files = [write_table({"tokens": corpus}, WriteOptions("lance", decode=d))
             for d in ("device", "numpy")]
    ops.reset_counts()
    dev = TokenLoader(files[0], batch=8, seq_len=2048, seed=3, device=cuda_device)
    host = TokenLoader(files[1], batch=8, seq_len=2048, seed=3, device="cpu")
    try:
        for _ in range(4):
            a, b = next(dev)["tokens"], next(host)["tokens"]
            assert a.dtype == np.int32 and a.shape == (8, 2049)
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(dev.batch_for_step(5)["tokens"],
                                      host.batch_for_step(5)["tokens"])
    finally:
        dev.close()
        host.close()
    assert ops.launches["miniblock_decode"] > 0 and ops.fallbacks == {}


# ---------------------------------------------------------------------------
# the LM serving path: the engine on the card against the CPU
# ---------------------------------------------------------------------------


def _lm_pair(arch, device, dtype="bfloat16"):
    """The same weights on the card (``dtype``) and on the CPU (float32)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import LMModel, build_model

    cfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    card = build_model(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    host = LMModel(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    host.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()})
    return cfg, card, host


def _lm_batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_vision))
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_audio))
    return b


def _on(batch, device, dtype):
    return {k: torch.as_tensor(v, device=device).to(dtype) if k != "tokens"
            else torch.as_tensor(v, device=device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-72b", "grok-1-314b",
                                  "deepseek-v2-lite-16b", "mamba2-780m", "zamba2-7b",
                                  "llama-3.2-vision-90b", "seamless-m4t-medium"])
def test_cuda_lm_prefill_and_decode_match_the_cpu(cuda_device, arch):
    """bf16 on the card against float32 on the CPU, same weights: the last
    logits within 0.06 of their max (the reference's consistency bound), and
    the card's own decode step within 0.06 of its full forward."""
    cfg, card, host = _lm_pair(arch, cuda_device)
    batch = _lm_batch(cfg, 2, 32)
    last, cache = card.prefill(_on(batch, cuda_device, torch.bfloat16), capacity=40)
    want, _ = host.prefill(_on(batch, "cpu", torch.float32))
    err = float((last.float().cpu() - want).abs().max() / want.abs().max())
    assert err < 0.06, err
    nxt = last.argmax(-1)[:, None].to(torch.int32)
    step, _ = card.decode_step(cache, nxt)
    full = card({**_on(batch, cuda_device, torch.bfloat16),
                 "tokens": torch.cat([torch.as_tensor(batch["tokens"], device=cuda_device), nxt],
                                     1)})[:, -1].float()
    err = float((step.float() - full).abs().max() / full.abs().max())
    assert err < 0.06, err


def test_cuda_engine_generates_on_the_card_as_on_the_cpu(cuda_device):
    """Greedy tokens, float32 on the card (TF32 off) and on the CPU, equal;
    and the engine raises for a model on another device."""
    from repro_torch.serve import BatchedEngine

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, card, host = _lm_pair("smollm-360m", cuda_device, dtype="float32")
    prompts = _lm_batch(cfg, 2, 16)["tokens"]
    got = BatchedEngine(card, device=cuda_device).generate({"tokens": prompts}, n_new=8)
    want = BatchedEngine(host, device="cpu").generate({"tokens": prompts}, n_new=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    with pytest.raises(ValueError, match="the model is on"):
        BatchedEngine(host, device=cuda_device)


def test_cuda_launch_serve_fetches_through_the_gather(cuda_device):
    from repro_torch.launch import serve

    ops.reset_counts()
    out = serve.run(docs=500, batch=2, new=4, device=cuda_device, verbose=False)
    assert ops.launches["fullzip_gather"] > 0 and not ops.fallbacks
    assert out["generate"]["tokens"].shape == (2, 4)


# ---------------------------------------------------------------------------
# training: the train step on the card against the CPU, and the driver
# ---------------------------------------------------------------------------


def _train_grads(model, batch):
    from repro_torch.train import loss_and_grads

    loss, _, grads = loss_and_grads(model, batch)
    return float(loss), {n: g.float().cpu() for n, g in grads.items()}


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-72b", "mamba2-780m", "zamba2-7b",
                                  "llama-3.2-vision-90b", "seamless-m4t-medium"])
def test_cuda_loss_and_gradients_match_the_cpu(cuda_device, arch):
    """bf16 on the card against float32 on the CPU, same weights: the loss
    within 2e-2 nats and each gradient tensor's cosine with the CPU's at
    least 0.99 (chip_smoke.py's train bounds)."""
    cfg, card, host = _lm_pair(arch, cuda_device)
    batch = _lm_batch(cfg, 2, 32)
    batch["tokens"] = np.random.default_rng(2).integers(1, cfg.vocab, (2, 33)).astype(np.int32)
    loss_c, grads_c = _train_grads(card, _on(batch, cuda_device, torch.bfloat16))
    loss_h, grads_h = _train_grads(host, _on(batch, "cpu", torch.float32))
    assert abs(loss_c - loss_h) < 2e-2, (loss_c, loss_h)
    for name, h in grads_h.items():
        c = grads_c[name]
        if float(h.norm()) == 0.0:
            assert float(c.abs().max()) == 0.0, name
            continue
        cos = float((c * h).sum() / (c.norm() * h.norm()))
        assert cos >= 0.99, (name, cos)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_cuda_optimizer_matches_the_cpu(cuda_device, name):
    """Two float32 updates on the card and on the CPU from the same weights
    and gradients: every parameter within 1e-6 of its tensor's max |value|."""
    from repro_torch.train import clip_by_global_norm, make_optimizer

    cfg, _, host = _lm_pair("grok-1-314b", cuda_device, dtype="float32")
    rng = np.random.default_rng(0)
    grads = [{k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
              for k, p in host.named_parameters()} for _ in range(2)]
    opt = make_optimizer(name, lr=1e-2)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = {k: v.detach().clone().to(dev) for k, v in host.named_parameters()}
        state = opt.init(params)
        for step, g in enumerate(grads):
            clipped, _ = clip_by_global_norm({k: v.to(dev) for k, v in g.items()}, 1.0)
            opt.update(clipped, state, params, step)
        out[dev.type] = {k: v.cpu() for k, v in params.items()}
    for k, want in out["cpu"].items():
        err = float((out["cuda"][k] - want).abs().max() / want.abs().max())
        assert err <= 1e-6, (k, err)


def test_cuda_launch_train_scans_through_the_decode_kernel(cuda_device):
    """launch.train on the card: every step's batch comes from the
    device-route token file through miniblock_decode, with no fallback."""
    from repro_torch.launch import train

    ops.reset_counts()
    loss, last = train.train("smollm-360m", steps=3, batch=2, seq=64, device=cuda_device)
    assert np.isfinite(loss) and last == 3
    assert ops.launches["miniblock_decode"] >= 3 and not ops.fallbacks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_one_rank_nccl_sharded_moe_matches_moe(cuda_device, dtype):
    """moe_apply_sharded on a world-1 NCCL mesh against MoE on the same
    card, reduced deepseek-v2-lite (MLA, shared experts) at capacity
    slots / top_k (nothing can drop): float32 within 1e-5 of max |out|,
    bfloat16 within 2e-2; then the LMModel with the flag on and off."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_apply_sharded, shard_moe_params

    cfg = reduced_config("deepseek-v2-lite-16b")
    big = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    cfg = dataclasses.replace(cfg, dtype=str(dtype).removeprefix("torch."), moe=big)
    mesh = make_host_mesh(cuda_device)
    try:
        assert dist.get_backend() == "nccl"
        model = build_model(cfg, mesh, data_size=1, use_sharded_moe=False, device=cuda_device)
        moe = model.layers[0].moe
        x = torch.randn((2, 64, cfg.d_model), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1)).to(dtype)
        with torch.no_grad():
            want, _ = moe(x)
            got, aux = moe_apply_sharded(shard_moe_params(moe, mesh), cfg, x, mesh)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert float(aux["dropped"]) == 0.0
        err = float((want.float() - got.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())
        tokens = torch.randint(1, cfg.vocab, (2, 32), device=cuda_device)
        plain = model({"tokens": tokens})
        model.use_sharded_moe = True
        sharded = model({"tokens": tokens})
        assert torch.isfinite(sharded.float()).all()
        if dtype == torch.float32:
            assert float((plain - sharded).abs().max()) <= 1e-4 * float(plain.abs().max())
    finally:
        dist.destroy_process_group()


def test_cuda_one_rank_nccl_sharded_moe_backward_matches_moe(cuda_device):
    """The sharded MoE's backward on a world-1 NCCL mesh: reduced
    deepseek-v2-lite in float32 at capacity 11.0 (nothing can drop),
    ``train.loss_and_grads`` with the flag on against off on the same card
    and weights (loss within 1e-5 relative, each gradient within 1e-4 of its
    tensor's max, the float32 bounds of tests/test_torch_train.py); then two
    bf16 adamw steps with the flag on stay finite."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train import loss_and_grads, make_optimizer, make_train_step

    cfg = reduced_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=11.0))
    batch = {"tokens": np.random.default_rng(4).integers(1, cfg.vocab, (2, 33)).astype(np.int32)}
    mesh = make_host_mesh(cuda_device)
    try:
        assert dist.get_backend() == "nccl"
        f32 = dataclasses.replace(cfg, dtype="float32")
        model = build_model(f32, mesh, data_size=1, use_sharded_moe=True, device=cuda_device)
        s_loss, _, s_grads = loss_and_grads(model, batch)
        model.use_sharded_moe = False
        u_loss, _, u_grads = loss_and_grads(model, batch)
        assert abs(float(s_loss) - float(u_loss)) <= 1e-5 * abs(float(u_loss))
        for name, want in u_grads.items():
            err = float((s_grads[name] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, err)
        model = build_model(cfg, mesh, data_size=1, use_sharded_moe=True, device=cuda_device)
        opt = make_optimizer("adamw")
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt)
        for i in range(2):
            metrics = step(state, batch, i)
            assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["miniblock", "fullzip"])
def test_cuda_take_copies_and_steps(cuda_device, kind):
    """``ops.copies`` counts the take's round trips to the card: 4 copies
    in and 1 out a mini-block fragment (its rows selected on the card), 2 in
    and 1 out a full-zip take; the
    tracer's steps name them, and change no answer; under a profiler, a
    reader without a tracer gives them to the step recorder."""
    from repro_torch.core import arrays as A
    from repro_torch.core import types as T
    from repro_torch.core.file import WriteOptions
    from repro_torch.dataset.manifest import write_fragments
    from repro_torch.dataset.reader import DatasetReader
    from repro_torch.obs import Tracer

    rng = np.random.default_rng(25)
    if kind == "miniblock":
        n, frags, per_fragment = 300_000, 3, 5
        col = A.PrimitiveArray(T.Primitive("int32", nullable=False), np.ones(n, bool),
                               rng.integers(8000, 10600, n).astype(np.int32))
    else:
        n, frags, per_fragment = 2000, 1, 3
        t = T.FixedSizeList(T.Primitive("float32", nullable=False), 768, nullable=True)
        col = A.FixedSizeListArray(t, rng.random(n) > 0.1,
                                   rng.standard_normal((n, 768)).astype(np.float32))
    files = write_fragments({"c": col}, frags, WriteOptions("lance", decode="device"))
    rows = rng.choice(n, 256, replace=False)
    plain = DatasetReader(files, device="cpu").take("c", rows)
    tr = Tracer(steps=True)
    reader = DatasetReader(files, device=cuda_device, tracer=tr)
    before = dict(ops.copies)
    got = reader.take("c", rows)
    moved = {k: ops.copies[k] - before[k] for k in before}
    assert moved["h2d"] + moved["d2h"] == per_fragment * frags
    assert moved["d2h"] == frags
    totals = tr.step_totals()
    assert totals["device.h2d"][0] == totals["device.d2h"][0] == frags
    launch = "device.miniblock_take" if kind == "miniblock" else "device.fullzip_gather"
    assert totals[launch][0] == frags
    events = [e for e in tr.events if e.get("cat") == "step"]
    assert sum(e["args"]["bytes"] for e in events if e["name"] == "device.h2d") == \
        moved["h2d_bytes"]
    assert sum(e["args"]["bytes"] for e in events if e["name"] == "device.d2h") == \
        moved["d2h_bytes"]
    assert np.array_equal(plain.validity, got.validity)
    assert np.array_equal(plain.values, got.values)
    # a reader with no tracer, under a profiler: the recorder counts the copies
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import PROFILER_STEPS

    untraced = DatasetReader(files, device=cuda_device)
    untraced.take("c", rows)
    with profile(activities=[ProfilerActivity.CPU]):
        untraced.take("c", rows)
    assert PROFILER_STEPS.metrics.counter_values()["ops.copies"] == per_fragment * frags
    assert PROFILER_STEPS.step_totals()[launch][0] == frags
