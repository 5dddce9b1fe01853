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


@pytest.mark.parametrize("stride", [1, 8, 33, 129, 1536])
def test_cuda_fullzip_gather_matches_plain(cuda_device, stride):
    rng = np.random.default_rng(stride)
    zipped = torch.from_numpy(rng.integers(0, 256, (300, stride), dtype=np.uint8)).to(cuda_device)
    rows = torch.from_numpy(rng.integers(0, 300, 257).astype(np.int32)).to(cuda_device)
    n0 = ops.launches["fullzip_gather"]
    got = ops.fullzip_gather(zipped, rows)
    torch.cuda.synchronize()
    assert ops.launches["fullzip_gather"] == n0 + 1
    assert torch.equal(got, ref.fullzip_gather_ref(zipped, rows))


def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    z = torch.zeros((5, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(IndexError):
        ops.fullzip_gather(z, torch.tensor([5], dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):  # mixed devices are refused, not copied
        ops.fullzip_gather(z, torch.tensor([1], dtype=torch.int32))
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
