"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip without an NVIDIA GPU (a CUDA kernel has no CPU
mode).  On a machine with one, with or without JAX installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0: all outputs are integers or bytes.
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
