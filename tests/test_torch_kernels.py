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
    assert ops.launches == {"miniblock_decode": 0, "fullzip_gather": 0}


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
