"""The port's dense LMs against the JAX package, and its configs, common
blocks and analytic counts.

Same weights (the reference's init, carried over by ``models/convert.py``)
and the same inputs on both sides.  Bounds are a share of max |reference|
(``_torch_models.TOL``): float32 1e-4, bfloat16 2e-2.  Measured on the CPU:
float32 ≤ 1.7e-6 on every output (smollm-360m at full width), bfloat16
≤ 1.35e-2 (reduced smollm's last logits; the prefill caches ≤ 1.1e-2, the
decode steps ≤ 1.05e-2): in bfloat16 the two packages round some
elementwise ops differently (XLA keeps products in float32 inside a
fusion), a few ulps that the layers add up.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models.registry import model_flops as r_model_flops
from repro.models.registry import param_counts as r_param_counts
from repro.models.registry import supports_shape as r_supports_shape
from repro_torch.models import attention as p_attn
from repro_torch.models import common as p_common
from repro_torch.models import convert
from repro_torch.models.registry import (cache_specs, input_specs, model_flops,
                                         param_counts, supports_shape)

from _torch_models import TOL, configs, prefill_decode_case, rel_err, tree_errs

DENSE = ["smollm-360m", "qwen1.5-4b", "qwen2-72b", "qwen1.5-32b"]
PARTS = ["last", "cache", "dec", "dcache"]


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------


def test_archs_equal_the_reference_field_by_field():
    assert list(PC.ARCHS) == list(RC.ARCHS)
    for name in RC.ARCHS:
        for full in (True, False):
            r = RC.get_config(name) if full else RC.reduced_config(name)
            p = PC.get_config(name) if full else PC.reduced_config(name)
            assert dataclasses.asdict(r) == dataclasses.asdict(p), name
            assert (r.d_inner, r.ssm_heads) == (p.d_inner, p.ssm_heads)
    assert {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()}
    assert PC._pad_vocab(50280) == RC._pad_vocab(50280) == 50432


@pytest.mark.parametrize("arch", list(RC.ARCHS))
def test_param_counts_and_flops_equal_the_reference(arch):
    r, p = RC.get_config(arch), PC.get_config(arch)
    assert param_counts(p) == r_param_counts(r)
    for shape in RC.SHAPES:
        assert model_flops(p, PC.SHAPES[shape]) == r_model_flops(r, RC.SHAPES[shape])
        assert supports_shape(p, PC.SHAPES[shape]) == r_supports_shape(r, RC.SHAPES[shape])


def test_smollm_param_count():
    """361,758,720 by ``param_counts``; the port's module holds the 65 norm
    scales of 960 that the count leaves out (2 layers here: 5 norms)."""
    assert param_counts(PC.get_config("smollm-360m")) == (361_758_720, 361_758_720)
    _, cfg = configs("smollm-360m", "bfloat16", reduced=False, n_layers=2)
    from repro_torch.models import LMModel

    model = LMModel(cfg, device="cpu")
    held = sum(p.numel() for p in model.parameters())
    assert held == param_counts(cfg)[0] + (2 * 2 + 1) * 960


def test_dryrun_specs_raise_naming_their_item():
    """The dry-run specs, once cut (item 8c), are plain data now: smollm's
    train input and decode cache at full size, sharded as the reference's
    (tests/test_torch_sharding_specs.py holds every cell against it)."""
    cfg = PC.get_config("smollm-360m")
    spec, axes = input_specs(cfg, PC.SHAPES["train_4k"])["tokens"]
    assert spec.shape == (256, 4_097) and spec.dtype == torch.int32 and axes == (p_common.DP, None)
    shapes, axes = cache_specs(cfg, PC.SHAPES["decode_32k"], 16)
    assert shapes["layers"]["k"].shape == (32, 128, 32_768, 5 * 64)
    assert axes["layers"]["k"] == (None, p_common.DP, None, p_common.TP)
    assert shapes["length"].shape == () and axes["length"] == ()
    assert shapes["layers"]["v"].meta().is_meta


# ---------------------------------------------------------------------------
# common blocks and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 7, 4, 64)) * 3, jnp.float32).astype(dtype)
    scale = jnp.asarray(1 + 0.1 * rng.standard_normal(64), jnp.float32).astype(dtype)
    px, ps = convert.to_torch(np.asarray(x)), convert.to_torch(np.asarray(scale))
    got = p_common.rmsnorm(px, ps, 1e-5)
    assert got.dtype == px.dtype
    assert rel_err(r_common.rmsnorm(x, scale, 1e-5), got) <= {"float32": 1e-6, "bfloat16": 1e-2}[dtype]
    pos = np.arange(7)[None].repeat(2, 0)
    for theta in (1e4, 1e6):
        rc, rs = r_common.rope_freqs(64, theta, jnp.asarray(pos))
        pc, psn = p_common.rope_freqs(64, theta, torch.from_numpy(pos))
        assert rel_err(rc, pc) < 1e-6 and rel_err(rs, psn) < 1e-6
        want = r_common.apply_rope(x, rc[:, :, None], rs[:, :, None])
        got = p_common.apply_rope(px, pc[:, :, None], psn[:, :, None])
        assert rel_err(want, got) < {"float32": 1e-5, "bfloat16": 1e-2}[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,hkv,kv_len", [
    (True, 64, 64, 2, None), (False, 48, 256, 4, 200), (True, 128, 128, 1, None)])
def test_flash_and_decode_attention_match(dtype, causal, sq, sk, hkv, kv_len):
    """Blockwise attention with small chunks (several tiles each way, the
    online-softmax rescale between them) and the decode path's masked
    softmax, against the reference's on the same inputs."""
    rng = np.random.default_rng(3)
    H, D = 4, 32
    q = jnp.asarray(rng.standard_normal((2, sq, H, D)), jnp.float32).astype(dtype)
    k = jnp.asarray(rng.standard_normal((2, sk, hkv, D)), jnp.float32).astype(dtype)
    v = jnp.asarray(rng.standard_normal((2, sk, hkv, D)), jnp.float32).astype(dtype)
    kw = dict(causal=causal, q_chunk=16, k_chunk=32)
    want = r_attn.flash_attention(q, k, v, kv_len=None if kv_len is None else jnp.int32(kv_len),
                                  **kw)
    pq, pk, pv = (convert.to_torch(np.asarray(a)) for a in (q, k, v))
    got = p_attn.flash_attention(pq, pk, pv, kv_len=kv_len, **kw)
    bound = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert rel_err(want, got) < bound
    length = sk - 5
    want = r_attn.decode_attention(q[:, :1], k, v, jnp.full((2,), length))
    got = p_attn.decode_attention(pq[:, :1], pk, pv, length)
    assert rel_err(want, got) < bound


def test_flash_attention_ragged_last_tile_equals_one_tile():
    """A length that is not a multiple of the chunk (which the reference
    asserts against) gets a shorter last tile: the same values as one tile
    over the whole length, within float32 rounding."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 37, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 37, 2, 16)).astype(np.float32))
    ragged = p_attn.flash_attention(q, k, k, causal=True, q_chunk=16, k_chunk=16)
    whole = p_attn.flash_attention(q, k, k, causal=True, q_chunk=64, k_chunk=64)
    assert rel_err(whole, ragged) < 1e-6


def test_decode_cache_write_raises_at_capacity():
    buf = torch.zeros((2, 4, 8))
    p_attn.cache_write(buf, torch.ones((2, 1, 8)), 3)
    assert float(buf[:, 3].sum()) == 16
    with pytest.raises(IndexError, match="capacity 4"):
        p_attn.cache_write(buf, torch.ones((2, 1, 8)), 4)


# ---------------------------------------------------------------------------
# the dense family, whole model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _case(arch, dtype, n_layers=None):
    """One prefill + decode on both packages per (arch, dtype), shared by
    the tests of its four outputs: reduced_config at B = 2, S = 32, or the
    full config cut to ``n_layers`` at B = 1, S = 16."""
    if n_layers is None:
        rcfg, pcfg = configs(arch, dtype)
        return prefill_decode_case(rcfg, pcfg, B=2, S=32)
    rcfg, pcfg = configs(arch, dtype, reduced=False, n_layers=n_layers)
    return prefill_decode_case(rcfg, pcfg, B=1, S=16)


def _check(case, part, dtype):
    ref, got = case[f"ref_{part}"], case[f"port_{part}"]
    if part in ("cache", "dcache"):
        errs = tree_errs(ref, got)
        assert max(errs.values()) <= TOL[dtype], errs
    else:
        assert rel_err(ref, got) <= TOL[dtype]


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_decode_match(arch, dtype, part):
    """Prefill's last logits and cache, then one decode step's logits and
    cache, at reduced_config (qwen: QKV bias, rope_theta 1e6)."""
    _check(_case(arch, dtype), part, dtype)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smollm_full_width_two_layers_match(dtype, part):
    """smollm-360m at full width (15 heads over 5 KV heads of 64, d_ff
    2,560, the tied 49,152-row unembedding), 2 layers, B = 1, S = 16."""
    _check(_case("smollm-360m", dtype, n_layers=2), part, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smollm_full_width_second_decode_step_matches(dtype):
    """A second decode step, from each package's own first step."""
    from _torch_models import make_batch, pad_cache, reference_pair, to_port, to_ref

    rcfg, pcfg = configs("smollm-360m", dtype, reduced=False, n_layers=2)
    rm, jp, _, pm = reference_pair(rcfg, pcfg)
    batch = make_batch(rcfg, 1, 16)
    r_last, r_cache = jax.jit(rm.prefill)(jp, to_ref(batch))
    r_cache = pad_cache(rm, r_cache, 8)
    p_last, p_cache = pm.prefill(to_port(batch), capacity=24)
    step = jax.jit(rm.decode_step)
    for _ in range(2):
        tok = np.array(jnp.argmax(r_last, -1)[:, None].astype(jnp.int32))
        r_last, r_cache = step(jp, r_cache, jnp.asarray(tok))
        p_last, p_cache = pm.decode_step(p_cache, torch.from_numpy(tok))
    assert p_cache["length"] == int(r_cache["length"]) == 18
    assert rel_err(r_last, p_last) <= TOL[dtype]
    errs = tree_errs(jax.tree.map(np.asarray, r_cache), convert.cache_to_reference(pcfg, p_cache))
    assert max(errs.values()) <= TOL[dtype], errs
