"""The port's moe, ssm and hybrid LMs against the JAX package.

Whole model, at reduced_config (B = 2, S = 32): the prefill's last logits
and cache, then one decode step's logits and cache from the reference's
padded cache, converted; float32, bound 1e-4 of max |reference| (measured
on the CPU ≤ 1.9e-6, deepseek's last logits).

In bfloat16 the two packages round some elementwise ops differently (XLA
keeps products in float32 inside a fusion; its bfloat16 silu differs from
PyTorch's in about a third of the values by an ulp), and whole models of
these families amplify that past any fixed bound: a MoE router whose top-2
probabilities sit an ulp apart sends a token to another expert (deepseek's
last logits then differ by 0.29 of their maximum), and the mamba state, a
float32 sum over the sequence of bfloat16 inputs, drifts to 2.0e-2 (ssm)
and 2.2e-2 (hybrid) of its maximum after 4-5 layers.  So bfloat16 holds
their blocks to 2e-2 one at a time, each on the same input on both sides:
the mamba mixer (prefill and a decode step; measured 1.2e-2 at the ssm
config, 7.7e-3 at the hybrid's), the MoE FFN (5.4e-3 routed only, 9.4e-3
with shared experts), MLA attention (3.0e-5) and the hybrid's shared
attention block (6.0e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as r_attn
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro_torch.models import convert

from _torch_models import (TOL, configs, pad_cache, prefill_decode_case, reference_pair,
                           rel_err, tree_errs)

FAMILIES = ["grok-1-314b", "deepseek-v2-lite-16b", "mamba2-780m", "zamba2-7b"]
PARTS = ["last", "cache", "dec", "dcache"]


@functools.lru_cache(maxsize=None)
def _case(arch, dtype):
    rcfg, pcfg = configs(arch, dtype)
    return prefill_decode_case(rcfg, pcfg)


def _check(case, part, dtype):
    ref, got = case[f"ref_{part}"], case[f"port_{part}"]
    if part in ("cache", "dcache"):
        errs = tree_errs(ref, got)
        assert max(errs.values()) <= TOL[dtype], errs
    else:
        assert rel_err(ref, got) <= TOL[dtype]


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode_match_float32(arch, part):
    """moe with GQA (grok) and MLA plus shared experts (deepseek), ssm,
    hybrid (mamba + the weight-tied shared block)."""
    _check(_case(arch, "float32"), part, "float32")


# ---------------------------------------------------------------------------
# bfloat16 blocks, each on the same input on both sides
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return reference_pair(*configs(arch, "bfloat16"))


def _activation(cfg, B=2, S=32, seed=7):
    """A bfloat16 activation (B, S, d) of unit scale, on both sides."""
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)),
                    jnp.float32).astype(jnp.bfloat16)
    return x, convert.to_torch(np.asarray(x))


def _layer0(jp, key="layers"):
    return jax.tree.map(lambda a: a[0], jp[key])


def _ssm_cache_errs(ref, got):
    """rel_err of each leaf of a mamba cache {"state", "conv": {x, B, C}}."""
    return {"state": rel_err(ref["state"], got["state"]),
            **{f"conv.{k}": rel_err(ref["conv"][k], got["conv"][k]) for k in ("x", "B", "C")}}


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_mamba_mixer_matches_bfloat16(arch):
    """The mixer's prefill (chunked SSD, causal convs, gated norm) and a
    decode step from the reference's cache."""
    rm, jp, _, pm = _pair(arch)
    cfg = rm.cfg
    p0, mixer = _layer0(jp)["mamba"], pm.layers[0].mamba
    x, px = _activation(cfg)
    y, cache = jax.jit(lambda p, x: r_ssm.mamba2_apply(p, cfg, x, "prefill"))(p0, x)
    py, pcache = mixer(px, "prefill")
    assert rel_err(y, py) <= TOL["bfloat16"]
    errs = _ssm_cache_errs(cache, pcache)
    assert max(errs.values()) <= TOL["bfloat16"], errs
    x1, px1 = _activation(cfg, S=1, seed=8)
    y1, c1 = jax.jit(lambda p, x, c: r_ssm.mamba2_apply(p, cfg, x, "decode", c))(p0, x1, cache)
    pc = jax.tree.map(lambda a: convert.to_torch(np.asarray(a)), cache)
    py1, pc1 = mixer(px1, "decode", pc)
    assert rel_err(y1, py1) <= TOL["bfloat16"]
    errs = _ssm_cache_errs(c1, pc1)
    assert max(errs.values()) <= TOL["bfloat16"], errs


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-lite-16b"])
def test_moe_ffn_matches_bfloat16(arch):
    """Top-2 of 4 routed experts (grok), plus 2 shared experts (deepseek)."""
    rm, jp, _, pm = _pair(arch)
    x, px = _activation(rm.cfg)
    want, _ = jax.jit(lambda p, x: r_moe.moe_apply_reference(p, rm.cfg, x))(
        _layer0(jp)["moe"], x)
    got, _ = pm.layers[0].moe(px)
    assert rel_err(want, got) <= TOL["bfloat16"]


def test_mla_attention_matches_bfloat16():
    """deepseek's MLA: the prefill (kv up-projections, roped shared key) and
    a decode step in the absorbed form, from the reference's padded cache."""
    rm, jp, _, pm = _pair("deepseek-v2-lite-16b")
    cfg, attn = rm.cfg, pm.layers[0].attn
    p0 = _layer0(jp)["attn"]
    x, px = _activation(cfg)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    out, cache = jax.jit(lambda p, x: r_attn.mla_apply(p, cfg, x, jnp.asarray(pos), "prefill"))(
        p0, x)
    pout, pcache = attn(px, torch.from_numpy(pos.copy()), "prefill", capacity=40)
    assert rel_err(out, pout) <= TOL["bfloat16"]
    for key in ("ckv", "kpe"):
        assert rel_err(cache[key], pcache[key][:, :32]) <= TOL["bfloat16"]
    padded = {k: jnp.pad(v, ((0, 0), (0, 8), (0, 0))) for k, v in cache.items()}
    x1, px1 = _activation(cfg, S=1, seed=8)
    out1, c1 = jax.jit(lambda p, x, c: r_attn.mla_apply(
        p, cfg, x, jnp.full((2, 1), 32), "decode", {**c, "length": jnp.int32(32)}))(
        p0, x1, padded)
    pc = {k: convert.to_torch(np.asarray(v)) for k, v in padded.items()}
    pout1, pc1 = attn(px1, torch.full((2, 1), 32), "decode", pc, length=32)
    assert rel_err(out1, pout1) <= TOL["bfloat16"]
    for key in ("ckv", "kpe"):
        assert rel_err(c1[key], pc1[key]) <= TOL["bfloat16"]


def test_hybrid_shared_block_matches_bfloat16():
    """zamba2's one shared attention block (GQA + FFN), prefill then a
    decode step from the reference's padded cache."""
    rm, jp, _, pm = _pair("zamba2-7b")
    x, px = _activation(rm.cfg)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    out, cache, _ = jax.jit(lambda p, x: rm._dense_layer_apply(
        p, x, jnp.asarray(pos), "prefill", None))(jp["shared"], x)
    pout, pcache = pm.shared(px, torch.from_numpy(pos.copy()), "prefill", capacity=40)
    assert rel_err(out, pout) <= TOL["bfloat16"]
    padded = pad_cache(rm, {"mamba": {}, "shared": jax.tree.map(lambda a: a[None], cache),
                            "length": jnp.int32(32)}, 8)["shared"]
    padded = jax.tree.map(lambda a: a[0], padded)
    for key in ("k", "v"):
        assert rel_err(padded[key], pcache[key]) <= TOL["bfloat16"]
    x1, px1 = _activation(rm.cfg, S=1, seed=8)
    out1, c1, _ = jax.jit(lambda p, x, c: rm._dense_layer_apply(
        p, x, jnp.full((2, 1), 32), "decode", {**c, "length": jnp.int32(32)}))(
        jp["shared"], x1, padded)
    pc = {k: convert.to_torch(np.asarray(v)) for k, v in padded.items()}
    pout1, pc1 = pm.shared(px1, torch.full((2, 1), 32), "decode", pc, length=32)
    assert rel_err(out1, pout1) <= TOL["bfloat16"]
    for key in ("k", "v"):
        assert rel_err(c1[key], pc1[key]) <= TOL["bfloat16"]
