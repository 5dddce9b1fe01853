"""Shared helpers of the port's LM parity tests (tests/test_torch_models_*.py,
tests/test_torch_engine.py).

The JAX package initialises a model's parameters; ``reference_pair`` carries
them into the port through ``repro_torch.models.convert``, after moving the
leaves that init leaves constant (norm scales 1, biases 0, the cross-attention
gates 0, which would multiply the whole cross-attention path by tanh(0) = 0,
and mamba's ``A_log``/``dt_bias`` 0) to seeded random values, so that every
parameter reaches the outputs the tests compare.  Inputs are made with numpy
from a seed.  Both packages then see exactly the same weights and inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as r_get_config
from repro.configs import reduced_config as r_reduced_config
from repro.models.registry import build_model as r_build_model
from repro_torch.configs import get_config as p_get_config
from repro_torch.configs import reduced_config as p_reduced_config
from repro_torch.models import LMModel, convert

# float32 and bfloat16 parity bounds, as a share of max |reference|
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def perturb(tree, seed: int = 0):
    """numpy copy of a param tree with the constant-at-init leaves drawn
    from ``seed`` (norm scales 1 + 0.1 N, biases / A_log / dt_bias 0.1 N,
    gates 0.7)."""
    rng = np.random.default_rng(seed)

    def leaf(name, a):
        a = np.asarray(a)
        if name == "scale":
            return (a.astype(np.float32) * (1 + 0.1 * rng.standard_normal(a.shape))).astype(a.dtype)
        if name == "gate":
            return np.full(a.shape, 0.7, a.dtype)
        if name in ("b", "A_log", "dt_bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return np.array(a)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in t.items()}

    return walk(tree)


def configs(arch: str, dtype: str, reduced: bool = True, **replace):
    """(reference config, port config), the same fields on both sides."""
    r = (r_reduced_config if reduced else r_get_config)(arch)
    p = (p_reduced_config if reduced else p_get_config)(arch)
    return (dataclasses.replace(r, dtype=dtype, **replace),
            dataclasses.replace(p, dtype=dtype, **replace))


def reference_pair(rcfg, pcfg, seed: int = 0, data_size: int = 16):
    """-> (reference model, its params (jnp), their numpy tree, the port's
    model on the CPU holding the same weights).  ``data_size`` is the
    reference's expert tiling (MoE): 1 holds each expert once, as the port
    does, so gradients and optimizer states map one to one."""
    rm = r_build_model(rcfg, data_size=data_size)
    params, _ = rm.init(jax.random.PRNGKey(seed))
    tree = perturb(jax.tree.map(np.asarray, params), seed)
    pm = LMModel(pcfg, device="cpu")
    missing = pm.load_state_dict(convert.params_from_reference(pcfg, tree), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return rm, jax.tree.map(jnp.asarray, tree), tree, pm


def make_batch(cfg, B: int, S: int, seed: int = 1):
    """numpy inputs of the reference's tests: tokens in [1, vocab), and the
    vlm's vision embeddings / the audio model's frames in the config's dtype."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_vision))
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_audio))
    return {k: v if k == "tokens" else np.array(jnp.asarray(v, jnp.float32).astype(cfg.dtype))
            for k, v in b.items()}


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: convert.to_torch(v) for k, v in batch.items()}


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def rel_err(ref, got) -> float:
    """max |ref - got| / max |ref| (0 when both are 0)."""
    r, g = as_f32(ref), as_f32(got)
    assert r.shape == g.shape, (r.shape, g.shape)
    scale = float(np.abs(r).max())
    err = float(np.abs(r - g).max())
    return err / scale if scale else err


def tree_errs(ref_tree, got_tree):
    """{leaf path: rel_err} over two trees of one structure."""
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    assert [p for p, _ in ref_flat] == [p for p, _ in got_flat]
    return {jax.tree_util.keystr(p): rel_err(a, b)
            for (p, a), (_, b) in zip(ref_flat, got_flat)}


def pad_cache(rm, cache, extra: int):
    """The reference engine's own padding of a prefill cache."""
    from repro.serve.engine import BatchedEngine

    return BatchedEngine(rm, None)._pad_cache(cache, extra)


def prefill_decode_case(rcfg, pcfg, B: int = 2, S: int = 32, pad: int = 8, seed: int = 0):
    """Prefill and one decode step on both packages.  The port prefills into
    a cache of S + pad positions, the reference pads its prefill cache by
    ``pad`` (its engine's ``_pad_cache``), so the two caches have one shape.
    The decode step runs on both from the *reference's* padded cache,
    converted, so it is held to its own rounding only.  Returns numpy/jnp
    results keyed ref_*/port_*."""
    rm, jp, _, pm = reference_pair(rcfg, pcfg, seed)
    batch = make_batch(rcfg, B, S, seed + 1)
    r_last, r_cache = jax.jit(rm.prefill)(jp, to_ref(batch))
    p_last, p_cache = pm.prefill(to_port(batch), capacity=S + pad)
    r_pad = pad_cache(rm, r_cache, pad)
    nxt = np.array(jnp.argmax(r_last, -1)[:, None].astype(jnp.int32))
    r_pad_np = jax.tree.map(np.asarray, r_pad)
    r_dec, r_dcache = jax.jit(rm.decode_step)(jp, r_pad, jnp.asarray(nxt))
    p_dec, p_dcache = pm.decode_step(convert.cache_from_reference(pcfg, r_pad_np),
                                     torch.from_numpy(nxt))
    return {
        "ref_last": r_last, "port_last": p_last,
        "ref_cache": jax.tree.map(np.asarray, r_pad),
        "port_cache": convert.cache_to_reference(pcfg, p_cache),
        "ref_dec": r_dec, "port_dec": p_dec,
        "ref_dcache": jax.tree.map(np.asarray, r_dcache),
        "port_dcache": convert.cache_to_reference(pcfg, p_dcache),
    }
