"""Architecture registry: config -> model builder, input and cache specs,
and the analytic counts.

The port's copy of the reference's ``models/registry.py``: ``build_model``
(with the reference's mesh, batch axes, data size and sharded-MoE flag, and
an explicit ``device`` and ``generator``), ``supports_shape``,
``input_specs``, ``cache_specs``, ``param_counts`` and ``model_flops``, and
``param_specs`` (the spec tree of the reference's ``LMModel.init``).

The dry-run stand-ins are plain data: where the reference gives
``jax.ShapeDtypeStruct`` leaves and ``PartitionSpec`` trees, the port gives
``TensorSpec(shape, dtype)`` leaves (``.meta()`` makes a tensor on the
``meta`` device, allocating nothing) and tuples of axes equal to the
reference's ``tuple(PartitionSpec)``, with its logical tokens ``DP`` and
``TP``.  Modality frontends are stubs as in the reference: the VLM receives
precomputed patch embeddings, the audio model precomputed frame embeddings.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..kernels import ops
from .attention import gqa_cache_spec, mla_cache_spec
from .common import DP, TensorSpec, map_leaves
from .ssm import mamba2_cache_spec
from .transformer import LMModel, param_specs

__all__ = ["build_model", "input_specs", "cache_specs", "param_specs", "supports_shape",
           "model_flops", "param_counts"]


def build_model(cfg: ModelConfig, mesh=None, batch_axes=("data",), data_size: int = 16,
                use_sharded_moe: bool = False, *, device=None,
                generator: Optional[torch.Generator] = None) -> LMModel:
    """An initialised model on ``device`` (CUDA unless the caller names the
    CPU; raises without a card), drawn from ``generator`` (default: one on
    the device seeded 0).  ``mesh``, ``batch_axes``, ``data_size`` and
    ``use_sharded_moe`` are the reference's (``LMModel``)."""
    dev = ops.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return LMModel(cfg, device=dev, mesh=mesh, use_sharded_moe=use_sharded_moe,
                   data_size=data_size, batch_axes=batch_axes).init(generator)


def supports_shape(cfg: ModelConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic sequence mixing (task spec)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "skipped: pure full-attention arch at 500K context (DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Tuple[TensorSpec, tuple]]:
    """{input name: (TensorSpec, axes)} of every model input of a cell."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    out: Dict[str, Tuple[TensorSpec, tuple]] = {}
    if shape.kind == "train":
        out["tokens"] = (TensorSpec((B, S + 1), torch.int32), (DP, None))
    elif shape.kind == "prefill":
        out["tokens"] = (TensorSpec((B, S), torch.int32), (DP, None))
    else:  # decode: one new token against a cache of length S
        out["tokens"] = (TensorSpec((B, 1), torch.int32), (DP, None))
    if cfg.family == "vlm" and shape.kind != "decode":
        out["vision_embeds"] = (TensorSpec((B, cfg.n_vision_tokens, cfg.d_vision), dt),
                                (DP, None, None))
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = (TensorSpec((B, S, cfg.d_audio), dt), (DP, None, None))
    return out


# ---------------------------------------------------------------------------
# caches (for decode dry-runs and the serving engine)
# ---------------------------------------------------------------------------


def _lead(tree, n: int = 1):
    """Every axes tuple of ``tree`` with ``n`` leading ``None`` axes."""
    return map_leaves(tree, lambda a: (None,) * n + a)


def _mamba_shapes(cfg, L, B, dt):
    s = cfg.ssm
    H, Pd, N = cfg.ssm_heads, s.head_dim, s.d_state
    di, GN, K1 = cfg.d_inner, s.n_groups * s.d_state, s.d_conv - 1
    return {"state": TensorSpec((L, B, H, N, Pd), torch.float32),
            "conv": {"x": TensorSpec((L, B, K1, di), dt), "B": TensorSpec((L, B, K1, GN), dt),
                     "C": TensorSpec((L, B, K1, GN), dt)}}


def _kv(lead, B, S, f, dt):
    return {"k": TensorSpec(lead + (B, S, f), dt), "v": TensorSpec(lead + (B, S, f), dt)}


def cache_specs(cfg: ModelConfig, shape: ShapeCfg, dp_total: int):
    """-> (TensorSpec tree, axes tree) of the decode cache, in the
    reference's stacked layout.

    ``dp_total``: number of chips on the batch axes; batches smaller than it
    flip the cache to sequence sharding (SP / flash-decoding combine)."""
    B, S = shape.global_batch, shape.seq_len
    L = cfg.n_layers
    dt = getattr(torch, cfg.dtype)
    batch_sharded = B >= dp_total and B % dp_total == 0
    length = TensorSpec((), torch.int32)
    f = cfg.n_kv_heads * cfg.head_dim

    if cfg.family in ("dense", "moe"):
        if cfg.mla is not None:
            m = cfg.mla
            shapes = {"layers": {"ckv": TensorSpec((L, B, S, m.kv_lora_rank), dt),
                                 "kpe": TensorSpec((L, B, S, m.qk_rope_dim), dt)},
                      "length": length}
            return shapes, {"layers": _lead(mla_cache_spec(cfg, batch_sharded)), "length": ()}
        return ({"layers": _kv((L,), B, S, f, dt), "length": length},
                {"layers": _lead(gqa_cache_spec(cfg, batch_sharded)), "length": ()})

    if cfg.family == "ssm":
        return ({"layers": _mamba_shapes(cfg, L, B, dt), "length": length},
                {"layers": _lead(mamba2_cache_spec(cfg, batch_sharded)), "length": ()})

    if cfg.family == "hybrid":
        n_shared = cfg.n_layers // cfg.shared_attn_every
        shapes = {"mamba": _mamba_shapes(cfg, L, B, dt), "shared": _kv((n_shared,), B, S, f, dt),
                  "length": length}
        return shapes, {"mamba": _lead(mamba2_cache_spec(cfg, batch_sharded)),
                        "shared": _lead(gqa_cache_spec(cfg, batch_sharded)), "length": ()}

    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1
        aspec = gqa_cache_spec(cfg, batch_sharded)
        shapes = {"self": _kv((n_cross, per), B, S, f, dt),
                  "cross": _kv((n_cross,), B, cfg.n_vision_tokens, f, dt), "length": length}
        return shapes, {"self": _lead(aspec, 2), "cross": _lead(aspec), "length": ()}

    if cfg.family == "audio":
        L = cfg.n_dec_layers
        aspec = gqa_cache_spec(cfg, batch_sharded)
        shapes = {"self": _kv((L,), B, S, f, dt), "cross": _kv((L,), B, S, f, dt),
                  "length": length}
        return shapes, {"self": _lead(aspec), "cross": _lead(aspec), "length": ()}

    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# analytic parameter / FLOP counts
# ---------------------------------------------------------------------------


def param_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(total_params, active_params) — active differs for MoE.  As in the
    reference, norm scales (and the mamba and cross-attention scalars) are
    not counted."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = V * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        if cfg.mla is not None:
            m = cfg.mla
            return (d * H * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                    + H * m.v_head_dim * d)
        return d * H * hd * 2 + d * Hkv * hd * 2

    def mlp_params(f=ff):
        return 3 * d * f

    def mamba_params():
        s = cfg.ssm
        di, GN, Hs = cfg.d_inner, s.n_groups * s.d_state, cfg.ssm_heads
        return 2 * d * di + 2 * d * GN + d * Hs + di * d + s.d_conv * (di + 2 * GN)

    total = active = embed
    fam = cfg.family
    if fam == "dense":
        per = attn_params() + mlp_params()
        total += cfg.n_layers * per
        active = total
    elif fam == "moe":
        m = cfg.moe
        routed = 3 * d * m.d_ff_expert
        shared = 3 * d * (m.d_ff_shared or 0) * m.n_shared if m.n_shared else 0
        per_total = attn_params() + m.n_experts * routed + shared + d * m.n_experts
        per_active = attn_params() + m.top_k * routed + shared + d * m.n_experts
        total += cfg.n_layers * per_total
        active += cfg.n_layers * per_active
    elif fam == "ssm":
        total += cfg.n_layers * mamba_params()
        active = total
    elif fam == "hybrid":
        total += cfg.n_layers * mamba_params()
        total += attn_params() + mlp_params()  # shared block counted once
        # but APPLIED n_shared times: active compute counts applications
        n_shared = cfg.n_layers // cfg.shared_attn_every
        active = embed + cfg.n_layers * mamba_params() + n_shared * (attn_params() + mlp_params())
    elif fam == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - n_cross
        total += n_self * (attn_params() + mlp_params())
        total += n_cross * (attn_params() + mlp_params())
        total += cfg.d_vision * d
        active = total
    elif fam == "audio":
        total += cfg.n_enc_layers * (attn_params() + mlp_params())
        total += cfg.n_dec_layers * (2 * attn_params() + mlp_params())
        total += cfg.d_audio * d
        active = total
    return int(total), int(active)


def model_flops(cfg: ModelConfig, shape: ShapeCfg) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for train;
    2·N·D for prefill; 2·N_active per token for decode."""
    total, active = param_counts(cfg)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # decode: one token per request
