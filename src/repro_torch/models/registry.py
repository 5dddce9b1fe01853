"""Architecture registry: config -> model builder, and the analytic counts.

The port's copy of the reference's ``models/registry.py``: ``build_model``
(with an explicit ``device`` and ``generator``), ``supports_shape``,
``param_counts`` and ``model_flops``.  The dry-run stand-ins ``input_specs``
and ``cache_specs`` (``ShapeDtypeStruct`` and ``PartitionSpec`` trees) raise:
they wait for ROADMAP.md, Queue 1 item 8c.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..kernels import ops
from .transformer import LMModel

__all__ = ["build_model", "input_specs", "cache_specs", "supports_shape", "model_flops",
           "param_counts"]

_DRYRUN = "the dry-run specs are not ported yet (ROADMAP.md, Queue 1 item 8c)"


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> LMModel:
    """An initialised model on ``device`` (CUDA unless the caller names the
    CPU; raises without a card), drawn from ``generator`` (default: one on
    the device seeded 0).  The reference's mesh, batch axes and sharded MoE
    wait for ROADMAP.md, Queue 1 item 8c."""
    dev = ops.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return LMModel(cfg, device=dev).init(generator)


def supports_shape(cfg: ModelConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic sequence mixing (task spec)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "skipped: pure full-attention arch at 500K context (DESIGN.md)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeCfg):
    raise NotImplementedError(_DRYRUN)


def cache_specs(cfg: ModelConfig, shape: ShapeCfg, dp_total: int):
    raise NotImplementedError(_DRYRUN)


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
