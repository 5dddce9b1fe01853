"""Assigned architecture configs (exact numbers from the task pool).

The port's own copy of the reference's ``configs/__init__.py``: the same ten
``ARCHS``, ``get_config`` and ``reduced_config``.  Vocab sizes not divisible
by a 16-wide model axis are padded up to a multiple of 256 (Megatron-style
vocab padding), as in the reference, so the two packages' shapes agree.
"""

from __future__ import annotations

from .base import MLACfg, ModelConfig, MoECfg, SHAPES, ShapeCfg, SSMCfg

__all__ = ["ARCHS", "get_config", "reduced_config", "SHAPES", "ModelConfig", "ShapeCfg"]


def _pad_vocab(v: int, m: int = 256) -> int:
    return ((v + m - 1) // m) * m


ARCHS = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# -- dense -------------------------------------------------------------------
# [hf:HuggingFaceTB/SmolLM-135M; hf] llama-arch small
_reg(ModelConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960,
    n_heads=15, n_kv_heads=5, head_dim=64, d_ff=2560, vocab=49152,
    tie_embeddings=True, optimizer="adamw", remat="none",
))

# [hf:Qwen/Qwen1.5-0.5B; hf] QKV bias
_reg(ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912, vocab=151936,
    qkv_bias=True, rope_theta=1e6,
))

# [arXiv:2407.10671; hf] GQA, QKV bias
_reg(ModelConfig(
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568, vocab=152064,
    qkv_bias=True, rope_theta=1e6, remat="dots",
))

# [hf:Qwen/Qwen1.5-0.5B; hf] QKV bias
_reg(ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, head_dim=128, d_ff=27392, vocab=152064,
    qkv_bias=True, rope_theta=1e6, remat="dots",
))

# -- ssm ----------------------------------------------------------------------
# [arXiv:2405.21060; unverified] SSD; vocab 50280 padded -> 50432 for TP
_reg(ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=_pad_vocab(50280),
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True, subquadratic=True, remat="none",
))

# -- moe ------------------------------------------------------------------------
# [hf:xai-org/grok-1; unverified] 8 experts top-2; adafactor for state memory
_reg(ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768, vocab=131072,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32768),
    optimizer="adafactor", remat="dots",
))

# [arXiv:2405.04434; hf] MLA kv_lora=512; 64 routed top-6 + 2 shared
# (the pool line's "160 routed" belongs to full V2 — see DESIGN.md §4)
_reg(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, d_ff_shared=1408),
    mla=MLACfg(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
))

# -- hybrid -----------------------------------------------------------------------
# [arXiv:2411.15242; unverified] Mamba2 backbone + weight-tied shared attn block
_reg(ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
    shared_attn_every=6, subquadratic=True,
))

# -- vlm --------------------------------------------------------------------------
# [hf:meta-llama/Llama-3.2-11B-Vision; unverified] cross-attn image layers
_reg(ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672, vocab=128256,
    cross_attn_every=5, n_vision_tokens=1601, d_vision=1280, rope_theta=5e5,
    remat="dots",
))

# -- audio ------------------------------------------------------------------------
# [arXiv:2308.11596; hf] enc-dec; vocab 256206 padded -> 256256 for TP
_reg(ModelConfig(
    name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=_pad_vocab(256206),
    enc_dec=True, n_enc_layers=12, n_dec_layers=12, d_audio=80,
))


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    import dataclasses

    cfg = ARCHS[name]
    kw = dict(
        n_layers=min(cfg.n_layers, 4), d_model=128, d_ff=256, vocab=512,
        head_dim=32,
        n_heads=4 if cfg.n_heads else 0, n_kv_heads=2 if cfg.n_kv_heads else 0,
    )
    if cfg.family == "hybrid":
        kw["n_layers"] = 5
        kw["shared_attn_every"] = 2
        kw["n_heads"], kw["n_kv_heads"] = 4, 4
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=32,
                           n_groups=1, chunk=32)
    if cfg.moe is not None:
        kw["moe"] = MoECfg(n_experts=4, top_k=2, d_ff_expert=64,
                           n_shared=cfg.moe.n_shared, d_ff_shared=64 if cfg.moe.n_shared else 0)
    if cfg.mla is not None:
        kw["mla"] = MLACfg(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    if cfg.family == "vlm":
        kw["n_layers"] = 5
        kw["cross_attn_every"] = 5
        kw["n_vision_tokens"] = 16
        kw["d_vision"] = 32
    if cfg.family == "audio":
        kw["n_enc_layers"] = 2
        kw["n_dec_layers"] = 2
        kw["d_audio"] = 16
    return dataclasses.replace(cfg, **kw)
