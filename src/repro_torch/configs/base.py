"""Model configuration dataclasses for the architecture zoo.

The port's own copy of the reference's ``configs/base.py``: every dataclass,
field and shape, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoECfg", "MLACfg", "SSMCfg", "ModelConfig", "SHAPES", "ShapeCfg"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid: period of the shared attention block (0 = none)
    shared_attn_every: int = 0
    # vlm: every Nth layer is a gated cross-attention layer (0 = none)
    cross_attn_every: int = 0
    n_vision_tokens: int = 1601
    d_vision: int = 1280
    # audio / encoder-decoder
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    d_audio: int = 80  # stub frontend feature dim
    tie_embeddings: bool = False
    # numerics / optimizer
    dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "full"  # none | full | dots
    # long-context support marker (sub-quadratic sequence mixing)
    subquadratic: bool = False

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524_288, 1),
}
