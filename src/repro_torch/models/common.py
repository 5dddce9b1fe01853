"""Shared model building blocks.

The port's copy of the reference's ``models/common.py``.  Parameters live in
``nn.Module``s whose names mirror the reference's param tree (a linear
layer's ``w`` is ``(d_in, d_out)`` and its optional ``b`` is ``(d_out,)``, a
norm's ``scale``, an embedding's ``w``), so ``models/convert.py`` maps one
onto the other by name.  The ``*_init_`` functions draw the reference's
distributions from an explicit ``torch.Generator``; the values differ from
JAX's, the distributions do not.

The reference's ``init_*`` functions also return a ``PartitionSpec`` tree;
the port keeps those specs as plain data, apart from the modules: a
``TensorSpec(shape, dtype)`` per leaf (``.meta()`` gives a tensor on the
``meta`` device, which allocates nothing) and a tuple of axes per leaf,
the reference's ``tuple(PartitionSpec(...))``: mesh axis names, ``None``,
tuples of names, and the logical tokens ``DP`` (the data-parallel axes)
and ``TP`` (the tensor-parallel axis).  ``dense_spec``,
``rmsnorm_spec`` and ``embed_spec`` are the specs of ``dense_init``,
``rmsnorm_init`` and ``embed_init``; ``join_specs`` nests named
(shapes, axes) pairs and ``stack_specs`` adds the leading layer axes of the
reference's ``lax.scan`` stacks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

__all__ = [
    "DP", "TP", "TensorSpec", "dense_spec", "rmsnorm_spec", "embed_spec", "stack_specs",
    "join_specs", "map_leaves",
    "Dense", "RMSNorm", "Embed", "MLP", "dense_init_", "embed_init_", "rmsnorm_init_",
    "normal_", "rmsnorm", "rope_freqs", "apply_rope", "dtype_of", "mlp_apply",
]


# logical axis tokens, the reference's (resolved by its sharding policy:
# DP to the data-parallel mesh axes, TP to "model")
DP = "__dp__"
TP = "__tp__"


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, the port's ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        """An empty tensor of this spec on the ``meta`` device (no storage)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def dense_spec(d_in: int, d_out: int, dtype, bias: bool = False, in_axis=None,
               out_axis=TP) -> Tuple[Dict, Dict]:
    """The specs of the reference's ``dense_init``: column parallel by default."""
    shapes = {"w": TensorSpec((d_in, d_out), dtype)}
    axes = {"w": (in_axis, out_axis)}
    if bias:
        shapes["b"] = TensorSpec((d_out,), dtype)
        axes["b"] = (out_axis,)
    return shapes, axes


def rmsnorm_spec(d: int, dtype) -> Tuple[Dict, Dict]:
    return {"scale": TensorSpec((d,), dtype)}, {"scale": (None,)}


def embed_spec(vocab: int, d: int, dtype) -> Tuple[Dict, Dict]:
    return {"w": TensorSpec((vocab, d), dtype)}, {"w": (TP, None)}


def map_leaves(tree: Dict, fn) -> Dict:
    """``fn`` over every leaf (non-dict value) of a nested dict."""
    return {k: map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def join_specs(**named: Tuple[Dict, Dict]) -> Tuple[Dict, Dict]:
    """{name: (shapes, axes)} -> (shapes tree, axes tree)."""
    return ({k: v[0] for k, v in named.items()}, {k: v[1] for k, v in named.items()})


def stack_specs(specs: Tuple[Dict, Dict], *lead: int) -> Tuple[Dict, Dict]:
    """(shapes, axes) of one layer -> those of ``lead`` stacked layers: each
    shape gains the leading dims ``lead``, each axes tuple a ``None`` per
    dim, as the reference's ``_stack`` (``P(None, *spec)``)."""
    shapes, axes = specs
    return (map_leaves(shapes, lambda t: TensorSpec(tuple(lead) + t.shape, t.dtype)),
            map_leaves(axes, lambda a: (None,) * len(lead) + a))


def normal_(t: torch.Tensor, generator: torch.Generator, scale: float) -> None:
    """Fill ``t`` with N(0, 1) * ``scale`` drawn in float32 on the
    generator's device, then cast to ``t``'s dtype (the reference draws in
    float32 and casts)."""
    draw = torch.randn(tuple(t.shape), generator=generator, dtype=torch.float32,
                       device=generator.device)
    with torch.no_grad():
        t.copy_(draw * scale)


def dense_init_(layer: "Dense", generator: torch.Generator,
                scale: Optional[float] = None) -> None:
    """The reference's ``dense_init``: w ~ N(0, 1/d_in) unless ``scale``; b = 0."""
    d_in = layer.w.shape[0]
    normal_(layer.w, generator, scale if scale is not None else 1.0 / (d_in ** 0.5))
    if layer.b is not None:
        with torch.no_grad():
            layer.b.zero_()


def embed_init_(layer: "Embed", generator: torch.Generator) -> None:
    normal_(layer.w, generator, 0.02)


def rmsnorm_init_(norm: "RMSNorm") -> None:
    with torch.no_grad():
        norm.scale.fill_(1.0)


class Dense(nn.Module):
    """A linear layer stored as the reference stores it: ``w`` (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int, dtype, device, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype, device=device),
                              requires_grad=False)
        self.b = (nn.Parameter(torch.empty(d_out, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)

    def init_(self, generator: torch.Generator) -> None:
        dense_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.w)
        if self.b is not None:
            y = y + self.b
        return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def init_(self, generator: torch.Generator) -> None:
        rmsnorm_init_(self)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(vocab, d, dtype=dtype, device=device),
                              requires_grad=False)

    def init_(self, generator: torch.Generator) -> None:
        embed_init_(self, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w[tokens]


class MLP(nn.Module):
    """SwiGLU FFN ``wi``/``wg``/``wo``: the reference's ``init_mlp``
    (``models/transformer.py``); MoE's shared experts are one too."""

    def __init__(self, d: int, ff: int, dtype, device):
        super().__init__()
        self.wi = Dense(d, ff, dtype, device)
        self.wg = Dense(d, ff, dtype, device)
        self.wo = Dense(ff, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    a = torch.matmul(x, p.wi.w)
    g = torch.matmul(x, p.wg.w)
    return torch.matmul(torch.nn.functional.silu(g) * a, p.wo.w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast back to the activation dtype, *then*
    multiply by ``scale`` in that dtype: two roundings, as the reference."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def rope_freqs(head_dim: int, theta: float,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    # a Python float base: a float32 scalar operand of the pow kernel, where
    # a tensor built on the card from it is a host-to-device copy that
    # waits for the card (once per attention layer and call)
    inv = 1.0 / (float(theta) ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., H, head_dim); cos/sin broadcastable to (..., 1, head_dim//2).
    Half-split rotation (not interleaved), in f32, cast back."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
