"""Mixture-of-Experts FFN: exact top-k routing on one device.

The port's copy of the reference's ``moe_apply_reference`` (``models/moe.py``)
and its routing.  The reference stores each expert ``expert_slots / n_experts``
times, for expert parallelism over a data axis; the port shards nothing, so
it holds each expert once (``models/convert.py`` drops the replicas and tiles
them back).  The expert-parallel ``moe_apply_sharded`` (``shard_map`` and
all-to-all) is not carried: it raises, naming ROADMAP.md, Queue 1 item 8c.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from .common import MLP, normal_

__all__ = ["MoE", "expert_slots", "routing", "moe_apply_sharded"]


def expert_slots(n_experts: int, data_size: int) -> int:
    """Physical expert slots = lcm-style padding up to the data axis size
    (the reference's layout; the converter uses it)."""
    if n_experts >= data_size:
        if n_experts % data_size:
            raise ValueError(f"{n_experts} experts do not divide over {data_size}")
        return n_experts
    if data_size % n_experts:
        raise ValueError(f"{n_experts} experts do not tile {data_size} slots")
    return data_size


def routing(x2d: torch.Tensor, router_w: torch.Tensor, n_experts: int,
            top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d (T, d) -> (top-k expert ids (T,k), gates (T,k), aux loss).

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` promises no order, so this takes a stable descending
    sort."""
    logits = torch.matmul(x2d.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing aux loss
    me = probs.mean(dim=0)
    ce = torch.bincount(ids.reshape(-1), minlength=n_experts).float() / ids.numel()
    aux = n_experts * torch.sum(me * ce)
    return ids, gates, aux


def moe_apply_sharded(*args, **kwargs):
    raise NotImplementedError(
        "moe_apply_sharded (expert parallelism over a mesh) is not ported yet "
        "(ROADMAP.md, Queue 1 item 8c)")


class _Router(nn.Module):
    def __init__(self, d: int, n_experts: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d, n_experts, dtype=torch.float32, device=device),
                              requires_grad=False)

    def init_(self, generator: torch.Generator) -> None:
        normal_(self.w, generator, 0.02)


class MoE(nn.Module):
    """Routed experts ``wi``/``wg``/``wo`` (E, d_in, d_out), a float32
    ``router``, and the optional ``shared`` experts (one FFN of
    ``n_shared * d_ff_shared``): the reference's ``init_moe``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
        self.cfg = cfg
        self.router = _Router(d, E, device)
        ew = lambda d_in, d_out: nn.Parameter(  # noqa: E731
            torch.empty(E, d_in, d_out, dtype=dtype, device=device), requires_grad=False)
        self.wi, self.wg, self.wo = ew(d, f), ew(d, f), ew(f, d)
        self.shared = (MLP(d, m.n_shared * (m.d_ff_shared or m.d_ff_expert), dtype, device)
                       if m.n_shared else None)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.wi, self.wg, self.wo):
            normal_(w, generator, 1.0 / (w.shape[1] ** 0.5))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """The reference's ``moe_apply_reference``: every token's top-k
        experts, no capacity drop.  Computed by expert (each expert's tokens
        in one matmul) where the reference gathers a (T, d, f) weight per
        token; each token's k outputs still add in k order, in float32."""
        m = self.cfg.moe
        B, S, d = x.shape
        T = B * S
        x2 = x.reshape(T, d)
        ids, gates, aux = routing(x2, self.router.w, m.n_experts, m.top_k)
        out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        for k in range(m.top_k):
            o = torch.empty((T, d), dtype=x.dtype, device=x.device)
            for e in range(m.n_experts):
                tok = torch.nonzero(ids[:, k] == e, as_tuple=True)[0]
                xe = x2[tok]
                a = torch.matmul(xe, self.wi[e])
                g = torch.matmul(xe, self.wg[e])
                o[tok] = torch.matmul(torch.nn.functional.silu(g) * a, self.wo[e])
            out = out + o.float() * gates[:, k][:, None]
        out = out.to(x.dtype).reshape(B, S, d)
        if self.shared is not None:
            out = out + self.shared(x)
        return out, {"aux": aux, "dropped": torch.zeros((), device=x.device)}
