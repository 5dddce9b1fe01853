"""Optimizers (no external deps): AdamW and Adafactor.

The port's copy of the reference's ``train/optimizer.py``, as plain tensor
code: ``torch.optim``'s AdamW rounds differently, so each update is written
out step by step in the reference's order, in float32, with the bias
corrections as float32 scalars of ``step + 1``.

The reference optimizes its parameter tree, whose per-layer tensors are
stacked on leading layer axes, and two of its rules read the stacked leaf:
weight decay applies to leaves of two or more dims (so to every per-layer
norm scale, stacked ``(L, d)``, but not to ``final_norm``), and Adafactor
factors such leaves and clips its update by the RMS over the whole stacked
leaf, all layers at once.  The port holds one module per layer, so these
optimizers group its parameters back into the reference's leaves
(``models.convert.stacked_leaves``; vlm's ``self_layers`` carry two stack
axes) and update each group as one stacked tensor, then write the layers
back in place.  The state is kept per leaf, stacked, keyed by the leaf's
path (``models.convert.opt_state_to_reference`` maps it to the reference's
tree).  ``state_specs`` maps a parameter axes tree (``models.registry.
param_specs``) to the optimizer state's, as the reference's does with its
``PartitionSpec`` trees: the state shards like the parameters.

``params`` and ``grads`` are dicts of the port's parameter names
(``dict(model.named_parameters())``) to tensors; ``update`` changes the
parameters and the state in place and returns nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from ..models.common import map_leaves
from ..models.convert import stacked_leaves

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, step) -> None; params and state in place
    state_specs: Callable  # param axes tree -> state axes tree


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """-> (the gradients scaled by min(1, max_norm / norm), each in its own
    dtype, and the global norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


def _wd_mask(stacked: torch.Tensor) -> bool:
    # no weight decay on norms/biases/scalars: of the *stacked* leaf
    return stacked.ndim >= 2


def _stack(tree: Dict[str, torch.Tensor], shape: Tuple[int, ...], names: List[str]):
    """The reference's stacked leaf of ``names`` (an unstacked leaf as is)."""
    if not shape:
        return tree[names[0]]
    first = tree[names[0]]
    return torch.stack([tree[n] for n in names]).reshape(shape + tuple(first.shape))


def _write_back(params: Dict[str, torch.Tensor], names: List[str], new: torch.Tensor) -> None:
    shape = params[names[0]].shape
    for name, layer in zip(names, new.reshape(-1, *shape)):
        params[name].copy_(layer)


def _step_scalar(step) -> torch.Tensor:
    """``(step + 1).astype(float32)`` of the reference, as a 0-dim float32
    tensor on the host (a scalar operand on any device)."""
    return torch.tensor(int(step) + 1, dtype=torch.float32)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        state = {"m": {}, "v": {}}
        for path, (shape, names) in stacked_leaves(params).items():
            p = params[names[0]]
            for key in ("m", "v"):
                state[key][path] = torch.zeros(shape + tuple(p.shape), dtype=moment_dtype,
                                               device=p.device)
        return state

    @torch.no_grad()
    def update(grads, state, params, step):
        t = _step_scalar(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for path, (shape, names) in stacked_leaves(params).items():
            p, g = _stack(params, shape, names), _stack(grads, shape, names)
            m, v = state["m"][path], state["v"][path]
            g32 = g.float()
            m2 = b1 * m.float() + (1 - b1) * g32
            v2 = b2 * v.float() + (1 - b2) * g32 * g32
            mhat = m2 / bc1
            vhat = v2 / bc2
            step_ = mhat / (torch.sqrt(vhat) + eps)
            if _wd_mask(p):
                step_ = step_ + weight_decay * p.float()
            _write_back(params, names, (p.float() - lr * step_).to(p.dtype))
            m.copy_(m2.to(moment_dtype))
            v.copy_(v2.to(moment_dtype))

    def state_specs(param_specs):
        return {"m": param_specs, "v": param_specs}

    return Optimizer(init, update, state_specs)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments; no first moment (memory ~= params/r + params/c)."""

    def init(params):
        state = {}
        for path, (shape, names) in stacked_leaves(params).items():
            p = params[names[0]]
            full = shape + tuple(p.shape)
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=p.device)  # noqa: E731
            if len(full) >= 2:  # factored
                state[path] = {"r": zeros(full[:-1]), "c": zeros(full[:-2] + full[-1:])}
            else:
                state[path] = {"v": zeros(full)}
        return {"f": state}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = _step_scalar(step)
        beta = 1.0 - t ** (-decay)
        for path, (shape, names) in stacked_leaves(params).items():
            p, g = _stack(params, shape, names), _stack(grads, shape, names)
            s = state["f"][path]
            g32 = g.float()
            g2 = g32 * g32 + eps
            if "r" in s:
                r = beta * s["r"] + (1 - beta) * g2.mean(dim=-1)
                c = beta * s["c"] + (1 - beta) * g2.mean(dim=-2)
                rc = r.mean(dim=-1, keepdim=True)
                vhat = (r / torch.clamp(rc, min=eps))[..., None] * c[..., None, :]
                s["r"].copy_(r)
                s["c"].copy_(c)
            else:
                vhat = beta * s["v"] + (1 - beta) * g2
                s["v"].copy_(vhat)
            u = g32 / torch.sqrt(torch.clamp(vhat, min=eps))
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and _wd_mask(p):
                u = u + weight_decay * p.float()
            _write_back(params, names, (p.float() - lr * u).to(p.dtype))

    def state_specs(param_specs):
        def one(axes):
            # r drops the last dim's axis, c the second-to-last
            if len(axes) >= 2:
                return {"r": axes[:-1], "c": axes[:-2] + axes[-1:]}
            return {"v": axes}

        return {"f": map_leaves(param_specs, one)}

    return Optimizer(init, update, state_specs)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)
