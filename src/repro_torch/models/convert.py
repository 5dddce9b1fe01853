"""Weights and caches between the JAX reference's layout and the port's.

The reference keeps a model's parameters as a nested dict whose layers are
stacked on leading axes; the port keeps one module per layer.  This module
maps one layout onto the other, for the parity tests and to load the
reference's weights, on numpy leaves (``np.asarray`` of each JAX array;
bfloat16 leaves are ``ml_dtypes`` arrays, read through their uint16 bits).

The parameter mapping (reference tree path -> port state-dict name):

* ``embed.w``, ``unembed.w``, ``final_norm.scale``, ``vis_proj.w``,
  ``audio_proj.w`` and hybrid's ``shared.*`` (the one weight-tied attention
  block, applied ``n_layers // shared_attn_every`` times) keep their names;
* ``layers``, ``enc_layers``, ``dec_layers`` and ``cross_layers`` are
  stacked ``(L, ...)``: leaf ``layers.attn.q.w`` of shape ``(L, d, f)``
  becomes ``layers.{i}.attn.q.w`` of shape ``(d, f)`` for each ``i``;
* vlm's ``self_layers`` are stacked ``(n_cross, period - 1, ...)`` and
  become ``self_layers.{g}.{j}.*``;
* a MoE layer's routed experts ``moe.wi``/``wg``/``wo`` are stored
  ``expert_slots(n_experts, data_size)`` deep in the reference, each expert
  repeated ``slots / n_experts`` times; the port keeps the first
  ``n_experts`` (the repeats must equal them) and the inverse tiles them
  back;
* every weight keeps the reference's ``(d_in, d_out)`` orientation; no
  transpose.

Caches map the same way: the reference's stacked ``(L, B, S, F)`` arrays
(``(n_cross, period - 1, B, S, F)`` for vlm's self caches) become the
port's per-layer lists, and ``length`` an int.

Gradients are keyed like the parameters, so ``params_to_reference`` and
``params_from_reference`` map them too (with ``data_size=1`` for MoE: a
tiled reference's unused expert replicas get zero gradients, which the
port does not hold).  ``stacked_leaves`` groups the port's parameter names
into the reference's stacked leaves; the port's optimizers
(``train/optimizer.py``) keep their state per such leaf, already stacked,
and ``opt_state_to_reference`` / ``opt_state_from_reference`` map it to the
reference's optimizer-state tree and back.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .moe import expert_slots

__all__ = ["params_from_reference", "params_to_reference", "cache_from_reference",
           "cache_to_reference", "stacked_leaves", "opt_state_to_reference",
           "opt_state_from_reference", "to_torch", "to_numpy"]

# stacked parameter groups and how many leading layer axes each has
_PARAM_STACKS = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "cross_layers": 1,
                 "self_layers": 2}
_EXPERTS = ("wi", "wg", "wo")


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf (bfloat16 included) as a torch tensor of the same dtype,
    on a copy (a JAX array's numpy view is read-only)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same dtype; bfloat16 needs numpy to
    know the type (``ml_dtypes``, which the JAX package loads)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def _flatten(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat: Dict[tuple, object]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _is_expert(rest: tuple) -> bool:
    return len(rest) == 2 and rest[0] == "moe" and rest[1] in _EXPERTS


def params_from_reference(cfg, tree: Dict) -> Dict[str, torch.Tensor]:
    """The reference's param tree (numpy leaves) -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(tree):
        a = np.asarray(a)
        depth = _PARAM_STACKS.get(path[0], 0)
        rest = path[1:]
        if depth == 0:
            out[".".join(path)] = to_torch(a)
            continue
        for idx in np.ndindex(*a.shape[:depth]):
            leaf = a[idx]
            if _is_expert(rest):
                E = cfg.moe.n_experts
                reps = leaf.shape[0] // E
                if not all(np.array_equal(leaf[r * E:(r + 1) * E], leaf[:E])
                           for r in range(1, reps)):
                    raise ValueError(f"{'.'.join(path)}: expert replicas differ")
                leaf = leaf[:E]
            name = ".".join((path[0], *map(str, idx), *rest))
            out[name] = to_torch(leaf)
    return out


def params_to_reference(cfg, state: Dict[str, torch.Tensor], data_size: int = 16) -> Dict:
    """The port's state dict -> the reference's param tree (numpy leaves),
    experts tiled to ``expert_slots(n_experts, data_size)``."""
    groups: Dict[tuple, Dict[tuple, np.ndarray]] = {}
    flat: Dict[tuple, np.ndarray] = {}
    for name, t in state.items():
        parts = name.split(".")
        depth = _PARAM_STACKS.get(parts[0], 0)
        a = to_numpy(t)
        if depth == 0:
            flat[tuple(parts)] = a
            continue
        idx = tuple(int(p) for p in parts[1:1 + depth])
        rest = tuple(parts[1 + depth:])
        if _is_expert(rest):
            a = np.tile(a, (expert_slots(cfg.moe.n_experts, data_size) // a.shape[0], 1, 1))
        groups.setdefault((parts[0],) + rest, {})[idx] = a
    for path, by_idx in groups.items():
        shape = tuple(max(i[k] for i in by_idx) + 1 for k in range(len(next(iter(by_idx)))))
        leaves = [by_idx[i] for i in np.ndindex(*shape)]
        flat[path] = np.stack(leaves).reshape(shape + leaves[0].shape)
    return _nest(flat)


def stacked_leaves(names: Iterable[str]) -> Dict[str, Tuple[Tuple[int, ...], List[str]]]:
    """The reference's leaves over the port's parameter names, in the order
    each leaf first appears: ``{leaf path: (stack shape, names)}``.  A leaf
    path is the reference's tree path joined by dots (``layers.attn.q.w``);
    the stack shape is its leading layer axes (``(L,)``, ``(n_cross,
    period - 1)`` for vlm's ``self_layers``, ``()`` for an unstacked leaf);
    ``names`` lists the port's per-layer names in ``np.ndindex`` order of
    that shape (``layers.0.attn.q.w``, ``layers.1.attn.q.w``, ...)."""
    by_leaf: Dict[str, Dict[tuple, str]] = {}
    for name in names:
        parts = name.split(".")
        depth = _PARAM_STACKS.get(parts[0], 0)
        idx = tuple(int(q) for q in parts[1:1 + depth])
        path = ".".join((parts[0], *parts[1 + depth:]))
        by_leaf.setdefault(path, {})[idx] = name
    out = {}
    for path, by_idx in by_leaf.items():
        depth = len(next(iter(by_idx)))
        shape = tuple(max(i[k] for i in by_idx) + 1 for k in range(depth))
        if len(by_idx) != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: layers {sorted(by_idx)} do not fill {shape}")
        out[path] = (shape, [by_idx[i] for i in np.ndindex(*shape)])
    return out


def opt_state_to_reference(state: Dict) -> Dict:
    """The port's optimizer state (``{"m": {leaf path: tensor}, ...}`` for
    adamw, ``{"f": {leaf path: {"r", "c"} | {"v"}}}`` for adafactor) ->
    the reference's optimizer-state tree (numpy leaves)."""
    out = {}
    for key, leaves in state.items():
        flat = {}
        for path, v in leaves.items():
            base = tuple(path.split("."))
            if isinstance(v, dict):
                flat.update({base + (sub,): to_numpy(t) for sub, t in v.items()})
            else:
                flat[base] = to_numpy(v)
        out[key] = _nest(flat)
    return out


def opt_state_from_reference(tree: Dict, device: Optional[torch.device] = None) -> Dict:
    """The reference's optimizer-state tree -> the port's, on ``device``.
    Adafactor's per-leaf ``{"r", "c"}`` / ``{"v"}`` dicts (under ``"f"``)
    stay dicts under their leaf's path."""
    device = torch.device("cpu") if device is None else device
    out: Dict = {}
    for key, sub in tree.items():
        leaves: Dict = {}
        for path, a in _flatten(sub):
            t = to_torch(np.asarray(a)).to(device)
            if key == "f":
                leaves.setdefault(".".join(path[:-1]), {})[path[-1]] = t
            else:
                leaves[".".join(path)] = t
        out[key] = leaves
    return out


def _cache_depths(cfg) -> Dict[str, int]:
    if cfg.family in ("dense", "moe", "ssm"):
        return {"layers": 1}
    if cfg.family == "hybrid":
        return {"mamba": 1, "shared": 1}
    if cfg.family == "vlm":
        return {"self": 2, "cross": 1}
    return {"self": 1, "cross": 1}


def _stack_tree(x, depth: int):
    """A nested list (``depth`` deep) of dicts of tensors -> a dict of
    stacked numpy arrays."""
    if depth == 0:
        return {k: _stack_tree(v, 0) for k, v in x.items()} if isinstance(x, dict) \
            else to_numpy(x)
    items = [_stack_tree(e, depth - 1) for e in x]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    return stack(*items)


def _unstack_tree(x, depth: int, device):
    if depth == 0:
        return {k: _unstack_tree(v, 0, device) for k, v in x.items()} if isinstance(x, dict) \
            else to_torch(np.asarray(x)).to(device)
    first = x
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n = np.asarray(first).shape[0]

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)[i]

    return [_unstack_tree(take(x, i), depth - 1, device) for i in range(n)]


def cache_to_reference(cfg, cache: Dict) -> Dict:
    """The port's cache -> the reference's stacked cache (numpy leaves,
    the port's capacity on the sequence axis)."""
    out = {k: _stack_tree(cache[k], d) for k, d in _cache_depths(cfg).items()}
    out["length"] = np.int32(cache["length"])
    return out


def cache_from_reference(cfg, tree: Dict, device: Optional[torch.device] = None) -> Dict:
    """The reference's (padded) cache -> the port's, on ``device``; the
    padded sequence axis becomes the port's capacity."""
    device = torch.device("cpu") if device is None else device
    out = {k: _unstack_tree(tree[k], d, device) for k, d in _cache_depths(cfg).items()}
    out["length"] = int(np.asarray(tree["length"]))
    return out
