"""Mixture-of-Experts FFN: exact top-k routing on one device, and expert
parallelism over ``torch.distributed``.

The port's copy of the reference's ``models/moe.py``.  ``MoE.forward`` is the
reference's ``moe_apply_reference``: every token's top-k experts, no
capacity drop.  The reference stores each expert ``expert_slots / n_experts``
times, for expert parallelism over a data axis; the module holds each expert
once (``models/convert.py`` drops the replicas and tiles them back), and
``shard_moe_params`` cuts a rank's slices of the tiled layout from it as
views.

``moe_apply_sharded`` is the reference's expert-parallel path (GShard-style
dispatch, ``moe.py:92``), step for step, over a
``torch.distributed.device_mesh.DeviceMesh`` of dims ``("data", "model")``
in place of ``shard_map``: experts live on the data axis, each expert's FFN
width on the model axis.  Its collectives are the reference's:

* ``all_to_all(tiled)`` over data (dispatch, return) -> ``all_to_all_single``;
* ``psum_scatter(scatter_dimension=2, tiled)`` over model (the row-parallel
  ``wo``) -> ``reduce_scatter_tensor``, with d made the leading axis first;
* ``all_gather(axis=1, tiled)`` over model -> ``all_gather_into_tensor``;
* ``psum`` of the shared experts over model -> ``all_reduce``.

Each collective is a ``torch.autograd.Function`` whose backward is its
transpose, the rule ``jax.vjp`` applies to the matching ``lax`` collective
inside the reference's ``shard_map`` (``check_vma=False``): ``all_to_all``
back, an ``all_gather`` for the reduce-scatter, a reduce-scatter for the
``all_gather``, an ``all_reduce`` for the ``all_reduce``.  So a rank's
backward gives its share of the gradient of the sum of every rank's
objective, the reference's per-shard gradient; ``shard_map``'s own
boundary rules (an output's cotangent divided by the mesh axes its spec
leaves out, an input's summed over them) are the train step's
(``train.train_loop``), which averages every gradient over the mesh.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .common import DP, MLP, TP, TensorSpec, dense_spec, join_specs, normal_

__all__ = ["MoE", "expert_slots", "routing", "moe_apply_sharded", "shard_moe_params",
           "moe_param_specs"]


def expert_slots(n_experts: int, data_size: int) -> int:
    """Physical expert slots = lcm-style padding up to the data axis size
    (the reference's layout; the converter and the sharded path use it)."""
    if n_experts >= data_size:
        if n_experts % data_size:
            raise ValueError(f"{n_experts} experts do not divide over {data_size}")
        return n_experts
    if data_size % n_experts:
        raise ValueError(f"{n_experts} experts do not tile {data_size} slots")
    return data_size


def moe_param_specs(cfg, dtype, data_size: int = 16):
    """The spec half of the reference's ``init_moe``: the routed experts
    ``expert_slots(n_experts, data_size)`` deep (the reference's tiled
    storage, where the module holds each expert once), sharded over
    ``data`` by slot and over TP by FFN width."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    slots = expert_slots(m.n_experts, data_size)
    shapes = {"router": {"w": TensorSpec((d, m.n_experts), torch.float32)},
              "wi": TensorSpec((slots, d, f), dtype), "wg": TensorSpec((slots, d, f), dtype),
              "wo": TensorSpec((slots, f, d), dtype)}
    axes = {"router": {"w": (None, None)}, "wi": ("data", None, TP),
            "wg": ("data", None, TP), "wo": ("data", TP, None)}
    if m.n_shared:
        fs = m.n_shared * (m.d_ff_shared or m.d_ff_expert)
        shapes["shared"], axes["shared"] = join_specs(
            wi=dense_spec(d, fs, dtype, in_axis=DP), wg=dense_spec(d, fs, dtype, in_axis=DP),
            wo=dense_spec(fs, d, dtype, in_axis=TP, out_axis=DP))
    return shapes, axes


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


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0; its transpose is
    itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _ReduceScatter(torch.autograd.Function):
    """``reduce_scatter_tensor`` (sum) of dim 0's blocks; its transpose is
    ``all_gather_into_tensor``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = torch.empty((n * g.shape[0], *g.shape[1:]), dtype=g.dtype, device=g.device)
        dist.all_gather_into_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """``all_gather_into_tensor`` along dim 0; its transpose is
    ``reduce_scatter_tensor`` (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = torch.empty((g.shape[0] // n, *g.shape[1:]), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllReduce(torch.autograd.Function):
    """``all_reduce`` (sum), in place on its input; its transpose is
    itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.mark_dirty(x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _groups(mesh, mesh_axes):
    data_axis, model_axis = mesh_axes
    dg, mg = mesh.get_group(data_axis), mesh.get_group(model_axis)
    return dg, mg, dist.get_world_size(dg), dist.get_world_size(mg)


def moe_apply_sharded(params, cfg, x, mesh, mesh_axes=("data", "model")):
    """Expert-parallel MoE on one rank of ``mesh``: -> (the local output
    (B_l, S_l, d), {"aux", "dropped"} of this rank's tokens).

    ``x`` is the rank's (B_l, S_l, d) activation shard (replicated over the
    model axis).  ``params`` holds the rank's slices in the reference's
    layout (``shard_moe_params``): ``wi``/``wg`` (slots_local, d, f_local),
    ``wo`` (slots_local, f_local, d), ``router.w`` whole, and ``shared``'s
    ``wi``/``wg`` column- and ``wo`` row-parallel.  Each slot takes at most
    ``C = ceil(T * top_k * capacity_factor / slots)`` of this rank's tokens
    in (token, k) order; the rest are dropped, and ``dropped`` is their
    share.  ``aux`` and ``dropped`` are this rank's own values (the
    reference returns one shard's).  Differentiable: see the module
    docstring for what a rank's backward computes."""
    m = cfg.moe
    dg, mg, data_size, model_size = _groups(mesh, mesh_axes)
    slots = expert_slots(m.n_experts, data_size)
    reps = slots // m.n_experts
    slots_local = slots // data_size
    B, S, d = x.shape
    T, k = B * S, m.top_k
    x2 = x.reshape(T, d)
    ids, gates, aux = routing(x2, params["router"]["w"], m.n_experts, k)

    # expert -> physical slot, spread over the replicas by token parity
    tok = torch.arange(T, device=x.device)[:, None]
    slot = ids * reps + tok % reps
    C = int(max(1, -(-T * k * m.capacity_factor // slots)))
    # each (token, k)'s position in its slot, the reference's exclusive
    # cumsum of one-hots in flattened (token, k) order: its rank among its
    # slot's entries after a stable sort by slot (a cumsum down the (T*k,
    # slots) one-hots is one thread per slot on the card)
    flat_slot = slot.reshape(-1)
    order = torch.sort(flat_slot, stable=True).indices
    counts = torch.bincount(flat_slot, minlength=slots)
    starts = torch.cumsum(counts, 0) - counts
    my_pos = torch.empty_like(flat_slot)
    my_pos[order] = torch.arange(flat_slot.numel(), device=x.device) - starts[flat_slot[order]]
    keep = my_pos < C
    dropped = 1.0 - keep.float().mean()
    src_tok = tok.expand(T, k).reshape(-1)  # flattened (token, k) order

    # the send buffer (slots, C, d); the kept (slot, position) pairs are unique
    send = torch.zeros((slots, C, d), dtype=x.dtype, device=x.device)
    send[flat_slot[keep], my_pos[keep]] = x2[src_tok[keep]]
    # dispatch: slot block j goes to data rank j; the received leading axis
    # enumerates the source ranks of this rank's slots
    recv = _AllToAll.apply(send, dg)
    hh = (recv.reshape(data_size, slots_local, C, d).transpose(0, 1)
          .reshape(slots_local, data_size * C, d))
    a = torch.bmm(hh, params["wi"])
    g = torch.bmm(hh, params["wg"])
    o = torch.bmm(torch.nn.functional.silu(g) * a, params["wo"]).to(x.dtype)
    # complete the row-parallel product with a reduce-scatter along d (the
    # reference's §Perf C2); reduce_scatter_tensor splits dim 0, so d leads
    ds = d // model_size
    part = _ReduceScatter.apply(o.permute(2, 0, 1).contiguous(), mg)
    o = (part.permute(1, 2, 0).reshape(slots_local, data_size, C, ds).transpose(0, 1)
         .reshape(slots, C, ds).contiguous())
    # the return trip, d-sliced
    back = _AllToAll.apply(o, dg)
    # combine: each token's k slot outputs weighted by its gates, added in
    # float32 in k order: the order of the reference's scatter-add
    # (.at[src_tok].add) on the host and of MoE.forward, where a CUDA
    # index_add_ adds in no fixed order and moves bf16 roundings
    out_tok = back[flat_slot, torch.where(keep, my_pos, 0)]
    out_tok = torch.where(keep[:, None], out_tok, 0).reshape(T, k, ds)
    combined = torch.zeros((T, ds), dtype=torch.float32, device=x.device)
    for j in range(k):
        combined = combined + out_tok[:, j].float() * gates[:, j][:, None]
    gathered = _AllGather.apply(combined.to(x.dtype), mg)
    out = gathered.reshape(model_size, T, ds).permute(1, 0, 2).reshape(B, S, d)

    if "shared" in params:
        # the shared experts: a plain TP FFN (wi/wg column-, wo row-parallel)
        sh = params["shared"]
        a = torch.matmul(x, sh["wi"]["w"])
        g = torch.matmul(x, sh["wg"]["w"])
        so = torch.matmul(torch.nn.functional.silu(g) * a, sh["wo"]["w"])
        out = out + _AllReduce.apply(so, mg)
    return out, {"aux": aux, "dropped": dropped}


def shard_moe_params(moe: "MoE", mesh, mesh_axes=("data", "model")) -> Dict:
    """This rank's slices of ``moe``'s weights in the reference's sharded
    layout, as views (nothing is copied): the routed experts tiled to
    ``expert_slots(n_experts, data_size)`` (slot ``s`` holds expert
    ``s % n_experts``), this data rank's ``slots / data_size`` slots and this
    model rank's share of each expert's FFN width; the shared experts'
    columns of ``wi``/``wg`` and rows of ``wo``; the router whole."""
    data_axis, model_axis = mesh_axes
    _, _, data_size, model_size = _groups(mesh, mesh_axes)
    r, mr = mesh.get_local_rank(data_axis), mesh.get_local_rank(model_axis)
    E = moe.cfg.moe.n_experts
    slots_local = expert_slots(E, data_size) // data_size
    # a rank's slots hold consecutive experts (one slot each when the
    # experts are tiled): a slice, not a gather
    e0 = (r * slots_local) % E

    def cols(w, axis):
        n = w.shape[axis] // model_size
        return w.narrow(axis, mr * n, n)

    def experts(w, axis):
        return cols(w.narrow(0, e0, slots_local), axis)

    params = {"router": {"w": moe.router.w}, "wi": experts(moe.wi, 2),
              "wg": experts(moe.wg, 2), "wo": experts(moe.wo, 1)}
    if moe.shared is not None:
        sh = moe.shared
        params["shared"] = {"wi": {"w": cols(sh.wi.w, 1)}, "wg": {"w": cols(sh.wg.w, 1)},
                            "wo": {"w": cols(sh.wo.w, 0)}}
    return params


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
    ``n_shared * d_ff_shared``): the reference's ``init_moe``.

    ``mesh`` is None (exact routing on this device) unless
    ``LMModel(use_sharded_moe=True)`` sets it; then ``forward`` runs
    ``moe_apply_sharded`` on this rank's slices."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
        self.cfg = cfg
        self.mesh = None
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
        token; each token's k outputs still add in k order, in float32.
        With a mesh: ``moe_apply_sharded``."""
        if self.mesh is not None:
            return moe_apply_sharded(shard_moe_params(self, self.mesh), self.cfg, x, self.mesh)
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
