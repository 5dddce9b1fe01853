"""Multi-process gradient runs of the sharded MoE for tests/test_torch_moe_train.py.

    python tests/_moe_train_runs.py torch OUTDIR   # 8 gloo ranks, the port
    python tests/_moe_train_runs.py jax OUTDIR     # 8 host devices, the reference

Both sides run the same cases on the same float32 inputs and write one
``.npz`` per case (the reference) or per case and rank (the port):

* ``COLLECTIVES``: each collective of the sharded MoE alone, as the
  reference calls it and as the port does, on a (4, 2) mesh: every rank's
  own input and output cotangent drawn with numpy; its output and the
  gradient of its input (the port's ``torch.autograd.Function``s against
  ``jax.vjp`` under ``compat.shard_map`` with specs that name every mesh
  axis, so that ``shard_map`` adds no rule of its own);
* ``MOE_CASES``: ``moe_apply_sharded`` with the specs of the reference's
  ``LMModel._moe_ffn`` (``x`` and ``out`` over data, ``aux`` and
  ``dropped`` replicated), ``jax.vjp`` with a global cotangent of ``out``
  and one of ``aux``.  Each port rank differentiates its share of the
  same objective, ``D * <out, cotangent>`` on its data shard plus the
  ``aux`` term (a local mean loss carries the factor D), and brings each
  gradient to the global one as ``train.train_loop`` does: summed over the
  ranks that hold a copy (every rank for a parameter, the model group for
  ``x``) and divided by the mesh size;
* ``MODEL_CASES``: ``LMModel.loss_fn`` with the sharded MoE, reduced
  deepseek-v2-lite on (4, 2) and reduced grok-1 on (8, 1) (4 experts held
  twice, ``reps = 2``), at capacity 1.25, on the port's weights drawn from a
  seed (the reference gets them through ``models.convert``, tiled): the
  reference's ``jax.value_and_grad`` on the global batch of B x (S + 1)
  tokens against the port's ``train.loss_and_grads`` on each rank's batch
  shard; then one ``make_train_step`` step of adamw on every rank, whose
  parameters are written out.  The reference's expert gradients are summed
  over its replica slots (the port ties them).

The port's ranks meet on a ``FileStore`` in ``OUTDIR`` with a 120 s
collective timeout, so a hang fails the run instead of stalling the suite.
"""

import dataclasses
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

from _moe_sharded_runs import B, CASES, case_config, case_inputs, load_moe

WORLD = 8
MESH = (4, 2)
# name: (per-shard input shape, the reference's op on one shard)
COLLECTIVES = {
    "all_to_all": (8, 3, 4),  # over data, split and concat dim 0 (dispatch, return)
    "psum_scatter": (2, 6, 8),  # over model, scatter_dimension=2 (the row-parallel wo)
    "all_gather": (5, 3),  # over model, axis=1 (the combined tokens' d-slices)
    "psum": (2, 3, 4),  # over model (the shared experts)
}
# _moe_sharded_runs's cases: "b" drops tokens with a shared expert on (4, 2),
# "c" holds 4 experts twice on (8, 1)
MOE_CASES = ("b", "c")
AUX_COT = 0.37
# name: (arch, mesh (data, model), seed)
MODEL_CASES = {"deepseek": ("deepseek-v2-lite-16b", (4, 2), 0),
               "grok": ("grok-1-314b", (8, 1), 1)}
MODEL_CF, S, LR = 1.25, 16, 1e-3


def collective_inputs(name):
    """(every shard's input (WORLD, *shape), every shard's output cotangent)."""
    shape = COLLECTIVES[name]
    rng = np.random.default_rng(sorted(COLLECTIVES).index(name))
    x = rng.standard_normal((WORLD, *shape)).astype(np.float32)
    out = shape
    if name == "psum_scatter":
        out = (*shape[:2], shape[2] // MESH[1])
    elif name == "all_gather":
        out = (shape[0], shape[1] * MESH[1])
    return x, rng.standard_normal((WORLD, *out)).astype(np.float32)


def moe_cotangent(name, d_model):
    return np.random.default_rng(100 + ord(name)).standard_normal(
        (B, 16, d_model)).astype(np.float32)


def model_config(pkg_configs, name):
    arch, _, _ = MODEL_CASES[name]
    cfg = pkg_configs.reduced_config(arch)
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=MODEL_CF))


def model_weights(name):
    """The port's state dict (float32, CPU), drawn from the case's seed."""
    import torch

    import repro_torch.configs as PC
    from repro_torch.models import build_model

    seed = MODEL_CASES[name][2]
    model = build_model(model_config(PC, name), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def model_batch(name, vocab):
    seed = MODEL_CASES[name][2]
    return np.random.default_rng(seed + 10).integers(1, vocab, (B, S + 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _torch_collective(name, x, mesh):
    from repro_torch.models import moe as M

    dg, mg = mesh.get_group("data"), mesh.get_group("model")
    if name == "all_to_all":
        return M._AllToAll.apply(x, dg)
    if name == "psum_scatter":  # as moe_apply_sharded: d made the leading axis
        return M._ReduceScatter.apply(x.permute(2, 0, 1).contiguous(), mg).permute(1, 2, 0)
    if name == "all_gather":
        T, ds = x.shape
        return M._AllGather.apply(x, mg).reshape(MESH[1], T, ds).permute(1, 0, 2).reshape(T, -1)
    return M._AllReduce.apply(x * 1.0, mg)  # in place: not on the leaf


def _to_global(t, group=None):
    """Summed over ``group`` (default: every rank), divided by the mesh size."""
    import torch.distributed as dist

    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t / WORLD


def _torch_rank(rank, outdir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.configs as PC
    from repro_torch.models import LMModel
    from repro_torch.models import moe as moe_module
    from repro_torch.models.moe import moe_apply_sharded, shard_moe_params
    from repro_torch.train import loss_and_grads, make_optimizer, make_train_step

    torch.set_num_threads(1)
    out = Path(outdir)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        for name in COLLECTIVES:
            xs, cts = collective_inputs(name)
            x = torch.from_numpy(xs[rank]).requires_grad_(True)
            y = _torch_collective(name, x, mesh)
            y.backward(torch.from_numpy(cts[rank]))
            np.savez(out / f"torch_coll_{name}_{rank}.npz", out=y.detach().numpy(),
                     grad=x.grad.numpy())

        for name in MOE_CASES:
            cfg = case_config(PC, name)
            D = CASES[name][0][0]
            mesh = init_device_mesh("cpu", CASES[name][0], mesh_dim_names=("data", "model"))
            r = mesh.get_local_rank("data")
            inputs = case_inputs(name, cfg.d_model)
            moe = load_moe(cfg, inputs).requires_grad_(True)
            bl = B // D
            x = torch.from_numpy(inputs["x"][r * bl:(r + 1) * bl]).requires_grad_(True)
            ct = torch.from_numpy(moe_cotangent(name, cfg.d_model)[r * bl:(r + 1) * bl])
            o, aux = moe_apply_sharded(shard_moe_params(moe, mesh), cfg, x, mesh)
            objective = D * (o * ct).sum() + AUX_COT * aux["aux"]
            params = dict(moe.named_parameters())
            grads = torch.autograd.grad(objective, [x, *params.values()])
            rec = {"param." + k: _to_global(g).numpy() for k, g in zip(params, grads[1:])}
            rec["x"] = _to_global(grads[0], mesh.get_group("model")).numpy()
            np.savez(out / f"torch_moe_{name}_{rank}.npz", out=o.detach().numpy(),
                     aux=aux["aux"].detach().numpy(), dropped=aux["dropped"].numpy(), **rec)

        dropped = []
        real = moe_module.moe_apply_sharded

        def recording(*a, **kw):
            o, aux = real(*a, **kw)
            dropped.append(float(aux["dropped"]))
            return o, aux

        moe_module.moe_apply_sharded = recording
        for name, (_, shape, _) in MODEL_CASES.items():
            cfg = model_config(PC, name)
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            r = mesh.get_local_rank("data")
            model = LMModel(cfg, device="cpu", mesh=mesh, use_sharded_moe=True,
                            data_size=shape[0])
            model.load_state_dict(model_weights(name))
            bl = B // shape[0]
            batch = {"tokens": torch.from_numpy(model_batch(name, cfg.vocab)[r * bl:(r + 1) * bl])}
            dropped.clear()
            loss, metrics, grads = loss_and_grads(model, batch)
            rec = {"loss": loss.numpy(), "nll": metrics["nll"].numpy(),
                   "aux": metrics["aux"].numpy(), "dropped": np.array(dropped)}
            rec.update({"grad." + k: g.numpy() for k, g in grads.items()})
            opt = make_optimizer("adamw", lr=LR)
            state = opt.init(dict(model.named_parameters()))
            step = make_train_step(model, opt)(state, batch, 0)
            rec.update({"step." + k: v.numpy() for k, v in step.items()})
            rec.update({"param." + k: v.detach().numpy() for k, v in model.named_parameters()})
            np.savez(out / f"torch_model_{name}_{rank}.npz", **rec)
        moe_module.moe_apply_sharded = real
    finally:
        dist.destroy_process_group()


def run_torch(outdir):
    import torch.multiprocessing as mp

    mp.spawn(_torch_rank, args=(outdir,), nprocs=WORLD, join=True)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def _fold_replicas(a, n_experts, axis):
    """Expert slots (``reps * E`` on ``axis``) summed over their replicas."""
    a = np.asarray(a)
    return a.reshape(*a.shape[:axis], -1, n_experts, *a.shape[axis + 1:]).sum(axis)


def _sum_replicas(tree, n_experts):
    """A model's gradient tree with each layer's expert slots summed over
    their replicas: (L, reps * E, ...) -> (L, E, ...)."""
    def walk(t, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else _fold_replicas(v, n_experts, 1)
                if path[-1:] == ("moe",) and k in ("wi", "wg", "wo") else np.asarray(v)
                for k, v in t.items()}

    return walk(tree, ())


def run_jax(outdir):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    import repro.configs as RC
    import repro_torch.configs as PC
    from repro.compat import set_mesh, shard_map
    from repro.models.moe import expert_slots, moe_apply_sharded
    from repro.models.transformer import LMModel as RLMModel
    from repro_torch.models import convert

    out = Path(outdir)
    every = P(("data", "model"))
    mesh = jax.make_mesh(MESH, ("data", "model"))
    ops = {
        "all_to_all": lambda x: jax.lax.all_to_all(x, "data", 0, 0, tiled=True),
        "psum_scatter": lambda x: jax.lax.psum_scatter(x, "model", scatter_dimension=2,
                                                       tiled=True),
        "all_gather": lambda x: jax.lax.all_gather(x, "model", axis=1, tiled=True),
        "psum": lambda x: jax.lax.psum(x, "model"),
    }
    for name, op in ops.items():
        xs, cts = collective_inputs(name)
        f = shard_map(lambda x, op=op: op(x[0])[None], mesh=mesh, in_specs=(every,),
                      out_specs=every)
        with set_mesh(mesh):
            y, vjp = jax.vjp(f, xs)
            (g,) = vjp(cts)
        np.savez(out / f"jax_coll_{name}.npz", out=np.asarray(y), grad=np.asarray(g))

    for name in MOE_CASES:
        cfg = case_config(RC, name)
        shape = CASES[name][0]
        inputs = case_inputs(name, cfg.d_model)
        mmesh = jax.make_mesh(shape, ("data", "model"))
        reps = expert_slots(cfg.moe.n_experts, shape[0]) // cfg.moe.n_experts
        tile = lambda a: np.tile(a, (reps, 1, 1))  # noqa: E731
        params = {"router": {"w": inputs["router"]}, "wi": tile(inputs["wi"]),
                  "wg": tile(inputs["wg"]), "wo": tile(inputs["wo"])}
        pspec = {"router": {"w": P(None, None)}, "wi": P("data", None, "model"),
                 "wg": P("data", None, "model"), "wo": P("data", "model", None)}
        if cfg.moe.n_shared:
            params["shared"] = {k: {"w": inputs["shared_" + k]} for k in ("wi", "wg", "wo")}
            pspec["shared"] = {"wi": {"w": P(None, "model")}, "wg": {"w": P(None, "model")},
                               "wo": {"w": P("model", None)}}
        bspec = P("data", None, None)
        f = shard_map(lambda pp, xx: moe_apply_sharded(pp, cfg, xx), mesh=mmesh,
                      in_specs=(pspec, bspec), out_specs=(bspec, {"aux": P(), "dropped": P()}))
        with set_mesh(mmesh):
            (o, aux), vjp = jax.vjp(f, params, inputs["x"])
            gp, gx = vjp((moe_cotangent(name, cfg.d_model),
                          {"aux": np.float32(AUX_COT), "dropped": np.float32(0.0)}))
        rec = {"param.router.w": np.asarray(gp["router"]["w"])}
        rec.update({f"param.{k}": _fold_replicas(gp[k], cfg.moe.n_experts, 0)
                    for k in ("wi", "wg", "wo")})
        if "shared" in gp:
            rec.update({f"param.shared.{k}.w": np.asarray(gp["shared"][k]["w"])
                        for k in ("wi", "wg", "wo")})
        np.savez(out / f"jax_moe_{name}.npz", out=np.asarray(o), aux=np.asarray(aux["aux"]),
                 x=np.asarray(gx), **rec)

    for name, (_, shape, _) in MODEL_CASES.items():
        rcfg, pcfg = model_config(RC, name), model_config(PC, name)
        tree = convert.params_to_reference(pcfg, model_weights(name), data_size=shape[0])
        jmesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        rm = RLMModel(rcfg, data_size=shape[0], use_sharded_moe=True, mesh=jmesh)
        batch = {"tokens": jnp.asarray(model_batch(name, rcfg.vocab))}
        with set_mesh(jmesh):
            (loss, met), grads = jax.jit(jax.value_and_grad(rm.loss_fn, has_aux=True))(
                jax.tree.map(jnp.asarray, tree), batch)
        summed = _sum_replicas(jax.tree.map(np.asarray, grads), rcfg.moe.n_experts)
        port = convert.params_from_reference(pcfg, summed)
        np.savez(out / f"jax_model_{name}.npz", loss=np.asarray(loss), nll=np.asarray(met["nll"]),
                 aux=np.asarray(met["aux"]),
                 **{"grad." + k: v.numpy() for k, v in port.items()})


if __name__ == "__main__":
    {"torch": run_torch, "jax": run_jax}[sys.argv[1]](sys.argv[2])
