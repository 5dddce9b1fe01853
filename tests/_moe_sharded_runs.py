"""Multi-process runs of the sharded MoE for tests/test_torch_moe_sharded.py.

    python tests/_moe_sharded_runs.py torch OUTDIR   # 8 gloo ranks, the port
    python tests/_moe_sharded_runs.py jax OUTDIR     # 8 host devices, the reference

Both sides run the cases of ``CASES`` on the same float32 inputs, drawn with
numpy from each case's seed (``case_inputs``), and write each rank's (the
port) or each mesh position's (the reference) output, ``aux`` and
``dropped`` to ``OUTDIR`` as ``.npz`` files.  The port's ranks meet on a
``FileStore`` in ``OUTDIR`` with a 120 s collective timeout, so a hang fails
the run instead of stalling the suite.
"""

import dataclasses
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

WORLD = 8
B, S = 8, 16
# name: (mesh (data, model), n_experts, top_k, n_shared, capacity_factor, seed)
CASES = {
    # the reference's own gate (tests/test_models.py): nothing drops
    "a": ((4, 2), 4, 2, 0, 8.0, 0),
    # tokens drop, with a shared expert (column/row parallel over model)
    "b": ((4, 2), 4, 2, 1, 1.0, 1),
    # 4 experts on a data axis of 8: each stored twice, reps = 2
    "c": ((8, 1), 4, 2, 0, 1.0, 2),
}
D_FF = 64


def case_config(pkg_configs, name):
    """The case's config in either package: reduced grok-1 in float32 with
    the case's experts (``pkg_configs`` is ``repro.configs`` or
    ``repro_torch.configs``)."""
    _, E, k, n_shared, cf, _ = CASES[name]
    cfg = pkg_configs.reduced_config("grok-1-314b")
    moe = dataclasses.replace(cfg.moe, n_experts=E, top_k=k, d_ff_expert=D_FF,
                              n_shared=n_shared, d_ff_shared=D_FF if n_shared else 0,
                              capacity_factor=cf)
    return dataclasses.replace(cfg, dtype="float32", moe=moe)


def case_inputs(name, d_model):
    """float32 x (B, S, d) and the weights, each expert once."""
    _, E, _, n_shared, _, seed = CASES[name]
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-2] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    out = {"x": w(B, S, d_model, scale=1.0), "router": w(d_model, E, scale=0.5),
           "wi": w(E, d_model, D_FF), "wg": w(E, d_model, D_FF), "wo": w(E, D_FF, d_model)}
    if n_shared:
        out.update(shared_wi=w(d_model, D_FF), shared_wg=w(d_model, D_FF),
                   shared_wo=w(D_FF, d_model))
    return out


def load_moe(cfg, inputs):
    """The port's ``MoE`` holding the case's weights (CPU, float32)."""
    import torch
    from repro_torch.models.moe import MoE

    moe = MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        moe.router.w.copy_(torch.from_numpy(inputs["router"]))
        for name in ("wi", "wg", "wo"):
            getattr(moe, name).copy_(torch.from_numpy(inputs[name]))
            if moe.shared is not None:
                getattr(moe.shared, name).w.copy_(torch.from_numpy(inputs["shared_" + name]))
    return moe


def _torch_rank(rank, outdir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.configs as PC
    from repro_torch.models.moe import moe_apply_sharded, shard_moe_params

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    try:
        for name, (shape, *_) in CASES.items():
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            r, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
            cfg = case_config(PC, name)
            inputs = case_inputs(name, cfg.d_model)
            bl = B // shape[0]
            x = torch.from_numpy(inputs["x"][r * bl:(r + 1) * bl])
            out, aux = moe_apply_sharded(shard_moe_params(load_moe(cfg, inputs), mesh),
                                         cfg, x, mesh)
            np.savez(Path(outdir) / f"torch_{name}_{rank}.npz", out=out.numpy(),
                     aux=aux["aux"].numpy(), dropped=aux["dropped"].numpy(),
                     coords=np.array([r, m]))
    finally:
        dist.destroy_process_group()


def run_torch(outdir):
    import torch.multiprocessing as mp

    mp.spawn(_torch_rank, args=(outdir,), nprocs=WORLD, join=True)


def run_jax(outdir):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    import jax
    from jax.sharding import PartitionSpec as P

    import repro.configs as RC
    from repro.compat import set_mesh, shard_map
    from repro.models.moe import expert_slots, moe_apply_sharded

    every = P(("data", "model"))
    for name, (shape, *_) in CASES.items():
        cfg = case_config(RC, name)
        inputs = case_inputs(name, cfg.d_model)
        mesh = jax.make_mesh(shape, ("data", "model"))
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

        def per_shard(pp, xx):
            out, aux = moe_apply_sharded(pp, cfg, xx)
            return out[None], aux["aux"][None], aux["dropped"][None]

        with set_mesh(mesh):
            out, aux, dropped = jax.jit(shard_map(
                per_shard, mesh=mesh, in_specs=(pspec, P("data", None, None)),
                out_specs=(every, every, every)))(params, inputs["x"])
        np.savez(Path(outdir) / f"jax_{name}.npz", out=np.asarray(out), aux=np.asarray(aux),
                 dropped=np.asarray(dropped))


if __name__ == "__main__":
    {"torch": run_torch, "jax": run_jax}[sys.argv[1]](sys.argv[2])
