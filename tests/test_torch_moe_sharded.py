"""The port's expert-parallel MoE (``moe_apply_sharded`` over
``torch.distributed``) and meshes (``launch/mesh.py``), against the JAX
package's on the CPU.

* 8 gloo ranks (tests/_moe_sharded_runs.py, in a subprocess with its own
  timeout) on the reference's gate: reduced grok-1 with 4 experts, top-2,
  capacity 8.0 on a (4, 2) mesh, within 2e-2 of the single-device ``MoE``;
* capacity 1.0 (tokens drop) with a shared expert on (4, 2), and 4 experts
  on a data axis of 8 (each stored twice, ``reps = 2``, slots by token
  parity) at capacity 1.0, each rank against the reference's
  ``moe_apply_sharded`` on 8 host devices (its own subprocess): outputs
  within 1e-5 of max |out|, each shard's ``dropped`` equal and ``aux``
  within 1e-6;
* the ranks are numbered row-major over (data, model), as ``jax.make_mesh``
  orders its devices, so both packages cut ``x`` and the experts alike;
* ``LMModel`` with the sharded MoE on a world-1 gloo mesh (reduced
  deepseek-v2-lite: MLA and shared experts) against the reference's on a
  (1, 1) mesh, on converted weights;
* the backward on that mesh: ``train.loss_and_grads`` against the
  reference's ``jax.value_and_grad`` on a (1, 1) mesh, and microbatched
  train steps against the unsharded model's (the multi-rank gradients are
  tests/test_torch_moe_train.py's);
* ``make_host_mesh`` and ``make_production_mesh``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as PC
from repro.compat import set_mesh
from repro.models.transformer import LMModel as RLMModel
from repro_torch.launch.mesh import MeshShape, make_host_mesh, make_production_mesh
from repro_torch.models import LMModel, build_model, convert
from repro_torch.models.moe import MoE, moe_apply_sharded, shard_moe_params
from repro_torch.train import loss_and_grads, make_optimizer, make_train_step

from _moe_sharded_runs import B, CASES, case_config, case_inputs, load_moe
from _torch_models import configs, make_batch, reference_pair, rel_err, to_port, tree_errs

ROOT = Path(__file__).resolve().parents[1]
RUNS = Path(__file__).resolve().parent / "_moe_sharded_runs.py"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' multi-process runs, started together; -> their
    output directory."""
    out = tmp_path_factory.mktemp("moe_sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = {side: subprocess.Popen([sys.executable, str(RUNS), side, str(out)], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for side in ("torch", "jax")}
    try:
        for side, p in procs.items():
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"{side}: {err[-3000:]}"
    finally:
        for p in procs.values():
            p.kill()
    return out


def _rank(out, name, rank):
    return np.load(out / f"torch_{name}_{rank}.npz")


def test_eight_gloo_ranks_match_the_single_device_moe(runs):
    """The reference's gate, ported: every rank's output within 2e-2 of
    ``MoE`` on its batch shard (nothing drops at capacity 8.0)."""
    cfg = case_config(PC, "a")
    inputs = case_inputs("a", cfg.d_model)
    with torch.no_grad():
        want, _ = load_moe(cfg, inputs)(torch.from_numpy(inputs["x"]))
    data = CASES["a"][0][0]
    bl = B // data
    for rank in range(8):
        got = _rank(runs, "a", rank)
        r = rank // 2
        assert rel_err(want[r * bl:(r + 1) * bl], got["out"]) < 2e-2
        assert float(got["dropped"]) == 0.0


@pytest.mark.parametrize("name", ["a", "b", "c"])
def test_ranks_are_row_major_over_data_and_model(runs, name):
    (data, model), *_ = CASES[name]
    for rank in range(8):
        assert tuple(_rank(runs, name, rank)["coords"]) == (rank // model, rank % model)


@pytest.mark.parametrize("name", ["b", "c"])
def test_each_shard_matches_the_reference_sharded_path(runs, name):
    """Capacity 1.0: each rank's output, ``dropped`` and ``aux`` against
    the reference's shard at the same mesh position."""
    ref = np.load(runs / f"jax_{name}.npz")
    drops = []
    for rank in range(8):
        got = _rank(runs, name, rank)
        want = ref["out"][rank]
        assert np.abs(got["out"] - want).max() <= 1e-5 * np.abs(want).max()
        assert float(got["dropped"]) == float(ref["dropped"][rank])
        assert abs(float(got["aux"]) - float(ref["aux"][rank])) <= 1e-6
        drops.append(float(got["dropped"]))
    assert max(drops) > 0  # tokens did drop


def test_the_reference_gate_case_matches_the_reference_too(runs):
    ref = np.load(runs / "jax_a.npz")
    for rank in range(8):
        got = _rank(runs, "a", rank)
        assert np.abs(got["out"] - ref["out"][rank]).max() <= 1e-5 * np.abs(ref["out"][rank]).max()


# ---------------------------------------------------------------------------
# one rank, in this process: meshes, the model, autograd
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    """A world-1 gloo mesh, ended after this module's tests."""
    mesh = make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_make_host_mesh_on_the_cpu(host_mesh):
    assert host_mesh.device_type == "cpu" and host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
    # an existing process group is reused, not started again
    again = make_host_mesh("cpu")
    assert tuple(again.shape) == (1, 1) and dist.get_world_size() == 1


def test_make_production_mesh_is_shape_only():
    assert make_production_mesh() == MeshShape((16, 16), ("data", "model"))
    multi = make_production_mesh(multi_pod=True)
    assert multi == MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert multi.size("pod") == 2 and multi.size("data") == 16 and multi.size("model") == 16


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-lite-16b"])
def test_one_rank_sharded_equals_moe_and_slices_are_views(host_mesh, arch):
    _, cfg = configs(arch, "float32")
    moe = MoE(cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    for mod in moe.modules():
        if hasattr(mod, "init_"):
            mod.init_(gen)
    params = shard_moe_params(moe, host_mesh)
    for name in ("wi", "wg", "wo"):
        assert params[name].data_ptr() == getattr(moe, name).data_ptr()
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    # capacity slots / top_k: a slot holds every token, nothing can drop
    big = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    with torch.no_grad():
        want, _ = moe(x)
        got, aux = moe_apply_sharded(params, dataclasses.replace(cfg, moe=big), x, host_mesh)
    assert float(aux["dropped"]) == 0.0
    assert rel_err(want, got) < 1e-6


def test_lmmodel_with_the_sharded_moe_matches_the_reference(host_mesh):
    """Reduced deepseek-v2-lite (MLA, shared experts, capacity 1.25) with the
    sharded MoE on a world-1 gloo mesh, against the reference's LMModel with
    its sharded MoE on a (1, 1) mesh, on the same weights: every position's
    logits within 1e-5 of max |logit|.  Then the flag turned off gives the
    single-device MoE on the same weights."""
    rcfg, pcfg = configs("deepseek-v2-lite-16b", "float32")
    _, jp, _, pm = reference_pair(rcfg, pcfg, data_size=1)
    # Auto axes: under jax's default Explicit axes the reference's
    # with_sharding_constraint in _embed asserts an input sharding instead
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rm = RLMModel(rcfg, data_size=1, use_sharded_moe=True, mesh=jmesh)
    batch = make_batch(rcfg, 2, 16)
    with set_mesh(jmesh):
        want = jax.jit(lambda p, b: rm._full_forward(p, b, "prefill")[0])(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = LMModel(pcfg, device="cpu", mesh=host_mesh, use_sharded_moe=True, data_size=1)
    model.load_state_dict(pm.state_dict())
    assert model.use_sharded_moe
    got = model(to_port(batch))
    assert rel_err(want, got) <= 1e-5
    model.use_sharded_moe = False
    assert not model.use_sharded_moe
    assert rel_err(pm(to_port(batch)), model(to_port(batch))) == 0.0


def test_build_model_takes_the_reference_signature(host_mesh):
    cfg = PC.reduced_config("deepseek-v2-lite-16b")
    model = build_model(cfg, host_mesh, ("data",), 1, True, device="cpu")
    assert model.use_sharded_moe and model.data_size == 1 and model.mesh is host_mesh
    with pytest.raises(ValueError, match="data extent"):
        build_model(cfg, host_mesh, data_size=16, use_sharded_moe=True, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        build_model(cfg, use_sharded_moe=True, device="cpu")
    with pytest.raises(ValueError, match="batch_axes"):
        build_model(cfg, host_mesh, ("pod",), 1, True, device="cpu")


def test_a_grad_enabled_call_raises_naming_8c_4(host_mesh):
    """The backward through the collectives (ROADMAP 8c-4) runs: reduced
    deepseek-v2-lite (MLA, shared experts, capacity 1.25) with the sharded
    MoE on a world-1 gloo mesh, ``train.loss_and_grads`` against the
    reference's ``jax.value_and_grad`` of its ``loss_fn`` with the sharded
    MoE on a (1, 1) mesh, same weights: loss, nll and aux within 1e-5
    relative, every gradient within 1e-4 of its tensor's max.  No call
    raises naming 8c-4."""
    rcfg, pcfg = configs("deepseek-v2-lite-16b", "float32")
    _, jp, _, pm = reference_pair(rcfg, pcfg, data_size=1)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rm = RLMModel(rcfg, data_size=1, use_sharded_moe=True, mesh=jmesh)
    batch = make_batch(rcfg, 2, 17)
    with set_mesh(jmesh):
        (r_loss, r_met), r_grads = jax.jit(jax.value_and_grad(rm.loss_fn, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = LMModel(pcfg, device="cpu", mesh=host_mesh, use_sharded_moe=True, data_size=1)
    model.load_state_dict(pm.state_dict())
    loss, met, grads = loss_and_grads(model, to_port(batch))
    for want, got in ((r_loss, loss), (r_met["nll"], met["nll"]), (r_met["aux"], met["aux"])):
        assert abs(float(want) - float(got)) <= 1e-5 * abs(float(want))
    errs = tree_errs(jax.tree.map(np.asarray, r_grads),
                     convert.params_to_reference(pcfg, grads, data_size=1))
    assert max(errs.values()) <= 1e-4, max(errs, key=errs.get)


def test_microbatched_steps_on_the_sharded_model_equal_the_unsharded(host_mesh):
    """``make_train_step(microbatches=2)`` on a world-1 gloo mesh: two adamw
    steps of the sharded model at capacity 11.0 (nothing can drop) report
    the unsharded model's losses (1e-6 relative) and hand the optimizer its
    gradients (1e-4 of each tensor's max, the float32 gradient bound of
    tests/test_torch_train.py), from the same weights."""
    cfg = dataclasses.replace(PC.reduced_config("deepseek-v2-lite-16b"), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=11.0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (4, 17)).astype(np.int32))}
    out = {}
    for sharded in (True, False):
        model = build_model(cfg, host_mesh, data_size=1, use_sharded_moe=sharded, device="cpu")
        opt = make_optimizer("adamw", lr=1e-3)
        seen = []
        opt = dataclasses.replace(opt, update=lambda g, *a, real=opt.update: (
            seen.append({k: v.clone() for k, v in g.items()}), real(g, *a))[1])
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt, microbatches=2)
        out[sharded] = [float(step(state, batch, i)["loss"]) for i in range(2)], seen
    (s_losses, s_grads), (u_losses, u_grads) = out[True], out[False]
    assert np.allclose(s_losses, u_losses, rtol=1e-6, atol=0)
    for got, want in zip(s_grads, u_grads):
        for name, w in want.items():
            assert float((got[name] - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
