"""The port's optimizers (``repro_torch.train.optimizer``) against the
reference's on identical parameters and gradients.

The reference updates its stacked parameter tree; the port updates its
per-layer parameters grouped back into the same stacked leaves.  Each case
takes a reduced config's reference parameters in float32 (perturbed, so no
leaf is constant), converts them to the port, draws three gradient trees
with numpy from a seed, and runs three steps of each package's optimizer on
the same gradients: every parameter and every state leaf within 1e-6 of its
leaf's max |value| after each step (float32; the two frameworks sum the
Adafactor factors' means in different orders).  Adam's first step is about
``sign(g)``, so the packages are held on identical gradients and never on
parameters that each package's own gradients moved.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import configs, reference_pair, rel_err
from _torch_train import one_torch_thread  # noqa: F401
from repro.train.optimizer import clip_by_global_norm as r_clip
from repro.train.optimizer import global_norm as r_global_norm
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro_torch.models import LMModel, convert
from repro_torch.train.optimizer import clip_by_global_norm, global_norm, make_optimizer

TOL = 1e-6
ARCHS = ["smollm-360m", "llama-3.2-vision-90b", "zamba2-7b", "grok-1-314b", "mamba2-780m"]
OPTIMIZERS = [("adamw", {}), ("adafactor", {}), ("adafactor", {"weight_decay": 0.1})]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    rcfg, pcfg = configs(arch, "float32")
    _, _, tree, _ = reference_pair(rcfg, pcfg, 0, data_size=1)
    return pcfg, tree


def _setup(arch):
    """-> (port config, reference params (jnp), their numpy tree, the port's
    parameters holding the same values)."""
    pcfg, tree = _reference(arch)
    pm = LMModel(pcfg, device="cpu")
    pm.load_state_dict(convert.params_from_reference(pcfg, tree))
    return pcfg, jax.tree.map(jnp.asarray, tree), tree, dict(pm.named_parameters())


def _grad_tree(tree, rng):
    """Gradients shaped like ``tree``: normal values at a per-leaf scale from
    1e-6 to 1, a tenth of them 1e3 times smaller (near-zero elements)."""
    def leaf(a):
        g = rng.standard_normal(a.shape) * 10.0 ** rng.uniform(-6, 0)
        g = np.where(rng.random(a.shape) < 0.1, g * 1e-3, g)
        return g.astype(np.float32)
    return jax.tree.map(leaf, tree)


def _assert_trees_close(ref_tree, got_tree, what):
    errs = {}
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    assert [p for p, _ in ref_flat] == [p for p, _ in got_flat], what
    for (path, a), (_, b) in zip(ref_flat, got_flat):
        errs[jax.tree_util.keystr(path)] = rel_err(a, b)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (what, worst, errs[worst])


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=["adamw", "adafactor", "adafactor-wd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_matches_reference_on_identical_gradients(arch, name, kw):
    pcfg, jp, tree, params = _setup(arch)
    r_opt, p_opt = r_make_optimizer(name, lr=1e-2, **kw), make_optimizer(name, lr=1e-2, **kw)
    r_state, p_state = r_opt.init(jp), p_opt.init(params)
    r_update = jax.jit(r_opt.update)
    _assert_trees_close(jax.tree.map(np.asarray, r_state),
                        convert.opt_state_to_reference(p_state), "init")
    rng = np.random.default_rng(7)
    for step in range(3):
        g = _grad_tree(tree, rng)
        jp, r_state = r_update(jax.tree.map(jnp.asarray, g), r_state, jp, jnp.int32(step))
        p_opt.update(convert.params_from_reference(pcfg, g), p_state, params, step)
        _assert_trees_close(jax.tree.map(np.asarray, jp),
                            convert.params_to_reference(pcfg, params, data_size=1),
                            f"params after step {step}")
        _assert_trees_close(jax.tree.map(np.asarray, r_state),
                            convert.opt_state_to_reference(p_state), f"state after step {step}")


def test_weight_decay_reaches_per_layer_norms_but_not_the_final_norm():
    """The reference decays every leaf of two or more dims, and a per-layer
    norm scale is stacked (L, d): zero gradients leave Adam's step 0, so only
    the decay moves the parameters, p * (1 - lr * wd), on every per-layer
    norm and on no unstacked vector."""
    pcfg, jp, tree, params = _setup("smollm-360m")
    before = {k: v.detach().clone() for k, v in params.items()}
    opt = make_optimizer("adamw", lr=1e-2, weight_decay=0.1)
    opt.update({k: torch.zeros_like(v) for k, v in params.items()}, opt.init(params), params, 0)
    decayed = {k for k in params if not torch.equal(params[k], before[k])}
    assert "final_norm.scale" not in decayed
    assert {f"layers.{i}.{n}.scale" for i in range(pcfg.n_layers) for n in ("n1", "n2")} <= decayed
    assert decayed == set(params) - {"final_norm.scale"}
    for k in decayed:
        want = (before[k] - 1e-2 * (0.1 * before[k])).to(before[k].dtype)
        torch.testing.assert_close(params[k].detach(), want, rtol=0, atol=0)
    r_opt = r_make_optimizer("adamw", lr=1e-2, weight_decay=0.1)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jp, _ = r_opt.update(zeros, r_opt.init(jp), jp, jnp.int32(0))
    _assert_trees_close(jax.tree.map(np.asarray, jp),
                        convert.params_to_reference(pcfg, params, data_size=1), "decay only")


def test_adafactor_factors_stacked_norms_across_layers():
    """A per-layer norm scale (L, d) is factored as the reference's stacked
    leaf: r over the d axis (one per layer), c over the layer axis (one per
    feature, shared by every layer); vlm's self layers keep both stack axes."""
    for arch in ("smollm-360m", "llama-3.2-vision-90b"):
        pcfg, jp, _, params = _setup(arch)
        state = make_optimizer("adafactor").init(params)["f"]
        L = pcfg.n_layers
        if arch == "smollm-360m":
            assert state["layers.n1.scale"]["r"].shape == (L,)
            assert state["layers.n1.scale"]["c"].shape == (pcfg.d_model,)
            assert set(state["final_norm.scale"]) == {"v"}
        else:
            n_cross = L // pcfg.cross_attn_every
            shape = (n_cross, pcfg.cross_attn_every - 1)
            assert state["self_layers.attn.q.w"]["r"].shape == shape + (pcfg.d_model,)
            assert state["self_layers.n1.scale"]["c"].shape == (n_cross, pcfg.d_model)
            assert set(state["cross_layers.attn.gate"]) == {"v"}
        ref = r_make_optimizer("adafactor").init(jp)["f"]
        got = convert.opt_state_to_reference({"f": state})["f"]
        assert jax.tree.map(np.shape, jax.tree.map(np.asarray, ref)) == jax.tree.map(np.shape, got)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    """The global norm over every leaf and the clipped gradients, each in its
    own dtype (bfloat16 leaves included), against the reference's."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": rng.standard_normal((3, 5, 2)).astype(np.float32),
            "c": np.asarray(jnp.asarray(rng.standard_normal(16), jnp.bfloat16))}
    r_clipped, r_norm = r_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    grads = {k: convert.to_torch(v) for k, v in tree.items()}
    clipped, norm = clip_by_global_norm(grads, max_norm)
    assert abs(float(norm) - float(r_norm)) <= TOL * float(r_norm)
    assert abs(float(global_norm(grads)) - float(r_global_norm(jax.tree.map(jnp.asarray, tree)))) \
        <= TOL * float(r_norm)
    for k in tree:
        assert clipped[k].dtype == grads[k].dtype
        ref = np.asarray(r_clipped[k], np.float32)
        got = clipped[k].float().numpy()
        tol = TOL if k != "c" else 2 ** -8  # one bf16 ulp where the scales round apart
        assert np.abs(ref - got).max() <= tol * np.abs(ref).max(), k


def test_stacked_leaves_and_state_round_trip():
    """stacked_leaves groups vlm's double stack in ndindex order, and the
    optimizer state converts to the reference's tree and back unchanged."""
    pcfg, _, _, params = _setup("llama-3.2-vision-90b")
    leaves = convert.stacked_leaves(params)
    n_cross, per = pcfg.n_layers // pcfg.cross_attn_every, pcfg.cross_attn_every - 1
    shape, names = leaves["self_layers.attn.q.w"]
    assert shape == (n_cross, per)
    assert names == [f"self_layers.{g}.{j}.attn.q.w" for g in range(n_cross) for j in range(per)]
    assert leaves["embed.w"] == ((), ["embed.w"])
    with pytest.raises(ValueError, match="do not fill"):
        convert.stacked_leaves(["layers.0.n1.scale", "layers.2.n1.scale"])
    for name in ("adamw", "adafactor"):
        state = make_optimizer(name).init(params)
        for leaf in jax.tree.leaves(state):
            leaf.normal_()
        back = convert.opt_state_from_reference(convert.opt_state_to_reference(state))
        flat_a, flat_b = jax.tree.leaves(state), jax.tree.leaves(back)
        assert len(flat_a) == len(flat_b)
        assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b))
