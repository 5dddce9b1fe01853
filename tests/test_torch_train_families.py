"""Training on the port against the JAX reference, continued: the vlm and
audio families' loss and gradients, the train step's microbatch
accumulation, per-layer remat, and the serving forward's values under
autograd.

Tolerances as in ``test_torch_train.py``: losses within 1e-5 relative,
gradients within 1e-4 of their tensor's max |gradient|.  Remat and the
attention tiles' checkpoints recompute the same operations, so they are
held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import configs, make_batch, reference_pair, to_port, to_ref, tree_errs
from _torch_train import GRAD_TOL, grads_case, loss_tol_ok, one_torch_thread  # noqa: F401
from repro.train.optimizer import Optimizer as ROptimizer
from repro.train.train_loop import make_train_step as r_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.models import attention, build_model, convert
from repro_torch.models.attention import flash_attention
from repro_torch.train import Optimizer, loss_and_grads, make_train_step


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-medium"])
def test_loss_and_gradients_match_reference(arch):
    case = grads_case(arch)
    for key in ("loss", "nll", "aux"):
        assert loss_tol_ok(case["ref"][key], case["port"][key]), key
    worst = max(case["grad_errs"], key=case["grad_errs"].get)
    assert case["grad_errs"][worst] <= GRAD_TOL, (worst, case["grad_errs"][worst])


def _capturing(store):
    """An optimizer of each package that keeps the clipped gradients it is
    handed and changes nothing."""
    def r_update(grads, state, params, step):
        store["ref"] = jax.tree.map(np.asarray, grads)
        return params, state

    def p_update(grads, state, params, step):
        store["port"] = grads

    return (ROptimizer(lambda p: {}, r_update, lambda s: s),
            Optimizer(lambda p: {}, p_update, lambda s: s))


@pytest.mark.parametrize("arch", ["smollm-360m", "grok-1-314b"])
def test_microbatch_accumulation_matches_reference(arch):
    """microbatches=2 over a batch of 4: the f32-accumulated, averaged and
    clipped gradients and the step's metrics (loss and nll averaged over the
    microbatches, grad_norm) against the reference's scan."""
    rcfg, pcfg = configs(arch, "float32")
    rm, jp, _, pm = reference_pair(rcfg, pcfg, 0, data_size=1)
    batch = make_batch(rcfg, 4, 33, 5)
    store = {}
    r_opt, p_opt = _capturing(store)
    _, _, r_met = r_make_train_step(rm, r_opt, grad_clip=0.5, microbatches=2)(
        jp, {}, to_ref(batch), jnp.int32(0))
    p_met = make_train_step(pm, p_opt, grad_clip=0.5, microbatches=2)({}, to_port(batch), 0)
    for key in ("loss", "nll", "aux", "grad_norm"):
        assert loss_tol_ok(r_met[key], p_met[key]), (key, r_met[key], p_met[key])
    assert all(g.dtype == torch.float32 for g in store["port"].values())
    errs = tree_errs(store["ref"], convert.params_to_reference(pcfg, store["port"], data_size=1))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_gradients_keep_the_parameter_dtype_with_one_microbatch():
    """bf16 parameters: one microbatch hands the optimizer bf16 gradients,
    two hand it float32 sums, as in the reference."""
    cfg = reduced_config("smollm-360m")
    model = build_model(cfg, device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(1, cfg.vocab, (2, 17)).astype(np.int32)}
    for mb, dtype in ((1, torch.bfloat16), (2, torch.float32)):
        store = {}
        make_train_step(model, _capturing(store)[1], microbatches=mb)({}, batch, 0)
        assert {g.dtype for g in store["port"].values()} == {dtype}
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(model, _capturing({})[1], microbatches=3)({}, batch, 0)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "grok-1-314b", "zamba2-7b",
                                  "llama-3.2-vision-90b", "seamless-m4t-medium"])
def test_remat_gives_identical_values(arch):
    """Each config's own remat ("full" or "dots": both recompute each layer
    in backward) against ``remat="none"`` on the same weights and batch: the
    loss and every gradient bit for bit."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    assert cfg.remat != "none"
    model = build_model(cfg, device="cpu")
    plain = build_model(dataclasses.replace(cfg, remat="none"), device="cpu")
    plain.load_state_dict(model.state_dict())
    rcfg, _ = configs(arch, "float32")
    batch = to_port(make_batch(rcfg, 2, 33, 2))
    loss_a, met_a, grads_a = loss_and_grads(model, batch)
    loss_b, met_b, grads_b = loss_and_grads(plain, batch)
    assert torch.equal(loss_a, loss_b) and torch.equal(met_a["aux"], met_b["aux"])
    assert all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b", "mamba2-780m",
                                  "zamba2-7b", "llama-3.2-vision-90b", "seamless-m4t-medium"])
def test_train_forward_keeps_the_serving_values(arch):
    """Under autograd (trainable parameters, checkpointed attention tiles,
    the config's remat) the forward's logits equal the serving forward's
    under ``inference_mode``, bit for bit, in the config's bf16."""
    cfg = reduced_config(arch)
    model = build_model(cfg, device="cpu")
    rcfg, _ = configs(arch, "bfloat16")
    batch = to_port(make_batch(rcfg, 2, 32, 3))
    served = model(batch)
    model.requires_grad_(True)
    logits, _, _ = model._full_forward(batch, "train")
    assert logits.requires_grad
    assert torch.equal(served, logits.detach())


def test_flash_attention_tiles_recompute_the_same_values(monkeypatch):
    """Several q and k tiles (a shorter last one), causal and masked: the
    output with autograd recording equals the output without, and its
    gradients equal those of the same tiles run without checkpoints."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 40, h, 8), generator=g, dtype=torch.float32).to(torch.bfloat16)
               for h in (4, 2, 2))
    kw = dict(causal=True, q_chunk=16, k_chunk=16, kv_len=37)
    with torch.no_grad():
        want = flash_attention(q, k, v, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = flash_attention(*leaves, **kw)
    assert torch.equal(want, got.detach())
    cot = torch.randn(got.shape, generator=g).to(got.dtype)
    grads = torch.autograd.grad(got, leaves, cot)
    monkeypatch.setattr(attention, "checkpoint", lambda fn, *a, use_reentrant: fn(*a))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, cot)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """A deliberate difference: the reference's chunked scan takes
    ``exp(seg)`` over the whole chunk and masks it after, so where a
    within-chunk log-decay passes float32's exp range (about 88; here
    dt ~ 6 over 31 steps of a 32-chunk) backward multiplies a masked zero
    by inf and the gradients turn NaN, while the loss stays finite.  The
    port exponentiates the masked log-decay (the same values): the same
    loss, finite gradients."""
    rcfg, pcfg = configs("mamba2-780m", "float32")
    rm, _, tree, pm = reference_pair(rcfg, pcfg, 0, data_size=1)
    tree["layers"]["mamba"]["dt_bias"] = np.full_like(tree["layers"]["mamba"]["dt_bias"], 6.0)
    pm.load_state_dict(convert.params_from_reference(pcfg, tree))
    batch = make_batch(rcfg, 2, 33, 1)
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(rm.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), to_ref(batch))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(r_grads))
    loss, _, grads = loss_and_grads(pm, to_port(batch))
    assert loss_tol_ok(r_loss, loss)
    assert all(torch.isfinite(g).all() for g in grads.values())
