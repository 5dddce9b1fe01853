"""Training on the port against the JAX reference: ``LMModel.loss_fn`` and
its gradients by autograd, for every family.

Each case converts a reduced config's reference parameters (float32,
perturbed so that no leaf is constant; MoE built with ``data_size=1``, each
expert held once, as the port holds it) into the port and feeds both
packages the same numpy batch of (B, S + 1) tokens: the loss, ``nll`` and
``aux`` within 1e-5 relative, and every gradient within 1e-4 of its
tensor's max |gradient| (the two frameworks sum in different orders; the
measured worst is under 1e-5).  The families' vlm and audio cases live in
``test_torch_train_families.py``.
"""

import pytest

from _torch_train import GRAD_TOL, grads_case, loss_tol_ok, one_torch_thread  # noqa: F401

ARCHS = ["smollm-360m", "qwen1.5-4b", "qwen2-72b", "qwen1.5-32b", "mamba2-780m",
         "grok-1-314b", "deepseek-v2-lite-16b", "zamba2-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    case = grads_case(arch)
    for key in ("loss", "nll", "aux"):
        assert loss_tol_ok(case["ref"][key], case["port"][key]), (key, case["ref"][key],
                                                                   case["port"][key])
    worst = max(case["grad_errs"], key=case["grad_errs"].get)
    assert case["grad_errs"][worst] <= GRAD_TOL, (worst, case["grad_errs"][worst])
