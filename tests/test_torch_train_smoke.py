"""The reference's training smoke tests (``tests/test_models.py``:
``test_smoke_train_step``, ``test_smoke_loss_decreases``) on the port, for
every config of ``ARCHS`` at ``reduced_config`` (bfloat16, the config's own
optimizer and remat), on the CPU.  The batch is the reference's ``_batch``
drawn with numpy (2 x 33 tokens; the vlm's vision embeddings and the audio
model's frames)."""

import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread, smoke_batch  # noqa: F401
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import build_model
from repro_torch.train import make_optimizer, make_train_step

ALL_ARCHS = list(ARCHS)


def _model(cfg):
    return build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_train_step(arch):
    cfg = reduced_config(arch)
    model = _model(cfg)
    params = dict(model.named_parameters())
    before = {k: v.detach().clone() for k, v in params.items()}
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    opt_state = opt.init(params)
    metrics = make_train_step(model, opt)(opt_state, smoke_batch(cfg), 0)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    # params actually changed
    delta = [float((before[k].float() - v.detach().float()).abs().max()) for k, v in params.items()]
    assert max(delta) > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_loss_decreases(arch):
    cfg = reduced_config(arch)
    model = _model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=3e-3)
    opt_state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt)
    batch = smoke_batch(cfg)  # overfit one batch
    losses = [float(step(opt_state, batch, i)["loss"]) for i in range(8)]
    assert losses[-1] < losses[0], losses
