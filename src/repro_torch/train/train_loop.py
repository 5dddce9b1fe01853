"""train_step factory: loss and gradients by autograd, global-norm clip and
the optimizer, with optional microbatch gradient accumulation.

The port's copy of the reference's ``train/train_loop.py``.  Where the
reference's jitted step takes the parameters and optimizer state and
returns new ones (donating the old), the port's step updates the model's
parameters and the state in place and returns the metrics.
"""

from __future__ import annotations

from typing import Dict

import torch

from .optimizer import Optimizer, clip_by_global_norm

__all__ = ["make_train_step", "loss_and_grads"]


def loss_and_grads(model, batch):
    """-> (loss, metrics, {name: gradient}): ``model.loss_fn`` and the
    gradient of the loss with respect to every parameter by autograd (the
    reference's ``value_and_grad``; zeros for a parameter the loss does not
    reach).  Makes the parameters trainable first."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, metrics = model.loss_fn(batch)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(p)
             for (n, p), g in zip(params.items(), gs)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, optimizer: Optimizer, *, grad_clip: float = 1.0,
                    microbatches: int = 1):
    """Makes ``model``'s parameters trainable and returns
    ``train_step(opt_state, batch, step) -> metrics`` (``loss``,
    ``grad_norm``, ``nll``, ``aux``; 0-dim tensors on the model's device),
    which updates the parameters and ``opt_state`` in place.  ``opt_state``
    is ``optimizer.init(dict(model.named_parameters()))``.  ``batch``'s
    leading dim must divide by ``microbatches``: each microbatch's
    gradients are added into float32 zeros and the sum divided by their
    count, as the reference's scan does; with one microbatch the gradients
    keep the parameters' dtype."""
    model.requires_grad_(True)
    params: Dict[str, torch.Tensor] = dict(model.named_parameters())

    def train_step(opt_state, batch, step) -> Dict[str, torch.Tensor]:
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, batch)
        else:
            n = len(batch["tokens"])
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into {microbatches} microbatches")
            size = n // microbatches
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for k, p in params.items()}
            losses, ms = [], []
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                lo, m, g = loss_and_grads(model, mb)
                for k, a in acc.items():
                    a.add_(g[k])
                losses.append(lo)
                ms.append(m)
            grads = {k: a / microbatches for k, a in acc.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        optimizer.update(grads, opt_state, params, step)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm})
        return metrics

    return train_step
