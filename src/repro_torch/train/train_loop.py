"""train_step factory: loss and gradients by autograd, global-norm clip and
the optimizer, with optional microbatch gradient accumulation.

The port's copy of the reference's ``train/train_loop.py``.  Where the
reference's jitted step takes the parameters and optimizer state and
returns new ones (donating the old), the port's step updates the model's
parameters and the state in place and returns the metrics.

A model whose MoE layers run expert-parallel (``LMModel(mesh=...,
use_sharded_moe=True)``) is one rank of a mesh that spans the job, each
rank holding its own batch shard, where the reference's jitted step takes
one global batch and ``shard_map``s the MoE layers over it.  The
reference's values then come from every rank's, in the same calls:

* the gradient: the reference differentiates the global mean nll plus
  ``router_aux_coef`` times the mean over mesh positions of each
  position's summed ``aux`` (``shard_map`` with ``check_vma=False`` divides
  the cotangent of an output by the mesh axes its spec leaves out, and sums
  an input's over them).  A rank's backward, through the collectives'
  transposes (``models/moe.py``), is its share of the gradient of the sum
  of every rank's loss, in which each data shard's loss appears once per
  model rank; so every parameter's gradient is summed over the mesh and
  divided by its size.  An expert the reference stores ``reps`` times
  (``n_experts < data size``) is held once: its gradient is the sum of its
  replicas', the gradient of tied weights;
* the reported values: ``nll`` the global mean (the mean over the mesh),
  ``aux`` that of mesh position (0, 0), the value the reference's
  ``P()`` output takes, and ``loss`` their sum weighted as in ``loss_fn``
  (which the gradient above is not quite: the reference's value and its
  gradient disagree on ``aux``).

Every rank then clips and updates the same parameters with the same
gradients, so parameters and optimizer state stay equal across ranks.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from .optimizer import Optimizer, clip_by_global_norm

__all__ = ["make_train_step", "loss_and_grads"]


def _local_loss_and_grads(model, batch):
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, metrics = model.loss_fn(batch)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(p)
             for (n, p), g in zip(params.items(), gs)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _to_global(model, loss, metrics, grads):
    """This rank's loss, metrics and gradients -> the reference's global
    ones on every rank when ``model``'s MoE layers are sharded (see the
    module docstring); else unchanged."""
    if not model.use_sharded_moe:
        return loss, metrics, grads
    mesh, world = model.mesh, dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"the mesh holds {mesh.size()} of the job's {world} ranks")
    out = {}
    for name, g in grads.items():
        g = g.contiguous()
        dist.all_reduce(g)
        out[name] = g.div_(world)
    nll = metrics["nll"].clone()
    dist.all_reduce(nll)
    nll = nll / world
    aux = metrics["aux"].clone()
    dist.broadcast(aux, src=int(mesh.mesh.flatten()[0]))
    loss = nll + model.cfg.moe.router_aux_coef * aux
    return loss, {**metrics, "nll": nll, "aux": aux}, out


def loss_and_grads(model, batch):
    """-> (loss, metrics, {name: gradient}): ``model.loss_fn`` and the
    gradient of the loss with respect to every parameter by autograd (the
    reference's ``value_and_grad``; zeros for a parameter the loss does not
    reach).  Makes the parameters trainable first.  With the sharded MoE,
    the global values on every rank of its mesh (module docstring)."""
    return _to_global(model, *_local_loss_and_grads(model, batch))


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
    keep the parameters' dtype.  With the sharded MoE, ``batch`` is this
    rank's shard, and the step reports and applies the global values on
    every rank (module docstring), once after the accumulation."""
    model.requires_grad_(True)
    params: Dict[str, torch.Tensor] = dict(model.named_parameters())

    def train_step(opt_state, batch, step) -> Dict[str, torch.Tensor]:
        if microbatches == 1:
            loss, metrics, grads = _local_loss_and_grads(model, batch)
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
                lo, m, g = _local_loss_and_grads(model, mb)
                for k, a in acc.items():
                    a.add_(g[k])
                losses.append(lo)
                ms.append(m)
            grads = {k: a / microbatches for k, a in acc.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        loss, metrics, grads = _to_global(model, loss, metrics, grads)

        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        optimizer.update(grads, opt_state, params, step)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm})
        return metrics

    return train_step
