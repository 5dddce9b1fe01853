"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \\
      --steps 200 --batch 8 --seq 256 [--device cpu]

The port's copy of the reference's ``launch/train.py``, in its order: the
config, the model (``build_model``, weights drawn from a generator seeded
0), the optimizer the config names, the train step, then a Lance token
file of ``max(64, 4 * batch)`` synthetic documents read by a
``TokenLoader``, whose ``batch_for_step(step)`` feeds each step.  The token
file is written for the device route (``WriteOptions("lance",
decode="device")``), so every step's scan of the token column decodes its
mini-block chunks through the ``miniblock_decode`` kernel on the card (its
plain version on the CPU); the reference writes its file for the numpy
route, and the batches are the same.

Not carried, and refused with ``NotImplementedError``: checkpointing
(``ckpt_dir``, ``ckpt_every``) and fault injection with restart
(``inject_failure_at``), which the reference builds on ``repro.dist``, a
package its tree does not have (ROADMAP.md, "Not to port"); and the
production mesh (``mesh_kind="production"``), whose reference path shards
its parameters through ``repro.dist.sharding`` as well.  Steps run on
``device``: CUDA unless the caller names the CPU, raising without a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, reduced_config
from ..core.file import WriteOptions, write_table
from ..data import synth
from ..data.loader import TokenLoader
from ..kernels import ops
from ..models.registry import build_model
from ..train.optimizer import make_optimizer
from ..train.train_loop import make_train_step

_NO_DIST = ("{} needs the reference's repro.dist (checkpointing, heartbeat and restart), "
            "which its tree does not have (ROADMAP.md, 'Not to port')")
_NO_MESH = ("the production mesh shards through the reference's repro.dist.sharding, "
            "which its tree does not have (ROADMAP.md, 'Not to port')")


def train(arch: str, *, reduced: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, ckpt_dir=None, ckpt_every=None, mesh_kind: str = "host",
          microbatches: int = 1, lr: float = 3e-4, log_every: int = 10,
          inject_failure_at=None, device=None):
    """Train ``arch`` for ``steps`` steps; -> (the last step's loss, the
    number of steps run)."""
    for name, value in (("ckpt_dir", ckpt_dir), ("ckpt_every", ckpt_every),
                        ("inject_failure_at", inject_failure_at)):
        if value is not None:
            raise NotImplementedError(_NO_DIST.format(name))
    if mesh_kind != "host":
        raise NotImplementedError(_NO_MESH)
    dev = ops.resolve_device(device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    if cfg.family in ("vlm", "audio"):
        # the reference's loop fails the same way, later (a KeyError in the
        # model): its loader yields tokens only
        raise ValueError(f"{arch}: the token loader feeds no "
                         f"{'vision_embeds' if cfg.family == 'vlm' else 'frames'}")
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    opt = make_optimizer(cfg.optimizer, lr=lr)
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(model, opt, microbatches=microbatches)

    # data: a Lance-encoded token file (full-scan consumer), device route
    corpus = synth.token_corpus(max(64, batch * 4), seq, cfg.vocab, 0)
    fbytes = write_table({"tokens": corpus}, WriteOptions("lance", decode="device"))
    loader = TokenLoader(fbytes, batch=batch, seq_len=seq, seed=0, device=dev)
    loss = None
    try:
        for step in range(steps):
            t0 = time.perf_counter()
            metrics = step_fn(opt_state, loader.batch_for_step(step), step)
            loss = float(metrics["loss"])
            if step % log_every == 0:
                print(f"[train] step {step} loss={loss:.4f} "
                      f"{(time.perf_counter() - t0) * 1e3:.0f}ms", flush=True)
    finally:
        loader.close()
    return loss, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--mesh", choices=["host", "production"], default="host")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    loss, last = train(args.arch, reduced=args.reduced, steps=args.steps,
                       batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, mesh_kind=args.mesh,
                       microbatches=args.microbatches, lr=args.lr, device=args.device)
    print(f"[train] done at step {last - 1}, final loss {loss:.4f}")


if __name__ == "__main__":
    main()
