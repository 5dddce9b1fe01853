"""End-to-end driver on the PyTorch/CUDA port: train a narrowed smollm.

The twin of ``examples/train_lm.py``: Lance mini-block token storage ->
the scan loader (device route: ``miniblock_decode`` on the card) -> the
train step (autograd, global-norm clip, AdamW).  It trains smollm-360m
narrowed as the reference's example narrows it (d_model 960 -> 512, 12
layers, vocab 32,768), which that example calls ~100M parameters;
``param_counts`` gives 54.5M.  It takes no ``ckpt_dir``: the reference
checkpoints through ``repro.dist``, which its tree does not have, so its
example does not run and the port carries no checkpointer.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs as C  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.registry import param_counts  # noqa: E402


def smollm_100m():
    """smollm-360m narrowed as the reference's example narrows it."""
    return dataclasses.replace(
        C.get_config("smollm-360m"), name="smollm-100m", n_layers=12, d_model=512,
        d_ff=1536, n_heads=8, n_kv_heads=4, head_dim=64, vocab=32768)


def run(cfg, steps: int, batch: int, seq: int, device=None):
    """Register ``cfg`` under its name and train it -> (loss, steps)."""
    C.ARCHS[cfg.name] = cfg
    total, _ = param_counts(cfg)
    print(f"[example] training {cfg.name}: {total / 1e6:.1f}M params")
    loss, last = train(cfg.name, reduced=False, steps=steps, batch=batch, seq=seq,
                       device=device)
    print(f"[example] finished step {last - 1}, loss {loss:.4f}")
    return loss, last


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(smollm_100m(), args.steps, args.batch, args.seq, args.device)


if __name__ == "__main__":
    main()
