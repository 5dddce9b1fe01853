#!/usr/bin/env python3
"""The rope table's base as a tensor on the card against a Python float,
in one process on one card, by turns (tensor, float, float, tensor, ...).

    python tools/compare_rope_bases.py [--pairs 2]

Needs an NVIDIA GPU.  ``models.common.rope_freqs`` takes ``theta ** exps``
with a float base; the other side builds ``torch.tensor(theta,
device=cuda)``, a host-to-device copy that waits for the card, once per
attention layer and call.  Both give the same tables.  On smollm-360m at
full width and depth in bf16 it times, per side and turn: 32 decode steps
of 8 requests after a 2,048-token prefill through ``BatchedEngine``
(CUDA-event ms a step and host enqueue ms a step), and 3 adamw train steps
of 8 x 2,048 positions (CUDA-event ms); ``--pairs`` pairs of turns, each
pair in the other order from the one before.  One JSON line per turn, then
the medians per side.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, build_model, common  # noqa: E402
from repro_torch.serve import BatchedEngine  # noqa: E402
from repro_torch.train import make_optimizer, make_train_step  # noqa: E402


def rope_tensor_base(head_dim, theta, positions):
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=positions.device) ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


SIDES = {"tensor": rope_tensor_base, "float": common.rope_freqs}


def timed_decode(model, prompts):
    engine = BatchedEngine(model, max_new=32)
    events, host = [], []
    real = model.decode_step

    def step(*a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        h = time.perf_counter()
        s.record()
        out = real(*a)
        e.record()
        host.append((time.perf_counter() - h) * 1e3)
        events.append((s, e))
        return out

    model.decode_step = step
    try:
        engine.generate({"tokens": prompts}, n_new=32)
        torch.cuda.synchronize()
    finally:
        del model.decode_step
    return float(np.mean([s.elapsed_time(e) for s, e in events])), float(np.mean(host))


def timed_train(step, state, batch, first):
    out = []
    for i in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        step(state, batch, first + i)
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.mean(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    pairs = ap.parse_args().pairs
    if not torch.cuda.is_available():
        print("compare_rope_bases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = get_config("smollm-360m")
    pos = torch.arange(4096, device=dev).expand(8, 4096)
    same = all(torch.equal(a, b) for a, b in zip(rope_tensor_base(64, cfg.rope_theta, pos),
                                                  common.rope_freqs(64, cfg.rope_theta, pos)))
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (8, 2048)).astype(np.int32)
    batch = {"tokens": rng.integers(1, cfg.vocab, (8, 2049)).astype(np.int32)}
    for side in ("tensor", "float"):  # warm-up
        attention.rope_freqs = SIDES[side]
        timed_decode(model, prompts)
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt)
    n = 0
    for side in ("tensor", "float"):
        attention.rope_freqs = SIDES[side]
        timed_train(step, state, batch, n)
        n += 3
    order = [side for i in range(pairs)
             for side in (("tensor", "float") if i % 2 == 0 else ("float", "tensor"))]
    runs = {"tensor": [], "float": []}
    for turn, side in enumerate(order):
        attention.rope_freqs = SIDES[side]
        dec_ms, host_ms = timed_decode(model, prompts)
        train_ms = timed_train(step, state, batch, n)
        n += 3
        rec = {"decode_ms": dec_ms, "decode_host_enqueue_ms": host_ms, "train_step_ms": train_ms}
        runs[side].append(rec)
        print(json.dumps({"turn": turn, "base": side, **rec, "same_tables": same,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    attention.rope_freqs = common.rope_freqs
    print(json.dumps({"medians": {side: {k: float(np.median([r[k] for r in rs])) for k in rs[0]}
                                  for side, rs in runs.items()}, "pairs": pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
