#!/usr/bin/env python3
"""Where a full-width train step makes the host wait for the card.

    python tools/probe_train_syncs.py

Needs an NVIDIA GPU.  Trains smollm-360m at full width and depth in bf16
(adamw, 8 x 2,048 positions of random tokens) and runs its steps with
``torch.utils.checkpoint``'s ``preserve_rng_state`` on and off in turns
(on, off, off, on, on, off after one warm-up step each), timing each step
by CUDA events and the host clock; then profiles one step of each and
counts the ``cudaStreamSynchronize`` / ``cudaDeviceSynchronize`` calls, the
host time in them and the operators that made them (each call's enclosing
profiler event).  One JSON line per setting.  The model draws no
random numbers, so the setting changes no value.
"""

import functools
import json
from collections import Counter
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.utils.checkpoint as ckpt

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, build_model, transformer  # noqa: E402
from repro_torch.train import make_optimizer, make_train_step  # noqa: E402

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_train_syncs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = get_config("smollm-360m")
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt)
    batch = {"tokens": np.random.default_rng(0).integers(1, cfg.vocab, (8, 2049)).astype(np.int32)}
    real, count = ckpt.checkpoint, [0]

    def setting(preserve):
        fn = functools.partial(real, preserve_rng_state=preserve)
        attention.checkpoint = transformer.checkpoint = fn

    def one():
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h = time.perf_counter()
        s.record()
        metrics = step(state, batch, count[0])
        e.record()
        host_ms = (time.perf_counter() - h) * 1e3
        torch.cuda.synchronize()
        count[0] += 1
        return {"step_ms": s.elapsed_time(e), "host_ms": host_ms, "loss": float(metrics["loss"])}

    for preserve in (True, False):
        setting(preserve)
        one()
    runs = {True: [], False: []}
    for preserve in (True, False, False, True, True, False):
        setting(preserve)
        runs[preserve].append(one())
    for preserve in (True, False):
        setting(preserve)
        with torch.profiler.profile(activities=list(torch.profiler.supported_activities())) as p:
            one()
        waits = [e for e in p.events() if e.name in SYNCS]
        callers = Counter(e.cpu_parent.name if e.cpu_parent is not None else "-" for e in waits)
        print(json.dumps({"preserve_rng_state": preserve, "steps": runs[preserve],
                          "syncs": len(waits),
                          "sync_ms": sum(e.time_range.elapsed_us() for e in waits) / 1e3,
                          "callers": dict(callers.most_common()),
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
