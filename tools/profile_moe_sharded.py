#!/usr/bin/env python3
"""Where one sharded MoE layer of a full-size prefill spends its device time.

    python tools/profile_moe_sharded.py [--arch deepseek-v2-lite-16b]
        [--batch 4] [--prompt 2048] [--layers 2] [--device cuda]

Builds the config at full width with ``--layers`` layers in its own dtype
(weights from a generator seeded 0) on a world-1 mesh
(``launch.mesh.make_host_mesh``: NCCL on ``cuda``), runs one warm-up prefill
of ``--batch`` x ``--prompt`` random tokens with the sharded MoE, then
profiles one call of the last layer's ``moe_apply_sharded`` on that
prefill's input to the layer (``torch.profiler``): the device time by
kernel, the device busy time against the call's CUDA-event time, and the
host time by operator.  ``--device cpu`` runs it on a gloo mesh (the
profile then has no device rows).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.moe import moe_apply_sharded, shard_moe_params  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    mesh = make_host_mesh(dev)
    try:
        cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
        model = build_model(cfg, mesh=mesh, data_size=1, use_sharded_moe=True, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        moe = model.layers[-1].moe
        seen = []
        hook = moe.register_forward_pre_hook(lambda mod, a: seen.append(a[0].detach()))
        tokens = torch.randint(1, cfg.vocab, (args.batch, args.prompt), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        model.prefill({"tokens": tokens})
        hook.remove()
        x = seen[-1]
        params = shard_moe_params(moe, mesh)
        with torch.no_grad():
            moe_apply_sharded(params, cfg, x, mesh)  # warm-up
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            with torch.profiler.profile(activities=activities) as prof:
                if dev.type == "cuda":
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                moe_apply_sharded(params, cfg, x, mesh)
                if dev.type == "cuda":
                    e.record()
                    torch.cuda.synchronize()
        if dev.type == "cuda":
            kernels = [ev for ev in prof.events() if str(ev.device_type).endswith("CUDA")]
            busy = sum(ev.device_time for ev in kernels) / 1e3
            print(f"{cfg.name} layer {args.layers - 1}: {len(kernels)} kernels, device busy "
                  f"{busy:.3f} ms of {s.elapsed_time(e):.3f} ms (CUDA events)")
            print(prof.key_averages().table(sort_by="device_time_total", row_limit=20,
                                            max_name_column_width=70))
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=20,
                                        max_name_column_width=70))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
