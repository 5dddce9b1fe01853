"""Serving driver: Lance-backed retrieval + batched generation.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
      --batch 4 --prompt-len 32 --new 16 --docs 5000 [--no-reduced] [--device cpu]

The port's copy of the reference's ``launch/serve.py``: a document store of
``--docs`` synthetic embeddings, one ``Retriever.fetch`` of ``--batch`` x
``--neighbors`` random rows, then greedy generation through
``BatchedEngine``.  The fetch takes the device route (the ``fullzip_gather``
kernel on the card, its plain version on the CPU), where the reference's
file, written with the default ``decode="numpy"``, decodes on the host: the
rows and the IO are the same.  ``--reduced`` is a real
switch here (``--no-reduced`` serves the full config); the reference's flag
is ``store_true`` with ``default=True`` and cannot be turned off.  The body
is :func:`run`, which returns its numbers.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..core.file import WriteOptions, write_table
from ..core.io_sim import NVME, S3, model_time
from ..data import synth
from ..kernels import ops
from ..models.registry import build_model
from ..serve.engine import BatchedEngine, Retriever


def run(arch: str = "smollm-360m", reduced: bool = True, batch: int = 4,
        prompt_len: int = 32, new: int = 16, docs: int = 5_000, neighbors: int = 8,
        device=None, verbose: bool = True) -> Dict:
    """Fetch ``batch * neighbors`` rows, then generate ``new`` tokens for a
    ``batch`` of prompts; on ``device`` (CUDA unless the caller names the
    CPU; raises without a card).  Returns the fetch's IO and times and the
    generation's tokens, wall time and rate."""
    dev = ops.resolve_device(device)
    rng = np.random.default_rng(0)
    # document store (the random-access consumer)
    emb = synth.scenario("embeddings", docs)
    retriever = Retriever(write_table({"embedding": emb}, WriteOptions("lance")),
                          "embedding", decode="device", device=dev)
    ids = rng.integers(0, docs, (batch, neighbors)).reshape(-1)
    t0 = time.perf_counter()
    rows, stats = retriever.fetch(ids)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_fetch = time.perf_counter() - t0
    out = {"fetch": {"rows": int(len(ids)), "n_iops": int(stats.n_iops),
                     "read_amplification": float(stats.read_amplification),
                     "wall_ms": t_fetch * 1e3,
                     "nvme_ms": model_time(stats, NVME) * 1e3,
                     "s3_ms": model_time(stats, S3) * 1e3},
           "fetched": rows}
    if verbose:
        f = out["fetch"]
        print(f"[retrieve] {f['rows']} rows: {f['n_iops']} IOPS "
              f"amp={f['read_amplification']:.2f} wall={f['wall_ms']:.1f}ms "
              f"nvme={f['nvme_ms']:.2f}ms s3={f['s3_ms']:.1f}ms")

    # generation (the sequential consumer)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    engine = BatchedEngine(model, max_new=new, device=dev)
    prompts = rng.integers(1, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    gen = engine.generate({"tokens": prompts}, n_new=new)
    dt = time.perf_counter() - t0
    out["generate"] = {"arch": cfg.name, "reduced": reduced, "tokens": gen.tokens,
                       "seconds": dt, "tokens_per_s": batch * new / dt,
                       "device": str(dev)}
    if verbose:
        print(f"[serve] {batch}x{new} tokens in {dt:.2f}s "
              f"({batch * new / dt:.1f} tok/s on {dev}, {cfg.name})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Lance-backed retrieval + batched generation")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--docs", type=int, default=5_000)
    ap.add_argument("--neighbors", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.arch, args.reduced, args.batch, args.prompt_len, args.new, args.docs,
        args.neighbors, device=args.device)


if __name__ == "__main__":
    main()
