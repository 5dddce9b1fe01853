#!/usr/bin/env python3
"""Where a token file's whole-column scan spends its host time, per route.

    python tools/profile_token_scan.py [--docs 16384] [--device cuda]

Writes ``synth.token_corpus`` (vocab 49,152, seq_len 2,048: the loader
path of ``chip_smoke.py``) as one Lance file for the device route, times
``FileReader.scan`` on the device route, the numpy route and the device
route again (host clock ending in a synchronise), then prints a cProfile of
one more device-route scan: the top functions by own time and by
cumulative time.  ``--device cpu`` runs the decode kernel's plain version.
cProfile adds cost to every Python call, so its total reads above the
plain timings.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.file import FileReader, WriteOptions, write_table  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=16384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = ops.resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    corpus = synth.token_corpus(args.docs, 2048, 49152, seed=0)
    fb = write_table({"tokens": corpus}, WriteOptions("lance", decode="device"))
    print(f"tokens {len(corpus.child.values)}, file bytes {len(fb)}, device {device}")
    for decode in ("device", "numpy", "device"):
        fr = FileReader(fb, decode=decode, device=device)
        s = time.perf_counter()
        fr.scan("tokens")
        sync()
        print(f"{decode} scan s {time.perf_counter() - s:.3f}", flush=True)
    fr = FileReader(fb, device=device)
    prof = cProfile.Profile()
    prof.enable()
    fr.scan("tokens")
    sync()
    prof.disable()
    stats = pstats.Stats(prof)
    stats.sort_stats("tottime").print_stats(15)
    stats.sort_stats("cumulative").print_stats(15)
    return 0


if __name__ == "__main__":
    sys.exit(main())
