#!/usr/bin/env python3
"""Where ``Disk.read_gather``'s span-by-span copy overtakes its per-byte index.

    python tools/gather_crossover.py [--disk-mb 64] [--out FILE]

Times the two routes of an unequal-size gather on this host's CPU, the
``"sliced"`` copy (one slice a span into a preallocated buffer) and the
``"indexed"`` one (one int64 index a byte), over mean span sizes from 16 B to
16 KiB and 64, 256 and 4,096 spans a call (sizes uniform in [m/2, 3m/2],
offsets uniform over the disk), by forcing
``io_sim.GATHER_SLICE_MIN_BYTES`` to 0 and to a size no span reaches.  Prints
one JSON line a shape (median ms of each route) and a last line with the
smallest mean size at which the sliced copy is no slower at every span
count: the value ``GATHER_SLICE_MIN_BYTES`` should take on this host.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import io_sim  # noqa: E402

MEANS = (16, 32, 64, 96, 128, 192, 256, 384, 512, 1024, 4096, 16384)
SPANS = (64, 256, 4096)


def timed(fn, reps: int) -> float:
    fn()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return statistics.median(out) * 1e3


def route_ms(disk, offsets, sizes, threshold: int, reps: int) -> float:
    io_sim.GATHER_SLICE_MIN_BYTES = threshold
    return timed(lambda: disk.read_gather(offsets, sizes), reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--disk-mb", type=int, default=64)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(29)
    disk = io_sim.Disk(rng.integers(0, 256, args.disk_mb << 20, dtype=np.uint8))
    saved = io_sim.GATHER_SLICE_MIN_BYTES
    lines, wins = [], {}
    try:
        for n in SPANS:
            for m in MEANS:
                sizes = rng.integers(m // 2, m + m // 2 + 1, n)
                sizes[0] = m // 2  # never all equal
                sizes[-1] = m + m // 2
                offsets = rng.integers(0, len(disk) - sizes.max(), n)
                assert io_sim.gather_route(sizes) != "strided"
                want = disk.read_gather(offsets, sizes)[0]
                io_sim.GATHER_SLICE_MIN_BYTES = 0
                assert np.array_equal(disk.read_gather(offsets, sizes)[0], want)
                sliced = route_ms(disk, offsets, sizes, 0, args.reps)
                indexed = route_ms(disk, offsets, sizes, 1 << 62, args.reps)
                lines.append({"spans": n, "mean_bytes": m, "sliced_ms": sliced,
                              "indexed_ms": indexed, "ratio": indexed / sliced})
                wins.setdefault(m, []).append(sliced <= indexed)
    finally:
        io_sim.GATHER_SLICE_MIN_BYTES = saved
    cut = next((m for m in MEANS if all(all(wins[k]) for k in MEANS if k >= m)), None)
    lines.append({"crossover_mean_bytes": cut, "current": saved})
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
