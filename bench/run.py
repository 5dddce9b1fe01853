#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this machine holds.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints information lines, then, as its last line, the result: one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared`` (each number
compared with the reference beside its limit, also the last lines on
standard error).  Exits non-zero and prints no result:

* 2 without enough CUDA devices;
* 3 if JAX or the JAX package got loaded;
* 4 if the card runs none of the cell's reads (``cell.NoDeviceRoute``): a
  warm-up request fell back to the host, so the window never starts, or a
  traced window saw no device time.  One line on standard error,
  ``<workload>: no device route: <what fell back>``, says so.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout; the
# port's own CUDA libraries build into build/repro_torch_kernels/
CACHE = ROOT / "build" / "bench_cache"
CACHE_VARS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


# glibc's mallopt parameters, and the values its dynamic rule climbs to on
# a 64-bit host (the mmap threshold's ceiling, and twice it for the trim
# threshold).  Fixed from the start, a run's host allocations do not move
# between the heap and mmap as the rule adapts to what it has freed, so
# every run of one code starts from one allocator state.
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
MMAP_THRESHOLD_BYTES = 32 << 20
TRIM_THRESHOLD_BYTES = 64 << 20


def pin_allocator() -> None:
    """Fix glibc's mmap and trim thresholds for this process, before torch
    or the port allocates; raises where the C library refuses."""
    mallopt = ctypes.CDLL(None).mallopt
    mallopt.argtypes, mallopt.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for param, value in ((M_MMAP_THRESHOLD, MMAP_THRESHOLD_BYTES),
                         (M_TRIM_THRESHOLD, TRIM_THRESHOLD_BYTES)):
        if mallopt(param, value) != 1:
            raise RuntimeError(f"mallopt({param}, {value}) was refused")


def card_state() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_allocator()
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from bench import manifest

    cell_ = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell_.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    from bench import cell

    try:
        result = cell.run_cell(cell_, args.seed, args.seconds, bool(args.trace),
                               device="cuda", t_start=T_START)
    except cell.NoDeviceRoute as e:
        print(f"{args.workload}: no device route: {e}", file=sys.stderr, flush=True)
        return 4
    found = cell.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    cell.info(card=card_state(), torch=torch.__version__, cuda=torch.version.cuda)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
