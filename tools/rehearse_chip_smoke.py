#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU, at a tiny size, in a few seconds.

    python tools/rehearse_chip_smoke.py

``chip_smoke.py`` needs an NVIDIA GPU.  This runs its phases end to end
without one, to catch wrong paths, arguments, shapes and control flow before
a run on the card:

* every ``"cuda"`` in the script becomes ``"cpu"`` and the entry points'
  device resolution returns the CPU, so the device routes run the kernels'
  plain versions;
* the CUDA-only measurement is stubbed: ``torch.cuda.Event`` reads the host
  clock, ``torch.cuda.CUDAGraph`` / ``torch.cuda.graph`` run the captured
  code once and replay nothing, streams are one host stream,
  ``synchronize`` returns at once, the build phase builds nothing and
  ``nvidia-smi`` answers with a placeholder line;
* the ``ops.launch_*`` launchers are no-ops, except the gather's, which
  writes its plain version's result into the output (``gather_streams``
  checks outputs written by the launcher); each kernel wrapper counts one
  launch per CPU call (on the card only CUDA launches count);
* the dataset, the search, the gather's streams, the tiered takes, the
  sweeps and the L2 flush are shrunk, and the serving path runs the serve
  bench's smoke size (96 requests; its cache, half of ``emb``, and its
  appends, a quarter fragment, shrink with the dataset).

Every number it prints is a CPU number under the script's device names, so
none of them is a measurement.  It exits with the script's code.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.dataset import writer as writer_module  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

# (text in chip_smoke.py, its stand-in here)
SHRINK = (
    ('"cuda"', '"cpu"'),
    (".cuda()", ".cpu()"),
    ("ROWS = 1 << 20", "ROWS = 1 << 12"),
    ("TAKE_SIZES = (1024, 16384, 65536)", "TAKE_SIZES = (64, 256, 1024)"),
    ("PARTITIONS, INDEX_FRAGMENTS, K = 256, 2, 10", "PARTITIONS, INDEX_FRAGMENTS, K = 16, 2, 10"),
    ("SEARCHES = ((1, 32), (8, 32), (4, PARTITIONS))", "SEARCHES = ((1, 2), (8, 2), (4, PARTITIONS))"),
    ("BITUNPACK_N, BITUNPACK_BITS = 1 << 20, 11", "BITUNPACK_N, BITUNPACK_BITS = 1 << 12, 11"),
    ("BITUNPACK_BIG_N = 1 << 24", "BITUNPACK_BIG_N = 1 << 14"),
    ("flush_bytes: int = 128 << 20", "flush_bytes: int = 1 << 10"),
    ("calls: int = 1000", "calls: int = 3"),
    ("ref.ivf_hazard_cases(rng)", "ref.ivf_hazard_cases(rng, n=600, dim=8)"),
    ("ref.gather_cases(rng)", "ref.gather_cases(rng, n_rows=40)"),
    ("GATHER_ROWS, GATHER_STRIDE = 16429, 1536", "GATHER_ROWS, GATHER_STRIDE = 64, 1536"),
    ("GATHER_STREAMS, GATHER_ROUNDS, GRAPH_REPLAYS = 65, 3, 20",
     "GATHER_STREAMS, GATHER_ROUNDS, GRAPH_REPLAYS = 3, 1, 2"),
    ("TIERED_TAKES = (1024, 16384)", "TIERED_TAKES = (64, 256)"),
    ("CRASH_ROWS = 4096", "CRASH_ROWS = 64"),
    ("TIERED_SCAN_CHUNK = 64 << 10", "TIERED_SCAN_CHUNK = 256"),
    ("SERVE_REQUESTS, SERVE_RATE, SERVE_ROWS, SERVE_QD = 1500, 200.0, 32, 32",
     "SERVE_REQUESTS, SERVE_RATE, SERVE_ROWS, SERVE_QD = 96, 200.0, 32, 32"),
)


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _Graph:
    def replay(self):
        pass


class _Stream:
    def __init__(self, *_, **__):
        pass

    def wait_stream(self, other):
        pass


class _Capture:
    def __init__(self, graph, **_):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _stub_cuda() -> None:
    torch.cuda.Event = _Event
    torch.cuda.CUDAGraph = _Graph
    torch.cuda.graph = _Capture
    torch.cuda.Stream = _Stream
    torch.cuda.current_stream = lambda *a: _Stream()
    torch.cuda.stream = lambda s: contextlib.nullcontext()
    torch.cuda.get_device_properties = lambda *a: types.SimpleNamespace(
        multi_processor_count=132)
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda *a: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    ops.resolve_device = cpu
    writer_module.resolve_device = cpu
    build.build_kernels = lambda: {"seconds": 0.0, "built": [], "ptxas": []}
    build.load_kernels = lambda: None
    for name, wrapper in (("miniblock_decode", "miniblock_decode"),
                          ("fullzip_gather", "fullzip_gather"),
                          ("ivf_topk", "ivf_topk_tensors"),
                          ("bitunpack", "bitunpack")):
        setattr(ops, f"launch_{name}", lambda *a, **k: None)

        def counted(*a, _real=getattr(ops, wrapper), _name=name, **k):
            out = _real(*a, **k)
            ops.launches[_name] += 1
            return out

        setattr(ops, wrapper, counted)
    ops.launch_fullzip_gather = lambda zipped, rows, out: out.copy_(
        ref.fullzip_gather_ref(zipped, rows))
    real_run = subprocess.run

    def run(cmd, *a, **k):
        if cmd and cmd[0] == "nvidia-smi":
            return types.SimpleNamespace(stdout="CPU rehearsal, 0 W\n")
        return real_run(cmd, *a, **k)

    subprocess.run = run


def main() -> int:
    script = ROOT / "chip_smoke.py"
    src = script.read_text()
    for old, new in SHRINK:
        if old not in src:
            raise SystemExit(f"rehearse: chip_smoke.py no longer has {old!r}")
        src = src.replace(old, new)
    _stub_cuda()
    sys.argv = [str(script)]
    code = compile(src, str(script), "exec")
    try:
        exec(code, {"__name__": "__main__", "__file__": str(script)})
    except SystemExit as e:
        return int(e.code or 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
