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
  ``synchronize`` returns at once, the peak-memory counters read 0, the
  build phase builds nothing and
  ``nvidia-smi`` answers with a placeholder line;
* the ``ops.launch_*`` launchers are no-ops, except the gather's, which
  writes its plain version's result into the output (``gather_streams``
  checks outputs written by the launcher); each kernel wrapper counts one
  launch per CPU call (on the card only CUDA launches count);
* the dataset, the search, the gather's streams, the tiered takes, the
  sweeps and the L2 flush are shrunk, and the serving path runs the serve
  bench's smoke size (96 requests; its cache, half of ``emb``, and its
  appends, a quarter fragment, shrink with the dataset); the paper path's
  types, struct and nesting rows take 16 rows twice at a few thousand rows
  or fewer, the loader reads 64 short documents, the KV pool holds 256
  blocks for 8 requests over 4 decode steps (81,920-byte rows as on the
  card), the lm path serves reduced smollm-360m (2 prompts of 64 tokens, 4
  new tokens; the host reference and the family sweep as on the card, all
  on the CPU), the train path trains reduced smollm-360m (3 steps of
  2 x 64 positions; its checks and the family sweep as on the card with 4
  overfit steps and a 33-token host batch, the "card" side in bf16 on the
  CPU), and the sharded MoE path runs reduced deepseek-v2-lite (2 prompts of
  64 tokens, 2 timed prefills, 4 new tokens) and the expert-parallel
  train path trains reduced deepseek-v2-lite cut to 2 layers (3 steps of
  2 x 64 positions; its checks as on the card) on a world-1 gloo mesh.

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
    ('PAPER_ROWS = {"scalar": 8_388_608, "string": 4_194_304, "scalar-list": 1_677_722,\n'
     '              "string-list": 838_861, "vector": 21_845, "vector-list": 4_369,\n'
     '              "image": 3_277, "image-list": 655}',
     'PAPER_ROWS = {"scalar": 4096, "string": 2048, "scalar-list": 512, "string-list": 256,\n'
     '              "vector": 64, "vector-list": 24, "image": 24, "image-list": 20}'),
    ("TAKE_N, TAKE_REPEATS = 256, 3", "TAKE_N, TAKE_REPEATS = 16, 2"),
    ("STRUCT_ROWS, STRUCT_FIELDS = 1 << 20, 5", "STRUCT_ROWS, STRUCT_FIELDS = 1 << 10, 5"),
    ("NEST_ROWS, NEST_DEPTHS = 1 << 20, (0, 1, 2, 3)", "NEST_ROWS, NEST_DEPTHS = 1 << 10, (0, 1, 2, 3)"),
    ("LOADER_DOCS, LOADER_VOCAB, LOADER_SEQ, LOADER_BATCH = 16384, 49152, 2048, 8",
     "LOADER_DOCS, LOADER_VOCAB, LOADER_SEQ, LOADER_BATCH = 64, 49152, 64, 8"),
    ("KV_FEATURES, KV_BLOCKS = 5 * 64, 16384", "KV_FEATURES, KV_BLOCKS = 5 * 64, 256"),
    ("KV_REQUESTS, KV_PROMPT = 256, (512, 8192)", "KV_REQUESTS, KV_PROMPT = 8, (1, 300)"),
    ("KV_STEPS, KV_REPLACE_AT = 32, 16", "KV_STEPS, KV_REPLACE_AT = 4, 2"),
    ('LM_ARCH, LM_REDUCED = "smollm-360m", False', 'LM_ARCH, LM_REDUCED = "smollm-360m", True'),
    ("LM_BATCH, LM_PROMPT, LM_NEW, LM_NEIGHBORS = 8, 2048, 32, 8",
     "LM_BATCH, LM_PROMPT, LM_NEW, LM_NEIGHBORS = 2, 64, 4, 8"),
    ("LM_PARAMS = (361_758_720, 361_821_120)", "LM_PARAMS = (655_360, 656_512)"),
    ('TRAIN_ARCH, TRAIN_REDUCED = "smollm-360m", False', 'TRAIN_ARCH, TRAIN_REDUCED = "smollm-360m", True'),
    ("TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 2048", "TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 2, 64"),
    ("TRAIN_OVERFIT, TRAIN_OVERFIT_LR, TRAIN_HOST_TOKENS = 8, 3e-3, 65",
     "TRAIN_OVERFIT, TRAIN_OVERFIT_LR, TRAIN_HOST_TOKENS = 4, 3e-3, 33"),
    ('MOE_ARCH, MOE_REDUCED, MOE_BACKEND = "deepseek-v2-lite-16b", False, "nccl"',
     'MOE_ARCH, MOE_REDUCED, MOE_BACKEND = "deepseek-v2-lite-16b", True, "gloo"'),
    ("MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_TIMED = 4, 2048, 16, 5",
     "MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_TIMED = 2, 64, 4, 2"),
    ("MOE_PARAMS = 16_210_198_528", "MOE_PARAMS = 944_128"),
    ("MOE_TRAIN_REDUCED, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = False, 4, 5",
     "MOE_TRAIN_REDUCED, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = True, 2, 3"),
    ("MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 2048", "MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 64"),
    ("MOE_TRAIN_PARAMS = (2_758_803_456, 751_828_992)", "MOE_TRAIN_PARAMS = (537_600, 439_296)"),
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
        multi_processor_count=132, total_memory=0)
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda: None
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
                          ("bitunpack", "bitunpack"),
                          ("miniblock_take", "miniblock_take")):
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
    # the rehearsal's operators are small: two intra-op threads run it as
    # fast as all the cores do, and leave the rest to parallel test workers
    torch.set_num_threads(min(2, torch.get_num_threads()))
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
