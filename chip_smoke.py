#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON object per line on stdout:

1. the card (``nvidia-smi`` name and power limit, also printed as it gives them);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` (seconds, ptxas lines);
3. the kernel sweep: each CUDA kernel against its plain PyTorch version on
   the card, over the shape sweeps of the tests, the edge cases of the
   mini-block decode's slices and of the unpack's runs included
   (``ref.miniblock_edge_cases``, ``ref.bitunpack_cases``; tolerance 0, except
   ``ivf_topk``: distances within 1e-6 of ``|d| + |q|^2 + max |c|^2``, the
   size of the terms the expanded form rounds at, and ids exact outside near
   ties, whose count it prints);
4. the take path: a dataset of 1,048,576 rows in 4 Lance files made from
   ``--seed`` (``id`` int64, ``score`` nullable int32, ``tags``
   List<int32> with nulls at both levels, ``emb`` FixedSizeList<float32>[384]),
   read through ``DatasetReader(decode="device")``: takes of 1,024 / 16,384 /
   65,536 random rows with duplicates on every column, and scans of ``id``
   and ``tags``.  Every result must equal the numpy route's and the source
   table's, with identical logical IO and modelled time; both kernels must
   have launched and no eligible column may fall back to the host;
5. the search path over the same four files: ``DatasetWriter(store="flat",
   flush=None)`` ingests them, ``IvfIndex.build`` trains 256 partitions on
   ``emb`` and stores the index as 2 fragments, and ``Retriever.search``
   answers batches of 1 and 8 queries at k = 10, nprobe = 32 and one
   exhaustive batch of 4 at nprobe = 256, on the device route and the numpy
   route.  Results must agree (the rule above), IO accounting must be
   identical, ``ivf_topk`` must launch on both steps of every search with no
   ``decode.fallback.ivf.*``, and the exhaustive batch must reach recall@10
   = 1.0 against a float64 brute force;
6. the tiered path over the same four files (``tiered``): the reference's
   deployment shape, an NVMe block cache (64 MB, 16,384 blocks of 4 KiB,
   clock, always-admit) over S3.  ``DatasetReader(store="tiered")`` takes
   1,024 and 16,384 random rows on every column cold (after
   ``drop_caches``) and warm, and scans ``id`` cold in 64 KiB windows with
   readahead;
   ``store="hot"`` (RAM over NVMe over S3) takes 1,024 rows cold and warm;
   ``store="tiered-auto"`` scans, then takes, and prints its admission
   flips; ``Retriever(store="tiered")`` fetches 1,024 ids cold and warm;
   ``DatasetWriter`` at the reference's defaults (tiered, write-back)
   ingests the files, takes the committed rows, then crashes with an
   uncommitted append in flight.  Each step runs on the device route and on
   a numpy-route twin in lockstep: results equal the source, and the twins'
   ``tier_stats()``, ``io_stats()``, ``write_stats()`` and
   ``modelled_time()`` are identical after every step; logical IO and the
   write trace equal the flat store's.  Each line gives both routes' wall
   ms, the kernels' and copies' ms, ``store_ms`` (host time in the store's
   batch-close accounting: coalescing, per-block classification,
   readahead, flush policy) and the modelled IO ms;
7. the serving path (``serve``): the JAX package's serve and chaos benches
   (``benchmarks/run.py`` ``serve_bench``, ``chaos_bench``) at full size
   over the same four files.  ``DatasetWriter`` on a tiered store whose NVMe
   cache holds half of ``emb`` (768 MiB; write-back, queue depth 32, a
   ``Tracer``) serves 1,500 open-loop requests of 32 Zipf-skewed rows
   (s = 1.05, Poisson at 200 requests per virtual second, seed 3) of
   ``emb`` for two tenants, ``premium`` (share 1, weight 4, priority 1) and
   ``standard`` (share 2, weight 1), through ``serve.workload.drive``, while
   an ``ingest`` tenant appends a 65,536-row fragment every 187 requests and
   commits every second append.  A numpy-route twin without a tracer serves
   the same stream: the interleaved and serial completions, tier stats, IO,
   write trace, modelled time and every take's values must be identical,
   and each take must equal the source rows.  The captured window is then
   re-priced with a metrics plane and an SLO monitor (completions
   bit-identical), by the bare event loop (equal to the healthy run), and
   under the chaos bench's scenarios with its gates: transient NVMe errors,
   an NVMe blackout with and without failover, a correlated NVMe+S3
   brownout (held to conservation only: at this load S3 is saturated and
   the reference's retry deadlines fail requests, see ``serve_chaos``), and
   the shed drill.  It prints per-tenant virtual-clock
   percentiles, the NVMe hit rate, each scenario's counters, the host wall
   time per request on both routes with the kernels' and copies' share, and
   the trace's event counts (exported to ``build/serve_trace.json``); no
   fallback may be counted, in ``ops.fallbacks`` or in the tracer;
8. the LM serving path (``lm``): ``Retriever(decode="device")`` fetches
   launch/serve.py's 8 x 8 random ``emb`` rows (against its numpy twin and
   the source, identical IO; ``fullzip_gather``), then smollm-360m at full
   width and depth (32 layers, 361,821,120 parameters, bf16, drawn from a
   ``torch.Generator`` seeded by ``--seed``) serves 8 prompts of 2,048
   tokens from ``synth.token_corpus`` (the loader path's batch and
   seq_len) through ``BatchedEngine``: 32 new tokens after a warm-up.
   Checks, on the card: the first decode step against the full forward of
   the prompt plus its token (< 0.06 of max |logit|, tests/test_models.py's
   bound); 4 decoded tokens of 2 requests replayed through full prefills,
   each within 0.02 of max |logit| of the row's max; a 64-token prefill
   against the same weights in float32 on the CPU (< 0.06); the blockwise
   attention against ``scaled_dot_product_attention`` at the prefill's
   shape (< 0.02; timed as a comparison only).  Then every config of
   ``ARCHS`` at reduced_config in bf16 (prefill + 8 decode steps through
   ``BatchedEngine``; decode against the full forward and the card against
   float32 on the CPU, both < 0.06; MoE configs on pinned routes, see
   ``PinnedRouting``) and ``launch.serve.run`` at its defaults.  It prints
   the prefill's ms, the decode step's mean, p50 and max ms (CUDA events)
   and host enqueue ms, the kernels one decode step launches
   (``torch.profiler``), tokens/s, peak memory and the bounds: a decode step
   reads every weight and the requests' KV once at 3.35 TB/s, a prefill
   does 2 N tokens FLOPs at 989 TFLOP/s (bf16 dense tensor peak);
9. the sharded MoE path (``moe_sharded``): deepseek-v2-lite-16b at full
   width and depth (27 layers, d_model 2,048, MLA, 64 routed experts top-6
   and 2 shared; 16,210,198,528 parameters by ``param_counts``, bf16, drawn
   from a generator seeded by ``--seed``) built by
   ``build_model(cfg, mesh=make_host_mesh(), data_size=1,
   use_sharded_moe=True)`` on a world-1 NCCL mesh.  First the one-rank
   ``moe_apply_sharded`` against ``MoE`` on reduced grok-1 and reduced
   deepseek-v2-lite (float32 within 1e-5, bf16 within 2e-2, nothing
   dropped).  Then 4 random prompts of 2,048 tokens, every position's
   logits, with the flag off and on over the same weights: at capacity
   11.0 (>= slots / top_k, nothing may drop) the sharded layers on the
   unsharded run's routes (``PinnedRouting``) within 2e-2 of max |logit|
   with argmax agreement >= 99%, and >= 99% unpinned; at the config's own
   1.25 the per-layer ``dropped`` and the logits' deviation.  It prints the
   prefill's CUDA-event ms (mean, p50 of 5 after a warm-up; sharded and
   unsharded), the ms in each collective summed over layers, peak bytes,
   and ``BatchedEngine.generate(n_new=16, greedy=True)``'s ms per token,
   beside the prefill's bound 2 N_active tokens / 989 TFLOP/s; the process
   group ends with the phase;
10. the paper path (``paper``): the JAX package's random-access figures
   (``benchmarks/run.py`` fig10, fig11, fig18) on the port.  Each of the
   eight §6.1 types from ``synth.paper_type(seed=1)`` at about 64 MiB of
   values is written as ``lance`` (device route), ``parquet`` (8 KiB pages)
   and ``arrow``, the scalar also as Parquet with 64 KiB, 256 KiB and 1 MiB
   pages and with 1 MiB pages and a dictionary (the "default" of the 60x
   row); a 5-field int64 struct packed and shredded (Fig 18); int64 scalars
   in 0-3 list levels as ``arrow``, ``lance-fullzip`` and ``lance``
   (Fig 11).  Each takes 256 random rows 3 times after ``reset_io``; every
   take must equal the source rows and every other encoding, and Lance runs
   on the device route and a numpy-route twin with identical ``io_stats()``
   and ``modelled_time()``.  It prints iops/row, read amplification,
   phases, search-cache bytes, modelled rows/s and host wall ms, and the
   device route's kernels, copies, launches and host fallbacks per type
   (var-width leaves and values over 31 bits decode on the host, as in the
   JAX package);
11. the loader path (``loader``): smollm-360m's training input.  A token
   file of 16,384 documents (``synth.token_corpus``, vocab 49,152, about 42M
   tokens) is written for the device route and for the numpy route; a
   ``TokenLoader`` over each yields 64 batches of 8 x 2,049 int32 tokens.
   The batches and ``batch_for_step`` must be equal; it prints each route's
   scan wall, tokens/s and the kernels' and copies' share;
12. the train path (``train``): ``launch.train.train`` on smollm-360m at
   full width and depth (361,821,120 parameters, bf16, adamw, no remat,
   weights from a generator seeded 0): 6 steps of 8 x 2,048 positions, each
   batch from ``TokenLoader.batch_for_step`` over the driver's device-route
   token file, whose scan decodes through ``miniblock_decode``.  Every loss
   and gradient norm must be finite, every weight matrix must move, every
   step's scan must launch the decode kernel and nothing may fall back.
   Then, from the same first weights (seeded by ``--seed``): the card's bf16
   loss and gradients on one 1 x 65-token batch against the same weights in
   float32 on the CPU (the loss within 2e-2 nats, each gradient tensor's
   cosine >= 0.99), one adamw update in float32 on the card and on the CPU
   from the same clipped gradients (each tensor within 1e-6 of its max
   |value|), and the reference's loss-decrease smoke test at full width (8
   steps at lr 3e-3 on one 2 x 33-token batch, the last loss below the
   first); then every config of ``ARCHS`` at reduced_config in bf16 (the
   same card/CPU check, MoE on pinned routes, and 8 steps on one batch).  It
   prints each step's CUDA-event ms (mean, p50, max after the first),
   host enqueue ms, the host ms of each ``batch_for_step`` and the decode
   kernel's device ms in it, tokens/s, peak memory and the bound: 6 N
   tokens FLOPs at 989 TFLOP/s (attention left out);
13. the expert-parallel train path (``moe_train``): deepseek-v2-lite-16b at
   full width (d_model 2,048, MLA, 64 routed experts top-6 of 1,408 and 2
   shared) with its depth cut from 27 to 4 layers (2,758,803,456
   parameters, 751,828,992 active, by ``param_counts``), bf16, adamw, remat
   "full", drawn from a generator seeded by ``--seed`` and built by
   ``build_model(cfg, mesh=make_host_mesh(), data_size=1,
   use_sharded_moe=True)`` on a world-1 NCCL mesh.  First reduced grok-1 and
   reduced deepseek-v2-lite, sharded on that mesh: the card's bf16 loss and
   gradients against float32 on the CPU on pinned routes at capacity 11.0
   (the train path's bounds).  Then, at capacity 11.0, the full-width
   model's loss and gradients sharded against ``MoE.forward``'s on the same
   weights and batch (nothing dropped, the same bounds).  Then
   ``make_train_step`` at the config's capacity 1.25 for 5 steps of 4 x
   2,048 positions, each batch from ``TokenLoader.batch_for_step`` over a
   device-route token file of the config's vocab, whose scan decodes
   through ``miniblock_decode``; one more step under ``torch.profiler`` and
   one with the flag off.  Losses and gradient norms must be finite and
   nothing may fall back.  It prints the step's CUDA-event ms (p50 after a
   warm-up step), tokens/s, peak bytes and the card's headroom, the idle
   share, the collectives' ms summed over layers (forward with its remat
   recompute, and backward), ``dropped``, the unsharded step's ms and the
   bound 6 N_active tokens / 989 TFLOP/s; the process group ends with the
   phase;
14. the kv path (``kv``): one layer's K pool of smollm-360m in a
   ``PagedKVCache`` (5 KV heads x 64 bf16 features: 81,920-byte block rows;
   16,384 blocks, 1.25 GiB).  256 requests with prompts of 512-8,192 tokens
   are prefilled, then 32 decode steps append one token to every request
   and gather every request's KV through ``fullzip_gather``; after step 16
   half of the requests are released and replaced.  Every gather must equal
   a mirror of the appended values rounded to bf16 on the host, and the
   plain gather of the same store (tolerance 0); it prints gathers, bytes,
   wall and the kernel's share;
15. the ``bitunpack`` path: 2**20 values at 11 bits (the JAX package's
   ``kernel_bench`` size), unpacked on the card and checked against the
   packed values;
16. each kernel at the largest input each path gave it (``take``, ``search``,
   ``tiered``, ``serve``, ``lm``, ``paper``, ``loader``, ``train``,
   ``moe_train``, ``kv`` and ``bitunpack``;
   ``ivf_topk`` per search step: the centroid ``probe``
   and the ``candidates`` of each batch size), one ``kernels`` entry each:
   ``ms``, the mean of 20 back-to-back launches by CUDA events, host launch
   path included; ``graph_ms``, the same 20 launches captured in one CUDA
   graph, one replay over 20 (the kernel's own device time, L2-warm);
   ``cold_ms``, launches timed alone after a 128 MB write flushed the 50 MB
   L2; ``launch_us``, host wall time per call of 1,000 launches at the
   kernel's smallest sweep input; its plain version's ``plain_ms``; the
   PyTorch call that computes the same function, where one does
   (``library_ms``, ``library_graph_ms``); and the least time the card
   could take (bytes over 3.35 TB/s or operations over 67 T/s, whichever
   is larger); and one more ``bitunpack`` row at 2**24 values of 11 bits
   (``"step": "2**24"``, no launches on any path: it shows whether the
   kernel reaches the bandwidth regime), and one more ``miniblock_take`` row
   at the shape of one fragment of the benchmark's date take (40 chunks of
   4,096 entries at 14 bits, 42 rows; ``"step": "date take"``, no launches
   on any path);
17. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

Between the sweep and the dataset, ``gather_streams`` holds the gather's
per-launch work counter to its contract: the take shape's gather (16,429
rows of 1,536 bytes) launched on 65 CUDA streams at once, three rounds, and
a CUDA graph captured on one stream and replayed on another while a direct
launch runs on the capture stream, 20 times.  Every output starts filled
with a sentinel and must equal the plain version at tolerance 0.

Any failure raises, so the script exits non-zero and prints no result line.
Without a CUDA device it exits 2 at once; without the repository's ``src``
beside it, the import fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import arrays as A  # noqa: E402
from repro_torch.core import types as T  # noqa: E402
from repro_torch.core.file import FileReader, WriteOptions, write_table  # noqa: E402
from repro_torch.core.compression import bitpack  # noqa: E402
from repro_torch.data import TokenLoader, synth  # noqa: E402
from repro_torch.dataset import (DatasetReader, DatasetWriter, IvfIndex,  # noqa: E402
                                 write_fragments)
from repro_torch.dataset import ivf as ivf_module  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LMModel, build_model, model_flops, param_counts  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models.moe import MoE, moe_apply_sharded, shard_moe_params  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402
from repro_torch.train import (clip_by_global_norm, loss_and_grads,  # noqa: E402
                               make_optimizer, make_train_step)
from repro_torch.core.io_sim import (NVME, S3, Blackout, CorrelatedFault,  # noqa: E402
                                     Degradation, TransientErrors)
from repro_torch.obs import (BurnWindow, MetricsPlane, Shedder, SLObjective,  # noqa: E402
                             SLOMonitor, Tracer)
from repro_torch.serve import (BLOCK, BatchedEngine, FaultScenario, PagedKVCache,  # noqa: E402
                               Retriever, TenantSpec, ZipfWorkload, drive, run_scenario,
                               tenant_summary)
from repro_torch.store import (DrainRecord, EventLoop, IOScheduler, QoS,  # noqa: E402
                               RetryPolicy, TieredStore, build_job)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
ROWS = 1 << 20  # the main path's dataset: ~1.6 GB in FRAGMENTS files
FRAGMENTS = 4
TAKE_SIZES = (1024, 16384, 65536)
COLUMNS = ("id", "score", "tags", "emb")
SCAN_COLUMNS = ("id", "tags")
# the search path: 256 partitions of ~4,096 rows; nprobe = 1/8 of them, the
# repo's search-bench ratio; one exhaustive batch
PARTITIONS, INDEX_FRAGMENTS, K = 256, 2, 10
SEARCHES = ((1, 32), (8, 32), (4, PARTITIONS))  # (queries, nprobe)
BITUNPACK_N, BITUNPACK_BITS = 1 << 20, 11  # the JAX package's kernel_bench size
# one more bitunpack row, off every path: whether the kernel reaches the
# bandwidth regime, since 2**20 values are near the floor of one launch
BITUNPACK_BIG_N = 1 << 24
# gather_streams: the take path's gather shape, on more streams than the
# bulk route had work counters before they became per launch (64)
GATHER_ROWS, GATHER_STRIDE = 16429, 1536
GATHER_STREAMS, GATHER_ROUNDS, GRAPH_REPLAYS = 65, 3, 20
# the tiered path: take sizes, and the size of the uncommitted append that
# the writer's crash tears
TIERED_TAKES = (1024, 16384)
CRASH_ROWS = 4096
# the tiered scans read in windows of this size, so that readahead sees a
# sequential stream inside each fragment (the default window, 8 MB, reads a
# fragment's id column at once)
TIERED_SCAN_CHUNK = 64 << 10
# the serving path: the JAX package's serve bench at full size (1,500
# requests of 32 rows at 200 per virtual second, queue depth 32) over the
# main dataset's emb column; the NVMe cache holds half of emb (the bench's
# rule: the Zipf head goes NVMe-warm, the tail keeps paying S3), and each
# append is a quarter fragment (the bench's rows_per // 4)
SERVE_REQUESTS, SERVE_RATE, SERVE_ROWS, SERVE_QD = 1500, 200.0, 32, 32
SERVE_CACHE_BYTES = ROWS * 384 * 4 // 2
SERVE_APPEND_ROWS = ROWS // FRAGMENTS // 4
SERVE_TRACE = ROOT / "build" / "serve_trace.json"
# the chaos bench's shed drill: synthetic 64-op drains, one premium and two
# standard arrivals per 300 us slot
SHED_SLOTS = 300
# the paper path (the JAX package's fig10/fig11/fig18, benchmarks/run.py, on
# the port): each §6.1 type at about 64 MiB of values (synth's sizes: 8 B,
# 16 B, 40 B, 80 B, 3 KiB, 15 KiB, 20 KiB and 100 KiB a row), taken TAKE_N
# rows at a time (the paper's take op), TAKE_REPEATS times after reset_io
PAPER_ROWS = {"scalar": 8_388_608, "string": 4_194_304, "scalar-list": 1_677_722,
              "string-list": 838_861, "vector": 21_845, "vector-list": 4_369,
              "image": 3_277, "image-list": 655}
TAKE_N, TAKE_REPEATS = 256, 3
# the scalar's Parquet page-size sweep past the 8 KiB of every type; the last
# size with a dictionary is the "default" of the paper's 60x row
PAPER_PAGES = (64 << 10, 256 << 10, 1 << 20)
# Fig 18: a struct of int64 fields, packed and shredded; Fig 11: int64
# scalars wrapped in 0-3 list levels
STRUCT_ROWS, STRUCT_FIELDS = 1 << 20, 5
NEST_ROWS, NEST_DEPTHS = 1 << 20, (0, 1, 2, 3)
# the loader path: smollm-360m's training input (configs: vocab 49,152;
# seq_len 2,048, batch 8) over a token file of LOADER_DOCS documents
LOADER_DOCS, LOADER_VOCAB, LOADER_SEQ, LOADER_BATCH = 16384, 49152, 2048, 8
LOADER_BATCHES, LOADER_STEP = 64, 100
# the kv path: one layer's K pool of smollm-360m (5 KV heads of 64: 81,920-B
# bf16 block rows), 16,384 blocks (1.25 GiB); KV_REQUESTS prompts of
# KV_PROMPT tokens, KV_STEPS one-token decode steps gathering every request,
# half the requests replaced after step KV_REPLACE_AT
KV_FEATURES, KV_BLOCKS = 5 * 64, 16384
KV_REQUESTS, KV_PROMPT = 256, (512, 8192)
KV_STEPS, KV_REPLACE_AT = 32, 16
# the lm path: smollm-360m (configs :29) at full width and depth in bf16,
# LM_BATCH prompts of LM_PROMPT tokens (the loader path's batch and seq_len)
# and LM_NEW new tokens; first launch/serve.py's --batch x --neighbors rows
# of emb; the trajectory replay, the host check and the family sweep sizes
LM_ARCH, LM_REDUCED = "smollm-360m", False
LM_BATCH, LM_PROMPT, LM_NEW, LM_NEIGHBORS = 8, 2048, 32, 8
LM_PARAMS = (361_758_720, 361_821_120)  # param_counts; the module's (+ 65 norm scales)
LM_REPLAY, LM_REPLAY_TOKENS, LM_HOST_PROMPT = 2, 4, 64
LM_SWEEP_B, LM_SWEEP_S, LM_SWEEP_NEW = 2, 32, 8
LM_BOUND = 0.06  # tests/test_models.py:110's prefill/decode bound
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
# the train path: launch/train.py's train() on smollm-360m at full width and
# depth in bf16, TRAIN_BATCH x TRAIN_SEQ positions a step (the loader path's
# batch and seq_len) from its device-route token file, TRAIN_STEPS steps;
# then the reference's loss-decrease smoke test at full width (TRAIN_OVERFIT
# steps at TRAIN_OVERFIT_LR on one 2 x 33-token batch, tests/test_models.py),
# the card against float32 on the CPU on one 1 x TRAIN_HOST_TOKENS batch,
# and every config reduced (8 steps on one batch, the same card/CPU check)
TRAIN_ARCH, TRAIN_REDUCED = "smollm-360m", False
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 2048
TRAIN_OVERFIT, TRAIN_OVERFIT_LR, TRAIN_HOST_TOKENS = 8, 3e-3, 65
# bounds of the card (bf16) against the CPU (float32) on the same weights:
# the loss in nats, each gradient tensor's cosine with the CPU's; the
# optimizer alone on identical float32 gradients, each parameter and moment
# as a share of its tensor's max |value|
TRAIN_LOSS_NATS, TRAIN_GRAD_COS, TRAIN_OPT_TOL = 2e-2, 0.99, 1e-6
# the moe_sharded path: deepseek-v2-lite-16b (configs :76) at full width and
# depth in bf16, its MoE layers through the one-rank sharded MoE on a
# world-1 MOE_BACKEND mesh; MOE_BATCH prompts of MOE_PROMPT tokens, first at
# capacity MOE_NO_DROP_CF (>= slots / top_k = 64 / 6: no token can drop),
# then at the config's own; MOE_TIMED timed prefills after one warm-up and
# MOE_NEW generated tokens; the one-rank sharded MoE against MoE on these
# reduced configs, MOE_SWEEP_B x MOE_SWEEP_S tokens
MOE_ARCH, MOE_REDUCED, MOE_BACKEND = "deepseek-v2-lite-16b", False, "nccl"
MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_TIMED = 4, 2048, 16, 5
MOE_PARAMS = 16_210_198_528  # param_counts (2,663,120,896 active)
MOE_NO_DROP_CF, MOE_BOUND, MOE_AGREE = 11.0, 2e-2, 0.99
MOE_SWEEP = ("grok-1-314b", "deepseek-v2-lite-16b")
MOE_SWEEP_B, MOE_SWEEP_S = 2, 64
# the moe_train path: deepseek-v2-lite-16b at full width with its depth cut
# to MOE_TRAIN_LAYERS of 27 (a layer's training state, bf16 weights and
# gradients and float32 adamw moments, is 12 B a parameter: 27 layers would
# need 195 GB), bf16, adamw, remat "full", its MoE layers expert-parallel on
# a world-1 MOE_BACKEND mesh at the config's capacity; MOE_TRAIN_STEPS steps
# (the first a warm-up) of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ positions from a
# device-route token file of its vocab
MOE_TRAIN_REDUCED, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = False, 4, 5
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 2048
MOE_TRAIN_PARAMS = (2_758_803_456, 751_828_992)  # param_counts at 4 layers (all, active)
RTOL = 1e-6
KERNEL_REPLACES = {
    "miniblock_decode": "src/repro/kernels/miniblock_decode.py:107",
    "fullzip_gather": "src/repro/kernels/fullzip_gather.py:35",
    "ivf_topk": "src/repro/kernels/ivf_topk.py:70",
    "bitunpack": "src/repro/kernels/bitunpack.py:46",
    "miniblock_take": None,  # none: the JAX package selects a take's rows on the host
}
# the wrapper each kernel is timed through, and the size of its input that
# picks the largest call of a path
WRAPPERS = {"miniblock_decode": "miniblock_decode", "fullzip_gather": "fullzip_gather",
            "ivf_topk": "ivf_topk_tensors", "bitunpack": "bitunpack",
            "miniblock_take": "miniblock_take"}
# the miniblock_take row at one fragment of the benchmark's date take
# (bench/: 6.0M dates in 6 files, 256 rows a take): its chunks and rows
DATE_TAKE = {"chunks": 40, "rows": 42, "bits": 14}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA events
    (inputs stay L2-warm between calls).  Each call pays its host launch
    path too, so at small sizes this measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, each replay timed by CUDA events and divided by ``reps``;
    the median of ``replays`` replays.  The host launch path is paid once,
    at capture, so this is the kernels' own time (L2-warm)."""
    fn()  # first launch outside the capture: build, load, set attributes
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del g
    return float(np.median(times))


def cold_ms(fn, reps: int = 20, flush_bytes: int = 128 << 20) -> float:
    """Mean time of ``fn`` with the 50 MB L2 flushed before each call: a
    128 MB scratch buffer is written, then the call alone is timed by its
    own CUDA events."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for i in range(reps):
        scratch.fill_(i & 0xFF)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def launch_us(fn, calls: int = 1000) -> float:
    """Host wall clock per call of ``calls`` back-to-back calls, synchronised
    once at the end: the host launch path at an input too small for the
    kernel to matter."""
    fn()
    torch.cuda.synchronize()
    s = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - s) / calls * 1e6


def ivf_step(queries, cands) -> str:
    """Which step of a search an ``ivf_topk`` call is: the centroid probe
    scores the index's PARTITIONS centroids, the candidate step the rows of
    the probed partitions (one entry per batch size)."""
    if cands.shape[0] == PARTITIONS:
        return "probe"
    return f"candidates q={queries.shape[0]}"


class Probe:
    """Wraps the port's kernel wrappers and host<->device copies with CUDA
    events.  For each kernel, path (``self.path``, set by ``main``) and
    search step it keeps the largest input a launching call had and the
    launches those calls made (read off the wrapper's own count).  The
    wrappers' counts are untouched."""

    def __init__(self):
        self.events = {}
        self.largest = {}  # (kernel, path, step) -> (size, args, kw)
        self.launched = {}  # (kernel, path, step) -> launches
        self.path = None
        # one wrapped call at a time: a TokenLoader's producer thread calls
        # the decode beside the main thread, and each call reads the
        # wrapper's launch count before and after
        self.lock = threading.RLock()
        self.real = {n: getattr(ops, n) for n in
                     (*WRAPPERS.values(), "to_device", "to_host")}
        for name, fn in self.real.items():
            setattr(ops, name, self._timed(name, fn))

    def _timed(self, name, fn):
        kernel = {w: k for k, w in WRAPPERS.items()}.get(name)

        def timed(*args, **kw):
            with self.lock:
                return call(*args, **kw)

        def call(*args, **kw):
            n0 = ops.launches[kernel] if kernel else 0
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.events.setdefault(name, []).append((s, e))
            launched = ops.launches[kernel] - n0 if kernel else 0
            if launched:
                step = ivf_step(*args[:2]) if kernel == "ivf_topk" else None
                key = (kernel, self.path, step)
                self.launched[key] = self.launched.get(key, 0) + launched
                # ivf_topk by its candidate matrix, then queries x k; the
                # others by their output
                size = (args[1].numel(), args[0].shape[0] * args[3]) \
                    if kernel == "ivf_topk" else \
                    (sum(o.numel() for o in (out if isinstance(out, tuple) else (out,))),)
                if size > self.largest.get(key, ((0,),))[0]:
                    self.largest[key] = (size, args, kw)
            return out

        return timed

    def kernel_ms(self, times):
        return {k: times.get(w, 0.0) for k, w in WRAPPERS.items()}

    def collect(self):
        """Milliseconds per wrapped function since the last collect."""
        torch.cuda.synchronize()
        out = {n: sum(s.elapsed_time(e) for s, e in p) for n, p in self.events.items()}
        self.events = {}
        return out

    def restore(self):
        for name, fn in self.real.items():
            setattr(ops, name, fn)


class StoreClock:
    """Host time in the store's batch-close accounting: the scheduler's
    read and write batch closes (coalescing, per-block classification
    against the cache tiers, readahead, the flush policy's ticks) and its
    commit barrier, read off by :meth:`take` (ms since the last take)."""

    NAMES = ("_finish", "_finish_write", "flush_barrier")

    def __init__(self):
        self.seconds = 0.0
        self.real = {n: getattr(IOScheduler, n) for n in self.NAMES}
        for name, fn in self.real.items():
            setattr(IOScheduler, name, self._timed(fn))

    def _timed(self, fn):
        def timed(*args, **kw):
            s = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - s
        return timed

    def take(self) -> float:
        ms, self.seconds = self.seconds * 1e3, 0.0
        return ms

    def restore(self):
        for name, fn in self.real.items():
            setattr(IOScheduler, name, fn)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


def build_phase():
    info = build.build_kernels()
    build.load_kernels()
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "library_dir": str(build.BUILD_DIR.relative_to(ROOT)), "ptxas": info["ptxas"]})


def _compare(got, want):
    """(mismatching elements, max |difference|) of two tensor tuples."""
    mism, err = 0, 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        mism += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    return mism, err


def sweep_phase():
    """Each kernel against its plain version over its sweep.  Returns the
    per-kernel tallies and, per kernel, its smallest launching input (where
    ``launch_us`` is taken)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = {name: [0, 0, 0] for name in WRAPPERS}
    smallest = {}

    def tally(name, mism, err, size, args, kw=None):
        r = res[name]
        r[0] += 1
        r[1] += mism
        r[2] = max(r[2], err)
        if size and size < smallest.get(name, (np.inf,))[0]:
            smallest[name] = (size, args, kw or {})

    for rep_bits, def_bits in [(0, 0), (0, 1), (0, 2), (1, 2), (2, 3)]:
        for vpe in (1, 4):
            for C in (1, 4, 33):
                for tile, max_bits, refs in ((1024, 24, (-100, 100)),
                                             (512, 31, (1 << 30, (1 << 31) - 1))):
                    case = ref.miniblock_case(rng, rep_bits, def_bits, vpe, C,
                                              tile, max_bits, refs)
                    t = [torch.from_numpy(a).to(dev) for a in case]
                    kw = dict(rep_bits=rep_bits, def_bits=def_bits, vpe=vpe,
                              tile_entries=tile, fill=-5)
                    got = ops.miniblock_decode(*t, **kw)
                    want = ref.miniblock_decode_ref(t[0], t[1], t[2], t[3][:, 0], t[3][:, 1],
                                                    t[3][:, 2], tile, rep_bits, def_bits, vpe, -5)
                    tally("miniblock_decode", *_compare(got, want),
                          sum(g.numel() for g in got), t, kw)
    for _, case, kw in ref.miniblock_edge_cases(rng):
        t = [torch.from_numpy(a).to(dev) for a in case]
        got = ops.miniblock_decode(*t, **kw)
        want = ref.miniblock_decode_ref(t[0], t[1], t[2], t[3][:, 0], t[3][:, 1], t[3][:, 2],
                                        kw["tile_entries"], kw["rep_bits"], kw["def_bits"],
                                        kw["vpe"], kw["fill"])
        tally("miniblock_decode", *_compare(got, want), sum(g.numel() for g in got), t, kw)
    for _, case, kw in ref.miniblock_take_cases(rng):
        t = [torch.from_numpy(a).to(dev) for a in case]
        got = ops.miniblock_take(*t, **kw)
        want = ref.miniblock_take_words_ref(*t, kw["def_bits"], kw["vpe"], kw["fill"])
        tally("miniblock_take", *_compare((got,), (want,)), got.numel(), t, kw)
    for _, zipped, rows, offset in ref.gather_cases(rng):
        zipped = ref.at_offset(zipped, dev, offset)
        rows = torch.from_numpy(rows).to(dev)
        got = ops.fullzip_gather(zipped, rows)
        tally("fullzip_gather", *_compare((got,), (ref.fullzip_gather_ref(zipped, rows),)),
              got.numel(), (zipped, rows))
    for bits in (1, 3, 5, 8, 11, 16, 21, 32):
        for n in (1, 100, 8192, 20000):
            v = rng.integers(0, 2 ** min(bits, 62), n, dtype=np.uint64)
            words = torch.from_numpy(ops.pack_words(bitpack(v, bits))).to(dev)
            got = ops.bitunpack(words, n, bits)
            m, e = _compare((got,), (ref.bitunpack_ref(words, n, bits),))
            tally("bitunpack", m + int((got.cpu().numpy() != v).sum()), e, n,
                  (words, n, bits))
    for _, v, words, bits, offset in ref.bitunpack_cases(rng):
        words = ref.at_offset(words, dev, offset)
        got = ops.bitunpack(words, len(v), bits)
        m, e = _compare((got,), (ref.bitunpack_ref(words, len(v), bits),))
        tally("bitunpack", m + int((got.cpu().numpy() != v).sum()), e, len(v),
              (words, len(v), bits))
    res["ivf_topk"][2] = 0.0
    ties = 0
    for q, c, ids, k, mask in ivf_cases(rng, dev):
        got = ops.ivf_topk_tensors(q, c, ids, k, mask)
        want = ref.ivf_topk_ref(q, c, ids, k, mask)
        m, e, g = compare_topk(got, want, ref.ivf_topk_scale(q, c))
        tally("ivf_topk", m, e, c.numel(), (q, c, ids, k, mask))
        ties += g
    torch.cuda.synchronize()
    out = {k: {"cases": v[0], "mismatches": v[1], "max_abs_err": v[2]} for k, v in res.items()}
    out["ivf_topk"]["near_tie_groups"] = ties
    emit({"phase": "kernels", "tolerance": 0, "ivf_topk_rtol": RTOL, **out})
    for k, v in out.items():
        check(v["mismatches"] == 0, f"{k}: {v['mismatches']} mismatches against its plain version")
    return out, smallest


def gather_streams_phase(rng):
    """The gather's bulk route draws work from a counter that must belong to
    its launch alone.  Launch it at the take shape on GATHER_STREAMS streams
    at once (GATHER_ROUNDS rounds, fresh row ids each), then replay a CUDA
    graph captured on stream A on stream B while a direct launch runs on A
    (GRAPH_REPLAYS times).  Outputs start filled with a sentinel, so a unit
    of rows that no block gathered shows; every output must equal the plain
    version exactly.  Emits the rows that differ, then fails on any."""
    dev = torch.device("cuda")
    zipped = torch.from_numpy(
        rng.integers(0, 256, (GATHER_ROWS, GATHER_STRIDE), dtype=np.uint8)).to(dev)
    plan = ops.fullzip_plan(GATHER_ROWS, GATHER_STRIDE, zipped.data_ptr(), 0,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
    check(plan["route"] == "bulk", f"gather_streams: the take shape took the {plan['route']} "
          "route, which has no work counter")

    def rows_of():
        return torch.from_numpy(
            rng.integers(0, GATHER_ROWS, GATHER_ROWS).astype(np.int32)).to(dev)

    def sentinel():
        return torch.full((GATHER_ROWS, GATHER_STRIDE), 0xA5, dtype=torch.uint8, device=dev)

    def wrong_rows(out, rows):
        return int((out != ref.fullzip_gather_ref(zipped, rows)).any(dim=1).sum())

    wrong = {"streams": 0, "graph": 0, "direct": 0}
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in range(GATHER_STREAMS)]
    for _ in range(GATHER_ROUNDS):
        rows = [rows_of() for _ in streams]
        outs = [sentinel() for _ in streams]
        for st in streams:
            st.wait_stream(main)
        for st, r, o in zip(streams, rows, outs):
            with torch.cuda.stream(st):
                ops.launch_fullzip_gather(zipped, r, o)
        for st in streams:
            main.wait_stream(st)
        torch.cuda.synchronize()
        wrong["streams"] += sum(wrong_rows(o, r) for r, o in zip(rows, outs))
    del outs

    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    rows_g, rows_d = rows_of(), rows_of()
    out_g, out_d = sentinel(), sentinel()
    for st in (a, b):
        st.wait_stream(main)
    with torch.cuda.stream(a):  # a first launch outside the capture
        ops.launch_fullzip_gather(zipped, rows_g, out_g)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=a):
        out_g.fill_(0xA5)
        ops.launch_fullzip_gather(zipped, rows_g, out_g)
    torch.cuda.synchronize()
    for _ in range(GRAPH_REPLAYS):
        with torch.cuda.stream(b):
            graph.replay()
        with torch.cuda.stream(a):
            out_d.fill_(0xA5)
            ops.launch_fullzip_gather(zipped, rows_d, out_d)
        torch.cuda.synchronize()
        wrong["graph"] += wrong_rows(out_g, rows_g)
        wrong["direct"] += wrong_rows(out_d, rows_d)
    del graph
    emit({"phase": "gather_streams", "rows": GATHER_ROWS, "row_bytes": GATHER_STRIDE,
          "route": plan["route"], "streams": GATHER_STREAMS, "rounds": GATHER_ROUNDS,
          "graph_replays": GRAPH_REPLAYS, "tolerance": 0, "rows_wrong": wrong})
    for k, v in wrong.items():
        check(v == 0, f"gather_streams: {v} rows wrong ({k})")


def ivf_cases(rng, dev):
    """The ivf_topk sweep: the grid of the JAX package's parity test, with
    and without a mask, a tie across tiles, an exhaustion case, then the
    hazards of the threshold filter (``ref.ivf_hazard_cases``)."""
    for dim in (3, 64, 128, 200):
        for nq, nc, k in ((1, 7, 3), (5, 300, 10), (9, 129, 1)):
            q = torch.from_numpy(rng.standard_normal((nq, dim)).astype(np.float32)).to(dev)
            c = torch.from_numpy(rng.standard_normal((nc, dim)).astype(np.float32)).to(dev)
            ids = torch.from_numpy(rng.permutation(nc).astype(np.int32)).to(dev)
            mask = torch.from_numpy(rng.integers(0, 2, (nq, nc)).astype(np.uint8)).to(dev)
            yield q, c, ids, k, None
            yield q, c, ids, k, mask
    ids = torch.from_numpy(rng.permutation(3000).astype(np.int32)).to(dev)
    yield torch.zeros((3, 16), device=dev), torch.zeros((3000, 16), device=dev), ids, 12, None
    q = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32)).to(dev)
    mask = torch.tensor([[1, 1, 1, 1, 1], [0, 1, 0, 1, 0], [0] * 5, [1, 0, 0, 0, 0]],
                        dtype=torch.uint8, device=dev)
    yield q, c, torch.arange(5, dtype=torch.int32, device=dev) * 11, 8, mask
    for _, *case in ref.ivf_hazard_cases(rng):
        q, c, ids, k, mask = case
        yield (torch.from_numpy(q).to(dev), torch.from_numpy(c).to(dev),
               torch.from_numpy(ids).to(dev), k,
               None if mask is None else torch.from_numpy(mask).to(dev))


def compare_topk(got, want, scale):
    """(mismatches, max |distance difference| over finite entries, near-tie
    groups) of two ``(dists, ids)`` results, by ``ref.ivf_topk_mismatches``:
    distances within RTOL of ``|d| + scale``, where ``scale`` is per query
    ``|q|^2 + max |c|^2`` (``ref.ivf_topk_scale``), since the expanded form
    ``(qq - 2 q.c) + cc`` rounds at the size of its terms."""
    d, w = (np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t) for t in got)
    wd, ww = (np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t) for t in want)
    mism, groups = ref.ivf_topk_mismatches(d, w, wd, ww, RTOL, scale)
    fin = np.isfinite(d) & np.isfinite(wd)
    err = float(np.abs(d[fin].astype(np.float64) - wd[fin]).max()) if fin.any() else 0.0
    return mism, err, groups


def make_table(n: int, rng):
    """The main path's table, from the seed: 1536-byte embeddings dominate."""
    score_valid = rng.random(n) >= 0.03
    lens = rng.integers(0, 8, n)
    list_valid = rng.random(n) >= 0.02
    lens[~list_valid] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    m = int(offsets[-1])
    child = A.PrimitiveArray(T.Primitive("int32", True), rng.random(m) >= 0.05,
                             rng.integers(0, 1 << 16, m).astype(np.int32))
    return {
        "id": A.PrimitiveArray.build(np.arange(n, dtype=np.int64), nullable=False),
        "score": A.PrimitiveArray.build(rng.integers(0, 1 << 20, n).astype(np.int32),
                                        validity=score_valid),
        "tags": A.ListArray(T.List(child.type, True), list_valid, offsets, child),
        "emb": A.FixedSizeListArray.build(
            rng.standard_normal((n, 384), dtype=np.float32), nullable=False),
    }


def same_buffers(a, b) -> bool:
    """Identical arrays, buffer by buffer (values at nulls included)."""
    if type(a) is not type(b) or not np.array_equal(a.validity, b.validity):
        return False
    if hasattr(a, "child"):
        return np.array_equal(a.offsets, b.offsets) and same_buffers(a.child, b.child)
    if hasattr(a, "data"):
        return np.array_equal(a.offsets, b.offsets) and np.array_equal(a.data, b.data)
    if hasattr(a, "children"):
        return [n for n, _ in a.children] == [n for n, _ in b.children] and all(
            same_buffers(x, y) for (_, x), (_, y) in zip(a.children, b.children))
    return a.values.dtype == b.values.dtype and np.array_equal(a.values, b.values)


def same_values(src, got) -> bool:
    """``got`` holds ``src``'s valid values (the source keeps arbitrary
    bytes under its nulls, decoded arrays do not)."""
    if type(src) is not type(got) or not np.array_equal(src.validity, got.validity):
        return False
    v = src.validity
    if hasattr(src, "child"):
        return np.array_equal(src.offsets, got.offsets) and same_values(src.child, got.child)
    if hasattr(src, "data"):  # var-width: nulls are empty in both
        return np.array_equal(src.offsets, got.offsets) and np.array_equal(src.data, got.data)
    if hasattr(src, "children"):
        return [n for n, _ in src.children] == [n for n, _ in got.children] and all(
            same_values(a, b) for (_, a), (_, b) in zip(src.children, got.children))
    return np.array_equal(src.values[v], got.values[v])


def io_of(reader):
    return dataclasses.astuple(reader.io_stats()), reader.modelled_time()


def dataset_phase(rng):
    t0 = time.perf_counter()
    table = make_table(ROWS, rng)
    t1 = time.perf_counter()
    files = write_fragments(table, FRAGMENTS, WriteOptions("lance", decode="device"))
    t2 = time.perf_counter()
    emit({"phase": "dataset", "rows": ROWS, "fragments": FRAGMENTS,
          "bytes": sum(len(f) for f in files), "gen_s": t1 - t0,
          "write_s": t2 - t1})
    return table, files


def take_path_phase(table, files, rng, probe):
    dev = DatasetReader(files)  # decode route from the footer: "device", on CUDA
    host = DatasetReader(files, decode="numpy")
    check(dev.fragments[0].decode == "device", "footer did not select the device route")
    check(dev.fragments[0].device.type == "cuda", "device route is not on CUDA")

    takes = [(k, rng.integers(0, ROWS, k)) for k in TAKE_SIZES]
    for _, rows in takes:  # duplicates, in and out of order
        rows[: len(rows) // 4] = rows[len(rows) // 2: len(rows) // 2 + len(rows) // 4][::-1]
    ops.reset_counts()  # the take path starts here
    for col in COLUMNS:  # warm-up: first launches, allocator, caches
        dev.take(col, takes[0][1][:64])
    probe.collect()
    for k, rows in takes:
        rec = {"phase": "take", "rows": k, "device_wall_ms": {}, "numpy_wall_ms": {},
               "modelled_io_ms": {}}
        n0 = dict(ops.launches)
        for col in COLUMNS:
            dev.reset_io()
            host.reset_io()
            s = time.perf_counter()
            got = dev.take(col, rows)
            torch.cuda.synchronize()
            rec["device_wall_ms"][col] = (time.perf_counter() - s) * 1e3
            s = time.perf_counter()
            want = host.take(col, rows)
            rec["numpy_wall_ms"][col] = (time.perf_counter() - s) * 1e3
            check(same_buffers(want, got), f"take {k} {col}: device != numpy route")
            check(same_values(table[col].take(rows), got), f"take {k} {col}: != source")
            check(io_of(dev) == io_of(host), f"take {k} {col}: IO accounting differs")
            rec["modelled_io_ms"][col] = dev.modelled_time() * 1e3
        times = probe.collect()
        rec["kernel_ms"] = probe.kernel_ms(times)
        rec["copy_ms"] = times.get("to_device", 0.0) + times.get("to_host", 0.0)
        rec["launches"] = {n: ops.launches[n] - n0[n] for n in ops.launches}
        emit(rec)
    for col in SCAN_COLUMNS:
        dev.reset_io()
        host.reset_io()
        n0 = dict(ops.launches)
        s = time.perf_counter()
        got = dev.scan(col)
        torch.cuda.synchronize()
        dwall = (time.perf_counter() - s) * 1e3
        s = time.perf_counter()
        want = host.scan(col)
        hwall = (time.perf_counter() - s) * 1e3
        check(same_buffers(want, got), f"scan {col}: device != numpy route")
        check(same_values(table[col], got), f"scan {col}: != source")
        check(io_of(dev) == io_of(host), f"scan {col}: IO accounting differs")
        times = probe.collect()
        emit({"phase": "scan", "column": col, "device_wall_ms": dwall, "numpy_wall_ms": hwall,
              "kernel_ms": probe.kernel_ms(times),
              "copy_ms": times.get("to_device", 0.0) + times.get("to_host", 0.0),
              "launches": {n: ops.launches[n] - n0[n] for n in ops.launches},
              "modelled_io_ms": dev.modelled_time() * 1e3})
    launches = dict(ops.launches)  # the take path ends here
    fallbacks = dict(ops.fallbacks)
    emit({"phase": "take_path", "checked": "exact vs decode=numpy and the source table; "
          "identical io_stats and modelled_time", "launches": launches,
          "fallbacks": fallbacks})
    for name in ("miniblock_decode", "fullzip_gather", "miniblock_take"):
        check(launches[name] > 0, f"{name} never launched on the take path")
    check(not fallbacks, f"eligible columns fell back to the host: {fallbacks}")
    return launches


def writer_io(w):
    return (dataclasses.astuple(w.io_stats()), dataclasses.astuple(w.write_stats()),
            [dataclasses.astuple(t) for t in w.tier_stats()], w.modelled_time())


def timed_build(writer):
    """``IvfIndex.build`` with its scan and k-means timed from outside."""
    spans = {}

    def timing(name, fn):
        def run(*a, **kw):
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - s
            return out
        return run

    real_kmeans = ivf_module.kmeans
    ivf_module.kmeans = timing("kmeans_s", real_kmeans)
    writer.scan = timing("scan_s", writer.scan)
    try:
        s = time.perf_counter()
        index = IvfIndex.build(writer, "emb", n_partitions=PARTITIONS,
                               n_fragments=INDEX_FRAGMENTS, seed=0)
        total = time.perf_counter() - s
    finally:
        ivf_module.kmeans = real_kmeans
        del writer.scan
    spans["write_s"] = total - spans["scan_s"] - spans["kmeans_s"]
    spans["total_s"] = total
    return index, spans


def emb_take_timer(reader):
    """Times each take of the retriever's data reader (candidates, then
    winners)."""
    log = []
    real = reader.take

    def take(name, rows):
        s = time.perf_counter()
        out = real(name, rows)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - s) * 1e3)
        return out

    reader.take = take
    return log


def recall_at_k(vecs64, q, ids, k):
    """recall@k of ``ids`` against a float64 brute force over every row, a
    row tied with the k-th within float32 noise counting as a hit (the rule
    of the JAX package's search property test)."""
    hits = 0
    for i in range(len(q)):
        d = ((vecs64 - torch.from_numpy(q[i].astype(np.float64)).to(vecs64.device)) ** 2).sum(1)
        top = torch.topk(d, k, largest=False)
        kth = float(top.values[-1])
        best = set(top.indices.cpu().tolist())
        dd = d[torch.from_numpy(ids[i]).to(vecs64.device)].cpu().numpy()
        hits += sum(int(r) in best or dd[j] <= kth * (1 + 1e-5) + 1e-7
                    for j, r in enumerate(ids[i]))
    return hits / (len(q) * k)


def search_path_phase(table, files, rng, probe):
    """DatasetWriter -> IvfIndex.build -> Retriever.search, on the device
    route and the numpy route, over the take path's four files."""
    vecs = table["emb"].values
    ops.reset_counts()  # the search path starts here
    s = time.perf_counter()
    w_dev = DatasetWriter(files, store="flat", flush=None, decode="device")
    ingest_s = time.perf_counter() - s
    w_np = DatasetWriter(files, store="flat", flush=None, decode="numpy")
    check(writer_io(w_dev) == writer_io(w_np), "ingest: IO accounting differs")
    ivf_dev, build_dev = timed_build(w_dev)
    ivf_np, build_np = timed_build(w_np)
    cent = ivf_dev.centroids()
    check(np.array_equal(cent, ivf_np.centroids()), "index: centroids differ between routes")
    parts = np.arange(PARTITIONS)
    posts = ivf_dev.postings(parts)
    check(all(np.array_equal(a, b) for a, b in zip(posts, ivf_np.postings(parts))),
          "index: posting lists differ between routes")
    check(writer_io(w_dev) == writer_io(w_np), "build: IO accounting differs")
    sizes = [len(p) for p in posts]
    emit({"phase": "index", "ingest_s": ingest_s, "build_device": build_dev,
          "build_numpy": build_np, "partitions": PARTITIONS,
          "posting_rows": {"min": min(sizes), "mean": float(np.mean(sizes)),
                           "max": max(sizes)},
          "write_stats": dataclasses.asdict(w_dev.write_stats())})
    r_dev = Retriever(w_dev.reader(), "emb", index=ivf_dev, decode="device")
    r_np = Retriever(w_np.reader(), "emb", index=ivf_np, decode="numpy")
    takes = emb_take_timer(r_dev.reader)
    r_dev.search(vecs[:1], k=K, nprobe=4)  # warm-up
    r_np.search(vecs[:1], k=K, nprobe=4)
    vecs64 = torch.from_numpy(vecs).to("cuda", torch.float64)
    cc_max = float((vecs.astype(np.float64) ** 2).sum(1).max())
    cent_max = float((cent.astype(np.float64) ** 2).sum(1).max())
    cent_plain = torch.from_numpy(cent)
    probe.collect()
    for nq, nprobe in SEARCHES:
        q = vecs[rng.integers(0, ROWS, nq)] + \
            0.05 * rng.standard_normal((nq, vecs.shape[1])).astype(np.float32)
        qq = (q.astype(np.float64) ** 2).sum(1)
        scale = qq + cc_max  # ref.ivf_topk_scale over the whole column
        w_dev.reset_io()
        w_np.reset_io()
        del takes[:]
        n0, f0 = dict(ops.launches), dict(ops.fallbacks)
        probe.collect()  # drop the numpy route's host-side events
        s = time.perf_counter()
        got = r_dev.search(q, k=K, nprobe=nprobe)
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - s) * 1e3
        times = probe.collect()
        launched = {n: ops.launches[n] - n0[n] for n in ops.launches}
        s = time.perf_counter()
        want = r_np.search(q, k=K, nprobe=nprobe)
        np_ms = (time.perf_counter() - s) * 1e3
        tag = f"search nq={nq} nprobe={nprobe}"
        # probes: the plain version's centroid distances order both routes
        pd, pw = ref.ivf_topk_ref(torch.from_numpy(q), cent_plain,
                                  torch.arange(PARTITIONS, dtype=torch.int32), nprobe)
        mp, _, gp = compare_topk((pd, got.probes), (pd, want.probes), qq + cent_max)
        check(np.array_equal(want.probes, pw.numpy()), f"{tag}: numpy route probes")
        mi, err, gi = compare_topk((got.distances, got.ids), (want.distances, want.ids), scale)
        check(mp == 0, f"{tag}: probes differ from the numpy route")
        check(mi == 0, f"{tag}: ids/distances differ from the numpy route")
        if np.array_equal(got.ids, want.ids):
            check(np.array_equal(got.winner_rows, want.winner_rows), f"{tag}: winner rows")
            check(same_buffers(want.values, got.values), f"{tag}: winner values differ")
        check(same_values(table["emb"].take(got.winner_rows), got.values),
              f"{tag}: winner values != source")
        check(got.n_candidates == want.n_candidates, f"{tag}: candidate counts differ")
        check(writer_io(w_dev) == writer_io(w_np), f"{tag}: IO accounting differs")
        check(launched["ivf_topk"] == 2, f"{tag}: ivf_topk launched {launched['ivf_topk']} "
              "times, not on both steps")
        ivf_fb = {k: v - f0.get(k, 0) for k, v in ops.fallbacks.items()
                  if k.startswith("decode.fallback.ivf.") and v != f0.get(k, 0)}
        check(not ivf_fb, f"{tag}: ivf_topk fell back: {ivf_fb}")
        rec = {"phase": "search", "queries": nq, "nprobe": nprobe, "k": K,
               "candidates": got.n_candidates, "device_wall_ms": dev_ms,
               "numpy_wall_ms": np_ms,
               "candidate_take_ms": takes[0], "winner_take_ms": takes[1],
               "winner_rows": int(got.winner_rows.size),
               "kernel_ms": probe.kernel_ms(times),
               "copy_ms": times.get("to_device", 0.0) + times.get("to_host", 0.0),
               "modelled_io_ms": w_dev.modelled_time() * 1e3, "launches": launched,
               "near_tie_groups": {"probes": gp, "ids": gi},
               "ids_identical": bool(np.array_equal(got.ids, want.ids)),
               "max_abs_distance_diff": err}
        if nprobe == PARTITIONS:
            rec["recall_at_k"] = recall_at_k(vecs64, q, got.ids, K)
            check(rec["recall_at_k"] == 1.0, f"{tag}: recall@{K} {rec['recall_at_k']} < 1")
        emit(rec)
    launches = dict(ops.launches)  # the search path ends here
    fallbacks = dict(ops.fallbacks)
    emit({"phase": "search_path", "checked": "ids/probes vs decode=numpy (near-tie rule), "
          "winner rows and values, identical io/write/tier stats and modelled_time, "
          "recall@10 = 1.0 at nprobe = 256", "launches": launches, "fallbacks": fallbacks})
    for name in ("miniblock_decode", "fullzip_gather", "ivf_topk"):
        check(launches[name] > 0, f"{name} never launched on the search path")
    return launches


def twin_state(r):
    """What the device route and its numpy twin must agree on after every
    step: every tier's counters, the logical read (and write) trace and the
    modelled IO time."""
    state = ([dataclasses.astuple(t) for t in r.tier_stats()],
             dataclasses.astuple(r.io_stats()), r.modelled_time())
    if hasattr(r, "write_stats"):
        state += (dataclasses.astuple(r.write_stats()),)
    return state


def tiers_of(r):
    return [{"tier": t.name, "hits": t.hits, "misses": t.misses, "hit_rate": t.hit_rate,
             "evictions": t.evictions, "n_iops": t.n_iops, "bytes_read": t.bytes_read,
             "prefetch_iops": t.prefetch_iops, "write_iops": t.write_iops,
             "flush_iops": t.flush_iops, "dirty_bytes": t.dirty_bytes,
             "lost_bytes": t.lost_bytes} for t in r.tier_stats()]


class Twins:
    """Runs each step on the device route, then on its numpy-route twin,
    and checks after each that their state is identical.  Sums each
    route's wall ms, the kernels' and copies' ms (device route) and the
    store's batch-close ms (both routes) into the open record."""

    def __init__(self, probe, clock):
        self.probe, self.clock = probe, clock
        self.rec = None

    def open(self, **fields):
        self.rec = {"phase": "tiered", **fields, "device_wall_ms": 0.0, "numpy_wall_ms": 0.0,
                    "kernel_ms": 0.0, "copy_ms": 0.0,
                    "store_ms": {"device": 0.0, "numpy": 0.0}}
        return self.rec

    def call(self, tag, dev, host, fn, state=twin_state):
        rec = self.rec
        self.probe.collect()
        self.clock.take()
        s = time.perf_counter()
        got = fn(dev)
        torch.cuda.synchronize()
        rec["device_wall_ms"] += (time.perf_counter() - s) * 1e3
        rec["store_ms"]["device"] += self.clock.take()
        times = self.probe.collect()
        rec["kernel_ms"] += sum(self.probe.kernel_ms(times).values())
        rec["copy_ms"] += times.get("to_device", 0.0) + times.get("to_host", 0.0)
        s = time.perf_counter()
        want = fn(host)
        rec["numpy_wall_ms"] += (time.perf_counter() - s) * 1e3
        rec["store_ms"]["numpy"] += self.clock.take()
        self.probe.collect()
        check(state(dev) == state(host),
              f"{tag}: tier stats, IO or modelled time differ between the routes")
        return got, want

    def close(self, dev):
        rec, self.rec = self.rec, None
        rec["modelled_io_ms"] = dev.modelled_time() * 1e3
        rec["tiers"] = tiers_of(dev)
        emit(rec)
        return rec


def take_all(tw, tag, dev, host, rows, table, flat=None):
    """Take ``rows`` of every column on both twins: equal to each other and
    to the source; with ``flat``, the logical IO equals the flat store's."""
    for col in COLUMNS:
        got, want = tw.call(f"{tag} {col}", dev, host, lambda r: r.take(col, rows))
        check(same_buffers(want, got), f"{tag} {col}: device != numpy route")
        check(same_values(table[col].take(rows), got), f"{tag} {col}: != source")
        if flat is not None:
            flat.take(col, rows)
            check(dataclasses.astuple(flat.io_stats()) == dataclasses.astuple(dev.io_stats()),
                  f"{tag} {col}: logical IO differs from the flat store's")


def cold_warm(tw, store, dev, host, rows, table, flat=None):
    """A cold pass (caches dropped) and a warm repeat of the same takes."""
    out = {}
    for r in (dev, host):
        r.drop_caches()
    for step in ("cold", "warm"):
        for r in (dev, host, flat):
            if r is not None:
                r.reset_io()
        tw.open(store=store, step=f"take {step}", rows=len(rows))
        take_all(tw, f"{store} take {len(rows)} {step}", dev, host, rows, table, flat)
        out[step] = tw.close(dev)
    return out


def tiered_path_phase(table, files, rng, probe):
    """The main path over the tiered store, device route against a numpy
    twin in lockstep (see the module docstring, item 6)."""
    clock = StoreClock()
    tw = Twins(probe, clock)
    ops.reset_counts()  # the tiered path starts here
    try:
        tiered_runs(tw, table, files, rng)
    finally:
        clock.restore()
    launches = dict(ops.launches)  # the tiered path ends here
    fallbacks = dict(ops.fallbacks)
    emit({"phase": "tiered_path", "checked": "exact vs decode=numpy and the source; "
          "identical tier_stats, io_stats, write_stats and modelled_time between the "
          "routes after every step; logical IO and write trace equal the flat store's",
          "launches": launches, "fallbacks": fallbacks})
    for name in ("miniblock_decode", "fullzip_gather"):
        check(launches[name] > 0, f"{name} never launched on the tiered path")
    check(not fallbacks, f"eligible columns fell back to the host: {fallbacks}")
    return launches


def tiered_runs(tw, table, files, rng):
    flat = DatasetReader(files, decode="numpy")
    dev, host = (DatasetReader(files, store="tiered", decode=d) for d in (None, "numpy"))
    cache = dev.store.levels[0].cache
    check((len(dev.store.levels), cache.capacity_blocks, cache.policy, cache.admission)
          == (1, 16384, "clock", "always"), "store='tiered' is not the reference's NVMe cache")
    for k in TIERED_TAKES:
        rows = rng.integers(0, ROWS, k)
        res = cold_warm(tw, "tiered", dev, host, rows, table, flat)
        if k == TIERED_TAKES[0]:
            check(res["warm"]["modelled_io_ms"] < res["cold"]["modelled_io_ms"],
                  f"tiered take {k}: warm is not cheaper than cold")
            check(res["warm"]["tiers"][-1]["n_iops"] == 0, f"tiered take {k}: S3 served a warm take")
    for r in (dev, host):
        r.drop_caches()
        r.reset_io()
    tw.open(store="tiered", step="scan id, cold")
    got, want = tw.call("tiered scan id", dev, host, lambda r: r.scan("id", io_chunk=TIERED_SCAN_CHUNK))
    check(same_buffers(want, got) and same_values(table["id"], got), "tiered scan id")
    check(dev.tier_stats()[-1].prefetch_iops > 0, "tiered scan id: readahead filled nothing")
    tw.close(dev)
    del dev, host, flat

    dev, host = (DatasetReader(files, store="hot", decode=d) for d in (None, "numpy"))
    res = cold_warm(tw, "hot", dev, host, rng.integers(0, ROWS, TIERED_TAKES[0]), table)
    check(res["warm"]["modelled_io_ms"] < res["cold"]["modelled_io_ms"] and
          res["warm"]["tiers"][-1]["n_iops"] == 0, "hot: warm take not served by the caches")
    del dev, host

    dev, host = (DatasetReader(files, store="tiered-auto", decode=d) for d in (None, "numpy"))
    cache = dev.store.levels[0].cache
    tw.open(store="tiered-auto", step="scan id, then takes")
    flips = []
    got, _ = tw.call("tiered-auto scan id", dev, host, lambda r: r.scan("id", io_chunk=TIERED_SCAN_CHUNK))
    check(same_values(table["id"], got), "tiered-auto scan id != source")
    flips.append(("scan id", cache.active_admission, cache.admission_flips))
    rows = rng.integers(0, ROWS, TIERED_TAKES[0])
    for _ in range(2):
        take_all(tw, "tiered-auto take", dev, host, rows, table)
        flips.append(("take", cache.active_admission, cache.admission_flips))
    tw.rec["admission"] = flips
    tw.close(dev)
    del dev, host

    dev, host = (Retriever(files, "emb", store="tiered", decode=d) for d in (None, "numpy"))
    ids = rng.integers(0, ROWS, TIERED_TAKES[0])
    cold = None
    for step in ("cold", "warm"):
        tw.open(store="tiered", step=f"Retriever.fetch {step}", rows=len(ids))
        got, want = tw.call(f"fetch {step}", dev, host, lambda r: r.fetch(ids)[0],
                            state=lambda r: twin_state(r.reader))
        check(same_buffers(want, got) and same_values(table["emb"].take(ids), got),
              f"fetch {step}: values")
        rec = tw.close(dev.reader)
        if step == "warm":
            check(rec["modelled_io_ms"] < cold and rec["tiers"][-1]["n_iops"] == 0,
                  "fetch warm: not served by the NVMe cache")
        cold = rec["modelled_io_ms"]
    del dev, host
    tiered_writer(tw, table, files, rng)


def tiered_writer(tw, table, files, rng):
    """DatasetWriter at the reference's defaults (tiered, write-back): ingest
    and commit, takes of the committed version, then a crash with an
    uncommitted append in flight."""
    rec = tw.open(store="tiered", step="DatasetWriter(files) ingest, write-back")
    twins = []
    for decode, key in ((None, "device"), ("numpy", "numpy")):
        tw.clock.take()
        s = time.perf_counter()
        twins.append(DatasetWriter(files, decode=decode))
        rec[f"{key}_wall_ms"] += (time.perf_counter() - s) * 1e3
        rec["store_ms"][key] += tw.clock.take()
    dev, host = twins
    check(dev.flush_policy.mode == "write-back" and len(dev.store.levels) == 1,
          "DatasetWriter() is not at the reference's defaults")
    check(twin_state(dev) == twin_state(host), "writer ingest: the routes' state differs")
    check(dev.dirty_bytes == host.dirty_bytes == 0, "writer ingest: dirty bytes after the commit")
    flat = DatasetWriter(files, store="flat", flush=None, decode="numpy")
    check(dataclasses.astuple(flat.write_stats()) == dataclasses.astuple(dev.write_stats()),
          "writer ingest: write trace differs from the flat store's")
    rec["write_stats"] = dataclasses.asdict(dev.write_stats())
    rec["flush_events"] = dev.flush_policy.n_flush_events
    del flat
    tw.close(dev)

    for w in (dev, host):
        w.reset_io()
    tw.open(store="tiered", step="DatasetWriter take", rows=TIERED_TAKES[0])
    take_all(tw, "writer take", dev, host, rng.integers(0, ROWS, TIERED_TAKES[0]), table)
    tw.close(dev)

    rec = tw.open(store="tiered", step="append uncommitted, simulate_crash, scan")
    extra = make_table(CRASH_ROWS, rng)
    _, _ = tw.call("writer append", dev, host, lambda w: w.append(extra, commit=False))
    torn, torn_np = tw.call("writer crash", dev, host, lambda w: w.simulate_crash())
    check(torn == torn_np and torn > 0, f"writer crash: torn {torn} / {torn_np} bytes")
    check(dev.tier_stats()[0].lost_bytes > 0, "writer crash: the NVMe tier lost nothing")
    check(dev.version == 1 and dev.n_rows == ROWS, "writer crash: not back at version 1")
    rec["torn_bytes"] = torn
    for col in COLUMNS:
        got, want = tw.call(f"writer scan {col}", dev, host, lambda w: w.scan(col))
        check(same_buffers(want, got) and same_values(table[col], got),
              f"writer scan {col} after the crash: != source")
    tw.close(dev)


class ServeRoute:
    """The writer a serving run drives, as ``drive`` sees it (its scheduler,
    ``take`` and ``append``): each take is timed on the host clock, ending in
    a synchronise, and its rows and values are kept for the twin check."""

    def __init__(self, writer):
        self.writer = writer
        self.scheduler = writer.scheduler
        self.takes, self.wall_ms = [], []

    def take(self, column, rows):
        s = time.perf_counter()
        out = self.writer.take(column, rows)
        torch.cuda.synchronize()
        self.wall_ms.append((time.perf_counter() - s) * 1e3)
        self.takes.append((rows, out))
        return out

    def append(self, table, commit=True):
        return self.writer.append(table, commit=commit)


def serve_run(files, decode, tracer, reqs, wl, seed, probe):
    """One route of the serving path: the writer's ingest, then ``drive``
    over the request stream with the ingest tenant's appends (tables from
    ``seed``, the same on both routes).  Returns the writer, its route, the
    interleaved and serial results, the window and the record to print."""
    s = time.perf_counter()
    w = DatasetWriter(files, store=lambda d: TieredStore.cached(d, cache_bytes=SERVE_CACHE_BYTES),
                      flush="write-back", opts=WriteOptions("lance", decode="device"),
                      queue_depth=SERVE_QD, decode=decode, tracer=tracer)
    ingest_s = time.perf_counter() - s
    route = ServeRoute(w)
    arng = np.random.default_rng(seed)
    probe.collect()
    s = time.perf_counter()
    inter, serial, win = drive(route, "emb", reqs, qos=wl.qos(),
                               append_table=lambda: make_table(SERVE_APPEND_ROWS, arng),
                               append_every=max(SERVE_REQUESTS // 8, 1), commit_every=2)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - s
    times = probe.collect()
    take_ms = sum(route.wall_ms)
    kernel_ms = sum(probe.kernel_ms(times).values())
    copy_ms = times.get("to_device", 0.0) + times.get("to_host", 0.0)
    rec = {"phase": "serve", "route": "device" if decode is None else decode,
           "requests": len(route.takes), "versions": w.version, "ingest_s": ingest_s,
           "drive_s": drive_s, "jobs": len(win.jobs),
           "request_wall_ms": {"p50": float(np.percentile(route.wall_ms, 50)),
                               "p99": float(np.percentile(route.wall_ms, 99)),
                               "total": take_ms},
           "kernel_ms": kernel_ms, "copy_ms": copy_ms,
           "kernel_share": kernel_ms / take_ms, "copy_share": copy_ms / take_ms}
    return w, route, inter, serial, win, rec


def ms_summary(res, names):
    """Per-tenant virtual-clock latency percentiles in ms, and the
    makespan."""
    out = dict(tenant_summary(res, names))
    out["makespan_ms"] = res.makespan * 1e3
    return out


def serve_path_phase(table, files, seed, probe):
    """The serving path (see the module docstring, item 7)."""
    tenants = [TenantSpec("premium", share=1.0, weight=4.0, priority=1,
                          rows_per_request=SERVE_ROWS),
               TenantSpec("standard", share=2.0, weight=1.0, rows_per_request=SERVE_ROWS)]
    names = [t.name for t in tenants] + ["ingest"]
    wl = ZipfWorkload(n_rows=ROWS, tenants=tenants, n_requests=SERVE_REQUESTS, zipf_s=1.05,
                      arrival_rate=SERVE_RATE, seed=3)
    reqs = wl.generate()
    tracer = Tracer()
    ops.reset_counts()  # the serving path starts here
    dev = serve_run(files, None, tracer, reqs, wl, seed + 13, probe)
    launches = dict(ops.launches)  # and ends here
    fallbacks = dict(ops.fallbacks)
    emit(dev[-1])
    host = serve_run(files, "numpy", None, reqs, wl, seed + 13, probe)
    emit(host[-1])
    w, route, inter, serial, win, _ = dev
    w_np, route_np, inter_np, serial_np, _, _ = host

    check(w.device.type == "cuda" and w.tracer is tracer,
          "serve: the writer is not the traced device route")
    check(inter.completions == inter_np.completions, "serve: interleaved completions differ")
    check(serial.completions == serial_np.completions, "serve: serial completions differ")
    check(twin_state(w) == twin_state(w_np), "serve: tier stats, IO, write trace or modelled "
          "time differ between the routes")
    check(len(route.takes) == len(route_np.takes) == SERVE_REQUESTS, "serve: requests lost")
    for (rows, got), (rows_np, want) in zip(route.takes, route_np.takes):
        check(np.array_equal(rows, rows_np) and same_buffers(want, got),
              "serve: a take differs between the routes")
        check(same_values(table["emb"].take(rows), got), "serve: a take != source rows")
    check(inter.makespan <= serial.makespan * (1 + 1e-12), "serve: interleaving lost to serial")
    emit({"phase": "serve_latency", "requests": SERVE_REQUESTS, "rows_per_request": SERVE_ROWS,
          "virtual_ms": {"interleaved": ms_summary(inter, names),
                         "serial": ms_summary(serial, names)},
          "nvme_hit_rate": w.tier_stats()[0].hit_rate, "tiers": tiers_of(w),
          "modelled_io_ms": w.modelled_time() * 1e3})
    del host, w_np, route_np

    # the captured window, re-priced with a plane and an SLO monitor
    # (objectives from the healthy run's own maxima, so it never breaches)
    for spec in tenants:
        spec.slo_ms = round(tenant_summary(inter, [spec.name])[spec.name]["max"] * 1.1, 6)
        spec.slo_target = 0.99 if spec.name == "premium" else 0.95
    plane = MetricsPlane(window=0.25, n_windows=8, rel_err=0.01)
    slo = SLOMonitor(wl.slo_objectives(),
                     windows=(BurnWindow(long_s=0.5, short_s=0.0625, burn_threshold=2.0),),
                     registry=plane.registry, plane=plane)
    sampled = win.run("interleaved", plane=plane, slo=slo)
    check(sampled.completions == inter.completions,
          "serve: plane/SLO sampling changed the completions")
    check(not slo.alerts, "serve: the healthy run breached its own objectives")
    devices = w.scheduler._devices()
    bare = EventLoop(devices, queue_depth=SERVE_QD, qos=wl.qos()).run(win.jobs)
    check(bare.completions == inter.completions,
          "serve: the bare event loop differs from the healthy run")
    chaos = serve_chaos(win, wl, devices, w.store.backing.name, inter.makespan)

    counts = {}
    for e in tracer.events:
        cat = e.get("cat", "meta")
        counts[cat] = counts.get(cat, 0) + 1
    tracer_fallbacks = tracer.metrics.counter_values("decode.fallback")
    SERVE_TRACE.parent.mkdir(exist_ok=True)
    n_events = tracer.export(str(SERVE_TRACE))
    emit({"phase": "serve_trace", "events": n_events, "by_category": counts,
          "bytes": SERVE_TRACE.stat().st_size, "path": str(SERVE_TRACE.relative_to(ROOT)),
          "plane_series": len(plane.series)})
    emit({"phase": "serve_path", "checked": "interleaved and serial completions, tier stats, "
          "IO, write trace, modelled time and values identical between the traced device "
          "route and the untraced numpy twin; takes equal the source; plane-on completions "
          "bit-identical; bare loop equals the healthy run; chaos gates",
          "chaos": chaos, "launches": launches, "fallbacks": fallbacks,
          "tracer_fallbacks": tracer_fallbacks})
    check(launches["fullzip_gather"] > 0, "fullzip_gather never launched on the serving path")
    check(not fallbacks and not tracer_fallbacks,
          f"serve: fell back to the host: {fallbacks} {tracer_fallbacks}")
    return launches


def serve_chaos(win, wl, devices, s3_name, makespan):
    """The chaos bench's scenarios re-price the captured window, each held
    to the bench's gate; the shed drill runs on its synthetic drains."""
    M = makespan
    nvme_name = next(d.name for d in devices if d.name.startswith("nvme"))
    out = {}
    res = run_scenario(win, FaultScenario("transient_nvme", faults=(
        (nvme_name, TransientErrors(0.25 * M, 0.75 * M, error_prob=0.05, seed=11)),)),
        qos=wl.qos())
    check(res.availability("premium") >= 0.999,
          f"chaos transient: premium availability {res.availability('premium')} < 99.9%")
    check(res.counters.get(f"retry.{nvme_name}", 0) > 0, "chaos transient: no retries")
    out["transient_nvme"] = chaos_cell(res)
    black = Blackout(0.3 * M)
    on = run_scenario(win, FaultScenario("blackout_failover", faults=((nvme_name, black),)),
                      qos=wl.qos())
    off = run_scenario(win, FaultScenario("blackout_no_failover", faults=((nvme_name, black),),
                                          retry=RetryPolicy(failover=False)), qos=wl.qos())
    check(not on.errors and on.counters.get(f"failover.{nvme_name}", 0) > 0,
          "chaos blackout: failover did not absorb the NVMe blackout")
    check(len(off.errors) > 0, "chaos blackout: the no-failover ablation failed nothing")
    out["blackout_failover"], out["blackout_no_failover"] = chaos_cell(on), chaos_cell(off)
    cf = CorrelatedFault(TransientErrors(0.25 * M, 0.6 * M, error_prob=0.03, seed=5),
                         (nvme_name, s3_name))
    res = run_scenario(win, FaultScenario("correlated_brownout",
                                          faults=tuple((n, cf.fault) for n in cf.devices)),
                       qos=wl.qos())
    # The chaos bench gates this scenario at 99.9% availability on its own,
    # lighter traffic.  Here S3 is saturated (requests wait seconds), and a
    # unit's retry deadline (timeout_k times its healthy service time) is
    # stamped when it queues, so an op error on S3 after the deadline fails
    # its request at once: the reference's semantics, not a port fault
    # (tests/test_torch_faults.py holds both packages to the same result).
    # What must hold at any load: each request completes exactly once, and
    # only on the last tier, where nothing is left to fail over to.
    check(len(res.completions) == len(win.jobs) and all(
        c.error in (None, f"io:{s3_name}") for c in res.completions),
        "chaos correlated: a request was lost, duplicated or failed short of S3")
    out["correlated_brownout"] = chaos_cell(res)
    out["shed_drill"] = shed_drill()
    emit({"phase": "serve_chaos", **out})
    return {k: v["counters"] for k, v in out.items()}


def chaos_cell(res, **extra):
    return {"makespan_ms": res.makespan * 1e3, "availability": res.availability(),
            "availability_premium": res.availability("premium"), "failed": len(res.errors),
            "counters": dict(sorted(res.counters.items())), **extra}


def shed_drill():
    """The chaos bench's shed drill: a controlled overload (one premium and
    two standard 64-op drains per 300 us slot) through a mid-run 2x NVMe
    slowdown.  The shedder must trip exactly once, shed only standard, keep
    premium fully available and finish before the unshed ablation."""
    devices = [NVME, S3]
    jobs, seq = [], 0
    for i in range(SHED_SLOTS):
        for tenant in ("premium", "standard", "standard"):
            seq += 1
            rec = DrainRecord(f"{tenant}/{i}", 1, {0: ({0: 64}, {0: 64 * 4096})})
            jobs.append(build_job(rec, devices, tenant=tenant, submit=i * 3e-4, seq=seq))
    qos = QoS(priority={"premium": 1})
    healthy = EventLoop(devices, queue_depth=64, qos=qos).run(jobs)
    M = healthy.makespan
    objective = SLObjective(healthy.percentiles("premium")["p99"] * 5.0, target=0.99)
    window = BurnWindow(long_s=M / 8, short_s=M / 64, burn_threshold=2.0)
    faulted = [NVME.with_fault(Degradation(0.2 * M, 0.8 * M, latency_factor=2.0,
                                           throughput_factor=1.0)), S3]

    def drill(shed_on):
        mon = SLOMonitor({"premium": objective}, windows=(window,))
        sh = Shedder(mon, protect=("premium",), shed=("standard",), on_burn=4.0,
                     off_burn=1.0, hold_s=M / 4) if shed_on else None
        res = EventLoop(faulted, queue_depth=64, qos=qos, retry=RetryPolicy(),
                        slo=mon, shedder=sh).run(jobs)
        return res, sh

    on, sh = drill(True)
    off, _ = drill(False)
    check(sh.trips == 1, f"shed drill: the shedder tripped {sh.trips} times")
    check(on.counters.get("shed.standard", 0) > 0 and "shed.premium" not in on.counters,
          "shed drill: shed the wrong tenant")
    check(on.availability("premium") == 1.0, "shed drill: premium lost requests")
    check(on.makespan < off.makespan, "shed drill: shedding did not shorten the run")
    return chaos_cell(on, trips=sh.trips, unshed_makespan_ms=off.makespan * 1e3)


class StepTimer:
    """Times a model's ``prefill`` and ``decode_step`` by CUDA events (the
    device's timeline, host launch path included) and by the host clock
    around each call without a synchronise (the time to enqueue it).  Keeps
    the first decode step's logits.  ``restore`` unwraps the model."""

    NAMES = ("prefill", "decode_step")

    def __init__(self, model):
        self.model = model
        self.reset()
        for name in self.NAMES:
            setattr(model, name, self._timed(name, getattr(model, name)))

    def reset(self):
        self.events = {n: [] for n in self.NAMES}
        self.host_ms = {n: [] for n in self.NAMES}
        self.first_logits = None

    def _timed(self, name, fn):
        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            h = time.perf_counter()
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.host_ms[name].append((time.perf_counter() - h) * 1e3)
            self.events[name].append((s, e))
            if name == "decode_step" and self.first_logits is None:
                self.first_logits = out[0].clone()
            return out

        return timed

    def ms(self, name):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[name]]

    def restore(self):
        for name in self.NAMES:
            delattr(self.model, name)


def rel_err(want, got) -> float:
    """max |want - got| / max |want|, in float32 on the host."""
    w, g = want.float().cpu(), got.float().cpu()
    return float((w - g).abs().max() / w.abs().max())


def lm_batch(cfg, B, S, rng):
    """Tokens in [1, vocab), and the vlm's vision embeddings or the audio
    model's frames, as host arrays."""
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_vision))
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_audio))
    return b


def on_device(batch, device, dtype):
    return {k: torch.as_tensor(v, device=device) if k == "tokens"
            else torch.as_tensor(v, device=device).to(dtype) for k, v in batch.items()}


def host_twin(model, cfg):
    """The model's weights in float32 on the CPU: the explicit host
    reference of the card-against-host checks."""
    host = LMModel(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    host.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    return host


def lm_fetch(table, files, rng, probe):
    """launch/serve.py's retrieval at its --batch x --neighbors: the device
    route against its numpy twin; rows equal the source's."""
    ids = rng.integers(0, ROWS, LM_BATCH * LM_NEIGHBORS)
    dev, host = (Retriever(files, "emb", decode=d) for d in ("device", "numpy"))
    probe.collect()
    s = time.perf_counter()
    got, _ = dev.fetch(ids)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - s) * 1e3
    times = probe.collect()
    want, _ = host.fetch(ids)
    check(same_buffers(want, got) and same_values(table["emb"].take(ids), got),
          "lm: fetched rows differ from the source")
    check(io_of(dev.reader) == io_of(host.reader), "lm: the fetch's IO or modelled time "
          "differs between the routes")
    return {"rows": len(ids), "row_bytes": 384 * 4, "wall_ms": wall_ms,
            "kernel_ms": probe.kernel_ms(times)["fullzip_gather"],
            "copy_ms": times.get("to_device", 0.0) + times.get("to_host", 0.0),
            "n_iops": dev.reader.io_stats().n_iops,
            "modelled_io_ms": dev.modelled_time() * 1e3}


def lm_attention_ms(cfg, dev):
    """The blockwise attention at the prefill's shape against
    ``scaled_dot_product_attention`` (keys and values repeated to the query
    heads outside the timing): times, and how far the two outputs are."""
    g = torch.Generator(device=dev).manual_seed(5)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn((LM_BATCH, LM_PROMPT, h, hd), generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16) for h in (H, Hkv, Hkv))
    kr, vr = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for t in (k, v))
    qt = q.transpose(1, 2)
    ours = flash_attention(q, k, v, causal=True)
    lib = torch.nn.functional.scaled_dot_product_attention(qt, kr, vr, is_causal=True)
    err = rel_err(lib.transpose(1, 2), ours)
    out = {"shape": [LM_BATCH, LM_PROMPT, H, Hkv, hd], "blockwise_ms": time_ms(
        lambda: flash_attention(q, k, v, causal=True), reps=5, warmup=1),
        "sdpa_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kr, vr, is_causal=True), reps=5, warmup=1),
        "rel_err_vs_sdpa": err}
    check(err < 2e-2, f"lm: the blockwise attention differs from SDPA by {err}")
    return out


def lm_decode_kernels(model, capacity, dev):
    """Kernels the card runs in one decode step of LM_BATCH requests, counted
    by ``torch.profiler`` (None when it records no device activity)."""
    toks = torch.ones((LM_BATCH, 1), dtype=torch.int32, device=dev)
    _, cache = model.prefill({"tokens": toks.expand(LM_BATCH, 8)}, capacity=capacity)
    model.decode_step(cache, toks)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(torch.profiler.supported_activities())) as prof:
        model.decode_step(cache, toks)
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    return n or None


class PinnedRouting:
    """Pins the MoE layers' expert choices of one forward to those another
    forward made, so that two runs in different precisions are compared on
    the same routes.  ``record`` keeps the expert ids of every routing call
    in order; ``replay`` hands them back, one call at a time, each as
    ``(B, S, k)`` ids reshaped to the call's tokens (``join`` concatenates
    recorded calls along S first), with gates renormalised from the
    replaying run's own router probabilities, and counts the tokens whose
    own top-k set differs (``moved``).  A router's top-2 that sit an ulp
    apart change places between bfloat16 and float32 (the JAX package's own
    bf16 and f32 prefills of reduced deepseek and grok disagree so in 3-4
    of 20 seeds), and a moved token changes its logits by up to half their
    range."""

    def __init__(self):
        self.recorded, self.queue, self.moved = [], None, 0
        self.real = moe_module.routing

    def _routing(self, x2d, router_w, n_experts, top_k):
        ids, gates, aux = self.real(x2d, router_w, n_experts, top_k)
        if self.queue is None:
            self.recorded.append(ids.clone())
            return ids, gates, aux
        pinned = self.queue.pop(0).reshape(-1, top_k).to(ids.device)
        own = torch.sort(ids, dim=-1).values
        self.moved += int((own != torch.sort(pinned, dim=-1).values).any(-1).sum())
        probs = torch.softmax(torch.matmul(x2d.float(), router_w), dim=-1)
        g = probs.gather(1, pinned)
        return pinned, g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), aux

    def record(self):
        self.recorded, self.queue = [], None
        moe_module.routing = self._routing
        return self

    def replay(self, calls):
        self.queue, self.moved = list(calls), 0
        moe_module.routing = self._routing
        return self

    def restore(self):
        moe_module.routing = self.real

    @staticmethod
    def join(a, b, B):
        """Per layer, the ids of calls ``a`` then ``b`` along the sequence."""
        return [torch.cat([x.reshape(B, -1, x.shape[-1]), y.reshape(B, -1, y.shape[-1])], 1)
                for x, y in zip(a, b)]


def lm_family_sweep(seed, dev):
    """Every config of ARCHS at reduced_config in bf16 on the card: prefill
    + LM_SWEEP_NEW decode steps through BatchedEngine, the card's decode
    step against its own full forward, and its prefill against float32 on
    the CPU (same weights).  MoE configs compare on pinned routes
    (``PinnedRouting``): the full forward takes the prefill's and the decode
    step's expert choices, the host the card's; the unpinned errors and the
    tokens whose own choice moved are printed beside them."""
    rng = np.random.default_rng(seed + 31)
    out = {}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        moe = cfg.moe is not None
        model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        batch = lm_batch(cfg, LM_SWEEP_B, LM_SWEEP_S, rng)
        card = on_device(batch, dev, torch.bfloat16)
        gen = BatchedEngine(model, max_new=LM_SWEEP_NEW).generate(card)
        check(gen.tokens.shape == (LM_SWEEP_B, LM_SWEEP_NEW) and (gen.tokens >= 0).all()
              and (gen.tokens < cfg.vocab).all(), f"lm {arch}: generated tokens out of range")
        pin = PinnedRouting()
        pin.record()
        last, cache = model.prefill(card, capacity=LM_SWEEP_S + 8)
        routes_prefill = pin.recorded
        pin.record()
        nxt = last.argmax(-1)[:, None].to(torch.int32)
        step, _ = model.decode_step(cache, nxt)
        routes_step = pin.recorded
        pin.restore()
        full_batch = {**card, "tokens": torch.cat([card["tokens"], nxt], 1)}
        host = host_twin(model, cfg)
        host_batch = on_device(batch, "cpu", torch.float32)
        want, _ = host.prefill(host_batch)
        errs = {"prefill_vs_decode": rel_err(model(full_batch)[:, -1], step),
                "card_vs_cpu_f32": rel_err(want, last)}
        rec = {"family": cfg.family}
        if moe:
            rec["unpinned"] = dict(errs)
            pin.replay(PinnedRouting.join(routes_prefill, routes_step, LM_SWEEP_B))
            errs["prefill_vs_decode"] = rel_err(model(full_batch)[:, -1], step)
            rec["moved_tokens"] = {"full_forward": pin.moved}
            pin.replay(routes_prefill)
            want, _ = host.prefill(host_batch)
            errs["card_vs_cpu_f32"] = rel_err(want, last)
            rec["moved_tokens"]["host"] = pin.moved
            pin.restore()
        out[arch] = {**rec, **errs}
        for name, e in errs.items():
            check(np.isfinite(e) and e < LM_BOUND, f"lm {arch}: {name} {e} >= {LM_BOUND}")
        del model, host
    return out


def lm_path_phase(table, files, seed, probe):
    """The LM serving path (see the module docstring, item 8)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 29)
    ops.reset_counts()  # the lm path starts here
    t = {}
    s = time.perf_counter()
    fetch = lm_fetch(table, files, rng, probe)
    t["fetch_s"] = time.perf_counter() - s

    # the model: full width and depth, bf16, from the seed
    cfg = reduced_config(LM_ARCH) if LM_REDUCED else get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    s = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    t["init_s"] = time.perf_counter() - s
    held = sum(p.numel() for p in model.parameters())
    check((param_counts(cfg)[0], held) == LM_PARAMS,
          f"lm: {param_counts(cfg)[0]} counted / {held} held parameters, not {LM_PARAMS}")
    check(all(p.device.type == "cuda" for p in model.parameters()), "lm: a weight is off the card")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    # prompts: the loader path's batch and seq_len from synth.token_corpus
    corpus = synth.token_corpus(2 * LM_BATCH, LM_PROMPT, cfg.vocab, seed=seed)
    flat = corpus.child.values
    check(len(flat) >= LM_BATCH * LM_PROMPT, "lm: the corpus is short of the prompts")
    prompts = flat[:LM_BATCH * LM_PROMPT].reshape(LM_BATCH, LM_PROMPT).astype(np.int32)

    # generation: one warm-up (cuBLAS handles, the allocator), then timed
    engine = BatchedEngine(model, max_new=LM_NEW)
    timer = StepTimer(model)
    engine.generate({"tokens": prompts}, n_new=2)
    timer.reset()
    s = time.perf_counter()
    out = engine.generate({"tokens": prompts}, n_new=LM_NEW)
    gen_s = time.perf_counter() - s
    prefill_ms, decode_ms = timer.ms("prefill")[0], timer.ms("decode_step")
    host_decode_ms = timer.host_ms["decode_step"]
    first = timer.first_logits
    timer.restore()
    peak = torch.cuda.max_memory_allocated()
    check(out.tokens.shape == (LM_BATCH, LM_NEW) and (out.tokens >= 0).all()
          and (out.tokens < cfg.vocab).all(), "lm: generated tokens out of shape or range")

    # prefill and decode agree: the first decode step against the full
    # forward of the prompt plus the token it consumed
    s = time.perf_counter()
    tok0 = torch.from_numpy(out.tokens[:, :1].copy()).to(dev)
    full, _ = model.prefill({"tokens": torch.cat([torch.from_numpy(prompts).to(dev), tok0], 1)})
    err_pd = rel_err(full, first)
    check(err_pd < LM_BOUND, f"lm: decode step vs full forward {err_pd} >= {LM_BOUND}")
    del full
    # the trajectory replays: each decoded token within 0.02 max|logit| of the max
    replay = []
    for r in range(LM_REPLAY):
        for j in range(LM_REPLAY_TOKENS):
            seq = np.concatenate([prompts[r], out.tokens[r, :j]])[None].astype(np.int32)
            logits, _ = model.prefill({"tokens": torch.from_numpy(seq).to(dev)})
            lg = logits[0].float()
            gap = float(lg.max() - lg[int(out.tokens[r, j])]) / float(lg.abs().max())
            replay.append(gap)
            check(gap <= 0.02, f"lm: request {r} token {j} is {gap} of max|logit| below the max")
    t["checks_s"] = time.perf_counter() - s

    # the card against the host: float32 weights on the CPU, a 64-token prompt
    s = time.perf_counter()
    host = host_twin(model, cfg)
    p = prompts[:1, :LM_HOST_PROMPT]
    card_l, _ = model.prefill({"tokens": torch.from_numpy(p.copy()).to(dev)})
    host_l, _ = host.prefill({"tokens": torch.from_numpy(p.copy())})
    err_host = rel_err(host_l, card_l)
    check(err_host < LM_BOUND, f"lm: card vs CPU float32 {err_host} >= {LM_BOUND}")
    del host
    t["host_s"] = time.perf_counter() - s

    attention = lm_attention_ms(cfg, dev)
    capacity = engine._capacity(LM_PROMPT, LM_NEW)
    kernels_per_step = lm_decode_kernels(model, capacity, dev)
    del model, engine, timer, first
    torch.cuda.empty_cache()

    s = time.perf_counter()
    families = lm_family_sweep(seed, dev)
    t["families_s"] = time.perf_counter() - s
    emit({"phase": "lm_families", "batch": LM_SWEEP_B, "prompt": LM_SWEEP_S,
          "new": LM_SWEEP_NEW, "bound": LM_BOUND, "dtype": "bfloat16", "archs": families})

    # the entry point itself, at its defaults
    s = time.perf_counter()
    served = launch_serve.run(device="cuda", verbose=False)
    t["serve_s"] = time.perf_counter() - s
    check(served["generate"]["tokens"].shape == (4, 16), "lm: launch.serve.run's tokens")
    emit({"phase": "lm_serve", "fetch": served["fetch"],
          **{k: v for k, v in served["generate"].items() if k != "tokens"}})

    launches = dict(ops.launches)  # the lm path ends here
    fallbacks = dict(ops.fallbacks)
    check(launches["fullzip_gather"] > 0, "fullzip_gather never launched on the lm path")
    check(not fallbacks, f"lm: fell back to the host: {fallbacks}")

    # bounds: a decode step reads every weight and each request's valid KV
    # once; a prefill does model_flops' 2 N tokens on the bf16 tensor peak
    L, F = cfg.n_layers, cfg.n_kv_heads * cfg.head_dim
    kv_read = [L * 2 * LM_BATCH * (LM_PROMPT + i + 1) * F * 2 for i in range(LM_NEW)]
    decode_bound_ms = float(np.mean([(weight_bytes + b) / HBM_BYTES_PER_S * 1e3
                                     for b in kv_read]))
    flops = model_flops(cfg, ShapeCfg("lm_prefill", "prefill", LM_PROMPT, LM_BATCH))
    attn_flops = 4 * LM_BATCH * cfg.n_heads * cfg.head_dim * LM_PROMPT * (LM_PROMPT + 1) // 2 * L
    dec = np.asarray(decode_ms)
    emit({"phase": "lm", "arch": cfg.name, "reduced": LM_REDUCED, "dtype": cfg.dtype,
          "parameters": held, "param_counts": param_counts(cfg)[0],
          "weight_bytes": weight_bytes, "peak_bytes": peak - base, "fetch": fetch,
          "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW, "cache_capacity": capacity,
          "prefill_ms": prefill_ms,
          "decode_ms": {"mean": float(dec.mean()), "p50": float(np.median(dec)),
                        "max": float(dec.max()), "steps": len(dec)},
          "decode_host_enqueue_ms": float(np.mean(host_decode_ms)),
          "decode_kernels_per_step": kernels_per_step,
          "generate_s": gen_s, "tokens_per_s": LM_BATCH * LM_NEW / gen_s,
          "bounds": {"decode_step_ms": decode_bound_ms, "weights_only_ms":
                     weight_bytes / HBM_BYTES_PER_S * 1e3, "hbm_bytes_per_s": HBM_BYTES_PER_S,
                     "prefill_ms": flops / BF16_FLOPS_PER_S * 1e3, "prefill_flops": flops,
                     "attention_flops": attn_flops, "bf16_flops_per_s": BF16_FLOPS_PER_S},
          "attention": attention,
          "checks": {"prefill_vs_decode": err_pd, "replay_max_gap": max(replay),
                     "card_vs_cpu_f32_64_tokens": err_host, "bound": LM_BOUND},
          "seconds": t, "launches": launches, "fallbacks": fallbacks})
    return launches



class ShardedProbe:
    """Wraps ``models.moe.moe_apply_sharded`` to keep each call's
    ``dropped``, and the four collectives it calls with CUDA events (the
    device's timeline: a synchronous collective makes the current stream
    wait for its own), summed per collective since the last ``collect``.
    Each call is staged by who made it: the forward of one of the sharded
    MoE's autograd Functions (a forward pass and its remat recompute), their
    backward (the transposes), or neither (the train step's gradient sync).
    ``restore`` unwraps them."""

    COLLECTIVES = ("all_to_all_single", "reduce_scatter_tensor", "all_gather_into_tensor",
                   "all_reduce")
    FUNCTIONS = ("_AllToAll", "_ReduceScatter", "_AllGather", "_AllReduce")
    STAGES = ("forward", "backward", "grad_sync")

    def __init__(self):
        self.real = {n: getattr(dist, n) for n in self.COLLECTIVES}
        self.real_apply = moe_module.moe_apply_sharded
        self.real_methods = {(f, m): getattr(moe_module, f).__dict__[m]
                             for f in self.FUNCTIONS for m in ("forward", "backward")}
        self.events, self.dropped, self.stage = [], [], "grad_sync"
        for name, fn in self.real.items():
            setattr(dist, name, self._timed(name, fn))
        for (f, m), method in self.real_methods.items():
            setattr(getattr(moe_module, f), m, staticmethod(self._staged(m, method.__func__)))
        moe_module.moe_apply_sharded = self._apply

    def _staged(self, stage, fn):
        def staged(*args):
            outer, self.stage = self.stage, stage
            try:
                return fn(*args)
            finally:
                self.stage = outer

        return staged

    def _timed(self, name, fn):
        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.events.append((name, self.stage, s, e))
            return out

        return timed

    def _apply(self, *args, **kw):
        out, aux = self.real_apply(*args, **kw)
        self.dropped.append(aux["dropped"])
        return out, aux

    def collect(self, split=False):
        """-> ({collective: ms}, [dropped per call]) since the last collect;
        with ``split``, the ms by stage ({"forward": {collective: ms},
        "backward": ..., "grad_sync": ...})."""
        torch.cuda.synchronize()
        ms = {k: {n: 0.0 for n in self.COLLECTIVES} for k in self.STAGES}
        for name, stage, s, e in self.events:
            ms[stage][name] += s.elapsed_time(e)
        if not split:
            ms = {n: sum(ms[k][n] for k in self.STAGES) for n in self.COLLECTIVES}
        dropped = [float(d) for d in self.dropped]
        self.events, self.dropped = [], []
        return ms, dropped

    def restore(self):
        for name, fn in self.real.items():
            setattr(dist, name, fn)
        for (f, m), method in self.real_methods.items():
            setattr(getattr(moe_module, f), m, method)
        moe_module.moe_apply_sharded = self.real_apply


def set_capacity(model, cf):
    """Every MoE layer's capacity factor (the same weights)."""
    cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(model.cfg.moe,
                                                                 capacity_factor=cf))
    for layer in model.layers:
        layer.moe.cfg = cfg


def logits_agreement(want, got):
    """(max |want - got| / max |want|, the share of positions whose argmax
    agrees), over (B, S, V) logits, one request at a time in float32."""
    err = scale = 0.0
    agree = 0
    for w, g in zip(want, got):
        w, g = w.float(), g.float()
        err = max(err, float((w - g).abs().max()))
        scale = max(scale, float(w.abs().max()))
        agree += int((w.argmax(-1) == g.argmax(-1)).sum())
    return err / scale, agree / (want.shape[0] * want.shape[1])


def moe_sweep(mesh, dev):
    """The one-rank sharded MoE against ``MoE`` on each MOE_SWEEP config
    reduced, in float32 (within 1e-5 of max |out|) and bf16 (2e-2), at
    capacity slots / top_k, where nothing can drop."""
    out = {}
    for arch in MOE_SWEEP:
        for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
            cfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
            gen = torch.Generator(device=dev).manual_seed(7)
            moe = MoE(cfg, getattr(torch, dtype), dev)
            for mod in moe.modules():
                if hasattr(mod, "init_"):
                    mod.init_(gen)
            x = torch.randn((MOE_SWEEP_B, MOE_SWEEP_S, cfg.d_model), generator=gen,
                            device=dev).to(getattr(torch, dtype))
            with torch.no_grad():
                want, _ = moe(x)
                got, aux = moe_apply_sharded(shard_moe_params(moe, mesh), cfg, x, mesh)
            err = rel_err(want, got)
            out[f"{arch} {dtype}"] = {"rel_err": err, "dropped": float(aux["dropped"]),
                                      "bound": tol}
            check(err <= tol and float(aux["dropped"]) == 0.0,
                  f"moe_sharded {arch} {dtype}: sharded vs MoE {err} > {tol}")
    return out


class LayerTimer:
    """CUDA events around every layer's ``attn`` and ``moe`` module (forward
    hooks); ``remove(runs)`` unhooks and gives each part's ms per run,
    summed over layers."""

    PARTS = ("attn", "moe")

    def __init__(self, model):
        self.events = {p: [] for p in self.PARTS}
        self.hooks = []
        for layer in model.layers:
            for part in self.PARTS:
                mod = getattr(layer, part)
                self.hooks.append(mod.register_forward_pre_hook(self._start))
                self.hooks.append(mod.register_forward_hook(self._end(part)))

    def _start(self, mod, args):
        mod._t0 = torch.cuda.Event(enable_timing=True)
        mod._t0.record()

    def _end(self, part):
        def hook(mod, args, out):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[part].append((mod._t0, e))
            del mod._t0

        return hook

    def remove(self, runs):
        for h in self.hooks:
            h.remove()
        torch.cuda.synchronize()
        return {p: sum(s.elapsed_time(e) for s, e in ev) / runs for p, ev in self.events.items()}


def moe_layers_vs_plain(model, mesh, layer_in):
    """Each MoE layer's sharded output against its unsharded one on the
    same input (the unsharded run's): max |diff| / max |out| and the share
    of elements that differ."""
    out = []
    with torch.no_grad():
        for layer, x in zip(model.layers, layer_in):
            moe = layer.moe
            want, _ = moe(x)
            got, _ = moe_apply_sharded(shard_moe_params(moe, mesh), moe.cfg, x, mesh)
            diff = (want.float() - got.float()).abs()
            out.append({"rel_err": float(diff.max() / want.float().abs().max()),
                        "differing": float((diff > 0).float().mean())})
    return out


def moe_sharded_path_phase(seed):
    """The sharded MoE path (see the module docstring, item 9)."""
    dev = torch.device("cuda")
    ops.reset_counts()  # the moe_sharded path starts here
    t = {}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s = time.perf_counter()
    mesh = make_host_mesh(dev)
    sharded_probe = ShardedProbe()
    try:
        check(dist.get_backend() == MOE_BACKEND and dist.get_world_size() == 1,
              f"moe_sharded: a {dist.get_backend()} group of {dist.get_world_size()}")
        sweep = moe_sweep(mesh, dev)
        sharded_probe.collect()
        t["sweep_s"] = time.perf_counter() - s

        cfg = reduced_config(MOE_ARCH) if MOE_REDUCED else get_config(MOE_ARCH)
        own_cf = cfg.moe.capacity_factor
        s = time.perf_counter()
        model = build_model(cfg, mesh=mesh, data_size=1, use_sharded_moe=True, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        t["init_s"] = time.perf_counter() - s
        held = sum(p.numel() for p in model.parameters())
        check(param_counts(cfg)[0] == MOE_PARAMS,
              f"moe_sharded: {param_counts(cfg)[0]} parameters, not {MOE_PARAMS}")
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        rng = np.random.default_rng(seed + 37)
        prompts = rng.integers(1, cfg.vocab, (MOE_BATCH, MOE_PROMPT)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(prompts).to(dev)}

        # capacity MOE_NO_DROP_CF: the sharded layers against the unsharded
        # ones on the same weights, unpinned, then on the unsharded run's
        # routes (PinnedRouting): a bf16 router's near ties can flip
        # between two orders of summation
        s = time.perf_counter()
        set_capacity(model, MOE_NO_DROP_CF)
        pin = PinnedRouting()
        model.use_sharded_moe = False
        layer_in = []
        hooks = [layer.moe.register_forward_pre_hook(
            lambda mod, args: layer_in.append(args[0].detach().clone())) for layer in model.layers]
        pin.record()
        plain = model(batch)
        routes = pin.recorded
        pin.restore()
        for h in hooks:
            h.remove()
        per_layer = moe_layers_vs_plain(model, mesh, layer_in)
        del layer_in
        check(max(r["rel_err"] for r in per_layer) <= MOE_BOUND,
              f"moe_sharded: a layer's sharded MoE differs from MoE on the same input: "
              f"{max(r['rel_err'] for r in per_layer)}")
        model.use_sharded_moe = True
        sharded = model(batch)
        _, dropped_nodrop = sharded_probe.collect()
        err_unpinned, agree_unpinned = logits_agreement(plain, sharded)
        del sharded
        pin.replay(routes)
        sharded = model(batch)
        moved = pin.moved
        pin.restore()
        sharded_probe.collect()
        err_pinned, agree_pinned = logits_agreement(plain, sharded)
        del sharded
        check(max(dropped_nodrop) == 0.0,
              f"moe_sharded: tokens dropped at capacity {MOE_NO_DROP_CF}")
        check(err_pinned <= MOE_BOUND and agree_pinned >= MOE_AGREE,
              f"moe_sharded: sharded vs unsharded at capacity {MOE_NO_DROP_CF}: "
              f"{err_pinned} of max |logit|, argmax agreement {agree_pinned}")
        check(agree_unpinned >= MOE_AGREE,
              f"moe_sharded: unpinned argmax agreement {agree_unpinned} < {MOE_AGREE}")
        check(bool(torch.isfinite(plain.float()).all()), "moe_sharded: non-finite logits")
        t["no_drop_s"] = time.perf_counter() - s

        # the config's own capacity: drops, the logits' deviation, timed prefills
        s = time.perf_counter()
        set_capacity(model, own_cf)
        sharded = model(batch)
        _, dropped_own = sharded_probe.collect()
        err_own, agree_own = logits_agreement(plain, sharded)
        del sharded, plain
        times, coll = {}, {}
        for name, on in (("sharded", True), ("unsharded", False)):
            model.use_sharded_moe = on
            model.prefill(batch)  # warm-up
            sharded_probe.collect()
            ms, per = [], []
            parts = LayerTimer(model)
            for _ in range(MOE_TIMED):
                st = torch.cuda.Event(enable_timing=True)
                en = torch.cuda.Event(enable_timing=True)
                st.record()
                model.prefill(batch)
                en.record()
                torch.cuda.synchronize()
                ms.append(st.elapsed_time(en))
                per.append(sharded_probe.collect()[0])
            parts = parts.remove(MOE_TIMED)
            times[name] = {"mean": float(np.mean(ms)), "p50": float(np.median(ms)),
                           "max": float(np.max(ms)), "runs": ms, "parts_ms": parts}
            if on:
                coll = {c: float(np.mean([p[c] for p in per])) for c in per[0]}
        t["timed_s"] = time.perf_counter() - s

        # generation through the engine on the sharded layers
        s = time.perf_counter()
        model.use_sharded_moe = True
        timer = StepTimer(model)
        gen = BatchedEngine(model, max_new=MOE_NEW).generate(
            {"tokens": prompts}, n_new=MOE_NEW, greedy=True)
        decode_ms = timer.ms("decode_step")
        timer.restore()
        gen_s = time.perf_counter() - s
        check(gen.tokens.shape == (MOE_BATCH, MOE_NEW) and (gen.tokens >= 0).all()
              and (gen.tokens < cfg.vocab).all(), "moe_sharded: generated tokens out of range")
        sharded_probe.collect()
        t["generate_s"] = gen_s
        peak = torch.cuda.max_memory_allocated()
        del model
    finally:
        sharded_probe.restore()
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    launches = dict(ops.launches)  # the moe_sharded path ends here
    check(not ops.fallbacks, f"moe_sharded: fell back to the host: {dict(ops.fallbacks)}")
    flops = model_flops(cfg, ShapeCfg("moe_prefill", "prefill", MOE_PROMPT, MOE_BATCH))
    dec = np.asarray(decode_ms)
    emit({"phase": "moe_sharded", "arch": cfg.name, "reduced": MOE_REDUCED, "dtype": cfg.dtype,
          "backend": MOE_BACKEND, "world": 1, "parameters": held,
          "param_counts": list(param_counts(cfg)), "weight_bytes": weight_bytes,
          "peak_bytes": peak - base, "batch": MOE_BATCH, "prompt": MOE_PROMPT,
          "no_drop": {"capacity_factor": MOE_NO_DROP_CF, "max_dropped": max(dropped_nodrop),
                      "per_layer": {"max_rel_err": max(r["rel_err"] for r in per_layer),
                                    "max_differing": max(r["differing"] for r in per_layer),
                                    "layers": per_layer},
                      "unpinned": {"rel_err": err_unpinned, "argmax_agree": agree_unpinned},
                      "pinned": {"rel_err": err_pinned, "argmax_agree": agree_pinned,
                                 "moved_tokens": moved},
                      "bound": MOE_BOUND, "agree_bound": MOE_AGREE},
          "own": {"capacity_factor": own_cf,
                  "dropped": {"mean": float(np.mean(dropped_own)),
                              "max": float(np.max(dropped_own)), "per_layer": dropped_own},
                  "vs_no_drop_unsharded": {"rel_err": err_own, "argmax_agree": agree_own}},
          "prefill_ms": times, "collective_ms": coll,
          "collective_ms_total": float(sum(coll.values())),
          "generate": {"new": MOE_NEW, "wall_s": gen_s, "ms_per_token": gen_s * 1e3 / MOE_NEW,
                       "decode_ms": {"mean": float(dec.mean()), "p50": float(np.median(dec)),
                                     "max": float(dec.max()), "steps": len(dec)}},
          "bounds": {"prefill_ms": flops / BF16_FLOPS_PER_S * 1e3, "prefill_flops": flops,
                     "bf16_flops_per_s": BF16_FLOPS_PER_S},
          "sweep": sweep, "seconds": t, "launches": launches})
    return launches



def paper_encodings(tname):
    """The encodings each type is written in (label, options): Lance on the
    device route (its numpy twin reads the same file), Parquet with 8 KiB
    pages and Arrow; the scalar also with larger pages and the 1 MiB
    dictionary "default"."""
    encs = [("lance", WriteOptions("lance", decode="device")),
            ("parquet-8k", WriteOptions("parquet", page_bytes=8 << 10)),
            ("arrow", WriteOptions("arrow"))]
    if tname == "scalar":
        encs += [(f"parquet-{p >> 10}k", WriteOptions("parquet", page_bytes=p))
                 for p in PAPER_PAGES]
        encs.append(("parquet-1024k-dict",
                     WriteOptions("parquet", page_bytes=1 << 20, dict_encode=True)))
    return encs


def take_bench(reader, column, rows):
    """benchmarks/run.py's take op: a warm-up of 4 rows, ``reset_io``, then
    TAKE_REPEATS takes of ``rows``, each timed on the host clock ending in a
    synchronise.  Returns the last result and the mean wall ms."""
    reader.take(column, rows[:4])
    reader.reset_io()
    walls, out = [], None
    for _ in range(TAKE_REPEATS):
        s = time.perf_counter()
        out = reader.take(column, rows)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - s) * 1e3)
    return out, float(np.mean(walls))


def take_record(reader, **fields):
    """iops/row, read amplification, dependent phases, search-cache bytes and
    modelled rows/s (NVMe, the flat store) of TAKE_REPEATS takes."""
    st = reader.io_stats()
    taken = TAKE_N * TAKE_REPEATS
    return {**fields, "iops_per_row": st.n_iops / taken,
            "read_amplification": st.read_amplification, "phases": st.max_phase,
            "search_cache_bytes": reader.search_cache_bytes(),
            "modelled_rows_per_s": taken / reader.modelled_time()}


def paper_take(label, fb, column, rows, source, probe, **fields):
    """One encoding's take bench.  A Lance file runs on the device route and
    on its numpy-route twin: equal results, identical io_stats and
    modelled_time; the device route's kernels, copies, launches and host
    fallbacks go into the record.  Every result must equal the source rows."""
    tag = f"paper {fields.get('type', '')} {label}"
    if not label.startswith("lance"):
        reader = FileReader(fb)
        got, wall = take_bench(reader, column, rows)
        check(same_values(source.take(rows), got), f"{tag}: take != source")
        return got, take_record(reader, encoding=label, **fields, wall_ms=wall)
    dev, host = FileReader(fb), FileReader(fb, decode="numpy")
    check(dev.decode == "device" and dev.device.type == "cuda", f"{tag}: not the device route")
    n0, f0 = dict(ops.launches), dict(ops.fallbacks)
    probe.collect()
    got, dwall = take_bench(dev, column, rows)
    times = probe.collect()
    launched = {n: ops.launches[n] - n0[n] for n in ops.launches}
    fell = {k: v - f0.get(k, 0) for k, v in ops.fallbacks.items() if v != f0.get(k, 0)}
    want, hwall = take_bench(host, column, rows)
    check(same_buffers(want, got), f"{tag}: device != numpy route")
    check(same_values(source.take(rows), got), f"{tag}: take != source")
    check(io_of(dev) == io_of(host), f"{tag}: IO accounting differs between the routes")
    rec = take_record(dev, encoding=label, **fields, wall_ms=dwall, numpy_wall_ms=hwall,
                      kernel_ms=probe.kernel_ms(times),
                      copy_ms=times.get("to_device", 0.0) + times.get("to_host", 0.0),
                      launches=launched, fallbacks=fell)
    return got, rec


def paper_path_phase(seed, probe):
    """The paper's random-access comparison on the port (see the module
    docstring, item 10)."""
    rng = np.random.default_rng(seed + 17)
    ops.reset_counts()  # the paper path starts here
    rates = {}
    for tname, n in PAPER_ROWS.items():
        s = time.perf_counter()
        arr = synth.paper_type(tname, n, seed=1)
        gen_s = time.perf_counter() - s
        rows = rng.choice(n, TAKE_N, replace=False)
        first = None
        for label, opts in paper_encodings(tname):
            s = time.perf_counter()
            fb = write_table({"c": arr}, opts)
            write_s = time.perf_counter() - s
            got, rec = paper_take(label, fb, "c", rows, arr, probe, type=tname, n_rows=n,
                                  file_bytes=len(fb), gen_s=gen_s, write_s=write_s)
            if first is None:
                first = got
            check(same_values(first, got), f"paper {tname} {label}: differs from lance")
            rates[(tname, label)] = rec["modelled_rows_per_s"]
            emit({"phase": "paper", **rec})
            del fb
        del arr, first
    tuned, default = rates[("scalar", "parquet-8k")], rates[("scalar", "parquet-1024k-dict")]
    emit({"phase": "paper_default_vs_tuned", "tuned": "parquet-8k", "default": "parquet-1024k-dict",
          "tuned_rows_per_s": tuned, "default_rows_per_s": default, "speedup": tuned / default})
    paper_struct(rng, probe)
    paper_nesting(rng, probe)
    launches = dict(ops.launches)  # the paper path ends here
    fallbacks = dict(ops.fallbacks)
    emit({"phase": "paper_path", "checked": "every take exact vs the source rows and every "
          "encoding; Lance's device route equal to its numpy twin with identical io_stats "
          "and modelled_time", "launches": launches, "fallbacks": fallbacks})
    for name in ("miniblock_decode", "fullzip_gather"):
        check(launches[name] > 0, f"{name} never launched on the paper path")
    return launches


def paper_struct(rng, probe):
    """Fig 18: a STRUCT_FIELDS-field struct, packed (every field of a row in
    one IOP) and shredded (one leaf per field); a packed single-field scan
    reads the whole stride."""
    n = STRUCT_ROWS
    arr = A.StructArray.build([(f"f{i}", A.PrimitiveArray.build(
        rng.integers(0, 1 << 40, n).astype(np.int64), nullable=False))
        for i in range(STRUCT_FIELDS)], nullable=False)
    rows = rng.choice(n, TAKE_N, replace=False)
    packed = write_table({"s": arr}, WriteOptions("lance", packed_columns=("s",)))
    got, rec = paper_take("packed", packed, "s", rows, arr, probe, n_rows=n,
                          fields=STRUCT_FIELDS)
    fr = FileReader(packed)
    s = time.perf_counter()
    f0 = fr.scan_packed_field("s", ["f0"])
    scan_ms = (time.perf_counter() - s) * 1e3
    check(same_values(arr.children[0][1], f0.children[0][1]), "paper struct: packed f0 scan")
    check(fr.io_stats().bytes_read == fr.data_bytes(), "paper struct: a packed field scan "
          "did not read the whole stride")
    rec["scan_one_field_ms"] = scan_ms
    rec["scan_one_field_bytes"] = fr.io_stats().bytes_read
    emit({"phase": "paper_struct", **rec})
    shredded = write_table({"s": arr}, WriteOptions("lance", decode="device"))
    got2, rec = paper_take("lance", shredded, "s", rows, arr, probe, n_rows=n,
                           fields=STRUCT_FIELDS)
    check(same_values(got, got2), "paper struct: packed and shredded takes differ")
    emit({"phase": "paper_struct", **rec})


def nested(depth, n):
    """int64 row ids wrapped in ``depth`` single-item list levels (Fig 11)."""
    arr = A.PrimitiveArray(T.int64(), np.ones(n, bool), np.arange(n, dtype=np.int64))
    for _ in range(depth):
        arr = A.ListArray(T.List(arr.type), np.ones(n, bool), np.arange(n + 1, dtype=np.int64),
                          arr)
    return arr


def paper_nesting(rng, probe):
    """Fig 11's nesting rows: Arrow chases one more offsets level per depth;
    Lance full-zip stays at 2 IOPS (1 at depth 0), and adaptive Lance
    (mini-block) at 1."""
    rows = rng.choice(NEST_ROWS, TAKE_N, replace=False)
    for depth in NEST_DEPTHS:
        arr = nested(depth, NEST_ROWS)
        first = None
        for label, opts in (("arrow", WriteOptions("arrow")),
                            ("lance-fullzip", WriteOptions("lance-fullzip", decode="device")),
                            ("lance", WriteOptions("lance", decode="device"))):
            got, rec = paper_take(label, write_table({"c": arr}, opts), "c", rows, arr, probe,
                                  depth=depth, n_rows=NEST_ROWS)
            first = got if first is None else first
            check(same_values(first, got), f"paper nesting {depth} {label}: differs from arrow")
            emit({"phase": "paper_nesting", **rec})


def loader_path_phase(seed, probe):
    """The training input of smollm-360m: a token file written for the
    device route and its numpy twin, each read by a TokenLoader for
    LOADER_BATCHES batches; the batches and ``batch_for_step`` agree."""
    s = time.perf_counter()
    corpus = synth.token_corpus(LOADER_DOCS, LOADER_SEQ, LOADER_VOCAB, seed=seed)
    rec = {"phase": "loader", "documents": LOADER_DOCS, "tokens": int(len(corpus.child.values)),
           "gen_s": time.perf_counter() - s, "write_s": {}, "file_bytes": {}}
    files = {}
    for decode in ("device", "numpy"):
        s = time.perf_counter()
        files[decode] = write_table({"tokens": corpus}, WriteOptions("lance", decode=decode))
        rec["write_s"][decode] = time.perf_counter() - s
        rec["file_bytes"][decode] = len(files[decode])
    del corpus
    ops.reset_counts()  # the loader path starts here
    batches, steps = {}, {}
    for decode in ("device", "numpy"):
        probe.collect()
        s = time.perf_counter()
        ld = TokenLoader(files[decode], batch=LOADER_BATCH, seq_len=LOADER_SEQ, seed=seed,
                         device="cuda")
        try:
            check(ld.reader.decode == decode, f"loader: the {decode} file reads on {ld.reader.decode}")
            out = [next(ld)["tokens"]]  # the producer scans the file before its first batch
            scan_s = time.perf_counter() - s
            times = probe.collect()
            out += [next(ld)["tokens"] for _ in range(LOADER_BATCHES - 1)]
            batch_s = time.perf_counter() - s - scan_s
            steps[decode] = ld.batch_for_step(LOADER_STEP)["tokens"]
        finally:
            ld.close()
        batches[decode] = out
        kernel_ms = probe.kernel_ms(times)["miniblock_decode"]
        copy_ms = times.get("to_device", 0.0) + times.get("to_host", 0.0)
        rec[decode] = {"scan_s": scan_s, "tokens_per_s": rec["tokens"] / scan_s,
                       "batches_s": batch_s, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
                       "kernel_share": kernel_ms / (scan_s * 1e3),
                       "copy_share": copy_ms / (scan_s * 1e3)}
    shape = (LOADER_BATCH, LOADER_SEQ + 1)
    check(all(b.dtype == np.int32 and b.shape == shape for b in batches["device"]),
          "loader: batches are not int32 of (batch, seq_len + 1)")
    check(all(np.array_equal(a, b) for a, b in zip(batches["device"], batches["numpy"]))
          and len(batches["device"]) == LOADER_BATCHES, "loader: the routes' batches differ")
    check(np.array_equal(steps["device"], steps["numpy"]), "loader: batch_for_step differs")
    launches = dict(ops.launches)  # the loader path ends here
    fallbacks = dict(ops.fallbacks)
    emit({**rec, "batches": LOADER_BATCHES, "batch": LOADER_BATCH, "seq_len": LOADER_SEQ,
          "launches": launches, "fallbacks": fallbacks})
    check(launches["miniblock_decode"] > 0, "miniblock_decode never launched on the loader path")
    check(not fallbacks, f"loader: fell back to the host: {fallbacks}")
    return launches


class TrainRecorder:
    """Records ``launch.train.train``'s run from outside: the model it
    builds (and a copy of its first weights), each step's CUDA-event time,
    host enqueue time and metrics, and each ``TokenLoader.batch_for_step``
    call's host time, its ``miniblock_decode`` launches on the calling
    thread and the decode's device time (the probe's lock keeps the
    loader's producer thread out of those counts).  ``restore`` unwraps."""

    def __init__(self, probe):
        self.probe = probe
        self.model, self.first = None, None
        self.steps = []  # (start, end events, host ms, metrics)
        self.scans = []  # {"host_ms", "launches", "kernel_events"}
        self.scanning = threading.local()
        self.real = {"build_model": launch_train.build_model,
                     "make_train_step": launch_train.make_train_step,
                     "batch_for_step": TokenLoader.batch_for_step,
                     "miniblock_decode": ops.miniblock_decode}
        launch_train.build_model = self._build_model
        launch_train.make_train_step = self._make_train_step
        TokenLoader.batch_for_step = self._batch_for_step()
        ops.miniblock_decode = self._decode

    def _build_model(self, *args, **kw):
        self.model = self.real["build_model"](*args, **kw)
        self.first = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        return self.model

    def _make_train_step(self, *args, **kw):
        step = self.step_fn = self.real["make_train_step"](*args, **kw)

        def timed(*a):
            self.last_args = a
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            h = time.perf_counter()
            s.record()
            metrics = step(*a)
            e.record()
            self.steps.append((s, e, (time.perf_counter() - h) * 1e3, metrics))
            return metrics

        return timed

    def _batch_for_step(self):
        real = self.real["batch_for_step"]

        def timed(loader, step):
            self.scanning.scan = {"launches": 0, "kernel_events": []}
            h = time.perf_counter()
            try:
                return real(loader, step)
            finally:
                self.scanning.scan["host_ms"] = (time.perf_counter() - h) * 1e3
                self.scans.append(self.scanning.scan)
                self.scanning.scan = None

        return timed

    def _decode(self, *args, **kw):
        scan = getattr(self.scanning, "scan", None)
        if scan is None:
            return self.real["miniblock_decode"](*args, **kw)
        with self.probe.lock:
            n0 = ops.launches["miniblock_decode"]
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.real["miniblock_decode"](*args, **kw)
            e.record()
            scan["launches"] += ops.launches["miniblock_decode"] - n0
            scan["kernel_events"].append((s, e))
        return out

    def restore(self):
        launch_train.build_model = self.real["build_model"]
        launch_train.make_train_step = self.real["make_train_step"]
        TokenLoader.batch_for_step = self.real["batch_for_step"]
        ops.miniblock_decode = self.real["miniblock_decode"]


def train_attention_ms(cfg, dev):
    """The blockwise attention of one layer at the train step's shape, by
    CUDA events: the forward alone, and forward + backward with its tiles
    checkpointed as in training (backward recomputes each tile)."""
    g = torch.Generator(device=dev).manual_seed(7)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, h, hd), generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_(True) for h in (H, Hkv, Hkv))
    cot = torch.randn((TRAIN_BATCH, TRAIN_SEQ, H, hd), generator=g, device=dev).to(torch.bfloat16)

    def forward():
        with torch.no_grad():
            flash_attention(q, k, v, causal=True)

    def forward_backward():
        torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), cot)

    return {"shape": [TRAIN_BATCH, TRAIN_SEQ, H, Hkv, hd],
            "forward_ms": time_ms(forward, reps=3, warmup=1),
            "forward_backward_ms": time_ms(forward_backward, reps=3, warmup=1)}


GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "wgmma")
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "cudaMemcpy", "cudaFree", "cudaMalloc")


def train_step_profile(step_fn, args):
    """One more train step under ``torch.profiler``: the kernels' device
    time (the matrix products' total, the top kernels by time), the device's
    idle share of the step (the CUDA-event time less the kernels', one
    stream), and the host's time in runtime calls that can wait for the
    device.  None when the profiler records no device activity."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=list(torch.profiler.supported_activities())) as prof:
        s.record()
        step_fn(*args)
        e.record()
        torch.cuda.synchronize()
    step_ms = s.elapsed_time(e)
    kernels, waits = {}, {}
    for ev in prof.events():
        ms = ev.time_range.elapsed_us() / 1e3
        if str(ev.device_type).endswith("CUDA"):
            k = kernels.setdefault(ev.name, [0.0, 0])
        elif ev.name in HOST_WAITS:
            k = waits.setdefault(ev.name, [0.0, 0])
        else:
            continue
        k[0] += ms
        k[1] += 1
    if not kernels:
        return None
    busy = sum(ms for ms, _ in kernels.values())
    gemm = sum(ms for n, (ms, _) in kernels.items() if any(g in n.lower() for g in GEMM_NAMES))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"step_ms": step_ms, "kernels": sum(c for _, c in kernels.values()),
            "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / step_ms),
            "matmul_ms": gemm, "top": [[n[:90], ms, c] for n, (ms, c) in top],
            "host_waits": {n: {"ms": ms, "calls": c} for n, (ms, c) in waits.items()}}


def train_batch(cfg, B, S, rng):
    """(B, S + 1) tokens in [1, vocab) (the reference's ``_batch``), and the
    vlm's vision embeddings or the audio model's frames, as host arrays."""
    b = lm_batch(cfg, B, S, rng)
    b["tokens"] = rng.integers(1, cfg.vocab, (B, S + 1)).astype(np.int32)
    return b


def grad_agreement(card, host):
    """Each gradient tensor of the card against the CPU's (or another
    reference's), on the card's device: -> (min cosine,
    its tensor, median cosine, tensors that are zero on the CPU, tensors
    zero on the CPU and not on the card)."""
    cos, zero, wrong = {}, 0, []
    for name, h in host.items():
        c = card[name].float()
        h = h.to(c.device).float()
        hn = float(h.norm())
        if hn == 0.0:
            zero += 1
            if float(c.abs().max()) != 0.0:
                wrong.append(name)
            continue
        cos[name] = float((c * h).sum() / (c.norm() * hn))
    worst = min(cos, key=lambda k: cos[k] if np.isfinite(cos[k]) else -2.0)
    return cos[worst], worst, float(np.median(list(cos.values()))), zero, wrong


def card_vs_cpu(model, cfg, batch, dev, pin=False):
    """The card's bf16 loss and gradients against the same weights in
    float32 on the CPU; MoE on pinned routes (every routing call of the
    card's forward and backward recompute, replayed on the host)."""
    routes = PinnedRouting().record() if pin else None
    try:
        loss_c, _, grads_c = loss_and_grads(model, on_device(batch, dev, torch.bfloat16))
    finally:
        if routes:
            routes.restore()
    host = host_twin(model, cfg)
    if routes:
        routes.replay(routes.recorded)
    try:
        loss_h, _, grads_h = loss_and_grads(host, on_device(batch, "cpu", torch.float32))
    finally:
        if routes:
            routes.restore()
    cos, worst, median, zero, wrong = grad_agreement(grads_c, grads_h)
    out = {"loss_card": float(loss_c), "loss_cpu_f32": float(loss_h),
           "loss_diff_nats": abs(float(loss_c) - float(loss_h)), "grad_cos_min": cos,
           "grad_cos_min_tensor": worst, "grad_cos_median": median,
           "grad_tensors": len(grads_h), "zero_grad_tensors": zero}
    if routes:
        out["moved_tokens"] = routes.moved
    check(not wrong, f"train {cfg.name}: gradients zero on the CPU and not on the card: {wrong}")
    check(out["loss_diff_nats"] < TRAIN_LOSS_NATS,
          f"train {cfg.name}: card vs CPU loss {out['loss_diff_nats']} >= {TRAIN_LOSS_NATS} nats")
    check(cos >= TRAIN_GRAD_COS,
          f"train {cfg.name}: gradient cosine {cos} ({worst}) < {TRAIN_GRAD_COS}")
    return out, grads_c


def optimizer_vs_cpu(model, cfg, grads, dev):
    """One update of the config's optimizer in float32 on the card and on
    the CPU from the same weights and the same (clipped) float32 gradients:
    each parameter and state tensor's largest difference as a share of its
    max |value|."""
    opt = make_optimizer(cfg.optimizer, lr=3e-4)
    sides = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        params = {k: v.detach().float().to(where) for k, v in model.named_parameters()}
        g = {k: v.float().to(where) for k, v in grads.items()}
        state = opt.init(params)
        g, norm = clip_by_global_norm(g, 1.0)
        opt.update(g, state, params, 0)
        sides[side] = (params, state, float(norm))
        del g
    errs = {}
    for key in sides["cpu"][0]:
        errs[key] = rel_err(sides["cpu"][0][key], sides["card"][0][key])
    flat = lambda st: {f"{k}.{p}.{sub}" if isinstance(v, dict) else f"{k}.{p}": v  # noqa: E731
                       for k, leaves in st.items() for p, vv in leaves.items()
                       for sub, v in (vv.items() if isinstance(vv, dict) else [(None, vv)])}
    card_state, cpu_state = flat(sides["card"][1]), flat(sides["cpu"][1])
    for key, want in cpu_state.items():
        if float(want.abs().max()) > 0:
            errs[key] = rel_err(want, card_state[key])
    worst = max(errs, key=errs.get)
    out = {"optimizer": cfg.optimizer, "grad_norm_card": sides["card"][2],
           "grad_norm_cpu": sides["cpu"][2], "max_rel_err": errs[worst], "worst": worst,
           "tensors": len(errs), "bound": TRAIN_OPT_TOL}
    check(errs[worst] <= TRAIN_OPT_TOL,
          f"train: the optimizer on the card vs the CPU {errs[worst]} ({worst}) > {TRAIN_OPT_TOL}")
    return out


def overfit(model, cfg, batch, lr, steps):
    """The reference's loss-decrease smoke test: ``steps`` steps of the
    config's optimizer on one batch; the losses, last below first."""
    opt = make_optimizer(cfg.optimizer, lr=lr)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt)
    losses = [float(step(state, batch, i)["loss"]) for i in range(steps)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train {cfg.name}: the loss did not decrease on one batch: {losses}")
    return losses


def train_family_sweep(seed, dev):
    """Every config of ARCHS at reduced_config in bf16 on the card: 8 steps
    of its optimizer at lr 3e-3 on one 2 x 33-token batch, the loss
    decreasing; and, from the same first weights, the card's loss and
    gradients against float32 on the CPU (MoE on pinned routes)."""
    rng = np.random.default_rng(seed + 37)
    out = {}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = build_model(cfg, device=dev, generator=gen)
        batch = train_batch(cfg, LM_SWEEP_B, LM_SWEEP_S, rng)
        rec, _ = card_vs_cpu(model, cfg, batch, dev, pin=cfg.moe is not None)
        rec["losses"] = overfit(model, cfg, on_device(batch, dev, torch.bfloat16),
                                TRAIN_OVERFIT_LR, TRAIN_OVERFIT)
        out[arch] = {"family": cfg.family, "optimizer": cfg.optimizer, "remat": cfg.remat, **rec}
        del model
    return out


def train_path_phase(seed, probe):
    """The training path (see the module docstring, item 12)."""
    dev = torch.device("cuda")
    cfg = reduced_config(TRAIN_ARCH) if TRAIN_REDUCED else get_config(TRAIN_ARCH)
    t = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    rec = TrainRecorder(probe)
    ops.reset_counts()  # the train path starts here
    s = time.perf_counter()
    try:
        loss, last = launch_train.train(TRAIN_ARCH, reduced=TRAIN_REDUCED, steps=TRAIN_STEPS,
                                        batch=TRAIN_BATCH, seq=TRAIN_SEQ, device="cuda",
                                        log_every=TRAIN_STEPS)
        torch.cuda.synchronize()
    finally:
        rec.restore()
    launches = dict(ops.launches)  # and ends here
    fallbacks = dict(ops.fallbacks)
    t["launch_s"] = time.perf_counter() - s
    peak = torch.cuda.max_memory_allocated() - base
    model = rec.model
    held = sum(p.numel() for p in model.parameters())
    check(last == TRAIN_STEPS and len(rec.steps) == TRAIN_STEPS and len(rec.scans) == TRAIN_STEPS,
          f"train: {last} steps, {len(rec.steps)} timed, {len(rec.scans)} scans")
    step_ms = [a.elapsed_time(b) for a, b, _, _ in rec.steps]
    enqueue_ms = [h for _, _, h, _ in rec.steps]
    losses = [float(m["loss"]) for *_, m in rec.steps]
    norms = [float(m["grad_norm"]) for *_, m in rec.steps]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)) and loss == losses[-1],
          f"train: a loss or gradient norm is not finite: {losses} {norms}")
    # bf16 weights: a 3e-4 step moves every matrix entry of ~0.03, but not
    # a norm scale of 1.0 (half its ulp is 2e-3), so the matrices must move
    moved = {k for k, v in model.named_parameters() if not torch.equal(v.detach(), rec.first[k])}
    matrices = {k for k, v in model.named_parameters() if v.ndim >= 2}
    check(matrices <= moved, f"train: weights that never moved: {sorted(matrices - moved)}")
    n_tensors = len(rec.first)
    per_scan = [sc["launches"] for sc in rec.scans]
    check(all(n >= 1 for n in per_scan),
          f"train: a step's scan did not launch miniblock_decode: {per_scan}")
    check(launches["miniblock_decode"] >= TRAIN_STEPS,
          f"train: {launches['miniblock_decode']} decode launches for {TRAIN_STEPS} steps")
    check(not fallbacks, f"train: fell back to the host: {fallbacks}")
    scan_host = [sc["host_ms"] for sc in rec.scans]
    scan_kernel = [sum(a.elapsed_time(b) for a, b in sc["kernel_events"]) for sc in rec.scans]
    # where a step's time goes: one more step of the same run, profiled,
    # and the attention of one layer alone
    s = time.perf_counter()
    state, batch, _ = rec.last_args
    profile = train_step_profile(rec.step_fn, (state, batch, TRAIN_STEPS))
    attention = train_attention_ms(cfg, dev)
    t["profile_s"] = time.perf_counter() - s
    del rec, state, batch
    model.requires_grad_(False)
    del model
    torch.cuda.empty_cache()

    # the reference's loss-decrease test at full width, and the card
    # against float32 on the CPU from the same first weights
    s = time.perf_counter()
    rng = np.random.default_rng(seed + 41)
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    host_batch = train_batch(cfg, 1, TRAIN_HOST_TOKENS - 1, rng)
    host, grads = card_vs_cpu(model, cfg, host_batch, dev)
    t["host_s"] = time.perf_counter() - s
    s = time.perf_counter()
    opt_check = optimizer_vs_cpu(model, cfg, grads, dev)
    del grads
    t["optimizer_s"] = time.perf_counter() - s
    s = time.perf_counter()
    batch = on_device(train_batch(cfg, LM_SWEEP_B, LM_SWEEP_S, rng), dev, torch.bfloat16)
    overfit_losses = overfit(model, cfg, batch, TRAIN_OVERFIT_LR, TRAIN_OVERFIT)
    t["overfit_s"] = time.perf_counter() - s
    model.requires_grad_(False)
    del model
    torch.cuda.empty_cache()

    s = time.perf_counter()
    families = train_family_sweep(seed, dev)
    t["families_s"] = time.perf_counter() - s
    emit({"phase": "train_families", "batch": LM_SWEEP_B, "seq": LM_SWEEP_S,
          "steps": TRAIN_OVERFIT, "lr": TRAIN_OVERFIT_LR, "dtype": "bfloat16",
          "bounds": {"loss_nats": TRAIN_LOSS_NATS, "grad_cos": TRAIN_GRAD_COS},
          "archs": families})

    # the bound: 6 N tokens FLOPs at the bf16 dense tensor peak, attention
    # left out (model_flops' train count)
    positions = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, ShapeCfg("train", "train", TRAIN_SEQ, TRAIN_BATCH))
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    steady = np.asarray(step_ms[1:] if len(step_ms) > 1 else step_ms)
    emit({"phase": "train", "arch": cfg.name, "reduced": TRAIN_REDUCED, "dtype": cfg.dtype,
          "optimizer": cfg.optimizer, "remat": cfg.remat, "parameters": held,
          "param_counts": param_counts(cfg)[0], "peak_bytes": peak, "steps": TRAIN_STEPS,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "positions_per_step": positions,
          "losses": losses, "grad_norms": norms, "step_ms": step_ms,
          "step_ms_steady": {"mean": float(steady.mean()), "p50": float(np.median(steady)),
                             "max": float(steady.max()), "steps": len(steady)},
          "step_ms_all": {"mean": float(np.mean(step_ms)), "p50": float(np.median(step_ms)),
                          "max": float(np.max(step_ms))},
          "step_host_enqueue_ms": enqueue_ms,
          "tokens_per_s": positions / (float(steady.mean()) / 1e3),
          "scan": {"host_ms": scan_host, "kernel_ms": scan_kernel,
                   "launches_per_step": per_scan,
                   "kernel_share": float(np.sum(scan_kernel) / np.sum(scan_host))},
          "bounds": {"step_ms": bound_ms, "train_flops": flops,
                     "bf16_flops_per_s": BF16_FLOPS_PER_S,
                     "x_bound": float(steady.mean()) / bound_ms},
          "moved_tensors": len(moved), "tensors": n_tensors,
          "profile": profile, "attention": attention,
          "overfit": {"batch": LM_SWEEP_B, "seq": LM_SWEEP_S, "lr": TRAIN_OVERFIT_LR,
                      "losses": overfit_losses},
          "card_vs_cpu_f32": {"tokens": TRAIN_HOST_TOKENS, **host,
                              "bounds": {"loss_nats": TRAIN_LOSS_NATS,
                                         "grad_cos": TRAIN_GRAD_COS}},
          "optimizer_vs_cpu_f32": opt_check,
          "seconds": t, "launches": launches, "fallbacks": fallbacks})
    return launches


def moe_train_sweep(seed, dev, mesh):
    """Each MOE_SWEEP config reduced, its MoE layers sharded on ``mesh``: the
    card's bf16 loss and gradients against float32 on the CPU, on pinned
    routes, at capacity MOE_NO_DROP_CF (nothing can drop, so the CPU's
    unsharded MoE computes the same function)."""
    rng = np.random.default_rng(seed + 43)
    out = {}
    for arch in MOE_SWEEP:
        cfg = reduced_config(arch)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=MOE_NO_DROP_CF))
        model = build_model(cfg, mesh, data_size=1, use_sharded_moe=True, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed))
        rec, _ = card_vs_cpu(model, cfg, train_batch(cfg, LM_SWEEP_B, LM_SWEEP_S, rng), dev,
                             pin=True)
        out[arch] = {"remat": cfg.remat, **rec}
        del model
    return out


def moe_train_path_phase(seed, probe):
    """The expert-parallel training path (see the module docstring, item 13)."""
    dev = torch.device("cuda")
    cfg = reduced_config(MOE_ARCH) if MOE_TRAIN_REDUCED else get_config(MOE_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    t = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s = time.perf_counter()
    # the training input as launch/train.py writes it: the device route
    corpus = synth.token_corpus(max(64, 4 * MOE_TRAIN_BATCH), MOE_TRAIN_SEQ, cfg.vocab, seed)
    fbytes = write_table({"tokens": corpus}, WriteOptions("lance", decode="device"))
    t["file_s"] = time.perf_counter() - s
    ops.reset_counts()  # the moe_train path starts here
    mesh = make_host_mesh(dev)
    sharded_probe = ShardedProbe()
    rec = TrainRecorder(probe)
    loader = None
    try:
        check(dist.get_backend() == MOE_BACKEND and dist.get_world_size() == 1,
              f"moe_train: a {dist.get_backend()} group of {dist.get_world_size()}")
        s = time.perf_counter()
        families = moe_train_sweep(seed, dev, mesh)
        sharded_probe.collect()
        t["families_s"] = time.perf_counter() - s

        s = time.perf_counter()
        model = build_model(cfg, mesh=mesh, data_size=1, use_sharded_moe=True, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed))
        check(param_counts(cfg) == MOE_TRAIN_PARAMS,
              f"moe_train: param_counts {param_counts(cfg)}, not {MOE_TRAIN_PARAMS}")
        held = sum(p.numel() for p in model.parameters())
        loader = TokenLoader(fbytes, batch=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ, seed=seed,
                             device=dev)
        torch.cuda.synchronize()
        t["init_s"] = time.perf_counter() - s

        # capacity MOE_NO_DROP_CF: the sharded loss and gradients against
        # MoE.forward's on the same weights and batch
        s = time.perf_counter()
        set_capacity(model, MOE_NO_DROP_CF)
        batch = loader.batch_for_step(0)
        loss_s, _, grads_s = loss_and_grads(model, batch)
        _, dropped_nd = sharded_probe.collect()
        model.use_sharded_moe = False
        loss_u, _, grads_u = loss_and_grads(model, batch)
        model.use_sharded_moe = True
        cos, worst, median, zero, wrong = grad_agreement(grads_s, grads_u)
        del grads_s, grads_u
        no_drop = {"capacity_factor": MOE_NO_DROP_CF, "max_dropped": max(dropped_nd),
                   "loss_sharded": float(loss_s), "loss_unsharded": float(loss_u),
                   "loss_diff_nats": abs(float(loss_s) - float(loss_u)),
                   "grad_cos_min": cos, "grad_cos_min_tensor": worst,
                   "grad_cos_median": median, "zero_grad_tensors": zero,
                   "bounds": {"loss_nats": TRAIN_LOSS_NATS, "grad_cos": TRAIN_GRAD_COS}}
        check(max(dropped_nd) == 0.0, f"moe_train: tokens dropped at capacity {MOE_NO_DROP_CF}")
        check(not wrong, f"moe_train: gradients zero unsharded and not sharded: {wrong}")
        check(no_drop["loss_diff_nats"] < TRAIN_LOSS_NATS,
              f"moe_train: sharded vs unsharded loss {no_drop['loss_diff_nats']} nats")
        check(cos >= TRAIN_GRAD_COS,
              f"moe_train: sharded vs unsharded gradient cosine {cos} ({worst})")
        set_capacity(model, cfg.moe.capacity_factor)
        t["no_drop_s"] = time.perf_counter() - s

        # the training run at the config's capacity
        s = time.perf_counter()
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(dict(model.named_parameters()))
        step_fn = make_train_step(model, opt)
        steps, coll, dropped = [], [], []
        for i in range(MOE_TRAIN_STEPS):
            batch = loader.batch_for_step(i)
            st = torch.cuda.Event(enable_timing=True)
            en = torch.cuda.Event(enable_timing=True)
            h = time.perf_counter()
            st.record()
            metrics = step_fn(state, batch, i)
            en.record()
            host_ms = (time.perf_counter() - h) * 1e3
            ms, dr = sharded_probe.collect(split=True)
            steps.append((st.elapsed_time(en), host_ms, float(metrics["loss"]),
                          float(metrics["grad_norm"])))
            coll.append(ms)
            dropped += dr
        t["steps_s"] = time.perf_counter() - s
        fallbacks = dict(ops.fallbacks)

        # one more step under the profiler; one unsharded step on the same weights
        s = time.perf_counter()
        profile = train_step_profile(step_fn, (state, batch, MOE_TRAIN_STEPS))
        model.use_sharded_moe = False
        st = torch.cuda.Event(enable_timing=True)
        en = torch.cuda.Event(enable_timing=True)
        st.record()
        step_fn(state, batch, MOE_TRAIN_STEPS + 1)
        en.record()
        torch.cuda.synchronize()
        unsharded_ms = st.elapsed_time(en)
        model.use_sharded_moe = True
        sharded_probe.collect()
        t["profile_s"] = time.perf_counter() - s
        peak = torch.cuda.max_memory_allocated() - base
        total = torch.cuda.get_device_properties(0).total_memory
        scans = rec.scans
        model.requires_grad_(False)
        del model, state, step_fn, opt
    finally:
        if loader is not None:
            loader.close()
        rec.restore()
        sharded_probe.restore()
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    launches = dict(ops.launches)  # the moe_train path ends here

    step_ms = [x[0] for x in steps]
    losses = [x[2] for x in steps]
    norms = [x[3] for x in steps]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"moe_train: a loss or gradient norm is not finite: {losses} {norms}")
    check(not fallbacks, f"moe_train: fell back to the host: {fallbacks}")
    per_scan = [sc["launches"] for sc in scans]
    check(len(per_scan) == MOE_TRAIN_STEPS + 1 and all(n >= 1 for n in per_scan),
          f"moe_train: a step's scan did not launch miniblock_decode: {per_scan}")
    timed_steps = np.asarray(step_ms[1:])
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    n_active = MOE_TRAIN_PARAMS[1]
    bound_ms = 6 * n_active * tokens / BF16_FLOPS_PER_S * 1e3
    coll_ms = {k: {n: float(np.mean([c[k][n] for c in coll[1:]])) for n in coll[0][k]}
               for k in ShardedProbe.STAGES}
    emit({"phase": "moe_train", "arch": cfg.name, "reduced": MOE_TRAIN_REDUCED,
          "layers": MOE_TRAIN_LAYERS, "dtype": cfg.dtype, "optimizer": cfg.optimizer,
          "remat": cfg.remat, "backend": MOE_BACKEND, "world": 1,
          "capacity_factor": cfg.moe.capacity_factor, "parameters": held,
          "param_counts": list(param_counts(cfg)), "peak_bytes": peak,
          "headroom_bytes": total - peak - base, "batch": MOE_TRAIN_BATCH,
          "seq": MOE_TRAIN_SEQ, "tokens_per_step": tokens, "steps": MOE_TRAIN_STEPS,
          "losses": losses, "grad_norms": norms, "step_ms": step_ms,
          "step_host_enqueue_ms": [x[1] for x in steps],
          "step_ms_after_warmup": {"p50": float(np.median(timed_steps)),
                                   "mean": float(timed_steps.mean()),
                                   "max": float(timed_steps.max()), "steps": len(timed_steps)},
          "tokens_per_s": tokens / (float(np.median(timed_steps)) / 1e3),
          "unsharded_step_ms": unsharded_ms,
          "collective_ms": coll_ms,
          "collective_ms_total": {k: float(sum(v.values())) for k, v in coll_ms.items()},
          "dropped": {"mean": float(np.mean(dropped)), "max": float(np.max(dropped)),
                      "calls": len(dropped)},
          "no_drop": no_drop,
          "scan": {"host_ms": [sc["host_ms"] for sc in scans], "launches_per_step": per_scan},
          "profile": profile,
          "bounds": {"step_ms": bound_ms, "n_active": n_active,
                     "n_counts": "param_counts' active parameters: every weight a token "
                                 "meets, the embedding table and top-k of the routed "
                                 "experts included",
                     "bf16_flops_per_s": BF16_FLOPS_PER_S,
                     "x_bound": float(np.median(timed_steps)) / bound_ms},
          "families": families, "seconds": t, "launches": launches, "fallbacks": fallbacks})
    check(launches["miniblock_decode"] >= MOE_TRAIN_STEPS,
          f"moe_train: {launches['miniblock_decode']} decode launches for {MOE_TRAIN_STEPS} steps")
    return launches


def kv_path_phase(seed, probe):
    """smollm-360m's paged K pool: KV_REQUESTS prefills, then KV_STEPS
    decode steps that append one token to every request and gather every
    request's KV through ``fullzip_gather``; after step KV_REPLACE_AT half
    of the requests are released and replaced, so freed blocks are reused.
    Every gather equals a mirror of the appended values rounded to bf16 on
    the host, and the plain gather of the same store, at tolerance 0."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 23)
    ops.reset_counts()  # the kv path starts here
    kv = PagedKVCache(KV_BLOCKS, KV_FEATURES)  # bf16 on the card
    row_bytes = BLOCK * KV_FEATURES * kv.store.element_size()
    check(kv.store.device.type == "cuda" and kv.store.view(torch.uint8).shape ==
          (KV_BLOCKS, row_bytes), "kv: the store is not the card's bf16 block rows")
    mirror = {}  # rid -> [host-rounded values on the card, length]
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    rec = {"phase": "kv", "blocks": KV_BLOCKS, "row_bytes": row_bytes,
           "pool_bytes": kv.store.numel() * kv.store.element_size(), "requests": KV_REQUESTS,
           "steps": KV_STEPS, "prefill_tokens": 0, "prefill_wall_ms": 0.0,
           "gathers": 0, "gather_bytes": 0, "step_wall_ms": 0.0}

    def prefill(rids):
        lens = rng.integers(KV_PROMPT[0], KV_PROMPT[1] + 1, len(rids))
        for rid, n in zip(rids, lens):
            x = rng.standard_normal((int(n), KV_FEATURES), dtype=np.float32)
            n = int(n)
            m = torch.empty((n + KV_STEPS, KV_FEATURES), dtype=torch.bfloat16, device=dev)
            m[:n] = torch.from_numpy(x).to(torch.bfloat16).to(dev)
            mirror[rid] = [m, n]
            s = time.perf_counter()
            kv.add_request(rid)
            kv.append(rid, x)
            torch.cuda.synchronize()
            rec["prefill_wall_ms"] += (time.perf_counter() - s) * 1e3
            rec["prefill_tokens"] += n

    prefill(list(range(KV_REQUESTS)))
    live = list(range(KV_REQUESTS))
    probe.collect()
    reused = 0
    for step in range(KV_STEPS):
        x = rng.standard_normal((len(live), 1, KV_FEATURES), dtype=np.float32)
        for rid, xi in zip(live, x):
            m = mirror[rid]
            m[0][m[1]] = torch.from_numpy(xi[0]).to(torch.bfloat16).to(dev)
            m[1] += 1
        s = time.perf_counter()
        for rid, xi in zip(live, x):
            kv.append(rid, xi)
        outs = [kv.gather(rid) for rid in live]
        torch.cuda.synchronize()
        rec["step_wall_ms"] += (time.perf_counter() - s) * 1e3
        store = kv.store.view(torch.uint8)
        for rid, got in zip(live, outs):
            m, n = mirror[rid]
            table = torch.from_numpy(kv.block_table(rid)).to(dev)
            plain = ref.fullzip_gather_ref(store, table).view(torch.bfloat16)
            plain = plain.reshape(-1, KV_FEATURES)[:n]
            wrong += (got.view(torch.int16) != m[:n].view(torch.int16)).any(1).sum()
            wrong += (got.view(torch.int16) != plain.view(torch.int16)).any(1).sum()
            rec["gathers"] += 1
            rec["gather_bytes"] += len(table) * row_bytes
        del outs
        check(int(wrong) == 0, f"kv step {step}: {int(wrong)} gathered rows wrong")
        if step + 1 == KV_REPLACE_AT:
            gone = live[::2]
            freed = {b for rid in gone for b in kv.reqs[rid].block_ids}
            for rid in gone:
                kv.release(rid)
                del mirror[rid]
            new = list(range(KV_REQUESTS, KV_REQUESTS + len(gone)))
            prefill(new)
            reused = len(freed & {b for rid in new for b in kv.reqs[rid].block_ids})
            live = live[1::2] + new
            check(reused > 0, "kv: no freed block was reused")
    times = probe.collect()
    kernel_ms = probe.kernel_ms(times)["fullzip_gather"]
    launches = dict(ops.launches)  # the kv path ends here
    rec.update({"tolerance": 0, "rows_wrong": int(wrong), "reused_blocks": reused,
                "utilization": kv.utilization, "kernel_ms": kernel_ms,
                "copy_ms": times.get("to_device", 0.0) + times.get("to_host", 0.0),
                "kernel_share": kernel_ms / rec["step_wall_ms"], "launches": launches,
                "fallbacks": dict(ops.fallbacks)})
    emit(rec)
    check(launches["fullzip_gather"] == rec["gathers"],
          f"kv: {launches['fullzip_gather']} gather launches for {rec['gathers']} gathers")
    return launches


def bitunpack_path_phase(rng):
    """The bitunpack kernel's own path: no reader calls it; the JAX package
    drives it at 2**20 values of 11 bits (kernel_bench)."""
    v = rng.integers(0, 1 << BITUNPACK_BITS, BITUNPACK_N, dtype=np.uint64)
    words = torch.from_numpy(ops.pack_words(bitpack(v, BITUNPACK_BITS))).cuda()
    ops.reset_counts()  # the bitunpack path starts here
    got = ops.bitunpack(words, BITUNPACK_N, BITUNPACK_BITS)
    launches = dict(ops.launches)  # and ends here
    check(np.array_equal(got.cpu().numpy(), v), "bitunpack: values differ from the packed ones")
    check(launches["bitunpack"] > 0, "bitunpack never launched on its path")
    emit({"phase": "bitunpack_path", "values": BITUNPACK_N, "bits": BITUNPACK_BITS,
          "launches": launches})
    return launches


def kernel_case(name, a, kw):
    """One kernel input as the measurement needs it: the kernel's launcher
    on preallocated outputs (``ops.launch_*``, past the wrapper's checks),
    its plain version, the one PyTorch call that computes the same function
    (or None), a check against the plain version -> (mismatches, max |err|,
    extra fields), its shape, and the bytes and operations of its bound."""
    if name == "miniblock_decode":
        rw, dw, vw, p = a
        C, tile, vpe = vw.shape[0], kw["tile_entries"], kw.get("vpe", 1)
        rb, db, fill = kw["rep_bits"], kw["def_bits"], kw.get("fill", 0)
        got = ops.miniblock_decode(*a, **kw)
        plain = lambda: ref.miniblock_decode_ref(rw, dw, vw, p[:, 0], p[:, 1], p[:, 2],  # noqa: E731
                                                 tile, rb, db, vpe, fill)
        bufs = [torch.empty_like(g) for g in got]
        return {
            "launch": lambda: ops.launch_miniblock_decode(
                rw, dw, vw, p, *bufs, rep_bits=rb, def_bits=db, vpe=vpe, fill=fill),
            "plain": plain, "library": None,
            "check": lambda: (*_compare(got, plain()), {}),
            "shape": {"chunks": C, "rep_words": rw.shape[1], "def_words": dw.shape[1],
                      "val_words": vw.shape[1], "rep_bits": rb, "def_bits": db, "vpe": vpe,
                      "tile_entries": tile, "fill": fill},
            "bytes": (4 * ((rw.numel() if rb else 0) + (dw.numel() if db else 0) + vw.numel()
                           + p.numel()) + sum(4 * g.numel() for g in got)),
            "operations": sum(g.numel() for g in got), "ops_per_s": INT_OPS_PER_S}
    if name == "miniblock_take":
        dw, vw, p, pairs = a
        db, vpe, fill = kw["def_bits"], kw.get("vpe", 1), kw.get("fill", 0)
        got = ops.miniblock_take(*a, **kw)
        buf = torch.empty_like(got)
        plain = lambda: ref.miniblock_take_words_ref(*a, db, vpe, fill)  # noqa: E731
        rows = got.shape[0]
        return {
            "launch": lambda: ops.launch_miniblock_take(*a, buf, def_bits=db, vpe=vpe,
                                                        fill=fill),
            "plain": plain, "library": None,
            "check": lambda: (*_compare((got,), (plain(),)), {}),
            "shape": {"chunks": vw.shape[0], "def_words": dw.shape[1],
                      "val_words": vw.shape[1], "rows": rows, "def_bits": db, "vpe": vpe,
                      "fill": fill},
            # each row: its pair, its chunk's params and its values read
            # once, the def words up to its entry, its outputs written once
            "bytes": rows * (4 + 12 + 4 * vpe) + 4 * got.numel()
            + (4 * int(((pairs.to(torch.int64) & 4095) * db // 32 + 1).sum()) if db else 0),
            "operations": got.numel(), "ops_per_s": INT_OPS_PER_S}
    if name == "fullzip_gather":
        zipped, rows = a
        got = ops.fullzip_gather(zipped, rows)
        buf = torch.empty_like(got)
        n_take, stride = got.shape
        n_unique = int(torch.unique(rows).numel())
        return {
            "launch": lambda: ops.launch_fullzip_gather(zipped, rows, buf),
            "plain": lambda: ref.fullzip_gather_ref(zipped, rows),
            "library": lambda: torch.index_select(zipped, 0, rows),
            "check": lambda: (*_compare((got,), (ref.fullzip_gather_ref(zipped, rows),)), {}),
            "shape": {"n_rows": zipped.shape[0], "row_bytes": stride, "n_take": n_take,
                      "unique_rows": n_unique},
            "bytes": n_unique * stride + 4 * n_take + n_take * stride,
            "operations": n_take * stride, "ops_per_s": INT_OPS_PER_S}
    if name == "ivf_topk":
        q, c, ids, k = a[:4]
        mask = a[4] if len(a) > 4 else kw.get("mask")
        (qn, dim), n = q.shape, c.shape[0]
        got = ops.ivf_topk_tensors(q, c, ids, k, mask)
        bufs = [torch.empty_like(g) for g in got]

        def check_topk():
            mism, err, ties = compare_topk(got, ref.ivf_topk_ref(q, c, ids, k, mask),
                                           ref.ivf_topk_scale(q, c))
            return mism, err, {"near_tie_groups": ties}

        return {
            "launch": lambda: ops.launch_ivf_topk(q, c, ids, mask, *bufs),
            "plain": lambda: ref.ivf_topk_ref(q, c, ids, k, mask), "library": None,
            "check": check_topk,
            "shape": {"queries": qn, "candidates": n, "dim": dim, "k": k,
                      "mask": mask is not None},
            "bytes": 4 * n * dim + (qn * n if mask is not None else 0) + 4 * n
            + 4 * qn * dim + 8 * qn * k,
            "operations": 2 * qn * n * dim, "ops_per_s": FP32_FLOPS_PER_S}
    words, n_vals, bits = a
    got = ops.bitunpack(words, n_vals, bits)
    buf = torch.empty_like(got)
    return {
        "launch": lambda: ops.launch_bitunpack(words, buf, bits=bits),
        "plain": lambda: ref.bitunpack_ref(words, n_vals, bits), "library": None,
        "check": lambda: (*_compare((got,), (ref.bitunpack_ref(words, n_vals, bits),)), {}),
        "shape": {"values": n_vals, "bits": bits, "words": words.shape[0]},
        "bytes": -(-n_vals * bits // 8) + 4 * n_vals,
        "operations": n_vals, "ops_per_s": INT_OPS_PER_S}


PATH_ORDER = {"take": 0, "search": 1, "tiered": 2, "serve": 3, "lm": 4, "moe_sharded": 5,
              "paper": 6, "loader": 7, "train": 8, "moe_train": 9, "kv": 10, "bitunpack": 11}


def measure_phase(probe, smallest, launches, sweep, rng):
    """Each kernel at the largest input each path (and search step) gave it:
    back-to-back ``ms``, device-only ``graph_ms``, L2-cold ``cold_ms``, the
    host ``launch_us`` at its smallest sweep input, its plain version's and
    the PyTorch call's times, and its bound.  Then one ``bitunpack`` row at
    BITUNPACK_BIG_N values of words drawn from ``rng`` (step "2**24"), which
    no path launches: its count is the probe's, 0."""
    out = []
    names = list(WRAPPERS)
    keys = sorted(probe.largest, key=lambda k: (names.index(k[0]), PATH_ORDER[k[1]],
                                                k[2] or ""))
    small = {name: kernel_case(name, *smallest[name][1:])["launch"] for name in names}

    def measure(name, path, step, a, kw, launched):
        case = kernel_case(name, a, kw)
        mism, err, extra = case["check"]()
        lib = case["library"]
        bytes_ms = case["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = case["operations"] / case["ops_per_s"] * 1e3
        rec = {
            "name": name, "path": path, "step": step, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": KERNEL_REPLACES[name],
            "launches": launched,
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": err,
            "ms": time_ms(case["launch"]),
            "graph_ms": graph_ms(case["launch"]),
            "cold_ms": cold_ms(case["launch"]),
            "launch_us": launch_us(small[name]),
            "plain_ms": time_ms(case["plain"]),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(lib) if lib else None,
            "library_graph_ms": graph_ms(lib) if lib else None,
            "shape": case["shape"], "bytes": case["bytes"],
            "operations": case["operations"],
            "cases": sweep[name]["cases"] + 1,
            "mismatches": mism + sweep[name]["mismatches"], **extra}
        del case
        check(mism == 0, f"{name} ({path}{' ' + step if step else ''}): disagrees with its "
              "plain version at the measured shape")
        out.append(rec)

    for key in keys:
        _, a, kw = probe.largest[key]
        measure(*key, a, kw, probe.launched[key])
    for name in names:
        check(any(r["name"] == name for r in out), f"{name}: no main-path input to measure")
    n, key = BITUNPACK_BIG_N, ("bitunpack", "bitunpack", "2**24")
    w = rng.integers(0, 1 << 32, -(-n * BITUNPACK_BITS // 32), dtype=np.uint64)
    words = ops.to_device(w.astype(np.uint32), ops.resolve_device())
    measure(*key, (words, n, BITUNPACK_BITS), {}, probe.launched.get(key, 0))
    key = ("miniblock_take", "take", "date take")
    bits = DATE_TAKE["bits"]
    case = ref.miniblock_take_case(rng, 0, 1, DATE_TAKE["chunks"], DATE_TAKE["rows"],
                                   n_range=(4096, 4096), min_bits=bits, max_bits=bits)
    a = tuple(ops.to_device(x, ops.resolve_device()) for x in case)
    measure(*key, a, {"def_bits": 0, "vpe": 1, "fill": 0}, probe.launched.get(key, 0))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain ivf_topk would round differently")
    t0 = time.perf_counter()
    device_phase()
    build_phase()
    sweep, smallest = sweep_phase()
    rng = np.random.default_rng(args.seed)
    phase_s = {}

    def timed(name, fn, *a):
        s = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - s
        return out

    timed("gather_streams", gather_streams_phase, np.random.default_rng(args.seed + 1))
    table, files = dataset_phase(rng)
    probe = Probe()
    probe.path = "take"
    launches = {"take": timed("take", take_path_phase, table, files, rng, probe)}
    probe.path = "search"
    launches["search"] = timed("search", search_path_phase, table, files, rng, probe)
    probe.path = "tiered"
    launches["tiered"] = timed("tiered", tiered_path_phase, table, files, rng, probe)
    probe.path = "serve"
    launches["serve"] = timed("serve", serve_path_phase, table, files, args.seed, probe)
    probe.path = "lm"
    launches["lm"] = timed("lm", lm_path_phase, table, files, args.seed, probe)
    probe.path = "moe_sharded"
    launches["moe_sharded"] = timed("moe_sharded", moe_sharded_path_phase, args.seed)
    del table, files
    probe.path = "paper"
    launches["paper"] = timed("paper", paper_path_phase, args.seed, probe)
    probe.path = "loader"
    launches["loader"] = timed("loader", loader_path_phase, args.seed, probe)
    probe.path = "train"
    launches["train"] = timed("train", train_path_phase, args.seed, probe)
    probe.path = "moe_train"
    launches["moe_train"] = timed("moe_train", moe_train_path_phase, args.seed, probe)
    probe.path = "kv"
    launches["kv"] = timed("kv", kv_path_phase, args.seed, probe)
    probe.path = "bitunpack"
    launches["bitunpack"] = bitunpack_path_phase(rng)
    probe.restore()
    for path, counts in launches.items():
        for name, n in counts.items():
            seen = sum(v for (k, p, _), v in probe.launched.items() if (k, p) == (name, path))
            check(seen == n, f"{name} on the {path} path: the probe saw {seen} of {n} launches")
    kernels = timed("measure", measure_phase, probe, smallest, launches, sweep, rng)
    emit({"phase": "done", "seconds": time.perf_counter() - t0, "phase_seconds": phase_s})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
