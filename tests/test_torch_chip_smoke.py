"""chip_smoke.py, rehearsed on the CPU (tools/rehearse_chip_smoke.py): every
phase runs at a tiny size with the kernels' plain versions and the CUDA
measurement, streams and graphs stubbed, and the result lines keep the shape
the card's run must print.  No number here is a measurement."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"name", "path", "step", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "graph_ms", "cold_ms", "launch_us", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_graph_ms", "shape", "bytes", "operations", "cases",
        "mismatches"}


@pytest.fixture(scope="module")
def rehearsal():
    """The rehearsal's standard output lines (one run for this module)."""
    run = subprocess.run([sys.executable, str(ROOT / "tools" / "rehearse_chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout.strip().splitlines()


def test_chip_smoke_rehearses_on_the_cpu(rehearsal):
    lines = rehearsal
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "CPU rehearsal", "count": 1}}
    assert "CPU rehearsal, 0 W" in lines[:-2]
    kernels = json.loads(lines[-2])["kernels"]
    for k in kernels:
        assert KEYS <= set(k), KEYS - set(k)
        # the 2**24 unpack and date-take rows are off every path; every other
        # row's path launched it
        assert (k["launches"] > 0) != (k["step"] in ("2**24", "date take"))
        assert k["mismatches"] == 0
        assert k["source"] == f"src/repro_torch/kernels/csrc/{k['name']}.cu"
        assert (k["library_ms"] is None) == (k["name"] != "fullzip_gather")
    entries = {(k["name"], k["path"], k["step"]) for k in kernels}
    assert len(entries) == len(kernels)
    assert {("miniblock_decode", "take", None), ("miniblock_decode", "search", None),
            ("miniblock_decode", "tiered", None), ("fullzip_gather", "tiered", None),
            ("fullzip_gather", "take", None), ("fullzip_gather", "search", None),
            ("fullzip_gather", "serve", None), ("miniblock_decode", "paper", None),
            ("fullzip_gather", "paper", None), ("miniblock_decode", "loader", None),
            ("fullzip_gather", "kv", None), ("fullzip_gather", "lm", None),
            ("ivf_topk", "search", "probe"), ("bitunpack", "bitunpack", None),
            ("miniblock_decode", "train", None), ("miniblock_decode", "moe_train", None),
            ("bitunpack", "bitunpack", "2**24"), ("miniblock_take", "take", None),
            ("miniblock_take", "take", "date take")} <= entries
    assert {s for n, _, s in entries if n == "ivf_topk"} == {
        "probe", "candidates q=1", "candidates q=4", "candidates q=8"}
    phases = [json.loads(ln).get("phase") for ln in lines if ln.startswith("{")]
    for phase in ("device", "build", "kernels", "gather_streams", "take_path", "search_path",
                  "tiered", "tiered_path", "serve", "serve_latency", "serve_chaos",
                  "serve_trace", "serve_path", "paper", "paper_default_vs_tuned",
                  "paper_struct", "paper_nesting", "paper_path", "loader", "kv",
                  "lm", "lm_families", "lm_serve", "moe_sharded", "train", "train_families",
                  "moe_train", "bitunpack_path", "done"):
        assert phase in phases
    records = [json.loads(ln) for ln in lines if ln.startswith('{"phase"')]
    streams = next(r for r in records if r["phase"] == "gather_streams")
    assert streams["rows_wrong"] == {"streams": 0, "graph": 0, "direct": 0}
    steps = {(r["store"], r["step"]) for r in records if r["phase"] == "tiered"}
    assert {("tiered", "take cold"), ("tiered", "take warm"), ("tiered", "scan id, cold"),
            ("hot", "take warm"), ("tiered-auto", "scan id, then takes"),
            ("tiered", "Retriever.fetch warm"),
            ("tiered", "DatasetWriter(files) ingest, write-back"),
            ("tiered", "append uncommitted, simulate_crash, scan")} <= steps
    tiered = next(r for r in records if r["phase"] == "tiered_path")
    assert tiered["launches"]["miniblock_decode"] > 0 and tiered["launches"]["fullzip_gather"] > 0
    assert tiered["fallbacks"] == {}
    serve = {r["route"]: r for r in records if r["phase"] == "serve"}
    assert set(serve) == {"device", "numpy"}
    for r in serve.values():
        assert r["requests"] == 96 and r["request_wall_ms"]["p50"] > 0
    latency = next(r for r in records if r["phase"] == "serve_latency")
    for mode in ("interleaved", "serial"):
        assert {"premium", "standard", "ingest", "all"} <= set(latency["virtual_ms"][mode])
    assert 0 < latency["nvme_hit_rate"] <= 1
    chaos = next(r for r in records if r["phase"] == "serve_chaos")
    assert chaos["blackout_failover"]["failed"] == 0
    assert chaos["blackout_no_failover"]["failed"] > 0
    assert chaos["shed_drill"]["trips"] == 1
    assert chaos["shed_drill"]["availability_premium"] == 1.0
    trace = next(r for r in records if r["phase"] == "serve_trace")
    assert trace["events"] > 0 and trace["bytes"] > 0
    assert {"reader", "scheduler", "writer", "flush"} <= set(trace["by_category"])
    path = next(r for r in records if r["phase"] == "serve_path")
    assert path["launches"]["fullzip_gather"] > 0
    assert path["fallbacks"] == {} and path["tracer_fallbacks"] == {}
    row = next(k for k in kernels if (k["name"], k["path"]) == ("fullzip_gather", "serve"))
    assert row["launches"] == path["launches"]["fullzip_gather"]
    assert row["shape"]["n_take"] == 32


def test_chip_smoke_rehearses_the_paper_loader_and_kv_paths(rehearsal):
    lines = rehearsal
    records = [json.loads(ln) for ln in lines if ln.startswith('{"phase"')]
    kernels = {(k["name"], k["path"]): k for k in json.loads(lines[-2])["kernels"]}
    paper = [r for r in records if r["phase"] == "paper"]
    assert {(r["type"], r["encoding"]) for r in paper} == {
        (t, e) for t in ("scalar", "string", "scalar-list", "string-list", "vector",
                         "vector-list", "image", "image-list")
        for e in ("lance", "parquet-8k", "arrow")} | {
        ("scalar", e) for e in ("parquet-64k", "parquet-256k", "parquet-1024k",
                                "parquet-1024k-dict")}
    for r in paper:
        assert r["iops_per_row"] > 0 and r["phases"] >= 1 and r["modelled_rows_per_s"] > 0
        assert ("numpy_wall_ms" in r) == (r["encoding"] == "lance")
    lance = {r["type"]: r for r in paper if r["encoding"] == "lance"}
    # only the vector reaches a kernel: 60-bit scalars and var-width leaves
    # decode on the host, counted
    assert lance["vector"]["launches"]["fullzip_gather"] > 0
    assert lance["scalar"]["fallbacks"] == {"decode.fallback.miniblock.>31-bit": 3}
    assert "decode.fallback.miniblock.variable-width-leaf" in lance["string"]["fallbacks"]
    tuned = next(r for r in records if r["phase"] == "paper_default_vs_tuned")
    assert tuned["speedup"] > 0
    struct = {r["encoding"]: r for r in records if r["phase"] == "paper_struct"}
    assert struct["packed"]["iops_per_row"] == 1.0
    assert struct["packed"]["scan_one_field_bytes"] > 0
    nesting = {(r["depth"], r["encoding"]): r for r in records if r["phase"] == "paper_nesting"}
    assert [nesting[(d, "arrow")]["phases"] for d in range(4)] == [1, 2, 3, 4]
    assert {nesting[(d, "lance-fullzip")]["phases"] for d in range(1, 4)} == {2}
    assert all(nesting[(d, "lance")]["launches"]["miniblock_decode"] > 0 for d in range(4))
    path = next(r for r in records if r["phase"] == "paper_path")
    assert path["launches"]["miniblock_decode"] > 0 and path["launches"]["fullzip_gather"] > 0
    loader = next(r for r in records if r["phase"] == "loader")
    assert loader["launches"]["miniblock_decode"] > 0 and loader["fallbacks"] == {}
    assert loader["device"]["kernel_ms"] > 0 and loader["numpy"]["kernel_ms"] == 0
    kv = next(r for r in records if r["phase"] == "kv")
    assert kv["row_bytes"] == 81920 and kv["rows_wrong"] == 0 and kv["reused_blocks"] > 0
    assert kv["launches"]["fullzip_gather"] == kv["gathers"] == 4 * 8
    assert kernels[("fullzip_gather", "kv")]["launches"] == kv["gathers"]
    assert kernels[("fullzip_gather", "kv")]["shape"]["row_bytes"] == 81920
    assert kernels[("miniblock_decode", "loader")]["launches"] == \
        loader["launches"]["miniblock_decode"]


def test_chip_smoke_rehearses_the_lm_path(rehearsal):
    """The lm path at the rehearsal's size: reduced smollm-360m (2 prompts of
    64 tokens, 4 new), the fetch through the gather, every check's error
    below its bound, every config in the family sweep, the entry point."""
    lines = rehearsal
    records = {json.loads(ln)["phase"]: json.loads(ln) for ln in lines
               if ln.startswith('{"phase": "lm')}
    lm = records["lm"]
    assert lm["arch"] == "smollm-360m" and lm["reduced"] and lm["dtype"] == "bfloat16"
    assert lm["parameters"] == lm["param_counts"] + 9 * 128
    assert lm["fetch"]["rows"] == 16 and lm["fetch"]["n_iops"] > 0
    assert lm["decode_ms"]["steps"] == 4 and lm["prefill_ms"] > 0 and lm["tokens_per_s"] > 0
    assert lm["cache_capacity"] == 64 + 4 + 8
    checks = lm["checks"]
    assert max(checks["prefill_vs_decode"], checks["card_vs_cpu_f32_64_tokens"]) < 0.06
    assert checks["replay_max_gap"] <= 0.02
    bounds = lm["bounds"]
    assert 0 < bounds["weights_only_ms"] < bounds["decode_step_ms"] and bounds["prefill_ms"] > 0
    assert lm["attention"]["rel_err_vs_sdpa"] < 2e-2
    assert lm["launches"]["fullzip_gather"] > 0 and lm["fallbacks"] == {}
    families = records["lm_families"]["archs"]
    assert list(families) == ["smollm-360m", "qwen1.5-4b", "qwen2-72b", "qwen1.5-32b",
                              "mamba2-780m", "grok-1-314b", "deepseek-v2-lite-16b", "zamba2-7b",
                              "llama-3.2-vision-90b", "seamless-m4t-medium"]
    for arch, r in families.items():
        assert max(r["prefill_vs_decode"], r["card_vs_cpu_f32"]) < 0.06, arch
        assert ("moved_tokens" in r) == (r["family"] == "moe")
    serve = records["lm_serve"]
    assert serve["arch"] == "smollm-360m" and serve["reduced"] and serve["fetch"]["rows"] == 32
    kernels = {(k["name"], k["path"]): k for k in json.loads(lines[-2])["kernels"]}
    row = kernels[("fullzip_gather", "lm")]
    assert row["launches"] == lm["launches"]["fullzip_gather"] and row["mismatches"] == 0


def test_chip_smoke_rehearses_the_train_path(rehearsal):
    """The train path at the rehearsal's size: launch.train on reduced
    smollm-360m (3 steps of 2 x 64 positions), every step's scan through
    the decode wrapper with no fallback, the matrices moved, the card/CPU
    and optimizer checks within their bounds, the loss decreasing on one
    batch, every config in the family sweep, and the kernels row."""
    lines = rehearsal
    records = {json.loads(ln)["phase"]: json.loads(ln) for ln in lines
               if ln.startswith('{"phase": "train')}
    tr = records["train"]
    assert tr["arch"] == "smollm-360m" and tr["reduced"] and tr["dtype"] == "bfloat16"
    assert tr["steps"] == 3 and tr["positions_per_step"] == 2 * 64
    assert len(tr["losses"]) == len(tr["grad_norms"]) == len(tr["step_ms"]) == 3
    assert tr["scan"]["launches_per_step"] == [1, 1, 1] and tr["fallbacks"] == {}
    assert tr["launches"]["miniblock_decode"] >= 3
    assert tr["bounds"]["step_ms"] > 0 and tr["tokens_per_s"] > 0
    assert 0 < tr["moved_tensors"] <= tr["tensors"]
    host = tr["card_vs_cpu_f32"]
    assert host["loss_diff_nats"] < 2e-2 and host["grad_cos_min"] >= 0.99
    assert tr["optimizer_vs_cpu_f32"]["max_rel_err"] <= 1e-6
    assert tr["overfit"]["losses"][-1] < tr["overfit"]["losses"][0]
    families = records["train_families"]["archs"]
    assert len(families) == 10
    for arch, r in families.items():
        assert r["losses"][-1] < r["losses"][0], arch
        assert r["loss_diff_nats"] < 2e-2 and r["grad_cos_min"] >= 0.99, arch
        assert ("moved_tokens" in r) == (r["family"] == "moe")
    kernels = {(k["name"], k["path"]): k for k in json.loads(lines[-2])["kernels"]}
    row = kernels[("miniblock_decode", "train")]
    assert row["launches"] == tr["launches"]["miniblock_decode"] and row["mismatches"] == 0


def test_chip_smoke_rehearses_the_moe_sharded_path(rehearsal):
    """The sharded MoE path at the rehearsal's size: reduced
    deepseek-v2-lite on a world-1 gloo mesh (2 prompts of 64 tokens), the
    one-rank sweep against MoE, nothing dropped at capacity 11.0 and the
    sharded logits within their bounds, drops at the config's own 1.25,
    the four collectives timed, 4 generated tokens, no kernel and no
    fallback on the path."""
    lines = rehearsal
    moe = next(json.loads(ln) for ln in lines if ln.startswith('{"phase": "moe_sharded"'))
    assert moe["arch"] == "deepseek-v2-lite-16b" and moe["reduced"] and moe["dtype"] == "bfloat16"
    assert moe["backend"] == "gloo" and moe["world"] == 1
    assert moe["param_counts"][0] == 944_128 and moe["batch"] == 2 and moe["prompt"] == 64
    no_drop = moe["no_drop"]
    assert no_drop["capacity_factor"] == 11.0 and no_drop["max_dropped"] == 0.0
    assert no_drop["pinned"]["rel_err"] <= 2e-2 and no_drop["pinned"]["argmax_agree"] >= 0.99
    assert no_drop["unpinned"]["argmax_agree"] >= 0.99
    own = moe["own"]
    assert own["capacity_factor"] == 1.25 and len(own["dropped"]["per_layer"]) == 4
    assert 0 <= own["dropped"]["mean"] <= own["dropped"]["max"] < 1
    assert set(moe["collective_ms"]) == {"all_to_all_single", "reduce_scatter_tensor",
                                         "all_gather_into_tensor", "all_reduce"}
    assert all(v > 0 for v in moe["collective_ms"].values())
    sharded = moe["prefill_ms"]["sharded"]
    assert sharded["p50"] > 0 and len(sharded["runs"]) == 2
    assert set(sharded["parts_ms"]) == {"attn", "moe"}
    no_drop_layers = moe["no_drop"]["per_layer"]
    assert len(no_drop_layers["layers"]) == 4 and no_drop_layers["max_rel_err"] <= 2e-2
    assert moe["generate"]["decode_ms"]["steps"] == 4 and moe["generate"]["ms_per_token"] > 0
    assert moe["bounds"]["prefill_ms"] > 0
    assert set(moe["sweep"]) == {f"{a} {d}" for a in ("grok-1-314b", "deepseek-v2-lite-16b")
                                 for d in ("float32", "bfloat16")}
    assert all(r["rel_err"] <= r["bound"] for r in moe["sweep"].values())
    assert not any(moe["launches"].values())


def test_chip_smoke_rehearses_the_moe_train_path(rehearsal):
    """The expert-parallel train path at the rehearsal's size: reduced
    deepseek-v2-lite cut to 2 layers on a world-1 gloo mesh, 3 steps of
    2 x 64 positions from the device-route token file (one decode launch a
    scan, no fallback), the sharded gradients against MoE.forward's at
    capacity 11.0 and the reduced configs against float32 on the CPU within
    the train path's bounds, the collectives staged forward, backward and
    gradient sync, and the line between train and kv in the run's order
    (PATH_ORDER), its kernels row after train's."""
    lines = rehearsal
    phases = [json.loads(ln)["phase"] for ln in lines if ln.startswith('{"phase"')]
    assert phases.index("train") < phases.index("moe_train") < phases.index("kv")
    mt = next(json.loads(ln) for ln in lines if ln.startswith('{"phase": "moe_train"'))
    assert mt["arch"] == "deepseek-v2-lite-16b" and mt["reduced"] and mt["layers"] == 2
    assert mt["dtype"] == "bfloat16" and mt["optimizer"] == "adamw" and mt["remat"] == "full"
    assert mt["backend"] == "gloo" and mt["world"] == 1 and mt["capacity_factor"] == 1.25
    assert mt["param_counts"] == [537_600, 439_296]
    assert mt["batch"] == 2 and mt["seq"] == 64 and mt["tokens_per_step"] == 128
    assert mt["steps"] == 3 and len(mt["losses"]) == len(mt["step_ms"]) == 3
    assert all(np.isfinite(mt["losses"])) and all(np.isfinite(mt["grad_norms"]))
    assert mt["step_ms_after_warmup"]["steps"] == 2 and mt["tokens_per_s"] > 0
    assert mt["unsharded_step_ms"] > 0
    assert mt["scan"]["launches_per_step"] == [1, 1, 1, 1] and mt["fallbacks"] == {}
    assert set(mt["collective_ms"]) == {"forward", "backward", "grad_sync"}
    for stage in ("forward", "backward"):
        assert all(v > 0 for v in mt["collective_ms"][stage].values()), stage
    assert mt["collective_ms"]["grad_sync"]["all_reduce"] > 0
    assert 0 <= mt["dropped"]["mean"] <= mt["dropped"]["max"] < 1
    # each forward's 2 layers in 3 steps; a remat recompute that stops early,
    # inside the layer, once backward has what it needs, records none
    assert mt["dropped"]["calls"] >= 2 * 3
    nd = mt["no_drop"]
    assert nd["capacity_factor"] == 11.0 and nd["max_dropped"] == 0.0
    assert nd["loss_diff_nats"] < 2e-2 and nd["grad_cos_min"] >= 0.99
    bounds = mt["bounds"]
    assert bounds["n_active"] == 439_296
    assert bounds["step_ms"] == 6 * 439_296 * 128 / 989e12 * 1e3
    assert set(mt["families"]) == {"grok-1-314b", "deepseek-v2-lite-16b"}
    for arch, r in mt["families"].items():
        assert r["loss_diff_nats"] < 2e-2 and r["grad_cos_min"] >= 0.99, arch
        assert "moved_tokens" in r
    assert mt["launches"]["miniblock_decode"] >= 3
    kernels = json.loads(lines[-2])["kernels"]
    paths = [k["path"] for k in kernels if k["name"] == "miniblock_decode"]
    assert paths.index("train") + 1 == paths.index("moe_train")
    row = next(k for k in kernels if (k["name"], k["path"]) == ("miniblock_decode", "moe_train"))
    assert row["launches"] == mt["launches"]["miniblock_decode"] and row["mismatches"] == 0
