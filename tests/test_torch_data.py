"""The port's ``data/`` (synth, the token loader), its paged KV cache and its
quickstart against the JAX package's, on the CPU.

* ``synth`` gives identical arrays, buffer by buffer, for all eight paper
  types, all eight scenarios and the token corpus at a seed;
* the loader cases of ``tests/test_data_serve.py`` run on both packages in
  lockstep (the same numpy int32 batches), and a token file written for the
  device route scans through the ``miniblock_decode`` wrapper;
* ``test_paged_kv_cache`` holds the port's bf16 store, block tables and
  gathers bit-exact against the reference's;
* ``examples/quickstart_torch.py`` runs at a shrunk size.

Tolerance 0 throughout.
"""

import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.data.synth as rsynth
import repro_torch.data.synth as psynth
from repro.data.loader import TokenLoader as RTokenLoader
from repro.serve.kv_cache import BLOCK as R_BLOCK
from repro.serve.kv_cache import PagedKVCache as RPagedKVCache
from repro_torch.core.file import FileReader, WriteOptions, write_table
from repro_torch.data.loader import TokenLoader as PTokenLoader
from repro_torch.kernels import ops
from repro_torch.serve import BLOCK, PagedKVCache

from _torch_port import assert_same_array, buffers, lockstep_packages, package

ROOT = Path(__file__).resolve().parents[1]
REF = package("repro")
PORT = package("repro_torch", device="cpu")
PAPER_N = {"image": 40, "image-list": 12, "vector-list": 30}


def lockstep(case, *args):
    lockstep_packages(REF, PORT, case, *args)


# ---------------------------------------------------------------------------
# synth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", rsynth.PAPER_TYPES)
def test_paper_type_is_identical(name):
    assert psynth.PAPER_TYPES == rsynth.PAPER_TYPES
    n = PAPER_N.get(name, 500)
    for seed in (0, 1):
        assert_same_array(rsynth.paper_type(name, n, seed=seed),
                          psynth.paper_type(name, n, seed=seed))


@pytest.mark.parametrize("name", rsynth.SCENARIOS)
def test_scenario_is_identical(name, monkeypatch):
    """Each package caches its word bank on the first text scenario of the
    process (``_WORDS``); both start from an empty bank here, and a second
    call reuses it in both."""
    assert psynth.SCENARIOS == rsynth.SCENARIOS
    monkeypatch.setattr(rsynth, "_WORDS", None)
    monkeypatch.setattr(psynth, "_WORDS", None)
    n = 12 if name in ("images", "websites", "code") else 200
    for seed in (3, 4):
        assert_same_array(rsynth.scenario(name, n, seed=seed),
                          psynth.scenario(name, n, seed=seed))
    assert (rsynth._WORDS is None) == (psynth._WORDS is None)
    if rsynth._WORDS is not None:
        assert rsynth._WORDS == psynth._WORDS


def test_token_corpus_is_identical():
    for seed in (0, 5):
        assert_same_array(rsynth.token_corpus(40, 64, 1000, seed=seed),
                          psynth.token_corpus(40, 64, 1000, seed=seed))


def test_unknown_names_raise():
    for fn in (psynth.paper_type, psynth.scenario):
        with pytest.raises(KeyError):
            fn("nope", 4)


# ---------------------------------------------------------------------------
# the token loader (tests/test_data_serve.py)
# ---------------------------------------------------------------------------


def test_token_file_roundtrip():
    def case(m, log):
        fb = m.write_token_file(n_rows=64, seq_len=100, vocab=1000, seed=0)
        fr = m.FileReader(fb)
        arr = fr.scan("tokens")
        assert isinstance(arr, m.A.ListArray)
        assert (arr.child.values < 1000).all()
        assert fr.columns["tokens"]["leaves"][0]["meta"]["encoding"] == "miniblock"
        log(fb)
        log(buffers(arr))
        log((fr.io_stats(), fr.modelled_time()))
    lockstep(case)


def test_loader_deterministic_cursor():
    def case(m, log):
        fb = m.write_token_file(n_rows=64, seq_len=100, vocab=1000, seed=0)
        l1 = m.TokenLoader(fb, batch=4, seq_len=32, seed=5)
        l2 = m.TokenLoader(fb, batch=4, seq_len=32, seed=5)
        try:
            for s in [0, 3, 17]:
                a, b = l1.batch_for_step(s)["tokens"], l2.batch_for_step(s)["tokens"]
                np.testing.assert_array_equal(a, b)
                assert a.dtype == np.int32
                log(a)
            a = next(iter(l1))
            assert a["tokens"].shape == (4, 33)
            log(a["tokens"])
        finally:
            l1.close()
            l2.close()
    lockstep(case)


def test_loader_exhausts_cleanly_after_stop():
    def case(m, log):
        fb = m.write_token_file(n_rows=64, seq_len=100, vocab=1000, seed=0)
        ld = m.TokenLoader(fb, batch=4, seq_len=32, seed=5)
        log(next(iter(ld))["tokens"])
        ld.stop()
        with pytest.raises(StopIteration):
            for _ in range(16):
                next(ld)
        with pytest.raises(StopIteration):
            next(ld)
        assert not ld._thread.is_alive()
        log(ld._done)
    lockstep(case)


@pytest.mark.parametrize("loader,kw", [(RTokenLoader, {}), (PTokenLoader, {"device": "cpu"})],
                         ids=["reference", "port"])
def test_loader_killed_producer_raises_stopiteration(loader, kw, monkeypatch):
    """A producer that dies mid-stream must not deadlock the consumer."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    fb = write_table({"tokens": psynth.token_corpus(64, 100, 1000, seed=0)})

    class Dying(loader):
        def _token_stream(self):
            raise RuntimeError("producer crashed")

    ld = Dying(fb, batch=4, seq_len=32, **kw)
    with pytest.raises(StopIteration):
        next(ld)
    ld._thread.join(timeout=5.0)
    assert not ld._thread.is_alive()
    ld.stop()  # no-op after the crash, must not raise


def test_loader_device_route_scans_through_the_kernel(monkeypatch):
    """A token file written for the device route (footer "pallas") scans
    its chunks through ``miniblock_decode`` with no fallback; its batches
    equal the numpy route's and the reference's."""
    corpus = psynth.token_corpus(96, 64, 49_152, seed=2)
    dev_fb = write_table({"tokens": corpus}, WriteOptions("lance", decode="device"))
    np_fb = write_table({"tokens": corpus}, WriteOptions("lance", decode="numpy"))
    assert FileReader(dev_fb, device="cpu").decode == "device"
    calls = []
    real = ops.miniblock_decode
    monkeypatch.setattr(ops, "miniblock_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ops.reset_counts()
    loaders = [PTokenLoader(dev_fb, batch=2, seq_len=64, seed=1, device="cpu"),
               PTokenLoader(np_fb, batch=2, seq_len=64, seed=1, device="cpu"),
               RTokenLoader(dev_fb, batch=2, seq_len=64, seed=1)]
    try:
        batches = [[next(ld)["tokens"] for _ in range(6)] for ld in loaders]
        for other in batches[1:]:
            for a, b in zip(batches[0], other):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(loaders[0].batch_for_step(4)["tokens"],
                                      loaders[2].batch_for_step(4)["tokens"])
    finally:
        for ld in loaders:
            ld.close()
    assert calls and ops.fallbacks == {}


def test_loader_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fb = write_table({"tokens": psynth.token_corpus(8, 16, 100)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PTokenLoader(fb, batch=1, seq_len=8)


# ---------------------------------------------------------------------------
# the paged KV cache
# ---------------------------------------------------------------------------


def _bits(x):
    """bf16 values of either package as their raw 16 bits."""
    if isinstance(x, torch.Tensor):
        return x.cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _same_cache(want, got, rids):
    np.testing.assert_array_equal(_bits(want.store), _bits(got.store))
    assert want.free == got.free and want.utilization == got.utilization
    for rid in rids:
        np.testing.assert_array_equal(want.block_table(rid), got.block_table(rid))
        g = got.gather(rid)
        assert g.dtype == torch.bfloat16 and g.device.type == "cpu"
        np.testing.assert_array_equal(_bits(want.gather(rid)), _bits(g))


def test_paged_kv_cache():
    """tests/test_data_serve.py's case on both packages: the stores, block
    tables, free lists and gathers are bit-identical in bf16, and each
    gather is the appended values rounded to bf16."""
    assert BLOCK == R_BLOCK
    rng = np.random.default_rng(0)
    want, got = RPagedKVCache(n_blocks=32, kv_features=16), \
        PagedKVCache(n_blocks=32, kv_features=16, device="cpu")
    a = rng.standard_normal((200, 16)).astype(np.float32)
    b = rng.standard_normal((40, 16)).astype(np.float32)
    for kv in (want, got):
        kv.add_request(0)
        kv.add_request(1)
        kv.append(0, a)
        kv.append(1, b)
    _same_cache(want, got, [0, 1])
    np.testing.assert_array_equal(_bits(got.gather(0)),
                                  _bits(torch.from_numpy(a).to(torch.bfloat16)))
    assert got.utilization > 0
    for kv in (want, got):
        kv.release(0)
        kv.add_request(2)
        kv.append(2, b)
    _same_cache(want, got, [1, 2])
    np.testing.assert_allclose(got.gather(2).float().numpy(), b, rtol=1e-2)


def test_paged_kv_cache_block_rows_of_a_real_model():
    """smollm-360m's K pool rows (5 KV heads x 64 = 320 features: 81,920-byte
    block rows): prefills, one-token decode steps that cross block edges,
    releases and reuse, against the reference bit for bit."""
    rng = np.random.default_rng(7)
    want, got = RPagedKVCache(n_blocks=12, kv_features=320), \
        PagedKVCache(n_blocks=12, kv_features=320, device="cpu")
    live = [0, 1, 2]
    for rid, n in zip(live, (300, 127, 1)):
        x = rng.standard_normal((n, 320)).astype(np.float32)
        for kv in (want, got):
            kv.add_request(rid)
            kv.append(rid, x)
    for step in range(3):
        for rid in live:
            x = rng.standard_normal((1, 320)).astype(np.float32)
            for kv in (want, got):
                kv.append(rid, x)
        if step == 1:
            for kv in (want, got):
                kv.release(2)
                kv.add_request(3)
                kv.append(3, np.ones((129, 320), np.float32))
            live = [0, 1, 3]
    _same_cache(want, got, live)
    assert got.store.view(torch.uint8).shape == (12, BLOCK * 320 * 2)
    with pytest.raises(MemoryError):
        got.append(0, np.zeros((12 * BLOCK, 320), np.float32))


def test_paged_kv_cache_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(n_blocks=2, kv_features=4)


# ---------------------------------------------------------------------------
# examples/quickstart_torch.py
# ---------------------------------------------------------------------------


def test_quickstart_torch_example_runs(monkeypatch, capsys):
    """End-to-end smoke of examples/quickstart_torch.py (scaled down, on
    the CPU)."""
    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "N_ROWS", 600)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    for enc in ("lance-adaptive", "lance-fullzip", "parquet-8k", "arrow"):
        assert out.count(enc) == 3
    assert "manifest v3" in out and "nvme hit-rate 1.00" in out
    # Arrow's List<String> take: 4 reads in 3 dependent phases for the
    # nulls-free lists of synth (the paper's Fig 4 counts 5 with nulls)
    cells = next(ln for ln in out.splitlines()
                 if ln.startswith("arrow") and "string-list" in ln).split()
    assert (cells[2], cells[4]) == ("4.00", "3")
