"""The port's baselines (Parquet, Arrow-style, packed structs) and the
full-zip walk oracle against the JAX package's, in lockstep on the CPU.

* the cases of ``tests/test_system.py`` (every encoding roundtrips every
  paper type, and the paper's IOPS / read-amplification / search-cache
  claims) run on both packages over each package's own ``synth`` data: their
  assertions hold on both, and the files, values, IO stats, search-cache
  bytes and modelled times they log are identical;
* the Parquet, Arrow and packed cases of ``tests/test_take_pipeline.py`` and
  ``test_dataset_take_packed_struct`` read files the JAX package wrote, and
  the port writes the same bytes.

The walk-parity properties are in ``tests/test_torch_decode_properties.py``.

Tolerance 0 throughout.
"""

import types

import numpy as np
import pytest

from repro.core import arrays as RA
from repro.core import types as RT
from repro.core.file import FileReader as RFileReader
from repro.core.file import write_table as r_write_table
from repro_torch.core import arrays as PA
from repro_torch.core.file import FileReader, WriteOptions, write_table
from repro_torch.kernels import ops

from _torch_port import (KINDS, assert_same_array, assert_same_io, buffers, lockstep_packages,
                         make_array, messy_rows, package, r_opts, to_port)

REF = package("repro")
PORT = package("repro_torch", device="cpu")

N = 600
TAKE = np.random.default_rng(42).choice(N, 31, replace=False)
# tests/test_system.py's encodings: (id, encoding, options)
ENCODINGS = [
    ("lance", "lance", {}),
    ("lance-miniblock", "lance-miniblock", {}),
    ("lance-fullzip", "lance-fullzip", {}),
    ("lance-fullzip-fsst", "lance-fullzip", {"bytes_codec": "fsst_lite"}),
    ("parquet", "parquet", {}),
    ("parquet-dict", "parquet", {"dict_encode": True}),
    ("arrow", "arrow", {}),
    ("arrow-zstd", "arrow", {"arrow_compress": True}),
]
TYPES = ["scalar", "string", "scalar-list", "string-list", "vector"]


def lockstep(case, *args):
    lockstep_packages(REF, PORT, case, *args)


def _take_stats(m, log, arr, opts, rows=TAKE):
    fb = m.write_table({"c": arr}, opts)
    fr = m.FileReader(fb)
    fr.reset_io()
    got = fr.take("c", rows)
    st = fr.io_stats()
    log(fb)
    log(buffers(got))
    log((st, fr.modelled_time(), fr.search_cache_bytes()))
    return fr, st


# ---------------------------------------------------------------------------
# tests/test_system.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encname,enc,kw", ENCODINGS, ids=[e[0] for e in ENCODINGS])
@pytest.mark.parametrize("tname", TYPES)
def test_roundtrip(encname, enc, kw, tname):
    def case(m, log):
        arr = m.synth.paper_type(tname, N, seed=7)
        fb = m.write_table({"c": arr}, m.WriteOptions(enc, **kw))
        fr = m.FileReader(fb)
        want = m.A.to_pylist(arr)
        scanned = fr.scan("c")
        assert m.A.to_pylist(scanned) == want
        got = fr.take("c", TAKE)
        assert m.A.to_pylist(got) == [want[i] for i in TAKE]
        log(fb)
        log(buffers(scanned))
        log(buffers(got))
        log((fr.io_stats(), fr.modelled_time(), fr.search_cache_bytes(), fr.data_bytes()))
    lockstep(case)


def test_fullzip_fixed_width_is_1_iop():
    def case(m, log):
        for t in ["scalar", "vector"]:
            fr, st = _take_stats(m, log, m.synth.paper_type(t, N, seed=7),
                                 m.WriteOptions("lance-fullzip"))
            assert st.n_iops == len(TAKE) and st.max_phase == 1
            assert fr.search_cache_bytes() == 0
    lockstep(case)


def test_fullzip_variable_width_is_2_iops():
    def case(m, log):
        for t in ["string", "scalar-list", "string-list"]:
            fr, st = _take_stats(m, log, m.synth.paper_type(t, N, seed=7),
                                 m.WriteOptions("lance-fullzip"))
            assert st.n_iops == 2 * len(TAKE) and st.max_phase == 2
            assert fr.search_cache_bytes() == 0
    lockstep(case)


def test_fullzip_nesting_invariance():
    def case(m, log):
        T = m.T
        typ = T.List(T.Struct((("s", T.List(T.utf8())),)))
        arr = m.A.from_pylist([[{"s": ["ab", "cd"]}], None, [{"s": []}]] * 50, typ)
        rows = np.arange(0, 150, 7)
        _, st = _take_stats(m, log, arr, m.WriteOptions("lance-fullzip"), rows=rows)
        assert st.n_iops == 2 * len(rows) and st.max_phase == 2
    lockstep(case)


def test_arrow_list_string_is_5_iops_3_phases():
    def case(m, log):
        arr = m.A.from_pylist([["ab", None, "cd"], None, ["xyz"], []] * 50,
                              m.T.List(m.T.utf8()))
        _, st = _take_stats(m, log, arr, m.WriteOptions("arrow"), rows=np.array([5]))
        assert st.n_iops == 5 and st.max_phase == 3
        _, st2 = _take_stats(m, log, arr, m.WriteOptions("lance-fullzip"),
                             rows=np.array([5]))
        assert st2.n_iops == 2 and st2.max_phase == 2
    lockstep(case)


def test_parquet_one_page_per_row():
    def case(m, log):
        arr = m.synth.paper_type("vector", N, seed=9)
        _, st = _take_stats(m, log, arr, m.WriteOptions("parquet", page_bytes=8192),
                            rows=np.array([1, 100, 200, 300, 400]))
        assert st.n_iops == 5 and st.max_phase == 1
    lockstep(case)


def test_parquet_dict_needs_extra_fetch():
    def case(m, log):
        arr = m.synth.paper_type("string", N, seed=7)
        opts = m.WriteOptions("parquet", dict_encode=True)
        _, st = _take_stats(m, log, arr, opts, rows=np.array([3]))
        assert st.n_iops == 2  # dictionary page + data page
        fr2 = m.FileReader(m.write_table({"c": arr}, opts), dict_cached=True)
        fr2.take("c", np.array([3]))
        fr2.reset_io()
        got = fr2.take("c", np.array([4]))
        assert fr2.io_stats().n_iops == 1
        log(buffers(got))
        log((fr2.io_stats(), fr2.modelled_time()))
        log([r.search_cache_bytes_effective() for r in fr2._leaf_readers("c")])
    lockstep(case)


def test_adaptive_threshold():
    def case(m, log):
        scalar = m.synth.paper_type("scalar", N, seed=7)
        vector = m.synth.paper_type("vector", N, seed=7)
        assert m.choose_encoding(m.shred(scalar)[0]) == "miniblock"
        assert m.choose_encoding(m.shred(vector)[0]) == "fullzip"
        for arr, enc in ((vector, "fullzip"), (scalar, "miniblock")):
            fr = m.FileReader(m.write_table({"c": arr}, m.WriteOptions("lance")))
            assert fr.columns["c"]["leaves"][0]["meta"]["encoding"] == enc
            log(fr.search_cache_bytes())
    lockstep(case)


def test_search_cache_budget():
    def case(m, log):
        arr = m.synth.paper_type("scalar", 50_000, seed=11)
        fr = m.FileReader(m.write_table({"c": arr}, m.WriteOptions("lance")))
        assert fr.search_cache_bytes() / fr.data_bytes() < 0.01
        log((fr.search_cache_bytes(), fr.data_bytes()))
    lockstep(case)


def test_miniblock_chunks_within_limits():
    def case(m, log):
        arr = m.synth.paper_type("string", 20_000, seed=13)
        fr = m.FileReader(m.write_table({"c": arr}, m.WriteOptions("lance-miniblock")))
        chunks = fr.columns["c"]["leaves"][0]["meta"]["chunks"]
        for cm in chunks:
            assert cm["n_entries"] <= 4096 and cm["words"] * 8 <= 32 * 1024
        log([(cm["n_entries"], cm["words"]) for cm in chunks])
    lockstep(case)


def _struct(m, n, k, seed, nullable=False):
    rng = np.random.default_rng(seed)
    children = [(f"f{i}", m.A.PrimitiveArray.build(
        rng.integers(0, 1 << 30, n).astype(np.int64),
        validity=(rng.random(n) > 0.1) if nullable and i % 2 else None,
        nullable=nullable and i % 2 == 1)) for i in range(k)]
    return m.A.StructArray.build(children, nullable=nullable,
                                 validity=(rng.random(n) > 0.1) if nullable else None)


def test_struct_packing_tradeoff():
    def case(m, log):
        n = 400
        arr = _struct(m, n, 4, seed=5)
        fb = m.write_table({"s": arr}, m.WriteOptions("lance", packed_columns=("s",)))
        fr = m.FileReader(fb)
        fr.reset_io()
        rows = np.arange(0, n, 37)
        got = fr.take("s", rows)
        assert fr.io_stats().n_iops == len(rows)  # 1 IOP for all fields
        assert m.A.to_pylist(got) == [m.A.to_pylist(arr)[i] for i in rows]
        log(fb)
        log(buffers(got))
        log((fr.io_stats(), fr.modelled_time()))
        fr.reset_io()
        f0 = fr.scan_packed_field("s", ["f0"])
        assert fr.io_stats().bytes_read == fr.data_bytes()  # reads everything
        assert [name for name, _ in f0.children] == ["f0"]
        log(buffers(f0))
        log((fr.io_stats(), fr.modelled_time()))
    lockstep(case)


def test_multi_column_table():
    def case(m, log):
        table = {"id": m.synth.paper_type("scalar", N, seed=1),
                 "text": m.synth.paper_type("string", N, seed=2),
                 "emb": m.synth.paper_type("vector", N, seed=3)}
        fr = m.FileReader(m.write_table(table, m.WriteOptions("lance")))
        for name, arr in table.items():
            got = fr.take(name, TAKE)
            assert m.A.to_pylist(got) == [m.A.to_pylist(arr)[i] for i in TAKE]
            log(buffers(got))
        log((fr.io_stats(), fr.modelled_time()))
    lockstep(case)


# ---------------------------------------------------------------------------
# tests/test_take_pipeline.py: the baselines' cases, on files the JAX package
# wrote (the port writes the same bytes)
# ---------------------------------------------------------------------------


def _pair(arr, encoding, **kw):
    """The JAX package's file for ``arr``; the port must write the same
    bytes from the same buffers."""
    want = r_write_table({"c": arr}, r_opts(encoding, **kw))
    assert write_table({"c": to_port(arr)}, WriteOptions(encoding, **kw)) == want
    return want


@pytest.mark.parametrize("encoding", ["parquet", "arrow"])
@pytest.mark.parametrize("kind", KINDS)
def test_take_equals_scan_gather(encoding, kind):
    rng = np.random.default_rng(123)
    n = 3000 if kind == "nested-list" else 600
    arr = make_array(kind, n, rng)
    fb = _pair(arr, encoding)
    want, got = RFileReader(fb), FileReader(fb, device="cpu")
    scanned = got.scan("c")
    assert_same_array(want.scan("c"), scanned)
    assert PA.to_pylist(scanned) == RA.to_pylist(arr)
    rows = messy_rows(n, 41, rng)
    taken = got.take("c", rows)
    assert_same_array(want.take("c", rows), taken)
    want_rows = PA.to_pylist(scanned)
    assert PA.to_pylist(taken) == [want_rows[i] for i in rows]
    assert_same_io(want, got)


@pytest.mark.parametrize("kind", ["utf8", "fixed-size-list", "nested-list"])
@pytest.mark.parametrize("io_chunk", [64, 257, 8 << 20])
def test_scan_windows_any_chunk_size(kind, io_chunk):
    """Parquet's windowed scan decodes at page boundaries and carries
    tails, so any ``io_chunk`` roundtrips."""
    arr = make_array(kind, 500, np.random.default_rng(31))
    fb = _pair(arr, "parquet")
    want, got = RFileReader(fb), FileReader(fb, device="cpu")
    scanned = got.scan("c", io_chunk=io_chunk)
    assert_same_array(want.scan("c", io_chunk=io_chunk), scanned)
    assert PA.to_pylist(scanned) == RA.to_pylist(arr)
    assert_same_io(want, got)


def _packed_file(arr):
    return _pair(arr, "lance", packed_columns=("c",))


def test_packed_take_out_of_range_raises():
    arr = RA.StructArray.build(
        [("f0", RA.PrimitiveArray.build(np.arange(100, dtype=np.int64), nullable=False))],
        nullable=False)
    fr = FileReader(_packed_file(arr), device="cpu")
    for rows in ([100], [-1]):
        with pytest.raises(IndexError):
            fr.take("c", np.array(rows))


@pytest.mark.parametrize("nullable", [False, True], ids=["plain", "nullable"])
def test_packed_struct_take_dup_unsorted(nullable):
    arr = _struct(types.SimpleNamespace(A=RA, T=RT), 300, 3, seed=7, nullable=nullable)
    fb = _packed_file(arr)
    want, got = RFileReader(fb), FileReader(fb, device="cpu")
    rows = np.array([250, 3, 250, 17, 3, 250])
    for r in (want, got):
        r.reset_io()
    taken = got.take("c", rows)
    assert_same_array(want.take("c", rows), taken)
    assert got.io_stats().n_iops == 3  # deduped, one IOP per unique row
    assert_same_io(want, got)
    assert_same_array(want.scan("c"), got.scan("c"))
    assert_same_array(want.scan_packed_field("c", ["f1"]), got.scan_packed_field("c", ["f1"]))
    assert_same_io(want, got)


def test_dataset_take_packed_struct():
    def case(m, log):
        n = 1200
        table = {"p": _struct(m, n, 3, seed=0)}
        opts = m.WriteOptions("lance", packed_columns=("p",))
        files = m.write_fragments(table, 3, opts)
        ds = m.DatasetReader(files)
        single = m.FileReader(m.write_table(table, opts))
        rows = messy_rows(n, 211, np.random.default_rng(3))
        got = ds.take("p", rows)
        assert m.A.to_pylist(got) == m.A.to_pylist(single.take("p", rows))
        assert m.A.to_pylist(ds.scan("p")) == m.A.to_pylist(table["p"])
        log(files)
        log(buffers(got))
        log((ds.io_stats(), ds.modelled_time(), ds.tier_stats()))
    lockstep(case)


# ---------------------------------------------------------------------------
# writer: byte-identical files for the reference's options; the device
# route reads baselines on the host, as the reference does
# ---------------------------------------------------------------------------

WRITE_CASES = [
    ("nullable", "parquet", {"page_bytes": 1024}),
    ("nullable", "parquet", {"page_bytes": 1 << 20, "dict_encode": True}),
    ("utf8", "parquet", {"dict_encode": True}),
    ("utf8", "parquet", {"bytes_codec": "fsst_lite"}),
    ("fixed-size-list", "parquet", {"dict_encode": True}),
    ("nested-list", "parquet", {"page_bytes": 2048}),
    ("struct-def2", "parquet", {}),
    ("float-fsl", "arrow", {}),
    ("nested-list", "arrow", {"arrow_compress": True}),
    ("struct-def2", "arrow", {"arrow_compress": True}),
]


@pytest.mark.parametrize("kind,encoding,kw", WRITE_CASES,
                         ids=[f"{k}-{e}-{'-'.join(kw) or 'default'}" for k, e, kw in WRITE_CASES])
def test_baseline_files_are_byte_identical(kind, encoding, kw):
    rng = np.random.default_rng(17)
    arr = make_array(kind, 2000, rng)
    fb = _pair(arr, encoding, **kw)
    rows = messy_rows(2000, 97, rng)
    want = RFileReader(fb, decode="pallas")
    ops.reset_counts()
    got = FileReader(fb, decode="device", device="cpu")
    assert_same_array(want.take("c", rows), got.take("c", rows))
    assert_same_array(want.scan("c"), got.scan("c"))
    assert_same_io(want, got)
    assert want.search_cache_bytes() == got.search_cache_bytes()
    assert ops.fallbacks == {}
