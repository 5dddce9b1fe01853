"""A mini-block take that selects its rows on the device (``miniblock_take``).

Columns without repetition levels, read with ``decode="device"``, take each
requested row's entry alone; every other take decodes whole chunks and
selects on the host (``_select``).  Held here, tolerance 0:

* ``ops.miniblock_take`` (on the CPU: ``miniblock_decode``'s plain version,
  then ``ref.miniblock_take_ref``) against a field-by-field oracle;
* the new route against the same take through ``_select`` (the route turned
  off), the numpy route and the JAX package's pallas route: values, logical
  IO, modelled time and fallback counts;
* which takes take it: a nested list, a float column and a batch holding
  one chunk the kernels cannot read keep today's path and its fallbacks;
* the ``miniblock.rows_on_card`` / ``miniblock.rows_on_host`` counters.
"""

import numpy as np
import pytest
import torch

import repro.core.arrays as RA
from repro.core.file import FileReader as RFileReader
from repro.core.file import write_table as r_write_table
from repro.obs import Tracer as RTracer
from repro_torch.core.file import FileReader
from repro_torch.core.miniblock import MiniBlockReader
from repro_torch.kernels import ops, ref
from repro_torch.obs import Tracer

from _torch_port import assert_same_array, assert_same_io, make_array, r_opts

N = 20_000
I32_MIN = -(1 << 31)


def _column(kind: str, rng: np.random.Generator):
    """A JAX-package array and the fixed codec it is written with."""
    valid = rng.random(N) > 0.1
    if kind == "bits=1":
        return RA.PrimitiveArray.build(rng.integers(0, 2, N).astype(np.int32), nullable=False), None
    if kind == "bits=14":
        return RA.PrimitiveArray.build(rng.integers(0, 1 << 14, N).astype(np.int32),
                                       nullable=False), None
    if kind == "bits=31":
        return RA.PrimitiveArray.build(rng.integers(0, 1 << 31, N).astype(np.int32),
                                       nullable=False), None
    if kind == "nullable bits=14":
        return RA.PrimitiveArray.build(rng.integers(0, 1 << 14, N).astype(np.int64),
                                       validity=valid), None
    if kind == "bytepack FoR at the int32 floor":
        v = (I32_MIN + rng.integers(0, 1 << 15, N)).astype(np.int64)
        return RA.PrimitiveArray.build(v, validity=valid), "bytepack"
    if kind == "fixed-size-list vpe=4":
        return RA.FixedSizeListArray.build(rng.integers(0, 1 << 10, (N, 4)).astype(np.int32),
                                           validity=valid), None
    if kind == "struct-def2":
        return make_array("struct-def2", N, rng), None
    raise ValueError(kind)


KINDS = ["bits=1", "bits=14", "bits=31", "nullable bits=14", "bytepack FoR at the int32 floor",
         "fixed-size-list vpe=4", "struct-def2"]


def _boundaries(fb):
    """Each chunk's first row (the repetition index's rows before it)."""
    leaf = FileReader(fb, device="cpu")._leaf_readers("c")[0]
    assert isinstance(leaf, MiniBlockReader) and leaf.proto.max_rep == 0
    return np.array([r[0] for r in leaf.meta["rep_index"]], np.int64)


def _rows(shape: str, starts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    if shape == "chunk ends":  # every chunk's first and last entry
        return np.unique(np.concatenate([starts, starts[1:] - 1, [N - 1]]))
    if shape == "unsorted":
        return rng.choice(N, 300, replace=False)
    if shape == "duplicates":
        rows = rng.integers(0, N, 200)
        return np.concatenate([rows, rows[::3], rows[:5]])
    return np.array([int(rng.integers(0, N))])  # one row


def _take(fb, rows, monkeypatch=None, **kw):
    """Values, the reader (for its IO), fallbacks and launches-by-wrapper of
    one take; with ``monkeypatch``, the device selection turned off."""
    calls = {"miniblock_decode": 0, "miniblock_take": 0}
    real = {n: getattr(ops, n) for n in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for n in calls:
            mp.setattr(ops, n, counting(n))
        if monkeypatch:
            mp.setattr(MiniBlockReader, "_take_kernel_params", lambda self, needed: None)
        ops.reset_counts()
        fr = FileReader(fb, device="cpu", **kw)
        got = fr.take("c", rows)
        return got, fr, dict(ops.fallbacks), calls


@pytest.mark.parametrize("shape", ["chunk ends", "unsorted", "duplicates", "one row"])
@pytest.mark.parametrize("kind", KINDS)
def test_device_selection_matches_select_numpy_and_reference(kind, shape):
    rng = np.random.default_rng(KINDS.index(kind))
    arr, codec = _column(kind, rng)
    fb = r_write_table({"c": arr}, r_opts("lance-miniblock", fixed_codec=codec))
    rows = _rows(shape, _boundaries(fb), rng)

    got, fr, fell, calls = _take(fb, rows, decode="device")
    assert calls == {"miniblock_decode": 1, "miniblock_take": 1}  # the decode: its CPU plain version
    assert fell == {}
    host, hfr, _, _ = _take(fb, rows, monkeypatch=True, decode="device")
    numpy, nfr, _, ncalls = _take(fb, rows, decode="numpy")
    assert ncalls == {"miniblock_decode": 0, "miniblock_take": 0}
    tracer = RTracer()
    want_reader = RFileReader(fb, decode="pallas", tracer=tracer)
    want = want_reader.take("c", rows)
    for other, reader in ((host, hfr), (numpy, nfr)):
        assert type(other) is type(got)
        np.testing.assert_array_equal(other.validity, got.validity)
        if hasattr(got, "children"):
            other, got_ = other.children[0][1], got.children[0][1]
            np.testing.assert_array_equal(other.validity, got_.validity)
            np.testing.assert_array_equal(other.values, got_.values)
        else:
            assert other.values.dtype == got.values.dtype
            np.testing.assert_array_equal(other.values, got.values)
        assert_same_io(reader, fr)
    assert_same_array(want, got)
    assert_same_io(want_reader, fr)
    assert tracer.metrics.counter_values("decode.fallback.") == {}


def _fields(words: np.ndarray, bitpos: int, bits: int) -> int:
    """The little-endian field at ``bitpos``, word indices clamped to the row."""
    last, bitpos = len(words) - 1, int(bitpos)
    w = bitpos // 32
    both = int(words[min(w, last)]) | int(words[min(w + 1, last)]) << 32
    return (both >> (bitpos % 32)) & ((1 << bits) - 1)


def _oracle(def_words, val_words, params, pairs, def_bits, vpe, fill):
    """``miniblock_take`` entry by entry in Python integers."""
    C = len(params)
    out = np.full((len(pairs), vpe + (1 if def_bits else 0)), fill, np.int64)
    for r, p in enumerate(pairs.tolist()):
        j, e = p >> 12, p & 4095
        if not (0 <= j < C and e < params[j, 0]):
            if def_bits:
                out[r, vpe] = -1
            continue
        d = _fields(def_words[j], e * def_bits, def_bits) if def_bits else 0
        slot = sum(_fields(def_words[j], i * def_bits, def_bits) == 0 for i in range(e)) \
            if def_bits else e
        if d == 0:
            for k in range(vpe):
                x = _fields(val_words[j], (slot * vpe + k) * int(params[j, 1]), int(params[j, 1]))
                out[r, k] = (x + int(params[j, 2]) + (1 << 31)) % (1 << 32) - (1 << 31)
        if def_bits:
            out[r, vpe] = d
    return out


_TAKES = [label for label, *_ in ref.miniblock_take_cases(np.random.default_rng(0))]


@pytest.mark.parametrize("index", range(len(_TAKES)), ids=_TAKES)
def test_plain_take_matches_an_entry_by_entry_oracle(index):
    """The sweep the kernel is held to on the card (``ref.miniblock_take_cases``):
    the plain version against Python integers."""
    label, case, kw = list(ref.miniblock_take_cases(np.random.default_rng(0)))[index]
    t = [torch.from_numpy(a) for a in case]
    got = ops.miniblock_take(*t, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _oracle(*case, **kw), err_msg=label)
    want = ref.miniblock_take_words_ref(*t, kw["def_bits"], kw["vpe"], kw["fill"])
    assert torch.equal(got, want), label


def test_wrapper_checks_what_the_kernel_takes():
    dw, vw, params, pairs = (torch.from_numpy(a) for a in ref.miniblock_take_case(
        np.random.default_rng(1), 1, 1, 2, 5, 256))
    with pytest.raises(TypeError):
        ops.miniblock_take(dw, vw, params, pairs.to(torch.int64), def_bits=1)
    with pytest.raises(ValueError):
        ops.miniblock_take(dw, vw[:1], params, pairs, def_bits=1)
    with pytest.raises(ValueError):
        ops.miniblock_take(dw, vw, params, pairs, def_bits=1, vpe=33)
    with pytest.raises(ValueError):
        ops.miniblock_take(dw, vw, params, pairs, def_bits=32)
    none = ops.miniblock_take(dw, vw, params, pairs[:0], def_bits=1, vpe=3)
    assert tuple(none.shape) == (0, 4)


@pytest.mark.parametrize("kind,decodes,fell", [
    ("nested-list", 1, {}),
    ("float-fsl", 0, {"decode.fallback.miniblock.float-values": 1})])
def test_nested_and_float_columns_keep_todays_path(kind, decodes, fell):
    """A list column (rows of many entries) still decodes whole chunks with
    ``miniblock_decode``; float values still decode on the host, counted."""
    rng = np.random.default_rng(5)
    fb = r_write_table({"c": make_array(kind, 3000, rng)}, r_opts("lance-miniblock"))
    rows = rng.integers(0, 3000, 97)
    got, fr, fallbacks, calls = _take(fb, rows, decode="device")
    assert calls == {"miniblock_decode": decodes, "miniblock_take": 0} and fallbacks == fell
    tracer = RTracer()
    want = RFileReader(fb, decode="pallas", tracer=tracer)
    assert_same_array(want.take("c", rows), got)
    assert_same_io(want, fr)
    assert tracer.metrics.counter_values("decode.fallback.") == fell


@pytest.mark.parametrize("wide,reason", [(np.int64(1) << 40, ">31-bit"),
                                         (np.int64((1 << 31) - 1), "ref-overflow")])
def test_a_chunk_the_kernels_cannot_read_keeps_the_whole_batch_on_todays_path(wide, reason):
    """One chunk of wide values (bitpack over 31 bits, or a bytepack FoR
    whose reference overflows int32) among narrow ones: a take that needs it
    decodes its batch whole and counts the fallback as the reference does;
    a take that does not selects on the device."""
    rng = np.random.default_rng(6)
    codec = "bytepack" if reason == "ref-overflow" else None
    v = rng.integers(0, 1 << 12, N).astype(np.int64)
    if codec:
        v += (1 << 31) - (1 << 17)  # eligible: ref + 2**16 - 1 stays below 2**31
    fb0 = r_write_table({"c": RA.PrimitiveArray.build(v, nullable=False)},
                        r_opts("lance-miniblock", fixed_codec=codec))
    starts = _boundaries(fb0)
    v[starts[-2]:] = wide - rng.integers(0, 1 << 20, N - starts[-2])  # the last chunks
    fb = r_write_table({"c": RA.PrimitiveArray.build(v, nullable=False)},
                       r_opts("lance-miniblock", fixed_codec=codec))
    for rows, wide_chunk in ((rng.integers(0, starts[-2], 50), False),
                             (np.array([5, starts[-2] + 7, N - 1, 5]), True)):
        got, fr, fell, calls = _take(fb, rows, decode="device")
        tracer = RTracer()
        want_reader = RFileReader(fb, decode="pallas", tracer=tracer)
        assert_same_array(want_reader.take("c", rows), got)
        assert_same_io(want_reader, fr)
        assert fell == tracer.metrics.counter_values("decode.fallback.")
        if wide_chunk:
            assert set(fell) == {f"decode.fallback.miniblock.{reason}"}
            assert calls == {"miniblock_decode": 1, "miniblock_take": 0}
        else:
            assert fell == {} and calls == {"miniblock_decode": 1, "miniblock_take": 1}


@pytest.mark.parametrize("decode", ["device", "numpy"])
def test_rows_selected_on_the_device_or_the_host_are_counted(decode):
    rng = np.random.default_rng(7)
    arr, _ = _column("nullable bits=14", rng)
    fb = r_write_table({"c": arr}, r_opts("lance-miniblock"))
    rows = np.array([3, 3, 900, 17, 19_999, 900])
    tr = Tracer(steps=True)
    fr = FileReader(fb, decode=decode, device="cpu", tracer=tr)
    fr.take("c", rows)
    fr.take("c", rows[:2])
    counts = tr.metrics.counter_values()
    unique = 4 + 1
    if decode == "device":
        assert counts["miniblock.rows_on_card"] == unique
        assert "miniblock.rows_on_host" not in counts
        assert tr.step_totals()["device.miniblock_take"][0] == 2
    else:
        assert counts["miniblock.rows_on_host"] == unique
        assert "miniblock.rows_on_card" not in counts
    assert tr.step_totals()["miniblock.select"][0] == 2
    # a reader with no tracer counts nothing outside a profiler
    FileReader(fb, decode=decode, device="cpu").take("c", rows)
    assert tr.metrics.counter_values() == counts
