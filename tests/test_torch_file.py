"""The port's file format and FileReader against the JAX package's.

* ``write_table`` writes byte-identical files, and the port's msgpack
  subset writes byte-identical footers;
* ``FileReader(device="cpu", decode="device")`` reads files the JAX package
  wrote with the same take and scan values, logical IO, modelled time and
  fallback counts as its ``decode="pallas"`` route.

Tolerance 0 throughout.
"""

import math

import msgpack
import numpy as np
import pytest

from repro.core.file import FileReader as RFileReader
from repro.core.file import read_footer as r_read_footer
from repro.core.file import write_table as r_write_table
from repro.obs import Tracer
from repro_torch.core import msgpack_subset
from repro_torch.core.file import FileReader, WriteOptions, pack_meta, unpack_meta, write_table
from repro_torch.kernels import ops
from repro_torch.store import make_store

from _torch_port import (KINDS, LANCE_ENCODINGS, assert_same_array, assert_same_io,
                         make_array, messy_rows, r_opts, to_port)

WIDENED = [("bytepack", {"fixed_codec": "bytepack"}), ("struct-def2", {}),
           ("fixed-size-list", {}), ("nested-list", {})]


def _n(kind):
    # large enough that mini-block rows cross chunk boundaries for lists
    return 3000 if kind == "nested-list" else 600


def _written(kind, encoding, seed, **kw):
    rng = np.random.default_rng(seed)
    arr = make_array(kind, _n(kind), rng)
    return arr, r_write_table({"c": arr}, r_opts(encoding, **kw)), rng


def _mp_default(obj):
    from repro.core.file import _mp_default as r_default

    return r_default(obj)


@pytest.mark.parametrize("encoding", LANCE_ENCODINGS)
@pytest.mark.parametrize("kind", KINDS)
def test_write_table_is_byte_identical(encoding, kind):
    arr, want, _ = _written(kind, encoding, 1)
    assert write_table({"c": to_port(arr)}, WriteOptions(encoding)) == want
    # the footer codec alone: re-packing the parsed footer gives the bytes
    # msgpack gives, and both parse it to the same object
    meta, flen = r_read_footer(lambda o, s: want[o:o + s], len(want))
    footer = want[len(want) - 12 - flen: len(want) - 12]
    assert pack_meta(meta) == footer
    assert msgpack_subset.packb(meta, default=_mp_default) == \
        msgpack.packb(meta, default=_mp_default, use_bin_type=True)
    assert repr(unpack_meta(footer)) == repr(meta)


@pytest.mark.parametrize("kind,kw", WIDENED, ids=[w[0] for w in WIDENED])
def test_write_table_is_byte_identical_widened(kind, kw):
    rng = np.random.default_rng(2)
    arr = make_array(kind, 5000, rng)
    for decode, footer_decode in (("numpy", "numpy"), ("device", "pallas")):
        want = r_write_table({"c": arr}, r_opts("lance-miniblock", decode=footer_decode, **kw))
        got = write_table({"c": to_port(arr)},
                          WriteOptions("lance-miniblock", decode=decode, **kw))
        assert got == want


MSGPACK_CASES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    True, False, None, 0.0, -1.5, math.inf, 1e300,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, "e" * 70000,
    b"", b"x" * 255, b"y" * 256, b"z" * 65536,
    [], list(range(15)), list(range(16)), list(range(70000)), (1, (2, 3)),
    {}, {i: i for i in range(15)}, {str(i): [i] for i in range(16)},
    {i: None for i in range(70000)},
    {"nested": {"x": [1, {"y": b"\x00"}], 5: -5}},
    np.arange(7, dtype=np.int16), np.int64(-9), np.float64(0.25), np.bool_(True),
    {"__nd__": True, "d": "<u4", "s": [2], "b": b"\x01\x00\x00\x00\x02\x00\x00\x00"},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES, ids=range(len(MSGPACK_CASES)))
def test_msgpack_subset_matches_msgpack(obj):
    want = msgpack.packb(obj, default=_mp_default, use_bin_type=True)
    got = msgpack_subset.packb(obj, default=_mp_default)
    assert got == want
    assert repr(msgpack_subset.unpackb(want)) == \
        repr(msgpack.unpackb(want, raw=False, strict_map_key=False))


def test_msgpack_subset_rejects_what_it_cannot_write():
    with pytest.raises(TypeError):
        msgpack_subset.packb({1, 2})
    with pytest.raises(ValueError):
        msgpack_subset.unpackb(b"\x92\x01")  # truncated array
    with pytest.raises(ValueError):
        msgpack_subset.unpackb(b"\x01\x02")  # trailing bytes


def _fallbacks(tracer):
    return tracer.metrics.counter_values("decode.fallback.")


def _check_reader_parity(fb, rows, scan=True):
    tracer = Tracer()
    want = RFileReader(fb, decode="pallas", tracer=tracer)
    ops.reset_counts()
    got = FileReader(fb, decode="device", device="cpu")
    assert got.decode == "device"
    assert_same_array(want.take("c", rows), got.take("c", rows))
    if scan:
        assert_same_array(want.scan("c"), got.scan("c"))
    assert_same_io(want, got)
    assert ops.fallbacks == _fallbacks(tracer)
    assert ops.launches == {"miniblock_decode": 0, "fullzip_gather": 0,
                            "ivf_topk": 0, "bitunpack": 0,
                            "miniblock_take": 0}


@pytest.mark.parametrize("encoding", LANCE_ENCODINGS)
@pytest.mark.parametrize("kind", KINDS)
def test_reader_matches_reference_pallas_route(encoding, kind):
    arr, fb, rng = _written(kind, encoding, 3)
    _check_reader_parity(fb, messy_rows(len(arr), 41, rng))


@pytest.mark.parametrize("kind,kw", WIDENED + [("float-fsl", {})],
                         ids=[w[0] for w in WIDENED] + ["float-fsl"])
def test_reader_device_route_takes_the_kernel_path(kind, kw, monkeypatch):
    """Integer chunk shapes reach the decode kernel's wrapper (float values
    fall back, counted like the reference), and the result is the
    reference's."""
    rng = np.random.default_rng(4)
    arr = make_array(kind, 5000, rng)
    fb = r_write_table({"c": arr}, r_opts("lance-miniblock", **kw))
    calls = []
    real = ops.miniblock_decode
    monkeypatch.setattr(ops, "miniblock_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _check_reader_parity(fb, messy_rows(5000, 67, rng))
    assert (len(calls) > 0) == (kind != "float-fsl")
    if kind == "float-fsl":
        assert ops.fallbacks == {"decode.fallback.miniblock.float-values": 2}


@pytest.mark.parametrize("kind", ["primitive", "nullable", "fixed-size-list"])
def test_fullzip_gather_route_matches_reference(kind, monkeypatch):
    arr, fb, rng = _written(kind, "lance-fullzip", 5)
    calls = []
    real = ops.fullzip_gather
    monkeypatch.setattr(ops, "fullzip_gather",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _check_reader_parity(fb, messy_rows(len(arr), 53, rng), scan=False)
    assert len(calls) == 1


def test_variable_stride_fullzip_counts_its_fallback():
    arr, fb, rng = _written("utf8", "lance-fullzip", 6)
    _check_reader_parity(fb, np.array([7, 1, 7, 390, 1]))
    assert ops.fallbacks == {"decode.fallback.fullzip.variable-stride": 1}


@pytest.mark.parametrize("encoding", LANCE_ENCODINGS)
def test_numpy_route_matches_reference_and_reads_both_ways(encoding):
    """Files go both ways: the reference reads the port's bytes and the port
    reads the reference's, on the host route too."""
    rng = np.random.default_rng(7)
    arr = make_array("nested-list", 3000, rng)
    fb = write_table({"c": to_port(arr)}, WriteOptions(encoding))
    want, got = RFileReader(fb), FileReader(fb, device="cpu")
    assert got.decode == "numpy"
    rows = messy_rows(3000, 41, rng)
    assert_same_array(want.take("c", rows), got.take("c", rows))
    assert_same_array(want.scan("c", io_chunk=257), got.scan("c", io_chunk=257))
    assert_same_io(want, got)
    assert_same_array(arr, got.scan("c"))


def test_empty_and_out_of_range_takes():
    arr, fb, _ = _written("nullable", "lance-miniblock", 8)
    fr = FileReader(fb, decode="device", device="cpu")
    assert len(fr.take("c", np.zeros(0, np.int64))) == 0
    with pytest.raises(IndexError):
        fr.take("c", np.array([0, len(arr)]))
    with pytest.raises(IndexError):
        FileReader(_written("primitive", "lance-fullzip", 8)[1], device="cpu").take(
            "c", np.array([-1]))


def test_decode_knob():
    """The footer's "pallas" is the port's "device"; the port writes
    "pallas" for "device"; an explicit argument overrides the footer."""
    arr, fb, _ = _written("primitive", "lance-miniblock", 9, decode="pallas")
    assert FileReader(fb, device="cpu").decode == "device"
    assert FileReader(fb, device="cpu", decode="numpy").decode == "numpy"
    with pytest.raises(ValueError):
        FileReader(fb, device="cpu", decode="pallas")
    with pytest.raises(ValueError):
        WriteOptions("lance-miniblock", decode="gpu")
    port_fb = write_table({"c": to_port(arr)}, WriteOptions("lance-miniblock", decode="device"))
    assert RFileReader(port_fb).decode == "pallas"


@pytest.mark.parametrize("spec", ["tiered", "tiered-auto", "hot"])
def test_unported_store_specs_raise(spec):
    """The cached specs (the name is from when they raised): a cold take, a
    warm repeat, a readahead scan and a cold restart after ``drop_caches``
    price exactly as the reference's, tier by tier, on both decode routes."""
    arr, fb, rng = _written("nested-list", "lance", 12)
    rows = messy_rows(len(arr), 97, rng)
    for decode, r_decode in (("device", "pallas"), ("numpy", "numpy")):
        want = RFileReader(fb, store=spec, decode=r_decode)
        got = FileReader(fb, store=spec, decode=decode, device="cpu")
        assert len(got.store.levels) == len(want.store.levels) > 0
        assert got.store.levels[0].cache.admission == \
            ("auto" if spec == "tiered-auto" else "always")
        for step in ("cold", "warm", "scan", "dropped"):
            for r in (want, got):
                r.reset_io()
                if step == "dropped":
                    r.drop_caches()
            if step == "scan":
                assert_same_array(want.scan("c", io_chunk=4096),
                                  got.scan("c", io_chunk=4096))
            else:
                assert_same_array(want.take("c", rows), got.take("c", rows))
            assert_same_io(want, got)
            if step == "warm":
                assert got.tier_stats()[-1].n_iops == 0 and got.tier_stats()[0].hits > 0


def test_flat_s3_store_prices_like_the_reference():
    arr, fb, rng = _written("nullable", "lance", 10)
    want = RFileReader(fb, store="flat-s3")
    got = FileReader(fb, store="flat-s3", device="cpu")
    rows = messy_rows(len(arr), 41, rng)
    assert_same_array(want.take("c", rows), got.take("c", rows))
    assert_same_io(want, got)
    assert want.search_cache_bytes() == got.search_cache_bytes()
    assert want.data_bytes() == got.data_bytes()
