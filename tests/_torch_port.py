"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Data is made with numpy from a seed and built as JAX-package arrays; ``to_port``
rebuilds the same buffers as the port's arrays, so both packages see exactly
the same inputs.  ``assert_same_array`` compares an array of each package
buffer by buffer (utf8 as bytes, never through ``to_pylist``).
"""

import dataclasses

import numpy as np
from repro.core import arrays as RA, types as RT
from repro.core.file import WriteOptions as RWriteOptions
from repro.core.file import type_to_dict as r_type_to_dict
from repro_torch.core import arrays as PA
from repro_torch.core.file import type_from_dict as p_type_from_dict
from repro_torch.core.file import type_to_dict as p_type_to_dict

KINDS = ["primitive", "nullable", "utf8", "fixed-size-list", "nested-list"]
LANCE_ENCODINGS = ["lance", "lance-miniblock", "lance-fullzip"]


def make_array(kind: str, n: int, rng: np.random.Generator):
    """The shapes of tests/test_take_pipeline.py, as JAX-package arrays."""
    if kind == "primitive":
        return RA.PrimitiveArray.build(
            rng.integers(0, 1 << 20, n).astype(np.int64), nullable=False)
    if kind == "nullable":
        return RA.PrimitiveArray.build(
            rng.integers(0, 1 << 20, n).astype(np.int64),
            validity=rng.random(n) > 0.1)
    if kind == "utf8":
        vals = [None if rng.random() < 0.1 else
                bytes(rng.integers(97, 123, rng.integers(0, 12), dtype=np.uint8))
                for _ in range(n)]
        return RA.VarBinaryArray.build(vals, utf8=True)
    if kind == "fixed-size-list":
        return RA.FixedSizeListArray.build(
            rng.integers(0, 1 << 10, (n, 4)).astype(np.int32),
            validity=rng.random(n) > 0.1)
    if kind == "nested-list":
        py = []
        for _ in range(n):
            u = rng.random()
            if u < 0.1:
                py.append(None)
            elif u < 0.2:
                py.append([])
            else:
                py.append([None if rng.random() < 0.1 else int(v)
                           for v in rng.integers(0, 1 << 16, rng.integers(1, 6))])
        return RA.from_pylist(py, RT.List(RT.Primitive("int64", nullable=True)))
    if kind == "bytepack":
        return RA.PrimitiveArray.build(
            (rng.integers(0, 1 << 16, n) + 123_456).astype(np.int64),
            validity=rng.random(n) > 0.1)
    if kind == "struct-def2":
        inner = RA.PrimitiveArray.build(
            rng.integers(0, 1 << 12, n).astype(np.int64),
            validity=rng.random(n) > 0.15)
        return RA.StructArray.build([("f", inner)], validity=rng.random(n) > 0.1)
    if kind == "float-fsl":
        return RA.FixedSizeListArray.build(
            rng.standard_normal((n, 48)).astype(np.float32), nullable=False)
    raise ValueError(kind)


def messy_rows(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """Unsorted row ids with duplicates (and a reversed tail)."""
    rows = rng.integers(0, n, k)
    rows[: k // 4] = rows[k // 2: k // 2 + k // 4][::-1]
    return rows


def to_port(a):
    """The same buffers as a port array."""
    t = p_type_from_dict(r_type_to_dict(a.type))
    name = type(a).__name__
    if name == "PrimitiveArray":
        return PA.PrimitiveArray(t, a.validity.copy(), a.values.copy())
    if name == "FixedSizeListArray":
        return PA.FixedSizeListArray(t, a.validity.copy(), a.values.copy())
    if name == "VarBinaryArray":
        return PA.VarBinaryArray(t, a.validity.copy(), a.offsets.copy(),
                                 a.data.copy())
    if name == "ListArray":
        return PA.ListArray(t, a.validity.copy(), a.offsets.copy(),
                            to_port(a.child))
    if name == "StructArray":
        return PA.StructArray(t, a.validity.copy(),
                              tuple((n, to_port(c)) for n, c in a.children))
    raise TypeError(name)


def assert_same_array(want, got):
    """JAX-package array ``want`` and port array ``got`` hold the same
    type and the same buffers."""
    assert type(want).__name__ == type(got).__name__
    assert r_type_to_dict(want.type) == p_type_to_dict(got.type)
    np.testing.assert_array_equal(want.validity, got.validity)
    name = type(want).__name__
    if name == "VarBinaryArray":
        np.testing.assert_array_equal(want.offsets, got.offsets)
        assert want.data.tobytes() == got.data.tobytes()
    elif name == "ListArray":
        np.testing.assert_array_equal(want.offsets, got.offsets)
        assert_same_array(want.child, got.child)
    elif name == "StructArray":
        assert [n for n, _ in want.children] == [n for n, _ in got.children]
        for (_, cw), (_, cg) in zip(want.children, got.children):
            assert_same_array(cw, cg)
    else:
        assert want.values.dtype == got.values.dtype
        np.testing.assert_array_equal(want.values, got.values)


def assert_same_tiers(want, got):
    """Every tier's counters identical, field by field (hits, misses,
    evictions, prefetch, reads, writes, flushes, RMW, dirty and lost bytes,
    phases and archived drains): the two packages' TierStats share their
    fields and order."""
    wt, gt = want.tier_stats(), got.tier_stats()
    assert len(wt) == len(gt)
    for w, g in zip(wt, gt):
        assert dataclasses.astuple(w) == dataclasses.astuple(g), (w, g)


def assert_same_io(want_reader, got_reader):
    """Identical logical IO trace, every tier's stats and modelled time."""
    assert dataclasses.astuple(want_reader.io_stats()) == \
        dataclasses.astuple(got_reader.io_stats())
    assert_same_tiers(want_reader, got_reader)
    assert want_reader.modelled_time() == got_reader.modelled_time()


def r_opts(encoding: str, **kw) -> RWriteOptions:
    return RWriteOptions(encoding, **kw)


def assert_same_writer_io(want, got):
    """Identical read and write traces, per-tier read/write/flush/RMW/dirty/
    lost and cache counters, dirty bytes and modelled time of two dataset
    writers."""
    assert dataclasses.astuple(want.io_stats()) == dataclasses.astuple(got.io_stats())
    assert dataclasses.astuple(want.write_stats()) == \
        dataclasses.astuple(got.write_stats())
    assert_same_tiers(want, got)
    assert want.dirty_bytes == got.dirty_bytes
    assert want.modelled_time() == got.modelled_time()
