"""The three walk-parity properties of ``tests/test_decode_properties.py``
on the port (optional: they need ``hypothesis``).

The port's row-parallel full-zip decode must be bit-identical to its
sequential per-value walk (``FullZipReader._decode_entries_walk``), and the
port's walk to the reference's, over arbitrary rep/def/null/length shapes;
the port writes the same full-zip bytes.  utf8 values are compared as
bytes, never through ``to_pylist`` (invalid UTF-8 is a valid input here).
Tolerance 0.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import arrays as RA  # noqa: E402
from repro.core import types as RT  # noqa: E402
from repro.core.file import FileReader as RFileReader  # noqa: E402
from repro.core.file import write_table as r_write_table  # noqa: E402
from repro_torch.core import arrays as PA  # noqa: E402
from repro_torch.core.file import FileReader, WriteOptions, write_table  # noqa: E402

from _torch_port import assert_same_array, assert_same_io, buffers, r_opts, to_port  # noqa: E402

utf8_rows = st.lists(st.one_of(st.none(), st.binary(max_size=40)), min_size=1, max_size=120)
nested_rows = st.lists(
    st.one_of(st.none(), st.lists(st.one_of(st.none(), st.binary(max_size=24)), max_size=6)),
    min_size=1, max_size=80)


def _leaf_readers(rows, typ, bytes_codec=None):
    """The reference's and the port's readers over the same full-zip file
    (written by each package: the bytes must agree)."""
    arr = RA.from_pylist(rows, typ)
    fb = r_write_table({"c": arr}, r_opts("lance-fullzip", bytes_codec=bytes_codec))
    assert write_table({"c": to_port(arr)},
                       WriteOptions("lance-fullzip", bytes_codec=bytes_codec)) == fb
    want, got = RFileReader(fb), FileReader(fb, device="cpu")
    return arr, want, got


def _walk_eq_rowparallel(fr, reader, ref_reader):
    """The oracle check on the port: whole-payload decode, walk against
    chain discovery; and the port's walk against the reference's."""
    m = reader.meta
    raw = fr.disk.read(reader.base + m["zip_base"], m["zip_bytes"])
    rw, dw, vw = reader._decode_entries_walk(raw, n_hint=m["n_entries"])
    rp, dp, vp = reader._decode_entries(raw, n_hint=m["n_entries"])
    for a, b in ((rw, rp), (dw, dp)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert buffers(vw) == buffers(vp)
    want = ref_reader._decode_entries_walk(raw, n_hint=m["n_entries"])
    for a, b in zip(want[:2], (rw, dw)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert_same_array(want[2], vw)


@settings(max_examples=40, deadline=None)
@given(utf8_rows)
def test_flat_var_width_walk_parity(rows):
    _, want, got = _leaf_readers(rows, RT.Binary(True))
    _walk_eq_rowparallel(got, got._leaf_readers("c")[0], want._leaf_readers("c")[0])


@settings(max_examples=40, deadline=None)
@given(nested_rows, st.randoms(use_true_random=False))
def test_nested_var_width_walk_parity(rows, rnd):
    _, want, got = _leaf_readers(rows, RT.List(RT.Binary(True)))
    for r, rr in zip(got._leaf_readers("c"), want._leaf_readers("c")):
        _walk_eq_rowparallel(got, r, rr)
    scanned = got.scan("c")
    assert_same_array(want.scan("c"), scanned)
    assert PA.to_pylist(scanned) == rows
    chunk = rnd.randrange(8, 128)
    assert_same_array(want.scan("c", io_chunk=chunk), got.scan("c", io_chunk=chunk))
    take = np.array([rnd.randrange(len(rows)) for _ in range(min(16, 2 * len(rows)))],
                    dtype=np.int64)
    assert_same_array(want.take("c", take), got.take("c", take))
    assert_same_io(want, got)


@settings(max_examples=20, deadline=None)
@given(utf8_rows)
def test_var_width_fsst_walk_parity(rows):
    """fsst under the row-parallel decode, on utf8 values that need not be
    valid UTF-8: compared as bytes (the reference's own property decodes
    them with ``to_pylist``, which raises on invalid UTF-8)."""
    _, want, got = _leaf_readers(rows, RT.Utf8(True), bytes_codec="fsst_lite")
    _walk_eq_rowparallel(got, got._leaf_readers("c")[0], want._leaf_readers("c")[0])
    scanned = got.scan("c")
    assert_same_array(want.scan("c"), scanned)
    assert [bytes(scanned.data[lo:hi]) if ok else None for lo, hi, ok in
            zip(scanned.offsets[:-1], scanned.offsets[1:], scanned.validity)] == rows
