"""``Disk.read_gather``'s three routes against the JAX package's gather.

The route follows the span sizes alone (``io_sim.gather_route``): equal
sizes are one 2-D take of a strided view, long unequal spans are copied one
by one, many tiny unequal spans go through one int64 index a byte.  Every
route returns the reference's bytes and output offsets exactly, raises its
errors before any copy, and hands back an array the caller may write into;
``ReadBatch.read_many`` counts each call's spans under the route that
served it.
"""

import numpy as np
import pytest

from repro.core import io_sim as R
from repro_torch.core import arrays as A
from repro_torch.core import io_sim as P
from repro_torch.core import types as T
from repro_torch.core.file import FileReader, WriteOptions, write_table
from repro_torch.obs import Tracer

SIZE = 1 << 16


def payload(n=SIZE, seed=29):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def spans(kind, rng):
    """``(offsets, sizes)`` of one call, and the route it must take."""
    if kind == "equal 1 B":
        return rng.integers(0, SIZE, 300), np.ones(300, np.int64), "strided"
    if kind == "equal 3,073 B":
        return rng.integers(0, SIZE - 3073, 20), np.full(20, 3073), "strided"
    if kind == "equal, overlapping and repeated":
        offs = np.array([5, 5, 6, 0, SIZE - 64, 100])
        return offs, np.full(len(offs), 64), "strided"
    if kind == "one span":
        return np.array([SIZE - 7000]), np.array([7000]), "strided"
    if kind == "long unequal":
        sizes = rng.integers(6000, 8400, 12)
        return rng.integers(0, SIZE - 8400, 12), sizes, "sliced"
    if kind == "many tiny unequal":
        sizes = rng.integers(0, 40, 500)
        return rng.integers(0, SIZE - 40, 500), sizes, "indexed"
    if kind == "zero-size among long":
        sizes = np.array([4096, 0, 9000, 0, 300, 5000])
        return np.array([0, SIZE, 17, 3, SIZE - 300, 60_000]), sizes, "sliced"
    if kind == "zero-size among tiny":
        sizes = np.array([3, 0, 9, 0, 1, 0, 12])
        return np.array([0, SIZE, 17, 3, SIZE - 1, 0, 900]), sizes, "indexed"
    if kind == "all zero-size":
        return np.array([0, 9, SIZE]), np.zeros(3, np.int64), "strided"
    raise ValueError(kind)


KINDS = ["equal 1 B", "equal 3,073 B", "equal, overlapping and repeated", "one span",
         "long unequal", "many tiny unequal", "zero-size among long", "zero-size among tiny",
         "all zero-size"]


def assert_same_gather(got, want):
    (data, offs), (rdata, roffs) = got, want
    assert data.dtype == rdata.dtype == np.uint8 and data.ndim == 1
    np.testing.assert_array_equal(data, rdata)
    assert offs.dtype == roffs.dtype and np.array_equal(offs, roffs)


@pytest.mark.parametrize("kind", KINDS)
def test_each_route_returns_the_reference_bytes(kind):
    rng = np.random.default_rng(len(kind))
    offsets, sizes, route = spans(kind, rng)
    assert P.gather_route(sizes) == route
    mem = payload()
    got = P.Disk(mem.copy()).read_gather(offsets, sizes)
    assert_same_gather(got, R.Disk(mem.copy()).read_gather(offsets, sizes))
    # lists in, as the callers that pass them
    assert_same_gather(P.Disk(mem.copy()).read_gather(list(offsets), list(sizes)), got)


def test_an_empty_call_returns_nothing():
    mem = payload()
    for offsets, sizes in (([], []), (np.zeros(0, np.int64), np.zeros(0, np.int64))):
        got = P.Disk(mem).read_gather(offsets, sizes)
        assert_same_gather(got, R.Disk(mem).read_gather(offsets, sizes))
        assert got[1].tolist() == [0]


@pytest.mark.parametrize("kind", ["equal 3,073 B", "long unequal", "many tiny unequal"])
def test_a_grown_disk_reads_only_its_size(kind):
    """After ``grow`` the backing array is larger than the disk: a span that
    ends in the spare capacity is out of bounds on every route."""
    mem = payload(40_000)
    disks = []
    for m in (P, R):
        d = m.Disk(mem.copy())
        d.grow(SIZE - 40_000)
        d.write(SIZE - 9, b"\x07" * 9)
        disks.append(d)
    got_disk, want_disk = disks
    assert len(got_disk._mem) > len(got_disk) == len(want_disk) == SIZE
    offsets, sizes, route = spans(kind, np.random.default_rng(3))
    offsets = np.minimum(offsets, SIZE - sizes)  # the last span ends at the end
    offsets[-1] = SIZE - sizes[-1]
    assert_same_gather(got_disk.read_gather(offsets, sizes),
                       want_disk.read_gather(offsets, sizes))
    for disk in disks:
        with pytest.raises(ValueError):
            disk.read_gather(offsets + 1, sizes)


@pytest.mark.parametrize("kind", ["equal 3,073 B", "long unequal", "many tiny unequal"])
def test_a_view_reads_through_its_base(kind):
    mem = payload(SIZE + 1000)
    base = 777
    got_view = P.DiskView(P.Disk(mem.copy()), base, SIZE)
    want_view = R.DiskView(R.Disk(mem.copy()), base, SIZE)
    offsets, sizes, _ = spans(kind, np.random.default_rng(4))
    assert not got_view.file_backed
    assert_same_gather(got_view.read_gather(offsets, sizes),
                       want_view.read_gather(offsets, sizes))
    for view in (got_view, want_view):
        with pytest.raises(ValueError):
            view.read_gather([SIZE - 2], [3])


@pytest.mark.parametrize("kind", ["equal 3,073 B", "long unequal", "many tiny unequal",
                                  "zero-size among tiny"])
def test_a_file_backed_disk_reads_span_by_span(tmp_path, kind):
    mem = payload()
    path = tmp_path / "blob.bin"
    path.write_bytes(mem.tobytes())
    disk = P.Disk(path=str(path))
    assert disk.file_backed and P.gather_route([4, 4], disk.file_backed) == "sliced"
    offsets, sizes, _ = spans(kind, np.random.default_rng(5))
    assert_same_gather(disk.read_gather(offsets, sizes),
                       R.Disk(path=str(path)).read_gather(offsets, sizes))
    assert_same_gather(disk.read_gather(offsets, sizes),
                       P.Disk(mem).read_gather(offsets, sizes))


@pytest.mark.parametrize("kind", ["equal 3,073 B", "long unequal", "many tiny unequal"])
@pytest.mark.parametrize("bad", ["past the end", "negative offset", "negative size"])
def test_bad_spans_raise_before_any_copy(kind, bad):
    offsets, sizes, _ = spans(kind, np.random.default_rng(6))
    offsets, sizes = offsets.copy(), sizes.copy()
    if bad == "past the end":
        offsets[-1] = SIZE - sizes[-1] + 1
    elif bad == "negative offset":
        offsets[0] = -1
    else:
        sizes[0] = -1
    for m in (P, R):
        with pytest.raises(ValueError):
            m.Disk(payload()).read_gather(offsets, sizes)


@pytest.mark.parametrize("kind", ["equal 1 B", "equal 3,073 B", "one span", "long unequal",
                                  "many tiny unequal"])
def test_writing_into_the_result_leaves_the_disk_unchanged(kind):
    mem = payload()
    disk = P.Disk(mem.copy())
    offsets, sizes, _ = spans(kind, np.random.default_rng(7))
    data, _ = disk.read_gather(offsets, sizes)
    assert data.flags.writeable
    data[:] = ~data
    np.testing.assert_array_equal(disk.read(0, SIZE), mem)
    assert_same_gather(disk.read_gather(offsets, sizes),
                       R.Disk(mem).read_gather(offsets, sizes))


def test_the_route_follows_the_mean_span_size():
    cut = P.GATHER_SLICE_MIN_BYTES
    assert P.gather_route([cut - 1, cut + 1]) == "sliced"
    assert P.gather_route([cut - 2, cut]) == "indexed"
    assert P.gather_route([cut] * 5) == "strided"
    assert P.gather_route([]) == "strided"


def gather_counts(tracer):
    return tracer.metrics.counter_values("store.gather_spans.")


def test_a_fixed_stride_full_zip_take_gathers_strided():
    rng = np.random.default_rng(8)
    n = 600
    t = T.FixedSizeList(T.Primitive("float32", nullable=False), 256, nullable=True)
    col = A.FixedSizeListArray(t, rng.random(n) > 0.1,
                               rng.standard_normal((n, 256)).astype(np.float32))
    fb = write_table({"c": col}, WriteOptions("lance", decode="device"))
    tr = Tracer(steps=True)
    rows = rng.choice(n, 64, replace=False)
    FileReader(fb, device="cpu", tracer=tr).take("c", rows)
    assert gather_counts(tr) == {"store.gather_spans.strided": 64}
    steps = [e for e in tr.events if e["name"] == "store.gather"]
    assert [e["args"] for e in steps] == [{"n_spans": 64, "route": "strided"}]


def test_a_flat_mini_block_take_gathers_sliced():
    rng = np.random.default_rng(9)
    n = 50_000
    col = A.PrimitiveArray(T.Primitive("int32", nullable=False), np.ones(n, bool),
                           rng.integers(8000, 10600, n).astype(np.int32))
    fb = write_table({"c": col}, WriteOptions("lance", decode="device"))
    tr = Tracer(steps=True)
    # the last row's chunk is short: the chunks' sizes are unequal
    rows = np.concatenate([rng.choice(n - 1, 40, replace=False), [n - 1]])
    reader = FileReader(fb, device="cpu", tracer=tr)
    got = reader.take("c", rows)
    np.testing.assert_array_equal(got.values, col.values[rows])
    counts = gather_counts(tr)
    assert set(counts) == {"store.gather_spans.sliced"} and counts["store.gather_spans.sliced"] > 1
    assert counts["store.gather_spans.sliced"] == tr.metrics.counter_values()["miniblock.chunks"]
    # a reader with no tracer counts nothing outside a profiler
    FileReader(fb, device="cpu").take("c", rows)
    assert gather_counts(tr) == counts
