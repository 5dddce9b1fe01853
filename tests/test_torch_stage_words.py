"""The mini-block reader's word rows, staged in bulk from the read buffer.

On the device route every chunk's stream becomes one zero-padded uint32 word
row of the kernels' input: ``_chunk_spans`` reads all chunks' headers at
once and ``_stack_words`` copies each stream straight from the buffer that
the IO returned.  Held here, tolerance 0: every array handed to
``ops.round_trip`` is the array the old rule builds (each chunk parsed by
``_parse_chunk``, each stream packed by ``ops.pack_words(buf, pad_words=1)``,
the rows stacked), in dtype, shape and bytes, for takes and scans of flat,
nullable, nested, fixed-size-list and FoR columns, a column whose batch
mixes covered chunks with fallbacks, ragged last chunks, single chunks and
repeated rows; and a covered read parses and packs nothing chunk by chunk.
"""

import numpy as np
import pytest

from repro_torch.core import arrays as A
from repro_torch.core import miniblock
from repro_torch.core import types as T
from repro_torch.core.file import FileReader, WriteOptions, write_table
from repro_torch.kernels import ops

from _torch_port import make_array, to_port

N = 20_000


def _wide_tail(rng):
    """Narrow ints whose last chunks hold 40-bit values: the kernels cannot
    read those chunks, so a batch holding them mixes both kinds."""
    v = rng.integers(0, 1 << 12, N).astype(np.int64)
    t = T.Primitive("int64", nullable=False)
    fb = write_table({"c": A.PrimitiveArray(t, np.ones(N, bool), v)},
                     WriteOptions("lance-miniblock"))
    meta = FileReader(fb, device="cpu")._leaf_readers("c")[0].meta
    v[meta["rep_index"][-2][0]:] += 1 << 40
    return A.PrimitiveArray(t, np.ones(N, bool), v), None


def _column(kind, rng):
    """A port array and the fixed codec it is written with."""
    if kind == "dates at 14 bits":
        return A.PrimitiveArray(T.Primitive("int32", nullable=False), np.ones(N, bool),
                                rng.integers(8000, 10600, N).astype(np.int32)), None
    if kind == "wide tail":
        return _wide_tail(rng)
    name, codec = {"nullable": ("nullable", None), "list<int>": ("nested-list", None),
                   "fixed-size-list": ("fixed-size-list", None),
                   "bytepack FoR": ("bytepack", "bytepack")}[kind]
    return to_port(make_array(name, N, rng)), codec


KINDS = ["dates at 14 bits", "nullable", "list<int>", "fixed-size-list", "bytepack FoR",
         "wide tail"]
READS = ["take many", "take one row", "scan"]


def _old_rule(mp):
    """Replace the bulk stager by the packer it replaced: each chunk parsed
    by ``_parse_chunk``, each stream packed by ``ops.pack_words``."""
    def spans(data, starts, n_slots):
        return [miniblock._parse_chunk(data[int(s):]) for s in starts]

    def stack(data, parsed, bi):
        if bi is None:
            return np.zeros((len(parsed), 1), dtype=np.uint32)
        rows = [ops.pack_words(bufs[bi], pad_words=1) for bufs in parsed]
        out = np.zeros((len(rows), max(len(r) for r in rows)), dtype=np.uint32)
        for j, r in enumerate(rows):
            out[j, : len(r)] = r
        return out

    mp.setattr(miniblock, "_chunk_spans", spans)
    mp.setattr(miniblock, "_stack_words", stack)


def _read(fb, read, rows, old):
    """The answer and each round trip's kernel and host arrays."""
    trips = []
    real = ops.round_trip

    def recording(kernel, host, *a, **kw):
        trips.append((kernel, [np.array(h, copy=True) for h in host]))
        return real(kernel, host, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "round_trip", recording)
        if old:
            _old_rule(mp)
        fr = FileReader(fb, decode="device", device="cpu")
        got = fr.scan("c") if read == "scan" else fr.take("c", rows)
    return got, trips


def _rows(read, rng):
    if read == "take one row":
        return np.array([int(rng.integers(0, N))])
    rows = rng.integers(0, N, 300)
    return np.concatenate([rows, rows[::4], [N - 1, N - 1]])  # repeats; the ragged last chunk


@pytest.mark.parametrize("read", READS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_inputs_equal_the_old_packers(kind, read):
    rng = np.random.default_rng(KINDS.index(kind))
    arr, codec = _column(kind, rng)
    fb = write_table({"c": arr}, WriteOptions("lance-miniblock", fixed_codec=codec))
    rows = _rows(read, rng)
    got, trips = _read(fb, read, rows, old=False)
    want, old_trips = _read(fb, read, rows, old=True)
    assert trips and [k for k, _ in trips] == [k for k, _ in old_trips]
    for (kernel, new), (_, old) in zip(trips, old_trips):
        assert len(new) == len(old), kernel
        for a, b in zip(new, old):
            assert (a.dtype, a.shape) == (b.dtype, b.shape), kernel
            assert a.tobytes() == b.tobytes(), kernel
    np.testing.assert_array_equal(got.validity, want.validity)


def test_the_wide_tail_stages_a_strict_subset():
    """The mixed column's scan stages every chunk but the fallbacks, and a
    take that needs a wide chunk stages the rest of its batch."""
    arr, _ = _wide_tail(np.random.default_rng(KINDS.index("wide tail")))
    fb = write_table({"c": arr}, WriteOptions("lance-miniblock"))
    for read, rows in (("scan", None), ("take", np.array([0, N - 1]))):
        _, trips = _read(fb, read, rows, old=False)
        ((kernel, host),) = trips
        n_chunks = len(FileReader(fb, device="cpu")._leaf_readers("c")[0].meta["chunks"])
        assert kernel == "miniblock_decode"
        staged = len(host[-1])
        assert 0 < staged < (n_chunks if read == "scan" else 2)


def test_a_covered_read_parses_and_packs_no_chunk_alone(monkeypatch):
    calls = {"parse": 0, "pack": 0}
    parse, pack = miniblock._parse_chunk, ops.pack_words

    def counting(name, real):
        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return call

    monkeypatch.setattr(miniblock, "_parse_chunk", counting("parse", parse))
    monkeypatch.setattr(ops, "pack_words", counting("pack", pack))
    for kind in ("dates at 14 bits", "list<int>"):
        arr, codec = _column(kind, np.random.default_rng(1))
        fb = write_table({"c": arr}, WriteOptions("lance-miniblock", fixed_codec=codec))
        fr = FileReader(fb, decode="device", device="cpu")
        fr.take("c", _rows("take many", np.random.default_rng(2)))
        fr.scan("c")
    assert calls == {"parse": 0, "pack": 0}


def test_spans_follow_the_parse_rule():
    """Buffers of every size mod 8 (and empty ones), at any start in the
    buffer: each span is where ``_parse_chunk`` slices."""
    rng = np.random.default_rng(4)
    chunks = [miniblock._serialize_chunk([bytes(rng.integers(0, 256, n, dtype=np.uint8))
                                          for n in sizes])
              for sizes in ([1, 0, 17], [8, 9, 3], [0, 0, 0], [15, 64, 7], [2, 3, 4, 5])]
    data = np.frombuffer(b"\x00" * 8 + b"".join(chunks), np.uint8)
    starts = 8 + np.cumsum([0] + [len(c) for c in chunks[:-1]])
    pos, sizes = miniblock._chunk_spans(data, starts, 3)
    assert pos.shape == sizes.shape == (len(chunks), 3)
    for c, s in enumerate(starts):
        bufs = miniblock._parse_chunk(data[s: s + len(chunks[c])])
        for i in range(3):
            assert sizes[c, i] == len(bufs[i])
            assert data[pos[c, i]: pos[c, i] + sizes[c, i]].tobytes() == bufs[i].tobytes()
        for bi in range(3):
            words = miniblock._stack_words(data, (pos, sizes), bi)[c]
            packed = ops.pack_words(bufs[bi], pad_words=1)
            assert not words[len(packed):].any()
            np.testing.assert_array_equal(words[: len(packed)], packed)


def test_a_header_with_too_few_buffers_is_refused():
    data = np.frombuffer(miniblock._serialize_chunk([b"\x01\x02", b"\x03"]), np.uint8)
    pos, sizes = miniblock._chunk_spans(data, np.array([0]), 2)
    assert sizes.tolist() == [[2, 1]]
    with pytest.raises(ValueError):
        miniblock._chunk_spans(data, np.array([0]), 3)
