"""The port's IVF search path against the JAX package's: ``kmeans``,
``IvfIndex`` (an index stored as fragments of an attached writer) and
``Retriever.search`` on the flat store.

k-means centroids and labels, index centroids and posting lists, winner ids,
probes and winner rows are identical to the reference's; the logical IO,
write trace, per-tier counters and modelled time are identical; distances
agree within 1e-6 of the size of the expanded form's terms (see
``assert_distances_close``).  Queries are perturbed copies of stored
vectors, as the repo's search benchmark makes them.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import arrays as RA
from repro.core.file import WriteOptions as RWriteOptions
from repro.dataset import DatasetWriter as RDatasetWriter
from repro.dataset import IvfIndex as RIvfIndex
from repro.dataset import kmeans as r_kmeans
from repro.dataset import write_fragments as r_write_fragments
from repro.serve.engine import Retriever as RRetriever
from repro_torch.dataset import DatasetWriter, IvfIndex, kmeans
from repro_torch.kernels import ops
from repro_torch.serve import Retriever
from repro_torch.serve.engine import BatchedEngine

from _torch_port import assert_same_array, assert_same_writer_io


def assert_distances_close(got, want, queries, vecs):
    """Padding (inf) at the same places; elsewhere |got - want| <= 1e-6 *
    (|want| + |q|^2 + max |c|^2).  The expanded form (qq - 2 q.c) + cc
    rounds at the scale of its terms, so a query next to a stored vector
    (distance near 0) differs by an ulp of qq + cc between summation orders,
    not by an ulp of the distance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    scale = (queries.astype(np.float64) ** 2).sum(1)[:, None] + \
        (vecs.astype(np.float64) ** 2).sum(1).max()
    fin = np.isfinite(want)
    err = np.abs(got.astype(np.float64) - want)
    assert (err[fin] <= 1e-6 * (np.abs(want) + scale)[fin]).all(), err.max()


def _data(n_rows, dim, seed):
    return np.random.default_rng(seed).standard_normal((n_rows, dim)).astype(np.float32)


def _queries(vecs, nq, seed):
    rng = np.random.default_rng(seed + 1)
    return vecs[rng.integers(0, len(vecs), nq)] + \
        0.05 * rng.standard_normal((nq, vecs.shape[1])).astype(np.float32)


def _build(vecs, n_partitions, seed, n_fragments=3, decode=None, ref_decode=None):
    """The same dataset and index in both packages: (reference writer,
    index, port writer, index)."""
    files = r_write_fragments({"emb": RA.FixedSizeListArray.build(vecs)},
                              n_fragments, RWriteOptions("lance"))
    rw = RDatasetWriter(files=files, store="flat", flush=None, decode=ref_decode)
    pw = DatasetWriter(files=files, store="flat", flush=None, decode=decode,
                       device="cpu")
    rivf = RIvfIndex.build(rw, "emb", n_partitions=n_partitions, n_fragments=2,
                           seed=seed)
    pivf = IvfIndex.build(pw, "emb", n_partitions=n_partitions, n_fragments=2,
                          seed=seed)
    return rw, rivf, pw, pivf


def _assert_same_search(a, b, q, vecs):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.probes, b.probes)
    np.testing.assert_array_equal(a.winner_rows, b.winner_rows)
    assert a.n_candidates == b.n_candidates
    assert b.ids.dtype == np.int64 and b.probes.dtype == np.int64
    assert_distances_close(b.distances, a.distances, q, vecs)
    if a.values is None:
        assert b.values is None
    else:
        assert_same_array(a.values, b.values)


@pytest.mark.parametrize("n,dim,p,seed", [(200, 8, 2, 0), (317, 24, 5, 1),
                                          (64, 3, 6, 2), (500, 16, 4, 3)])
def test_kmeans_is_bit_identical(n, dim, p, seed):
    vecs = _data(n, dim, seed)
    for iters in (1, 8):
        rc, rl = r_kmeans(vecs, p, iters, seed)
        pc, pl = kmeans(vecs, p, iters, seed)
        np.testing.assert_array_equal(rc, pc)
        np.testing.assert_array_equal(rl, pl)
    with pytest.raises(ValueError):
        kmeans(vecs, n + 1)


@pytest.mark.parametrize("n_partitions", [2, 5, 6])
def test_index_is_identical_to_the_reference(n_partitions):
    vecs = _data(240, 12, n_partitions)
    rw, rivf, pw, pivf = _build(vecs, n_partitions, seed=7)
    assert (pivf.n_partitions, pivf.dim, pivf.column) == \
        (rivf.n_partitions, rivf.dim, rivf.column)
    np.testing.assert_array_equal(rivf.centroids(), pivf.centroids())
    parts = np.arange(n_partitions)[::-1]
    for a, b in zip(rivf.postings(parts), pivf.postings(parts)):
        np.testing.assert_array_equal(a, b)
    assert [(f.base, f.nbytes, f.n_rows) for f in rivf.writer.fragments] == \
        [(f.base, f.nbytes, f.n_rows) for f in pivf.writer.fragments]
    assert_same_writer_io(rw, pw)


@pytest.mark.parametrize("n,dim,p,k,nq,nprobe", [
    (300, 16, 4, 5, 4, 2), (180, 24, 6, 8, 1, 3), (400, 8, 3, 1, 5, 1),
    (120, 10, 2, 8, 3, 2), (260, 20, 5, 3, 2, 5)])
def test_search_matches_both_reference_routes(n, dim, p, k, nq, nprobe):
    vecs = _data(n, dim, n + dim)
    q = _queries(vecs, nq, n)
    got = {}
    for route in ("device", "numpy"):
        ops.reset_counts()
        rw, rivf, pw, pivf = _build(vecs, p, seed=dim, decode=route,
                                    ref_decode="numpy" if route == "numpy" else None)
        want_r = RRetriever(rw.reader(), "emb", index=rivf, decode=route if
                            route == "numpy" else None)
        got_r = Retriever(pw.reader(), "emb", index=pivf, decode=route)
        rw.reset_io()
        pw.reset_io()
        a, b = want_r.search(q, k=k, nprobe=nprobe), got_r.search(q, k=k, nprobe=nprobe)
        _assert_same_search(a, b, q, vecs)
        assert b.ids.shape == b.distances.shape == (nq, k)
        assert_same_writer_io(rw, pw)
        assert rw.scheduler.ops == pw.scheduler.ops
        assert not [f for f in ops.fallbacks if f.startswith("decode.fallback.ivf.")]
        assert set(ops.launches.values()) == {0}
        got[route] = b
    # the routes agree with each other exactly: same plain versions on the CPU
    np.testing.assert_array_equal(got["device"].ids, got["numpy"].ids)
    np.testing.assert_array_equal(got["device"].distances, got["numpy"].distances)


@pytest.mark.parametrize("n,p,nprobe,seed", [(140, 3, 1, 0), (90, 7, 3, 1), (120, 5, 2, 2)])
def test_search_invariant_under_index_compact_and_versions(n, p, nprobe, seed):
    vecs = _data(n, 12, seed)
    q = vecs[np.random.default_rng(seed + 2).integers(0, n, 3)]
    rw, rivf, pw, pivf = _build(vecs, p, seed)
    want_r = RRetriever(rw.reader(), "emb", index=rivf, decode="numpy")
    got_r = Retriever(pw.reader(), "emb", index=pivf, decode="device")
    before = got_r.search(q, k=5, nprobe=nprobe)
    _assert_same_search(want_r.search(q, k=5, nprobe=nprobe), before, q, vecs)
    v1 = pivf.writer.version
    rivf.compact()
    pivf.compact()
    assert pivf.writer.version == rivf.writer.version > v1
    after = got_r.search(q, k=5, nprobe=nprobe)
    _assert_same_search(want_r.search(q, k=5, nprobe=nprobe), after, q, vecs)
    np.testing.assert_array_equal(before.ids, after.ids)
    np.testing.assert_array_equal(before.distances, after.distances)
    np.testing.assert_array_equal(before.probes, after.probes)
    old = got_r.search(q, k=5, nprobe=nprobe, index_version=v1)
    _assert_same_search(want_r.search(q, k=5, nprobe=nprobe, index_version=v1),
                        old, q, vecs)
    np.testing.assert_array_equal(before.ids, old.ids)
    assert_same_writer_io(rw, pw)


@pytest.mark.parametrize("n,dim,p,k,nq,seed", [(150, 4, 2, 8, 5, 0), (90, 24, 6, 3, 2, 1),
                                               (200, 12, 4, 6, 4, 2)])
def test_recall_is_exact_when_probing_every_partition(n, dim, p, k, nq, seed):
    vecs = _data(n, dim, seed)
    q = _queries(vecs, nq, seed)
    _, _, pw, pivf = _build(vecs, p, seed)
    res = Retriever(pw.reader(), "emb", index=pivf, decode="device").search(
        q, k=k, nprobe=p)
    d64 = ((vecs[None].astype(np.float64) - q[:, None].astype(np.float64)) ** 2).sum(-1)
    top = np.argsort(d64, axis=1, kind="stable")[:, :k]
    hits = 0
    for i in range(nq):
        kth = d64[i, top[i, -1]]
        for rid in res.ids[i]:
            # in the exact top-k, or tied with the k-th within f32 noise
            hits += rid in top[i] or d64[i, rid] <= kth * (1 + 1e-5) + 1e-7
    assert hits == nq * k


def test_fetch_single_query_and_no_fetch_match_the_reference():
    vecs = _data(160, 8, 5)
    rw, rivf, pw, pivf = _build(vecs, 4, 5)
    want_r = RRetriever(rw.reader(), "emb", index=rivf, decode="numpy")
    got_r = Retriever(pw.reader(), "emb", index=pivf, decode="device")
    q = _queries(vecs, 1, 9)
    _assert_same_search(want_r.search(q[0], k=4, nprobe=2, fetch=False),
                        got_r.search(q[0], k=4, nprobe=2, fetch=False), q, vecs)
    rows = np.array([3, 159, 3, 77])
    (va, sa), (vb, sb) = want_r.fetch(rows), got_r.fetch(rows)
    assert_same_array(va, vb)
    assert dataclasses.astuple(sa) == dataclasses.astuple(sb)
    assert_same_writer_io(rw, pw)
    assert [dataclasses.astuple(t)[:3] for t in want_r.tier_stats()] == \
        [dataclasses.astuple(t)[:3] for t in got_r.tier_stats()]
    assert want_r.modelled_time() == got_r.modelled_time()


def test_retriever_over_files_and_its_refusals():
    vecs = _data(60, 8, 6)
    files = r_write_fragments({"emb": RA.FixedSizeListArray.build(vecs)}, 2,
                              RWriteOptions("lance"))
    rows = np.array([0, 59, 31])
    want = RRetriever(files, "emb", store="flat", decode="numpy")
    for decode in (None, "device", "pallas", "numpy"):
        got = Retriever(files, "emb", store="flat", decode=decode, device="cpu")
        assert_same_array(want.fetch(rows)[0], got.fetch(rows)[0])
    got = Retriever(files[0], "emb", decode="pallas", device="cpu")
    assert got.reader.decode == "device"
    with pytest.raises(ValueError):
        Retriever(files, "emb", decode="jnp", device="cpu")
    with pytest.raises(ValueError):
        Retriever(got.reader, "emb", device="cpu")
    with pytest.raises(ValueError, match="no index"):
        got.search(vecs[0])
    # the engine beside the retriever is ported now (ROADMAP.md, item 8a)
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    model = build_model(reduced_config("smollm-360m"), device="cpu")
    out = BatchedEngine(model, device="cpu").generate({"tokens": np.ones((1, 4), np.int32)},
                                                      n_new=2)
    assert out.tokens.shape == (1, 2) and out.steps == 2
