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


# ---------------------------------------------------------------------------
# lockstep over whole packages (the serving-plane tests: obs, evloop, faults)
# ---------------------------------------------------------------------------

_LOCKSTEP_MODULES = ("core.io_sim", "obs", "store", "store.stats",
                     "serve.workload", "dataset")
# the entry points that take the port's ``device`` (CPU in the tests)
_DEVICE_ENTRY_POINTS = ("FileReader", "DatasetReader", "DatasetWriter",
                        "Retriever")


def package(root: str, **port_kw):
    """A flat namespace of one package's public names (io_sim, obs, store,
    the serve workload, dataset, the file API, ``A``/``T``), the entry points
    bound to ``port_kw``, and ``route``: the device decode route's name in
    this package (``"pallas"`` in the JAX package, ``"device"`` in the
    port)."""
    import functools
    import importlib
    import types

    ns = types.SimpleNamespace(name=root)
    for mod_name in _LOCKSTEP_MODULES:
        mod = importlib.import_module(f"{root}.{mod_name}")
        for k in getattr(mod, "__all__", None) or dir(mod):
            v = getattr(mod, k)
            if not k.startswith("__") and not isinstance(v, types.ModuleType):
                setattr(ns, k, v)
    file = importlib.import_module(f"{root}.core.file")
    ns.FileReader, ns.WriteOptions = file.FileReader, file.WriteOptions
    ns.write_table = file.write_table
    ns.Retriever = importlib.import_module(f"{root}.serve.engine").Retriever
    ns.A = importlib.import_module(f"{root}.core.arrays")
    ns.T = importlib.import_module(f"{root}.core.types")
    for k in _DEVICE_ENTRY_POINTS:
        setattr(ns, k, functools.partial(getattr(ns, k), **port_kw))
    ns.route = "device" if port_kw else "pallas"
    return ns


def snap(x):
    """A comparable form of what a case logs: dataclasses as (name, fields),
    numpy arrays and scalars as Python values, NaN as a string, recursively
    through lists, tuples and dicts."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                [snap(getattr(x, f.name)) for f in dataclasses.fields(x)])
    if isinstance(x, dict):
        return {snap(k): snap(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [snap(v) for v in x]
    if isinstance(x, np.ndarray):
        return snap(x.tolist())
    if isinstance(x, np.generic):
        return snap(x.item())
    if isinstance(x, float) and x != x:
        return "nan"
    return x


_ROUTE_NAMES = {"device": "pallas"}


def trace_shape(events):
    """Trace events without their wall-clock fields (``ts``, ``dur``): name,
    category, phase, track and args, with the port's decode-route name
    mapped to the reference's."""
    out = []
    for e in events:
        args = dict(e.get("args", {}))
        if "decode" in args:
            args["decode"] = _ROUTE_NAMES.get(args["decode"], args["decode"])
        out.append((e["name"], e.get("cat"), e["ph"], e["tid"], snap(args)))
    return out


def lockstep_packages(ref, port, case, *args):
    """Run ``case(m, log, *args)`` on the reference namespace and on the
    port's; each run's assertions must hold, and the logs must be identical
    (tolerance 0)."""
    logs = []
    for m in (ref, port):
        log = []
        case(m, log.append, *args)
        logs.append(snap(log))
    assert len(logs[0]) > 0
    assert logs[0] == logs[1]


def job_shape(job):
    """An event-loop job's serving metadata and its (phase, tier) units."""
    return (job.label, job.tenant, job.weight, job.request, job.n_requests,
            job.submit, job.seq, job.think,
            [(u.phase, u.tier, u.dev.name, u.ops, u.nbytes, u.pipe)
             for u in job.units])
