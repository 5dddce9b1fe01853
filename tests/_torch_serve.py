"""The serve bench's smoke run (``benchmarks/run.py`` ``serve_bench`` at
``SMOKE`` size, with the chaos bench's tenants), written once over a
namespace of one package's names so that the port's tests can drive it on
either package: 4 fragments of 1,000 rows of FixedSizeList<float32>[32]
(full-zip), a tiered store whose NVMe cache holds half the data, queue depth
32, 96 open-loop Zipf requests of 32 rows at 200 per virtual second, and an
ingest tenant appending 250 rows every 12 requests, committing every second
append.  Imports neither package itself."""

import numpy as np

N_FRAG, ROWS_PER, N_REQUESTS, WIDTH, QD = 4, 1_000, 96, 32, 32


class Recorder:
    """The writer as ``drive`` sees it, keeping each take's rows and values."""

    def __init__(self, writer):
        self.writer = writer
        self.scheduler = writer.scheduler
        self.takes = []

    def take(self, column, rows):
        out = self.writer.take(column, rows)
        self.takes.append((np.asarray(rows), out))
        return out

    def append(self, table, commit=True):
        return self.writer.append(table, commit=commit)


def _table(m, rng, n):
    vals = rng.standard_normal((n, WIDTH)).astype(np.float32)
    return {"c": m.A.FixedSizeListArray(
        m.T.FixedSizeList(m.T.Primitive("float32", nullable=False), WIDTH),
        np.ones(n, bool), vals)}


def serve_smoke(m, **writer_kw):
    """Drive the smoke run through ``m``'s writer (``writer_kw``: its decode
    route, device and tracer).  Returns the writer, the recorder, the
    interleaved and serial results, the window and the source tables."""
    rng = np.random.default_rng(7)
    tables = [_table(m, rng, ROWS_PER) for _ in range(N_FRAG)]
    seeds = [m.write_table(t, m.WriteOptions("lance-fullzip")) for t in tables]
    budget = max(int(0.5 * N_FRAG * ROWS_PER * WIDTH * 4), 1 << 18)
    w = m.DatasetWriter(
        files=seeds, store=lambda d: m.TieredStore.cached(d, cache_bytes=budget),
        flush="write-back", opts=m.WriteOptions("lance-fullzip"), queue_depth=QD,
        **writer_kw)
    tenants = [m.TenantSpec("premium", share=1.0, weight=4.0, priority=1,
                            rows_per_request=32),
               m.TenantSpec("standard", share=2.0, weight=1.0, rows_per_request=32)]
    wl = m.ZipfWorkload(n_rows=w.n_rows, tenants=tenants, n_requests=N_REQUESTS,
                        zipf_s=1.05, arrival_rate=200.0, seed=3)
    rec = Recorder(w)
    rng2 = np.random.default_rng(13)
    inter, serial, win = m.drive(
        rec, "c", wl.generate(), qos=wl.qos(),
        append_table=lambda: _table(m, rng2, ROWS_PER // 4),
        append_every=max(N_REQUESTS // 8, 1), commit_every=2)
    source = np.concatenate([t["c"].values for t in tables])
    return w, rec, inter, serial, win, source
