"""Quickstart on the PyTorch/CUDA port: the paper's core idea in 100 lines.

The twin of ``examples/quickstart.py`` on ``repro_torch``.  Writes one table
in four structural encodings, then compares random access IOPS / read
amplification / search-cache size (full-zip: <=2 IOPS & no cache; Arrow
List<String>: 5 IOPS in 3 dependent phases; Parquet: 1 IOP with page-size
amplification).  Lance takes decode on the device route (the
``miniblock_decode`` and ``fullzip_gather`` kernels); the baselines decode
on the host, as in the JAX package.  Then the ingest path: append
fragments to a live versioned dataset through the write-back store and
take freshly written rows back out, NVMe-warm.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse

import numpy as np

from repro_torch.core import FileReader, WriteOptions, write_table
from repro_torch.core.io_sim import NVME, model_time
from repro_torch.data import synth
from repro_torch.kernels import ops

N_ROWS = 4_000
TAKE = 64


def append_then_take(device):
    """Ingest: three appends -> three manifest versions, then random access
    over the committed dataset (served warm from the blocks the write path
    just filled)."""
    from repro_torch.dataset import DatasetWriter

    w = DatasetWriter(flush="write-back", opts=WriteOptions("lance"), decode="device",
                      device=device)
    for _ in range(3):
        w.append({"c": synth.paper_type("string", 1_000, seed=w.version)})
    rng = np.random.default_rng(0)
    rows = rng.choice(w.n_rows, TAKE, replace=False)
    w.reset_io()
    w.take("c", rows)
    st = w.io_stats()
    tiers = {s.name: s for s in w.tier_stats()}
    print(f"appended 3 fragments -> manifest v{w.version} "
          f"({w.n_rows} rows, dirty after commit: {w.dirty_bytes} B)")
    print(f"take {TAKE} fresh rows: {st.n_iops/TAKE:.2f} iops/row, "
          f"nvme hit-rate {tiers['nvme_970evo'].hit_rate:.2f}, "
          f"s3 reads {tiers['s3'].n_iops} (warm from the write path)")
    print(f"old versions stay readable: v1 has {w.reader(1).n_rows} rows\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the device decode routes run (default: cuda)")
    device = ops.resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    rows = rng.choice(N_ROWS, TAKE, replace=False)
    print(f"device: {device}")
    print(f"{'encoding':16s} {'type':12s} {'iops/row':>9s} {'read-amp':>9s} "
          f"{'phases':>7s} {'cache B':>9s} {'modelled rows/s':>16s}")
    for tname in ["string", "string-list", "vector"]:
        arr = synth.paper_type(tname, N_ROWS, seed=1)
        for enc, opts in [
            ("lance-adaptive", WriteOptions("lance")),
            ("lance-fullzip", WriteOptions("lance-fullzip")),
            ("parquet-8k", WriteOptions("parquet", page_bytes=8 * 1024)),
            ("arrow", WriteOptions("arrow")),
        ]:
            fr = FileReader(write_table({"c": arr}, opts), decode="device", device=device)
            fr.take("c", rows)  # warm nothing: takes are cold by design
            fr.reset_io()
            fr.take("c", rows)
            st = fr.io_stats()
            t = model_time(st, NVME)
            print(f"{enc:16s} {tname:12s} {st.n_iops/TAKE:9.2f} "
                  f"{st.read_amplification:9.1f} {st.max_phase:7d} "
                  f"{fr.search_cache_bytes():9d} {TAKE/t:16,.0f}")
        print()
    append_then_take(device)
    print(f"kernel launches: {ops.launches}; host fallbacks: {ops.fallbacks}")


if __name__ == "__main__":
    main()
