"""Serving example on the PyTorch/CUDA port: retrieval-augmented batched
generation.

The twin of ``examples/retrieval_serve.py`` on ``repro_torch``: the paper's
two access patterns in one loop.
 1. **vector search** — an IVF index trained over the embedding column and
    stored *as dataset fragments* (``repro_torch.dataset.IvfIndex``):
    centroids and posting lists live in the same global address space as
    the data, so index reads and data reads share ONE NVMe block cache and
    IO scheduler.  ``Retriever.search()`` probes centroids, batch-fetches
    posting lists, scores candidates with the ``ivf_topk`` kernel and takes
    the winners (``miniblock_decode`` decodes the posting lists,
    ``fullzip_gather`` fetches the rows), every step priced on the shared
    tiered store;
 2. **sequential decode** — batched generation with a prefill + KV-cache
    decode loop on a reduced model, through ``BatchedEngine``.

  PYTHONPATH=src python examples/retrieval_serve_torch.py [--device cuda|cpu]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.file import WriteOptions
from repro_torch.data import synth
from repro_torch.dataset import DatasetWriter, IvfIndex, write_fragments
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchedEngine, Retriever

N_DOCS = 5_000
N_FRAGMENTS = 4
N_PARTITIONS = 32
NPROBE = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels and the model run (default: cuda)")
    device = ops.resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    # 1. build the document store as a fragmented dataset: embeddings
    # (full-zip: fixed 2 KiB values), split across N_FRAGMENTS Lance files
    # behind one shared tiered store (NVMe block cache over S3), then train
    # the IVF index and commit it as fragments of the SAME address space.
    emb = synth.scenario("embeddings", N_DOCS)
    files = write_fragments({"embedding": emb}, N_FRAGMENTS, WriteOptions("lance"))
    writer = DatasetWriter(files=files, store="tiered", decode="device", device=device)
    index = IvfIndex.build(writer, "embedding", n_partitions=N_PARTITIONS,
                           n_fragments=2, seed=0)
    retriever = Retriever(writer.reader(), "embedding", index=index, decode="device")

    # real ANN queries: perturbed copies of stored docs — *global* row ids
    # come back from the index, spanning every fragment
    targets = rng.integers(0, N_DOCS, 4)
    queries = np.asarray(emb.values, np.float32)[targets] \
        + 0.05 * rng.standard_normal((4, 512)).astype(np.float32)
    writer.reset_io()
    res = retriever.search(queries, k=8, nprobe=NPROBE)
    stats = writer.io_stats()
    t_cold = retriever.modelled_time()
    print(f"[search] 4 queries x top-8 over {N_FRAGMENTS} fragments "
          f"({N_PARTITIONS} partitions, nprobe={NPROBE}) on {device}: "
          f"{res.n_candidates} candidates scored, {stats.n_iops} IOPS, "
          f"modelled time {t_cold*1e3:.2f} ms")
    print(f"[search] q0 neighbors: {res.ids[0].tolist()} (target {targets[0]})")
    # the repeat search is served by the shared NVMe cache — index reads
    # (centroids, postings) and data reads warm the same budget
    writer.reset_io()
    retriever.search(queries, k=8, nprobe=NPROBE)
    nvme, s3 = retriever.tier_stats()
    print(f"[search] warm repeat: nvme_hit_rate={nvme.hit_rate:.2f}, "
          f"s3_iops={s3.n_iops}, modelled {retriever.modelled_time()*1e3:.2f} ms")

    # 2. generate with the fetched context (reduced model, greedy decode)
    cfg = reduced_config("qwen2-72b")
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    engine = BatchedEngine(model, max_new=16, device=device)
    prompts = rng.integers(1, cfg.vocab, (4, 32)).astype(np.int32)
    out = engine.generate({"tokens": prompts}, n_new=16)
    print(f"[serve] generated {out.tokens.shape} tokens "
          f"(batch={out.tokens.shape[0]}, steps={out.steps})")
    print("[serve] sample:", out.tokens[0][:10])
    print(f"kernel launches: {ops.launches}; host fallbacks: {ops.fallbacks}")


if __name__ == "__main__":
    main()
