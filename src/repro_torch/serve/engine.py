"""Batched serving engine: prefill + decode over a language model, plus the
random-access retrieval path (the paper's ``take``) for embedding and
document fetch, and IVF search over an index stored as dataset fragments.

The port's copy of the reference's ``serve/engine.py``.  Generation runs
under ``torch.inference_mode()``, eagerly (no ``torch.compile``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.file import FileReader
from ..kernels import ops
from ..obs import NULL_TRACER

__all__ = ["BatchedEngine", "GenResult", "Retriever", "SearchResult"]

_ROUTES = (None, "device", "pallas", "numpy")


@dataclasses.dataclass
class SearchResult:
    """One batched IVF search: per-query winners plus the one batched take
    that materialized them.

    ``ids``/``distances`` are (Q, k); a query with fewer than ``k``
    eligible candidates pads with ``id = -1`` / ``distance = inf``.
    ``winner_rows`` is the deduplicated ascending union of valid ids —
    the row set the winner ``take`` fetched; ``values`` is that take's
    result, aligned with ``winner_rows`` (``None`` when ``fetch=False``).
    """

    ids: np.ndarray          # (Q, k) int64 global row ids, -1 at padding
    distances: np.ndarray    # (Q, k) float32 squared L2, inf at padding
    probes: np.ndarray       # (Q, nprobe) probed partition ids
    winner_rows: np.ndarray  # unique valid ids, ascending
    values: Optional[object] = None
    n_candidates: int = 0    # posting entries scored across probed parts


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray  # (B, n_gen)
    steps: int


class BatchedEngine:
    """Static-batch generate: prefill once, decode N steps with a cache
    preallocated to capacity (prompt + n_new + 8, the reference's padding),
    written in place by each step.  ``device`` is CUDA unless the caller
    names the CPU (raises without a card) and must be the model's."""

    def __init__(self, model, max_new: int = 32, device=None):
        self.device = ops.resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        self.model = model
        self.max_new = max_new

    def _capacity(self, prompt_len: int, n_new: int) -> int:
        """The reference's ``_pad_cache(cache, n_new + 8)``, as a capacity
        the prefill preallocates for every family (ssm states need none)."""
        return prompt_len + n_new + 8

    @torch.inference_mode()
    def generate(self, batch: Dict, n_new: Optional[int] = None,
                 greedy: bool = True) -> GenResult:
        """Greedy decoding of ``n_new`` (default ``max_new``) tokens.
        ``greedy`` is the reference's keyword, which decodes greedily
        either way."""
        n_new = n_new or self.max_new
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        batch = {**batch, "tokens": tokens}
        logits, cache = self.model.prefill(
            batch, capacity=self._capacity(tokens.shape[1], n_new))
        toks = []
        cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for _ in range(n_new):
            toks.append(cur)
            logits, cache = self.model.decode_step(cache, cur)
            cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
        return GenResult(torch.cat(toks, dim=1).cpu().numpy(), n_new)


class Retriever:
    """Random-access retrieval over a Lance file *or dataset*: the
    search-path consumer (§1: 'search workloads fetch small subsets not
    aligned with the clustered index').

    ``source`` is one Lance file (bytes), a list of fragment files (served
    through :class:`repro_torch.dataset.DatasetReader`), or a ready
    ``FileReader``/``DatasetReader``.  ``store`` selects the tier stack
    (see :func:`repro_torch.store.make_store`): ``"tiered"`` serves repeat
    fetches from the NVMe cache instead of S3.

    ``decode`` selects the kernel route of both the file decode and the
    search's distance/top-k: ``None``, ``"device"`` and ``"pallas"`` (the
    reference's name) run the CUDA kernels on the reader's device
    (``device``, CUDA unless ``"cpu"``, where their plain versions run);
    ``"numpy"`` runs the plain versions on the host.
    """

    def __init__(self, source, column: str = "embedding", store=None,
                 index=None, decode: Optional[str] = None, device=None):
        if decode not in _ROUTES:
            raise ValueError(f"decode must be one of {_ROUTES}, got {decode!r}")
        file_decode = "device" if decode == "pallas" else decode
        if isinstance(source, (list, tuple)):
            from ..dataset import DatasetReader

            self.reader = DatasetReader(list(source), store=store,
                                        decode=file_decode, device=device)
        elif isinstance(source, (bytes, bytearray)):
            self.reader = FileReader(source, store=store, decode=file_decode,
                                     device=device)
        else:
            if store is not None or device is not None:
                raise ValueError("store and device are fixed by a ready reader")
            self.reader = source
        self.column = column
        # ``index``: an IvfIndex whose attached writer shares this reader's
        # scheduler/store — :meth:`search` turns queries into row ids.
        self.index = index
        self.decode = decode

    def fetch(self, row_ids: np.ndarray):
        """take() — at most 2 IOPS/row via full-zip (§4.1.4).  Row ids are
        global over the dataset when serving from fragments."""
        self.reader.reset_io()
        out = self.reader.take(self.column, np.asarray(row_ids, np.int64))
        return out, self.reader.io_stats()

    def search(self, query, k: int = 10, nprobe: int = 4,
               fetch: bool = True, index_version: Optional[int] = None,
               ) -> SearchResult:
        """IVF search: probe partitions → batched posting-list fetch →
        distance/top-k kernel → one batched ``take`` of the winners.

        Every IO lands on the retriever's shared scheduler/store — index
        reads (centroids, posting lists) and data reads (candidate vectors,
        winner rows).  Accepts one query ``(D,)`` or a batch ``(Q, D)``;
        multi-query batches score one shared candidate matrix under a
        per-query partition mask, so each query still sees exactly its own
        ``nprobe`` probes.  Deterministic end to end: k-means is seeded and
        ties break toward the lowest row id.
        """
        if self.index is None:
            raise ValueError(
                "no index attached — IvfIndex.build(writer, column) first")
        q = np.atleast_2d(np.asarray(query, np.float32))
        nq = q.shape[0]
        p = self.index.n_partitions
        k = int(k)
        nprobe = min(max(1, int(nprobe)), p)
        dev = torch.device("cpu") if self.decode == "numpy" \
            else self.reader.device
        tracer = getattr(self.reader, "tracer", NULL_TRACER)
        # the host route reports no kernel fallback to the tracer, as the
        # reference's jnp oracle route does not
        kernel_tracer = None if self.decode == "numpy" else tracer
        with tracer.span("search", cat="serve", n_queries=nq, k=k,
                         nprobe=nprobe):
            # 1. probe: nearest centroids per query (centroid rows come
            # through the shared store)
            cent = self.index.centroids(index_version)
            _, probes = ops.ivf_topk(q, cent, np.arange(p, dtype=np.int32),
                                     nprobe, device=dev, tracer=kernel_tracer)
            probes = np.asarray(probes, np.int64)           # (Q, nprobe)
            # 2. one batched posting fetch for the union of probed parts
            parts = np.unique(probes)
            posts = self.index.postings(parts, index_version)
            cand_ids = np.concatenate(posts) if posts else \
                np.zeros(0, np.int64)
            # per-query eligibility: candidate row -> owning partition,
            # eligible iff that partition is in the query's probe set
            probed = np.zeros((nq, p), bool)
            probed[np.repeat(np.arange(nq), nprobe), probes.reshape(-1)] = True
            part_of = np.repeat(parts, [len(pl) for pl in posts])
            mask = probed[:, part_of]                       # (Q, N)
            # 3. one batched take of the candidate vectors, then the kernel
            cand = self.reader.take(self.column, cand_ids)
            d, w = ops.ivf_topk(q, np.asarray(cand.values, np.float32),
                                cand_ids, k, mask=mask, device=dev,
                                tracer=kernel_tracer)
            d = np.asarray(d, np.float32)
            w = np.asarray(w, np.int64)
            w[w == ops.IVF_ID_SENTINEL] = -1
            # 4. one batched take of the deduplicated winner rows — the
            # response payload, served (and priced) like any data read
            winners = np.unique(w[w >= 0])
            values = None
            if fetch and winners.size:
                values = self.reader.take(self.column, winners)
            return SearchResult(ids=w, distances=d, probes=probes,
                                winner_rows=winners, values=values,
                                n_candidates=int(cand_ids.size))

    def tier_stats(self):
        """Per-tier dispatched-IO stats since the last fetch."""
        return self.reader.tier_stats()

    def modelled_time(self) -> float:
        return self.reader.modelled_time()
