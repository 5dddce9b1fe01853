"""Paged KV cache with a Lance-style block layout.

The mini-block idea mapped to serving: KV entries are stored in fixed
power-of-two **blocks** (the mini-block chunk), located through a **block
table** (the search cache / repetition index).  Fetching the blocks of a
request is the full-zip gather pattern — one copy per block, driven by the
table — run on the device by the ``fullzip_gather`` kernel.

This module is the host-side allocator and the device gather wrapper; the
store is a torch tensor on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..kernels import ops

__all__ = ["PagedKVCache", "BLOCK"]

BLOCK = 128  # tokens per block (power of two)


@dataclasses.dataclass
class _Req:
    block_ids: List[int]
    length: int


class PagedKVCache:
    """One layer's paged K or V store: ``(n_blocks, BLOCK * kv_features)``
    of ``dtype`` on ``device`` (CUDA unless the caller names the CPU)."""

    def __init__(self, n_blocks: int, kv_features: int, dtype=torch.bfloat16,
                 device=None):
        self.device = ops.resolve_device(device)
        self.store = torch.zeros((n_blocks, BLOCK * kv_features), dtype=dtype,
                                 device=self.device)
        self.kv_features = kv_features
        self.free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.reqs: Dict[int, _Req] = {}

    # -- allocation ---------------------------------------------------------
    def add_request(self, rid: int) -> None:
        self.reqs[rid] = _Req([], 0)

    def release(self, rid: int) -> None:
        self.free.extend(self.reqs.pop(rid).block_ids)

    def _ensure_capacity(self, rid: int, length: int) -> None:
        r = self.reqs[rid]
        while len(r.block_ids) * BLOCK < length:
            if not self.free:
                raise MemoryError("KV pool exhausted")
            r.block_ids.append(self.free.pop())

    # -- writes ---------------------------------------------------------------
    def append(self, rid: int, kv) -> None:
        """kv: ``(n_new, kv_features)`` array (numpy or torch) appended at
        the request's tail, cast to the store's dtype.  Only the new slots
        are written, in place on the device."""
        r = self.reqs[rid]
        kv = torch.as_tensor(kv)
        n_new = kv.shape[0]
        self._ensure_capacity(rid, r.length + n_new)
        pos = r.length + np.arange(n_new)
        blocks = np.asarray(r.block_ids, dtype=np.int64)[pos // BLOCK]
        slots = torch.from_numpy(blocks * BLOCK + pos % BLOCK).to(self.device)
        self.store.view(-1, self.kv_features).index_copy_(
            0, slots, kv.to(self.device).to(self.store.dtype))
        r.length += n_new

    # -- reads -------------------------------------------------------------
    def block_table(self, rid: int) -> np.ndarray:
        return np.array(self.reqs[rid].block_ids, dtype=np.int32)

    def gather(self, rid: int) -> torch.Tensor:
        """Fetch a request's KV as ``(length, kv_features)`` via the full-zip
        gather kernel (one row of ``BLOCK * kv_features`` values per block,
        the paper's IOP bound): the store is gathered as ``uint8`` rows and
        viewed back as ``dtype``."""
        r = self.reqs[rid]
        table = ops.to_device(self.block_table(rid), self.device)
        rows = ops.fullzip_gather(self.store.view(torch.uint8), table)
        return rows.view(self.store.dtype).reshape(-1, self.kv_features)[: r.length]

    @property
    def utilization(self) -> float:
        used = sum(len(r.block_ids) for r in self.reqs.values())
        total = used + len(self.free)
        return used / total if total else 0.0
