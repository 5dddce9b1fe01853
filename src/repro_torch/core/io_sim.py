"""IOP accounting and storage-device modelling.

Results come in three tiers:

1. **Counted** — every read issued by an encoding goes through the
   scheduler's read batch; we report exact IOPS, bytes fetched, dependency
   phases (sequential round-trips) and read amplification.
2. **Measured** — wall-clock decode/scan work.
3. **Modelled** — the counted trace priced with the paper's Fig. 1 device
   characteristics (Samsung 970 EVO Plus NVMe; S3 from [4]).

This is the port's copy of the healthy-device subset: the fault models
(degradations, transient errors, blackouts, correlated faults) wait for
ROADMAP.md, Queue 1 item 4b.  The reference's ``HBM`` device model (a TPU's
HBM-to-VMEM DMA regime) is deliberately not carried: the port prices no
TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Disk", "DiskView", "IOTracker", "IOStats", "DeviceModel",
    "NVME", "S3", "DRAM", "model_time", "merge_phase_extents",
    "trace_stats",
]


class Disk:
    """An addressable in-memory byte store (the 'file')."""

    def __init__(self, data: Optional[np.ndarray] = None):
        self._mem = np.asarray(data, dtype=np.uint8) if data is not None else np.zeros(0, np.uint8)
        self._size = len(self._mem)

    @staticmethod
    def from_bytes(b: bytes) -> "Disk":
        return Disk(np.frombuffer(b, dtype=np.uint8).copy())

    def __len__(self) -> int:
        return self._size

    def read(self, offset: int, size: int) -> np.ndarray:
        offset, size = int(offset), int(size)
        if size < 0:
            raise ValueError(f"negative read size {size}")
        if offset < 0 or offset + size > self._size:
            raise ValueError(
                f"read [{offset}, {offset + size}) out of bounds for "
                f"{self._size}-byte disk"
            )
        # copy so callers can never alias (or mutate) the backing store
        return self._mem[offset : offset + size].copy()

    def write(self, offset: int, data) -> None:
        """Data-plane write: store ``data`` at ``offset``.  Durability is
        *not* implied — the store decides when the bytes count as persisted
        on the backing device."""
        data = np.frombuffer(bytes(data), dtype=np.uint8) \
            if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
        offset = int(offset)
        if offset < 0 or offset + len(data) > self._size:
            raise ValueError(
                f"write [{offset}, {offset + len(data)}) out of bounds for "
                f"{self._size}-byte disk")
        self._mem[offset : offset + len(data)] = data

    def grow(self, nbytes: int) -> int:
        """Extend the address space by ``nbytes`` zero bytes (append path);
        returns the new size.  Existing views/readers stay valid — they hold
        the Disk object, not the buffer.  Capacity doubles geometrically (a
        logical ``_size`` over a larger backing array) so N appends cost
        amortized O(appended bytes), not O(total * N) reallocation."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"cannot grow by {nbytes} bytes")
        new_size = self._size + nbytes
        if new_size > len(self._mem):
            buf = np.zeros(max(new_size, 2 * len(self._mem), 4096), np.uint8)
            buf[: self._size] = self._mem[: self._size]
            self._mem = buf
        # bytes in [_size, new_size) are zero: writes are bounds-checked to
        # _size, so the spare capacity has never been touched
        self._size = new_size
        return self._size

    def zero(self, lo: int, hi: int) -> None:
        """Zero a byte range in place (the crash simulator's torn-write
        model: unflushed bytes vanish from the media)."""
        lo, hi = max(int(lo), 0), min(int(hi), self._size)
        if hi > lo:
            self._mem[lo:hi] = 0

    def read_gather(self, offsets, sizes) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized multi-extent read: one gather for N spans.

        Returns ``(data, out_offsets)`` where span ``k``'s bytes are
        ``data[out_offsets[k]:out_offsets[k + 1]]``.  Bounds are checked for
        every span; the in-memory path is a single fancy-index copy (no
        per-span Python loop), which is what makes the batched ``take``
        pipeline's chunk/index/span fetches cheap.
        """
        offsets = np.asarray(offsets, dtype=np.int64)
        sizes = np.asarray(sizes, dtype=np.int64)
        out_offs = np.zeros(len(sizes) + 1, dtype=np.int64)
        if len(sizes) == 0:
            return np.zeros(0, np.uint8), out_offs
        if (sizes < 0).any():
            raise ValueError("negative read size in gather")
        if int(offsets.min()) < 0 or int((offsets + sizes).max()) > self._size:
            raise ValueError(
                f"gather read out of bounds for {self._size}-byte disk"
            )
        np.cumsum(sizes, out=out_offs[1:])
        total = int(out_offs[-1])
        idx = np.repeat(offsets - out_offs[:-1], sizes) + np.arange(
            total, dtype=np.int64
        )
        return self._mem[idx], out_offs


class DiskView:
    """A length-bounded window into another :class:`Disk`.

    A multi-fragment dataset concatenates its files into one global address
    space (``repro_torch.dataset``); each per-file reader parses its footer in
    file-local coordinates through a view while every scheduled read is
    priced at ``base + offset`` in the shared store — so cache block ids and
    sector alignment are consistent across files.
    """

    def __init__(self, disk: "Disk", base: int, size: int):
        base, size = int(base), int(size)
        if base < 0 or size < 0 or base + size > len(disk):
            raise ValueError(
                f"view [{base}, {base + size}) out of bounds for "
                f"{len(disk)}-byte disk"
            )
        self.disk = disk
        self.base = base
        self._size = size

    def __len__(self) -> int:
        return self._size

    def read(self, offset: int, size: int) -> np.ndarray:
        offset, size = int(offset), int(size)
        if size < 0:
            raise ValueError(f"negative read size {size}")
        if offset < 0 or offset + size > self._size:
            raise ValueError(
                f"read [{offset}, {offset + size}) out of bounds for "
                f"{self._size}-byte view"
            )
        return self.disk.read(self.base + offset, size)

    def read_gather(self, offsets, sizes) -> Tuple[np.ndarray, np.ndarray]:
        offsets = np.asarray(offsets, dtype=np.int64)
        sizes = np.asarray(sizes, dtype=np.int64)
        if len(sizes) and (
            (sizes < 0).any() or int(offsets.min()) < 0
            or int((offsets + sizes).max()) > self._size
        ):
            raise ValueError(
                f"gather read out of bounds for {self._size}-byte view"
            )
        return self.disk.read_gather(offsets + self.base, sizes)


@dataclasses.dataclass
class IOStats:
    n_iops: int = 0
    bytes_read: int = 0
    useful_bytes: int = 0
    max_phase: int = 0  # dependency depth: number of sequential round trips
    n_coalesced: int = 0  # IOPS after merging adjacent/overlapping requests

    @property
    def read_amplification(self) -> float:
        return self.bytes_read / self.useful_bytes if self.useful_bytes else float("nan")


def merge_phase_extents(
    ops: Sequence[Tuple[int, int, int]], gap: int = 0
) -> Dict[int, List[Tuple[int, int]]]:
    """Merge adjacent/overlapping byte ranges **within each dependency
    phase**.  Reads at phase p causally depend on reads at phases < p having
    returned, so cross-phase merging would fabricate requests no scheduler
    could have issued.  Returns ``{phase: [(lo, hi), ...]}`` sorted by lo;
    zero-length requests survive as ``(o, o)`` extents (they are still ops)."""
    by_phase: Dict[int, List[Tuple[int, int]]] = {}
    for o, sz, p in ops:
        by_phase.setdefault(int(p), []).append((int(o), int(o) + int(sz)))
    out: Dict[int, List[Tuple[int, int]]] = {}
    for p, ivs in by_phase.items():
        ivs.sort()
        merged: List[Tuple[int, int]] = []
        cur: Optional[Tuple[int, int]] = None
        for a, b in ivs:
            if cur is None or a > cur[1] + gap:
                if cur is not None:
                    merged.append(cur)
                cur = (a, b)
            else:
                cur = (cur[0], max(cur[1], b))
        if cur is not None:
            merged.append(cur)
        out[p] = merged
    return out


def trace_stats(
    ops: Sequence[Tuple[int, int, int]], useful_bytes: int = 0,
    coalesce_gap: int = 0,
) -> IOStats:
    """IOStats for a logical read trace; single source of truth shared by the
    legacy :class:`IOTracker` and the batched scheduler in
    ``repro_torch.store``."""
    s = IOStats()
    s.n_iops = len(ops)
    s.bytes_read = sum(sz for _, sz, _ in ops)
    s.useful_bytes = int(useful_bytes)
    # an empty trace has depth 0; otherwise depth = deepest phase + 1
    s.max_phase = max((p for _, _, p in ops), default=-1) + 1
    s.n_coalesced = sum(len(v) for v in merge_phase_extents(ops, coalesce_gap).values())
    return s


class IOTracker:
    """Counts every read.  ``phase`` expresses dependencies: a read at phase p
    could only be issued after all reads at phases < p returned (the paper's
    'issued in 3 phases' for Arrow List<String>).  The legacy per-read
    tracker: the scheduler's logical stats must equal its stats on the same
    trace."""

    def __init__(self, disk: Disk, sector: int = 4096):
        self.disk = disk
        self.sector = sector
        self.ops: List = []  # (offset, size, phase)

    def read(self, offset: int, size: int, phase: int = 0) -> np.ndarray:
        offset, size = int(offset), int(size)
        self.ops.append((offset, size, phase))
        return self.disk.read(offset, size)

    def note_useful(self, nbytes: int) -> None:
        self._useful = getattr(self, "_useful", 0) + int(nbytes)

    def reset(self) -> None:
        self.ops = []
        self._useful = 0

    def stats(self, coalesce_gap: int = 0) -> IOStats:
        return trace_stats(self.ops, getattr(self, "_useful", 0), coalesce_gap)


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """First-order device model from the paper's Fig. 1 measurements."""

    name: str
    iops_4k: float  # peak random 4 KiB IOPS at full queue depth
    seq_bw: float  # bytes/s sequential
    latency: float  # per-round-trip latency (seconds)
    min_read: int  # reads below this size cost the same as this size


# Samsung 970 EVO Plus measured in the paper: 850K IOPS @4KiB, 3,400 MiB/s.
NVME = DeviceModel("nvme_970evo", 850_000, 3400 * (1 << 20), 90e-6, 4096)
# S3 (c7gn.8xlarge): tens of thousands of IOPS, no benefit < ~100KB reads.
S3 = DeviceModel("s3", 20_000, 10 * (1 << 30), 30e-3, 100 * 1024)
# Host DRAM (the tiered store's RAM-hot tier): a cache-line-granular copy.
DRAM = DeviceModel("dram", 10_000_000, 25 * (1 << 30), 2e-7, 64)


def model_time(stats: IOStats, dev: DeviceModel, queue_depth: int = 256,
               use_coalesced: bool = False) -> float:
    """Price an IO trace on a device: throughput-limited term (max of IOPS
    limit scaled by request size, and bandwidth) plus dependency round trips
    amortized across the queue."""
    n = stats.n_coalesced if use_coalesced else stats.n_iops
    if n == 0:
        return 0.0
    avg = max(stats.bytes_read / n, 1.0)
    eff = max(avg, dev.min_read)
    iops_limit = min(dev.iops_4k, dev.seq_bw / eff)
    t_ops = n / iops_limit
    t_bw = stats.bytes_read / dev.seq_bw
    # dependency phases are sequential round trips; with a deep queue their
    # latency is paid once per phase, not per op
    return max(t_ops, t_bw) + stats.max_phase * dev.latency
