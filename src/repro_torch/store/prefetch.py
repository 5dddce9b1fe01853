"""Sequential / strided readahead policy for the scan path.

Watches the stream of coalesced extents a batch dispatches and, once it sees
``min_run`` consecutive reads advancing forward by a (near-)constant step,
asks the scheduler to pull the next ``window_bytes`` into the cache ahead of
demand.  Readahead never re-requests a region it already covered
(``_ra_until`` high-water mark), so a steady scan issues one window-sized
backing read per window instead of one per logical read.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["SequentialReadahead"]


class SequentialReadahead:
    def __init__(self, window_bytes: int = 1 << 20, min_run: int = 2,
                 max_gap: int = 1 << 16):
        if window_bytes <= 0:
            raise ValueError("window_bytes must be positive")
        self.window_bytes = int(window_bytes)
        self.min_run = int(min_run)
        self.max_gap = int(max_gap)
        self.reset()

    def reset(self) -> None:
        self._last_lo: Optional[int] = None
        self._last_end: Optional[int] = None
        self._stride: Optional[int] = None
        self._run = 0
        self._ra_until = 0

    def observe(self, lo: int, hi: int) -> Optional[Tuple[int, int]]:
        """Feed one demand extent; returns a (lo, hi) region to prefetch, or
        None if the pattern is not (yet) sequential/strided."""
        lo, hi = int(lo), int(hi)
        seq = (
            self._last_end is not None
            and 0 <= lo - self._last_end <= self.max_gap
        )
        stride = lo - self._last_lo if self._last_lo is not None else None
        strided = (
            stride is not None and stride > 0 and stride == self._stride
        )
        if seq or strided:
            self._run += 1
        else:
            self._run = 1
            self._ra_until = 0
        self._stride = stride
        self._last_lo, self._last_end = lo, hi
        if self._run < self.min_run:
            return None
        start = max(hi, self._ra_until)
        end = hi + self.window_bytes
        if start >= end:
            return None  # window already covered by an earlier prefetch
        self._ra_until = end
        return start, end
