"""Workload-mix observer for the batched IO scheduler.

Admission tuning (ROADMAP): ``second_touch`` protects a cache from
single-pass scan flooding but delays residency for the take-heavy serving
workload the paper optimizes.  Neither is right for every trace, so the
scheduler feeds every finished batch into a :class:`WorkloadStats` and any
cache level configured ``admission="auto"`` follows the observed mix:

* **scan-heavy** (scan batches moved more logical bytes than take batches)
  → ``second_touch``: streams must touch a block twice to earn a slot;
* **take-heavy** → ``always``: the hot rows are admitted on first miss.

Classification is by batch intent, not size: a batch opened with
``prefetch=True`` (or labelled ``scan:*``) is a scan, everything else is a
take.  The decision is re-evaluated *before* each batch dispatches, so a
scan arriving at a take-warmed cache is already policed by ``second_touch``
and cannot flush the working set first.

The decision carries **hysteresis**: near the scan/take byte-mix boundary a
naive majority test flips the admission policy on every batch (each flip
resets second-touch ghost state, so thrashing is not free).  The preference
is therefore stateful — it only moves to ``second_touch`` once scan bytes
exceed take bytes by the ``hysteresis`` margin, and only moves back once
they fall short by the same margin; inside the band the previous decision
sticks.
"""

from __future__ import annotations

__all__ = ["WorkloadStats"]


class WorkloadStats:
    def __init__(self, scan_bias: float = 1.0, hysteresis: float = 0.1):
        # scan_bias scales scan bytes in the comparison: > 1 flips to
        # second_touch earlier, < 1 later.  1.0 = plain byte majority.
        # hysteresis is the dead band around the boundary: the preference
        # flips only once the biased scan bytes cross take bytes by this
        # relative margin (0 restores the memoryless majority test).
        self.scan_bias = float(scan_bias)
        if hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")
        self.hysteresis = float(hysteresis)
        self.reset()

    def reset(self) -> None:
        self.n_scan_batches = 0
        self.n_take_batches = 0
        self.scan_ops = 0
        self.take_ops = 0
        self.scan_bytes = 0
        self.take_bytes = 0
        self._pref = "always"  # cold-start default; sticky inside the band

    # -- ingest --------------------------------------------------------------
    def note_batch(self, label: str, prefetch: bool, n_ops: int,
                   nbytes: int) -> None:
        """Record one finished :class:`~repro_torch.store.ReadBatch`."""
        if prefetch or str(label).startswith("scan"):
            self.n_scan_batches += 1
            self.scan_ops += int(n_ops)
            self.scan_bytes += int(nbytes)
        else:
            self.n_take_batches += 1
            self.take_ops += int(n_ops)
            self.take_bytes += int(nbytes)

    # -- decision ------------------------------------------------------------
    @property
    def scan_fraction(self):
        """Scan share of the logical byte stream, or ``None`` before any
        batch — never NaN."""
        total = self.scan_bytes + self.take_bytes
        return self.scan_bytes / total if total else None

    def preferred_admission(self) -> str:
        """``second_touch`` when scans dominate the byte stream, else
        ``always`` (also the cold-start default).  Stateful: inside the
        hysteresis band the previous preference is returned unchanged, so
        an alternating workload sitting on the boundary cannot thrash the
        admission policy batch to batch."""
        scan = self.scan_bytes * self.scan_bias
        if scan > (1.0 + self.hysteresis) * self.take_bytes:
            self._pref = "second_touch"
        elif scan < self.take_bytes / (1.0 + self.hysteresis):
            self._pref = "always"
        return self._pref

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"WorkloadStats(scan={self.n_scan_batches}b/{self.scan_bytes}B, "
            f"take={self.n_take_batches}b/{self.take_bytes}B, "
            f"prefer={self.preferred_admission()})"
        )
