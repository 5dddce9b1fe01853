"""The one generator of traffic: reads a mix's parameters
(``traffic/<name>.json``) and yields its requests.

Keys of a mix:

* ``kind``: ``"take"`` (``DatasetReader.take`` of a row set) or ``"scan"``
  (``DatasetReader.scan`` of the whole column);
* ``loop``: ``"closed"``: one caller, each request issued when the last has
  returned (the only loop a library call with a waiting caller has);
* ``rows_per_request`` (take): distinct rows a take asks for, drawn
  uniformly over every row of the dataset, in random order;
* ``warmup_requests``: requests of the same shapes made in set-up (at
  least one);
* ``check_requests``: how many of the window's answers are compared with
  the reference (a seeded reservoir sample; all of them when fewer came);
* ``reader``: keyword arguments for ``DatasetReader`` (empty: its defaults).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

KINDS = ("take", "scan")


def check(mix: dict) -> None:
    """Raise ValueError for a mix this generator cannot run."""
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic kind must be one of {KINDS}")
    if mix.get("loop") != "closed":
        raise ValueError("only closed-loop traffic is supported")
    if mix["kind"] == "take" and int(mix.get("rows_per_request", 0)) < 1:
        raise ValueError("rows_per_request must be at least 1")
    for key in ("warmup_requests", "check_requests"):
        if int(mix.get(key, 0)) < 1:
            raise ValueError(f"{key} must be at least 1")


class Requests:
    """The request stream of one mix over a dataset of ``n_rows`` rows:
    :meth:`next` gives a take's global row ids, or None for a scan."""

    def __init__(self, mix: dict, n_rows: int, rng: np.random.Generator):
        check(mix)
        self.mix, self.n_rows, self.rng = mix, int(n_rows), rng
        self.k = int(mix.get("rows_per_request", 0))
        if mix["kind"] == "take" and self.k > n_rows:
            raise ValueError("more distinct rows a take than the dataset has")

    def next(self) -> Optional[np.ndarray]:
        if self.mix["kind"] == "scan":
            return None
        return self.rng.choice(self.n_rows, self.k, replace=False)
