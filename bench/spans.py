"""Host-clock spans around the port's layer entry points, wrapped from the
benchmark's side (the port is not edited): each call's time, less the time
of the wrapped calls inside it, is its layer's self time.  In a traced run
each span is also a ``torch.profiler.record_function`` range, so the device
trace can name what the host was doing in each idle gap.

Installed only for a traced run, and removed when its window closes.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

# (module, class or None for a module function, attribute, layer)
TARGETS: Tuple[Tuple[str, str, str, str], ...] = (
    ("repro_torch.dataset.reader", "DatasetReader", "take", "dataset"),
    ("repro_torch.dataset.reader", "DatasetReader", "scan", "dataset"),
    ("repro_torch.core.file", "FileReader", "take_leaves", "file"),
    ("repro_torch.core.file", "FileReader", "scan_into", "file"),
    ("repro_torch.store.scheduler", "ReadBatch", "read", "store"),
    ("repro_torch.store.scheduler", "ReadBatch", "read_many", "store"),
    ("repro_torch.store.scheduler", "IOScheduler", "_finish", "store"),
    ("repro_torch.kernels.ops", None, "miniblock_decode", "ops"),
    ("repro_torch.kernels.ops", None, "fullzip_gather", "ops"),
    ("repro_torch.kernels.ops", None, "ivf_topk", "ops"),
    ("repro_torch.kernels.ops", None, "bitunpack", "ops"),
    ("repro_torch.kernels.ops", None, "to_device", "ops"),
    ("repro_torch.kernels.ops", None, "to_host", "ops"),
)


class Spans:
    """Self time by layer (seconds) and calls by span, since :meth:`reset`."""

    def __init__(self, annotate: bool = True):
        self.annotate = annotate
        self.self_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._stack: List[float] = []  # time of the wrapped calls inside each open span
        self._real: List[Tuple[object, str, object]] = []

    def install(self) -> "Spans":
        for module, cls, attr, layer in TARGETS:
            owner = importlib.import_module(module)
            if cls is not None:
                owner = getattr(owner, cls)
            real = owner.__dict__[attr] if cls is not None else getattr(owner, attr)
            self._real.append((owner, attr, real))
            setattr(owner, attr, self._wrap(real, layer, f"{layer}.{attr}"))
        return self

    def remove(self) -> None:
        for owner, attr, real in reversed(self._real):
            setattr(owner, attr, real)
        self._real = []

    def reset(self) -> None:
        self.self_s.clear()
        self.calls.clear()

    def _wrap(self, fn, layer: str, name: str):
        from torch.profiler import record_function

        def wrapped(*args, **kw):
            ctx = record_function(name) if self.annotate else contextlib.nullcontext()
            self._stack.append(0.0)
            start = time.perf_counter()
            try:
                with ctx:
                    return fn(*args, **kw)
            finally:
                took = time.perf_counter() - start
                self.self_s[layer] += took - self._stack.pop()
                self.calls[name] += 1
                if self._stack:
                    self._stack[-1] += took

        wrapped.__wrapped__ = fn
        return wrapped
