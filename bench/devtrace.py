"""The device trace of a traced run's window, from ``torch.profiler``.

The window is one ``record_function`` range (``WINDOW``); the host spans of
``spans.py`` are ranges inside it.  From the exported trace this reads the
device's busy time (the union of its kernels, copies and memsets inside the
window), the kernels' and the copies' summed times, the device operations
that took most time, and the idle gaps, each named by the innermost host
range open over each part of it and summed by that name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import List, Optional

WINDOW = "bench.window"
REQUEST = "bench.request"
KERNEL, COPY, SET = "kernel", "gpu_memcpy", "gpu_memset"
DEVICE_CATS = (KERNEL, COPY, SET)
HOST_CAT = "user_annotation"
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: float
    copy_s: float
    device_ops: List[list]  # [[name, seconds]], most time first
    idle_gaps: List[list]  # [[host range, seconds]], most time first


def profiler(cuda: bool):
    """A profiler over the host ranges and, with ``cuda``, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def reduce(prof) -> Optional[DeviceTrace]:
    """Read the window out of a stopped profiler (None without a window)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events)


def reduce_events(events) -> Optional[DeviceTrace]:
    host, dev = [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in (HOST_CAT, *DEVICE_CATS):
            continue
        start = float(e["ts"])
        span = (start, start + float(e.get("dur", 0)), e.get("name", ""), cat)
        (host if cat == HOST_CAT else dev).append(span)
    windows = [h for h in host if h[2] == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0][0], windows[0][1]
    by_name, summed = defaultdict(float), defaultdict(float)
    clipped = []
    for s, e, name, cat in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        by_name[name] += e - s
        summed[cat] += e - s
    busy, gaps = _union(clipped, w0, w1)
    idle = defaultdict(float)
    for s, e, name in _overlaps(gaps, _innermost(host, w0, w1)):
        idle[name] += e - s
    us = 1e-6
    return DeviceTrace(
        window_s=(w1 - w0) * us, busy_s=busy * us,
        kernel_s=summed[KERNEL] * us, copy_s=summed[COPY] * us,
        device_ops=[[n, t * us] for n, t in _top(by_name)],
        idle_gaps=[[n, t * us] for n, t in _top(idle)])


def _top(d):
    return sorted(d.items(), key=lambda kv: -kv[1])[:TOP]


def _union(spans, w0, w1):
    """Length of the union of ``spans`` and the gaps it leaves in [w0, w1]."""
    busy, gaps, cur = 0.0, [], w0
    for s, e in sorted(spans):
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _innermost(host, w0, w1):
    """The window cut into segments, each named by the innermost host range
    open in it (ranges nest: one thread opens them)."""
    segs, stack, cur = [], [], w0

    def upto(t):
        nonlocal cur
        while stack and stack[-1][1] <= t:  # close the ranges that end first
            end = max(cur, min(stack[-1][1], w1))
            segs.append((cur, end, stack[-1][2]))
            cur = end
            stack.pop()
        t = min(t, w1)
        if t > cur:
            segs.append((cur, t, stack[-1][2] if stack else "outside the window"))
            cur = t

    for s, e, name, _ in sorted(host, key=lambda h: (h[0], -h[1])):
        upto(max(s, w0))
        stack.append((s, e, name))
    upto(w1)
    return segs


def _overlaps(gaps, segs):
    """Pieces of the sorted ``gaps`` that fall in each of the sorted named
    ``segs``."""
    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            s, e = max(g0, segs[j][0]), min(g1, segs[j][1])
            if e > s:
                yield s, e, segs[j][2]
            j += 1
