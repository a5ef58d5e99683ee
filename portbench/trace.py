"""A ``torch.profiler`` trace of the measured window, reduced to what the
per-layer metrics read.

The benchmark marks its own spans with ``record_function`` (names under
``portbench.``); the trace gives every kernel, copy and set on the card.
Busy time is the union of those device intervals inside the window; an
idle gap is a stretch of the window with none, labelled by the
benchmark's span and the host's outermost operator at its middle.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."
WINDOW = PREFIX + "window"


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]     # seconds by name, longest first
    idle_gaps: List[Tuple[str, float]]      # seconds by label, longest first

    def seconds_matching(self, pattern) -> float:
        """Device seconds of the operations whose name matches
        ``pattern`` (a compiled regular expression)."""
        return sum(sec for name, sec in self.device_ops
                   if pattern.search(name))


def profile():
    """The profiler of a traced window (CPU and CUDA activity)."""
    import torch
    import torch.profiler as tp
    activities = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(tp.ProfilerActivity.CUDA)
    return tp.profile(activities=activities)


def summarize(prof) -> TraceSummary:
    """Export the profile as a Chrome trace under ``TMPDIR``, read it back
    and reduce it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as handle:
            events = json.load(handle)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events)


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _outermost(intervals):
    """The intervals not inside an earlier one, sorted by start."""
    out = []
    for start, end, name in sorted(intervals, key=lambda e: (e[0], -e[1])):
        if out and end <= out[-1][1]:
            continue
        out.append((start, end, name))
    return out


def _label_at(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i][2]
    return None


def reduce_events(events) -> TraceSummary:
    """Busy time, device seconds by operation and idle seconds by label
    from Chrome-trace events (times in microseconds)."""
    window = None
    device, marks, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((start, end, name))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            if name == WINDOW:
                window = (start, end)
            else:
                marks.append((start, end, name[len(PREFIX):]))
        elif cat == "cpu_op":
            host.append((start, end, name))
    if window is None:
        raise ValueError("the trace holds no portbench.window span")
    lo, hi = window
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in device
              if e > lo and s < hi]
    by_name: Dict[str, float] = defaultdict(float)
    for start, end, name in inside:
        by_name[name] += (end - start) * 1e-6
    busy = _union((s, e) for s, e, _ in inside)
    busy_s = sum(e - s for s, e in busy) * 1e-6

    marks = _outermost(marks)
    host = _outermost(h for h in host if h[1] > lo and h[0] < hi)
    mark_starts = [m[0] for m in marks]
    host_starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    cursor = lo
    for start, end in busy + [[hi, hi]]:
        if start > cursor:
            mid = 0.5 * (cursor + start)
            span = _label_at(marks, mark_starts, mid) or "between steps"
            op = _label_at(host, host_starts, mid) or "python"
            gaps[f"{span}: {op}"] += (start - cursor) * 1e-6
        cursor = max(cursor, end)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])
    return TraceSummary(window_s=(hi - lo) * 1e-6, busy_s=busy_s,
                        device_ops=order(by_name), idle_gaps=order(gaps))
