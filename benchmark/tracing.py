"""The traced window: the cell's loop under ``torch.profiler``, reduced to
each card's busy time, the device operations that took the most time and
the idle gaps labelled by the host span around them."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import WINDOW_LABEL, sync


def union(intervals) -> list:
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(merged, lo: float, hi: float) -> list:
    """The parts of ``[lo, hi]`` that ``merged`` leaves uncovered."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def _label_of(spans_by_name, t: float) -> str:
    """The innermost benchmark span around time ``t``: the index call, the
    rest of the outer call, or the loop between calls."""
    inner = None
    for name, (starts, ends) in spans_by_name.items():
        i = np.searchsorted(starts, t, side="right") - 1
        if i >= 0 and ends[i] >= t:
            length = ends[i] - starts[i]
            if inner is None or length < inner[1]:
                inner = (name, length)
    return inner[0] if inner else "between calls"


def traced_window(loop, spans, devices, seconds: float, log) -> dict:
    """Runs ``loop`` for ``seconds`` under the profiler, with the spans as
    labels. Returns ``busy_s`` (union of device operations, mean over the
    cards used), ``window_s``, the calls, each card's busy seconds, each
    card's seconds by device operation (full names), and the
    ``breakdown``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans.labels = True
    try:
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_LABEL):
                _s, calls, _a, _f, _lat = loop.run(seconds)
                sync(devices)
    finally:
        spans.labels = False
    t0 = time.perf_counter()
    events = prof.events()
    win = [e for e in events if e.name == WINDOW_LABEL]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    per_card: dict = {d.index: [] for d in cuda}
    ops: dict = {}
    ops_by_card: dict = {}
    labelled: dict = {}
    labels = set(spans.total) | {WINDOW_LABEL}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in labels:
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                per_card.setdefault(e.device_index, []).append((s, t))
                ops[e.name] = ops.get(e.name, 0.0) + (t - s)
                mine = ops_by_card.setdefault(e.device_index, {})
                mine[e.name] = mine.get(e.name, 0.0) + (t - s) / 1e6
        elif e.device_type == DeviceType.CPU and e.name in spans.total:
            labelled.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    window_us = w1 - w0
    merged = {c: union(iv) for c, iv in per_card.items()}
    busy = {c: sum(e - s for s, e in m) / 1e6 for c, m in merged.items()}
    spans_by_name = {}
    for name, iv in labelled.items():
        iv.sort()
        spans_by_name[name] = (np.array([s for s, _ in iv]), np.array([e for _, e in iv]))
    idle: dict = {}
    first = min(merged) if merged else None
    for s, e in (gaps(merged[first], w0, w1) if first is not None else []):
        label = _label_of(spans_by_name, (s + e) / 2)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    log(f"traced window {window_us / 1e6:.3f}s, {calls} calls, {len(events)} events, read in "
        f"{time.perf_counter() - t0:.1f}s; busy s by card {busy}")
    return {
        "busy_s": float(np.mean(list(busy.values()))) if busy else 0.0,
        "window_s": window_us / 1e6,
        "calls": calls,
        "busy_by_card": busy,
        "ops_by_card": ops_by_card,
        "breakdown": {
            "device_ops": [[name[:120], us / 1e6] for name, us in top_ops],
            "idle_gaps": [[name, s] for name, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }
