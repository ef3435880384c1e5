"""Profiler sessions inside the measured window, and the reduction of
their trace to what the per-layer metrics read.

A session profiles a few whole steps (``torch.profiler`` with CPU and
CUDA activities), marked on the host by a ``dtrbench.window`` range from
the first step's start to the last one's end.  A session can come back
short on the H100 (two or three of ten in ``chip_smoke.py``'s
``device_ms`` after thousands of kernels held no device events), so the
run takes several and uses the first complete one, as ``device_ms``'s
guard runs a short session again.

The trace is read from its Chrome export (``traceEvents``): device
events (kernels, copies, fills) are matched to their launch on the host
by correlation id, and each launch to the innermost ``dtrbench.*`` range
open on its thread (``lib.spans``), which names the kernel and pass.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from .spans import MEASURE, PREFIX

WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class Session:
    """One profiled stretch of steps, opened and closed by the step hook."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.handle = None

    def start(self):
        self.prof.start()
        self.handle = torch.ops.profiler._record_function_enter_new(
            WINDOW, None)

    def stop(self):
        torch.ops.profiler._record_function_exit._RecordFunction(self.handle)
        self.prof.stop()

    def events(self) -> list:
        """The session's Chrome trace events (written to a temporary file
        under ``TMPDIR`` and deleted)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="dtrbench-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_events: int = 0
    span_s: dict = field(default_factory=dict)      # (kernel, phase) -> s
    device_ops: list = field(default_factory=list)  # [[name, s]] top 10
    idle_gaps: list = field(default_factory=list)   # [[host doing, s]]


def _complete(ev) -> bool:
    return ev.get("ph") == "X" and "ts" in ev and "dur" in ev


def _innermost(points, ranges):
    """For each time in ``points`` (sorted (t, key)), the innermost range
    of ``ranges`` ((start, end, name), one thread's, properly nested)
    containing it: ``{key: (name, start, outermost dtrbench name)}``."""
    marks = sorted([(s, 0, i) for i, (s, _, _) in enumerate(ranges)]
                   + [(e, 2, i) for i, (_, e, _) in enumerate(ranges)]
                   + [(t, 1, k) for t, k in points], key=lambda m: m[:2])
    stack, found = [], {}
    for _, kind, ref in marks:
        if kind == 0:
            stack.append(ref)
        elif kind == 2:
            if ref in stack:
                stack.remove(ref)
        elif stack:
            top = ranges[stack[-1]]
            outer = next((ranges[i][2] for i in stack
                          if ranges[i][2].startswith(PREFIX)), None)
            found[ref] = (top[2], top[0], outer)
    return found


def _union(intervals):
    """Merged (start, end) of the intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list, top: int = 10) -> TraceSummary:
    """Reduce one session's events to busy time, the window, each kernel
    span's device time and the breakdown."""
    out = TraceSummary()
    win = [e for e in events if _complete(e) and e.get("name") == WINDOW]
    if not win:
        return out
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    out.window_s = (w1 - w0) / 1e6
    device = [e for e in events if _complete(e)
              and e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    out.device_events = len(device)
    if not device:
        return out
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                              w1)) for e in device]
    busy = _union(clipped)
    out.busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = defaultdict(float)
    for e, (s, t) in zip(device, clipped):
        by_name[e["name"]] += (t - s) / 1e6
    out.device_ops = [[n, s] for n, s in sorted(by_name.items(),
                                                key=lambda x: -x[1])[:top]]

    # Device time inside each kernel span, by the launch's innermost range.
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (float(e["ts"]),
                                                (e.get("pid"), e.get("tid")))
    ranges = defaultdict(list)
    for e in events:
        if _complete(e) and e.get("cat") in HOST_CATS:
            ranges[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))
    spans = {key: [r for r in rs if r[2].startswith(PREFIX)
                   and r[2] != WINDOW] for key, rs in ranges.items()}
    points = defaultdict(list)
    for i, e in enumerate(device):
        hit = launch.get(e.get("args", {}).get("correlation"))
        if hit is not None:
            points[hit[1]].append((hit[0], i))
    span_s = defaultdict(float)
    for key, pts in points.items():
        for i, (name, _, _) in _innermost(sorted(pts), spans.get(key, [])
                                          ).items():
            if name == MEASURE:
                continue
            kernel, phase = name[len(PREFIX):].rsplit(".", 1)
            s, t = clipped[i]
            span_s[(kernel, phase)] += (t - s) / 1e6
    out.span_s = dict(span_s)

    # Idle gaps, named by what the host was doing when each began: the
    # innermost host range open then, on the thread where it began last.
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy[0][0] > w0:
        gaps.insert(0, (w0, busy[0][0]))
    if busy[-1][1] < w1:
        gaps.append((busy[-1][1], w1))
    label = {}
    for key, rs in ranges.items():
        for g, (name, start, outer) in _innermost(
                sorted((s, i) for i, (s, _) in enumerate(gaps)), rs).items():
            if g not in label or start > label[g][0]:
                label[g] = (start, name if outer in (None, name)
                            else f"{outer}: {name}")
    idle = defaultdict(float)
    for i, (s, t) in enumerate(gaps):
        idle[label.get(i, (0, "no host range"))[1]] += (t - s) / 1e6
    out.idle_gaps = [[n, s] for n, s in sorted(idle.items(),
                                               key=lambda x: -x[1])[:top]]
    return out
