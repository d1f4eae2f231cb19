"""The profiled slice: a fixed number of requests or steps under
`torch.profiler`, after the window, in the same process; and what the
readers take from its trace.

The trace is written as a Chrome trace into a temporary directory (under
TMPDIR) and read back, so the same fields are read on every PyTorch
version: device operations (`kernel`, `gpu_memcpy`, `gpu_memset`) and the
host's named ranges (`user_annotation`), on one clock in microseconds.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
ITEM_RANGE = "port_bench.item"
PROFILER_RANGE = "ProfilerStep#"   # the profiler's own range of each step, not the host's work


@dataclass
class SliceTrace:
    ops: list          # (name, start_us, end_us) of each device operation
    ranges: list       # (name, start_us, end_us) of each host range
    window: tuple      # (start_us, end_us) of the profiled slice
    items: int         # requests or steps in the slice
    images: int        # images they carry
    extra: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.ops if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most time."""
        by = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host range, seconds], ...]: the device's idle time inside the
        window, by the innermost host range open at each gap's midpoint
        ('host' where none is)."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        by = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            open_ranges = [(rs, re_, n) for n, rs, re_ in self.ranges
                           if rs <= mid < re_ and not n.startswith(PROFILER_RANGE)]
            name = max(open_ranges)[2] if open_ranges else "host"
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def op_seconds(self, patterns) -> float:
        """Device seconds of the operations whose name holds any of `patterns`."""
        return sum((e - s) for n, s, e in self.ops if any(p in n for p in patterns)) / 1e6


def sync(device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_slice(fn, items: int, images_per_item: int, device, sync_each: bool = True) -> SliceTrace:
    """Run `fn()` once to warm the profiler (and wait for it), then `items`
    times under it, each call in a host range of its own; with
    `sync_each` each range ends after a synchronize, as a request does,
    else only the last one, as steps run back to back in the window. The
    window runs from the first call's start to the last one's end."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=items, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(items + 1):
                with record_function(ITEM_RANGE):
                    fn()
                    if sync_each or i in (0, items):
                        sync(device)
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops, ranges = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        span = (ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if ev.get("cat") in DEVICE_CATEGORIES:
            ops.append(span)
        elif ev.get("cat") == "user_annotation":
            ranges.append(span)
    marks = [r for r in ranges if r[0] == ITEM_RANGE]
    window = (min(r[1] for r in marks), max(r[2] for r in marks))
    return SliceTrace(ops, ranges, window, len(marks), len(marks) * images_per_item)
