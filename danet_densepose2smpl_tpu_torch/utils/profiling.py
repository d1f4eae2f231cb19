"""Profiling (port of the JAX package's `utils/profiling.py`): a tic/toc
timer, a `torch.profiler` trace of a block written as a Chrome trace, and
named ranges in such traces.

    with trace("logs/trace"):
        with annotate("serve.request"):
            predictor.predict(images)

`trace` records the CPU's activity, and the CUDA card's where one is
available; `logs/trace/trace.json` opens in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class Timer:
    """Streaming tic/toc with running mean (reference utils/timer.py)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.calls = 0
        self._t0 = None
        self.last = 0.0

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        self.last = time.perf_counter() - self._t0
        self.total += self.last
        self.calls += 1
        return self.last

    @property
    def average(self) -> float:
        return self.total / max(self.calls, 1)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block and write `log_dir/trace.json`. Yields
    the `torch.profiler.profile` object (its `key_averages()` and
    `events()` are there after the block)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range in profiler traces."""
    with record_function(name):
        yield
