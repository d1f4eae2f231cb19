"""Profiling (port of the JAX package's `utils/profiling.py`): a
`torch.profiler` trace of a block written as a Chrome trace, and the port's
spans.

    with trace("logs/trace"):
        with annotate("serve.request"):
            predictor.predict(images)

`trace` records the CPU's activity, and the CUDA card's where one is
available; `logs/trace/trace.json` opens in Perfetto or chrome://tracing.

`annotate(name)` is the port's span. While no `torch.profiler` session
records, it is exactly a `record_function` range. While one records (`trace`,
the benchmark's profiled slice, any profiler of an operator's), the span
keeps besides, in memory:

- a pair of timing CUDA events on the current stream, at its entry and at
  its exit (where CUDA is initialised): its device ms, the time between the
  two, is read after the fact by `recorded_items` and never waited for on
  the way;
- its parent span and its item. A span opened while no span is open on its
  thread starts an item (a request, `serve.request`; a step, `train.step`)
  with a sequence id; the spans opened inside it belong to it;
- its blocking host waits. While an item is open, PyTorch's sync debug mode
  is "warn": each synchronizing CUDA call (a copy from pageable memory with
  non_blocking=False, `.item()`, `.cpu()`, `nonzero`, a stream synchronize)
  warns, and the warning is counted, not shown, against the innermost open
  span with the port's `file:line` that made the call. Other warnings pass.
  The mode and the warning filters are restored when the last item closes.
  (`torch.cuda.synchronize()`, a device synchronize, is not flagged by the
  mode; the port makes none inside a request or a step.)

The store keeps the last `ITEMS_KEPT` items; `recorded_items()` reads them
out, oldest first.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import warnings
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ITEMS_KEPT = 64
SYNC_WARNING = "called a synchronizing CUDA operation"   # c10::cuda::warn_or_error_on_sync's message
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


@dataclass(eq=False)
class Span:
    name: str
    parent: str | None
    start: torch.cuda.Event | None = None
    end: torch.cuda.Event | None = None
    device_ms: float | None = None
    waits: list = field(default_factory=list)   # "file:line" of each blocking wait charged here


@dataclass(eq=False)
class Item:
    id: int
    spans: list = field(default_factory=list)
    open: list = field(default_factory=list)    # the open spans, innermost last


def recording() -> bool:
    """Whether a `torch.profiler` session records now."""
    return torch._C._autograd._profiler_enabled()


def on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def port_site() -> str:
    """The innermost frame of the port (this file aside) as `file:line`
    relative to the package, else the innermost frame outside `warnings`."""
    frame, fallback = sys._getframe(1), None
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(PACKAGE_DIR) and path != __file__:
            return f"{path[len(PACKAGE_DIR):]}:{frame.f_lineno}"
        if fallback is None and path not in (__file__, warnings.__file__):
            fallback = f"{path}:{frame.f_lineno}"
        frame = frame.f_back
    return fallback or "unknown"


class Recorder:
    """The spans of the last `ITEMS_KEPT` items, and the item open on each
    thread. While any item is open the sync warnings are counted."""

    def __init__(self):
        self.items = collections.deque(maxlen=ITEMS_KEPT)
        self.ids = itertools.count()
        self.local = threading.local()
        self.lock = threading.Lock()
        self.open_items = 0
        self.saved = None   # (catch_warnings, sync debug mode) while items are open

    def current(self) -> Item | None:
        return getattr(self.local, "item", None)

    def enter(self, name: str) -> Span:
        item = self.current()
        if item is None:
            item = self.local.item = Item(next(self.ids))
            self.count_waits(+1)
        span = Span(name, item.open[-1].name if item.open else None)
        if on_card():
            span.start, span.end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            span.start.record()
        item.spans.append(span)
        item.open.append(span)
        return span

    def exit(self, span: Span) -> None:
        if span.end is not None:
            span.end.record()
        item = self.local.item
        item.open.pop()   # spans close innermost first: they are `with` blocks
        if not item.open:
            self.local.item = None
            self.items.append(item)
            self.count_waits(-1)

    def count_waits(self, delta: int) -> None:
        """Open (+1) or close (-1) an item: the first open turns the sync
        warnings on and counts them, the last close restores both."""
        with self.lock:
            self.open_items += delta
            if delta > 0 and self.open_items == 1:
                filters = warnings.catch_warnings()
                filters.__enter__()
                warnings.filterwarnings("always", message=SYNC_WARNING)
                warnings.showwarning = self.showwarning_of(warnings.showwarning)
                mode = None
                if on_card():
                    mode = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("warn")
                self.saved = (filters, mode)
            elif delta < 0 and self.open_items == 0:
                filters, mode = self.saved
                self.saved = None
                if mode is not None:
                    torch.cuda.set_sync_debug_mode(mode)
                filters.__exit__(None, None, None)

    def showwarning_of(self, shown):
        def showwarning(message, category, filename, lineno, file=None, line=None):
            if not str(message).startswith(SYNC_WARNING):
                shown(message, category, filename, lineno, file, line)
                return
            item = self.current()
            if item is not None and item.open:
                item.open[-1].waits.append(port_site())

        return showwarning

    def read(self) -> list:
        out = []
        for item in list(self.items):
            spans = []
            for s in item.spans:
                if s.end is not None:   # resolved once, after the fact
                    s.end.synchronize()
                    s.device_ms, s.start, s.end = s.start.elapsed_time(s.end), None, None
                spans.append({"name": s.name, "parent": s.parent, "device_ms": s.device_ms,
                              "syncs": len(s.waits), "waits": list(s.waits)})
            out.append({"id": item.id, "name": spans[0]["name"], "syncs": sum(s["syncs"] for s in spans),
                        "spans": spans})
        return out

    def clear(self) -> None:
        self.items.clear()


RECORDER = Recorder()


def recorded_items() -> list:
    """The kept items, oldest first: {'id', 'name' (its first span's),
    'syncs' (its blocking waits), 'spans': [{'name', 'parent', 'device_ms'
    (None without CUDA events), 'syncs', 'waits' (their `file:line`)}]}, the
    spans in the order they opened. Waits for the spans' end events."""
    return RECORDER.read()


class annotate:
    """The port's span `name`: a `record_function` range, and while a
    profiler records, an entry of the recorder (see the module docstring)."""

    __slots__ = ("name", "range", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        self.span = RECORDER.enter(self.name) if recording() else None
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            RECORDER.exit(self.span)
        self.range.__exit__(*exc)
        return False


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
