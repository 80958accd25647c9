"""Opt-in timing of the render and training paths, in two modes, both off
by default (a `stage` is then a no-op).

- Fenced stage totals (`start` / `stop`): each stage synchronises the
  device at its start and end, so its seconds are the device work of
  that stage, summed per stage name.
- Spans (`start_spans` / `stop_spans`): every `stage` and every `span`
  is recorded in memory with its name, id, parent, root
  (one per training step or served view, shared by all its spans) and
  thread, and its host start and end. No fence, no CUDA event, no device
  work: the host's launch order as it runs untraced. The times are on the
  `time.time_ns()` clock, which is the clock of the profiler's events
  (`kineto_results.trace_start_ns()` + an event's `time_range`), so a
  span can be laid over a device trace of the same window.

Counters are kept at the same boundaries in span mode: `host_syncs`, one
per `sync.<site>` span (a place where the host blocks on the device), and the
totals given to `count`: `instances`, the rows binning made, added to on
the device and read once, when the window stops; `light_builds`, one per
prefiltered light, on the host.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Union

import torch

_totals: Optional[Dict[str, float]] = None
_rec: Optional["_Recorder"] = None


def start() -> None:
    global _totals
    _totals = {}


def stop() -> Dict[str, float]:
    """Turn timing off and return the seconds per stage since `start`."""
    global _totals
    out, _totals = _totals or {}, None
    return out


@contextlib.contextmanager
def suspended():
    """Leave the work inside the block out of the stage totals."""
    global _totals
    saved, _totals = _totals, None
    try:
        yield
    finally:
        _totals = saved


@contextlib.contextmanager
def stage(name: str, device: torch.device):
    if _totals is None:
        if _rec is None:
            yield
            return
        with span(name):
            yield
        return
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: 0)
    sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(device)
        _totals[name] = _totals.get(name, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    name: str
    id: int
    parent: int          # 0: none
    root: int            # the id of the outermost span of its step or view
    thread: int          # threading.get_native_id() of the opening thread
    start_ns: int        # time.time_ns() clock
    end_ns: int


class Records(NamedTuple):
    spans: List[Span]            # in the order they closed
    counters: Dict[str, int]     # host_syncs and each `count` total


class _Open(NamedTuple):
    name: str
    id: int
    parent: int
    root: int
    start: int           # perf_counter_ns


class _Recorder:
    """One window's spans. Each thread has its own stack of open spans;
    a span opened with an empty stack on another thread than the one in
    `backward` (CUDA autograd runs a backward on its worker thread) takes
    as parent the innermost span open on the thread in `backward`."""

    def __init__(self):
        # one anchor pair: perf_counter_ns -> time_ns for the whole window
        self.wall0 = time.time_ns()
        self.pc0 = time.perf_counter_ns()
        self.ids = itertools.count(1)
        self.stacks: Dict[int, List[_Open]] = {}
        self.native: Dict[int, int] = {}
        self.closed: list = []
        self.backward: Optional[List[_Open]] = None
        self.device: Dict[str, Union[torch.Tensor, int]] = {}

    def open(self, name: str) -> _Open:
        tid = threading.get_ident()
        stack = self.stacks.get(tid)
        if stack is None:
            stack = self.stacks[tid] = []
            self.native[tid] = threading.get_native_id()
        if stack:
            up = stack[-1]
        elif self.backward:
            up = self.backward[-1]
        else:
            up = None
        i = next(self.ids)
        s = (_Open(name, i, up.id, up.root, time.perf_counter_ns()) if up
             else _Open(name, i, 0, i, time.perf_counter_ns()))
        stack.append(s)
        if name == "backward":
            self.backward = stack
        return s

    def close(self, s: _Open) -> None:
        end = time.perf_counter_ns()
        tid = threading.get_ident()
        self.stacks[tid].pop()
        self.closed.append((s, self.native[tid], end))

    def records(self) -> Records:
        at = lambda pc: self.wall0 + pc - self.pc0
        spans = [Span(s.name, s.id, s.parent, s.root, thread, at(s.start),
                      at(end)) for s, thread, end in self.closed]
        counters = {"host_syncs": sum(s.name.startswith("sync.")
                                      for s in spans)}
        counters.update({k: int(v) for k, v in self.device.items()})
        return Records(spans, counters)


def start_spans() -> None:
    """Record spans (and counters) from now until `stop_spans`."""
    global _rec
    _rec = _Recorder()


def stop_spans() -> Records:
    """Turn span recording off and return what it recorded. Reads the
    device counters: the one host sync of the window, after it."""
    global _rec
    rec, _rec = _rec, None
    return rec.records() if rec is not None else Records([], {})


@contextlib.contextmanager
def span(name: str):
    """A span named `name` in span mode; nothing otherwise. A span named
    `sync.<site>` encloses one place where the host blocks on the device
    and counts one host sync."""
    rec = _rec
    if rec is None:
        yield
        return
    s = rec.open(name)
    try:
        yield
    finally:
        rec.close(s)


def spanned(name: str):
    """Decorator: each call of the function is a span `name` (span mode
    only)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _rec is None:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value: Union[torch.Tensor, int]) -> None:
    """Add `value` to the counter `name` (span mode only): a device scalar
    is added on its device, with no host read until `stop_spans`; an int
    on the host, with no device work."""
    rec = _rec
    if rec is None:
        return
    cur = rec.device.get(name)
    if cur is None:
        rec.device[name] = (value.to(torch.int64, copy=True)
                            if torch.is_tensor(value) else int(value))
    elif torch.is_tensor(cur):
        cur.add_(value)
    else:
        rec.device[name] = cur + value
