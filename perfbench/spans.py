"""The program's spans in a `--trace 1` run: two windows after trace.py's
four, n steps (or views) each, and what the span metrics (the entries of
BENCHMARK.json's `per_layer` whose `metrics/<name>.py` reads this
module) read of them.

- Window A: the program's span mode (`utils/timing.start_spans`), no
  profiler. Each span's host time, the counters (`host_syncs`,
  `instances`) and a step's time with spans on, which against the plain
  window's is the cost of tracing when on.
- Window B: span mode under the device window's profiler (device
  activity only). Each device operation is put down to a span through
  its launch: the runtime call of the same correlation id, on the clock
  both share (`time.time_ns()`). It goes to the innermost span open on
  the launching thread at that time, failing that to the innermost span
  open on any thread (a backward's worker thread opens its spans under
  `backward`). Each idle gap goes to the span the main thread was in when
  the gap opened (`idle_by_span`): read for the breakdown only, since
  the profiler's 6-12 us a launch widens a host-bound step's gaps.

`trace.windows` runs both after its four in every `--trace 1` run.
`python3 perfbench/spans.py --workload <cell> --seed <n>` runs the
cell's `--trace 1` run with `alternated`'s windows after those six and
prints its result line with a `spans` report besides. Without the
program's span mode (`start_spans`) the windows are skipped and every
span metric reads nothing."""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Op:
    """A device operation of window B and the launch it came from."""
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int] = None
    thread: Optional[int] = None       # the launching thread, as kineto
    span: Optional[object] = None      # its innermost span (timing.Span)


@dataclasses.dataclass
class SpanData:
    steps: int                     # steps or views in each window
    step_s: float                  # window A: a step's seconds
    host: List                     # window A's spans (timing.Span)
    counters: Dict[str, int]       # window A's counters
    spans: List                    # window B's spans
    ops: List[Op]                  # window B's device operations
    calls: List[int]               # window B's launch times (time_ns)

    def __post_init__(self):
        self.by_id = {s.id: s for s in self.spans}
        self.main = _main_thread(self.spans)
        attribute(self.ops, self.spans)

    def chain(self, s) -> List[str]:
        """The names of s and of every span above it."""
        out = []
        while s is not None:
            out.append(s.name)
            s = self.by_id.get(s.parent)
        return out


def _main_thread(spans) -> Optional[int]:
    roots = [s for s in spans if s.parent == 0]
    return roots[0].thread if roots else None


# ---------------------------------------------------------------------------
# Attribution
# ---------------------------------------------------------------------------

class _Index:
    """Spans by start time, for the innermost span open at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
        self.starts = [s.start_ns for s in self.spans]

    def innermost(self, t: int, thread=None):
        """The span open at t (on `thread`, if given) that opened last."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            s = self.spans[i]
            if s.end_ns >= t and (thread is None or s.thread == thread):
                return s
        return None


def attribute(ops: List[Op], spans) -> None:
    """Set each op's span: the innermost span open at its launch on the
    launching thread, failing that on any thread. Ops without a launch,
    or launched outside every span, keep None."""
    index = _Index(spans)
    threads = {s.thread for s in spans}
    for op in ops:
        if op.launch_ns is None:
            continue
        s = None
        if op.thread in threads:
            s = index.innermost(op.launch_ns, op.thread)
        op.span = s or index.innermost(op.launch_ns)


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds covered by the union of [start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(ops: List[Op]) -> List[Tuple[int, int]]:
    """The device's idle intervals between its first and last op."""
    out, end = [], None
    for op in sorted(ops, key=lambda o: o.start_ns):
        if end is not None and op.start_ns > end:
            out.append((end, op.start_ns))
        end = op.end_ns if end is None else max(end, op.end_ns)
    return out


# ---------------------------------------------------------------------------
# Readings (per step or view; None without spans)
# ---------------------------------------------------------------------------

def of(t) -> Optional[SpanData]:
    """The SpanData of a TraceData, or None if the run had no spans."""
    d = getattr(t, "spans", None)
    return d if d is not None and d.spans else None


def device_ms(t, *names: str) -> Optional[float]:
    """Device-busy ms per step of the ops under any span named `names`
    (the union of their intervals)."""
    d = of(t)
    if d is None:
        return None
    want = set(names)
    iv = [(o.start_ns, o.end_ns) for o in d.ops
          if o.span is not None and want & set(d.chain(o.span))]
    return union_ns(iv) * 1e-6 / d.steps


def host_issue_ms(t, root: str) -> Optional[float]:
    """Window A: host ms per `root` span, less the time in its sync.*
    spans."""
    d = of(t)
    if d is None:
        return None
    roots = [s for s in d.host if s.name == root]
    if not roots:
        return None
    ids = {s.id for s in roots}
    syncs = sum(s.end_ns - s.start_ns for s in d.host
                if s.root in ids and s.name.startswith("sync."))
    return (sum(s.end_ns - s.start_ns for s in roots) - syncs) * 1e-6 / \
        len(roots)


def counter(t, name: str) -> Optional[float]:
    """Window A: the counter `name` per step."""
    d = of(t)
    if d is None or name not in d.counters:
        return None
    return d.counters[name] / d.steps


def sync_idle_ms(t) -> Optional[float]:
    """Device idle ms per step in gaps that open inside a sync.* span, or
    after one ends but before the host's next launch."""
    d = of(t)
    if d is None:
        return None
    calls = sorted(d.calls)
    wins = []
    for s in d.spans:
        if s.name.startswith("sync."):
            i = bisect.bisect_left(calls, s.end_ns)
            wins.append((s.start_ns, calls[i] if i < len(calls)
                         else float("inf")))
    idle = sum(b - a for a, b in gaps(d.ops)
               if any(lo <= a < hi for lo, hi in wins))
    return idle * 1e-6 / d.steps


def idle_by_span(d: SpanData) -> Dict[str, float]:
    """Idle ms per step by the innermost span the main thread was in
    when the gap opened ("none": outside every span)."""
    index = _Index([s for s in d.spans if s.thread == d.main])
    out: Dict[str, float] = {}
    for a, b in gaps(d.ops):
        s = index.innermost(a)
        k = s.name if s else "none"
        out[k] = out.get(k, 0.0) + (b - a) * 1e-6 / d.steps
    return out


def report(d: SpanData, plain_step_s: float,
           pairs: Sequence[Tuple[float, float]] = ()) -> Dict:
    """What PERF.md's breakdown reads: per span name, the device ms of
    the ops it launched itself and its host self time (window A: its
    duration less its children's); the share of the device's busy time
    put down to a span, the ops that were not, the sync sites, the idle
    gaps by span and the cost of tracing when on: window A against the
    plain window, and the median over `alternated`'s pairs."""
    n = d.steps
    per: Dict[str, Dict[str, float]] = {}
    for name in {o.span.name for o in d.ops if o.span is not None}:
        iv = [(o.start_ns, o.end_ns) for o in d.ops
              if o.span is not None and o.span.name == name]
        per.setdefault(name, {})["device_ms"] = union_ns(iv) * 1e-6 / n
    kids: Dict[int, List] = {}
    for s in d.host:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    for s in d.host:
        self_ns = s.end_ns - s.start_ns - union_ns(kids.get(s.id, []))
        e = per.setdefault(s.name, {})
        e["host_self_ms"] = e.get("host_self_ms", 0.0) + self_ns * 1e-6 / n
        e["count"] = e.get("count", 0) + 1 / n
    busy = union_ns([(o.start_ns, o.end_ns) for o in d.ops])
    mine = union_ns([(o.start_ns, o.end_ns) for o in d.ops
                     if o.span is not None])
    loose: Dict[str, float] = {}
    for o in d.ops:
        if o.span is None:
            loose[o.name] = loose.get(o.name, 0.0) + \
                (o.end_ns - o.start_ns) * 1e-6 / n
    syncs: Dict[str, float] = {}
    for s in d.host:
        if s.name.startswith("sync."):
            syncs[s.name] = syncs.get(s.name, 0) + 1 / n
    top = lambda m: dict(sorted(m.items(), key=lambda kv: -kv[1])[:12])
    return {"step_ms_plain": plain_step_s * 1e3,
            "step_ms_spans": d.step_s * 1e3,
            "tracing_cost_pct": 100.0 * (d.step_s / plain_step_s - 1.0)
            if plain_step_s else None,
            "tracing_cost_alternated_pct": statistics.median(
                100.0 * (a / p - 1.0) for p, a in pairs) if pairs else None,
            "alternated_ms": [[p * 1e3, a * 1e3] for p, a in pairs],
            "busy_ms": busy * 1e-6 / n,
            "attributed_pct": 100.0 * mine / busy if busy else None,
            "unattributed_ms": top(loose),
            "syncs_per_step": syncs,
            "idle_by_span_ms": top(idle_by_span(d)),
            "per_span": dict(sorted(per.items())),
            "counters_per_step": {k: v / n for k, v in d.counters.items()}}


# ---------------------------------------------------------------------------
# The windows
# ---------------------------------------------------------------------------

def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def profile_ops(fn: Callable, dev) -> Tuple[List[Op], List[int], object]:
    """Run fn() under the profiler recording device activity only: every
    device operation with its launch (time and thread of the runtime call
    of the same correlation id), every launch's time, and fn()'s
    result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from perfbench.loops import sync
    cuda = torch.device(dev).type == "cuda"
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA] if cuda
                 else [ProfilerActivity.CPU]) as prof:
        result = fn()
        sync(dev)
    events = list(prof.profiler.kineto_results.events())
    ops = [Op(e.name(), e.start_ns(), e.end_ns(), None, None)
           for e in events if _is_device(e)]
    corr = [e.correlation_id() for e in events if _is_device(e)]
    # the CUDA API calls (cuda*, cu*) that launched them
    host = {e.correlation_id(): e for e in events
            if not _is_device(e) and e.name().startswith("cu")}
    calls = []
    for op, c in zip(ops, corr):
        h = host.get(c)
        if h is not None:
            op.launch_ns, op.thread = h.start_ns(), h.start_thread_id()
            calls.append(h.start_ns())
    return ops, calls, result


def windows(run: Callable, n: int, timing, dev, first: int
            ) -> Tuple[Optional[SpanData], list]:
    """Windows A and B over steps first .. first + 2n - 1 of
    `run(i0, n)`, and their results. (None, []) if the program has no
    span mode."""
    from perfbench.loops import sync
    if not hasattr(timing, "start_spans"):
        return None, []
    sync(dev)
    timing.start_spans()
    try:
        t0 = time.perf_counter()
        ra = run(first, n)
        sync(dev)
        step_s = (time.perf_counter() - t0) / n
    finally:
        a = timing.stop_spans()
    timing.start_spans()
    try:
        ops, calls, rb = profile_ops(lambda: run(first + n, n), dev)
    finally:
        b = timing.stop_spans()
    return SpanData(steps=n, step_s=step_s, host=a.spans,
                    counters=a.counters, spans=b.spans, ops=ops,
                    calls=calls), [ra, rb]


# ---------------------------------------------------------------------------
# A cell's --trace 1 run with the cost of tracing
# ---------------------------------------------------------------------------

def alternated(run: Callable, n: int, timing, dev, first: int,
               rounds: int = 3) -> Tuple[List[Tuple[float, float]], list]:
    """The cost of tracing when on, measured apart from the profiler's
    after-effects: `rounds` pairs of a plain window and a span-mode
    window, n steps each, in turn, all after the profiled windows.
    Returns each pair's step seconds (plain, spans) and the results."""
    from perfbench.loops import sync
    from perfbench.trace import plain_window
    pairs, got = [], []
    for r in range(rounds):
        p, rp = plain_window(lambda: run(first + 2 * r * n, n), n, dev)
        timing.start_spans()
        try:
            a, ra = plain_window(lambda: run(first + (2 * r + 1) * n, n), n,
                                 dev)
        finally:
            timing.stop_spans()
        pairs.append((p, a))
        got += [rp, ra]
    sync(dev)
    return pairs, got


@contextlib.contextmanager
def after_the_six(kept: list):
    """Within the block, trace.windows runs `alternated`'s windows after
    its six, where the program has span mode; each (SpanData, the plain
    window's step seconds, the alternated pairs) is appended to
    `kept`."""
    from perfbench import trace
    six = trace.windows

    def more(run, n, timing, dev, inputs):
        data, got = six(run, n, timing, dev, inputs)
        pairs = []
        if data.spans is not None:
            pairs, late = alternated(run, n, timing, dev, 6 * n)
            got = got + late
        kept.append((data.spans, data.step_s, pairs))
        return data, got

    trace.windows = more
    try:
        yield
    finally:
        trace.windows = six


def main(argv=None) -> int:
    import argparse
    from perfbench.run import CACHES, loaded_forbidden, process_start
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    os.environ.update(CACHES)
    import torch
    from perfbench import cells, runner

    cell = cells.load_cell(args.workload, cells.benchmark(kept_out=True))
    if not torch.cuda.is_available():
        print("perfbench.spans: needs a CUDA device. No result.",
              file=sys.stderr)
        return 3
    kept: List = []
    with after_the_six(kept):
        out = runner.run_cell(cell, args.seed, args.seconds, True,
                              torch.device("cuda", 0), started)
    if loaded_forbidden():
        print("perfbench.spans: JAX was loaded. No result.", file=sys.stderr)
        return 4
    if kept and kept[0][0] is not None:
        out["spans"] = report(*kept[0])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from perfbench.spans import main as _main
    sys.exit(_main())
