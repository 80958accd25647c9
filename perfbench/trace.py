"""The windows of a `--trace 1` run, one after the other and never one
for two readings:

- a window with neither the profiler nor the stage timer, for a step's
  plain time;
- the program's sync-fenced stage timer's window (`utils/timing`);
- the device window: the profiler recording device activity only (no
  host operator events, which slow a host-bound step), for the device's
  busy time, the launches and each kernel's device time;
- the host window: the profiler recording host operators as well, read
  only for the idle gaps of the breakdown, by what the host was doing;
- after those four, the program's span windows A and B (`spans.py`),
  which the span metrics read; skipped where the program has no span
  mode.

What the per-layer readers (`metrics/*.py`) read is a `TraceData`."""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import spans
from .loops import sync


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_us: float
    dur_us: float


@dataclasses.dataclass
class HostEvent:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class TraceData:
    steps: int                         # steps or views in each window
    window_s: float                    # the device window's host time
    device: List[DeviceEvent]          # the device window's operations
    gaps: Dict[str, float] = dataclasses.field(default_factory=dict)
    #                                    idle seconds by host operation,
    #                                    from the host window
    stage_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_s: float = 0.0                # a step's seconds, neither profiled
    #                                    nor fenced
    inputs: object = None              # what the work counts are taken on
    #                                    (`work.Inputs`)
    cache: Dict = dataclasses.field(default_factory=dict)   # work's walks
    spans: Optional["spans.SpanData"] = None   # windows A and B; None
    #                                    without the program's span mode

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of
        their intervals)."""
        busy, end = 0.0, float("-inf")
        for e in sorted(self.device, key=lambda e: e.start_us):
            s, t = e.start_us, e.start_us + e.dur_us
            if t > end:
                busy += t - max(s, end)
                end = t
        return busy * 1e-6

    @property
    def launches(self) -> int:
        return len(self.device)

    def kernel_ms(self, name: str) -> List[float]:
        """Each launch's device milliseconds of the kernel function
        `<name>_kernel` (any template instance), in launch order."""
        pat = re.compile(r"(^|[\s:])" + re.escape(name) + r"_kernel[<(]")
        return [e.dur_us * 1e-3 for e in sorted(self.device,
                                                key=lambda e: e.start_us)
                if pat.search(e.name)]

    def stages(self, *names: str) -> Optional[float]:
        """Milliseconds per step of the named stages; None if none ran."""
        got = [self.stage_ms[n] for n in names if n in self.stage_ms]
        return sum(got) if got else None

    def breakdown(self) -> Dict:
        """The ten device operations that took most time (device window)
        and the ten longest idle gaps summed by what the host was doing
        (host window)."""
        ops: Dict[str, float] = {}
        for e in self.device:
            ops[e.name] = ops.get(e.name, 0.0) + e.dur_us * 1e-6
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(self.gaps)}


def idle_gaps(device: List[DeviceEvent], host: List[HostEvent]
              ) -> Dict[str, float]:
    """Seconds in which no device operation ran, summed by what the host
    was doing: the first host operation that began in the gap, or the
    one it fell in."""
    gaps: Dict[str, float] = {}
    dev = sorted(device, key=lambda e: e.start_us)
    host = sorted(host, key=lambda h: h.start_us)
    starts = [h.start_us for h in host]
    end = dev[0].start_us + dev[0].dur_us if dev else 0.0
    for e in dev[1:]:
        if e.start_us > end:
            key = _host_name(host, starts, end, e.start_us)
            gaps[key] = gaps.get(key, 0.0) + (e.start_us - end) * 1e-6
        end = max(end, e.start_us + e.dur_us)
    return gaps


def _host_name(host, starts, a: float, b: float) -> str:
    i = bisect.bisect_left(starts, a)
    if i < len(host) and host[i].start_us < b:
        return host[i].name
    for h in reversed(host[max(0, i - 64):i]):
        if h.end_us >= (a + b) / 2:
            return h.name
    return "host"


def _is_device(e) -> bool:
    dt = getattr(e, "device_type", None)
    return dt is not None and str(dt).endswith("CUDA")


def profile(fn: Callable, dev, host: bool = False
            ) -> Tuple[float, List[DeviceEvent], List[HostEvent], object]:
    """Run fn() under torch.profiler: the window's seconds, every device
    operation (kernels, copies, sets), the host's operator calls (with
    `host` only; without it the profiler records device activity alone)
    and fn()'s result."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    cuda = torch.device(dev).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    sync(dev)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync(dev)
        window = time.perf_counter() - t0
    device, ops = [], []
    for e in prof.events():
        rng = e.time_range
        if _is_device(e):
            device.append(DeviceEvent(e.name, rng.start, rng.end - rng.start))
        elif host and (e.name.startswith("aten::")
                       or e.name.startswith("cuda")):
            ops.append(HostEvent(e.name, rng.start, rng.end))
    return window, device, ops, result


def plain_window(fn: Callable, steps: int, dev) -> Tuple[float, object]:
    """Seconds per step of fn() (`steps` steps) with neither the profiler
    nor the stage timer on, and fn()'s result."""
    sync(dev)
    t0 = time.perf_counter()
    result = fn()
    sync(dev)
    return (time.perf_counter() - t0) / steps, result


def stage_window(timing, fn: Callable, steps: int, dev
                 ) -> Tuple[Dict[str, float], object]:
    """The program's stage timer over fn(): milliseconds per step of
    each stage, and fn()'s result."""
    sync(dev)
    timing.start()
    try:
        result = fn()
        sync(dev)
    finally:
        totals = timing.stop()
    return {k: v * 1e3 / steps for k, v in totals.items()}, result


def windows(run: Callable, n: int, timing, dev, inputs: Callable
            ) -> Tuple[TraceData, list]:
    """The four windows over steps (or views) 0 .. 4n - 1 of `run(i0, n)`,
    n in each, then the span windows A and B over steps 4n .. 6n - 1, and
    the results of all of them, in order; `inputs(i0)` takes the inputs
    of step i0 as they stand, for the work counts of the device window's
    first step. The plain window comes first, before the profiler has
    traced the device: run after it, it read a view ~11 ms slower than an
    untraced run did (PERF.md, section 6). Window A runs after two
    profiled windows all the same, so its host times may read high."""
    step_s, r0 = plain_window(lambda: run(0, n), n, dev)
    stage_ms, r1 = stage_window(timing, lambda: run(n, n), n, dev)
    first = inputs(2 * n)
    window, device, _, r2 = profile(lambda: run(2 * n, n), dev)
    _, hdev, host, r3 = profile(lambda: run(3 * n, n), dev, host=True)
    span_data, more = spans.windows(run, n, timing, dev, 4 * n)
    data = TraceData(steps=n, window_s=window, device=device,
                     gaps=idle_gaps(hdev, host), stage_ms=stage_ms,
                     step_s=step_s, inputs=first, spans=span_data)
    return data, [r0, r1, r2, r3] + more
