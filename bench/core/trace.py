"""The device trace of a fixed span of steady steps in mid-window, and its
reduction: busy and idle time, kernels by name, and the kernels of each
step, told apart by marker kernels launched around each step.

A run with ``--trace 1`` starts ``torch.profiler`` at a step boundary,
launches a marker (``torch.cuda._sleep(0)``, a ``spin_kernel`` that no
program launches) before and after each step it records, and stops after
a fixed number of steps, once the device is synchronised.  The full trace
is never exported."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"
#: decode steps a traced span records: enough to average a step's kernels,
#: few enough that CUPTI keeps every record (~8,000 kernels a step)
TRACE_STEPS = 8
_NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start: float  # us, the profiler's clock
    end: float


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    events: List[DeviceEvent]  # markers left out
    steps: List[Tuple[str, List[DeviceEvent]]]  # (kind, its kernels) in order
    gaps: List[Tuple[str, float]]  # (where, seconds), longest first
    markers_ok: bool

    def kernels(self, *parts: str, kind: Optional[str] = None) -> Tuple[float, int]:
        """(device seconds, calls) of the kernels whose name holds every
        part; with ``kind`` only those inside steps of that kind."""
        pool = (self.events if kind is None
                else [e for k, evs in self.steps if k == kind for e in evs])
        hit = [e for e in pool if all(p in e.name for p in parts)]
        return sum(e.end - e.start for e in hit) / 1e6, len(hit)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for e in self.events:
            by[e.name] = by.get(e.name, 0.0) + (e.end - e.start) / 1e6
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class StepTracer:
    """Profiles ``n_steps`` steps of one kind (and whatever runs between
    them): ``begin`` before the first, ``mark`` around every step recorded
    while it runs, ``summary`` after ``end``."""

    def __init__(self, step_kind: str, n_steps: int = TRACE_STEPS):
        self.n_steps = int(n_steps)
        self.step_kind = step_kind
        self.kinds: List[str] = []
        self.prof = None
        self.done_steps = 0
        self.t0 = self.t1 = 0.0
        self.overhead_s = 0.0  # host time spent starting and stopping the profiler

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.t1

    @property
    def finished(self) -> bool:
        return bool(self.t1)

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.overhead_s += self.t0 - t

    def mark(self, kind: str) -> None:
        """A marker on the stream; call it right before and right after
        each step."""
        torch.cuda._sleep(0)
        self.kinds.append(kind)

    def step_done(self, kind: str) -> None:
        if kind == self.step_kind:
            self.done_steps += 1
        if self.done_steps >= self.n_steps:
            self.end()

    def end(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.overhead_s += time.perf_counter() - self.t1

    def summary(self) -> Summary:
        return reduce(self.prof, self.kinds, self.t1 - self.t0)


def reduce(prof, kinds: List[str], window_s: float) -> Summary:
    """``kinds`` holds one entry per marker (:meth:`StepTracer.mark`): two
    per recorded step, before it and after it."""
    import bisect

    dev = torch.autograd.DeviceType.CUDA
    evs = sorted((DeviceEvent(e.name, float(e.time_range.start), float(e.time_range.end))
                  for e in prof.events() if getattr(e, "device_type", None) == dev),
                 key=lambda e: e.start)
    markers = [e for e in evs if MARKER in e.name]
    events = [e for e in evs if MARKER not in e.name]
    # a lost record (CUPTI drops some under load) shows as a missing marker
    markers_ok = len(markers) == len(kinds) and len(kinds) % 2 == 0
    steps: List[Tuple[str, List[DeviceEvent]]] = []
    marks: List[Tuple[float, str]] = []
    if markers_ok:
        starts = [e.start for e in events]
        for i in range(len(markers) // 2):
            kind, lo, hi = kinds[2 * i], markers[2 * i].end, markers[2 * i + 1].start
            inside = events[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]
            steps.append((kind, [e for e in inside if not e.name.startswith(_NOT_KERNELS)]))
            marks += [(lo, f"in {kind}"), (hi, f"after {kind}")]
    mark_t = [t for t, _ in marks]
    busy, gaps, last_end = 0.0, [], None
    for e in events:
        if last_end is not None and e.start > last_end:
            i = bisect.bisect_right(mark_t, last_end) - 1
            gaps.append((marks[i][1] if i >= 0 else "before the first step",
                         (e.start - last_end) / 1e6))
        if last_end is None or e.start >= last_end:
            busy += e.end - e.start
            last_end = e.end
        elif e.end > last_end:
            busy += e.end - last_end
            last_end = e.end
    gaps.sort(key=lambda g: -g[1])
    return Summary(window_s=window_s, busy_s=busy / 1e6, events=events, steps=steps,
                   gaps=gaps, markers_ok=markers_ok)


def idle_gaps(summary: Summary, n: int = 10) -> List[List]:
    """The longest idle gaps summed by what the host was doing: the kind of
    step the gap followed."""
    by: Dict[str, float] = {}
    for where, s in summary.gaps:
        by[where] = by.get(where, 0.0) + s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
