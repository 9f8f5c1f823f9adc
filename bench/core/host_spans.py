"""The program's own spans in a traced span, read against the device's idle
time: what the host was doing in every gap of the device.

The program records each of its spans (``engine/*``, ``serve/*``,
``train/*``: ``repro_torch.runtime.telemetry``) as a function-scope event
in a running ``torch.profiler``'s trace, on the profiler's clock with the
kernels; such an event has no device-side copy, so the device events of
``trace.reduce`` are those of a run without spans.  A span whose name ends
in ``_wait`` is one in which the host waits for the device (a read of a
step's tokens, a synchronisation): a gap of the device under it is the
device's own (the gaps between a graph's kernels), a gap under any other
span, or under none, is the host's.

Two readers, on plain lists (``program_spans`` takes them from a
profiler): :func:`idle_split` puts each idle piece of the traced span down
to the innermost span open on the host over it, and :func:`per_step` sums
a named span inside each step the profiler recorded whole.  Times are the
profiler's microseconds."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

PREFIXES = ("engine/", "serve/", "train/")
#: the name a piece of idle time takes where no program span was open
OUTSIDE = "outside"
WAIT_SUFFIX = "_wait"


@dataclasses.dataclass
class HostSpan:
    name: str
    start: float  # us, the profiler's clock
    end: float


def program_spans(prof) -> List[HostSpan]:
    """The program's spans in a profiler's trace: its CPU-side events whose
    names start with :data:`PREFIXES`, by start (a parent before the spans
    it holds)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    spans = [HostSpan(e.name, float(e.time_range.start), float(e.time_range.end))
             for e in prof.events()
             if getattr(e, "device_type", None) == cpu and e.name.startswith(PREFIXES)]
    return sorted(spans, key=lambda s: (s.start, -s.end))


def innermost(spans: Sequence[HostSpan]) -> List[Tuple[float, float, str]]:
    """Disjoint ``(start, end, name)`` pieces of the time under any span,
    each named by the innermost span open over it.  Spans nest (a span
    ends no later than the one holding it; a child cut at its parent's end
    where rounding says otherwise)."""
    pieces: List[Tuple[float, float, str]] = []
    stack: List[List] = []  # [name, end, cursor]: open spans, innermost last

    def close_until(t: float) -> None:
        while stack and stack[-1][1] <= t:
            name, end, cursor = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, name))
            if stack:
                stack[-1][2] = max(stack[-1][2], end)

    for sp in sorted(spans, key=lambda s: (s.start, -s.end)):
        close_until(sp.start)
        end = sp.end
        if stack:
            parent = stack[-1]
            end = min(end, parent[1])
            if sp.start > parent[2]:
                pieces.append((parent[2], sp.start, parent[0]))
            parent[2] = max(parent[2], sp.start)
        stack.append([sp.name, end, sp.start])
    close_until(float("inf"))
    return sorted(pieces)


def idle_intervals(events, start: float, end: float) -> List[Tuple[float, float]]:
    """The pieces of ``[start, end]`` in which no device event (anything
    with ``start`` and ``end``) ran."""
    out, t = [], start
    for e in sorted(events, key=lambda e: e.start):
        if e.start > t:
            out.append((t, min(e.start, end)))
        t = max(t, e.end)
        if t >= end:
            return out
    if t < end:
        out.append((t, end))
    return out


def idle_split(events, spans: Sequence[HostSpan], start: float, end: float) -> Dict[str, float]:
    """Idle device time (us) of ``[start, end]`` by the innermost program
    span open on the host over it; :data:`OUTSIDE` where none was.  With
    ``trace.Summary.events`` (markers left out, as in its busy time) and
    the traced span ``[0, window]``, the parts add up to its idle time."""
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]
    out: Dict[str, float] = {}
    for a, b in idle_intervals(events, start, end):
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            lo, hi = max(pieces[i][0], a), min(pieces[i][1], b)
            if hi > lo:
                out[pieces[i][2]] = out.get(pieces[i][2], 0.0) + (hi - lo)
                covered += hi - lo
            i += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered)
    return out


def waiting_us(split: Dict[str, float]) -> float:
    """The idle time under a ``*_wait`` span: the device's own gaps."""
    return sum(v for k, v in split.items() if k.endswith(WAIT_SUFFIX))


def host_us(split: Dict[str, float]) -> float:
    """The idle time under any other span or under none: the host's."""
    return sum(v for k, v in split.items() if not k.endswith(WAIT_SUFFIX))


def covered_us(spans: Sequence[HostSpan], start: float, end: float) -> float:
    """The time of ``[start, end]`` under some program span."""
    return sum(max(min(b, end) - max(a, start), 0.0) for a, b, _ in innermost(spans))


def per_step(spans: Sequence[HostSpan], outer: str, inner: str,
             last: Optional[str] = None) -> List[float]:
    """For each ``outer`` span the profiler recorded whole, the summed wall
    (us) of the ``inner`` spans inside it.  A step opened before the
    profiler started is not in the trace; one still open when it stopped
    ends at the stop, cut: where ``last`` is given, a step counts only if
    a ``last`` span (its final phase) lies inside it."""
    out = []
    for o in (s for s in spans if s.name == outer):
        inside = [s for s in spans if s is not o and o.start <= s.start and s.end <= o.end]
        if last is not None and not any(s.name == last for s in inside):
            continue
        out.append(sum(s.end - s.start for s in inside if s.name == inner))
    return out
