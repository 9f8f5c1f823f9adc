"""The program's spans against the device's idle time, on a made-up
profiler timeline: the span events are the program's (CPU-side, named
``engine/...``, ``train/...``) beside the kernels and markers of
``trace.reduce``."""

from types import SimpleNamespace

import pytest
import torch

from bench.core import host_spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _prof(device_events, cpu_events=()):
    """A profiler whose ``events()`` are the given ``(name, start, end)``
    on the device and on the host."""
    def ev(dev, n, a, b):
        return SimpleNamespace(name=n, device_type=dev, time_range=SimpleNamespace(start=a, end=b))

    return SimpleNamespace(events=lambda: [ev(CUDA, *e) for e in device_events]
                           + [ev(CPU, *e) for e in cpu_events])


M = trace.MARKER
#: two decode steps over 0..100 us; the device runs a graph's kernels with
#: a gap of its own (31..33) while the host waits, and is idle while the
#: host works between the steps
DEVICE = [(M, 2, 3), ("k1", 10, 20), ("k2", 20, 31), ("k3", 33, 40), (M, 41, 42),
          (M, 62, 63), ("k4", 65, 90), (M, 91, 92)]
SPANS = [
    ("engine/decode_step", 5, 45), ("engine/decode_prep", 5, 8), ("engine/decode_launch", 8, 12),
    ("engine/decode_wait", 12, 41), ("engine/decode_post", 41, 45),
    ("engine/yield", 46, 50), ("engine/admit", 50, 55),
    ("engine/decode_step", 58, 95), ("engine/decode_prep", 58, 64),
    ("engine/decode_launch", 64, 66), ("engine/decode_wait", 66, 91),
    ("engine/decode_post", 91, 95),
    ("aten::copy_", 6, 7),  # not the program's
]
WINDOW_US = 100.0


def _spans():
    return host_spans.program_spans(_prof(DEVICE, SPANS))


def test_the_program_spans_are_the_host_events_with_the_programs_names():
    spans = _spans()
    assert [s.name for s in spans][:3] == ["engine/decode_step", "engine/decode_prep",
                                           "engine/decode_launch"]
    assert len(spans) == len(SPANS) - 1
    assert all(s.name.startswith(host_spans.PREFIXES) for s in spans)


def test_span_events_on_the_host_leave_the_reduction_of_the_device_trace_as_it_was():
    kinds = ["decode"] * 4
    bare = trace.reduce(_prof(DEVICE), kinds, WINDOW_US / 1e6)
    spanned = trace.reduce(_prof(DEVICE, SPANS), kinds, WINDOW_US / 1e6)
    assert spanned == bare


def test_innermost_names_each_piece_by_the_deepest_open_span():
    spans = [host_spans.HostSpan(*s) for s in [("a", 0, 10), ("b", 2, 5), ("c", 6, 8),
                                                ("d", 6, 7), ("e", 12, 15)]]
    assert host_spans.innermost(spans) == [(0, 2, "a"), (2, 5, "b"), (5, 6, "a"), (6, 7, "d"),
                                           (7, 8, "c"), (8, 10, "a"), (12, 15, "e")]
    assert host_spans.covered_us(spans, 1, 13) == pytest.approx(10)


def _device_events():
    """The reduction's device events: the markers left out, as in its busy
    time."""
    return trace.reduce(_prof(DEVICE), ["decode"] * 4, WINDOW_US / 1e6).events


def test_idle_gaps_split_by_the_innermost_span_and_waiting_plus_host_is_idle():
    split = host_spans.idle_split(_device_events(), _spans(), 0.0, WINDOW_US)
    assert split == pytest.approx({
        host_spans.OUTSIDE: 5 + 1 + 3 + 5,  # 0-5, 45-46, 55-58, 95-100
        "engine/decode_prep": 3 + 6,  # 5-8, 58-64
        "engine/decode_launch": 2 + 1,  # 8-10, 64-65
        "engine/decode_wait": 2 + 1 + 1,  # the graph's own gap 31-33; 40-41, 90-91
        "engine/decode_post": 4 + 4,  # 41-45, 91-95
        "engine/yield": 4,
        "engine/admit": 5,
    })
    summary = trace.reduce(_prof(DEVICE, SPANS), ["decode"] * 4, WINDOW_US / 1e6)
    idle_us = 1e6 * (summary.window_s - summary.busy_s)
    assert host_spans.waiting_us(split) == pytest.approx(4)
    assert host_spans.waiting_us(split) + host_spans.host_us(split) == pytest.approx(idle_us)


def test_a_step_counts_only_where_the_profiler_recorded_it_whole():
    spans = _spans() + [
        # a step's phases whose step was opened before the profiler started
        host_spans.HostSpan("engine/decode_prep", -3, -2),
        # a step still open when the profiler stopped: cut at the stop
        host_spans.HostSpan("engine/decode_step", 96, 100),
        host_spans.HostSpan("engine/decode_prep", 96, 97),
    ]
    prep = host_spans.per_step(spans, "engine/decode_step", "engine/decode_prep",
                               last="engine/decode_post")
    assert prep == [pytest.approx(3), pytest.approx(6)]
    assert len(host_spans.per_step(spans, "engine/decode_step", "engine/decode_prep")) == 3


def test_the_readers_find_nothing_where_the_run_recorded_no_span():
    assert host_spans.program_spans(_prof(DEVICE)) == []
    # busy 10-31, 33-40, 65-90: 53 of 100 us
    assert host_spans.idle_split(_device_events(), [], 0.0, WINDOW_US) == \
        pytest.approx({host_spans.OUTSIDE: 47})
    assert host_spans.per_step([], "train/step", "train/forward") == []
    assert host_spans.covered_us([], 0.0, WINDOW_US) == 0.0
