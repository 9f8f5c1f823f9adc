"""What a traced run's host-clock readers may use: the profiler holds the
host while it starts and stops and slows the steps it records, so they
read only what came before it (the requests due, and the steps begun,
before it started) and the calls it did not record."""

from __future__ import annotations

from typing import Dict, List


def engine_records(run) -> List[Dict]:
    recs = run.obs.get("records") or []
    t = run.obs.get("t_trace")
    if t is None:
        return recs
    t0 = run.obs["t0"]
    return [x for x in recs if t0 + x["arrival"] < t]


def decode_steps(run):
    """``(host span, work entry)`` of every untraced engine decode step
    begun before the profiler started."""
    spans = run.obs.get("spans", {}).get("decode") or []
    work = [w for w in run.obs.get("work", []) if w[0] == "decode"]
    out = [(s, w) for s, w in zip(spans, work) if not w[1]]
    if run.obs.get("t_trace") is not None:
        out = [(s, w) for s, w in out if w[2]["t"] < run.obs["t_trace"]]
    return out


def batch_calls(run) -> List[Dict]:
    return [c for c in run.obs.get("calls") or [] if not c["traced"]]


def train_steps(run) -> List[Dict]:
    """The training steps begun before the profiler started (all of them in
    a run without it)."""
    steps = run.obs.get("steps") or []
    t = run.obs.get("t_trace")
    return [x for x in steps if t is None or x["start"] < t]
