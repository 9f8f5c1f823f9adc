"""Readers that several per-layer metrics share: kernels per step, a
kernel's roofline share over the traced span, and the whole step's share
of the chip's peak."""

from __future__ import annotations

from typing import List, Optional, Sequence

from . import counts, peaks, untraced


def kernels_per_step(run, kind: str) -> Optional[float]:
    s = run.summary
    if s is None or not s.markers_ok:
        return None
    steps = [evs for k, evs in s.steps if k == kind]
    if not steps:
        return None
    return sum(len(evs) for evs in steps) / len(steps)


def traced_calls(run) -> List[counts.Call]:
    """The kernel calls of the work the traced span held, from its shapes."""
    sh: counts.Shapes = run.obs["shapes"]
    out: List[counts.Call] = []
    if run.obs["kind"] == "engine":
        for kind, traced, info in run.obs["work"]:
            if not traced:
                continue
            if kind in ("decode", "chunk", "prefill"):
                out += counts.step_calls(sh, info["rows"], 0)
            if kind == "decode":
                out += counts.attention_calls(sh, 1, info["packed"])
            elif kind == "chunk":
                out += counts.attention_calls(sh, info["rows"], info["packed"])
        return out
    rows = run.obs["batch"] * run.obs["prompt_len"]
    out += counts.step_calls(sh, rows, rows)  # the prefill's head runs at every position
    for _ in range(run.obs.get("traced_steps", 0)):
        out += counts.step_calls(sh, run.obs["batch"], run.obs["batch"])
    return out


def roofline(run, kernel: str, name_parts: Sequence[str]) -> Optional[float]:
    s = run.summary
    if s is None:
        return None
    device_s, n = s.kernels(*name_parts)
    if not n or device_s <= 0:
        return None
    bound = counts.total(traced_calls(run), kernel)["bound_s"]
    if bound <= 0:
        return None
    return 100.0 * bound / device_s


def engine_mfu(run) -> Optional[float]:
    sh: counts.Shapes = run.obs.get("shapes")
    steps = untraced.decode_steps(run)
    if not steps or sh is None:
        return None
    a, b = counts.model_ops(sh, True)
    ops = sum(a * len(w[2]["ctx"]) + b * sum(w[2]["ctx"]) for _, w in steps)
    return 100.0 * ops / sum(s for s, _ in steps) / peaks.INT8_OPS_PER_S


def batch_mfu(run) -> Optional[float]:
    sh: counts.Shapes = run.obs.get("shapes")
    calls = untraced.batch_calls(run)
    if not calls or sh is None:
        return None
    plen, gen = run.obs["prompt_len"], run.obs["gen"]
    per_seq = sum(counts.model_ops_per_token(sh, t + 1, t == plen - 1) for t in range(plen))
    per_seq += sum(counts.model_ops_per_token(sh, plen + i + 1, True) for i in range(gen - 1))
    ops = per_seq * run.obs["batch"] * len(calls)
    return 100.0 * ops / sum(c["end"] - c["start"] for c in calls) / peaks.INT8_OPS_PER_S


def train_mfu(run) -> Optional[float]:
    """The training steps begun before the profiler started (each ends by
    then: it synchronises first), or all of them: the model's operations
    times 3 (forward, and the backward's two products a matrix) for every
    position of every row, over their time, against the bf16 peak."""
    sh: counts.Shapes = run.obs.get("shapes")
    steps = untraced.train_steps(run)
    if not steps or sh is None:
        return None
    end = run.obs.get("t_trace") or run.obs["t_end"]
    seq = run.obs["seq"]
    a, b = counts.model_ops(sh, True)
    per_row = a * seq + b * seq * (seq + 1) / 2
    ops = 3.0 * per_row * run.obs["batch"] * len(steps)
    return 100.0 * ops / (end - run.obs["t_first"]) / peaks.BF16_FLOPS_PER_S
