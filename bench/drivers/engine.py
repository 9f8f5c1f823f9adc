"""The serving cells: open-loop traffic through ``PVQEngine.run``.

Every request of the mix is due at ``t0 + arrival``, where ``t0`` is taken
right before ``run``; its time to first token runs from then, so a busy
loop's lateness in releasing it counts.  ``run`` returns once every
request has finished, so each is timed to its end.  Set-up is the
parameters, the engine and its warm-up (every graph the mix's prompt
lengths need)."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from ..core import counts, stats, traffic
from ..core.trace import StepTracer
from ..core.weights import WeightSource
from ..core.registry import reference
from .common import (Run, Spans, build_params, free_device, port_config, quant_scopes,
                     serving_policy, sync)

#: the control's activations: int4
CONTROL_QMAX = 7


def run(r: Run) -> None:
    from repro_torch.launch.engine import PVQEngine, Request
    from repro_torch.nn.models import build_model

    cfg, ecfg = r.cfg, r.cell["engine"]
    port = port_config(cfg)
    ws = WeightSource(r.seed, r.device)
    specs = traffic.poisson(r.mix, r.seed, r.seconds, cfg["vocab_size"])
    with quant_scopes(cfg):
        t = time.perf_counter()
        model = build_model(port)
        params = build_params(model, serving_policy(port, cfg), ws)
        sync(r.device)
        r.obs["setup_phases"] = {"start": t - r.t_process, "weights": time.perf_counter() - t}
        t = time.perf_counter()
        eng = PVQEngine(model, params, **ecfg)
        eng.warmup(prompt_lens=[len(s.prompt) for s in specs])
        warm_prefixes(eng, r.mix, r.seed, cfg["vocab_size"])
        sync(r.device)
        r.obs["setup_phases"]["warmup"] = time.perf_counter() - t
        spans, log, tracer = _instrument(r, eng)
        reqs = [Request(rid=s.rid, prompt=list(s.prompt), max_new_tokens=s.max_new,
                        arrival=s.arrival) for s in specs]
        sync(r.device)
        t0 = time.perf_counter()
        r.setup_s = t0 - r.t_process
        r.obs["t0"] = t0
        eng.run(reqs)
        sync(r.device)
    if r.device.type == "cuda":
        r.memory_peak_bytes = int(torch.cuda.max_memory_allocated(r.device))
    if tracer is not None and tracer.finished:
        r.summary = tracer.summary()
        r.obs["trace_overhead_s"] = tracer.overhead_s
    records = _records(r, eng, reqs, t0)
    r.attempted = len(records)
    r.failed = sum(1 for x in records if not x["ok"])
    r.e2e["ttft_p90_ms"] = 1e3 * stats.percentile([x["ttft_s"] for x in records], 90)
    r.e2e["tpot_p90_ms"] = 1e3 * stats.percentile([x["tpot_s"] for x in records], 90)
    r.obs.update(kind="engine", records=records, spans=spans.by, work=log,
                 shapes=counts.Shapes.of(cfg))
    sample = _sample(r, records)
    del eng, params, model
    free_device(r.device)
    _check(r, ws, sample)


def warm_prefixes(eng, mix: dict, seed: int, vocab: int) -> None:
    """Serve each of the mix's shared prompts, where it has any, once (and
    one token more), so that its pages sit in the prefix cache when the
    window opens; the engine's record of them is cleared."""
    from repro_torch.launch.engine import Request

    warm = [Request(rid=-1 - k, prompt=p + [0], max_new_tokens=1)
            for k, p in enumerate(traffic.shared_prefixes(mix, seed, vocab))]
    if warm:
        eng.run(warm)
        eng.finished.clear()


def _instrument(r: Run, eng):
    """Spans around the engine's device steps (each ends in the step's host
    read, so its wall is the step's), the work each did (for the counts),
    and with ``--trace 1`` the profiler over ``TRACE_STEPS`` decode steps
    from the middle of the window."""
    spans = Spans()
    log: List[tuple] = []
    tracer = StepTracer("decode") if r.trace else None
    page = eng.page

    def decode_before(tokens, pos, write_page, fill=None):
        if tracer is not None and not tracer.prof and \
                time.perf_counter() - r.obs["t0"] >= r.seconds / 2:
            r.obs["t_trace"] = time.perf_counter()
            tracer.begin()
        active = [s for s, st in enumerate(eng.slots) if st is not None and st.phase == "decode"]
        ctx = [int(pos[s]) + 1 for s in active]
        log.append(("decode", tracer is not None and tracer.active,
                    {"rows": eng.n_slots, "ctx": ctx, "packed": [c // page * page for c in ctx],
                     "t": time.perf_counter()}))
        if tracer is not None and tracer.active:
            tracer.mark("decode")

    def decode_after(*args, **kwargs):
        if tracer is not None and tracer.active:
            tracer.mark("decode")
            tracer.step_done("decode")

    def other(kind):
        def before(*args, **kwargs):
            if kind == "chunk":
                info = {"rows": eng.chunk_tokens, "packed": [int(args[2])]}
            elif kind == "prefill":
                info = {"rows": int(args[0].shape[0]) * int(args[0].shape[1])}
            else:
                info = {}
            log.append((kind, tracer is not None and tracer.active, info))
            if tracer is not None and tracer.active:
                tracer.mark(kind)

        def after(*args, **kwargs):
            if tracer is not None and tracer.active:
                tracer.mark(kind)
        return before, after

    eng._decode = spans.wrap("decode", eng._decode, decode_before, decode_after)
    for kind in ("chunk", "prefill", "graft"):
        before, after = other(kind)
        setattr(eng, f"_{kind}", spans.wrap(kind, getattr(eng, f"_{kind}"), before, after))
    return spans, log, tracer


def _records(r: Run, eng, reqs, t0: float) -> List[Dict]:
    vocab = r.cfg["vocab_size"]
    done = {q.rid for q in eng.finished}
    out = []
    for q in reqs:
        due = t0 + q.arrival
        n = len(q.generated)
        ok = (q.rid in done and n == q.max_new_tokens and q.first_token_t is not None
              and all(0 <= t < vocab for t in q.generated))
        ttft = q.first_token_t - due if ok else math.inf
        tpot = (q.finish_t - q.first_token_t) / (n - 1) if ok and n > 1 else (0.0 if ok else math.inf)
        out.append({
            "rid": q.rid, "ok": ok, "prompt": list(q.prompt), "generated": list(q.generated),
            "arrival": q.arrival, "ttft_s": ttft, "tpot_s": tpot,
            "queue_s": (q.admit_t - due) if q.admit_t is not None else math.inf,
            "hit_pages": q.prefix_hit_pages,
        })
    return out


def _sample(r: Run, records: List[Dict]) -> List[Dict]:
    """The requests the reference checks: the longest one finished and
    ``sample - 1`` more drawn from the seed."""
    ok = [x for x in records if x["ok"]]
    if not ok:
        return []
    longest = max(ok, key=lambda x: len(x["prompt"]) + len(x["generated"]))
    rest = [x for x in ok if x is not longest]
    k = min(r.cell["check"]["sample"] - 1, len(rest))
    pick = traffic.rng(r.seed, 3).choice(len(rest), size=k, replace=False) if k else []
    return [longest] + [rest[i] for i in sorted(pick)]


def cuts_of(x: Dict, cell: dict, page: int) -> List[int]:
    """For each fed position ``t`` of a served request, how many leading
    positions its query read from PVQ pages: a chunked prompt's queries the
    context before their chunk, a prompt prefilled whole none, a decoded
    position every completed block (the one its own key completes too)."""
    ecfg = cell["engine"]
    chunk = (ecfg.get("prefill_chunk") or 0) * page
    p = len(x["prompt"])
    s0 = x["hit_pages"] * page
    chunked = bool(chunk) and (p > chunk or s0 > 0)
    out = []
    for t in range(p + len(x["generated"]) - 1):
        if t >= p:
            out.append((t + 1) // page * page)
        elif not chunked:
            out.append(0)
        elif t >= s0:
            out.append(s0 + (t - s0) // chunk * chunk)
        else:
            out.append(t // chunk * chunk)
    return out


def reference_logits(r: Run, ws: WeightSource, sample: List[Dict], qmax: int) -> List[torch.Tensor]:
    """The reference's logits at every served position of each checked
    request, with activations of ``qmax`` levels."""
    from ..reference.common import no_tf32

    no_tf32()
    dev = ws.device
    page = r.cfg["serving"]["kv_cache"]["block"]
    seqs = [torch.tensor(x["prompt"] + x["generated"][:-1], device=dev) for x in sample]
    cuts = [torch.tensor(cuts_of(x, r.cell, page), device=dev) for x in sample]
    firsts = [len(x["prompt"]) - 1 for x in sample]
    with torch.no_grad():
        return reference(r.cfg["reference"]).forward(r.cfg, ws, seqs, cuts, firsts, qmax)


def _check(r: Run, ws: WeightSource, sample: List[Dict]) -> None:
    from ..reference.compare import widest_gap

    limit = r.cell["check"]["max_logit_gap"]
    if not sample:
        r.checks = {"served_tokens": {"value": 0, "limit": 1}}
        r.correct = False
        return
    ref = reference_logits(r, ws, sample, 127)
    gap = widest_gap(ref, [torch.tensor(x["generated"], device=ws.device) for x in sample])
    r.checks = {
        "failed_requests": {"value": r.failed, "limit": 0},
        "max_logit_gap": {"value": gap, "limit": limit},
    }
    r.obs["served_checked"] = sum(len(x["generated"]) for x in sample)
    if r.keep:
        r.obs.update(sample=sample, ref_logits=ref)
    r.correct = r.failed == 0 and math.isfinite(gap) and gap <= limit


def control_readings(r: Run, ws: WeightSource) -> Dict[str, Dict[str, float]]:
    """The control (a run with ``keep``): the reference with activations of
    the next lower precision (int4 where int8 is stated), its first choice
    at every position of the checked requests read against the reference."""
    from ..reference.compare import argmax_tokens, widest_gap

    ctl = reference_logits(r, ws, r.obs["sample"], CONTROL_QMAX)
    return {"control": {"max_logit_gap": widest_gap(r.obs["ref_logits"], argmax_tokens(ctl))}}
