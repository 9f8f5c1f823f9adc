"""The offline batch cells: ``serve.generate`` calls back to back, each of
``batch`` prompts of ``prompt_len`` tokens and ``gen`` greedy tokens.

Calls begin while the window is open; the rate is the tokens of every
call begun in it over the time from the first call's start to the last
call's synchronised end.  Set-up is the parameters and one warm call at
the cell's shapes (its prefill, and the decode step's capture)."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from ..core import counts, traffic
from ..core.trace import StepTracer
from ..core.weights import WeightSource
from ..core.registry import reference
from .common import Run, build_params, free_device, port_config, quant_scopes, serving_policy, sync

WARM_CALL = 1 << 30  # a call index no window reaches

#: the control's activations: int4
CONTROL_QMAX = 7


def run(r: Run) -> None:
    from repro_torch.launch import serve
    from repro_torch.nn.models import build_model

    cfg, mix = r.cfg, r.mix
    port = port_config(cfg)
    ws = WeightSource(r.seed, r.device)
    vocab, gen, plen = cfg["vocab_size"], mix["gen"], mix["prompt_len"]
    cache_len = plen + gen

    def tokens(call: int) -> torch.Tensor:
        return torch.from_numpy(traffic.batch_tokens(mix, r.seed, call, vocab)).to(r.device)

    with quant_scopes(cfg):
        t = time.perf_counter()
        model = build_model(port)
        params = build_params(model, serving_policy(port, cfg), ws)
        sync(r.device)
        r.obs["setup_phases"] = {"start": t - r.t_process, "weights": time.perf_counter() - t}
        t = time.perf_counter()
        serve.generate(model, params, tokens(WARM_CALL), gen=2, cache_len=cache_len)
        sync(r.device)
        r.obs["setup_phases"]["warmup"] = time.perf_counter() - t
        calls: List[Dict] = []
        tracer = StepTracer("decode") if r.trace else None
        t_first = time.perf_counter()
        r.setup_s = t_first - r.t_process
        while time.perf_counter() - t_first < r.seconds:
            i = len(calls)
            tok = tokens(i)
            traced = tracer is not None and not tracer.prof and \
                time.perf_counter() - t_first >= r.seconds / 2
            restore = _trace_call(model, tracer) if traced else None
            tm: Dict[str, float] = {}
            t_s = time.perf_counter()
            try:
                out = serve.generate(model, params, tok, gen=gen, cache_len=cache_len, timings=tm)
            finally:
                if restore is not None:
                    restore()
            t_e = time.perf_counter()
            calls.append({"start": t_s, "end": t_e, "prefill_s": tm["prefill_s"],
                          "decode_s": tm["decode_s"], "out": out.cpu(), "traced": traced})
        sync(r.device)
    if r.device.type == "cuda":
        r.memory_peak_bytes = int(torch.cuda.max_memory_allocated(r.device))
    if tracer is not None and tracer.finished:
        r.summary = tracer.summary()
        r.obs["trace_overhead_s"] = tracer.overhead_s
        r.obs["traced_steps"] = tracer.done_steps
    batch = mix["batch"]
    r.attempted = len(calls) * batch
    r.failed = sum(int(((c["out"][:, plen:] < 0) | (c["out"][:, plen:] >= vocab)).any(-1).sum())
                   for c in calls)
    r.e2e["output_tok_s"] = output_rate(calls, t_first, batch, gen)
    r.obs.update(kind="batch", calls=[{k: v for k, v in c.items() if k != "out"} for c in calls],
                 shapes=counts.Shapes.of(cfg), batch=batch, prompt_len=plen, gen=gen)
    pick = int(traffic.rng(r.seed, 3).integers(len(calls)))
    seq = calls[pick]["out"]
    del model, params, calls
    free_device(r.device)
    _check(r, ws, seq)


def output_rate(calls: List[Dict], t_first: float, batch: int, gen: int) -> float:
    """Tokens of every call begun in the window over the time from the
    first call's start to the last call's synchronised end."""
    return len(calls) * batch * gen / (calls[-1]["end"] - t_first)


def _trace_call(model, tracer: StepTracer):
    """Profile this call's prefill and its first decode steps: the prefill
    and each replay of the captured step between markers."""
    from repro_torch.launch import capture

    replay = capture.CapturedStep.replay
    prefill = model.prefill

    def marked_prefill(*args, **kwargs):
        tracer.mark("prefill")
        out = prefill(*args, **kwargs)
        tracer.mark("prefill")
        return out

    def marked_replay(self):
        if not tracer.active:
            return replay(self)
        tracer.mark("decode")
        out = replay(self)
        tracer.mark("decode")
        tracer.step_done("decode")
        return out

    tracer.begin()
    model.prefill = marked_prefill
    capture.CapturedStep.replay = marked_replay

    def restore():
        capture.CapturedStep.replay = replay
        del model.prefill
        if tracer.active:
            tracer.end()

    return restore


def reference_logits(r: Run, ws: WeightSource, seq: torch.Tensor, qmax: int) -> List[torch.Tensor]:
    """The reference's logits at every decoded position of the checked
    call ``seq``, with activations of ``qmax`` levels."""
    from ..reference.common import no_tf32

    no_tf32()
    plen = r.mix["prompt_len"]
    fed = seq[:, :-1].to(ws.device)
    with torch.no_grad():
        return [reference(r.cfg["reference"]).forward(r.cfg, ws, fed, plen, plen - 1, qmax)]


def _check(r: Run, ws: WeightSource, seq: torch.Tensor) -> None:
    from ..reference.compare import widest_gap

    plen = r.mix["prompt_len"]
    ref = reference_logits(r, ws, seq, 127)
    gap = widest_gap(ref, [seq[:, plen:]])
    limit = r.cell["check"]["max_logit_gap"]
    r.checks = {
        "failed_sequences": {"value": r.failed, "limit": 0},
        "max_logit_gap": {"value": gap, "limit": limit},
    }
    r.obs["served_checked"] = int(seq[:, plen:].numel())
    if r.keep:
        r.obs.update(sample=seq, ref_logits=ref)
    r.correct = r.failed == 0 and math.isfinite(gap) and gap <= limit


def control_readings(r: Run, ws: WeightSource) -> Dict[str, Dict[str, float]]:
    """The control (a run with ``keep``): the reference with activations of
    the next lower precision (int4 where int8 is stated), its first choice
    at every decoded position of the checked call read against the
    reference."""
    from ..reference.compare import argmax_tokens, widest_gap

    ctl = reference_logits(r, ws, r.obs["sample"], CONTROL_QMAX)
    return {"control": {"max_logit_gap": widest_gap(r.obs["ref_logits"], argmax_tokens(ctl))}}
