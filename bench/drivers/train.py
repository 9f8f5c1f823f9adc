"""The training cells: the step function of ``make_state_and_step`` with
PVQ-aware training, driven back to back on the mix's batches.

Set-up builds one state (the model's parameters made from ``--seed`` by
the benchmark, AdamW's state from the program) and drives it through the
first ``CHECKED_STEPS`` steps, on the window's own feed; what they read
(each step's loss and gradient norm, every leaf's first gradient as the
optimizer took it, the leaves' change over the steps) is kept for the
check.  The window takes the same state on from there.  Its rate is the
tokens of every step begun in it over the time to the last step's
synchronised end."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from ..core import counts, traffic
from ..core.registry import reference
from ..core.trace import StepTracer
from ..core.weights import WeightSource
from .common import Run, build_params, free_device, port_config, sync

#: the steps of set-up that the reference follows
CHECKED_STEPS = 3
#: steps a traced span records (~0.5 s each)
TRACE_STEPS = 4


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def optimizer(opt: dict):
    from repro_torch.optim import AdamW, cosine_schedule

    return AdamW(lr=cosine_schedule(opt["lr"], opt["warmup"], opt["total"], opt["floor"]),
                 b1=opt["b1"], b2=opt["b2"], eps=opt["eps"], weight_decay=opt["weight_decay"],
                 clip_norm=opt["clip_norm"])


def batch(r: Run, step: int) -> Dict[str, torch.Tensor]:
    tok, tgt = traffic.train_batch(r.mix, r.seed, step, r.cfg["vocab_size"], r.device)
    return {"tokens": tok, "targets": tgt}


def run(r: Run) -> None:
    from repro_torch.launch.train import make_state_and_step
    from repro_torch.nn.models import build_model

    cfg, opt = r.cfg, r.cell["optimizer"]
    qat = cfg["training"]["qat"]
    port = port_config(cfg)
    ws = WeightSource(r.seed, r.device)
    t = time.perf_counter()
    model = build_model(port)
    params = build_params(model, None, ws)
    adamw = optimizer(opt)
    state, step_fn = make_state_and_step(model, adamw, pvq_qat=True, pvq_k=qat["k"],
                                         pvq_group=qat["group"], seed=r.seed, device=r.device,
                                         state=(params, adamw.init(params)))
    del params
    sync(r.device)
    r.obs["setup_phases"] = {"start": t - r.t_process, "weights": time.perf_counter() - t}
    t = time.perf_counter()
    start = {p: v.clone() for p, v in flat(state[0]).items()}
    losses, gnorms, grad1 = [], [], {}
    for i in range(CHECKED_STEPS):
        state, met = step_fn(state, batch(r, i))
        losses.append(met["loss"])
        gnorms.append(met["grad_norm"])
        if i == 0:  # AdamW's first moment after one step is (1 - b1) g
            grad1 = {p: float(m.norm()) / (1.0 - opt["b1"]) for p, m in flat(state[1].mu).items()}
    change = {p: float((v.to(torch.float32) - start[p].to(torch.float32)).norm())
              for p, v in flat(state[0]).items()}
    del start
    program = {"loss": [float(x) for x in losses], "grad_norm": [float(x) for x in gnorms],
               "grad1": grad1, "change": change}
    sync(r.device)
    r.obs["setup_phases"]["checked_steps"] = time.perf_counter() - t
    tracer = StepTracer("train", TRACE_STEPS) if r.trace else None
    steps: List[Dict] = []
    i = CHECKED_STEPS
    t_first = time.perf_counter()
    r.setup_s = t_first - r.t_process
    while time.perf_counter() - t_first < r.seconds:
        if tracer is not None and not tracer.prof and \
                time.perf_counter() - t_first >= r.seconds / 2:
            sync(r.device)
            r.obs["t_trace"] = time.perf_counter()
            tracer.begin()
        traced = tracer is not None and tracer.active
        feed = batch(r, i)
        if traced:
            tracer.mark("train")
        t_s = time.perf_counter()
        state, met = step_fn(state, feed)
        if traced:
            tracer.mark("train")
            tracer.step_done("train")
        steps.append({"start": t_s, "loss": met["loss"], "traced": traced})
        i += 1
    sync(r.device)
    t_end = time.perf_counter()
    if r.device.type == "cuda":
        r.memory_peak_bytes = int(torch.cuda.max_memory_allocated(r.device))
    if tracer is not None and tracer.finished:
        r.summary = tracer.summary()
        r.obs["trace_overhead_s"] = tracer.overhead_s
    window_losses = torch.stack([x.pop("loss") for x in steps]).cpu()
    b, s = r.mix["batch"], r.mix["seq"]
    r.attempted = CHECKED_STEPS + len(steps)
    r.failed = int((~torch.isfinite(window_losses)).sum()) + \
        sum(1 for x in program["loss"] if not math.isfinite(x))
    r.e2e["train_tok_s"] = len(steps) * b * s / (t_end - t_first)
    r.obs.update(kind="train", steps=steps, t_first=t_first, t_end=t_end,
                 shapes=counts.Shapes.of(cfg), batch=b, seq=s)
    del state, step_fn, model, met
    free_device(r.device)
    _check(r, ws, program)


def reference_run(r: Run, ws: WeightSource, rows=None, matmul=None) -> dict:
    """The reference's ``CHECKED_STEPS`` steps on the same batches (only the
    batch rows ``rows`` where given), ``matmul`` in place of its matrix
    products."""
    from ..reference.common import no_tf32

    no_tf32()
    feeds = []
    for i in range(CHECKED_STEPS):
        f = batch(r, i)
        if rows is not None:
            f = {k: v[rows] for k, v in f.items()}
        feeds.append((f["tokens"], f["targets"]))
    return reference(r.cfg["reference"]).train_steps(r.cfg, ws, feeds, r.cell["optimizer"],
                                                     matmul)


def _check(r: Run, ws: WeightSource, program: dict) -> None:
    from ..reference.compare import train_gaps

    ref = reference_run(r, ws)
    limits = r.cell["check"]
    # the numbers the cell compares (the loss's gap is not: neither the
    # control nor a fault moves it past three times what sound runs read)
    gaps = {k: v for k, v in train_gaps(program, ref).items() if k in limits}
    r.checks = {"failed_steps": {"value": r.failed, "limit": 0}}
    r.checks.update({k: {"value": v, "limit": limits[k]} for k, v in gaps.items()})
    if r.keep:
        r.obs.update(program=program, ref=ref)
    r.correct = r.failed == 0 and all(math.isfinite(v) and v <= limits[k]
                                      for k, v in gaps.items())


def control_readings(r: Run, ws: WeightSource) -> Dict[str, Dict[str, float]]:
    """Against the reference (a run with ``keep``): the control, the
    reference with every matrix product's operands in float8 e4m3 (the
    configuration states bfloat16), put in the program's place; and the
    fault of half the batch left out, the mean taken over the rest."""
    from ..reference.compare import train_gaps
    from ..reference.llama import FP8MatMul

    ref = r.obs["ref"]
    half = list(range(r.mix["batch"] // 2 or 1))
    return {"control": train_gaps(reference_run(r, ws, matmul=FP8MatMul.apply), ref),
            "half_batch": train_gaps(reference_run(r, ws, rows=half), ref)}
