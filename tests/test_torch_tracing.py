"""The port's spans on the CPU: one mechanism for the registry and the
profiler, and where they sit in the engine loop and the training step.

* With the registry off and no profiler running, a span site returns the
  shared ``NOOP`` and allocates nothing; under a running
  ``torch.profiler`` the same site records a function-scope event into the
  profiler's trace (no user annotation, so no device-side copy on a card)
  and still nothing into the registry.
* A running profiler turns on no instrument and no quantization probe:
  those read tensors back to the host, and follow ``obs.enabled()`` alone.
* Under a CPU profiler, a reduced ``PVQEngine.run`` (batched prefills,
  chunks and decode steps) and a reduced ``--pvq-qat`` training step record
  every span of the loop, nested as the engine and ``step_fn`` nest them,
  and together the spans cover at least 95% of the run's and the step's
  wall.
* The feeder stamps each request's due time; the report's latency and
  TTFT count from it, so a feeder held back by a long loop iteration
  shows in them, and the registry keeps the lateness.

This file imports no JAX.
"""

import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.core import quantize as port_q
from repro_torch.core.packed import quantize_params
from repro_torch.launch import engine as port_engine
from repro_torch.launch.serve import serving_policy
from repro_torch.launch.train import make_state_and_step
from repro_torch.nn.models import Model
from repro_torch.optim import AdamW
from repro_torch.runtime import obs, telemetry

KVQ = port_q.KVQuant(8, 16)
#: the loop's spans with a parent, and the parent; the rest sit at the top
ENGINE_NESTING = {
    "engine/prefill": "engine/admit",
    "engine/graft": "engine/admit",
    "engine/prefill_wait": "engine/prefill",
    "engine/chunk_wait": "engine/prefill_chunk",
    "engine/decode_prep": "engine/decode_step",
    "engine/decode_launch": "engine/decode_step",
    "engine/decode_wait": "engine/decode_step",
    "engine/decode_post": "engine/decode_step",
}
ENGINE_TOP = ("engine/admit", "engine/prefill_chunk", "engine/decode_step", "engine/yield")
TRAIN_PHASES = ("train/project", "train/forward", "train/backward", "train/optimizer")


@pytest.fixture(autouse=True)
def _registry_off():
    prev = obs.set_enabled(False)
    obs.registry().clear()
    yield
    obs.set_enabled(prev)
    obs.registry().clear()


@pytest.fixture(scope="module")
def port_model():
    model = Model(get_config("smollm-360m").reduced())
    return model, model.init(0, device="cpu")


def _profiled(fn, name):
    """``fn()`` under a CPU profiler, inside a ``name`` range: ``(result,
    the range's event, the program's span events)``."""
    with profile(activities=[ProfilerActivity.CPU]):  # the profiler's first start is slow
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(name):
            out = fn()
    evs = prof.events()
    outer = next(e for e in evs if e.name == name)
    spans = [e for e in evs if e.name.startswith(("engine/", "train/"))]
    return out, outer, spans


def _coverage(spans, outer) -> float:
    """The share of ``outer``'s wall under the top spans (parent ``outer``)."""
    top = [e for e in spans if e.cpu_parent is not None and e.cpu_parent.name == outer.name]
    lo, hi = outer.time_range.start, outer.time_range.end
    return sum(e.time_range.end - e.time_range.start for e in top) / (hi - lo)


def _engine(model, params, **kw):
    return port_engine.PVQEngine(model, params, n_slots=2, max_len=64, prefill_chunk=2,
                                 prefill_batch=2, **kw)


def _requests(lengths, arrivals=None, max_new=4):
    arrivals = arrivals or [0.0] * len(lengths)
    return [port_engine.Request(rid=i, prompt=[(7 * i + j) % 100 + 1 for j in range(n)],
                                max_new_tokens=max_new, arrival=a)
            for i, (n, a) in enumerate(zip(lengths, arrivals))]


def test_a_span_site_with_registry_and_profiler_off_allocates_nothing():
    assert not obs.tracing() and obs.span("engine/decode_step") is obs.NOOP

    def site():
        with obs.span("engine/decode_launch"):
            pass
        with obs.span("engine/prefill", args={"rows": 1} if obs.tracing() else None):
            pass

    site()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            site()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == telemetry.__file__ and d.size_diff > 0]
    assert grown == []
    assert obs.registry().chrome_trace()["traceEvents"] == []


def test_under_a_profiler_a_span_records_into_its_trace_and_not_into_the_registry():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.tracing() and not obs.enabled()
        with obs.span("engine/decode_step"):
            with obs.span("engine/decode_wait"):
                torch.ones(4).sum()
    assert not obs.tracing()
    evs = {e.name: e for e in prof.events()}
    wait = evs["engine/decode_wait"]
    assert wait.cpu_parent.name == "engine/decode_step"
    assert wait.device_type == torch.autograd.DeviceType.CPU
    assert not getattr(wait, "is_user_annotation", False)
    assert obs.registry().chrome_trace()["traceEvents"] == []


def test_a_span_records_into_both_where_both_are_on():
    obs.set_enabled(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("train/step", args={"n": 1}):
            pass
    assert [e["name"] for e in obs.registry().chrome_trace()["traceEvents"]] == ["train/step"]
    assert any(e.name == "train/step" for e in prof.events())


def test_a_running_profiler_enables_no_instrument_and_no_probe(port_model, monkeypatch):
    """The engine's instruments and the quantization probes (KV encode,
    activation quantization, the prefill's KV quality) stay off under a
    profiler, on packed weights and int8 activations: each would reach one
    of these accessors first."""
    model, _ = port_model

    def refuse(*args, **kwargs):
        raise AssertionError("an instrument or probe ran with the registry off")

    packed = quantize_params(model.init(0, device="cpu"), serving_policy(model.cfg))
    for name in ("counter", "gauge", "histogram", "event", "trace_counter"):
        monkeypatch.setattr(obs, name, refuse)
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(KVQ):
        eng = _engine(model, packed)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            report = eng.run(_requests([5, 30]))
    assert report["requests"] == 2
    assert any(e.name == "engine/decode_step" for e in prof.events())


def test_engine_run_spans_nest_and_cover_the_run(port_model):
    model, params = port_model
    with port_q.kv_quant_scope(KVQ):
        eng = _engine(model, params)
        report, outer, spans = _profiled(lambda: eng.run(_requests([5, 30, 6, 12])), "test/run")
    assert report["requests"] == 4 and report["chunks"] >= 2 and report["prefill_batches"] >= 1
    names = {e.name for e in spans}
    assert names == set(ENGINE_NESTING) | set(ENGINE_TOP)
    for e in spans:
        want = ENGINE_NESTING.get(e.name, "test/run")
        assert e.cpu_parent is not None and e.cpu_parent.name == want, (e.name, e.cpu_parent)
    steps = [e for e in spans if e.name == "engine/decode_step"]
    for step in steps:
        kids = [c.name for c in spans if c.cpu_parent is step]
        # the tables and the input copy in ``_decode`` are a second prep span
        assert kids == ["engine/decode_prep", "engine/decode_prep", "engine/decode_launch",
                        "engine/decode_wait", "engine/decode_post"]
    assert _coverage(spans, outer) >= 0.95


def test_train_step_spans_nest_and_cover_the_step():
    model = Model(get_config("smollm-360m").reduced())
    state, step_fn = make_state_and_step(model, AdamW(lr=1e-3), pvq_qat=True, pvq_k=64,
                                         device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 100, (2, 16), generator=g),
             "targets": torch.randint(0, 100, (2, 16), generator=g)}
    state, _ = step_fn(state, batch)
    (state, met), outer, spans = _profiled(lambda: step_fn(state, batch), "test/step")
    assert torch.isfinite(met["loss"])
    parents = {e.name: e.cpu_parent.name for e in spans}
    assert parents == {"train/step": "test/step", **{p: "train/step" for p in TRAIN_PHASES}}
    assert _coverage(spans, outer) >= 0.95
    step = next(e for e in spans if e.name == "train/step")
    phases = sum(e.time_range.end - e.time_range.start for e in spans if e.name in TRAIN_PHASES)
    assert phases >= 0.9 * (step.time_range.end - step.time_range.start)


def test_report_counts_from_the_due_time_when_the_feeder_runs_late(port_model):
    """A 50 ms decode step holds the loop; the second request falls due 2 ms
    into the run, is queued after the first iteration, and its latency and
    TTFT count from when it was due."""
    model, params = port_model
    obs.set_enabled(True)
    with port_q.kv_quant_scope(KVQ):
        eng = _engine(model, params)
        decode = eng._decode

        def slow_decode(*args, **kwargs):
            time.sleep(0.05)
            return decode(*args, **kwargs)

        eng._decode = slow_decode
        reqs = _requests([5, 6], arrivals=[0.0, 1.0])
        report = eng.run(reqs, time_scale=0.002)
    late = [r.submit_t - r.due_t for r in reqs]
    assert late[1] >= 0.04
    assert reqs[1].due_t - reqs[0].due_t == pytest.approx(0.002)
    ttft = [r.first_token_t - r.due_t for r in reqs]
    lat = [r.finish_t - r.due_t for r in reqs]
    assert report["ttft_p99_s"] == round(float(np.percentile(ttft, 99)), 4)
    assert report["latency_p50_s"] == round(float(np.percentile(lat, 50)), 4)
    assert report["ttft_p99_s"] > round(max(r.first_token_t - r.submit_t for r in reqs), 4)
    hist = obs.histogram("engine.feed_late_s")
    assert hist.count == 2 and hist.max == pytest.approx(max(late))
    # submit_t stays the moment of queueing: the queue wait counts from it
    assert all(r.admit_t >= r.submit_t >= r.due_t for r in reqs)
