"""Reduced cells run end to end on the CPU: the engine under chat and agent
traffic and the lockstep batch, each checked against the reference; the
process that ran them holds neither JAX nor the JAX package; and a token
altered where it is produced makes ``correct`` false."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench.core import registry
from bench.drivers import batch, engine, train
from bench.drivers.common import Run
from bench.tests import _tiny

ROOT = Path(__file__).resolve().parents[2]
NAMES = {"chat": "smollm-engine-chat", "agent": "smollm-engine-agent", "batch": "dsv2lite-batch64",
         "train": "smollm-qat-train"}

_SCRIPT = r"""
import json, sys, time
t = time.perf_counter()
sys.path[:0] = [{root!r}, {src!r}]
from bench import run
from bench.core import guard, registry
from bench.tests import _tiny
cells = {{"chat": (_tiny.engine_cell(), _tiny.smollm_cfg(), _tiny.chat_mix()),
          "agent": (_tiny.engine_cell(), _tiny.smollm_cfg(), _tiny.agent_mix()),
          "batch": (_tiny.batch_cell(), _tiny.deepseek_cfg(), _tiny.batch_mix()),
          "train": (_tiny.train_cell(), _tiny.smollm_cfg(), _tiny.train_mix())}}
cell, cfg, mix = cells[sys.argv[1]]
name = sys.argv[2]
out = run.execute(name, cell, cfg, mix, registry.metrics_of(name, registry.benchmark()),
                  seed=2**33 + 1, seconds=1.5, trace=False, device="cpu", t_process=t)
out["forbidden"] = guard.forbidden_modules()
print(json.dumps(out))
"""


@pytest.mark.parametrize("which", ["chat", "agent", "batch", "train"])
def test_a_reduced_cell_runs_end_to_end_without_jax(which):
    code = _SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code, which, NAMES[which]], capture_output=True,
                         text=True,
                         timeout=240, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    listed = registry.metrics_of(NAMES[which], registry.benchmark())
    assert set(out["metrics"]) == {m["name"] for m in listed["end_to_end"]}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "forbidden" and list(out)[-2] == "checks"


def _alter(monkeypatch, when, once=True):
    """Wrap the model's decode step so that where ``when(pos)`` names a row
    (with ``once``, the first time only), that row's produced token becomes
    its least likely one."""
    from repro_torch.nn.models import Model

    orig = Model.decode_step
    done = []

    def decode_step(self, params, cache, token, pos, fill=None):
        logits, cache = orig(self, params, cache, token, pos, fill=fill)
        row = None if (once and done) else when(pos)
        if row is not None:
            logits = logits.clone()
            lo = logits[row, -1].argmin()
            logits[row, -1, lo] = logits[row, -1].max() + 1.0
            done.append(row)
        return logits, cache

    monkeypatch.setattr(Model, "decode_step", decode_step)
    return done


def _run(cell, cfg, mix, driver, seed=5, seconds=1.5):
    r = Run(name="tiny", cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=False,
            device=torch.device("cpu"), t_process=time.perf_counter())
    driver.run(r)
    return r


def test_an_altered_token_in_the_engine_is_caught(monkeypatch):
    cell = _tiny.engine_cell()
    cell["check"]["sample"] = 1000  # every request: the altered one among them

    def when(pos):
        hit = (pos.reshape(-1) >= 12).nonzero()
        return int(hit[0]) if len(hit) else None

    done = _alter(monkeypatch, when)
    r = _run(cell, _tiny.smollm_cfg(), _tiny.chat_mix(), engine)
    assert done, "no decode step reached the altered position"
    assert r.correct is False
    assert r.checks["max_logit_gap"]["value"] > r.checks["max_logit_gap"]["limit"]


def test_an_altered_token_in_a_batch_call_is_caught(monkeypatch):
    mix = _tiny.batch_mix()
    target = mix["prompt_len"] + 2
    hits = []

    def when(pos):
        # the third decode step of every call, the checked one included
        if int(pos.reshape(-1)[0]) != target:
            return None
        hits.append(1)
        return 1

    _alter(monkeypatch, when, once=False)
    r = _run(_tiny.batch_cell(), _tiny.deepseek_cfg(), mix, batch)
    assert hits
    assert r.correct is False
    assert r.checks["max_logit_gap"]["value"] > r.checks["max_logit_gap"]["limit"]


def _break_step(monkeypatch, fault):
    """Wrap the program's training step: ``unchanged`` returns the state it
    was given (with the step's readings), ``half_batch`` feeds it the first
    half of the rows only (the mean taken over those)."""
    import repro_torch.launch.train as port_train

    orig = port_train.make_state_and_step

    def make_state_and_step(*args, **kwargs):
        state, step = orig(*args, **kwargs)

        def broken(state, feed):
            if fault == "half_batch":
                n = max(feed["tokens"].shape[0] // 2, 1)
                return step(state, {k: v[:n] for k, v in feed.items()})
            _, met = step(state, feed)
            return state, met

        return state, broken

    monkeypatch.setattr(port_train, "make_state_and_step", make_state_and_step)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_caught(monkeypatch, fault):
    _break_step(monkeypatch, fault)
    r = _run(_tiny.train_cell(), _tiny.smollm_cfg(), _tiny.train_mix(), train, seconds=0.5)
    assert r.correct is False
    assert any(c["value"] > c["limit"] for c in r.checks.values()), r.checks
