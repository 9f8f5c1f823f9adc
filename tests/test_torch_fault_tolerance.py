"""The port's fault-tolerant runner (``repro_torch.runtime.fault_tolerance``)
against the JAX reference's (``repro.runtime.fault_tolerance``): the cases
of ``tests/test_fault_tolerance.py``, each run in both packages side by side.

* The toy step (a linear least-squares fit, AdamW): both runners see the
  same numpy batches (a function of the step, made from a seed) and the
  same failure injector.  The served steps, the history's step sequence
  and keys, the restores and the committed checkpoints are equal; every
  loss within ``rtol=1e-5`` and the trained weights within ``rtol=1e-5``
  plus ``atol=1e-6`` (8 weights, f32, XLA and PyTorch sum in other orders).
* A new runner resumes from the other package's checkpoint directory and
  holds its state bit for bit.
* ``StragglerPolicy`` and ``ElasticPlan``: the same decisions on the same
  inputs (seeded step-time streams with spikes; a grid of batches and chip
  counts).
* ``launch.train`` at reduced smollm-360m with ``--pvq-qat`` and an injected
  failure: the reference's runner, wired as its ``main`` wires it, and the
  port's, started from the reference's state (``convert``), serve the same
  step sequence and restore once; losses within ``rtol=1e-4`` (the
  three-step parity's tolerance in ``tests/test_torch_train.py``) and the
  trained params within its Adam bound.  The port's ``run`` serves the
  reference's step sequence and ends on its own uninterrupted run's params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.data import TokenLoader as RefTokenLoader
from repro.data import TokenTask as RefTokenTask
from repro.launch import train as ref_train
from repro.nn.models import build_model as ref_build_model
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_opt_state, from_reference_params
from repro_torch.data import TokenLoader, TokenTask
from repro_torch.launch import train as port_train
from repro_torch.nn.models import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.fault_tolerance import ElasticPlan, StragglerPolicy, TrainingRunner


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


class ToyLoader:
    """Deterministic batch(step) from numpy, as either package's arrays;
    records the steps it served."""

    def __init__(self, as_array, dim=8):
        self.as_array = as_array
        self.dim = dim
        self.calls = []

    def device_batch(self, step):
        self.calls.append(step)
        x = np.random.default_rng(step).normal(size=(4, self.dim)).astype(np.float32)
        return {"x": self.as_array(x), "y": self.as_array(x.sum(-1, keepdims=True))}


def _ref_toy():
    opt = RefAdamW(lr=1e-2, weight_decay=0.0)

    @jax.jit
    def step_fn(state, batch):
        params, opt_state = state

        def loss_fn(p):
            return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state, gn = opt.update(grads, opt_state, params)
        return (params, opt_state), {"loss": loss, "grad_norm": gn}

    params = {"w": jnp.zeros((8, 1))}
    return step_fn, (params, opt.init(params)), ToyLoader(jnp.asarray)


def _port_toy():
    opt = AdamW(lr=1e-2, weight_decay=0.0)

    def step_fn(state, batch):
        params, opt_state = state
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean((batch["x"] @ w - batch["y"]) ** 2)
        (g,) = torch.autograd.grad(loss, (w,))
        params, opt_state, gn = opt.update({"w": g}, opt_state, params)
        return (params, opt_state), {"loss": loss.detach(), "grad_norm": gn}

    params = {"w": torch.zeros((8, 1))}
    return step_fn, (params, opt.init(params)), ToyLoader(torch.from_numpy)


def _both_runners(tmp_path, **kw):
    """(reference runner, its loader, port runner, its loader), each with
    its own checkpoint directory."""
    ref_step, ref_state, ref_loader = _ref_toy()
    step, state, loader = _port_toy()
    ref = ref_ft.TrainingRunner(ref_step, ref_state, ref_loader,
                                RefCheckpointer(tmp_path / "ref"), **kw)
    port = TrainingRunner(step, state, loader, Checkpointer(tmp_path / "port"), **kw)
    return ref, ref_loader, port, loader


def _assert_same_run(ref, port):
    """Equal step sequences, history keys and restores; losses and the
    trained weights within the module docstring's tolerances."""
    assert [h["step"] for h in port.history] == [h["step"] for h in ref.history]
    # (a jitted step returns its metrics in sorted key order)
    assert [sorted(h) for h in port.history] == [sorted(h) for h in ref.history]
    assert port.restores == ref.restores
    np.testing.assert_allclose([h["loss"] for h in port.history],
                               [h["loss"] for h in ref.history], rtol=1e-5)
    np.testing.assert_allclose(port.state[0]["w"].numpy(), np.asarray(ref.state[0]["w"]),
                               rtol=1e-5, atol=1e-6)
    assert port.state[1].step == int(ref.state[1].step)


def _injector(at):
    crashed = []

    def injector(step):
        if step == at and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    return injector


def test_runner_trains_and_checkpoints(tmp_path):
    ref, _, port, _ = _both_runners(tmp_path, ckpt_every=10)
    assert port.run(40) == ref.run(40) == 40
    _assert_same_run(ref, port)
    assert port.history[0]["loss"] > port.history[-1]["loss"]
    assert port.ckpt.all_steps() == ref.ckpt.all_steps()
    assert port.ckpt.latest_step() == ref.ckpt.latest_step() == 39


def test_runner_recovers_from_injected_failures(tmp_path):
    ref, ref_loader, port, loader = _both_runners(tmp_path, ckpt_every=5)
    assert port.run(30, failure_injector=_injector(17)) == \
        ref.run(30, failure_injector=_injector(17)) == 30
    assert loader.calls == ref_loader.calls
    assert port.restores == ref.restores == 1
    _assert_same_run(ref, port)
    assert port.ckpt.all_steps() == ref.ckpt.all_steps()


def test_runner_gives_up_after_max_restores(tmp_path):
    ref, ref_loader, port, loader = _both_runners(tmp_path, ckpt_every=5, max_restores=2)

    def always(step):
        raise RuntimeError("persistent failure")

    for runner in (ref, port):
        with pytest.raises(RuntimeError, match="persistent"):
            runner.run(10, failure_injector=always)
    assert port.restores == ref.restores
    assert loader.calls == ref_loader.calls == []


def test_resume_across_runner_instances(tmp_path):
    """A full job restart: a new runner of either package picks up where
    an old one of either package ended, from its checkpoint directory."""
    ref, _, port, _ = _both_runners(tmp_path, ckpt_every=10)
    ref.run(20)
    port.run(20)
    _assert_same_run(ref, port)
    finals = {"ref": np.asarray(ref.state[0]["w"]), "port": port.state[0]["w"].numpy()}
    for src, want in finals.items():
        ref_step, ref_state, ref_loader = _ref_toy()
        r2 = ref_ft.TrainingRunner(ref_step, ref_state, ref_loader,
                                   RefCheckpointer(tmp_path / src), ckpt_every=10)
        step, state, loader = _port_toy()
        p2 = TrainingRunner(step, state, loader, Checkpointer(tmp_path / src), ckpt_every=10)
        assert p2.resume_step() == r2.resume_step() == 20
        np.testing.assert_array_equal(p2.state[0]["w"].numpy(), want)
        np.testing.assert_array_equal(np.asarray(r2.state[0]["w"]), want)
        assert p2.state[1].step == int(r2.state[1].step) == 20


@pytest.mark.parametrize("seed,window,factor", [(0, 16, 3.0), (1, 32, 3.0), (2, 8, 1.5)])
def test_straggler_flagging(seed, window, factor):
    """The same flags on a seeded stream of step times with spikes."""
    rng = np.random.default_rng(seed)
    dts = rng.uniform(0.08, 0.12, size=200)
    dts[rng.choice(200, size=12, replace=False)] *= rng.uniform(1.2, 10.0, size=12)
    ref = ref_ft.StragglerPolicy(window=window, factor=factor)
    pol = StragglerPolicy(window=window, factor=factor)
    said = [pol.observe(s, float(dt)) for s, dt in enumerate(dts)]
    assert said == [ref.observe(s, float(dt)) for s, dt in enumerate(dts)]
    assert pol.flagged == ref.flagged
    assert any(said)


@pytest.mark.parametrize("candidates", [None, ((4, 4), (2, 4), (1, 4), (1, 1))])
def test_elastic_plan_divisibility(candidates):
    """The same mesh for every batch and surviving chip count on a grid."""
    kw = {} if candidates is None else {"candidates": candidates}
    picks = []
    for batch in (1, 2, 3, 8, 12, 24, 256, 384):
        ref = ref_ft.ElasticPlan(global_batch=batch, **kw)
        plan = ElasticPlan(global_batch=batch, **kw)
        for chips in range(0, 300, 7):
            picks.append(plan.pick(chips))
            assert picks[-1] == ref.pick(chips), (batch, chips)
    assert None in picks and len(set(picks)) > 2


# ---------------------------------------------------------------------------
# launch.train at reduced size, an injected failure
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--reduced", "--device", "cpu", "--steps", "10", "--batch", "2", "--seq", "16",
              "--pvq-qat", "--pvq-k", "128", "--ckpt-every", "5"]
LR, STEPS = 3e-3, 10  # the CLI's default peak rate, the run's steps


def _adam_close(got, want, what):
    """``tests/test_torch_train.py``'s bound on trained params: every
    element within ``2 lr`` a step, the leaf within 1e-4 of its norm."""
    got_l = [g.detach().double().numpy() for g in tree_leaves(got)]
    want_l = [np.asarray(w, np.float64) for w in tree_leaves(from_reference_params(want))]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        diff = np.abs(g - w)
        assert diff.max() <= 2 * LR * STEPS, what
        assert np.linalg.norm(diff) <= 1e-4 * np.linalg.norm(w), what


def test_train_recovers_from_an_injected_failure(tmp_path):
    """A failure at step 7 restores step 4 (``--ckpt-every 5``) in both
    packages; the port's ``run`` ends on its uninterrupted run's params
    (the loader's stream is a function of the step)."""
    ref_model = ref_build_model(ref_get_config("smollm-360m").reduced())
    cfg = get_config("smollm-360m").reduced()
    qat = dict(pvq_qat=True, pvq_k=128, seed=0)

    # the reference's runner, wired as repro.launch.train.main wires it
    ref_state, ref_step = ref_train.make_state_and_step(
        ref_model, RefAdamW(lr=ref_cosine_schedule(LR, warmup=20, total=STEPS)), **qat)
    state = (from_reference_params(jax.tree.map(np.asarray, ref_state[0])),
             from_reference_opt_state(jax.tree.map(np.asarray, ref_state[1])))
    ref = ref_ft.TrainingRunner(
        ref_step, ref_state, RefTokenLoader(RefTokenTask(cfg.vocab_size, seed=0), 2, 16, seed=0),
        RefCheckpointer(tmp_path / "ref", keep=3), ckpt_every=5,
        straggler=ref_ft.StragglerPolicy())
    ref.run(STEPS, failure_injector=_injector(7))

    # the port's, wired as launch.train.run wires it, from the same state
    state, step_fn = port_train.make_state_and_step(
        build_model(cfg), AdamW(lr=cosine_schedule(LR, warmup=20, total=STEPS)), device="cpu",
        state=state, **qat)
    port = TrainingRunner(
        step_fn, state, TokenLoader(TokenTask(cfg.vocab_size, seed=0), 2, 16, seed=0,
                                    device="cpu"),
        Checkpointer(tmp_path / "port", keep=3), ckpt_every=5, straggler=StragglerPolicy())
    port.run(STEPS, failure_injector=_injector(7))

    steps = [h["step"] for h in ref.history]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]
    assert [h["step"] for h in port.history] == steps
    assert port.restores == ref.restores == 1
    assert port.ckpt.all_steps() == ref.ckpt.all_steps()
    for k in ("loss", "ce", "accuracy"):
        np.testing.assert_allclose([h[k] for h in port.history], [h[k] for h in ref.history],
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    _adam_close(port.state[0], jax.tree.map(np.asarray, ref.state[0]), "recovered params")
    assert port.state[1].step == int(ref.state[1].step) == STEPS

    # the port's entry point: the same step sequence, and the params of an
    # uninterrupted run
    report, rc, st = port_train.run(TRAIN_ARGV + ["--ckpt-dir", str(tmp_path / "a")],
                                    return_state=True, failure_injector=_injector(7))
    assert rc == 0 and report["restores"] == ref.restores and report["steps"] == len(steps)
    assert [h["step"] for h in st["runner"].history] == steps
    _, _, clean = port_train.run(TRAIN_ARGV + ["--ckpt-dir", str(tmp_path / "b")],
                                 return_state=True)
    for got, want in zip(tree_leaves(st["runner"].state[0]), tree_leaves(clean["runner"].state[0])):
        assert torch.equal(got, want)
    assert st["runner"].state[1].step == clean["runner"].state[1].step == STEPS
