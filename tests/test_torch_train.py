"""The training slice: the port's train mode, ``Model.loss``, the token
loader and ``launch.train`` against the JAX reference.

Both packages start from the reference's parameters (``jax.random`` init)
and optimizer state, carried into the port with ``convert``, and see the
same numpy batches (``TokenLoader.host_batch``, the same numpy in both).

* ``TokenLoader.host_batch``: identical arrays.
* ``Model.loss`` and its gradients, reduced smollm-360m and reduced
  deepseek-v2-lite-16b (MoE, MLA; the Switch aux loss in the loss, router
  jitter off), f32: loss and metrics ``rtol=1e-5``; every gradient leaf
  within ``rtol=1e-4`` plus ``atol=1e-5 * max|want|`` (XLA and PyTorch sum
  in other orders, and the backward passes add many of them up).
* RMSNorm's gradients keep the reference custom VJP's dtypes (``dx`` in
  x's, ``dscale`` in the scale's) and values (``rtol=1e-5``).
* The router jitter: the reference's properties
  (``tests/test_nn_components.py:198-242``) in the port's terms, a
  ``torch.Generator`` for the key (no torch generator gives
  ``jax.random``'s draws, so the jittered values themselves are not
  compared).
* Three steps of ``make_state_and_step``, plain and ``--pvq-qat`` at K 128
  (group 256): step-1 STE pulses identical leaf for leaf, the projected
  weights within 1e-6 relative (rho's float sums); every step's loss and
  metrics ``rtol=1e-4``, grad norm ``rtol=1e-3``.  The trained params:
  Adam's step ``m / (sqrt(v) + eps)`` is up to ``lr`` an element whatever
  the gradient's size (on step 1 it is ``g / (|g| + eps)``), so where a
  gradient element is near 0 summation-order noise may move it by up to
  ``2 lr`` a step.  So every element within ``2 lr`` a step, each leaf's
  difference within ``1e-4`` of its norm, and at most 0.1% of a leaf's
  elements beyond ``rtol=1e-4`` plus ``atol=1e-2 * lr``.
* ``launch.train``'s CLI: the reference's report keys, a falling loss on
  the acceptance command, the ``--pvq-qat``-without-``--pvq-k`` message.
* ``tools/profile_train.py``'s shape parsing (the tool itself measures
  only on the card).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import qat as ref_qat
from repro.data import TokenLoader as RefTokenLoader
from repro.data import TokenTask as RefTokenTask
from repro.kernels import ops as ref_ops
from repro.launch import train as ref_train
from repro.nn import layers as ref_layers
from repro.nn.models import build_model as ref_build_model
from repro.optim import AdamW as RefAdamW
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_opt_state, from_reference_params
from repro_torch.data import TokenLoader, TokenTask
from repro_torch.kernels import ops as port_ops
from repro_torch.launch import train as port_train
from repro_torch.nn import layers as port_layers
from repro_torch.nn import moe as port_moe
from repro_torch.nn.models import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (either package), sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _pairs(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for key in w:
        got_a = g[key].detach().to(torch.float64).numpy() if isinstance(g[key], torch.Tensor) \
            else np.asarray(g[key], np.float64)
        yield key, got_a, np.asarray(w[key], np.float64)


def _assert_tree_close(got, want, rtol, atol_frac, what):
    """Each leaf within ``rtol`` plus ``atol_frac * max|want|``."""
    for key, got_a, want_a in _pairs(got, want, what):
        atol = atol_frac * float(np.abs(want_a).max() or 1.0)
        np.testing.assert_allclose(got_a, want_a, rtol=rtol, atol=atol, err_msg=f"{what} {key}")


def _assert_adam_close(got, want, lr, steps, what):
    """Trained params (module docstring): every element within the Adam
    bound ``2 lr`` a step, the leaf within 1e-4 of its norm, at most 0.1%
    of its elements beyond ``rtol=1e-4, atol=1e-2 * lr``."""
    for key, got_a, want_a in _pairs(got, want, what):
        diff = np.abs(got_a - want_a)
        assert diff.max() <= 2 * lr * steps, (what, key, diff.max())
        assert np.linalg.norm(diff) <= 1e-4 * np.linalg.norm(want_a), (what, key)
        off = diff > 1e-4 * np.abs(want_a) + 1e-2 * lr
        assert off.mean() <= 1e-3, (what, key, int(off.sum()), off.size)


def _batch(cfg, b=4, s=16, seed=3):
    """One numpy batch in both packages' dtypes (int32 tokens/targets)."""
    return TokenLoader(TokenTask(cfg.vocab_size, seed=seed), b, s, seed=seed,
                       device="cpu").host_batch(0)


def _models(arch):
    """(reference model, port config, port model) of the reduced config."""
    cfg = get_config(arch).reduced()
    return ref_build_model(ref_get_config(arch).reduced()), cfg, build_model(cfg)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,batch,seq", [(0, 8, 32), (5, 3, 17)])
def test_host_batch_matches_reference(seed, batch, seq):
    ref = RefTokenLoader(RefTokenTask(300, seed=seed), batch, seq, seed=seed)
    port = TokenLoader(TokenTask(300, seed=seed), batch, seq, seed=seed, device="cpu")
    for step in (0, 1, 7):
        want, got = ref.host_batch(step), port.host_batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        dev = port.device_batch(step)
        for k in want:
            assert dev[k].dtype == torch.int32 and dev[k].device.type == "cpu"
            np.testing.assert_array_equal(dev[k].numpy(), want[k])


def test_loader_prefetch_and_sharding():
    port = TokenLoader(TokenTask(64, seed=1), 2, 8, seed=1, device="cpu").start(3)
    try:
        for step in (3, 4, 5):
            got = port.next()
            np.testing.assert_array_equal(got["tokens"].numpy(), port.host_batch(step)["tokens"])
    finally:
        port.close()
    with pytest.raises(ValueError, match="sharding"):
        TokenLoader(TokenTask(64), 2, 8, sharding=object(), device="cpu")


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_loss_and_grads_match_reference(arch):
    ref_model, cfg, model = _models(arch)
    ref_params = ref_model.init(jax.random.PRNGKey(0), max_seq=64)
    params = from_reference_params(_np(ref_params))
    batch = _batch(cfg)

    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: ref_model.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(ref_params)

    latent = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss(latent, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(latent))
    it = iter(grads)
    got_g = tree_map(lambda _: next(it), params)

    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for k in ("ce", "aux", "accuracy"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]), rtol=1e-5,
                                   atol=1e-7,
                                   err_msg=k)
    if cfg.moe is not None:
        assert float(metrics["aux"].detach()) > 0.5  # the Switch loss is in the total
    _assert_tree_close(got_g, _np(want_g), 1e-4, 1e-5, f"{arch} grad")


def test_rmsnorm_grads_keep_the_reference_dtypes():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    g = rng.normal(size=(2, 5, 64)).astype(np.float32)
    for x_dt, s_dt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                       (torch.float32, torch.float32)):
        xt = torch.from_numpy(x).to(x_dt).requires_grad_(True)
        st = torch.from_numpy(scale).to(s_dt).requires_grad_(True)
        y = port_layers.rmsnorm({"rms_scale": st}, xt)
        dx, ds = torch.autograd.grad(y, (xt, st), torch.from_numpy(g).to(y.dtype))
        assert (y.dtype, dx.dtype, ds.dtype) == (x_dt, x_dt, s_dt)
    # values in f32 against the reference's custom VJP
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    y = port_layers.rmsnorm({"rms_scale": st}, xt)
    dx, ds = torch.autograd.grad(y, (xt, st), torch.from_numpy(g))
    y_ref, vjp = jax.vjp(lambda a, b: ref_layers.rmsnorm({"rms_scale": b}, a),
                         jnp.asarray(x), jnp.asarray(scale))
    dx_ref, ds_ref = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the router jitter (tests/test_nn_components.py:198-242 in the port's terms)
# ---------------------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_moe_router_jitter():
    cfg = port_moe.MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=32, capacity_factor=1.0,
                             group_size=32, activation="swiglu", router_jitter=0.5)
    p = port_moe.init_moe(_gen(8), 16, cfg, dtype=torch.float32, device="cpu")
    x = torch.randn((2, 32, 16), generator=_gen(9)) * 3.0
    base, _ = port_moe.moe_forward(p, x, cfg)
    # eval (train=False) and train without a generator are noise-free
    for kw in ({}, {"train": True}, {"rng": _gen(0)}):
        out, _ = port_moe.moe_forward(p, x, cfg, **kw)
        assert torch.equal(out, base), kw
    # train + generator perturbs the routing; the same seed is deterministic
    j1, _ = port_moe.moe_forward(p, x, cfg, train=True, rng=_gen(1))
    j1b, _ = port_moe.moe_forward(p, x, cfg, train=True, rng=_gen(1))
    j2, _ = port_moe.moe_forward(p, x, cfg, train=True, rng=_gen(2))
    assert torch.equal(j1, j1b)
    assert not torch.equal(j1, base)
    assert not torch.equal(j1, j2)
    # jitter 0 is a no-op even in train mode
    out0, _ = port_moe.moe_forward(p, x, cfg._replace(router_jitter=0.0), train=True,
                                   rng=_gen(3))
    assert torch.equal(out0, base)


def test_moe_router_jitter_reachable_from_model_loss():
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(router_jitter=0.5))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=_gen(1))
    batch = {"tokens": toks, "targets": toks}
    l0 = float(model.loss(params, batch)[0])  # no generator: deterministic
    assert l0 == float(model.loss(params, batch)[0])
    l1 = float(model.loss(params, batch, rng=_gen(2))[0])
    l1b = float(model.loss(params, batch, rng=_gen(2))[0])
    assert l1 == l1b  # deterministic per seed
    assert l1 != l0  # the jitter moved the routing and gates
    # the step generator is a pure function of (seed, optimizer step)
    a = port_train.step_generator(0, 3, "cpu")
    assert torch.equal(torch.rand(4, generator=a),
                       torch.rand(4, generator=port_train.step_generator(0, 3, "cpu")))
    assert not torch.equal(torch.rand(4, generator=port_train.step_generator(0, 3, "cpu")),
                           torch.rand(4, generator=port_train.step_generator(0, 4, "cpu")))


# ---------------------------------------------------------------------------
# make_state_and_step: three steps in both packages
# ---------------------------------------------------------------------------


def _qat_leaves(params_np):
    """The leaves the reference's --pvq-qat rule projects: {path: array}."""
    from repro.core.quantize import QuantPolicy

    policy = QuantPolicy()
    return {k: v for k, v in _flat(params_np).items()
            if v.ndim >= 2 and policy.match(k) and v.size >= 1024}


LR = 3e-3  # the CLI's default peak rate


@pytest.mark.parametrize("pvq_qat", [False, True])
def test_three_steps_match_reference(pvq_qat):
    ref_model, cfg, model = _models("smollm-360m")
    kw = dict(pvq_qat=pvq_qat, pvq_k=128, pvq_group=256, seed=0)
    ref_state, ref_step = ref_train.make_state_and_step(
        ref_model, RefAdamW(lr=LR, weight_decay=0.1), **kw)
    params_np = _np(ref_state[0])
    state = (from_reference_params(params_np), from_reference_opt_state(_np(ref_state[1])))
    port_state, port_step = port_train.make_state_and_step(
        model, AdamW(lr=LR, weight_decay=0.1), device="cpu", state=state, **kw)

    if pvq_qat:
        # step 1's STE projection: identical pulses on every projected leaf
        leaves = _qat_leaves(params_np)
        assert len(leaves) == 8  # the embedding and 7 stacked matmul leaves
        for key, w in leaves.items():
            p_ref, _ = ref_ops.pvq_encode_grouped_fast(jnp.asarray(w).reshape(-1), 256, 128,
                                                       scale_mode="paper")
            p_port, _ = port_ops.pvq_encode_grouped_fast(torch.tensor(w).reshape(-1), 256, 128,
                                                         scale_mode="paper")
            np.testing.assert_array_equal(p_port.numpy(), np.asarray(p_ref), err_msg=key)
            want = np.asarray(ref_qat.pvq_ste(jnp.asarray(w), 128, 256))
            got = port_train.qat_projector(128)({"k": {"kernel": torch.tensor(w)}})
            np.testing.assert_allclose(got["k"]["kernel"].numpy(), want, rtol=1e-6, atol=1e-9,
                                       err_msg=key)

    loader = TokenLoader(TokenTask(cfg.vocab_size, seed=1), 8, 32, seed=1, device="cpu")
    for step in range(3):
        hb = loader.host_batch(step)
        ref_state, want = ref_step(ref_state, {k: jnp.asarray(v) for k, v in hb.items()})
        port_state, got = port_step(port_state, {k: torch.from_numpy(v) for k, v in hb.items()})
        assert sorted(got) == sorted(want)
        for k in ("loss", "ce", "aux", "accuracy"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {step} {k}")
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-3,
                                   err_msg=f"step {step} grad_norm")
    assert port_state[1].step == int(ref_state[1].step) == 3
    _assert_adam_close(port_state[0], _np(ref_state[0]), LR, 3, "params after 3 steps")


def test_make_state_and_step_refuses_qat_without_k():
    _, _, model = _models("smollm-360m")
    with pytest.raises(ValueError, match="pvq_k"):
        port_train.make_state_and_step(model, AdamW(), pvq_qat=True, device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

#: the report keys of ``repro.launch.train.main`` (src/repro/launch/train.py)
REPORT_KEYS = ["arch", "steps", "wall_s", "loss_first10", "loss_last10",
               "stragglers_flagged", "restores"]


def test_cli_trains_with_pvq_qat(tmp_path, capsys):
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps", "30",
            "--batch", "8", "--seq", "32", "--pvq-qat", "--pvq-k", "128",
            "--ckpt-dir", str(tmp_path)]
    assert port_train.main(argv) == 0
    import json

    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(report) == REPORT_KEYS
    assert report["steps"] == 30 and report["restores"] == 0
    assert report["arch"] == "smollm-360m-smoke"
    assert report["loss_last10"] < report["loss_first10"]
    # the final blocking save of the runner
    from repro_torch.checkpoint import Checkpointer

    assert Checkpointer(tmp_path).latest_step() == 29


def test_cli_refuses_pvq_qat_without_pvq_k(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        port_train.run(["--reduced", "--device", "cpu", "--pvq-qat", "--ckpt-dir", str(tmp_path)])
    assert exc.value.code == 2
    assert "--pvq-qat needs --pvq-k" in capsys.readouterr().err


def test_profile_train_parses_shapes_and_needs_a_card(monkeypatch):
    """``tools/profile_train.py``: ``BxS`` shapes parse; with no card the
    tool refuses to measure."""
    from repro_torch.tools import profile_train

    assert profile_train._shape("3x2048") == (3, 2048)
    assert profile_train._shape("8X64") == (8, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_train.main(["--shapes", "2x16"])
