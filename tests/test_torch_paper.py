"""The paper slice (§VII nets A-D): the port against the JAX reference.

Both packages run on the same inputs: numpy-seeded data and the reference's
parameters (``jax.random`` init or its trained weights) carried into the
port with ``convert.from_reference_params``; the nets are tiny
``SequentialConfig``s (an MLP, a bsign MLP, a CNN), net A at its published
width and a narrowed net B (its twelve layers, channels cut).

* ``pvq_encode_np`` and ``dot_op_counts``: identical.
* ``pvq_encode_layers``: pulses and stats identical, rho within 1e-6
  relative.
* ``apply``, ``integer_forward`` and ``kernel_apply`` (f32 and
  ``ActQuant``): ``rtol=1e-4, atol=1e-4`` (as ``tests/test_kernels.py``);
  the packed kernels ``pvq_kernel_encode`` gives are identical (scales
  within 1e-6 relative); the int8 gap of a packed layer stays within
  ``act_matmul_error_bound``, which equals the reference's.
* ``fold_codes``: pulse tensors identical, output scale within 1e-6
  relative.
* ``xent_loss`` and its gradients, one ``AdamW.update`` and 3 steps of
  ``train_net`` on ReLU nets without dropout: ``rtol=1e-5`` (gradients
  and trained weights with ``atol=1e-5 * max|want|``: XLA and PyTorch sum
  in other orders).
* ``bsign``, ``bsign_clipped_ste`` and ``pvq_ste``: values identical (rho
  to 1e-6), gradients straight through.
* ``run_net``'s half after training on the reference's trained weights:
  ``layer_stats`` and ``weight_tables`` identical, accuracies equal on net
  A (on the bsign net C within 0.5%: a pre-activation within an ulp of 0
  may take the other sign), ``fold_check`` within 1e-5; ``format_result``
  the same text.
* ``export --paper-net A``: on the reference's weights the port packs the
  reference's codes (pulses identical, rho within 1e-6) and writes the
  reference's bytes from the reference's codes; each package loads the
  other's file to identical leaves; CI's 1.65 bits/weight gate on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import artifact as ref_art
from repro.configs import paper_nets as ref_nets
from repro.core import fold as ref_fold
from repro.core import packed as ref_packed
from repro.core import packing as ref_packing
from repro.core import pvq as ref_pvq
from repro.core import qat as ref_qat
from repro.core import quantize as ref_q
from repro.data import synthetic as ref_syn
from repro.nn import sequential as ref_seq
from repro.optim import adamw as ref_adamw
from repro.paper import experiment as ref_exp
from repro_torch.checkpoint import artifact as port_art
from repro_torch.configs import paper_nets as port_nets
from repro_torch.convert import from_reference_params
from repro_torch.core import fold as port_fold
from repro_torch.core import packed as port_packed
from repro_torch.core import packing as port_packing
from repro_torch.core import pvq as port_pvq
from repro_torch.core import qat as port_qat
from repro_torch.core import quantize as port_q
from repro_torch.data import synthetic as port_syn
from repro_torch.launch import export as port_export
from repro_torch.nn import sequential as port_seq
from repro_torch.optim import adamw as port_adamw
from repro_torch.paper import experiment as port_exp


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


# ---------------------------------------------------------------------------
# nets in both packages
# ---------------------------------------------------------------------------

MLP = ((32,), [dict(kind="fc", out=24, activation="relu", n_over_k=2.0),
               dict(kind="fc", out=16, activation="relu", n_over_k=2.0),
               dict(kind="fc", out=10, activation="none", n_over_k=1.0)])
BSIGN_MLP = ((32,), [dict(kind="fc", out=24, activation="bsign", n_over_k=2.5),
                     dict(kind="fc", out=16, activation="bsign", n_over_k=5.0),
                     dict(kind="fc", out=10, activation="none", n_over_k=4.0)])
CNN = ((8, 8, 3), [dict(kind="conv", out=4, kernel=3, activation="relu", n_over_k=1.0),
                   dict(kind="conv", out=4, kernel=3, activation="relu", n_over_k=1.0),
                   dict(kind="maxpool", pool=2),
                   dict(kind="flatten"),
                   dict(kind="fc", out=16, activation="relu", n_over_k=2.0),
                   dict(kind="fc", out=10, activation="none", n_over_k=1.0)])
MLP_DROPOUT = ((32,), MLP[1][:1] + [dict(kind="dropout", rate=0.2)] + MLP[1][1:])


def _narrowed(cfg, input_shape, widths):
    """``cfg``'s layers (kinds, kernels, activations, N/K) at other widths."""
    layers = [dict(kind=s.kind, out=widths.get(i, s.out), kernel=s.kernel, pool=s.pool,
                   rate=s.rate, activation=s.activation, n_over_k=s.n_over_k)
              for i, s in enumerate(cfg.layers)]
    return input_shape, layers


# net B with its twelve layers (layer9 and layer11 sort before layer2) on a
# 16 x 16 x 3 input, channels 8/8/16/16 and fc 64
NARROW_B = _narrowed(ref_nets.NET_B, (16, 16, 3), {0: 8, 1: 8, 4: 16, 5: 16, 9: 64})


def _pair(desc, name="t"):
    """(reference net, port net) for one ``(input_shape, layers)`` description."""
    shape, layers = desc
    ref = ref_seq.SequentialNet(ref_seq.SequentialConfig(
        name, shape, tuple(ref_seq.LayerSpec(**d) for d in layers)))
    port = port_seq.SequentialNet(port_seq.SequentialConfig(
        name, shape, tuple(port_seq.LayerSpec(**d) for d in layers)))
    return ref, port


def _published(net_id):
    return (ref_seq.SequentialNet(ref_nets.PAPER_NETS[net_id]),
            port_seq.SequentialNet(port_nets.PAPER_NETS[net_id]))


NETS = {"mlp": lambda: _pair(MLP), "bsign_mlp": lambda: _pair(BSIGN_MLP),
        "cnn": lambda: _pair(CNN), "narrow_b": lambda: _pair(NARROW_B),
        "A": lambda: _published("A")}


def _np_tree(tree):
    if isinstance(tree, ref_packed.PackedPVQ):
        return {"pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
                "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
                "layout": tree.layout, "scale_mode": tree.scale_mode}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _params(ref_net, seed=0):
    """The reference's init and the same weights in the port."""
    ref_p = ref_net.init(jax.random.PRNGKey(seed))
    return ref_p, from_reference_params(_np_tree(ref_p))


def _inputs(cfg, n, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, *cfg.input_shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64) if not torch.is_tensor(got)
                               else got.detach().double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _close_scaled(got, want, rtol=1e-5):
    """``rtol`` elementwise, with ``atol = rtol * max|want|``."""
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * (np.abs(want).max() or 1.0))


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in sorted(tree.items())
                for k2, v2 in _flat_leaves(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# core: the numpy encoder, op counts, packing, the error bound, fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(16, 7), (100, 40), (300, 1500), (2000, 400)])
@pytest.mark.parametrize("scale_mode", ["paper", "ls"])
def test_pvq_encode_np_identical(n, k, scale_mode):
    w = np.random.default_rng(n + k).laplace(size=n)
    y_ref, rho_ref = ref_pvq.pvq_encode_np(w, k, scale_mode)
    y, rho = port_pvq.pvq_encode_np(w, k, scale_mode)
    assert y.dtype == np.int64 and np.abs(y).sum() == k
    np.testing.assert_array_equal(y, y_ref)
    assert rho == rho_ref


@pytest.mark.parametrize("n,k", [(1024, 128), (256, 256), (64, 3)])
def test_dot_op_counts_and_pvq_dot(n, k):
    w = np.random.default_rng(n).laplace(size=n).astype(np.float32)
    x = np.random.default_rng(n + 1).normal(size=n).astype(np.float32)
    ref_code = ref_pvq.pvq_encode(jnp.asarray(w), k)
    code = port_pvq.pvq_encode(torch.from_numpy(w), k)
    np.testing.assert_array_equal(code.pulses.numpy(), np.asarray(ref_code.pulses))
    assert port_pvq.dot_op_counts(code) == ref_pvq.dot_op_counts(ref_code)
    _close(port_pvq.pvq_dot(code, torch.from_numpy(x)),
           ref_pvq.pvq_dot(ref_code, jnp.asarray(x)), rtol=1e-6, atol=1e-6)


def test_packing_helpers():
    code = port_pvq.pvq_encode(torch.from_numpy(
        np.random.default_rng(3).laplace(size=(4, 33)).astype(np.float32)), 20)
    ref_code = ref_pvq.PVQCode(pulses=jnp.asarray(code.pulses.numpy()),
                               scale=jnp.asarray(code.scale.numpy()), k=code.k)
    p8, s = port_packing.pulses_to_int8(code, debug=True)
    assert p8.dtype == torch.int8 and torch.equal(p8.to(torch.int32), code.pulses)
    for fmt in ("nibble", "int8"):
        assert port_packing.packed_nbytes(code, fmt) == ref_packing.packed_nbytes(ref_code, fmt)
    nib, shape = port_packing.pack_nibbles(code.pulses.numpy())
    np.testing.assert_array_equal(port_packing.unpack_nibbles(nib, shape), code.pulses.numpy())
    with pytest.raises(ValueError, match="127"):
        port_packing.pulses_to_int8(port_pvq.PVQCode(code.pulses, code.scale, k=200))


@pytest.mark.parametrize("per_tile", [False, True])
def test_act_matmul_error_bound_matches_reference(per_tile):
    rng = np.random.default_rng(4)
    k, n, g, m = 64, 12, 16, 5
    pulses = rng.integers(-5, 6, size=(k, n)).astype(np.int8)
    scales = rng.random((k // g, n)).astype(np.float32)
    a = rng.random((m, k // g if per_tile else 1)).astype(np.float32)
    want = ref_q.act_matmul_error_bound(jnp.asarray(a), jnp.asarray(pulses),
                                        jnp.asarray(scales), g)
    got = port_q.act_matmul_error_bound(torch.from_numpy(a), torch.from_numpy(pulses),
                                        torch.from_numpy(scales), g)
    _close(got, want, rtol=1e-6, atol=0)


def test_fold_codes_and_homogeneity():
    ref_net, net = _pair(MLP)
    ref_p, p = _params(ref_net)
    _, ref_codes, _ = ref_net.pvq_encode_layers(ref_p)
    _, codes, _ = net.pvq_encode_layers(p)
    acts = [s.activation for s in net.cfg.layers if s.kind == "fc"]
    want_t, want_s = ref_fold.fold_codes(list(ref_codes.values()), acts)
    got_t, got_s = port_fold.fold_codes(list(codes.values()), acts)
    for a, b in zip(got_t, want_t):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert abs(got_s - want_s) <= 1e-6 * abs(want_s)
    with pytest.raises(ValueError):
        port_fold.fold_codes(list(codes.values()), acts[:-1] + ["tanh"])
    for name, fn in (("relu", torch.relu), ("none", lambda x: x), ("bsign", port_qat.bsign)):
        assert port_fold.check_homogeneity(name, fn)
    assert not port_fold.check_homogeneity("relu", torch.tanh)
    assert port_fold.HOMOGENEOUS == ref_fold.HOMOGENEOUS
    assert port_fold.ABSORBING == ref_fold.ABSORBING


# ---------------------------------------------------------------------------
# the nets: configs, convert, PVQ, forward paths
# ---------------------------------------------------------------------------


def test_paper_nets_at_published_widths():
    counts = {}
    for net_id, cfg in port_nets.PAPER_NETS.items():
        assert cfg == _same_cfg(ref_nets.PAPER_NETS[net_id])
        params = port_seq.SequentialNet(cfg).init(0, device="cpu")
        counts[net_id] = {k: sum(t.numel() for t in v.values()) for k, v in params.items()}
    assert sum(counts["A"].values()) == 669_706
    assert sum(counts["B"].values()) == 2_168_362 and counts["B"]["layer9"] == 2_097_664


def _same_cfg(ref_cfg):
    return port_seq.SequentialConfig(
        ref_cfg.name, ref_cfg.input_shape,
        tuple(port_seq.LayerSpec(**vars(s)) for s in ref_cfg.layers), ref_cfg.n_classes)


def test_convert_carries_a_sequential_tree_with_conv_leaves():
    ref_net, _ = _pair(NARROW_B)
    ref_p, p = _params(ref_net, seed=3)
    assert list(p) == list(ref_p)
    for path, leaf in _flat_leaves(ref_p).items():
        got = _flat_leaves(p)[path]
        assert got.dtype == torch.float32 and tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert p["layer0"]["kernel"].shape == (3, 3, 3, 8)  # HWIO kept
    assert p["layer9"]["kernel"].shape == (4 * 4 * 16, 64)


@pytest.mark.parametrize("name", ["mlp", "bsign_mlp", "cnn", "narrow_b", "A"])
def test_pvq_encode_layers_identical(name):
    ref_net, net = NETS[name]()
    ref_p, p = _params(ref_net)
    for mode in ("paper", "ls"):
        ref_q_p, ref_codes, ref_stats = ref_net.pvq_encode_layers(ref_p, scale_mode=mode)
        q_p, codes, stats = net.pvq_encode_layers(p, scale_mode=mode)
        assert stats == ref_stats and list(codes) == list(ref_codes)
        for lname, code in codes.items():
            np.testing.assert_array_equal(code.pulses.numpy(), np.asarray(ref_codes[lname].pulses))
            _close(code.scale, ref_codes[lname].scale, rtol=1e-6, atol=0)
        for path, leaf in _flat_leaves(ref_q_p).items():
            _close(_flat_leaves(q_p)[path], leaf, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["mlp", "bsign_mlp", "cnn", "narrow_b", "A"])
def test_apply_and_integer_forward(name):
    ref_net, net = NETS[name]()
    ref_p, p = _params(ref_net)
    xj, xt = _inputs(net.cfg, 16)
    _close(net.apply(p, xt), ref_net.apply(ref_p, xj))
    _, ref_codes, _ = ref_net.pvq_encode_layers(ref_p)
    _, codes, _ = net.pvq_encode_layers(p)
    want, want_scale = ref_net.integer_forward(ref_p, ref_codes, xj)
    got, scale = net.integer_forward(p, codes, xt)
    assert abs(scale - want_scale) <= 1e-6 * abs(want_scale)
    _close(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("name,group", [("mlp", 128), ("bsign_mlp", 16), ("cnn", 32),
                                        ("narrow_b", 256), ("A", 256), ("A", 128)])
def test_kernel_encode_and_kernel_apply(name, group):
    ref_net, net = NETS[name]()
    ref_p, p = _params(ref_net)
    ref_k = ref_net.pvq_kernel_encode(ref_p, group=group)
    kp = net.pvq_kernel_encode(p, group=group)
    assert list(kp) == list(ref_k)
    for lname, sub in kp.items():
        pk, rk = sub["kernel"], ref_k[lname]["kernel"]
        np.testing.assert_array_equal(pk.pulses.numpy(), np.asarray(rk.pulses))
        _close(pk.scales, rk.scales, rtol=1e-6, atol=0)
        assert (pk.group, pk.k, pk.shape, pk.layout) == (rk.group, rk.k, tuple(rk.shape),
                                                         rk.layout)
    xj, xt = _inputs(net.cfg, 8)
    for aq_ref, aq in ((None, None), (ref_q.ActQuant(), port_q.ActQuant())):
        want = ref_net.kernel_apply(ref_p, ref_k, xj, group=group, act_quant=aq_ref)
        got = net.kernel_apply(p, kp, xt, group=group, act_quant=aq)
        _close(got, want)


@pytest.mark.parametrize("name", ["mlp", "A"])
def test_int8_gap_within_the_error_bound(name):
    """Each packed layer of the net, on its own input: |int8 - f32| per
    logit stays within ``act_matmul_error_bound``."""
    _, net = NETS[name]()
    p = net.init(5, device="cpu")
    kp = net.pvq_kernel_encode(p, group=128)
    x = torch.randn(8, *net.cfg.input_shape, generator=torch.Generator().manual_seed(6))
    for i, spec in enumerate(net.cfg.layers):
        if spec.kind != "fc":
            continue
        lay = kp[f"layer{i}"]
        pk = lay["kernel"]
        xf = port_seq._flat(x)
        y_f = port_seq.pvq_dense(lay, xf, act_quant=None)
        y_q = port_seq.pvq_dense(lay, xf, act_quant=port_q.ActQuant())
        xpad = torch.nn.functional.pad(xf, (0, pk.pulses.shape[0] - xf.shape[-1]))
        _, a = port_q.quantize_activations(xpad, port_q.ActQuant())
        bound = port_q.act_matmul_error_bound(a, pk.pulses, pk.scales, pk.group)
        assert bool(((y_q - y_f).abs() <= bound * (1 + 1e-5) + 1e-6).all())
        x = torch.relu(y_f) if spec.activation == "relu" else y_f


# ---------------------------------------------------------------------------
# training: the loss, AdamW, train_net, the estimators
# ---------------------------------------------------------------------------


def _batch(cfg, n=32, seed=2):
    task = ref_syn.ClassifyTask(cfg.input_shape, n_classes=cfg.n_classes, noise=6.0, seed=0)
    b = task.sample(np.random.default_rng(seed), n)
    x = b["x"].astype(np.float32)
    return ({"x": jnp.asarray(x), "y": jnp.asarray(b["y"])},
            {"x": torch.from_numpy(x), "y": torch.from_numpy(b["y"])})


@pytest.mark.parametrize("name", ["mlp", "cnn", "bsign_mlp"])
def test_xent_loss_and_gradients(name):
    ref_net, net = NETS[name]()
    ref_p, p = _params(ref_net)
    bj, bt = _batch(net.cfg)
    want, want_g = jax.value_and_grad(lambda q: ref_seq.xent_loss(ref_net, q, bj))(ref_p)
    leaves = port_adamw.tree_map(lambda t: t.clone().requires_grad_(True), p)
    got = port_seq.xent_loss(net, leaves, bt)
    got.backward()
    _close(got, want, rtol=1e-5, atol=0)
    for path, g in _flat_leaves(want_g).items():
        _close_scaled(_flat_leaves(leaves)[path].grad, g)
    assert port_seq.accuracy(net, p, bt["x"], bt["y"]) == ref_seq.accuracy(
        ref_net, ref_p, bj["x"], bj["y"])


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(7)
    tree = {"a": {"kernel": rng.normal(size=(6, 5)), "bias": rng.normal(size=5)},
            "c": {"kernel": rng.normal(size=(3, 3, 2, 4))}}
    grads = {"a": {"kernel": rng.normal(size=(6, 5)) * 3.0, "bias": rng.normal(size=5)},
             "c": {"kernel": rng.normal(size=(3, 3, 2, 4))}}
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    tree, grads = f32(tree), f32(grads)
    for lr in (1e-2, ref_adamw.cosine_schedule(1e-2, 2, 10)):
        port_lr = lr if isinstance(lr, float) else port_adamw.cosine_schedule(1e-2, 2, 10)
        ref_opt = ref_adamw.AdamW(lr=lr, weight_decay=0.05, clip_norm=1.0)
        opt = port_adamw.AdamW(lr=port_lr, weight_decay=0.05, clip_norm=1.0)
        rp, rs = jax.tree.map(jnp.asarray, tree), ref_opt.init(tree)
        pp = from_reference_params(tree)
        ps = opt.init(pp)
        for _ in range(3):  # clipped (global norm > 1) every step
            rp, rs, rn = ref_opt.update(jax.tree.map(jnp.asarray, grads), rs, rp)
            pp, ps, pn = opt.update(from_reference_params(grads), ps, pp)
            _close(pn, rn, rtol=1e-5, atol=0)
        assert ps.step == int(rs.step) == 3
        for path, leaf in _flat_leaves(rp).items():
            _close(_flat_leaves(pp)[path], leaf, rtol=1e-5, atol=1e-7)
        for got, want in ((ps.mu, rs.mu), (ps.nu, rs.nu)):
            for path, leaf in _flat_leaves(want).items():
                _close(_flat_leaves(got)[path], leaf, rtol=1e-5, atol=1e-9)
    # the decay only on leaves of rank >= 2
    opt = port_adamw.AdamW(lr=1.0, weight_decay=0.5, clip_norm=None)
    zero = {"b": torch.ones(3), "w": torch.ones(2, 2)}
    out, _, _ = opt.update({"b": torch.zeros(3), "w": torch.zeros(2, 2)}, opt.init(zero), zero)
    assert torch.equal(out["b"], torch.ones(3)) and torch.allclose(out["w"], torch.full((2, 2), 0.5))
    sched, ref_sched = port_adamw.cosine_schedule(3e-4, 10, 100), ref_adamw.cosine_schedule(3e-4, 10, 100)
    for s in (0, 5, 10, 50, 100, 150):
        assert abs(sched(s) - float(ref_sched(jnp.asarray(s)))) <= 1e-6 * 3e-4
    _close(port_adamw.global_norm(from_reference_params(grads)),
           ref_adamw.global_norm(jax.tree.map(jnp.asarray, grads)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,project", [("mlp", False), ("cnn", False), ("mlp", True)])
def test_train_net_three_steps(name, project):
    """Plain training, and the §IV mixed optimization (``pvq_project``: the
    forward on the PVQ-projected weights, the STE backward)."""
    ref_net, net = NETS[name]()
    ref_p, p = _params(ref_net)
    task = ref_syn.ClassifyTask(net.cfg.input_shape, noise=6.0, seed=0)
    port_task = port_syn.ClassifyTask(net.cfg.input_shape, noise=6.0, seed=0)
    want = ref_exp.train_net(ref_net, task, steps=3, batch=32, seed=4, init_params=ref_p,
                             pvq_project=project)
    got = port_exp.train_net(net, port_task, steps=3, batch=32, seed=4, init_params=p,
                             pvq_project=project)
    for path, leaf in _flat_leaves(want).items():
        _close_scaled(_flat_leaves(got)[path], leaf)


def test_train_net_draws_dropout_and_learns():
    _, net = _pair(MLP_DROPOUT)
    task = port_syn.ClassifyTask(net.cfg.input_shape, noise=1.0, seed=0)
    p0 = net.init(0, device="cpu")
    a = port_exp.train_net(net, task, steps=30, batch=32, lr=1e-2, seed=1, device="cpu")
    b = port_exp.train_net(net, task, steps=30, batch=32, lr=1e-2, seed=1, device="cpu")
    for path, leaf in _flat_leaves(a).items():
        assert torch.equal(leaf, _flat_leaves(b)[path])  # seeded: repeatable
    test = task.test_set(256)
    x, y = torch.from_numpy(test["x"]).float(), torch.from_numpy(test["y"])
    assert port_seq.accuracy(net, a, x, y) > port_seq.accuracy(net, p0, x, y) + 0.4
    # run_net's evaluation with the §IV refinement on top
    out = port_exp._evaluate(net, task, a, batch=32, refine_steps=2)
    assert 0.0 <= out["acc_refined"] <= 1.0 and out["fold_check"]["rel_err"] < 1e-5


def test_bsign_and_pvq_ste():
    x = np.array([-2.0, -0.5, 0.0, 0.3, 1.5, -1.0], np.float32)
    c = np.arange(1, 7, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (port_qat.bsign(xt) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(port_qat.bsign(xt).detach().numpy(),
                                  np.asarray(ref_qat.bsign(jnp.asarray(x))))
    np.testing.assert_array_equal(xt.grad.numpy(), c)
    xt.grad = None
    (port_qat.bsign_clipped_ste(xt) * torch.from_numpy(c)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(ref_qat.bsign_clipped_ste(v) * c))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    w = np.random.default_rng(8).laplace(size=(12, 20)).astype(np.float32)
    for k, group in ((60, None), (9, 16)):
        wt = torch.from_numpy(w).requires_grad_(True)
        got = port_qat.pvq_ste(wt, k, group)
        want = ref_qat.pvq_ste(jnp.asarray(w), k, group)
        _close(got, want, rtol=1e-6, atol=1e-7)
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(wt.grad.numpy(), w)  # straight through
    sched, ref_sched = port_qat.k_annealing_schedule(512, 64, 10), ref_qat.k_annealing_schedule(512, 64, 10)
    assert [sched(s) for s in range(-1, 13)] == [ref_sched(s) for s in range(-1, 13)]
    assert port_qat.k_annealing_stages(512, 64, 5) == ref_qat.k_annealing_stages(512, 64, 5)
    with pytest.raises(ValueError):
        port_qat.k_annealing_schedule(8, 64, 10)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_tasks_identical(seed):
    for shape in ((784,), (32, 32, 3)):
        a = ref_syn.ClassifyTask(shape, seed=seed).sample(np.random.default_rng(seed + 1), 16)
        b = port_syn.ClassifyTask(shape, seed=seed).sample(np.random.default_rng(seed + 1), 16)
        for key in ("x", "y"):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(ref_syn.ClassifyTask(shape, seed=seed).test_set(8)["x"],
                                      port_syn.ClassifyTask(shape, seed=seed).test_set(8)["x"])
    a = ref_syn.TokenTask(50, seed=seed).sample(np.random.default_rng(seed), 4, 12)
    b = port_syn.TokenTask(50, seed=seed).sample(np.random.default_rng(seed), 4, 12)
    for key in ("tokens", "targets"):
        np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# run_net's half after training, on the reference's trained weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net_id,steps", [("A", 40), ("C", 20)])
def test_evaluate_on_reference_trained_weights(monkeypatch, net_id, steps):
    ref_net, net = _published(net_id)
    task = ref_syn.ClassifyTask(net.cfg.input_shape, noise=6.0, seed=0)
    trained = ref_exp.train_net(ref_net, task, steps=steps, seed=0)
    # the reference's own run_net, its training replaced by these weights
    monkeypatch.setattr(ref_exp, "train_net", lambda *a, **kw: trained)
    want = ref_exp.run_net(net_id, steps=steps, check_fold=True)
    got = port_exp._evaluate(
        net, port_syn.ClassifyTask(net.cfg.input_shape, noise=6.0, seed=0),
        from_reference_params(_np_tree(trained)), check_fold=True)
    assert got["layer_stats"] == want.layer_stats
    assert got["weight_tables"] == want.weight_tables
    # ReLU nets: equal; bsign nets: a pre-activation within an f32 ulp of 0
    # takes the other sign when XLA and PyTorch sum in other orders, and the
    # flip runs on through the next layers, so up to 0.5% of the test set
    tol = 0.0 if net_id in "AB" else 0.005
    for key in ("acc_before", "acc_after", "acc_after_ls"):
        assert abs(got[key] - getattr(want, key)) <= tol, key
    assert want.acc_before > 0.5
    if net_id not in "AB":
        return
    assert got["drop_pct"] == want.drop_pct
    fc, wc = got["fold_check"], want.fold_check
    assert abs(fc["rel_err"] - wc["rel_err"]) <= 1e-5 and fc["rel_err"] < 1e-5
    assert fc["argmax_agreement"] == wc["argmax_agreement"]
    assert abs(fc["output_scale"] - wc["output_scale"]) <= 1e-6 * abs(wc["output_scale"])
    result = port_exp.RepoResult(net=net_id, **got, train_steps=steps, wall_s=0.0)
    mirror = ref_exp.RepoResult(**{f: getattr(result, f) for f in vars(want)})
    assert port_exp.format_result(result) == ref_exp.format_result(mirror)


# ---------------------------------------------------------------------------
# export --paper-net: the reference's bytes, cross loads, CI's gate
# ---------------------------------------------------------------------------


def _ref_paper_net_tree(net_id, group, seed=0):
    ref_net, _ = _published(net_id)
    params = ref_net.init(jax.random.PRNGKey(seed))
    merged = dict(params)
    merged.update(ref_net.pvq_kernel_encode(params, group=group))
    meta = {"kind": "paper_net", "net": net_id, "group": group, "seed": seed}
    return params, merged, meta


def _same_codes(tree, ref_tree):
    """The port's packing of the reference's float weights against the
    reference's: raw leaves and pulses identical, rho within 1e-6."""
    mine, theirs = _flat_leaves(tree), _flat_leaves(ref_tree)
    assert list(mine) == list(theirs)
    for path, leaf in theirs.items():
        if isinstance(leaf, ref_packed.PackedPVQ):
            np.testing.assert_array_equal(mine[path].pulses.numpy(), np.asarray(leaf.pulses))
            _close(mine[path].scales, leaf.scales, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(mine[path].numpy(), np.asarray(leaf))


def test_export_paper_net_a_writes_the_references_bytes(tmp_path):
    """The port's packing of the reference's weights gives the reference's
    codes (rho to 1e-6: a float sum in another order), and the port's
    writer turns the reference's codes into the reference's bytes."""
    params, ref_tree, meta = _ref_paper_net_tree("A", 256)
    tree, port_meta = port_export.pack_paper_net(
        "A", from_reference_params(_np_tree(params)), group=256, seed=0)
    assert port_meta == meta
    _same_codes(tree, ref_tree)
    want = ref_art.write_pvqz(tmp_path / "ref.pvqz", ref_tree, meta=meta)
    got = port_art.write_pvqz(tmp_path / "port.pvqz", from_reference_params(_np_tree(ref_tree)),
                              meta=port_meta)
    assert (tmp_path / "port.pvqz").read_bytes() == (tmp_path / "ref.pvqz").read_bytes()
    assert got["bits_per_weight"] == want["bits_per_weight"] <= 1.65
    # each package loads the other's file (the port's own codes) to its leaves
    mine = port_art.write_pvqz(tmp_path / "mine.pvqz", tree, meta=port_meta)
    assert mine["bits_per_weight"] == want["bits_per_weight"]  # the same pulses
    back = port_art.load_pvqz(tmp_path / "ref.pvqz", device="cpu")
    ref_back = ref_art.load_pvqz(tmp_path / "mine.pvqz", target=ref_tree)
    _same_codes(back, ref_tree)
    for path, leaf in _flat_leaves(tree).items():
        if port_packed.is_packed(leaf):
            np.testing.assert_array_equal(np.asarray(_ref_leaf(ref_back, path).pulses),
                                          leaf.pulses.numpy())
            np.testing.assert_array_equal(np.asarray(_ref_leaf(ref_back, path).scales),
                                          leaf.scales.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(_ref_leaf(ref_back, path)), leaf.numpy())


def _ref_leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def test_export_paper_net_cli_gate_on_cpu(tmp_path):
    out = tmp_path / "a.pvqz"
    report, rc = port_export.run(["--paper-net", "A", "--out", str(out), "--device", "cpu",
                                  "--max-bits-per-weight", "1.65"])
    assert rc == 0 and report["bits_per_weight"] <= 1.65
    toc = port_art.read_toc(out)
    assert toc["meta"] == {"kind": "paper_net", "net": "A", "group": 256, "seed": 0}
    assert sorted(report["leaves"]) == ["layer0/bias", "layer0/kernel", "layer2/bias",
                                        "layer2/kernel", "layer4/bias", "layer4/kernel"]
    back = ref_art.load_pvqz(out)  # the reference reads the port's file
    assert np.asarray(back["layer0"]["kernel"].pulses).shape == (1024, 512)
    _, rc = port_export.run(["--paper-net", "A", "--out", str(out), "--device", "cpu",
                             "--max-bits-per-weight", "1.0"])
    assert rc == 1


def test_narrow_b_tree_with_conv_leaves_byte_identical(tmp_path):
    """Twelve layers (layer11 sorts before layer2) and 4-D raw conv kernels."""
    ref_net, net = _pair(NARROW_B)
    ref_p, p = _params(ref_net)
    ref_tree = dict(ref_p)
    ref_tree.update(ref_net.pvq_kernel_encode(ref_p, group=256))
    tree = dict(p)
    tree.update(net.pvq_kernel_encode(p, group=256))
    _same_codes(tree, ref_tree)
    ref_art.write_pvqz(tmp_path / "ref.pvqz", ref_tree, meta={"kind": "paper_net"})
    port_art.write_pvqz(tmp_path / "port.pvqz", from_reference_params(_np_tree(ref_tree)),
                        meta={"kind": "paper_net"})
    assert (tmp_path / "port.pvqz").read_bytes() == (tmp_path / "ref.pvqz").read_bytes()
    toc = port_art.read_toc(tmp_path / "port.pvqz")
    paths = [r["path"] for r in toc["leaves"]]
    assert paths == sorted(paths) and paths.index("layer11/kernel") < paths.index("layer4/kernel")
    back = port_art.load_pvqz(tmp_path / "ref.pvqz", target=tree, device="cpu")
    assert back["layer0"]["kernel"].shape == (3, 3, 3, 8)
    assert torch.equal(back["layer0"]["kernel"], p["layer0"]["kernel"])


def test_paper_tables_cli_on_cpu(tmp_path, monkeypatch):
    """``tools.paper_tables`` end to end, net A at 5 training steps: one row
    per table, the §III op counts (K-1 adds, one multiply) and N_p(8, 4)."""
    import json

    from repro_torch.tools import paper_tables

    monkeypatch.setitem(paper_tables.FAST_STEPS, "A", 5)
    out = tmp_path / "t.json"
    assert paper_tables.main(["--nets", "A", "--device", "cpu", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows["device"] == "cpu"
    (t1,) = rows["tables_1_4"]
    assert t1["table"] == "T1" and t1["steps"] == 5 and t1["fold_check"]["rel_err"] < 1e-5
    assert [r["table"] for r in rows["tables_5_8"]] == [
        "T5:FC0(A)", "T6:CONV1(B)", "T6:FC4(B)", "T7:FC0(C)", "T8:CONV0(D)"]
    y, _ = ref_pvq.pvq_encode_np(np.random.default_rng(0).laplace(size=401920), 80384)
    assert rows["tables_5_8"][0]["zeros_pct"] == round(100 * float(np.mean(y == 0)), 2)
    for r in rows["opcount_enumeration"][:3]:
        assert (r["pvq_adds"], r["pvq_muls"], r["naive_muls"]) == (r["K"] - 1, 1, r["N"])
    assert rows["opcount_enumeration"][3]["num_points"] == 2816
