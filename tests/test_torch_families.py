"""The attention families (gemma-2b, granite-8b, starcoder2-15b, paligemma-3b,
whisper-small) in the port against the JAX reference, reduced.

Both packages compute on the reference's parameters (``jax.random`` init,
seed 0), carried across as numpy (``convert.from_reference_params``); the
batches are numpy from a seed (tokens, targets, whisper's ``frames``,
paligemma's ``patches``).

* ``Model.forward`` logits ``atol 1e-4``; ``Model.loss`` and its metrics
  ``rtol 1e-5``; every gradient leaf ``rtol 1e-4`` plus ``1e-5 * max|want|``
  (``tests/test_torch_train.py``'s tolerances), but whisper's key biases',
  whose gradient is 0 without RoPE (the softmax cancels them), held to
  noise in both.
* ``prefill`` and ``decode_step`` logits on the f32 path, on packed weights
  with f32 activations, and under ``--act-int8 --kv-pvq`` (KV block 8, group
  16, so decode crosses a block fill): ``atol 1e-4`` for the f32 legs and
  ``3e-2 * max|logit|`` for int8, with any argmax split a near-tie
  (``tests/test_torch_model.py``'s tolerances and reasons).  A VLM decodes
  at ``prefix_len + t`` in both packages.
* ``quantize_params`` under serve's policy: the port's own packing of the
  same float weights packs the reference's leaf set (17 tensors for
  whisper, its encoder and cross projections) with the reference's pulses
  but at near-ties of the greedy step (codes within 1e-6 in cosine; one
  of 4,672 on whisper) and rho within ``1e-6`` relative (a float sum in
  another order).
* The reference's ``tests/test_arch_smoke.py`` checks in the port: decode
  matches the parallel forward (``rtol 2e-2, atol 2e-3``), whisper's cross
  caches (dense under ``--kv-pvq``, never padded, untouched by decode).
* The VLM position finding: the reference's ``serve.teacher_forced_logits``
  decodes paligemma at ``prompt_len + i`` (over the patch prefix's cache
  rows) and departs from its own ``Model.forward``; the port's decodes at
  ``prefix_len + prompt_len + i`` and matches the reference's forward.
* The entry points: ``serve`` with CI's flags exits 0 at agreement >= 0.99
  for all five, with the reference's ``pvq_tensors``; ``train`` runs the
  three text-only models and refuses whisper-small and paligemma-3b;
  the engine refuses both (``NotImplementedError``) and on gemma-2b and
  starcoder2-15b with f32 activations gives the reference engine's tokens
  exactly; ``export --arch whisper-small --reduced``'s file is the
  reference's byte for byte on the reference's codes, and loads into the
  port's whisper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _chip_smoke_module import chip_smoke

from repro.checkpoint import artifact as ref_art
from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.launch import engine as ref_engine
from repro.launch import serve as ref_serve
from repro.nn.models import Model as RefModel
from repro_torch.checkpoint import artifact as port_art
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.launch import engine as port_engine
from repro_torch.launch import export as port_export
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.nn.models import Model
from repro_torch.optim.adamw import tree_leaves, tree_map

ARCHS = ("gemma-2b", "granite-8b", "starcoder2-15b", "paligemma-3b", "whisper-small")
TEXT_ONLY = ("gemma-2b", "granite-8b", "starcoder2-15b")
PROMPT, STEPS, BLOCK, GROUP = 12, 5, 8, 16
SEQ = 16


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


def _np_tree(tree):
    if isinstance(tree, ref_packed.PackedPVQ):
        return {"pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
                "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
                "layout": tree.layout, "scale_mode": tree.scale_mode}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _policy(q, cfg):
    """``serve --pvq``'s packing policy (N/K 1)."""
    return q.QuantPolicy(rules=(("embedding", cfg.pvq.n_over_k_embed, cfg.pvq.group),
                                ("kernel|experts", 1.0, cfg.pvq.group)), scale_mode="ls")


_MODELS = {}


def _models(arch):
    """(reference cfg, reference model, its float params, its packed params,
    port model, port float params, port packed params): once a module."""
    if arch not in _MODELS:
        ref_cfg = ref_get_config(arch).reduced()
        ref_model = RefModel(ref_cfg)
        ref_float = ref_model.init(jax.random.PRNGKey(0), max_seq=64)
        ref_pk = ref_packed.quantize_params(ref_float, _policy(ref_q, ref_cfg))
        model = Model(get_config(arch).reduced())
        _MODELS[arch] = (ref_cfg, ref_model, ref_float, ref_pk, model,
                         from_reference_params(_np_tree(ref_float)),
                         from_reference_params(_np_tree(ref_pk)))
    return _MODELS[arch]


def _extra(cfg, b, s, seed):
    """The stub frontends' numpy inputs: whisper's frames, paligemma's patches."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)}
    return {}


def _batch(cfg, b=2, s=SEQ, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    out.update(_extra(cfg, b, s, seed + 1))
    return out


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    ref_cfg, ref_model, ref_float, _, model, port_float, _ = _models(arch)
    batch = _batch(ref_cfg)
    want_logits, _, _ = ref_model.forward(ref_float, _ref_batch(batch), mode="train")
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: ref_model.loss(p, _ref_batch(batch)), has_aux=True)(ref_float)

    got_logits, _, _ = model.forward(port_float, _port_batch(batch), mode="train")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)

    latent = tree_map(lambda p: p.detach().clone().requires_grad_(True), port_float)
    loss, metrics = model.loss(latent, _port_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(latent))
    it = iter(grads)
    got_g = tree_map(lambda _: next(it), port_float)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for k in ("ce", "accuracy"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    g, w = _flat(got_g), _flat(jax.tree.map(np.asarray, want_g))
    assert sorted(g) == sorted(w)
    top = max(float(np.abs(np.asarray(v, np.float64)).max()) for v in w.values())
    for key in w:
        want_a = np.asarray(w[key], np.float64)
        if key.endswith("wk/bias") and ref_cfg.rope_theta is None:
            # without RoPE a key bias adds one constant to a query's every
            # score, which the softmax cancels: its gradient is 0 and both
            # packages give summation noise, so it is held to noise level
            assert np.abs(g[key].double().numpy()).max() <= 1e-6 * top, key
            assert np.abs(want_a).max() <= 1e-6 * top, key
            continue
        atol = 1e-5 * float(np.abs(want_a).max() or 1.0)
        np.testing.assert_allclose(g[key].double().numpy(), want_a, rtol=1e-4, atol=atol,
                                   err_msg=f"{arch} grad {key}")


# ---------------------------------------------------------------------------
# prefill and decode, f32 and int8 with the PVQ KV cache
# ---------------------------------------------------------------------------


def _run_ref(cfg, model, params, batch, feed):
    logits, cache = model.prefill(params, _ref_batch(batch), cache_len=PROMPT + STEPS)
    out = [np.asarray(logits[:, -1])]
    for i in range(STEPS):
        logits, cache = model.decode_step(params, cache, jnp.asarray(feed[:, i : i + 1]),
                                          jnp.int32(cfg.prefix_len + PROMPT + i))
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out, 1)


def _run_port(cfg, model, params, batch, feed, device_pos=False):
    logits, cache = model.prefill(params, _port_batch(batch), cache_len=PROMPT + STEPS)
    out = [logits[:, -1].numpy()]
    b = feed.shape[0]
    for i in range(STEPS):
        pos = cfg.prefix_len + PROMPT + i
        tok = torch.from_numpy(feed[:, i : i + 1].astype(np.int64))
        if device_pos:
            logits, cache = model.decode_step(params, cache, tok, torch.full((b,), pos),
                                              fill=(pos + 1) % BLOCK == 0)
        else:
            logits, cache = model.decode_step(params, cache, tok, pos)
        out.append(logits[:, -1].numpy())
    return np.stack(out, 1)


LEGS = {"float": ("float", False, False), "packed_f32": ("packed", False, False),
        "packed_int8_kvpvq": ("packed", True, True)}


def _close_with_near_ties(got, want, act):
    atol = 3e-2 * float(np.abs(want).max()) if act else 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    pa, pb = want.argmax(-1), got.argmax(-1)
    margin = (np.take_along_axis(want, pa[..., None], -1)
              - np.take_along_axis(want, pb[..., None], -1))
    noise = np.abs(got - want).max(-1, keepdims=True)
    assert ((pa == pb)[..., None] | (margin <= noise)).all()


@pytest.mark.parametrize("leg", list(LEGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, leg):
    which, act, kv = LEGS[leg]
    ref_cfg, ref_model, ref_float, ref_pk, model, port_float, port_pk = _models(arch)
    ref_params, port_params = (ref_float, port_float) if which == "float" else (ref_pk, port_pk)
    batch = _batch(ref_cfg, s=PROMPT, seed=11)
    batch.pop("targets")
    feed = np.random.default_rng(12).integers(0, 128, size=(2, STEPS)).astype(np.int32)
    with ref_q.act_quant_scope(ref_q.ActQuant() if act else None), \
            ref_q.kv_quant_scope(ref_q.KVQuant(block=BLOCK, group=GROUP) if kv else None):
        want = _run_ref(ref_cfg, ref_model, ref_params, batch, feed)
    with port_q.act_quant_scope(port_q.ActQuant() if act else None), \
            port_q.kv_quant_scope(port_q.KVQuant(block=BLOCK, group=GROUP) if kv else None):
        got = _run_port(ref_cfg, model, port_params, batch, feed)
        # the step a CUDA graph captures: (b,) device positions, the host's fill
        at_device = _run_port(ref_cfg, model, port_params, batch, feed, device_pos=True)
    np.testing.assert_array_equal(at_device, got)
    assert got.shape == want.shape == (2, STEPS + 1, 128)
    _close_with_near_ties(got, want, act)


# ---------------------------------------------------------------------------
# packing under serve's policy
# ---------------------------------------------------------------------------


REFERENCE_PVQ_TENSORS = {"whisper-small": 17}  # the reference's serve report, reduced


def _groups(leaf, pulses, w):
    """``(pulses, weights)`` of every code of a packed leaf as rows ``(G,
    group)``: a matmul-layout leaf's groups run down its columns, a flat
    one's along its rows."""
    g = leaf.group
    if leaf.layout == "matmul":
        lead, k, n = pulses.shape[:-2], pulses.shape[-2], pulses.shape[-1]
        def rows(a):
            a = a.reshape(*lead, k // g, g, n)
            return np.moveaxis(a, -1, -2).reshape(-1, g)
        return rows(pulses), rows(w)
    return pulses.reshape(-1, g), w.reshape(-1, g)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_pulses_identical_under_serve_policy(arch):
    """The port packs the reference's leaf set from the same float weights;
    every code's pulses are the reference's but at near-ties of the greedy
    step: codes whose exact (f64) cosine with the weights differs from the
    reference code's by under 1e-6 relative, where the two packages' f32
    objectives (sums in other orders) pick different lanes.  On reduced
    whisper, seed 0, that is one code of 4,672 (layer 1's cross ``wv``,
    column 23: cosine 0.89945290 for the port's, 0.89945286 for the
    reference's).  The reference's own codes cross byte for byte
    (``convert``), which is what the artifact and serving tests run on."""
    ref_cfg, _, ref_float, ref_pk, model, port_float, _ = _models(arch)
    dense = tree_map(lambda t: t.clone(), port_float)  # quantize_params packs in place
    got = port_packed.packed_leaves(port_packed.quantize_params(dense, _policy(port_q,
                                                                           model.cfg)))
    want = ref_packed.packed_leaves(ref_pk)
    assert sorted(got) == sorted(want)
    if arch in REFERENCE_PVQ_TENSORS:
        assert len(got) == REFERENCE_PVQ_TENSORS[arch]
    assert not any("bias" in k or "ln_" in k or "pos_embedding" in k for k in got)
    floats = _flat(jax.tree.map(np.asarray, ref_float))
    codes = near_ties = 0
    for path, w in want.items():
        g = got[path]
        assert (g.group, g.k, tuple(g.shape), g.layout) == (w.group, w.k, tuple(w.shape),
                                                            w.layout), path
        gp, wp = g.pulses.numpy().astype(np.float64), np.asarray(w.pulses, np.float64)
        rows_g, weights = _groups(w, gp, np.asarray(floats[path], np.float64))
        rows_w, _ = _groups(w, wp, np.asarray(floats[path], np.float64))
        same = (rows_g == rows_w).all(-1)
        codes += same.size
        for i in np.flatnonzero(~same):
            a, b, y = rows_g[i], rows_w[i], weights[i]
            assert np.abs(a).sum() == np.abs(b).sum() == w.k, path
            cos_a, cos_b = y @ a / np.linalg.norm(a), y @ b / np.linalg.norm(b)
            assert abs(cos_a - cos_b) <= 1e-6 * abs(cos_b), (path, i, cos_a, cos_b)
            near_ties += 1
        # rho of each code, in _groups' order
        rho_g, rho_w = (np.moveaxis(r, -1, -2).reshape(-1) if w.layout == "matmul"
                        else r.reshape(-1) for r in (g.scales.numpy(), np.asarray(w.scales)))
        np.testing.assert_allclose(rho_g[same], rho_w[same], rtol=1e-6, atol=0, err_msg=path)
    assert near_ties <= max(1, codes // 1000), (near_ties, codes)


def test_whisper_packs_its_encoder_and_cross_projections():
    _, _, _, ref_pk, _, _, port_pk = _models("whisper-small")
    leaves = port_packed.packed_leaves(port_pk)
    assert "encoder/segments/seg0/b0/mixer/wq/kernel" in leaves
    assert "segments/seg0/b0/cross/wo/kernel" in leaves
    # the biases ride the kernels' epilogue as floats; positions stay float
    assert torch.is_tensor(port_pk["segments"]["seg0"]["b0"]["cross"]["wq"]["bias"])
    assert torch.is_tensor(port_pk["pos"]["pos_embedding"])


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py's decode checks, in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode agrees with the parallel forward (a VLM at
    positions after its prefix)."""
    ref_cfg, _, _, _, model, params, _ = _models(arch)
    batch = _port_batch(_batch(ref_cfg, s=SEQ, seed=21))
    full, _, _ = model.forward(params, batch, mode="train")
    half = SEQ // 2
    pre = {k: (v[:, :half] if k == "tokens" else v) for k, v in batch.items() if k != "targets"}
    logits, cache = model.prefill(params, pre, cache_len=SEQ)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, half - 1].numpy(), rtol=2e-2,
                               atol=2e-3)
    for t in range(half, half + 3):
        logits, cache = model.decode_step(params, cache, batch["tokens"][:, t : t + 1],
                                          ref_cfg.prefix_len + t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(), rtol=2e-2,
                                   atol=2e-3)


def test_whisper_cross_caches():
    """The cross cache is the encoder's K/V over the frames (the
    reference's values), dense under a KV quantizer, not padded to the
    cache length, and no decode step writes it."""
    ref_cfg, ref_model, ref_float, _, model, params, _ = _models("whisper-small")
    batch = _batch(ref_cfg, s=PROMPT, seed=31)
    batch.pop("targets")
    _, ref_cache = ref_model.prefill(ref_float, _ref_batch(batch), cache_len=32)
    with port_q.kv_quant_scope(port_q.KVQuant(block=BLOCK, group=GROUP)):
        _, cache = model.prefill(params, _port_batch(batch), cache_len=32)
        layer = cache["seg0"][1]["b0"]
        assert port_packed.is_packed_kv(layer["kv"])
        cross = layer["cross"]
        assert set(cross) == {"k", "v"} and tuple(cross["k"].shape) == (2, PROMPT, 4, 16)
        want = ref_cache["seg0"]["b0"]["cross"]
        np.testing.assert_allclose(cross["k"].numpy(), np.asarray(want["k"][1]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(cross["v"].numpy(), np.asarray(want["v"][1]), rtol=0,
                                   atol=1e-5)
        before = {n: t.clone() for n, t in cross.items()}
        _, cache = model.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.int64),
                                     PROMPT)
        for n, t in cache["seg0"][1]["b0"]["cross"].items():
            assert torch.equal(t, before[n])
        zero = model.init_cache(2, 24, device="cpu", enc_len=PROMPT)
        assert not port_packed.is_packed_kv(zero["seg0"][0]["b0"]["cross"])
        assert tuple(zero["seg0"][0]["b0"]["cross"]["k"].shape) == (2, PROMPT, 4, 16)


# ---------------------------------------------------------------------------
# the VLM position finding
# ---------------------------------------------------------------------------


def test_vlm_teacher_forced_positions_finding():
    """On reduced paligemma (f32, seed 0, prompt 12, 6 decode steps) the
    reference's teacher-forced decode departs from its own forward at every
    decode position (it decodes at ``prompt_len + i``, over the patches'
    cache rows); the port's equals the reference's forward."""
    ref_cfg, ref_model, ref_float, _, model, params, _ = _models("paligemma-3b")
    batch = _batch(ref_cfg, b=2, s=PROMPT + 6, seed=41)
    batch.pop("targets")
    seq, patches = batch["tokens"], batch["patches"]
    full, _, _ = ref_model.forward(ref_float, _ref_batch(batch), mode="prefill")
    want = np.asarray(full)[:, PROMPT - 1 : -1]
    ref_tf = np.asarray(ref_serve.teacher_forced_logits(
        ref_model, ref_float, jnp.asarray(seq), prompt_len=PROMPT,
        extra_batch={"patches": jnp.asarray(patches)}))
    got = port_serve.teacher_forced_logits(
        model, params, torch.from_numpy(seq.astype(np.int64)), prompt_len=PROMPT,
        extra_batch={"patches": torch.from_numpy(patches)}).numpy()
    assert ref_tf.shape == got.shape == want.shape == (2, 6, 128)
    gap = np.abs(ref_tf - want).max(axis=(0, 2))
    assert gap[0] < 1e-4 and (gap[1:] > 0.1).all(), gap
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_vlm_cache_holds_the_prefix_and_every_decode_position():
    """A prefix several KV blocks long (reduced paligemma with 40 patches,
    block 8): the prefill's planes hold the prefix plus ``cache_len``
    rounded up to a block, and ``generate`` (the device-position step)
    runs to its last position, which fills a block, giving the host-int
    step's tokens."""
    import dataclasses

    cfg = dataclasses.replace(get_config("paligemma-3b").reduced(), prefix_len=40)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    extra = {"patches": torch.randn((2, 40, cfg.d_model), generator=gen)}
    with port_q.kv_quant_scope(port_q.KVQuant(block=BLOCK, group=GROUP)):
        _, cache = model.prefill(params, {"tokens": tokens, **extra}, cache_len=24)
        assert cache["seg0"][0]["b0"]["kv"].k_pulses.shape[1] == 64  # 40 + 24
        out = port_serve.generate(model, params, tokens, gen=12, cache_len=24, extra_batch=extra)
        eager = port_serve.generate(model, params, tokens, gen=12, cache_len=24,
                                    extra_batch=extra, eager=True)
    assert tuple(out.shape) == (2, 24)
    assert torch.equal(out, eager)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


CI_FLAGS = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--pvq", "--act-int8", "--kv-pvq", "--kv-block", "8", "--kv-group", "16",
            "--agreement-min", "0.99"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    report, rc = port_serve.run(["--arch", arch, *CI_FLAGS])
    assert rc == 0, report
    assert report["generated_shape"] == [2, 12] and report["logits_finite"]
    assert report["act_int8_top1_agreement"] >= 0.99
    want = len(ref_packed.packed_leaves(_models(arch)[3]))
    assert report["pvq_tensors"] == want


def test_stub_inputs_follow_the_family():
    gemma, whisper, pali = (get_config(a).reduced() for a in ("gemma-2b", "whisper-small",
                                                             "paligemma-3b"))
    assert port_serve.stub_inputs(gemma, 2, 8, 1, "cpu") == {}
    frames = port_serve.stub_inputs(whisper, 2, 8, 1, "cpu")["frames"]
    patches = port_serve.stub_inputs(pali, 2, 8, 1, "cpu")["patches"]
    assert tuple(frames.shape) == (2, 8, 64) and tuple(patches.shape) == (2, 4, 64)
    assert torch.equal(frames, port_serve.stub_inputs(whisper, 2, 8, 1, "cpu")["frames"])


@pytest.mark.parametrize("arch", TEXT_ONLY)
def test_train_cli_on_cpu(arch, tmp_path):
    report, rc = port_train.run(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert rc == 0, report
    assert np.isfinite(report["loss_first10"]) and np.isfinite(report["loss_last10"])
    assert report["steps"] == 2 and report["restores"] == 0


@pytest.mark.parametrize("arch,what", [("whisper-small", "frames"), ("paligemma-3b", "patches")])
def test_train_cli_refuses_encdec_and_vlm(arch, what, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_train.run(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                        "--ckpt-dir", str(tmp_path)])
    assert e.value.code == 2
    assert f"no {what}" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("arch,reason", [("whisper-small", "cross-attention"),
                                         ("paligemma-3b", "patch prefix")])
def test_engine_refuses_encdec_and_vlm(arch, reason):
    _, _, _, _, model, _, port_pk = _models(arch)
    with port_q.kv_quant_scope(port_q.KVQuant(block=BLOCK, group=GROUP)):
        with pytest.raises(NotImplementedError, match=reason):
            port_engine.PVQEngine(model, port_pk, n_slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match=reason):
        port_serve.run(["--arch", arch, "--reduced", "--device", "cpu", "--engine", "--kv-pvq",
                        "--pvq", "--requests", "2"])


def _engine_trace(mod):
    return mod.poisson_trace(6, rate=0.0, vocab=128, prompt_lens=(6, 12), max_new=8, seed=2)


@pytest.mark.parametrize("arch", ["gemma-2b", "starcoder2-15b"])
def test_engine_tokens_match_reference_with_f32_activations(arch):
    """CI's saturating engine configuration (3 slots, 6 requests, rate 0),
    the KV cache PVQ-coded, f32 activations: the reference engine's tokens
    and schedule exactly."""
    ref_cfg, ref_model, _, ref_pk, model, _, port_pk = _models(arch)
    max_len = ref_engine.bucket_len(12 + 8, BLOCK)
    with ref_q.kv_quant_scope(ref_q.KVQuant(BLOCK, GROUP)):
        trace = _engine_trace(ref_engine)
        eng = ref_engine.PVQEngine(ref_model, ref_pk, n_slots=3, max_len=max_len)
        eng.warmup([len(r.prompt) for r in trace])
        want = eng.run(trace)
    with port_q.kv_quant_scope(port_q.KVQuant(BLOCK, GROUP)):
        port_trace = _engine_trace(port_engine)
        eng = port_engine.PVQEngine(model, port_pk, n_slots=3, max_len=max_len)
        eng.warmup([len(r.prompt) for r in port_trace])
        got = eng.run(port_trace)
        assert eng.alloc.used == 0
    assert [r.prompt for r in port_trace] == [list(r.prompt) for r in trace]
    for k in ("requests", "generated_tokens", "prefill_batches", "decode_steps", "evictions"):
        assert got[k] == want[k], k
    assert got["outputs"] == want["outputs"]


def test_export_whisper_writes_the_references_file(tmp_path):
    """The reference's packed reduced whisper written by both packages:
    the same bytes (``export --arch whisper-small --reduced``'s meta); the
    port's ``export`` of the same config runs, and the reference's file
    loads into the port's whisper with the reference's leaves."""
    _, _, _, ref_pk, model, _, port_pk = _models("whisper-small")
    meta = {"kind": "arch", "arch": "whisper-small-smoke", "reduced": True, "n_over_k": 1.0,
            "seed": 0}
    ref_art.write_pvqz(tmp_path / "ref.pvqz", ref_pk, meta=meta)
    port_art.write_pvqz(tmp_path / "port.pvqz", port_pk, meta=meta)
    assert (tmp_path / "port.pvqz").read_bytes() == (tmp_path / "ref.pvqz").read_bytes()

    report, rc = port_export.run(["--arch", "whisper-small", "--reduced", "--n-over-k", "1.0",
                                  "--out", str(tmp_path / "cli.pvqz"), "--device", "cpu"])
    assert rc == 0 and report["file_bytes"] == (tmp_path / "cli.pvqz").stat().st_size
    assert sorted(report["leaves"]) == [k for k, _ in port_packed.sorted_leaves(port_pk)]
    loaded = port_art.load_pvqz(tmp_path / "ref.pvqz", target=model.init(1, device="cpu"),
                                device="cpu")
    got = dict(port_packed.sorted_leaves(loaded))
    for path, leaf in port_packed.sorted_leaves(port_pk):
        if port_packed.is_packed(leaf):
            assert torch.equal(got[path].pulses, leaf.pulses), path
            assert torch.equal(got[path].scales, leaf.scales), path
        else:
            assert torch.equal(got[path], leaf), path


def test_chip_smoke_depth_cut_restores_the_published_config():
    """The card check's harness-only depth cut (starcoder2-15b and
    granite-8b at 4 layers, the artifact phase's smollm-360m): the cut
    config while active, the published one after, also on an error."""
    smoke = chip_smoke()
    with smoke.depth_cut("starcoder2-15b", 4) as cut:
        assert get_config("starcoder2-15b").n_layers == 4
        assert get_config("starcoder2-15b").d_model == 6144
        assert cut == {"arch": "starcoder2-15b", "n_layers": 4, "published_n_layers": 40,
                       "cut": True}
    assert get_config("starcoder2-15b").n_layers == 40
    with pytest.raises(RuntimeError):
        with smoke.depth_cut("granite-8b", 4):
            raise RuntimeError
    assert get_config("granite-8b").n_layers == 36
    with smoke.depth_cut("gemma-2b", None) as cut:
        assert cut["n_layers"] == 18 and not cut["cut"]
