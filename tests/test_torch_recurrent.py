"""The recurrent families (rwkv6-1.6b, jamba-1.5-large-398b's Mamba/attention
hybrid, deepseek-v2-236b's q-LoRA MLA and its 160-expert MoE) in the port
against the JAX reference, reduced.

Both packages compute on the reference's parameters (``jax.random`` init,
carried across as numpy by ``convert.from_reference_params``); the inputs
are numpy from a seed.

* The layers: RWKV's time mix and channel mix, Mamba's forward, decode and
  prefill-then-decode against the reference's functions in f32, ``rtol
  1e-5, atol 1e-6``; at bf16 parameters with f32 activations (the LoRA
  and ``dt_proj`` matmuls meet mixed dtypes: both packages cast the kernel
  to the activations' dtype) at the same tolerance.  The reference's own
  streaming checks (``tests/test_nn_components.py``) in the port: ``rtol
  2e-4, atol 2e-5`` for Mamba, ``5e-3/5e-4`` for RWKV; the decay in (0, 1).
* The models: forward logits ``atol 1e-4``; ``Model.loss`` ``rtol 1e-5``
  and every gradient leaf ``rtol 1e-4`` plus ``1e-5 * max|want|``; the
  prefill caches (the reference's names and shapes, recurrent leaves never
  padded) and 6 decode steps on the float weights, on packed weights with
  f32 activations and under ``--act-int8 --kv-pvq`` (``tests/
  test_torch_families.py``'s tolerances: ``atol 1e-4`` and ``3e-2 *
  max|logit|`` with any argmax split a near-tie); the device-position step
  identical to the host-int one, for 32 steps through ``generate``.
* The greedy tokens of ``generate`` on f32 activations identical to the
  reference's (``tests/test_integration.py``'s roundtrip).
* Packing under serve's policy: the reference's leaf set (10, 58 and 19
  tensors) with its pulses, but at near-ties of the greedy step, and rho
  within ``1e-6``; ``Model.init(pack=...)`` equal to init-then-pack byte
  for byte.
* The entry points: ``serve`` with CI's flags, ``train --reduced``, and the
  engine's up-front refusals.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.launch import serve as ref_serve
from repro.nn import mamba as ref_mamba
from repro.nn import rwkv as ref_rwkv
from repro.nn.models import Model as RefModel
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.nn import mamba as port_mamba
from repro_torch.nn import rwkv as port_rwkv
from repro_torch.nn.models import Model
from repro_torch.optim.adamw import tree_leaves, tree_map

ARCHS_RECURRENT = ("rwkv6-1.6b", "jamba-1.5-large-398b", "deepseek-v2-236b")
REFERENCE_PVQ_TENSORS = {"rwkv6-1.6b": 10, "jamba-1.5-large-398b": 58, "deepseek-v2-236b": 19}
PROMPT, STEPS, BLOCK, GROUP = 12, 6, 8, 16
SEQ = 16
F32 = dict(rtol=1e-5, atol=1e-6)


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


def _port(tree):
    return from_reference_params(_np_tree(tree))


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


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_every_reference_config_builds_field_for_field(arch, reduced):
    ref, port = ref_get_config(arch), get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert sorted(ARCHS) == sorted(REF_ARCHS)


def test_reduced_recurrent_configs_take_the_references_values():
    rwkv, jamba = get_config("rwkv6-1.6b").reduced(), get_config("jamba-1.5-large-398b").reduced()
    assert tuple(rwkv.rwkv) == (16, 8, 4) and rwkv.n_layers == 2
    assert tuple(jamba.ssm) == (4, 4, 2, 0) and jamba.n_layers == 8
    assert jamba.moe.n_shared == 0 and jamba.moe_period == 2


# ---------------------------------------------------------------------------
# the layers against the reference's functions
# ---------------------------------------------------------------------------


RWKV_CFG = dict(head_size=8, decay_lora=4, mix_lora=4)
SSM_CFG = dict(d_state=4, d_conv=4, expand=2)
D, B, S = 16, 2, 10


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _rwkv_params(seed, dtype=jnp.float32):
    cfg = ref_rwkv.RWKVConfig(**RWKV_CFG)
    tm = ref_rwkv.init_rwkv_time_mix(jax.random.PRNGKey(seed), D, cfg, dtype=dtype)
    cm = ref_rwkv.init_rwkv_channel_mix(jax.random.PRNGKey(seed + 1), D, 24, dtype=dtype)
    return cfg, port_rwkv.RWKVConfig(**RWKV_CFG), tm, cm


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_rwkv_time_mix_matches_reference(param_dtype):
    ref_cfg, cfg, tm, _ = _rwkv_params(0, getattr(jnp, param_dtype))
    ptm = _port(tm)
    assert ptm["time_mix_w1"].dtype == getattr(torch, param_dtype)
    assert ptm["time_mix_base"].dtype == ptm["time_faaaa"].dtype == torch.float32
    x = _x(1, (B, S, D))
    want = ref_rwkv.rwkv_time_mix(tm, jnp.asarray(x), ref_cfg)
    got = port_rwkv.rwkv_time_mix(ptm, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    # a continuation: the previous token and state given
    x_prev, state = _x(2, (B, D)), _x(3, (B, D // 8, 8, 8), 0.1)
    want, want_s = ref_rwkv.rwkv_time_mix(tm, jnp.asarray(x), ref_cfg, x_prev=jnp.asarray(x_prev),
                                          state=jnp.asarray(state), return_state=True)
    got, got_s = port_rwkv.rwkv_time_mix(ptm, torch.from_numpy(x), cfg,
                                         x_prev=torch.from_numpy(x_prev),
                                         state=torch.from_numpy(state), return_state=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    np.testing.assert_allclose(_np(got_s), np.asarray(want_s), **F32)
    assert got_s.dtype == torch.float32


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_rwkv_channel_mix_matches_reference(param_dtype):
    _, _, _, cm = _rwkv_params(4, getattr(jnp, param_dtype))
    pcm = _port(cm)
    assert pcm["cmix_base"].dtype == torch.float32
    x, x_prev = _x(5, (B, S, D)), _x(6, (B, D))
    for prev in (None, x_prev):
        want = ref_rwkv.rwkv_channel_mix(cm, jnp.asarray(x),
                                         x_prev=None if prev is None else jnp.asarray(prev))
        got = port_rwkv.rwkv_channel_mix(pcm, torch.from_numpy(x),
                                         x_prev=None if prev is None else torch.from_numpy(prev))
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_rwkv_decay_matches_reference_and_lies_in_the_unit_interval():
    _, _, tm, _ = _rwkv_params(2)
    x = _x(3, (1, 4, D), 1.0)
    want = np.asarray(ref_rwkv._decay(tm, jnp.asarray(x)))
    got = port_rwkv._decay(_port(tm), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, **F32)
    assert bool(((got > 0) & (got < 1)).all())


def test_rwkv_streaming_matches_forward():
    """``tests/test_nn_components.py``'s streaming check in the port."""
    _, cfg, tm, _ = _rwkv_params(0)
    p = _port(tm)
    x = torch.from_numpy(_x(1, (B, S, D)))
    full = port_rwkv.rwkv_time_mix(p, x, cfg)
    state, x_prev = None, torch.zeros((B, D))
    for t in range(S):
        y, state = port_rwkv.rwkv_time_mix(p, x[:, t : t + 1], cfg, x_prev=x_prev, state=state,
                                           return_state=True)
        x_prev = x[:, t]
        np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, t]), rtol=5e-3, atol=5e-4)


def _mamba_params(seed, dtype=jnp.float32):
    ref_cfg = ref_mamba.SSMConfig(**SSM_CFG)
    return ref_cfg, port_mamba.SSMConfig(**SSM_CFG), ref_mamba.init_mamba(
        jax.random.PRNGKey(seed), D, ref_cfg, dtype=dtype)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mamba_forward_decode_and_prefill_match_reference(param_dtype):
    ref_cfg, cfg, p = _mamba_params(0, getattr(jnp, param_dtype))
    pp = _port(p)
    assert pp["a_log"].dtype == pp["d_skip"].dtype == torch.float32
    assert pp["conv_kernel"].dtype == pp["dt_proj"]["bias"].dtype == getattr(torch, param_dtype)
    x = _x(1, (B, 12, D))
    want, want_c = ref_mamba.mamba_forward(p, jnp.asarray(x[:, :8]), ref_cfg, return_state=True)
    got, got_c = port_mamba.mamba_forward(pp, torch.from_numpy(x[:, :8]), cfg, return_state=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    for name in ("conv", "ssm"):
        assert tuple(got_c[name].shape) == want_c[name].shape
        np.testing.assert_allclose(_np(got_c[name]), np.asarray(want_c[name]), **F32)
    for t in range(8, 12):  # the prefill's state carries into decode
        want, want_c = ref_mamba.mamba_decode(p, jnp.asarray(x[:, t : t + 1]), want_c, ref_cfg)
        got, got_c = port_mamba.mamba_decode(pp, torch.from_numpy(x[:, t : t + 1]), got_c, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
        np.testing.assert_allclose(_np(got_c["ssm"]), np.asarray(want_c["ssm"]), **F32)
    # decode from the zero cache
    want_c = ref_mamba.init_mamba_cache(B, D, ref_cfg)
    got_c = port_mamba.init_mamba_cache(B, D, cfg, torch.float32, "cpu")
    for t in range(4):
        want, want_c = ref_mamba.mamba_decode(p, jnp.asarray(x[:, t : t + 1]), want_c, ref_cfg)
        got, got_c = port_mamba.mamba_decode(pp, torch.from_numpy(x[:, t : t + 1]), got_c, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("prefill", [0, 8])
def test_mamba_streaming_matches_forward(prefill):
    """``tests/test_nn_components.py``'s two decode checks in the port: from
    the zero cache, and continuing a prefill's state."""
    _, cfg, p = _mamba_params(2 if prefill else 0)
    p = _port(p)
    x = torch.from_numpy(_x(3 if prefill else 1, (B, 12 if prefill else S, D)))
    full = port_mamba.mamba_forward(p, x, cfg)
    if prefill:
        _, cache = port_mamba.mamba_forward(p, x[:, :prefill], cfg, return_state=True)
    else:
        cache = port_mamba.init_mamba_cache(B, D, cfg, torch.float32, "cpu")
    for t in range(prefill, x.shape[1]):
        y, cache = port_mamba.mamba_decode(p, x[:, t : t + 1], cache, cfg)
        np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, t]), rtol=2e-4, atol=2e-5)


def test_softplus_is_jaxs():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    np.testing.assert_allclose(_np(port_mamba.softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------


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
        _MODELS[arch] = (ref_cfg, ref_model, ref_float, ref_pk, model, _port(ref_float),
                         _port(ref_pk))
    return _MODELS[arch]


def _batch(cfg, b=2, s=SEQ, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)}


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
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
    for k in ("ce", "aux", "accuracy"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    g, w = _flat(got_g), _flat(jax.tree.map(np.asarray, want_g))
    assert sorted(g) == sorted(w)
    for key in w:
        want_a = np.asarray(w[key], np.float64)
        atol = 1e-5 * float(np.abs(want_a).max() or 1.0)
        np.testing.assert_allclose(g[key].double().numpy(), want_a, rtol=1e-4, atol=atol,
                                   err_msg=f"{arch} grad {key}")


RECURRENT_LEAVES = {"mamba", "rwkv_state", "rwkv_shift_att", "rwkv_shift_ffn"}
# batch 2, d 64: Mamba's window of d_conv - 1 rows of d_inner 128 and its
# (d_inner, d_state) state; RWKV's 4 heads of 16 and its token shifts
RECURRENT_SHAPES = {"mamba/conv": (2, 3, 128), "mamba/ssm": (2, 128, 4),
                    "rwkv_state": (2, 4, 16, 16), "rwkv_shift_att": (2, 64),
                    "rwkv_shift_ffn": (2, 64)}


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_prefill_caches_have_the_references_names_and_shapes(arch):
    """Each layer's cache entries are the reference's (its stacked leaves
    less the layer axis) at ``cache_len`` 24 after a 12-token prompt: the
    attention and MLA rows padded, every recurrent leaf unpadded and equal
    to the reference's."""
    ref_cfg, ref_model, ref_float, _, model, port_float, _ = _models(arch)
    batch = _batch(ref_cfg, s=PROMPT, seed=5)
    batch.pop("targets")
    _, ref_cache = ref_model.prefill(ref_float, _ref_batch(batch), cache_len=24)
    _, cache = model.prefill(port_float, _port_batch(batch), cache_len=24)
    want = _flat(jax.tree.map(np.asarray, ref_cache))
    got = {}
    for seg, layers in cache.items():
        for r, layer in enumerate(layers):
            for path, leaf in _flat(layer).items():
                got.setdefault(f"{seg}/{path}", {})[r] = leaf
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        for r, leaf in got[path].items():
            assert tuple(leaf.shape) == w.shape[1:], path
            if set(path.split("/")) & RECURRENT_LEAVES:
                assert tuple(leaf.shape) == RECURRENT_SHAPES[path.split("/", 2)[2]], path
                np.testing.assert_allclose(_np(leaf), w[r], rtol=1e-5, atol=1e-5, err_msg=path)
    kinds = {p.split("/")[2] for p in want}
    expect = {"rwkv6-1.6b": {"rwkv_state", "rwkv_shift_att", "rwkv_shift_ffn"},
              "jamba-1.5-large-398b": {"mamba", "kv"}, "deepseek-v2-236b": {"mla"}}[arch]
    assert kinds == expect


def _run_ref(model, params, batch, feed):
    logits, cache = model.prefill(params, _ref_batch(batch), cache_len=PROMPT + STEPS)
    out = [np.asarray(logits[:, -1])]
    for i in range(STEPS):
        logits, cache = model.decode_step(params, cache, jnp.asarray(feed[:, i : i + 1]),
                                          jnp.int32(PROMPT + i))
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out, 1)


def _run_port(model, params, batch, feed, device_pos=False):
    logits, cache = model.prefill(params, _port_batch(batch), cache_len=PROMPT + STEPS)
    out = [logits[:, -1].numpy()]
    b = feed.shape[0]
    for i in range(STEPS):
        pos = PROMPT + i
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


# reduced jamba's int8 leg is held block by block below, not end to end
MODEL_LEGS = [(arch, leg) for arch in ARCHS_RECURRENT for leg in LEGS
              if (arch, leg) != ("jamba-1.5-large-398b", "packed_int8_kvpvq")]


@pytest.mark.parametrize("arch,leg", MODEL_LEGS)
def test_prefill_and_decode_match_reference(arch, leg):
    which, act, kv = LEGS[leg]
    ref_cfg, ref_model, ref_float, ref_pk, model, port_float, port_pk = _models(arch)
    ref_params, port_params = (ref_float, port_float) if which == "float" else (ref_pk, port_pk)
    batch = _batch(ref_cfg, s=PROMPT, seed=11)
    batch.pop("targets")
    feed = np.random.default_rng(12).integers(0, 128, size=(2, STEPS)).astype(np.int32)
    with ref_q.act_quant_scope(ref_q.ActQuant() if act else None), \
            ref_q.kv_quant_scope(ref_q.KVQuant(block=BLOCK, group=GROUP) if kv else None):
        want = _run_ref(ref_model, ref_params, batch, feed)
    with port_q.act_quant_scope(port_q.ActQuant() if act else None), \
            port_q.kv_quant_scope(port_q.KVQuant(block=BLOCK, group=GROUP) if kv else None):
        got = _run_port(model, port_params, batch, feed)
        at_device = _run_port(model, port_params, batch, feed, device_pos=True)
    np.testing.assert_array_equal(at_device, got)
    assert got.shape == want.shape == (2, STEPS + 1, 128)
    _close_with_near_ties(got, want, act)


def _ref_layer(tree):
    """Layer 0 of a reference stack (one repeat in reduced jamba)."""
    if isinstance(tree, ref_packed.PackedPVQ):
        return dataclasses.replace(tree, pulses=tree.pulses[0], scales=tree.scales[0])
    if isinstance(tree, dict):
        return {k: _ref_layer(v) for k, v in tree.items()}
    return tree[0]


def test_jamba_int8_blocks_match_reference_on_its_inputs(monkeypatch):
    """Reduced jamba's int8 leg, block by block: each of the super-block's
    8 blocks (7 Mamba, 1 attention; 4 MoE, 4 dense) on packed weights with
    int8 activations, fed the reference's own input to that block (the
    prefill's hidden states from the packed embedding of a 12-token
    prompt) and normed by the reference's norm, gives the reference's
    output within ``atol 1e-5``.  The norms themselves agree within
    ``rtol 1e-6`` (the next test), which at exact rounding ties is enough
    to set an int8 level apart: end to end the two packages part."""
    from repro.nn import transformer as ref_T
    from repro_torch.nn import transformer as port_T

    ref_cfg, ref_model, _, ref_pk, model, _, port_pk = _models("jamba-1.5-large-398b")

    def reference_norm(cfg, p, x):
        ref_p = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
        return torch.from_numpy(np.array(ref_T._norm(ref_cfg, ref_p, jnp.asarray(x.numpy()))))

    monkeypatch.setattr(port_T, "_norm", reference_norm)
    tokens = _batch(ref_cfg, s=PROMPT, seed=11)["tokens"]
    ref_layer = _ref_layer(ref_pk["segments"]["seg0"])
    layer = port_T.unstack_layers(port_pk["segments"]["seg0"], 1)[0]
    plan = port_T.segment_plan(model.cfg)[0][1]
    with ref_q.act_quant_scope(ref_q.ActQuant()), port_q.act_quant_scope(port_q.ActQuant()):
        x = ref_model._embed_tokens(ref_pk, jnp.asarray(tokens), pos_offset=0)
        for i, spec in enumerate(ref_T.segment_plan(ref_cfg)[0][1]):
            want, _, _ = ref_T.block_forward(ref_cfg, spec, ref_layer[f"b{i}"], x, mode="prefill")
            got, _, _ = port_T.block_forward(model.cfg, plan[i], layer[f"b{i}"],
                                             torch.from_numpy(np.array(x)), mode="prefill")
            assert (plan[i].mixer, plan[i].ffn) == (spec.mixer, spec.ffn)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                       err_msg=f"block {i}")
            x = want


def test_jamba_int8_parts_from_the_reference_only_at_exact_rounding_ties():
    """Why reduced jamba's int8 leg parts end to end: the packed embedding's
    rows are integer multiples of rho, so after the first norm many
    activations sit exactly halfway between two int8 levels.  The two
    packages' norms differ by an ulp there, and every level they set
    differently is such a tie; Mamba's ``dt`` path (an int8 contraction of
    4) and the MoE routing then amplify one level.  The reference misses
    its own 0.99 gate on this config (0.75 under CI's flags)."""
    from repro.core.quantize import quantize_activations as ref_quant
    from repro_torch.core.quantize import quantize_activations as port_quant
    from repro_torch.nn import transformer as port_T
    from repro.nn import transformer as ref_T

    ref_cfg, ref_model, _, ref_pk, model, _, port_pk = _models("jamba-1.5-large-398b")
    tokens = _batch(ref_cfg, s=PROMPT, seed=11)["tokens"]
    x = ref_model._embed_tokens(ref_pk, jnp.asarray(tokens), pos_offset=0)
    want_h = ref_T._norm(ref_cfg, _ref_layer(ref_pk["segments"]["seg0"])["b0"]["ln_mix"], x)
    got_h = port_T._norm(model.cfg, port_T.unstack_layers(port_pk["segments"]["seg0"], 1)[0]
                         ["b0"]["ln_mix"], torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-6, atol=0)
    want_q, want_s = ref_quant(want_h, ref_q.ActQuant())
    got_q, got_s = port_quant(got_h, port_q.ActQuant())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)
    differ = got_q.numpy() != np.asarray(want_q)
    assert differ.any()
    v = np.asarray(want_h, np.float64) / np.asarray(want_s, np.float64)
    assert np.all(np.abs(np.abs(v[differ] - np.trunc(v[differ])) - 0.5) < 1e-4)
    assert np.all(np.abs(got_q.numpy().astype(int) - np.asarray(want_q).astype(int)) <= 1)


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_generate_tokens_match_reference_on_f32_activations(arch):
    """``tests/test_integration.py``'s roundtrip (prompt 8, 6 tokens, cache
    16) on the reference's weights: the same tokens."""
    _, ref_model, ref_float, _, model, port_float, _ = _models(arch)
    toks = np.random.default_rng(1).integers(0, 128, size=(2, 8)).astype(np.int32)
    want = np.asarray(ref_serve.generate(ref_model, ref_float, jnp.asarray(toks), gen=6,
                                         cache_len=16))
    got = port_serve.generate(model, port_float, torch.from_numpy(toks.astype(np.int64)), gen=6,
                              cache_len=16)
    assert want.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_captured_step_carries_the_recurrent_state_for_32_steps(arch):
    """The step a CUDA graph captures (device positions, a static cache the
    new states are written into) run eagerly here gives the host-int
    step's tokens and logits for 32 steps, over packed weights with int8
    activations and the PVQ KV cache."""
    _, _, _, _, model, _, port_pk = _models(arch)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 128, size=(2, 8)))
    with port_q.act_quant_scope(port_q.ActQuant()), \
            port_q.kv_quant_scope(port_q.KVQuant(block=BLOCK, group=GROUP)):
        runs = {}
        for eager in (False, True):
            logits = []
            out = port_serve.generate(model, port_pk, tokens, gen=32, cache_len=40,
                                      eager=eager, step_logits=logits)
            runs[eager] = (out, torch.stack(logits))
    assert tuple(runs[False][0].shape) == (2, 40)
    assert torch.equal(runs[False][0], runs[True][0])
    assert torch.equal(runs[False][1], runs[True][1])


def test_static_step_writes_the_new_state_into_its_cache():
    """One step of ``_StaticStep`` leaves the new recurrent states in the
    static cache's own tensors (the buffers a graph reads on replay)."""
    _, _, _, _, model, port_float, _ = _models("jamba-1.5-large-398b")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 128, size=(2, 8)))
    _, cache = model.prefill(port_float, {"tokens": tokens}, cache_len=16)
    static = port_serve._StaticStep(port_float, cache, 2, torch.device("cpu"))
    ssm = cache["seg0"][0]["b0"]["mamba"]["ssm"]
    before = ssm.clone()
    _, want = model.decode_step(port_float, copy.deepcopy(cache), tokens[:, -1:], 8)
    static.run(model, tokens[:, -1:], 8, False)
    assert static.cache["seg0"][0]["b0"]["mamba"]["ssm"] is ssm
    assert not torch.equal(ssm, before)
    assert torch.equal(ssm, want["seg0"][0]["b0"]["mamba"]["ssm"])


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def _groups(leaf, pulses, w):
    g = leaf.group
    if leaf.layout == "matmul":
        lead, k, n = pulses.shape[:-2], pulses.shape[-2], pulses.shape[-1]

        def rows(a):
            a = a.reshape(*lead, k // g, g, n)
            return np.moveaxis(a, -1, -2).reshape(-1, g)
        return rows(pulses), rows(w)
    return pulses.reshape(-1, g), w.reshape(-1, g)


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_packed_pulses_identical_under_serve_policy(arch):
    """The port packs the reference's leaf set (``pvq_tensors`` 10, 58, 19)
    from the same float weights with the reference's pulses, but at
    near-ties of the greedy step (codes within 1e-6 in cosine, at most one
    in a thousand), rho within ``1e-6``; the recurrence's leaves (``time_*``,
    ``a_log``, ``d_skip``, ``conv_kernel``, ``cmix_base``) stay raw."""
    _, _, ref_float, ref_pk, model, port_float, _ = _models(arch)
    dense = tree_map(lambda t: t.clone(), port_float)
    got = port_packed.packed_leaves(port_packed.quantize_params(dense, _policy(port_q,
                                                                           model.cfg)))
    want = ref_packed.packed_leaves(ref_pk)
    assert sorted(got) == sorted(want)
    assert len(got) == REFERENCE_PVQ_TENSORS[arch]
    raw = ("time_", "a_log", "d_skip", "conv_kernel", "conv_bias", "cmix_base", "router", "ln_",
           "wk_b", "wv_b", "bias")
    assert not any(r in k for k in got for r in raw)
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
        rho_g, rho_w = (np.moveaxis(r, -1, -2).reshape(-1) if w.layout == "matmul"
                        else r.reshape(-1) for r in (g.scales.numpy(), np.asarray(w.scales)))
        np.testing.assert_allclose(rho_g[same], rho_w[same], rtol=1e-6, atol=0, err_msg=path)
    assert near_ties <= max(1, codes // 1000), (near_ties, codes)


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif port_packed.is_packed(a):
        assert port_packed.is_packed(b), path
        assert (a.group, a.k, a.shape, a.dtype, a.layout, a.scale_mode) == (
            b.group, b.k, b.shape, b.dtype, b.layout, b.scale_mode), path
        assert torch.equal(a.pulses, b.pulses), path
        assert torch.equal(a.scales, b.scales), path
    else:
        assert not port_packed.is_packed(b) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS_RECURRENT + ("smollm-360m", "whisper-small"))
def test_pack_at_init_is_init_then_pack_byte_for_byte(arch):
    """``Model.init(pack=policy)`` (``serve --pvq``) packs each part as it
    is built; the tree is ``quantize_params(init(...), policy)``'s, every
    pulse and scale, in bf16 parameters too (the serving dtype)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="bfloat16")
    model = Model(cfg)
    policy = port_serve.serving_policy(cfg)
    want = port_packed.quantize_params(model.init(3, device="cpu"), policy)
    got = model.init(3, device="cpu", pack=policy)
    _same_tree(got, want)
    assert port_packed.packed_stats(got, entropy=False)["packed_tensors"] == (
        REFERENCE_PVQ_TENSORS.get(arch) or len(port_packed.packed_leaves(want)))


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_convert_carries_every_leaf_in_the_serving_dtypes(arch):
    """The reference's reduced model in bf16 parameters (the published
    configs' dtype), float and packed, through ``from_reference_params``:
    every leaf in its dtype (``a_log``, ``d_skip``, ``time_mix_base``,
    ``time_decay_base``, ``time_faaaa``, ``cmix_base`` and the router f32;
    ``conv_kernel``, ``conv_bias``, the ``time_*`` LoRAs and ``dt_proj``'s
    bias bf16) with its values, and every packed leaf byte for byte."""
    cfg = dataclasses.replace(ref_get_config(arch).reduced(), param_dtype="bfloat16")
    ref_model = RefModel(cfg)
    ref_float = ref_model.init(jax.random.PRNGKey(1), max_seq=64)
    ref_pk = ref_packed.quantize_params(ref_float, _policy(ref_q, cfg))
    for tree in (ref_float, ref_pk):
        want = _flat(tree)
        got = _flat(_port(tree))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            if isinstance(w, ref_packed.PackedPVQ):
                assert np.array_equal(g.pulses.numpy(), np.asarray(w.pulses)), path
                assert np.array_equal(g.scales.numpy(), np.asarray(w.scales)), path
                continue
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
            np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32), err_msg=path)
    raw_f32 = ("a_log", "d_skip", "time_mix_base", "time_decay_base", "time_faaaa", "cmix_base")
    leaves = _flat(_port(ref_float))
    for path, leaf in leaves.items():
        if path.rsplit("/", 1)[-1] in raw_f32:
            assert leaf.dtype == torch.float32, path
        if any(n in path for n in ("conv_kernel", "conv_bias", "time_mix_w", "time_decay_w",
                                   "dt_proj/bias")):
            assert leaf.dtype == torch.bfloat16, path


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


CI_FLAGS = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--pvq", "--act-int8", "--kv-pvq", "--kv-block", "8", "--kv-group", "16",
            "--agreement-min", "0.99"]


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_serve_cli_on_cpu(arch):
    """CI's flags: finite logits, the reference's ``pvq_tensors`` and, for
    rwkv6-1.6b and deepseek-v2-236b, the 0.99 gate (the reference scores
    1.0 on both).  Reduced jamba-1.5-large-398b misses the gate in the
    reference too (0.75 on its weights), so its agreement is reported."""
    report, rc = port_serve.run(["--arch", arch, *CI_FLAGS])
    assert report["generated_shape"] == [2, 12] and report["logits_finite"]
    assert report["pvq_tensors"] == REFERENCE_PVQ_TENSORS[arch]
    assert report["decode_step_captures"] == 0  # the CPU runs the step eagerly
    if arch == "jamba-1.5-large-398b":
        assert 0.0 <= report["act_int8_top1_agreement"] <= 1.0
        assert rc == (1 if "agreement_fail" in report else 0)
    else:
        assert rc == 0, report
        assert report["act_int8_top1_agreement"] >= 0.99


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_train_cli_on_cpu(arch, tmp_path):
    report, rc = port_train.run(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert rc == 0, report
    assert np.isfinite(report["loss_first10"]) and np.isfinite(report["loss_last10"])
    assert report["steps"] == 2 and report["restores"] == 0


@pytest.mark.parametrize("arch,mixer", [("rwkv6-1.6b", "rwkv"),
                                        ("jamba-1.5-large-398b", "mamba"),
                                        ("deepseek-v2-236b", "mla"),
                                        ("deepseek-v2-lite-16b", "mla")])
def test_engine_refuses_recurrent_and_mla_models_up_front(arch, mixer):
    model = Model(get_config(arch).reduced())
    with port_q.kv_quant_scope(port_q.KVQuant(block=BLOCK, group=GROUP)):
        with pytest.raises(NotImplementedError, match=f"has {mixer} blocks"):
            port_engine.PVQEngine(model, {}, n_slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match=f"has {mixer} blocks"):
        port_serve.run(["--arch", arch, "--reduced", "--device", "cpu", "--engine", "--kv-pvq",
                        "--pvq", "--requests", "2"])


def test_chip_smoke_recurrent_phase_cuts_and_kernels():
    """The card check's recurrent phase: jamba at one super-block (8 of 72
    layers: one repeat of the 8-block pattern) and deepseek-v2-236b at 4
    of 60 (1 dense + 3 MoE), the published widths kept; each model
    requires the kernels its path runs: v4 on jamba only (rwkv6 has no
    attention, deepseek's MLA cache is dense), the batched kernels on the
    two MoE models."""
    from _chip_smoke_module import chip_smoke
    from repro_torch.kernels import LAUNCHES
    from repro_torch.nn import transformer as port_T

    smoke = chip_smoke()
    expect = {arch: set(kernels) for arch, _, kernels in smoke.RECURRENT_FULL}
    assert set(expect) == set(ARCHS_RECURRENT)
    assert all(k <= set(LAUNCHES) for k in expect.values())
    assert {a for a, k in expect.items() if "pvq_attn_q" in k} == {"jamba-1.5-large-398b"}
    assert {a for a, k in expect.items() if "pvq_matmul_q_batched" in k} == {
        "jamba-1.5-large-398b", "deepseek-v2-236b"}
    for arch, layers, _ in smoke.RECURRENT_FULL:
        with smoke.depth_cut(arch, layers):
            cfg = get_config(arch)
            plan = port_T.segment_plan(cfg)
        assert cfg.d_model == ref_get_config(arch).d_model
        if arch == "jamba-1.5-large-398b":
            assert [(r, [(b.mixer, b.ffn) for b in p]) for r, p in plan] == [
                (1, [("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
                     ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe")])]
        elif arch == "deepseek-v2-236b":
            assert [(r, p[0].ffn) for r, p in plan] == [(1, "dense0"), (3, "moe")]
        else:
            assert [(r, p[0].mixer, p[0].ffn) for r, p in plan] == [(24, "rwkv", "cmix")]
    assert get_config("jamba-1.5-large-398b").n_layers == 72
