"""The port's model against the JAX reference on identical weights.

The reference's reduced smollm parameters (and its packed codes) are
converted through numpy, so both packages compute on identical weights and
identical pulses.  Logits of ``prefill`` and of ``decode_step`` are
compared on the same tokens.  Tolerances: the f32 legs ``atol=1e-4``.  The
int8 legs: ``atol=3e-2 * max|logit|``, the measured bound with margin.  The
packed embedding makes a token row ``p * c`` (integer pulses times one row
factor), so after rmsnorm the activation codes ``x / s = 127 p / max p``
land exactly on half-quanta; a one-ulp difference between XLA's and
PyTorch's f32 mean/rsqrt rounds such a tie the other way, one code step.
Measured on this test's inputs: batch row 0 agrees to 1.2e-7, row 1 (which
holds such ties) by at most 1.07e-2 = 2.1% of max|logit|.  Where the
argmax tokens differ, the reference's own margin between the two tokens
must be below the measured perturbation at that position (a near-tie).  Decode crosses a KV block
boundary (block 8, positions 12..16), so the packed leg encodes a block
during decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.nn.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.nn.models import Model

PROMPT, STEPS, BLOCK = 12, 5, 8


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))


def to_numpy_tree(tree):
    if isinstance(tree, ref_packed.PackedPVQ):
        return {
            "pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
            "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
            "layout": tree.layout, "scale_mode": tree.scale_mode,
        }
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_get_config("smollm-360m").reduced()
    ref_model = RefModel(ref_cfg)
    ref_float = ref_model.init(jax.random.PRNGKey(1))
    policy = ref_q.QuantPolicy(
        rules=(("embedding", 0.5, 256), ("kernel|experts", 1.0, 256)), scale_mode="ls"
    )
    ref_packed_params = ref_packed.quantize_params(ref_float, policy)
    port_model = Model(get_config("smollm-360m").reduced())
    return {
        "ref_model": ref_model,
        "port_model": port_model,
        "float": (ref_float, from_reference_params(to_numpy_tree(ref_float))),
        "packed": (ref_packed_params, from_reference_params(to_numpy_tree(ref_packed_params))),
    }


def _run_ref(model, params, tokens, feed):
    cache_len = PROMPT + STEPS
    logits, cache = model.prefill(params, {"tokens": jnp.asarray(tokens)}, cache_len=cache_len)
    out = [np.asarray(logits[:, -1])]
    for i in range(STEPS):
        logits, cache = model.decode_step(
            params, cache, jnp.asarray(feed[:, i : i + 1]), jnp.int32(PROMPT + i)
        )
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out, 1)


def _run_port(model, params, tokens, feed):
    cache_len = PROMPT + STEPS
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=cache_len)
    out = [logits[:, -1].numpy()]
    for i in range(STEPS):
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[:, i : i + 1]), PROMPT + i)
        out.append(logits[:, -1].numpy())
    return np.stack(out, 1)


LEGS = {
    # name: (params, ActQuant?, KVQuant?, atol relative to max|logit| or absolute)
    "float": ("float", False, False),
    "float_kvpvq": ("float", False, True),
    "packed_f32": ("packed", False, False),
    "packed_int8": ("packed", True, False),
    "packed_int8_kvpvq": ("packed", True, True),
}


@pytest.mark.parametrize("leg", list(LEGS))
def test_prefill_and_decode_logits_match_reference(models, leg):
    which, act, kv = LEGS[leg]
    ref_params, port_params = models[which]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 128, size=(2, PROMPT)).astype(np.int32)
    feed = rng.integers(0, 128, size=(2, STEPS)).astype(np.int32)
    ref_aq = ref_q.ActQuant() if act else None
    port_aq = port_q.ActQuant() if act else None
    ref_kvq = ref_q.KVQuant(block=BLOCK, group=16) if kv else None
    port_kvq = port_q.KVQuant(block=BLOCK, group=16) if kv else None
    with ref_q.act_quant_scope(ref_aq), ref_q.kv_quant_scope(ref_kvq):
        want = _run_ref(models["ref_model"], ref_params, tokens, feed)
    with port_q.act_quant_scope(port_aq), port_q.kv_quant_scope(port_kvq):
        got = _run_port(models["port_model"], port_params, tokens.astype(np.int64), feed.astype(np.int64))
    assert got.shape == want.shape == (2, STEPS + 1, 128)
    atol = 3e-2 * float(np.abs(want).max()) if act else 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    pa, pb = want.argmax(-1), got.argmax(-1)
    margin = np.take_along_axis(want, pa[..., None], -1) - np.take_along_axis(want, pb[..., None], -1)
    noise = np.abs(got - want).max(-1, keepdims=True)
    assert ((pa == pb)[..., None] | (margin <= noise)).all()


def test_converted_params_keep_reference_paths(models):
    ref_params, port_params = models["packed"]
    assert sorted(port_packed.packed_leaves(port_params)) == sorted(
        ref_packed.packed_leaves(ref_params)
    )
    wq = port_packed.packed_leaves(port_params)["segments/seg0/b0/mixer/wq/kernel"]
    assert wq.pulses.dtype == torch.int8 and wq.pulses.shape == (2, 64, 64)


def test_attention_prefill_cache_and_init_cache(models):
    """The stand-alone prompt-cache constructor and the zero decode cache."""
    from repro.nn import attention as ref_attn
    from repro_torch.nn import attention as port_attn

    ref_params, port_params = models["packed"]
    x = np.random.default_rng(6).normal(size=(2, 12, 64)).astype(np.float32)
    # layer 0 of the stacked segment (PackedPVQ is a pytree of pulses/scales)
    ref_p = jax.tree.map(lambda t: t[0], ref_params["segments"]["seg0"]["b0"]["mixer"])
    from repro_torch.nn.transformer import layer_params

    port_p = layer_params(port_params["segments"]["seg0"], 0)["b0"]["mixer"]
    kw = dict(n_heads=4, n_kv_heads=4, head_dim=16)
    kvq_r, kvq_p = ref_q.KVQuant(block=8, group=16), port_q.KVQuant(block=8, group=16)
    want = ref_attn.attention_prefill_cache(ref_p, jnp.asarray(x), quantized=kvq_r, **kw)
    got = port_attn.attention_prefill_cache(port_p, torch.from_numpy(x), quantized=kvq_p, **kw)
    np.testing.assert_array_equal(got.k_pulses.numpy(), np.asarray(want.k_pulses))
    np.testing.assert_allclose(got.tail_v.numpy(), np.asarray(want.tail_v), atol=1e-5)

    with ref_q.kv_quant_scope(kvq_r):
        ref_cache = models["ref_model"].init_cache(2, 20)
    with port_q.kv_quant_scope(kvq_p):
        port_cache = models["port_model"].init_cache(2, 20, device="cpu")
    ref_kv = ref_cache["seg0"]["b0"]["kv"]
    assert len(port_cache["seg0"]) == ref_kv.k_pulses.shape[0]
    port_kv = port_cache["seg0"][0]["b0"]["kv"]
    assert tuple(port_kv.k_pulses.shape) == ref_kv.k_pulses.shape[1:]
    assert tuple(port_kv.tail_k.shape) == ref_kv.tail_k.shape[1:]
    assert port_kv.dtype == ref_kv.dtype
