"""The attention families' layers in the port against the JAX reference.

The same numpy inputs (seeded) go through both packages' functions:

* ``layernorm`` (eps 1e-5) and its gradients, in f32 and bf16;
* ``sinusoidal_positions`` (the whisper encoder's);
* ``init_dense(bias=True)``, ``init_layernorm``, ``init_positional`` and
  ``init_ffn`` of all five kinds with and without bias: the same names and
  shapes (other random numbers: a torch generator is not ``jax.random``);
* ``ffn`` of all five kinds with bias, on the reference's weights;
* ``full_causal_attention`` and ``chunked_causal_attention`` with the
  prefix-LM mask (one chunk and several), GQA;
* ``attention_forward`` non-causal (the encoder) and with the prefix mask,
  with biases and without RoPE (``rope_theta=None``);
* ``cross_attention_forward`` and ``cross_kv``, float and packed weights
  (v2 and v3 with the bias epilogue, through their plain versions);
* kernel v4's plain twin at head dim 256 (gemma's and paligemma's one KV
  head, 8 query rows) against the reference's kernel, and
  ``decode_attention_packed`` there against its exact oracle.

Tolerances: f32 ``atol 1e-5`` (``2e-5`` for attention, whose softmax sums
run in other orders), bf16 outputs within one bf16 ulp of the value
(``rtol 8e-3``), int8 activations ``atol 3e-2 * max|y|`` as
``tests/test_torch_model.py`` (a half-quantum tie may round one code the
other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.nn import attention as ref_attn
from repro.nn import layers as ref_layers
from repro_torch.convert import from_reference_params
from repro_torch.core import quantize as port_q
from repro_torch.nn import attention as port_attn
from repro_torch.nn import layers as port_layers

FFN_KINDS = ("swiglu", "geglu", "gelu", "relu", "relu2")


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


def _with_bias(p, rng):
    """The reference's params with nonzero biases (init makes them zero)."""
    if isinstance(p, dict):
        return {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
                    if k == "bias" else _with_bias(v, rng)) for k, v in p.items()}
    return p


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_shapes(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


# ---------------------------------------------------------------------------
# norms and positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"ln_scale": (1 + 0.1 * rng.normal(size=64)).astype(np.float32),
         "ln_bias": (0.1 * rng.normal(size=64)).astype(np.float32)}
    want = ref_layers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x).astype(dtype))
    got = port_layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=8e-3, atol=1e-6)


def test_layernorm_grads_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    g = rng.normal(size=(3, 64)).astype(np.float32)
    sc = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bi = (0.1 * rng.normal(size=64)).astype(np.float32)

    def ref_f(x, s, b):
        return jnp.sum(ref_layers.layernorm({"ln_scale": s, "ln_bias": b}, x) * g)

    want = jax.grad(ref_f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi))
    xt, st, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, sc, bi))
    y = port_layers.layernorm({"ln_scale": st, "ln_bias": bt}, xt)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (xt, st, bt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length,d", [(1, 64), (17, 64), (128, 768), (7, 10)])
def test_sinusoidal_positions_match_reference(length, d):
    want = np.asarray(ref_layers.sinusoidal_positions(length, d))
    got = port_layers.sinusoidal_positions(length, d)
    assert got.shape == want.shape == (length, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_param_inits_keep_reference_names_and_shapes():
    gen = torch.Generator().manual_seed(0)
    kw = dict(dtype=torch.float32, device="cpu")
    key = jax.random.PRNGKey(0)
    pairs = [
        (ref_layers.init_dense(key, 8, 12, bias=True),
         port_layers.init_dense(gen, 8, 12, bias=True, **kw)),
        (ref_layers.init_layernorm(12), port_layers.init_layernorm(12, **kw)),
        (ref_layers.init_positional(key, 33, 12), port_layers.init_positional(gen, 33, 12, **kw)),
    ]
    for kind in FFN_KINDS:
        for bias in (False, True):
            pairs.append((ref_layers.init_ffn(key, 8, 24, kind, bias=bias),
                          port_layers.init_ffn(gen, 8, 24, kind, bias=bias, **kw)))
    for want, got in pairs:
        assert _shapes(got) == _shapes(want)
    dense = pairs[0][1]
    assert torch.count_nonzero(dense["bias"]) == 0 and dense["kernel"].abs().max() > 0
    ln = pairs[1][1]
    assert torch.equal(ln["ln_scale"], torch.ones(12)) and torch.equal(ln["ln_bias"], torch.zeros(12))
    pe = pairs[2][1]["pos_embedding"]
    assert 0.01 < float(pe.std()) < 0.03  # N(0, 0.02^2), as the reference's
    with pytest.raises(ValueError):
        port_layers.init_ffn(gen, 8, 24, "tanh", **kw)


@pytest.mark.parametrize("kind", FFN_KINDS)
def test_ffn_with_bias_matches_reference(kind):
    rng = np.random.default_rng(2)
    p = _with_bias(ref_layers.init_ffn(jax.random.PRNGKey(3), 64, 96, kind, bias=True), rng)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    want = np.asarray(ref_layers.ffn(p, jnp.asarray(x), kind))
    got = port_layers.ffn(_port(p), torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("kind", ["gelu", "geglu"])
def test_packed_ffn_with_bias_matches_reference(kind, act):
    """The packed FFN: kernels v2 (f32 x) and v3 (``ActQuant``) with the
    fused bias epilogue, through their plain versions on the CPU."""
    rng = np.random.default_rng(4)
    p = _with_bias(ref_layers.init_ffn(jax.random.PRNGKey(5), 64, 256, kind, bias=True), rng)
    policy = ref_q.QuantPolicy(rules=(("kernel", 1.0, 256),), scale_mode="ls")
    q = ref_packed.quantize_params(p, policy)
    assert ref_packed.is_packed(q["wo"]["kernel"]) and "bias" in q["wo"]
    x = rng.normal(size=(3, 64)).astype(np.float32)
    with ref_q.act_quant_scope(ref_q.ActQuant() if act else None):
        want = np.asarray(ref_layers.ffn(q, jnp.asarray(x), kind))
    with port_q.act_quant_scope(port_q.ActQuant() if act else None):
        got = port_layers.ffn(_port(q), torch.from_numpy(x), kind).numpy()
    atol = 3e-2 * float(np.abs(want).max()) if act else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# attention: the prefix-LM mask, bidirectional, no RoPE, biases, cross
# ---------------------------------------------------------------------------


def _qkv(rng, b, s, h, n_kv, hd):
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("prefix_len", [0, 3, 9])
def test_full_attention_prefix_mask_matches_reference(prefix_len):
    q, k, v = _qkv(np.random.default_rng(6), 2, 12, 4, 2, 16)
    want = ref_attn.full_causal_attention(*map(jnp.asarray, (q, k, v)), scale=0.25,
                                          prefix_len=prefix_len)
    got = port_attn.full_causal_attention(*map(torch.from_numpy, (q, k, v)), scale=0.25,
                                          prefix_len=prefix_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    if prefix_len:
        # every query sees every prefix key: row 0 differs from the causal one
        causal = port_attn.full_causal_attention(*map(torch.from_numpy, (q, k, v)), scale=0.25)
        assert not torch.allclose(got[:, 0], causal[:, 0])
        torch.testing.assert_close(got[:, prefix_len:], causal[:, prefix_len:], rtol=0, atol=0)


@pytest.mark.parametrize("s,prefix_len", [(256, 4), (384, 256)])
def test_chunked_attention_prefix_mask_matches_reference(s, prefix_len):
    """Several 128-query chunks (the VLM's prefix-plus-prompt lengths)."""
    q, k, v = _qkv(np.random.default_rng(7), 1, s, 2, 1, 8)
    want = ref_attn.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), scale=0.3,
                                             q_chunk=128, prefix_len=prefix_len)
    got = port_attn.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3,
                                             q_chunk=128, prefix_len=prefix_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def _attn_params(rng, d, h, n_kv, hd, bias):
    p = ref_attn.init_attention(jax.random.PRNGKey(8), d, h, n_kv, hd, bias=bias)
    return _with_bias(p, rng) if bias else p


@pytest.mark.parametrize("causal,prefix_len,rope", [(False, 0, None), (True, 5, 10000.0),
                                                    (True, 0, None)])
def test_attention_forward_matches_reference(causal, prefix_len, rope):
    rng = np.random.default_rng(9)
    p = _attn_params(rng, 64, 4, 2, 16, bias=True)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=rope, causal=causal,
              prefix_len=prefix_len)
    want = ref_attn.attention_forward(p, jnp.asarray(x), **kw)
    got = port_attn.attention_forward(_port(p), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("packed,act", [(False, False), (True, False), (True, True)])
def test_cross_attention_matches_reference(packed, act):
    rng = np.random.default_rng(10)
    p = _attn_params(rng, 64, 4, 4, 16, bias=True)
    if packed:
        p = ref_packed.quantize_params(
            p, ref_q.QuantPolicy(rules=(("kernel", 1.0, 256),), scale_mode="ls"))
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    enc = rng.normal(size=(2, 7, 64)).astype(np.float32)
    with ref_q.act_quant_scope(ref_q.ActQuant() if act else None):
        kv_r = ref_attn.cross_kv(p, jnp.asarray(enc), n_heads=4, head_dim=16)
        want = ref_attn.cross_attention_forward(p, jnp.asarray(x), kv_r, n_heads=4, head_dim=16)
    pp = _port(p)
    with port_q.act_quant_scope(port_q.ActQuant() if act else None):
        kv_p = port_attn.cross_kv(pp, torch.from_numpy(enc), n_heads=4, head_dim=16)
        got = port_attn.cross_attention_forward(pp, torch.from_numpy(x), kv_p, n_heads=4,
                                                head_dim=16)
    assert tuple(kv_p["k"].shape) == kv_r["k"].shape == (2, 7, 4, 16)
    want = np.asarray(want)
    atol = 3e-2 * float(np.abs(want).max()) if act else 2e-5
    np.testing.assert_allclose(kv_p["k"].numpy(), np.asarray(kv_r["k"]), rtol=0, atol=atol)
    np.testing.assert_allclose(kv_p["v"].numpy(), np.asarray(kv_r["v"]), rtol=0, atol=atol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# kernel v4's plain twin at gemma's and paligemma's decode shape: head dim
# 256, one KV head, 8 query rows a KV head
# ---------------------------------------------------------------------------


def test_attn_plain_at_head_dim_256_matches_reference_kernel():
    """``pvq_attn_q_plain`` against the reference's kernel v4 (interpret
    mode) at hd 256, group 32, 8 query rows, two 128-column blocks: the
    tolerances of ``tests/test_torch_kernels.py``'s v4 check."""
    from repro.kernels.pvq_matmul import pvq_attn_q as ref_attn_q
    from repro_torch.kernels import pvq_matmul as port_mm

    bh, m, s, hd, group = 2, 8, 160, 256, 32
    rng = np.random.default_rng(13)
    q_i8, a = ref_q.quantize_activations(jnp.asarray(rng.normal(size=(bh, m, hd)),
                                                     jnp.float32), ref_q.ActQuant())
    kp = rng.integers(-12, 13, size=(bh, s, hd)).astype(np.int8)
    vp = rng.integers(-12, 13, size=(bh, s, hd)).astype(np.int8)
    ks = rng.uniform(0.02, 0.2, size=(bh, s, hd // group)).astype(np.float32)
    vs = rng.uniform(0.02, 0.2, size=(bh, s, hd // group)).astype(np.float32)
    kv_len = np.asarray([131, 160], np.int32)
    acc_r, m_r, l_r = map(np.asarray, ref_attn_q(
        q_i8, a, *map(jnp.asarray, (kp, ks, vp, vs, kv_len)), group=group, sm_scale=1 / 16,
        bs=128, interpret=True))
    acc, mm, ll = port_mm.pvq_attn_q_plain(
        torch.from_numpy(np.array(q_i8)), torch.from_numpy(np.array(a)),
        *(torch.from_numpy(t)[:, :, None] for t in (kp, ks, vp, vs)),
        torch.from_numpy(kv_len), group=group, sm_scale=1 / 16)
    np.testing.assert_allclose(mm.numpy(), m_r, rtol=1e-6)
    np.testing.assert_allclose(ll.numpy(), l_r, rtol=1e-4)
    np.testing.assert_allclose(acc.numpy(), acc_r, rtol=1e-4, atol=1e-4 * np.abs(acc_r).max())


@pytest.mark.parametrize("s,b", [(160, 4), (416, 4), (2048, 1)])
def test_packed_decode_at_head_dim_256_against_the_exact_oracle(s, b):
    """``decode_attention_packed`` (v4's plain twin, the tail leg, the
    merge) against ``exact=True`` (the dequantized cache through the dense
    attention) at hd 256, one KV head, 8 query heads, KV block 32, group
    32: relative L2 error 0.0136-0.0147 measured here, gated at 0.03 (the
    reference measures 0.013-0.014 at hd 64, ROADMAP queue 3)."""
    from repro_torch.core.packed import PackedKV

    gen = torch.Generator().manual_seed(s)
    k, v = (torch.randn((b, s, 1, 256), generator=gen) for _ in range(2))
    q = torch.randn((b, 1, 8, 256), generator=gen)
    kv = PackedKV.from_dense(k, v, kvq=port_q.KVQuant(block=32, group=32))
    length = torch.full((b,), s - 5)
    got = port_attn.decode_attention_packed(q, kv, scale=1 / 16, length=length, filled=s)
    want = port_attn.decode_attention_packed(q, kv, scale=1 / 16, length=length, filled=s,
                                             exact=True)
    assert float((got - want).norm() / want.norm()) <= 0.03
