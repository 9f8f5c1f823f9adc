"""The port's MoE/MLA slice (deepseek-v2-lite-16b) against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages; the
reference's Pallas kernels run in interpret mode, as its own tests run them.
Here the port runs each kernel's plain PyTorch version (the route a CPU
tensor takes); the CUDA kernels are held against those plain versions on
the card (``test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:

* routing: dispatch identical; combine ``atol=1e-6`` (the renormalized
  gates are f32 quotients of softmax values);
* matmuls (batched v2/v3, ``packed_matmul_stacked``, the DMA body):
  ``rtol=1e-5, atol=1e-5 * max|y|``, the 2-D matmuls' tolerance (sums in
  another order); per slice, each batched plain version is bit-identical
  to its 2-D plain version before the activation;
* ``moe_forward`` and the reduced model's logits: f32 legs ``atol=1e-4``;
  int8 legs ``atol=3e-2 * max|y|`` (a one-ulp difference of XLA's and
  PyTorch's f32 rounding may flip an int8 code on a half-quantum, as in
  ``test_torch_model.py``), on every batch row whose routing matches the
  reference's (a row is excused only where each differing routing choice
  is a near-tie of the reference's router); MLA ``atol=1e-4``;
* packing: pulses identical, scales ``atol=1e-6``; chunked stacked packing
  byte-identical to whole-stack packing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.kernels import ops as ref_ops
from repro.kernels import pvq_matmul as ref_mm
from repro.launch import serve as ref_serve
from repro.nn import mla as ref_mla
from repro.nn import moe as ref_moe
from repro.nn.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.kernels import ops
from repro_torch.kernels import pvq_matmul as port_mm
from repro_torch.launch import serve as port_serve
from repro_torch.nn import mla as port_mla
from repro_torch.nn import moe as port_moe
from repro_torch.nn.models import Model

ARCH = "deepseek-v2-lite-16b"


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


def _policy(mod, cfg):
    return mod.QuantPolicy(
        rules=(("embedding", cfg.pvq.n_over_k_embed, cfg.pvq.group),
               ("kernel|experts", 1.0, cfg.pvq.group)),
        scale_mode="ls",
    )


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_get_config(ARCH).reduced()
    ref_model = RefModel(ref_cfg)
    ref_float = ref_model.init(jax.random.PRNGKey(5))
    ref_packed_params = ref_packed.quantize_params(ref_float, _policy(ref_q, ref_cfg))
    return {
        "ref_cfg": ref_cfg,
        "ref_model": ref_model,
        "port_model": Model(get_config(ARCH).reduced()),
        "float": (ref_float, from_reference_params(to_numpy_tree(ref_float))),
        "packed": (ref_packed_params, from_reference_params(to_numpy_tree(ref_packed_params))),
    }


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_asdict_matches_reference(reduced):
    ref, port = ref_get_config(ARCH), get_config(ARCH)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.resolved_head_dim == ref.resolved_head_dim


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n_experts,top_k,g,s,pad",
    [
        (4, 2, 1, 40, 0),     # reduced config, one group
        (4, 2, 2, 64, 48),    # t = 80 > group 64: the padding is masked
        (64, 6, 1, 4, 0),     # full-width decode: C = 1, drops every step
        (64, 6, 1, 512, 0),   # full-width prefill: C = 60
    ],
)
def test_routing_matches_reference(n_experts, top_k, g, s, pad):
    cfg_r = ref_moe.MoEConfig(n_experts=n_experts, top_k=top_k, group_size=s)
    cfg_p = port_moe.MoEConfig(n_experts=n_experts, top_k=top_k, group_size=s)
    logits = np.random.default_rng(s + pad).normal(size=(g, s, n_experts)).astype(np.float32)
    mask = None
    if pad:
        mask = (np.arange(g * s) < g * s - pad).reshape(g, s)
    routing = jax.jit(ref_moe._routing, static_argnames=("cfg", "light"))
    disp_r, comb_r, _, aux_r = routing(
        jnp.asarray(logits), cfg_r, token_mask=None if mask is None else jnp.asarray(mask)
    )
    disp_p, comb_p, aux_p = port_moe._routing(
        torch.from_numpy(logits), cfg_p, token_mask=None if mask is None else torch.from_numpy(mask)
    )
    np.testing.assert_array_equal(disp_p.float().numpy(), np.asarray(disp_r, np.float32))
    np.testing.assert_allclose(comb_p.numpy(), np.asarray(comb_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=1e-5)
    if pad:  # padded tokens claim no slot
        assert float(disp_p.float()[torch.from_numpy(~mask)].sum()) == 0.0
    c = port_moe.routing_capacity(cfg_p, s)
    assert c == ref_moe.routing_capacity(cfg_r, s)
    # every slot holds at most one token; over-capacity choices are dropped
    assert float(disp_p.float().sum(1).max()) <= 1.0
    assert port_moe.dispatch_gemm_rows(cfg_p, g * s - pad) == ref_moe.dispatch_gemm_rows(cfg_r, g * s - pad)


def test_topk_argmax_takes_the_first_of_tied_maxima():
    probs = torch.tensor([[0.3, 0.3, 0.1, 0.3]])
    vals, idx = port_moe._topk_argmax(probs, 3)
    vr, ir = ref_moe._topk_argmax(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ir).tolist() == [[0, 1, 3]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vr))


# ---------------------------------------------------------------------------
# batched kernels: plain versions against the reference kernels
# ---------------------------------------------------------------------------


def _bank(seed, e, k, n, group):
    """Expert-stacked PVQ codes: int8 pulses (E, k, n), rho (E, k/group, n)."""
    w = np.random.default_rng(seed).laplace(size=(e, k, n)).astype(np.float32)
    bank = ref_packed.pack_matmul(jnp.asarray(w), group=group, k=group, scale_mode="ls")
    return np.array(bank.pulses), np.array(bank.scales)


BATCHED = [(e, m) for e in (1, 4) for m in (1, 7, 60)]


@pytest.mark.parametrize("e,m", BATCHED)
def test_batched_v2_plain_matches_reference_kernel(e, m):
    k, n, group = 256, 72, 128  # ragged n (not a multiple of 32 or 128)
    pulses, scales = _bank(e * 100 + m, e, k, n, group)
    x = np.random.default_rng(m).normal(size=(e, m, k)).astype(np.float32)
    want = ref_mm.pvq_matmul_batched(
        jnp.asarray(x), jnp.asarray(pulses), jnp.asarray(scales), group=group,
        bm=64, bn=128, bk=128, activation="silu", interpret=True,
    )
    args = [torch.from_numpy(t) for t in (x, pulses, scales)]
    got = port_mm.pvq_matmul_batched_plain(*args, group=group, activation="silu")
    _close(got.numpy(), want)
    # per slice, the 2-D plain version's arithmetic bit for bit (before the
    # activation: PyTorch's vectorized CPU silu rounds a tensor's tail
    # elements apart from its body, so it is not elementwise across shapes)
    lin = port_mm.pvq_matmul_batched_plain(*args, group=group)
    for i in range(e):
        assert torch.equal(lin[i], port_mm.pvq_matmul_plain(args[0][i], args[1][i], args[2][i],
                                                            group=group))


@pytest.mark.parametrize("e,m", BATCHED)
def test_batched_v3_plain_matches_reference_kernel(e, m):
    k, n, group = 256, 72, 128
    pulses, scales = _bank(e * 100 + m + 1, e, k, n, group)
    rng = np.random.default_rng(m + 1)
    x_q = rng.integers(-127, 128, size=(e, m, k)).astype(np.int8)
    a = rng.uniform(0.005, 0.02, size=(e, m, 1)).astype(np.float32)
    want = ref_mm.pvq_matmul_q_batched(
        jnp.asarray(x_q), jnp.asarray(pulses), jnp.asarray(scales), jnp.asarray(a),
        group=group, bm=64, bn=128, bk=128, activation="silu", interpret=True,
    )
    args = [torch.from_numpy(t) for t in (x_q, pulses, scales, a)]
    got = port_mm.pvq_matmul_q_batched_plain(*args, group=group, activation="silu")
    _close(got.numpy(), want)
    lin = port_mm.pvq_matmul_q_batched_plain(*args, group=group)
    for i in range(e):  # per slice bit for bit, before the activation
        assert torch.equal(lin[i], port_mm.pvq_matmul_q_plain(*(t[i] for t in args), group=group))


def test_dma_body_matches_batched_plain_per_slice():
    """The reference's ``_kernel_q_dma`` (pulses streamed in bk-row chunks
    through a 2-slot ring), forced on at 4 chunks, against the port's
    batched v3 plain version on each slice."""
    e, m, k, n, group, bk = 2, 16, 512, 160, 128, 128
    pulses, scales = _bank(31, e, k, n, group)
    rng = np.random.default_rng(32)
    x_q = rng.integers(-127, 128, size=(e, m, k)).astype(np.int8)
    a = rng.uniform(0.005, 0.02, size=(e, m, 1)).astype(np.float32)
    assert k // bk >= 2
    got = port_mm.pvq_matmul_q_batched_plain(
        *(torch.from_numpy(t) for t in (x_q, pulses, scales, a)), group=group
    )
    for i in range(e):
        want = ref_mm.pvq_matmul_q(
            jnp.asarray(x_q[i]), jnp.asarray(pulses[i]), jnp.asarray(scales[i]),
            jnp.asarray(a[i]), group=group, bm=8, bn=128, bk=bk, dma_streaming=True,
            interpret=True,
        )
        _close(got[i].numpy(), want)


def test_batched_per_tile_scales_match_2d_plain():
    e, m, k, n, group = 3, 5, 96, 40, 32
    rng = np.random.default_rng(41)
    pulses = torch.from_numpy(rng.integers(-9, 10, size=(e, k, n)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, size=(e, k // group, n)).astype(np.float32))
    x_q = torch.from_numpy(rng.integers(-127, 128, size=(e, m, k)).astype(np.int8))
    a = torch.from_numpy(rng.uniform(0.005, 0.02, size=(e, m, k // group)).astype(np.float32))
    got = port_mm.pvq_matmul_q_batched_plain(x_q, pulses, scales, a, group=group)
    for i in range(e):
        assert torch.equal(got[i], port_mm.pvq_matmul_q_plain(
            x_q[i], pulses[i], scales[i], a[i], group=group))
    for bad in ((e, m, 2), (e, 1, 1)):
        with pytest.raises(ValueError, match="act_scale"):
            port_mm.pvq_matmul_q_batched_plain(x_q, pulses, scales, torch.ones(bad), group=group)


# ---------------------------------------------------------------------------
# ops.packed_matmul_stacked
# ---------------------------------------------------------------------------


def _stacked_pair(seed, e, d_in, n, group):
    w = np.random.default_rng(seed).normal(size=(e, d_in, n)).astype(np.float32)
    ref = ref_packed.pack_matmul(jnp.asarray(w), group=group, k=group, scale_mode="ls")
    return ref, from_reference_params(to_numpy_tree(ref))


@pytest.mark.parametrize("mode", [None, "per_row", "per_tile"])
def test_packed_matmul_stacked_matches_reference(mode):
    # d_in 96 < k_pad 128: x is padded before it is quantized
    e, m, d_in, n, group = 4, 7, 96, 40, 64
    ref_bank, port_bank = _stacked_pair(51, e, d_in, n, group)
    assert port_bank.k_pad == 128 > d_in
    x = np.random.default_rng(52).normal(size=(e, m, d_in)).astype(np.float32)
    aq_r = ref_q.ActQuant(mode=mode) if mode else None
    aq_p = port_q.ActQuant(mode=mode) if mode else None
    want = ref_ops.packed_matmul_stacked(jnp.asarray(x), ref_bank, activation="relu",
                                         act_quant=aq_r, interpret=True)
    got = ops.packed_matmul_stacked(torch.from_numpy(x), port_bank, activation="relu",
                                    act_quant=aq_p)
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, m, n)
    _close(got.numpy(), want)


def test_packed_matmul_stacked_act_scale_is_act_quant():
    """The quantize-once contract: a pre-quantized ``(int8 x, act_scale)``
    gives exactly what ``act_quant`` gives."""
    e, m, d_in, n, group = 4, 6, 128, 24, 64
    _, port_bank = _stacked_pair(53, e, d_in, n, group)
    x = torch.from_numpy(np.random.default_rng(54).normal(size=(e, m, d_in)).astype(np.float32))
    x_q, a = port_q.quantize_activations(x, port_q.ActQuant())
    want = ops.packed_matmul_stacked(x, port_bank, act_quant=port_q.ActQuant())
    got = ops.packed_matmul_stacked(x_q, port_bank, act_scale=a)
    assert torch.equal(got, want)


def test_packed_matmul_stacked_checks_raise_like_reference():
    e, m, d_in, n, group = 2, 3, 96, 16, 64
    ref_bank, port_bank = _stacked_pair(55, e, d_in, n, group)
    bad = {
        "x width": (np.zeros((e, m, 100), np.float32), {}),
        "expert axis": (np.zeros((e + 1, m, d_in), np.float32), {}),
        "x rank": (np.zeros((m, d_in), np.float32), {}),
        "float x with act_scale": (np.zeros((e, m, d_in), np.float32),
                                   {"act_scale": np.ones((e, m, 1), np.float32)}),
    }
    for what, (x, kw) in bad.items():
        with pytest.raises(ValueError):
            ref_ops.packed_matmul_stacked(jnp.asarray(x), ref_bank, interpret=True,
                                          **{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(ValueError):
            ops.packed_matmul_stacked(torch.from_numpy(x), port_bank,
                                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    x = torch.zeros(e, m, d_in)
    for leaf in (port_bank.stack_item(0),
                 port_packed.pack_flat(torch.randn(e, d_in, n), group=group, k=group)):
        with pytest.raises(ValueError):
            ops.packed_matmul_stacked(x, leaf)


# ---------------------------------------------------------------------------
# moe_forward and MLA
# ---------------------------------------------------------------------------


def _moe_layer(models, which):
    """Layer 0 of the MoE segment in both packages (reference params sliced
    from its scan stack; the port's through ``unstack_layers``)."""
    from repro_torch.nn.transformer import unstack_layers

    ref_params, port_params = models[which]
    ref_p = jax.tree.map(lambda t: t[0], ref_params["segments"]["seg1"]["b0"]["ffn"])
    port_p = unstack_layers(port_params["segments"]["seg1"], 1)[0]["b0"]["ffn"]
    return ref_p, port_p


@pytest.mark.parametrize("which,act", [("float", False), ("packed", False), ("packed", True)])
def test_moe_forward_matches_reference(models, which, act, monkeypatch):
    ref_p, port_p = _moe_layer(models, which)
    if which == "packed":
        bank = port_p["wi_up_experts"]
        assert port_packed.is_packed(bank) and bank.pulses.ndim == 3
    cfg_r, cfg_p = models["ref_cfg"].moe, get_config(ARCH).reduced().moe
    x = np.random.default_rng(61).normal(size=(2, 40, 64)).astype(np.float32)  # t 80 > group 64
    aq_r = ref_q.ActQuant() if act else None
    aq_p = port_q.ActQuant() if act else None
    want, aux_r = ref_moe.moe_forward(ref_p, jnp.asarray(x), cfg_r, act_quant=aq_r)
    calls = []
    quantize = port_q.quantize_activations

    def counting(t, *a, **kw):
        calls.append(tuple(t.shape))
        return quantize(t, *a, **kw)

    monkeypatch.setattr(port_q, "quantize_activations", counting)
    with port_q.act_quant_scope(aq_p):
        got, aux_p = port_moe.moe_forward(port_p, torch.from_numpy(x), cfg_p, act_quant=aq_p)
    want = np.asarray(want)
    atol = 3e-2 * float(np.abs(want).max()) if act else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=1e-5)
    if act:
        # the (E, g*C, d) dispatch buffer is quantized once for up and
        # gate, the hidden once for wo: two 3-D quantizations
        assert [s for s in calls if len(s) == 3] == [(4, 2 * 40, 64), (4, 2 * 40, 32)]


def test_mla_forward_and_decode_match_reference(models):
    from repro_torch.nn.transformer import unstack_layers

    ref_params, port_params = models["packed"]
    ref_p = jax.tree.map(lambda t: t[0], ref_params["segments"]["seg0"]["b0"]["mixer"])
    port_p = unstack_layers(port_params["segments"]["seg0"], 1)[0]["b0"]["mixer"]
    cfg_r, cfg_p = models["ref_cfg"].mla, get_config(ARCH).reduced().mla
    rng = np.random.default_rng(71)
    b, s, steps, h = 2, 10, 3, 4
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    xs = rng.normal(size=(steps, b, 1, 64)).astype(np.float32)
    want = ref_mla.mla_forward(ref_p, jnp.asarray(x), n_heads=h, cfg=cfg_r)
    got, cache = port_mla.mla_forward(port_p, torch.from_numpy(x), n_heads=h, cfg=cfg_p,
                                      return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    ref_cache = ref_mla.mla_prefill_cache(ref_p, jnp.asarray(x), cfg_r)
    port_cache = port_mla.mla_prefill_cache(port_p, torch.from_numpy(x), cfg_p)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]), atol=1e-5)
        assert torch.equal(cache[name], port_cache[name])

    def pad(t, n):
        return jnp.pad(t, ((0, 0), (0, n), (0, 0)))

    ref_cache = {k: pad(v, steps) for k, v in ref_cache.items()}
    port_cache = {k: torch.nn.functional.pad(v, (0, 0, 0, steps)) for k, v in port_cache.items()}
    ref_step = jax.jit(ref_mla.mla_decode, static_argnames=("n_heads", "cfg"))
    for i in range(steps):
        want, ref_cache = ref_step(ref_p, jnp.asarray(xs[i]), ref_cache, jnp.int32(s + i),
                                   n_heads=h, cfg=cfg_r)
        got, port_cache = port_mla.mla_decode(port_p, torch.from_numpy(xs[i]), port_cache, s + i,
                                              n_heads=h, cfg=cfg_p)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(port_cache["c_kv"].numpy(), np.asarray(ref_cache["c_kv"]), atol=1e-5)


# ---------------------------------------------------------------------------
# stacked packing
# ---------------------------------------------------------------------------


def test_expert_packing_matches_reference(models):
    ref_params, _ = models["float"]
    cfg = get_config(ARCH).reduced()
    port_float = from_reference_params(to_numpy_tree(ref_params))
    got = port_packed.quantize_params(port_float, _policy(port_q, cfg))
    _, want_tree = models["packed"]
    want = port_packed.packed_leaves(want_tree)
    have = port_packed.packed_leaves(got)
    assert sorted(have) == sorted(want)
    experts = port_packed.expert_leaves(got)
    assert sorted(experts) == sorted(
        k for k in ref_packed.expert_leaves(models["packed"][0])
    ) and len(experts) == 3
    for path, leaf in have.items():
        assert torch.equal(leaf.pulses, want[path].pulses), path
        np.testing.assert_allclose(leaf.scales.numpy(), want[path].scales.numpy(), rtol=0, atol=1e-6)
    bank = experts["segments/seg1/b0/ffn/wi_up_experts"]
    assert tuple(bank.pulses.shape) == (1, 4, 64, 32)  # (layers, E, k_pad, n)
    assert tuple(bank.stack_item(0).pulses.shape) == (4, 64, 32)
    # the router stays a dense f32 tensor, as do the MLA b-projections
    seg = got["segments"]["seg1"]["b0"]
    assert isinstance(seg["ffn"]["router"]["kernel"], torch.Tensor)
    assert isinstance(seg["mixer"]["wk_b"]["kernel"], torch.Tensor)


def test_chunked_stacked_packing_is_byte_identical(monkeypatch):
    w = torch.from_numpy(np.random.default_rng(81).normal(size=(3, 4, 96, 40)).astype(np.float32))
    whole = port_packed.pack_matmul(w, group=64, k=64)
    monkeypatch.setattr(port_packed, "PACK_CHUNK_ELEMS", 1000)  # one 2-D matrix per call
    chunked = port_packed.pack_matmul(w, group=64, k=64)
    assert torch.equal(chunked.pulses, whole.pulses)
    assert torch.equal(chunked.scales, whole.scales)
    assert chunked.shape == whole.shape == (96, 40)


def test_consume_replaces_dense_leaves_in_place():
    """``quantize_params`` packs in place: it returns the tree it was given,
    each packed leaf is the encoding of the dense leaf it replaced, and no
    dense leaf that the policy packs is left behind."""
    cfg = get_config(ARCH).reduced()
    policy = _policy(port_q, cfg)
    params = Model(cfg).init(0, device="cpu")
    before = {}
    port_packed.tree_map_with_path(lambda p, leaf: before.setdefault(p, leaf.clone()), params)
    out = port_packed.quantize_params(params, policy)
    assert out is params
    leaves = port_packed.packed_leaves(params)
    assert len(port_packed.expert_leaves(params)) == 3 and "embed/embedding" in leaves
    for path, leaf in leaves.items():
        m = policy.match(path)
        want = port_packed._pack_leaf(path, before[path], m[0], m[1], policy.scale_mode)
        assert torch.equal(leaf.pulses, want.pulses) and torch.equal(leaf.scales, want.scales), path
    dense = {}
    port_packed.tree_map_with_path(lambda p, leaf: dense.setdefault(p, leaf), params)
    for path, leaf in dense.items():
        if path in leaves:
            continue
        m = policy.match(path)
        assert (leaf.ndim < 2 or m is None
                or port_packed._pack_leaf(path, leaf, m[0], m[1], policy.scale_mode) is None), path


# ---------------------------------------------------------------------------
# the reduced deepseek-v2-lite-16b model
# ---------------------------------------------------------------------------

PROMPT, STEPS = 36, 4  # batch 2 x 36 = 72 prompt tokens > group 64: padded routing


def _run(model, params, tokens, feed, ref: bool, device_pos: bool = False):
    """Prefill and ``STEPS`` decode steps; the port's at host-int positions
    or, with ``device_pos``, at ``(b,)`` position tensors (the step a CUDA
    graph captures)."""
    cache_len = PROMPT + STEPS
    if ref:
        logits, cache = model.prefill(params, {"tokens": jnp.asarray(tokens)}, cache_len=cache_len)
        out = [np.asarray(logits[:, -1])]
        step = jax.jit(model.decode_step)  # traced here, under the caller's ActQuant
        for i in range(STEPS):
            logits, cache = step(params, cache, jnp.asarray(feed[:, i : i + 1]), jnp.int32(PROMPT + i))
            out.append(np.asarray(logits[:, -1]))
        return np.stack(out, 1)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=cache_len)
    out = [logits[:, -1].numpy()]
    for i in range(STEPS):
        pos = torch.full((tokens.shape[0],), PROMPT + i) if device_pos else PROMPT + i
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[:, i : i + 1]), pos)
        out.append(logits[:, -1].numpy())
    return np.stack(out, 1)


def _record_router_logits(monkeypatch):
    """Wrap both packages' ``_routing`` to keep every call's (g, s, E)
    router logits (the reference's from inside its scan, by callback)."""
    got = {"ref": [], "port": []}
    ref_routing, port_routing = ref_moe._routing, port_moe._routing

    def ref_rec(logits, cfg, **kw):
        jax.debug.callback(lambda v: got["ref"].append(np.asarray(v)), logits)
        return ref_routing(logits, cfg, **kw)

    def port_rec(logits, cfg, **kw):
        got["port"].append(logits.numpy().copy())
        return port_routing(logits, cfg, **kw)

    monkeypatch.setattr(ref_moe, "_routing", ref_rec)
    monkeypatch.setattr(port_moe, "_routing", port_rec)
    return got


def _near_tie_rows(ref_logits, port_logits, top_k, batch, seq_len):
    """Batch rows where a routing choice differs between the packages.  Each
    such choice must be a near-tie: the reference's margin between the two
    experts is at most the measured router-logit perturbation at that token
    (the tie rule of ``test_torch_model.py``, applied to the router)."""
    rows = set()
    for lr, lp in zip(ref_logits, port_logits):
        ir = np.argsort(-lr, axis=-1, kind="stable")[..., :top_k]
        ip = np.argsort(-lp, axis=-1, kind="stable")[..., :top_k]
        for g, s in np.argwhere((ir != ip).any(-1)):
            noise = np.abs(lr[g, s] - lp[g, s]).max()
            j = int(np.argmax(ir[g, s] != ip[g, s]))
            margin = lr[g, s, ir[g, s, j]] - lr[g, s, ip[g, s, j]]
            assert margin <= noise, (g, s, margin, noise)
            t = g * lr.shape[1] + s  # token index (prefill: row-major (batch, seq_len))
            rows.add(t // seq_len if lr.size // lr.shape[-1] > batch else t)
    return rows


@pytest.mark.parametrize("leg", ["float", "packed_f32", "packed_int8"])
def test_reduced_model_logits_match_reference(models, leg, monkeypatch):
    """Prefill (72 tokens: two routing groups, the second padded) plus 4
    decode steps.  In the int8 leg a one-code rounding difference can move
    a router logit past a near-tie and change which token a full expert
    drops; a batch row holding such a near-tie flip is excused, every other
    row must meet the int8 tolerance."""
    which = "float" if leg == "float" else "packed"
    act = leg == "packed_int8"
    ref_params, port_params = models[which]
    rng = np.random.default_rng(91)
    tokens = rng.integers(0, 128, size=(2, PROMPT)).astype(np.int64)
    feed = rng.integers(0, 128, size=(2, STEPS)).astype(np.int64)
    router = _record_router_logits(monkeypatch)
    with ref_q.act_quant_scope(ref_q.ActQuant() if act else None):
        want = _run(models["ref_model"], ref_params, tokens.astype(np.int32),
                    feed.astype(np.int32), ref=True)
    with port_q.act_quant_scope(port_q.ActQuant() if act else None):
        got = _run(models["port_model"], port_params, tokens, feed, ref=False)
    assert got.shape == want.shape == (2, STEPS + 1, 128)
    assert len(router["ref"]) == len(router["port"]) == 1 + STEPS
    excused = _near_tie_rows(router["ref"], router["port"], 2, batch=2, seq_len=PROMPT) if act else set()
    keep = [r for r in range(2) if r not in excused]
    assert keep, "every batch row excused: the comparison lost its teeth"
    atol = 3e-2 * float(np.abs(want).max()) if act else 1e-4
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=atol)


@pytest.mark.parametrize("leg", ["float", "packed_f32", "packed_int8"])
def test_reduced_model_device_position_decode_matches_host_int_step(models, leg, monkeypatch):
    """The decode step at device positions (the MLA latent writes by
    ``index_copy_``, per-row masks) gives the host-int step's logits bit for
    bit, and the reference's within the tolerances of
    ``test_reduced_model_logits_match_reference`` (its near-tie excuse for
    the int8 leg)."""
    which = "float" if leg == "float" else "packed"
    act = leg == "packed_int8"
    ref_params, port_params = models[which]
    rng = np.random.default_rng(93)
    tokens = rng.integers(0, 128, size=(2, PROMPT)).astype(np.int64)
    feed = rng.integers(0, 128, size=(2, STEPS)).astype(np.int64)
    router = _record_router_logits(monkeypatch)
    with ref_q.act_quant_scope(ref_q.ActQuant() if act else None):
        want = _run(models["ref_model"], ref_params, tokens.astype(np.int32),
                    feed.astype(np.int32), ref=True)
    with port_q.act_quant_scope(port_q.ActQuant() if act else None):
        got = _run(models["port_model"], port_params, tokens, feed, ref=False, device_pos=True)
        excused = (_near_tie_rows(router["ref"], router["port"], 2, batch=2, seq_len=PROMPT)
                   if act else set())
        host = _run(models["port_model"], port_params, tokens, feed, ref=False)
    np.testing.assert_array_equal(got, host)
    keep = [r for r in range(2) if r not in excused]
    assert keep, "every batch row excused: the comparison lost its teeth"
    atol = 3e-2 * float(np.abs(want).max()) if act else 1e-4
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=atol)


def test_reduced_serve_gate_decision_matches_reference(models):
    """``serve --pvq --act-int8 --agreement-min 0.99`` on the reduced model:
    both packages score their served leg against their f32 leg on the same
    packed parameters and the reference's greedy tokens; the gate decision
    (agreement >= 0.99) is the reference's.

    The reference's ``teacher_forced_logits`` runs a decode step jitted once
    per model, and the activation contract is read when it is traced: with a
    dense cache (no ``--kv-pvq``, as here) its f32 leg would reuse the step
    traced under int8.  The test drops that cached step before the f32 leg,
    so the reference's f32 leg is f32 (ROADMAP queue 3)."""
    ref_params, port_params = models["packed"]
    prompt, gen = 20, 6
    tokens = np.random.default_rng(92).integers(0, 128, size=(2, prompt)).astype(np.int32)
    with ref_q.act_quant_scope(ref_q.ActQuant()):
        seq = ref_serve.generate(models["ref_model"], ref_params, jnp.asarray(tokens), gen=gen,
                                 cache_len=prompt + gen)
        ref_q_leg = ref_serve.teacher_forced_logits(models["ref_model"], ref_params, seq,
                                                    prompt_len=prompt)
    ref_serve._STEP_JITS.pop(models["ref_model"], None)
    ref_f_leg = ref_serve.teacher_forced_logits(models["ref_model"], ref_params, seq,
                                                prompt_len=prompt)
    port_seq = torch.from_numpy(np.asarray(seq, np.int64))
    with port_q.act_quant_scope(port_q.ActQuant()):
        port_q_leg = port_serve.teacher_forced_logits(models["port_model"], port_params, port_seq,
                                                      prompt_len=prompt)
    port_f_leg = port_serve.teacher_forced_logits(models["port_model"], port_params, port_seq,
                                                  prompt_len=prompt)
    legs = [torch.from_numpy(np.array(t, np.float32)) for t in (ref_f_leg, ref_q_leg)]
    ref_ag = port_serve.top1_agreement(*legs)["top1_agreement"]
    port_ag = port_serve.top1_agreement(port_f_leg, port_q_leg)["top1_agreement"]
    assert (ref_ag >= 0.99) == (port_ag >= 0.99), (ref_ag, port_ag)
    np.testing.assert_allclose(port_f_leg.numpy(), legs[0].numpy(), rtol=0, atol=1e-4)


def test_bf16_reduced_model_f32_leg_matches_reference():
    """The reduced model computing in bf16, as the full-width config does
    (MLA's casts around the latent cache, the bf16 dispatch buffer and
    combine).  Tolerance: 1e-2 relative L2 on the f32 leg's teacher-forced
    logits (bf16 rounding of the residual stream in two backends, as in
    ``test_torch_fidelity.py``)."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    port_cfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    ref_model = RefModel(ref_cfg)
    ref_params = ref_packed.quantize_params(ref_model.init(jax.random.PRNGKey(7)),
                                            _policy(ref_q, ref_cfg))
    port_params = from_reference_params(to_numpy_tree(ref_params))
    seq = np.random.default_rng(93).integers(0, 128, size=(2, 26)).astype(np.int64)
    want = ref_serve.teacher_forced_logits(ref_model, ref_params, jnp.asarray(seq.astype(np.int32)),
                                           prompt_len=20)
    got = port_serve.teacher_forced_logits(Model(port_cfg), port_params, torch.from_numpy(seq),
                                           prompt_len=20)
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape == (2, 6, 128)
    rel = float((got - want).norm() / want.norm())
    assert rel < 1e-2, rel
    assert port_serve.top1_agreement(want, got)["top1_agreement"] == 1.0
