"""The port's kernels against the JAX reference kernels (Pallas in interpret
mode on the CPU).

Here the port runs each kernel's plain PyTorch version (the route a CPU
tensor takes); the CUDA kernels are held against those same plain versions
on the card (``test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances: pulses and int8 codes identical; encode rho ``atol=1e-6``
(sum order); matmuls ``rtol=1e-5, atol=1e-5 * max|y|`` (the f32 sum over
groups and inside a float group runs in another order); attention
``rtol=1e-4`` on ``acc`` and ``l`` (exp and the softmax sum differ in the
last bits, and a requantized probability that sits on a half-quantum
boundary may round the other way: each such flip moves ``acc`` by at most
one quantum ``s_p * max|V|``, far below the bound used here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as ref_q
from repro.kernels import ops as ref_ops
from repro.kernels.pvq_matmul import pvq_attn_q as ref_attn_q
from repro_torch.core import quantize as port_q
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import pvq_encode as port_enc
from repro_torch.kernels import pvq_matmul as port_mm


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    # a stray autotune cache must not change the reference's delta_max/tiles
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))


def _weight(seed, k, n, group, k_pulses):
    """A PVQ-coded weight: int8 pulses (k, n) and rho (k/group, n)."""
    w = np.random.default_rng(seed).laplace(size=(k, n)).astype(np.float32)
    pulses, scales, _ = ref_ops.encode_weight_matrix(
        jnp.asarray(w), group=group, k_pulses=k_pulses, interpret=True
    )
    return np.array(pulses), np.array(scales)


# ---------------------------------------------------------------------------
# pvq_encode_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "g,n,k",
    [
        (10, 32, 16),    # K <= delta_max: exact greedy only
        (12, 64, 96),    # K > delta_max: bisection bulk + greedy tail
        (9, 256, 256),   # K > 127, full-width matmul group
        (8, 64, 128),    # full-width embedding group
    ],
)
def test_encode_plain_matches_reference_kernel(g, n, k):
    w = np.random.default_rng(g * n + k).laplace(size=(g, n)).astype(np.float32)
    w[1] = 0.0
    p_ref, rho_ref = ref_ops.pvq_encode(jnp.asarray(w), k_pulses=k, interpret=True)
    p, rho = ops.pvq_encode(torch.from_numpy(w), k_pulses=k)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_ref), rtol=0, atol=1e-6)
    assert rho[1] == 0 and (p[1] == 0).all()


@pytest.mark.parametrize("k_dim,n,group", [(64, 24, 64), (96, 40, 32), (960, 16, 256)])
def test_encode_weight_matrix_matches_reference(k_dim, n, group):
    w = np.random.default_rng(k_dim + n).normal(size=(k_dim, n)).astype(np.float32)
    p_ref, s_ref, kp_ref = ref_ops.encode_weight_matrix(
        jnp.asarray(w), group=group, k_pulses=group, interpret=True
    )
    p, s, kp = ops.encode_weight_matrix(torch.from_numpy(w), group=group, k_pulses=group)
    assert kp == kp_ref
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# pvq_matmul (v2) and pvq_matmul_q (v3)
# ---------------------------------------------------------------------------

SHAPES = [(5, 96, 40, 32), (3, 128, 130, 64), (9, 64, 24, 16)]


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("activation", port_mm.ACTIVATIONS)
@pytest.mark.parametrize("m,k,n,group", SHAPES[:2])
def test_pvq_matmul_plain_matches_reference(m, k, n, group, activation):
    pulses, scales = _weight(m + k + n, k, n, group, group)
    rng = np.random.default_rng(m * n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32) if activation != "none" else None
    want = ref_ops.pvq_matmul(
        jnp.asarray(x), jnp.asarray(pulses), jnp.asarray(scales), group=group,
        bias=None if bias is None else jnp.asarray(bias), activation=activation, interpret=True,
    )
    got = ops.pvq_matmul(
        torch.from_numpy(x), torch.from_numpy(pulses), torch.from_numpy(scales), group=group,
        bias=None if bias is None else torch.from_numpy(bias), activation=activation,
    )
    _close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["per_row", "per_tile", "per_tensor"])
@pytest.mark.parametrize(
    "m,k,n,group,activation", [s + (a,) for s, a in zip(SHAPES, ("none", "gelu", "silu"))]
)
def test_pvq_matmul_q_plain_matches_reference(m, k, n, group, activation, mode):
    pulses, scales = _weight(m + k + n, k, n, group, group)
    rng = np.random.default_rng(m * n + 1)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[1] = 0.0  # zero row: zero scale on both sides
    bias = rng.normal(size=(n,)).astype(np.float32)
    want = ref_ops.pvq_matmul(
        jnp.asarray(x), jnp.asarray(pulses), jnp.asarray(scales), group=group,
        bias=jnp.asarray(bias), activation=activation,
        act_quant=ref_q.ActQuant(mode=mode), interpret=True,
    )
    got = ops.pvq_matmul(
        torch.from_numpy(x), torch.from_numpy(pulses), torch.from_numpy(scales), group=group,
        bias=torch.from_numpy(bias), activation=activation, act_quant=port_q.ActQuant(mode=mode),
    )
    _close(got.numpy(), want)


@pytest.mark.parametrize("relu2", ["relu", "relu2"])
def test_pvq_matmul_q_relu_family_and_scalar_scale(relu2):
    m, k, n, group = 4, 64, 48, 32
    pulses, scales = _weight(3, k, n, group, group)
    rng = np.random.default_rng(5)
    x_q = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    a = np.full((1, 1), 0.013, np.float32)
    from repro.kernels.pvq_matmul import pvq_matmul_q as ref_mm_q

    want = ref_mm_q(jnp.asarray(x_q), jnp.asarray(pulses), jnp.asarray(scales), jnp.asarray(a),
                    group=group, activation=relu2, interpret=True)
    got = port_mm.pvq_matmul_q_plain(
        torch.from_numpy(x_q), torch.from_numpy(pulses), torch.from_numpy(scales),
        torch.from_numpy(a), group=group, activation=relu2,
    )
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# pvq_attn_q (v4)
# ---------------------------------------------------------------------------


def _attn_operands(seed, bh, m, s, hd, group):
    rng = np.random.default_rng(seed)
    ng = hd // group
    qf = rng.normal(size=(bh, m, hd)).astype(np.float32)
    q_i8, a = ref_q.quantize_activations(jnp.asarray(qf), ref_q.ActQuant())
    kp = rng.integers(-12, 13, size=(bh, s, hd)).astype(np.int8)
    vp = rng.integers(-12, 13, size=(bh, s, hd)).astype(np.int8)
    ks = rng.uniform(0.02, 0.2, size=(bh, s, ng)).astype(np.float32)
    vs = rng.uniform(0.02, 0.2, size=(bh, s, ng)).astype(np.float32)
    return np.array(q_i8), np.array(a), kp, ks, vp, vs


@pytest.mark.parametrize(
    "hd,group,s,lens",
    [
        (16, 16, 40, [0, 17, 40, 8]),           # reduced head dim: narrow group, one block
        (64, 32, 160, [0, 37, 160, 129]),       # full width: two 128-column blocks
    ],
)
def test_attn_plain_matches_reference_kernel(hd, group, s, lens):
    # GQA 8 heads / 2 kv heads, batch 2 -> BH 4 rows of m = 4 queries
    bh, m = 4, 4
    q_i8, a, kp, ks, vp, vs = _attn_operands(hd + s, bh, m, s, hd, group)
    kv_len = np.asarray(lens, np.int32)
    scale = 1.0 / np.sqrt(hd)
    acc_r, m_r, l_r = ref_attn_q(*map(jnp.asarray, (q_i8, a, kp, ks, vp, vs, kv_len)),
                                 group=group, sm_scale=scale, bs=128, interpret=True)
    # the reference kernel's (BH, S, X) rows are the port's (b, S, n_kv, X)
    # cache planes with b = BH, n_kv = 1
    acc, mm, ll = port_mm.pvq_attn_q_plain(
        *map(torch.from_numpy, (q_i8, a)),
        *(torch.from_numpy(t)[:, :, None] for t in (kp, ks, vp, vs)),
        torch.from_numpy(kv_len), group=group, sm_scale=scale,
    )
    acc_r, m_r, l_r = map(np.asarray, (acc_r, m_r, l_r))
    np.testing.assert_allclose(mm.numpy(), m_r, rtol=1e-6)
    np.testing.assert_allclose(ll.numpy(), l_r, rtol=1e-4)
    np.testing.assert_allclose(acc.numpy(), acc_r, rtol=1e-4, atol=1e-4 * np.abs(acc_r).max())
    empty = kv_len == 0
    assert (ll.numpy()[empty] == 0).all() and (mm.numpy()[empty] == -1e30).all()


def test_exp_nonpos_is_exp_within_two_ulp():
    """The softmax exp that kernel v4 and its plain version share."""
    x = -torch.from_numpy(np.random.default_rng(3).uniform(0, 90, size=200_000)).float()
    got = port_mm.exp_nonpos(x).double()
    want = torch.exp(x.double())
    live = x >= port_mm.EXP_MIN
    assert ((got - want).abs() <= 2 * 2.0**-24 * want)[live].all()
    assert (got[~live] == 0).all()
    edge = port_mm.exp_nonpos(torch.tensor([0.0, -1e30, port_mm.EXP_MIN]))
    assert edge[0] == 1.0 and edge[1] == 0.0 and edge[2] > 0


def test_attn_plain_takes_the_cache_layout():
    """(b, S, n_kv, X) planes give exactly what their rows give as
    (b*n_kv, S, 1, X) planes: row bh is batch bh // n_kv, kv head bh % n_kv."""
    b, n_kv, m, s, hd, group = 2, 3, 2, 40, 16, 8
    q_i8, a, kp, ks, vp, vs = _attn_operands(5, b * n_kv, m, s, hd, group)
    kv_len = torch.tensor([0, 3, 40, 17, 9, 33], dtype=torch.int32)
    rows = [torch.from_numpy(t)[:, :, None] for t in (kp, ks, vp, vs)]
    cache = [t.reshape(b, n_kv, s, -1).permute(0, 2, 1, 3).contiguous() for t in rows]
    q, a = torch.from_numpy(q_i8), torch.from_numpy(a)
    want = port_mm.pvq_attn_q_plain(q, a, *rows, kv_len, group=group, sm_scale=0.3)
    got = port_mm.pvq_attn_q_plain(q, a, *cache, kv_len, group=group, sm_scale=0.3)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    with pytest.raises(ValueError, match="b\\*n_kv"):
        port_mm.pvq_attn_q_plain(q[:4], a[:4], *cache, kv_len[:4], group=group, sm_scale=0.3)


def test_attn_decode_dispatch_matches_reference():
    """``ops.pvq_attn_decode``: GQA folding, quantization and unfolding."""
    from repro.core.packed import PackedKV as RefKV
    from repro_torch.core.packed import PackedKV

    b, s, n_kv, n_heads, hd = 2, 48, 2, 8, 16
    rng = np.random.default_rng(9)
    k = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    q = rng.normal(size=(b, 1, n_heads, hd)).astype(np.float32)
    kvq_r, kvq_p = ref_q.KVQuant(block=16, group=16), port_q.KVQuant(block=16, group=16)
    ref_kv = RefKV.from_dense(jnp.asarray(k), jnp.asarray(v), kvq=kvq_r)
    port_kv = PackedKV.from_dense(torch.from_numpy(k), torch.from_numpy(v), kvq=kvq_p)
    lens = np.asarray([48, 21], np.int32)
    want = ref_ops.pvq_attn_decode(jnp.asarray(q), ref_kv, jnp.asarray(lens), sm_scale=0.25,
                                   interpret=True)
    got = ops.pvq_attn_decode(torch.from_numpy(q), port_kv, torch.from_numpy(lens), sm_scale=0.25)
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-4, atol=1e-4 * np.abs(w_).max())


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_cpu_route_launches_no_kernel():
    before = dict(LAUNCHES)
    x = torch.randn(2, 64)
    pulses = torch.randint(-3, 4, (64, 8), dtype=torch.int8)
    ops.pvq_matmul(x, pulses, torch.ones(1, 8), group=64)
    ops.pvq_matmul(x, pulses, torch.ones(1, 8), group=64, act_quant=port_q.ActQuant())
    ops.pvq_encode(torch.randn(3, 16), k_pulses=8)
    assert dict(LAUNCHES) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        port_enc.pvq_encode_batch_cuda(torch.randn(2, 8), k_pulses=4)
    with pytest.raises(ValueError, match="CUDA"):
        port_mm.pvq_matmul_cuda(torch.randn(2, 8), torch.zeros(8, 4, dtype=torch.int8),
                                torch.ones(1, 4), group=8)


# ---------------------------------------------------------------------------
# oracles (kernels/ref.py)
# ---------------------------------------------------------------------------


def test_ref_oracles_match_reference():
    from repro.kernels import ref as ref_ref
    from repro_torch.kernels import ref as port_ref

    w = np.random.default_rng(21).laplace(size=(7, 32)).astype(np.float32)
    p_ref, rho_ref = ref_ref.pvq_encode_ref(jnp.asarray(w), 40)
    p, rho = port_ref.pvq_encode_ref(torch.from_numpy(w), 40)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_ref), rtol=0, atol=1e-6)
    pulses, scales = _weight(22, 64, 24, 32, 32)
    x = np.random.default_rng(23).normal(size=(5, 64)).astype(np.float32)
    want = ref_ref.pvq_matmul_ref(jnp.asarray(x), jnp.asarray(pulses), jnp.asarray(scales), group=32)
    got = port_ref.pvq_matmul_ref(torch.from_numpy(x), torch.from_numpy(pulses),
                                  torch.from_numpy(scales), group=32)
    _close(got.numpy(), want)
