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
from _act_quant_rows import SHAPES as ACT_SHAPES
from _act_quant_rows import TIES_ROUNDED, act_rows
from _encode_rows import encode_rows
from _hyp import given, settings, st

from repro.core import quantize as ref_q
from repro.kernels import ops as ref_ops
from repro.kernels.pvq_matmul import pvq_attn_q as ref_attn_q
from repro_torch.core import quantize as port_q
from repro_torch.kernels import LAUNCHES, V2_BODY_LAUNCHES, V3_BODY_LAUNCHES, ops
from repro_torch.kernels import pvq_encode as port_enc
from repro_torch.kernels import pvq_matmul as port_mm


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    # a stray autotune cache must not change the reference's delta_max/tiles
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    # and the port's, whose delta_max and choices would follow it
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


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
        (10, 32, 127),   # the KV cache's group (mostly bulk 0: greedy only)
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


# the encode kernel's order (csrc/pvq_encode.cu), emulated in torch: lane l
# of a row's warp holds columns l + 32 i (slot i); a tree sum folds the
# slots, then runs a butterfly over the lanes; bisection counts are warp
# sums, equal-ranks come from ballots; a greedy step takes each lane's first
# maximum over its slots (score patterns as ints), then the top pattern and
# the lowest column holding it
_LANES = torch.arange(32)
_ENC_TOP, _INT_MIN, _INT_MAX = 0x7F7FFFFF, -2**31, 2**31 - 1


def _enc_row_sum(t):
    """(g, S, 32) -> (g,): slot i += slot i + h, then lane l += lane l ^ h;
    every lane ends with the same sum."""
    while t.shape[1] > 1:
        h = t.shape[1] // 2
        t = t[:, :h] + t[:, h:]
    v = t[:, 0]
    for h in (16, 8, 4, 2, 1):
        v = v + v[:, _LANES ^ h]
    assert torch.equal(v, v[:, :1].expand_as(v))
    return v[:, 0]


def _popc(masks):
    """Set bits of each 32-bit mask in an int64 tensor."""
    return sum((masks >> b) & 1 for b in range(32))


def _ballot(pred):
    """(g, 32) bool -> (g,) int64 mask, bit l for lane l."""
    return (pred.to(torch.int64) << _LANES).sum(-1)


def _encode_emulate(w, k, delta_max):
    g, n = w.shape
    p = 32
    while p < n:
        p *= 2
    s = p // 32

    def slots(x):
        return torch.nn.functional.pad(x, (0, p - n)).reshape(g, s, 32)

    wv = slots(w.to(torch.float32))
    live = slots(torch.ones((g, n), dtype=torch.bool))
    absw = wv.abs()
    l1 = _enc_row_sum(absw)
    pos = (l1 > 0)[:, None, None]
    kq = torch.full_like(l1, float(k)) / torch.where(l1 > 0, l1, torch.ones_like(l1))
    target = absw * kq[:, None, None]
    y = torch.where(live & pos, torch.floor(target), torch.zeros_like(target))
    fb = torch.where(live, (target - y).view(torch.int32),
                     torch.full(target.shape, _INT_MIN, dtype=torch.int32))
    bulk = torch.clamp(k - _enc_row_sum(y).to(torch.int32) - delta_max, min=0)
    # bisection, skipped (hi stays at the top) where bulk == 0
    lo = torch.full((g,), -1, dtype=torch.int32)
    hi = torch.full((g,), _ENC_TOP, dtype=torch.int32)
    run = bulk > 0
    for _ in range(32):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        cnt = (fb > mid[:, None, None]).to(torch.int32).sum(1).sum(-1)  # lanes, then the warp
        ok = cnt <= bulk
        hi = torch.where(run & ok, mid, hi)
        lo = torch.where(run & ~ok, mid, lo)
    extra = bulk - (fb > hi[:, None, None]).to(torch.int32).sum(1).sum(-1)
    le = (2 << _LANES) - 1
    below = torch.zeros((g,), dtype=torch.int64)
    for i in range(s):
        eq = fb[:, i] == hi[:, None]
        ballot = _ballot(eq)
        rank = below[:, None] + _popc(ballot[:, None] & le)
        bump = (fb[:, i] > hi[:, None]) | (eq & (rank <= extra[:, None]))
        below = below + _popc(ballot)
        y[:, i] = torch.where(pos[:, 0] & bump, y[:, i] + 1.0, y[:, i])
    # greedy steps
    corr = _enc_row_sum(absw * y)
    energy = _enc_row_sum(y * y)
    rem = torch.clamp(k - _enc_row_sum(y).to(torch.int32), max=delta_max)
    cols = _LANES + 32 * torch.arange(s)[:, None]  # (S, 32)
    for _ in range(min(delta_max, k)):
        do = rem > 0
        if not bool(do.any()):
            break
        c = corr[:, None, None] + absw
        score = ((c * c) / (energy[:, None, None] + 2.0 * y + 1.0)).view(torch.int32)
        best = torch.full((g, 32), -1, dtype=torch.int32)
        col = torch.full((g, 32), _INT_MAX, dtype=torch.int32)
        for i in range(s):  # each lane's slots in ascending column order, strict >
            take = live[:, i] & (score[:, i] > best)
            best = torch.where(take, score[:, i], best)
            col = torch.where(take, cols[i].to(torch.int32), col)
        top = best.amax(-1, keepdim=True)
        j = torch.where(best == top, col, torch.full_like(col, _INT_MAX)).amin(-1)
        jj = j.to(torch.int64)[:, None]  # a slot-major flat index is the column
        yf = y.reshape(g, p).scatter_add(1, jj, do.to(torch.float32)[:, None])
        y = yf.reshape(g, s, 32)
        aj = absw.reshape(g, p).gather(1, jj)[:, 0]
        yj = yf.gather(1, jj)[:, 0]
        corr = torch.where(do, corr + aj, corr)
        energy = torch.where(do, energy + (2.0 * yj - 1.0), energy)
        rem = rem - do.to(torch.int32)
    pv = torch.sign(wv) * y
    yn2 = _enc_row_sum(pv * pv)
    dot = _enc_row_sum(wv * pv)
    rho = torch.clamp(dot / torch.where(yn2 > 0, yn2, torch.ones_like(yn2)), min=0.0)
    rho = torch.where(yn2 > 0, rho, torch.zeros_like(rho))
    return pv.reshape(g, p)[:, :n].to(torch.int32), rho


_EMULATE_N = [12, 32, 64, 200, 256]


def _emulate_case(seed, g, n, k, delta_max):
    w = torch.from_numpy(encode_rows(seed, g, n))
    got = _encode_emulate(w, k, delta_max)
    want = port_enc.pvq_encode_batch_plain(w, k_pulses=k, delta_max=delta_max)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), k=st.sampled_from([1, 16, 127, 128, 256, 1100]),
       delta_max=st.sampled_from([0, 1, 32, 2000]))
@pytest.mark.parametrize("n", _EMULATE_N)
def test_encode_kernel_order_is_the_plain_version_bit_for_bit(n, seed, k, delta_max):
    """The warp-per-row kernel's order (slot layout, register-then-butterfly
    tree sums, warp-sum bisection counts skipped at bulk 0, ballot
    equal-ranks, the lane-then-warp argmax with ties to the lower column)
    equals ``pvq_encode_batch_plain`` bit for bit on rows with exact ties,
    zero rows and rows whose bulk is 0."""
    _emulate_case(seed, 13, n, k, delta_max)


@pytest.mark.parametrize("n,k,delta_max", [(32, 127, 32), (64, 128, 32), (256, 256, 32),
                                           (16, 1024, 32), (16, 1, 32), (48, 96, 0),
                                           (1000, 512, 32), (7, 40, 40)])
def test_encode_kernel_order_on_the_served_and_edge_shapes(n, k, delta_max):
    _emulate_case(n + k, 25, n, k, delta_max)


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


# kernel v4's redesigned order (csrc/pvq_attn_decode.cuh), emulated in torch:
# the blocks of a pass side by side given the prefix max of the block
# maxima, lane-layout tree sums over 128 zero-padded columns, and the fold
# in block order, pass after pass, over tiles of km query rows
def _v4_emulate(q_i8, a, kp, ks, vp, vs, kv_len, *, group, sm_scale, km, w):
    bh, m, hd = q_i8.shape
    s, ng, bs = kp.shape[1], hd // group, port_mm.ATTN_BS
    kp, ks, vp, vs = (t.permute(0, 2, 1, 3).reshape(bh, s, t.shape[-1]) for t in (kp, ks, vp, vs))
    lens = kv_len.to(torch.int64)
    nblk = -(-int(lens.max()) // bs) if bh else 0
    pad = nblk * bs - s if nblk * bs > s else 0
    # zero-padded to whole blocks; positions past a row's kv_len are zeros,
    # as the kernel stages them
    pos = torch.arange(s + pad)
    live = pos[None, :] < lens[:, None]  # (BH, S')

    def staged(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad))[:, : nblk * bs]
        return torch.where(live[:, : nblk * bs, None], t, torch.zeros_like(t))

    kp, vp = staged(kp.to(torch.int32)), staged(vp.to(torch.int32))
    ks, vs = staged(ks.float()), staged(vs.float())
    acc = torch.zeros((bh, m, hd))
    m_run = torch.full((bh, m, 1), port_mm.ATTN_NEG_INF)
    l_run = torch.zeros((bh, m, 1))
    for r0 in range(0, m, km):  # one CTA per (row, tile of km query rows)
        rs = slice(r0, min(r0 + km, m))
        q, ar = q_i8[:, rs].to(torch.int32), a[:, rs].float()
        for p0 in range(0, nblk, w):  # passes of w blocks
            blocks = range(p0, min(p0 + w, nblk))
            scores, bmax = [], []
            for b in blocks:  # each block's scores, independently
                cols = slice(b * bs, (b + 1) * bs)
                sc = torch.zeros((bh, q.shape[1], bs))
                for g in range(ng):
                    sl = slice(g * group, (g + 1) * group)
                    dot = (q[:, :, None, sl] * kp[:, None, cols, sl]).sum(-1).float()
                    sc = sc + dot * ks[:, None, cols, g]
                sc = sc * ar * sm_scale
                valid = live[:, None, cols]
                sc = torch.where(valid, sc, torch.full_like(sc, port_mm.ATTN_NEG_INF))
                scores.append((sc, valid))
                bmax.append(sc.amax(-1, keepdim=True))
            parts = []
            for i in reversed(range(len(blocks))):  # given the prefix max, in any order
                b = blocks[i]
                sc, valid = scores[i]
                m_prev = m_run[:, rs]
                for bm in bmax[:i]:
                    m_prev = torch.maximum(m_prev, bm)
                m_new = torch.maximum(m_prev, bmax[i])
                pr = torch.where(valid, port_mm.exp_nonpos(sc - m_new), torch.zeros_like(sc))
                lanes = pr.reshape(*pr.shape[:-1], 4, 32)
                t = (lanes[..., 0, :] + lanes[..., 2, :]) + (lanes[..., 1, :] + lanes[..., 3, :])
                while t.shape[-1] > 1:
                    t = t[..., : t.shape[-1] // 2] + t[..., t.shape[-1] // 2:]
                cols = slice(b * bs, (b + 1) * bs)
                outs = []
                for g in range(ng):
                    sl = slice(g * group, (g + 1) * group)
                    pg = pr * vs[:, None, cols, g]
                    amax = pg.abs().amax(-1, keepdim=True)
                    s_p = amax / torch.full_like(amax, 127.0)
                    inv = torch.where(s_p > 0, 1.0 / torch.clamp(s_p, min=1e-30),
                                      torch.zeros_like(s_p))
                    pq = torch.clamp(torch.round(pg * inv), -127, 127).to(torch.int32)
                    o = (pq[:, :, :, None] * vp[:, None, cols, sl]).sum(-2).float()
                    outs.append(o * s_p)
                alpha = port_mm.exp_nonpos(m_prev - m_new)
                parts.insert(0, (b, alpha, t, torch.cat(outs, -1), m_new))
            for b, alpha, psum, o, m_new in parts:  # the fold, in block order
                upd = (b * bs < lens)[:, None, None]  # blocks past kv_len are skipped
                l_run[:, rs] = torch.where(upd, l_run[:, rs] * alpha + psum, l_run[:, rs])
                acc[:, rs] = torch.where(upd, acc[:, rs] * alpha + o, acc[:, rs])
                m_run[:, rs] = torch.where(upd, m_new, m_run[:, rs])
    return acc, m_run, l_run


# (b, n_kv, m, hd, group, S): smollm's decode and CI's prompt-512 smoke at
# full width, smollm's published context, a chunked prefill's rows, the
# reduced model's head dim
_V4_SHAPES = [(4, 5, 3, 64, 32, 160), (1, 5, 3, 64, 32, 520), (1, 2, 3, 64, 32, 2048),
              (2, 3, 12, 64, 32, 1000), (3, 1, 4, 16, 16, 300), (1, 1, 20, 16, 8, 385)]


def _v4_case(b, n_kv, m, hd, group, s, seed=0):
    """Random int8 queries and K/V planes in the cache layout; kv_len takes
    0, 1, 127, 128, 129 and S among its rows."""
    rng = np.random.default_rng(seed + s + m)
    bh, ng = b * n_kv, hd // group
    q_i8, a = port_q.quantize_activations(torch.from_numpy(rng.normal(size=(bh, m, hd)).astype(np.float32)))
    lead = (b, s, n_kv)
    kp = torch.from_numpy(rng.integers(-20, 21, size=(*lead, hd)).astype(np.int8))
    vp = torch.from_numpy(rng.integers(-20, 21, size=(*lead, hd)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(0.0, 0.2, size=(*lead, ng)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.0, 0.2, size=(*lead, ng)).astype(np.float32))
    lens = [n for n in (0, 1, 127, 128, 129, s) if n <= s]
    lens += [int(n) for n in rng.integers(0, s + 1, size=max(bh - len(lens), 0))]
    kv_len = torch.tensor(lens[:bh], dtype=torch.int32)
    return q_i8, a, kp, ks, vp, vs, kv_len


@pytest.mark.parametrize("shape", _V4_SHAPES)
@pytest.mark.parametrize("w", ["plan", 1, 2, 3])
def test_v4_block_and_pass_order_is_the_plain_version_bit_for_bit(shape, w):
    """The redesigned kernel's order (blocks side by side given the prefix
    max, lane-layout tree sums, passes carrying (acc, m, l), the fold in
    block order) equals ``pvq_attn_q_plain`` bit for bit."""
    b, n_kv, m, hd, group, s = shape
    args = _v4_case(*shape)
    km, plan_w, _ = port_mm._v4_plan(m, s, hd, group)
    want = port_mm.pvq_attn_q_plain(*args, group=group, sm_scale=hd ** -0.5)
    got = _v4_emulate(*args, group=group, sm_scale=hd ** -0.5, km=km,
                      w=plan_w if w == "plan" else w)
    for name, g_, w_ in zip(("acc", "m", "l"), got, want):
        assert torch.equal(g_, w_), name


@pytest.mark.parametrize("m", [1, 3, 9, 768, 4096])
@pytest.mark.parametrize("s", [1, 129, 160, 520, 2048, 32768])
@pytest.mark.parametrize("hd,group", [(64, 32), (16, 16), (128, 32), (36, 12)])
def test_v4_plan_covers_every_block_and_row_within_shared_memory(m, s, hd, group):
    km, w, passes = port_mm._v4_plan(m, s, hd, group)
    nblk = -(-s // port_mm.ATTN_BS)
    assert km == min(m, port_mm.V4_KM_MAX)  # a decode row's query rows share one CTA
    assert -(-m // km) * km >= m > (-(-m // km) - 1) * km  # tiles cover every row once
    assert passes * w >= nblk > (passes - 1) * w  # passes cover every block once
    assert km * w <= port_mm.V4_WARPS_MAX
    assert port_mm._v4_smem_bytes(km, w, hd, group) <= port_mm.V4_SMEM_MAX
    assert port_mm._check_v4_plan((km, w, passes), s, hd, group) == (km, w, passes)


def test_v4_plan_on_the_timed_decode_rows():
    """smollm's decode (S 160) and CI's prompt-512 smoke take one pass; its
    published context (S 2048) makes balanced passes; a chunked prefill's
    768 query rows take tiles of 8."""
    assert port_mm._v4_plan(3, 160, 64, 32) == (3, 2, 1)
    assert port_mm._v4_plan(3, 520, 64, 32) == (3, 5, 1)
    assert port_mm._v4_plan(3, 2048, 64, 32) == (3, 4, 4)
    assert port_mm._v4_plan(768, 2048, 64, 32) == (8, 2, 8)
    # shared memory caps the blocks a pass at wide head dims
    assert port_mm._v4_plan(3, 160, 512, 32) == (3, 1, 2)


def test_v4_shared_memory_does_not_grow_with_m():
    sizes = {port_mm._v4_smem_bytes(*port_mm._v4_plan(m, 160, 64, 32)[:2], 64, 32)
             for m in (8, 9, 649, 650, 768, 4096)}
    assert len(sizes) == 1


@pytest.mark.parametrize("plan", [(9, 1, 2), (4, 5, 1), (2, 1, 1), (0, 2, 1), (1, 1, 2)])
def test_check_v4_plan_refuses_what_the_kernel_cannot_take(plan):
    # S 160 is two blocks: w 1 takes 2 passes, w 2 one; hd 1024 leaves no room
    hd = 1024 if plan == (1, 1, 2) else 64
    with pytest.raises(ValueError, match="does not fit"):
        port_mm._check_v4_plan(plan, 160, hd, 32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


# the main path's prefill: group 256, k a multiple of 256, n a multiple of
# 16, operands 16-byte aligned
_MMA_OK = dict(m=512, k=1024, n=2560, group=256, x_ptr=4096, w_ptr=8192)


@pytest.mark.parametrize("m", [1, 4, 8])
def test_v3_body_is_the_ring_up_to_eight_rows(m):
    # up to 8 rows the splitk body (which replaced the ring) takes every
    # shape that fits it
    assert port_mm._v3_body(**{**_MMA_OK, "m": m}) == "splitk"
    assert port_mm._v3_body(m, 96, 48, 4, 16, 32) == "splitk"
    # ragged shapes go to the direct body
    assert port_mm._v3_body(m, 12, 5, 6, 3, 5) == "direct"


# (e, k, n) of the full-width main paths' v3 decode calls: smollm-360m's 7
# layer matmuls (wq, wk, wv, wo, wi_gate, wi_up, ffn wo); deepseek-v2-lite-
# 16b's 2-D matrices (MLA wq, wkv_a, wo; the shared experts' up/gate and
# down; layer 0's dense FFN, 10944 padded to 11008; lm_head) and its two
# expert-bank shapes; group 256
V3_DECODE_MAIN_PATH = [
    (1, 1024, 960), (1, 1024, 320), (1, 1024, 2560), (1, 2560, 960),
    (1, 2048, 3072), (1, 2048, 576), (1, 2048, 2048), (1, 2048, 2816), (1, 2816, 2048),
    (1, 2048, 10944), (1, 11008, 2048), (1, 2048, 102400),
    (64, 2048, 1408), (64, 1536, 2048),
]


def _plan_tiles(e, m, k, n, group):
    """Every CTA of the splitk plan as (expert, k rows, columns)."""
    cols, chunk, splits = port_mm._v3_decode_plan(e, m, k, n, group)
    assert chunk * splits == k
    return [(x, range(s * chunk, (s + 1) * chunk), range(c, min(c + cols, n)))
            for x in range(e) for s in range(splits) for c in range(0, n, cols)]


@pytest.mark.parametrize("e,m,k,n,group", [(1, 4, 1024, 960, 256), (1, 1, 512, 80, 64),
                                           (3, 8, 96, 48, 32), (2, 2, 384, 16, 128),
                                           (5, 4, 1536, 208, 256), (300, 1, 256, 16, 256),
                                           (1, 3, 40, 32, 20)])
def test_v3_decode_plan_covers_every_expert_group_and_column_once(e, m, k, n, group):
    cover = np.zeros((e, k, n), np.int32)
    for x, rows, cols in _plan_tiles(e, m, k, n, group):
        cover[x, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (cover == 1).all()
    # each group's k rows are split into whole pieces that stay inside it
    _, chunk, splits = port_mm._v3_decode_plan(e, m, k, n, group)
    if splits > 1:
        assert group % chunk == 0 and chunk % 4 == 0
    else:
        assert chunk == k


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("e,k,n", V3_DECODE_MAIN_PATH)
def test_v3_decode_plan_chunks_are_fours_inside_one_group(e, k, n, m):
    cols, chunk, splits = port_mm._v3_decode_plan(e, m, k, n, 256)
    assert cols == port_mm.SPLITK_COLS and chunk * splits == k
    if splits > 1:
        assert chunk % 4 == 0 and 256 % chunk == 0
        assert chunk >= min(max(32, 16 * m), 256)  # partials at most half the pulse bytes
        # a split k means too few column blocks: the counters cover them
        assert e * -(-n // cols) < port_mm.SPLITK_TARGET_CTAS
    assert port_mm._v3_body(m, k, n, 256, 4096, 8192) == "splitk"


@pytest.mark.parametrize("k,n,least", [(1024, 960, 132), (1024, 2560, 264), (2560, 960, 264)])
def test_v3_decode_plan_fills_the_card_on_smollms_layer(k, n, least):
    """q/o launch >= 132 CTAs and up/gate/down >= 264 at m 4 (two an SM)."""
    assert len(_plan_tiles(1, 4, k, n, 256)) >= least


@pytest.mark.parametrize("k,n", [(2048, 1408), (1536, 2048)])
def test_v3_decode_plan_does_not_split_the_expert_banks(k, n):
    assert port_mm._v3_decode_plan(64, 1, k, n, 256) == (port_mm.SPLITK_COLS, k, 1)


@pytest.mark.parametrize("failing", [dict(n=40), dict(n=2568), dict(group=6, k=1020),
                                     dict(group=18, k=1026), dict(w_ptr=8200),
                                     dict(x_ptr=4098)])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_v3_decode_routes_ragged_shapes_to_direct(failing, m):
    assert port_mm._v3_body(**{**_MMA_OK, "m": m, **failing}) == "direct"


@pytest.mark.parametrize("m,k,n", [(9, 256, 16), (60, 2048, 1408), (60, 1536, 2048),
                                   (512, 1024, 2560), (640, 2048, 102400)])
def test_v3_body_takes_the_tensor_cores_when_every_precondition_holds(m, k, n):
    assert port_mm._v3_body(**{**_MMA_OK, "m": m, "k": k, "n": n}) == "mma"
    assert port_mm._v3_body(m, 96, 48, 32, 16, 32) == "mma"


@pytest.mark.parametrize("failing", [dict(group=48, k=960), dict(group=16, k=1024),
                                     dict(n=40), dict(n=2568), dict(x_ptr=4100),
                                     dict(w_ptr=8200)])
def test_v3_body_is_direct_when_a_precondition_fails(failing):
    assert port_mm._v3_body(**{**_MMA_OK, **failing}) == "direct"


# the full-width main paths' v2 calls (the f32 leg): (k_pad, n) of
# smollm-360m's 7 layer matmuls (wq, wk, wv, wo, wi_gate, wi_up, ffn wo);
# deepseek-v2-lite-16b's 2-D matrices (MLA wq, wkv_a, wk_rope, wo; layer 0's
# dense FFN up/gate and down, 10944 padded to 11008; the shared experts' up/
# gate and down; the untied lm_head) and its two expert-bank shapes (up/
# gate, wo with 1408 padded to 1536); group 256 throughout
V2_MAIN_PATH = [
    (1024, 960), (1024, 320), (1024, 2560), (2560, 960),
    (2048, 3072), (2048, 512), (2048, 64), (2048, 2048), (2048, 10944), (11008, 2048),
    (2048, 2816), (2816, 2048), (2048, 102400),
    (2048, 1408), (1536, 2048),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", V2_MAIN_PATH)
def test_v2_body_on_the_main_paths_shapes(k, n, dtype):
    """Decode (m 4 on the 2-D matrices, m 1 per expert) takes the splitk
    body; prefill (m 512, m 60 per expert) the f64 tensor cores."""
    for m in (1, 4, 8):
        assert port_mm._v2_body(m, k, n, 256, 4096, 8192, dtype) == "splitk"
    for m in (9, 60, 512):
        assert port_mm._v2_body(m, k, n, 256, 4096, 8192, dtype) == "mma"


# at m <= 8: a ragged n, a group not divisible by 4, unaligned pulses, and an
# x not aligned to 4 of its elements (f32: 16 bytes, bf16: 8 bytes)
@pytest.mark.parametrize("failing,dtype", [
    (dict(n=40), torch.float32), (dict(n=40), torch.bfloat16),
    (dict(n=2568), torch.float32), (dict(group=6, k=1020), torch.float32),
    (dict(group=6, k=1020), torch.bfloat16), (dict(group=18, k=1026), torch.bfloat16),
    (dict(w_ptr=8200), torch.float32), (dict(w_ptr=8200), torch.bfloat16),
    (dict(x_ptr=4104), torch.float32), (dict(x_ptr=4100), torch.float32),
    (dict(x_ptr=4100), torch.bfloat16), (dict(x_ptr=4098), torch.bfloat16),
])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_v2_decode_routes_ragged_or_misaligned_shapes_to_direct(failing, dtype, m):
    call = {**dict(m=m, k=1024, n=2560, group=256, x_ptr=4096, w_ptr=8192), **failing}
    assert port_mm._v2_body(**call, x_dtype=dtype) == "direct"


def test_v2_splitk_takes_an_x_aligned_to_four_of_its_elements():
    """bf16 x needs 8-byte alignment for its 4-element copies, f32 16."""
    assert port_mm._v2_body(4, 1024, 960, 256, 4104, 8192, torch.bfloat16) == "splitk"
    assert port_mm._v2_body(4, 1024, 960, 256, 4104, 8192, torch.float32) == "direct"
    assert port_mm._v2_body(4, 96, 48, 4, 16, 32, torch.float32) == "splitk"


@pytest.mark.parametrize("m,n,group", [(9, 64, 64), (4, 40, 64), (4, 64, 6)])
def test_pick_v2_body_refuses_splitk_outside_its_preconditions(m, n, group):
    k = 4 * group
    x = torch.zeros(m, k)
    w = torch.zeros(k, n, dtype=torch.int8)
    with pytest.raises(ValueError, match="v2 splitk body"):
        port_mm._pick_v2_body("splitk", m, k, n, group, x, w)
    assert port_mm._pick_v2_body(None, m, k, n, group, x, w) in ("direct", "mma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("failing", [dict(group=8, k=1024), dict(group=24, k=960),
                                     dict(n=40), dict(n=2568), dict(x_ptr=4100),
                                     dict(x_ptr=4104), dict(w_ptr=8200)])
def test_v2_body_is_direct_on_ragged_or_misaligned_operands(failing, dtype):
    call = {**dict(m=512, k=1024, n=2560, group=256, x_ptr=4096, w_ptr=8192), **failing}
    assert port_mm._v2_body(**call, x_dtype=dtype) == "direct"
    assert port_mm._v2_body(**{**call, "m": 60}, x_dtype=dtype) == "direct"


def test_cpu_route_leaves_v2_body_counts_alone():
    """CPU tensors take the plain versions at every m, 2-D and batched: no
    v2 launch, of either body, is counted."""
    from repro_torch.core.packed import pack_matmul

    before, before_bodies = dict(LAUNCHES), dict(V2_BODY_LAUNCHES)
    pulses = torch.randint(-3, 4, (64, 16), dtype=torch.int8)
    for m in (4, 60):
        ops.pvq_matmul(torch.randn(m, 64), pulses, torch.ones(1, 16), group=64)
        ops.pvq_matmul(torch.randn(m, 64).to(torch.bfloat16), pulses, torch.ones(1, 16), group=64)
    bank = pack_matmul(torch.randn(2, 64, 16), group=64, k=64)
    ops.packed_matmul_stacked(torch.randn(2, 60, 64), bank)
    assert dict(LAUNCHES) == before
    assert dict(V2_BODY_LAUNCHES) == before_bodies


def test_cpu_route_launches_no_kernel():
    before, before_bodies = dict(LAUNCHES), dict(V3_BODY_LAUNCHES)
    x = torch.randn(2, 64)
    pulses = torch.randint(-3, 4, (64, 8), dtype=torch.int8)
    ops.pvq_matmul(x, pulses, torch.ones(1, 8), group=64)
    ops.pvq_matmul(x, pulses, torch.ones(1, 8), group=64, act_quant=port_q.ActQuant())
    ops.pvq_encode(torch.randn(3, 16), k_pulses=8)
    assert dict(LAUNCHES) == before
    assert dict(V3_BODY_LAUNCHES) == before_bodies


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        port_enc.pvq_encode_batch_cuda(torch.randn(2, 8), k_pulses=4)
    with pytest.raises(ValueError, match="CUDA"):
        port_mm.pvq_matmul_cuda(torch.randn(2, 8), torch.zeros(8, 4, dtype=torch.int8),
                                torch.ones(1, 4), group=8)
    with pytest.raises(ValueError, match="CUDA"):
        port_mm.act_quant_rows_cuda(torch.randn(2, 8), 8)


# ---------------------------------------------------------------------------
# the int8 boundary (ops.quantize_rows; csrc/act_quant.cu on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d_in,k_pad", ACT_SHAPES)
def test_quantize_rows_cpu_route_is_pad_then_quantize_activations(rows, d_in, k_pad, dtype):
    """Per row, the CPU route of ``quantize_rows`` is ``F.pad`` of the f32
    cast, then ``quantize_activations``, bit for bit in ``q`` and ``scale``:
    the zero row gets scale 0, the ties row rounds half to even, the
    negative absmax sets its row's scale."""
    x = act_rows(rows * 7 + d_in, rows, d_in, dtype)
    q, scale = ops.quantize_rows(x, k_pad, port_q.ActQuant("per_row"))
    want_q, want_scale = port_q.quantize_activations(
        torch.nn.functional.pad(x.float(), (0, k_pad - d_in)), port_q.ActQuant("per_row"))
    assert q.dtype == torch.int8 and tuple(q.shape) == (rows, k_pad)
    assert scale.dtype == torch.float32 and tuple(scale.shape) == (rows, 1)
    assert torch.equal(q, want_q) and torch.equal(scale, want_scale)
    assert not q[:, d_in:].any()
    ties = 0 if rows == 1 else 1
    np.testing.assert_array_equal(q[ties, : len(TIES_ROUNDED)].numpy(), TIES_ROUNDED)
    assert float(scale[ties]) == 1.0
    if rows > 1:
        assert float(scale[0]) == 0.0 and not q[0].any()
        assert float(scale[2]) == float(np.float32(40.0) / np.float32(127.0))
        assert int(q[2, d_in // 2]) == -127


@pytest.mark.parametrize("bias,activation", [(False, "none"), (True, "silu")])
def test_pvq_dense_on_bf16_x_matches_the_f32_composition(bias, activation):
    """``pvq_dense`` hands a bf16 ``x`` to ``quantize_rows`` uncast and lets
    kernel v3 write bf16: the same bits as the f32 composition it replaced
    (cast, pad, quantize, v3 in f32, cast back)."""
    from repro_torch.core.packed import pack_matmul
    from repro_torch.nn.layers import pvq_dense

    gen = torch.Generator().manual_seed(31)
    packed = pack_matmul(torch.randn(960, 320, generator=gen) * 0.05, group=256, k=128)
    p = {"kernel": packed}
    if bias:
        p["bias"] = (torch.randn(320, generator=gen) * 0.1).to(torch.bfloat16)
    x = act_rows(33, 32, 960, torch.bfloat16).reshape(4, 8, 960)
    got = pvq_dense(p, x, activation=activation, act_quant=port_q.ActQuant())

    xf = torch.nn.functional.pad(x.reshape(-1, 960).to(torch.float32), (0, 1024 - 960))
    xq, a = port_q.quantize_activations(xf, port_q.ActQuant())
    want = port_mm.pvq_matmul_q_plain(xq, packed.pulses, packed.scales, a, p.get("bias"),
                                      group=256, activation=activation)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16).reshape(4, 8, 320))


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
