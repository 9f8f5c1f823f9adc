"""PVQ matmuls and packed-KV attention decode (port of
``repro.kernels.pvq_matmul``): kernels v2 ``pvq_matmul``, v3
``pvq_matmul_q`` and v4 ``pvq_attn_q``.

For each kernel, ``*_cuda`` launches the hand-written Hopper kernel
(``csrc/pvq_matmul.cu``, ``csrc/pvq_attn.cu``) and ``*_plain`` computes the
same function in plain PyTorch.  Integer contractions in the plain versions
run as f32 matmuls of integer-valued tensors, exact while
``group * 127^2 < 2^24`` (``torch.mm`` on int8 wraps in int8); wider groups
contract in int64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import LAUNCHES
from . import build

ACTIVATIONS = ("none", "relu", "relu2", "gelu", "silu")

#: finite attention mask value (a fully masked block merges out with weight 0)
ATTN_NEG_INF = -1e30
#: sequence columns per attention block (the reference's bs at S > 128; for
#: S <= 128 its single block covers the same columns)
ATTN_BS = 128

# exp of a non-positive argument for the softmax of kernel v4, as one fixed
# sequence of separately rounded f32 operations that csrc/pvq_attn.cu
# repeats (torch.exp and CUDA's expf may differ in the last bit): Cody-Waite
# reduction x = n ln2 + r, the Cephes expf polynomial on r, then times 2^n
# built from its bits.  Arguments below EXP_MIN give 0.
EXP_MIN = -87.0
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
             1.6666665459e-1, 5.0000001201e-1)

_EXACT_F32 = 2**24


def _apply_activation(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "none":
        return y
    if activation == "relu":
        return torch.relu(y)
    if activation == "relu2":
        r = torch.relu(y)
        return r * r
    if activation == "gelu":
        return torch.nn.functional.gelu(y, approximate="tanh")
    if activation == "silu":
        return torch.nn.functional.silu(y)
    raise ValueError(f"unknown activation {activation!r}; expected one of {ACTIVATIONS}")


def int_dot(a: torch.Tensor, b: torch.Tensor, depth: int) -> torch.Tensor:
    """Exact integer ``a @ b`` of int8-valued operands, returned as f32."""
    if depth * 127 * 127 < _EXACT_F32:
        return a.to(torch.float32) @ b.to(torch.float32)
    return (a.to(torch.int64)[..., :, :, None] * b.to(torch.int64)[..., None, :, :]).sum(-2).to(
        torch.float32
    )


def exp_nonpos(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` for f32 ``x <= 0`` (about one ulp), bit for bit what kernel
    v4 computes on the card."""
    xc = torch.clamp(x, min=EXP_MIN)
    n = torch.round(xc * _LOG2E)
    r = (xc - n * _LN2_HI) - n * _LN2_LO
    z = r * r
    y = r * _EXP_POLY[0] + _EXP_POLY[1]
    for c in _EXP_POLY[2:]:
        y = y * r + c
    y = (y * z + r) + 1.0
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(x < EXP_MIN, torch.zeros_like(y), y * two_n)


def _check_matmul(x, w_pulses, scales, group, bias, activation):
    m, k = x.shape
    k2, n = w_pulses.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if k % group:
        raise ValueError(f"contraction dim {k} must be a group ({group}) multiple")
    if w_pulses.dtype != torch.int8:
        raise ValueError(f"pulses must be int8, got {w_pulses.dtype}")
    if tuple(scales.shape) != (k // group, n):
        raise ValueError(f"scales {tuple(scales.shape)} != {(k // group, n)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({n},)")
    return m, k, n


def _per_tile(act_scale, m, k, group) -> bool:
    per_tile = tuple(act_scale.shape) == (m, k // group) and k > group
    if not per_tile and tuple(act_scale.shape) not in ((m, 1), (1, 1)):
        raise ValueError(f"act_scale {tuple(act_scale.shape)} fits neither (m,1)/(1,1) nor (m,k/G)")
    return per_tile


def _cuda_operand(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# kernel v2: float activations
# ---------------------------------------------------------------------------


def pvq_matmul_plain(
    x: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, group: int, activation: str = "none",
) -> torch.Tensor:
    """``act(sum_g (x_g @ W_g) * rho_g + bias)`` in x's float dtype."""
    m, k, n = _check_matmul(x, w_pulses, scales, group, bias, activation)
    xf = x.to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(k // group):
        sl = slice(g * group, (g + 1) * group)
        acc = acc + (xf[:, sl] @ w_pulses[sl].to(torch.float32)) * scales[g].to(torch.float32)
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return _apply_activation(acc, activation).to(x.dtype)


def pvq_matmul_cuda(
    x: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, group: int, activation: str = "none",
) -> torch.Tensor:
    m, k, n = _check_matmul(x, w_pulses, scales, group, bias, activation)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pvq_matmul takes f32 or bf16 x, got {x.dtype}")
    xc = _cuda_operand(x, x.dtype, "x")
    wc = _cuda_operand(w_pulses, torch.int8, "w_pulses")
    sc = _cuda_operand(scales, torch.float32, "scales")
    bc = None if bias is None else _cuda_operand(bias, torch.float32, "bias")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    status = build.launcher("pvq_matmul_launch")(
        xc.data_ptr(), wc.data_ptr(), sc.data_ptr(),
        None if bc is None else bc.data_ptr(), ACTIVATIONS.index(activation),
        out.data_ptr(), int(x.dtype == torch.bfloat16), m, k, n, group, _stream(x),
    )
    build.check(status, "pvq_matmul")
    LAUNCHES["pvq_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel v3: int8 activations
# ---------------------------------------------------------------------------


def pvq_matmul_q_plain(
    x_q: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    act_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
    group: int, activation: str = "none", out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``act(a (.) sum_g rho_g * int32(x_q,g @ W_g) + bias)``; a per-row
    ``(m,1)``/``(1,1)`` scale applies in the epilogue, a per-tile
    ``(m, k/G)`` scale to each group partial beside rho."""
    m, k, n = _check_matmul(x_q, w_pulses, scales, group, bias, activation)
    if x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be pre-quantized int8, got {x_q.dtype}")
    per_tile = _per_tile(act_scale, m, k, group)
    a = act_scale.to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x_q.device)
    for g in range(k // group):
        sl = slice(g * group, (g + 1) * group)
        part = int_dot(x_q[:, sl], w_pulses[sl], group) * scales[g].to(torch.float32)
        if per_tile:
            part = part * a[:, g : g + 1]
        acc = acc + part
    y = acc if per_tile else acc * a
    if bias is not None:
        y = y + bias.to(torch.float32)
    return _apply_activation(y, activation).to(out_dtype)


def pvq_matmul_q_cuda(
    x_q: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    act_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
    group: int, activation: str = "none", out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    m, k, n = _check_matmul(x_q, w_pulses, scales, group, bias, activation)
    if x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be pre-quantized int8, got {x_q.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pvq_matmul_q writes f32 or bf16, got {out_dtype}")
    per_tile = _per_tile(act_scale, m, k, group)
    a_mode = 2 if per_tile else (1 if tuple(act_scale.shape) == (1, 1) else 0)
    xc = _cuda_operand(x_q, torch.int8, "x_q")
    wc = _cuda_operand(w_pulses, torch.int8, "w_pulses")
    sc = _cuda_operand(scales, torch.float32, "scales")
    ac = _cuda_operand(act_scale, torch.float32, "act_scale")
    bc = None if bias is None else _cuda_operand(bias, torch.float32, "bias")
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    status = build.launcher("pvq_matmul_q_launch")(
        xc.data_ptr(), wc.data_ptr(), sc.data_ptr(), ac.data_ptr(), a_mode,
        None if bc is None else bc.data_ptr(), ACTIVATIONS.index(activation),
        out.data_ptr(), int(out_dtype == torch.bfloat16), m, k, n, group, _stream(x_q),
    )
    build.check(status, "pvq_matmul_q")
    LAUNCHES["pvq_matmul_q"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel v4: packed-KV flash decode
# ---------------------------------------------------------------------------


def _check_attn(q_i8, act_scale, k_pulses, k_scales, v_pulses, v_scales, kv_len, group):
    """Shapes of a v4 call.  The K/V planes are in a packed cache's own
    ``(b, S, n_kv, X)`` layout with ``b * n_kv == BH``: row ``bh`` of q is
    batch ``bh // n_kv``, kv head ``bh % n_kv``.  Returns
    ``(bh, m, hd, s, ng, n_kv)``."""
    bh, m, hd = q_i8.shape
    if k_pulses.ndim != 4:
        raise ValueError(f"K/V planes must be (b, S, n_kv, X), got {tuple(k_pulses.shape)}")
    b, s, n_kv = k_pulses.shape[:3]
    if hd % group:
        raise ValueError(f"head dim {hd} not a multiple of group {group}")
    ng = hd // group
    if q_i8.dtype != torch.int8 or k_pulses.dtype != torch.int8 or v_pulses.dtype != torch.int8:
        raise ValueError("queries and K/V pulses must be int8")
    if b * n_kv != bh or tuple(k_pulses.shape) != (b, s, n_kv, hd) \
            or tuple(v_pulses.shape) != (b, s, n_kv, hd):
        raise ValueError(f"K/V pulses must be (b, S, n_kv, hd) with b*n_kv = {bh}")
    if tuple(k_scales.shape) != (b, s, n_kv, ng) or tuple(v_scales.shape) != (b, s, n_kv, ng):
        raise ValueError(f"K/V scales must be {(b, s, n_kv, ng)}")
    if tuple(act_scale.shape) != (bh, m, 1):
        raise ValueError(f"act_scale {tuple(act_scale.shape)} != {(bh, m, 1)}")
    if tuple(kv_len.shape) != (bh,):
        raise ValueError(f"kv_len {tuple(kv_len.shape)} != ({bh},)")
    return bh, m, hd, s, ng, n_kv


def pvq_attn_q_plain(
    q_i8, act_scale, k_pulses, k_scales, v_pulses, v_scales, kv_len, *,
    group: int, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """UNNORMALIZED ``(acc (BH,m,hd), m (BH,m,1), l (BH,m,1))`` of the packed
    flash decode, walking the sequence in 128-column blocks.  Each block's
    probability sum is the kernel's pairwise tree (``tree_sum``) and its exp
    is ``exp_nonpos``, so on the card the two agree bit for bit."""
    from ..core.pvq import tree_sum

    bh, m, hd, s, ng, _ = _check_attn(
        q_i8, act_scale, k_pulses, k_scales, v_pulses, v_scales, kv_len, group
    )
    # (b, S, n_kv, X) -> (BH, S, X) rows
    k_pulses, k_scales, v_pulses, v_scales = (
        t.permute(0, 2, 1, 3).reshape(bh, s, t.shape[-1])
        for t in (k_pulses, k_scales, v_pulses, v_scales)
    )
    dev = q_i8.device
    a = act_scale.to(torch.float32)
    lens = kv_len.to(torch.int64)[:, None, None]
    acc = torch.zeros((bh, m, hd), dtype=torch.float32, device=dev)
    m_run = torch.full((bh, m, 1), ATTN_NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((bh, m, 1), dtype=torch.float32, device=dev)
    n_blk = -(-int(kv_len.max()) // ATTN_BS) if bh else 0
    for blk in range(n_blk):
        lo, hi = blk * ATTN_BS, min((blk + 1) * ATTN_BS, s)
        cols = torch.arange(lo, hi, device=dev)[None, None, :]
        valid = cols < lens  # (BH, 1, w)
        kp, vp = k_pulses[:, lo:hi], v_pulses[:, lo:hi]
        ks, vs = k_scales[:, lo:hi].to(torch.float32), v_scales[:, lo:hi].to(torch.float32)
        scores = torch.zeros((bh, m, hi - lo), dtype=torch.float32, device=dev)
        for g in range(ng):
            sl = slice(g * group, (g + 1) * group)
            part = int_dot(q_i8[:, :, sl], kp[:, :, sl].transpose(1, 2), group)
            scores = scores + part * ks[:, None, :, g]
        scores = scores * a * sm_scale
        scores = torch.where(valid, scores, torch.full_like(scores, ATTN_NEG_INF))
        m_new = torch.maximum(m_run, scores.amax(-1, keepdim=True))
        p = torch.where(valid, exp_nonpos(scores - m_new), torch.zeros_like(scores))
        alpha = exp_nonpos(m_run - m_new)
        l_run = l_run * alpha + tree_sum(p, keepdim=True)
        m_run = m_new
        outs = []
        for g in range(ng):
            sl = slice(g * group, (g + 1) * group)
            pg = p * vs[:, None, :, g]
            # a tensor divisor: PyTorch's CUDA division by a Python scalar
            # multiplies by its f32 reciprocal, one rounding more than the
            # kernel's (and the reference's) true division
            amax = pg.abs().amax(-1, keepdim=True)
            s_p = amax / torch.full_like(amax, 127.0)
            inv = torch.where(s_p > 0, 1.0 / torch.clamp(s_p, min=1e-30), torch.zeros_like(s_p))
            pq = torch.clamp(torch.round(pg * inv), -127, 127)
            outs.append(int_dot(pq, vp[:, :, sl], hi - lo) * s_p)
        acc = acc * alpha + torch.cat(outs, dim=-1)
    return acc, m_run, l_run


def pvq_attn_q_cuda(
    q_i8, act_scale, k_pulses, k_scales, v_pulses, v_scales, kv_len, *,
    group: int, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel v4.  It reads a packed cache's ``(b, S, n_kv, X)`` planes in
    place (never copied into per-row order)."""
    bh, m, hd, s, ng, n_kv = _check_attn(
        q_i8, act_scale, k_pulses, k_scales, v_pulses, v_scales, kv_len, group
    )
    if build.launcher("pvq_attn_q_smem_bytes")(m, hd, group) > 227 * 1024:
        raise ValueError(f"pvq_attn_q: {m} query rows x head dim {hd} exceed shared memory")
    ops_ = [
        _cuda_operand(q_i8, torch.int8, "q"),
        _cuda_operand(act_scale, torch.float32, "act_scale"),
        _cuda_operand(k_pulses, torch.int8, "k_pulses"),
        _cuda_operand(k_scales, torch.float32, "k_scales"),
        _cuda_operand(v_pulses, torch.int8, "v_pulses"),
        _cuda_operand(v_scales, torch.float32, "v_scales"),
        _cuda_operand(kv_len, torch.int32, "kv_len"),
    ]
    dev = q_i8.device
    acc = torch.empty((bh, m, hd), dtype=torch.float32, device=dev)
    m_run = torch.empty((bh, m, 1), dtype=torch.float32, device=dev)
    l_run = torch.empty((bh, m, 1), dtype=torch.float32, device=dev)
    status = build.launcher("pvq_attn_q_launch")(
        *[t.data_ptr() for t in ops_], bh, n_kv, m, s, hd, group, float(sm_scale),
        acc.data_ptr(), m_run.data_ptr(), l_run.data_ptr(), _stream(q_i8),
    )
    build.check(status, "pvq_attn_q")
    LAUNCHES["pvq_attn_q"] += 1
    return acc, m_run, l_run
