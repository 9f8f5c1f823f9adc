"""PVQ matmuls and packed-KV attention decode (port of
``repro.kernels.pvq_matmul``): kernels v2 ``pvq_matmul``, v3
``pvq_matmul_q``, their expert-batched forms ``pvq_matmul_batched`` and
``pvq_matmul_q_batched``, and v4 ``pvq_attn_q``; and ``act_quant_rows``,
the per-row int8 quantization of the activations in front of v3 and v4.

For each kernel, ``*_cuda`` launches the hand-written Hopper kernel
(``csrc/pvq_matmul.cu``, ``csrc/pvq_matmul_batched.cu``,
``csrc/pvq_attn.cu`` with ``csrc/pvq_attn_decode.cuh``,
``csrc/act_quant.cu``) and ``*_plain`` computes the same function in plain
PyTorch.  Integer contractions in the plain versions run as f32 matmuls of
integer-valued tensors, exact while ``group * 127^2 < 2^24`` (``torch.mm``
on int8 wraps in int8); wider groups contract in int64.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import LAUNCHES, V2_BODY_LAUNCHES, V3_BODY_LAUNCHES
from . import build

#: the bodies' version: part of every tuned entry's key, so a change to a
#: kernel body (``csrc/``) that moves its timing is bumped here and every
#: entry timed against the old body misses
KERNEL_VERSION = 1

ACTIVATIONS = ("none", "relu", "relu2", "gelu", "silu")
#: kernel v3's bodies, in the C launchers' numbering
V3_BODIES = ("splitk", "direct", "mma")
#: kernel v2's bodies, in the C launchers' numbering
V2_BODIES = ("direct", "mma", "splitk")

#: finite attention mask value (a fully masked block merges out with weight 0)
ATTN_NEG_INF = -1e30
#: sequence columns per attention block (the reference's bs at S > 128; for
#: S <= 128 its single block covers the same columns)
ATTN_BS = 128

# exp of a non-positive argument for the softmax of kernel v4, as one fixed
# sequence of separately rounded f32 operations that csrc/pvq_attn_decode.cuh
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
    """``act(sum_g (x_g @ W_g) * rho_g + bias)`` in x's float dtype.  Each
    group's dot is taken in f64 (every product exact) and rounded to f32
    once, so its f32 value does not depend on the order of the sum; rho
    and the f32 accumulator follow, as in kernel v2."""
    m, k, n = _check_matmul(x, w_pulses, scales, group, bias, activation)
    xd = x.to(torch.float64)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(k // group):
        sl = slice(g * group, (g + 1) * group)
        dot = (xd[:, sl] @ w_pulses[sl].to(torch.float64)).to(torch.float32)
        acc = acc + dot * scales[g].to(torch.float32)
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return _apply_activation(acc, activation).to(x.dtype)


def _v2_mma_fits(k: int, n: int, group: int, x_ptr: int, w_ptr: int,
                 x_dtype: torch.dtype) -> bool:
    """Whether v2's tensor-core body takes the operands: 16- or 32-deep
    stages that never straddle a group, and 16-byte aligned x and pulse
    rows for x's dtype."""
    return (group % 16 == 0 and n % 16 == 0 and (k * x_dtype.itemsize) % 16 == 0
            and x_ptr % 16 == 0 and w_ptr % 16 == 0)


def _v2_splitk_fits(k: int, n: int, group: int, x_ptr: int, w_ptr: int,
                    x_dtype: torch.dtype) -> bool:
    """Whether v2's splitk body takes the operands: 4-row steps inside a
    group, 16-byte pulse pieces (n % 16 == 0, aligned pulses) and x staged
    4 elements a copy (x aligned to 4 of its elements)."""
    return (group % 4 == 0 and n % 16 == 0 and w_ptr % 16 == 0
            and x_ptr % (4 * x_dtype.itemsize) == 0)


def _v2_body(m: int, k: int, n: int, group: int, x_ptr: int, w_ptr: int,
             x_dtype: torch.dtype) -> str:
    """Which body of kernel v2 contracts ``m`` rows (per expert) of ``(m, k)
    x (k, n)``: at m <= 8 (decode) ``"splitk"`` (the contraction split over
    CTAs with f64 partials, see :func:`_v3_decode_plan`) when the operands
    fit it, above that ``"mma"`` (f64 tensor cores on 64 x 64 tiles) when
    they fit it, and ``"direct"`` (f64 FMAs on the CUDA cores, 8 x 32 CTAs)
    for the ragged rest.  Each takes each group's dot in f64 and rounds it
    to f32 once, as the plain version does."""
    if m <= 8:
        return "splitk" if _v2_splitk_fits(k, n, group, x_ptr, w_ptr, x_dtype) else "direct"
    return "mma" if _v2_mma_fits(k, n, group, x_ptr, w_ptr, x_dtype) else "direct"


def _pick_v2_body(body: Optional[str], m, k, n, group, xc, wc, tuned: bool = False) -> str:
    """The rule's body, or ``body`` where a caller names one: a check that
    compares bodies on the card (the mma and splitk bodies are refused where
    the operands do not fit them) or, with ``tuned``, the autotuner's choice
    (where the operands do not fit it, the rule's body runs)."""
    xp, wp = xc.data_ptr(), wc.data_ptr()
    if body is None:
        return _v2_body(m, k, n, group, xp, wp, xc.dtype)
    if body not in V2_BODIES:
        problem = f"unknown v2 body {body!r}; expected one of {V2_BODIES}"
    elif body == "mma" and not _v2_mma_fits(k, n, group, xp, wp, xc.dtype):
        problem = (f"the v2 mma body needs group % 16 == 0, n % 16 == 0 and 16-byte "
                   f"aligned rows (k {k}, n {n}, group {group}, {xc.dtype})")
    elif body == "splitk" and (m > 8 or not _v2_splitk_fits(k, n, group, xp, wp, xc.dtype)):
        problem = (f"the v2 splitk body needs m <= 8, group % 4 == 0 and n % 16 == 0 "
                   f"(m {m}, k {k}, n {n}, group {group})")
    else:
        return body
    if tuned:
        return _v2_body(m, k, n, group, xp, wp, xc.dtype)
    raise ValueError(problem)


def pvq_matmul_cuda(
    x: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, group: int, activation: str = "none",
    _body: Optional[str] = None, _chunk: Optional[int] = None, _tuned: bool = False,
) -> torch.Tensor:
    """Kernel v2 on the rule's body and splitk plan, or ``_body`` and
    ``_chunk`` where a caller names them: a check (refused where the
    operands do not fit them) or, with ``_tuned``, the autotuner's choice
    (the rule's where they do not fit)."""
    m, k, n = _check_matmul(x, w_pulses, scales, group, bias, activation)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pvq_matmul takes f32 or bf16 x, got {x.dtype}")
    xc = _cuda_operand(x, x.dtype, "x")
    wc = _cuda_operand(w_pulses, torch.int8, "w_pulses")
    sc = _cuda_operand(scales, torch.float32, "scales")
    bc = None if bias is None else _cuda_operand(bias, torch.float32, "bias")
    body = _pick_v2_body(_body, m, k, n, group, xc, wc, _tuned)
    plan = _splitk_plan(body, 1, m, k, n, group, _choice(_body, _chunk, body), _tuned)
    stream = _stream(x)
    scratch, counters = _splitk_buffers(plan, 1, m, n, x.device, stream, torch.float64)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    status = build.launcher("pvq_matmul_launch")(
        xc.data_ptr(), wc.data_ptr(), sc.data_ptr(), _ptr(bc), ACTIVATIONS.index(activation),
        out.data_ptr(), int(x.dtype == torch.bfloat16), m, k, n, group,
        V2_BODIES.index(body), *plan, _ptr(scratch), _ptr(counters), stream,
    )
    build.check(status, f"pvq_matmul ({body} body)")
    LAUNCHES["pvq_matmul"] += 1
    V2_BODY_LAUNCHES[body] += 1
    return out


# ---------------------------------------------------------------------------
# the int8 boundary: per-row activation quantization in front of v3 and v4
# ---------------------------------------------------------------------------


def act_quant_rows_plain(x: torch.Tensor, k_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (..., d_in)`` zero-padded to ``k_pad``, then quantized per row
    (``core.quantize.quantize_activations``): ``(q int8 (..., k_pad),
    scale f32 (..., 1))``."""
    from ..core.quantize import ActQuant, quantize_activations

    if x.shape[-1] != k_pad:
        x = torch.nn.functional.pad(x, (0, k_pad - x.shape[-1]))
    return quantize_activations(x, ActQuant("per_row"))


def act_quant_rows_cuda(x: torch.Tensor, k_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`act_quant_rows_plain` in one launch (``csrc/act_quant.cu``):
    the cast, the pad and the quantization fused, bit for bit the same.
    ``x`` is f32 or bf16 with unit stride along its last dim; its rows may
    lie any stride apart.  Feeds the clamp and zero-scale probe as
    ``quantize_activations`` does (off while a graph is captured)."""
    from ..core.quantize import _probe_act_quant

    if x.device.type != "cuda":
        raise ValueError(f"act_quant_rows_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"act_quant_rows takes f32 or bf16 x, got {x.dtype}")
    d_in = x.shape[-1]
    if k_pad < max(d_in, 1):
        raise ValueError(f"k_pad {k_pad} below the row width {d_in}")
    x2 = x.reshape(-1, d_in)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    q = torch.empty((*x.shape[:-1], k_pad), dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if rows:
        ld = x2.stride(0) if rows > 1 else d_in
        status = build.launcher("act_quant_rows_launch")(
            x2.data_ptr(), ld, int(x.dtype == torch.bfloat16), rows, d_in, k_pad,
            q.data_ptr(), scale.data_ptr(), _stream(x),
        )
        build.check(status, "act_quant_rows")
        LAUNCHES["act_quant_rows"] += 1
    _probe_act_quant(q, scale)
    return q, scale


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


def _mma_fits(k: int, n: int, group: int, x_ptr: int, w_ptr: int) -> bool:
    """Whether the tensor-core body takes the operands: 32-deep k steps that
    never straddle a group, and 16-byte aligned x and pulse rows."""
    return (group % 32 == 0 and k % 16 == 0 and n % 16 == 0
            and x_ptr % 16 == 0 and w_ptr % 16 == 0)


def _splitk_fits(k: int, n: int, group: int, x_ptr: int, w_ptr: int) -> bool:
    """Whether the splitk body takes the operands: 4-row __dp4a steps inside
    a group, 16-byte pulse pieces (n % 16 == 0, aligned pulses) and 4-byte
    x words."""
    return group % 4 == 0 and n % 16 == 0 and w_ptr % 16 == 0 and x_ptr % 4 == 0


def _v3_body(m: int, k: int, n: int, group: int, x_ptr: int, w_ptr: int) -> str:
    """Which body of kernel v3 contracts ``m`` rows (per expert) of ``(m, k)
    x (k, n)``: at m <= 8 (decode) ``"splitk"`` (the contraction split over
    CTAs, see :func:`_v3_decode_plan`) when the operands fit it, above that
    ``"mma"`` (int8 tensor cores on 64 x 128 tiles) when they fit it, and
    ``"direct"`` (``__dp4a`` reading the pulses from global memory) for the
    ragged rest.  Every body is bit-identical to the plain version."""
    if m <= 8:
        return "splitk" if _splitk_fits(k, n, group, x_ptr, w_ptr) else "direct"
    return "mma" if _mma_fits(k, n, group, x_ptr, w_ptr) else "direct"


def _pick_body(body: Optional[str], m, k, n, group, xc, wc, tuned: bool = False) -> str:
    """The rule's body, or ``body`` where a caller names one: a check that
    compares bodies on the card (the mma and splitk bodies are refused where
    the operands do not fit them) or, with ``tuned``, the autotuner's choice
    (where the operands do not fit it, the rule's body runs)."""
    xp, wp = xc.data_ptr(), wc.data_ptr()
    if body is None:
        return _v3_body(m, k, n, group, xp, wp)
    if body not in V3_BODIES:
        problem = f"unknown v3 body {body!r}; expected one of {V3_BODIES}"
    elif body == "mma" and not _mma_fits(k, n, group, xp, wp):
        problem = f"the mma body needs group % 32 == 0 and n % 16 == 0 (k {k}, n {n}, group {group})"
    elif body == "splitk" and (m > 8 or not _splitk_fits(k, n, group, xp, wp)):
        problem = (f"the splitk body needs m <= 8, group % 4 == 0 and n % 16 == 0 "
                   f"(m {m}, k {k}, n {n}, group {group})")
    else:
        return body
    if tuned:
        return _v3_body(m, k, n, group, xp, wp)
    raise ValueError(problem)


#: SMs of the H100 SXM; the splitk plan aims at two CTAs on each
SPLITK_SMS = 132
SPLITK_TARGET_CTAS = 2 * SPLITK_SMS
#: output columns of a splitk CTA (64-byte pulse rows per request)
SPLITK_COLS = 64


@functools.lru_cache(maxsize=None)
def _v3_decode_plan(e: int, m: int, k: int, n: int, group: int) -> Tuple[int, int, int]:
    """``(cols, chunk, splits)`` of the splitk bodies (v3's and v2's) for
    ``e`` matrices of ``(m, k) x (k, n)``: CTAs of ``cols`` columns, each
    contracting ``chunk`` k rows; ``splits = k // chunk``.  Where the column
    blocks alone reach ``SPLITK_TARGET_CTAS`` (the 64-expert banks, a wide
    ``lm_head``), k is not split (``chunk == k``).  Otherwise the chunk is
    the largest divisor of the group, a multiple of 4, that reaches the
    target, but no smaller than ``max(32, 16 m)`` rows (v3's int32
    partials, written and read back, stay at most half the pulse bytes,
    v2's f64 partials at most all of them), or the group where that floor
    exceeds it."""
    cols = SPLITK_COLS
    tiles = e * -(-n // cols)
    if tiles >= SPLITK_TARGET_CTAS:
        return cols, k, 1
    floor = min(max(32, 16 * m), group)
    chunks = [d for d in range(group, 3, -1) if group % d == 0 and d % 4 == 0 and d >= floor]
    chunk = next((d for d in chunks if tiles * (k // d) >= SPLITK_TARGET_CTAS), chunks[-1])
    return cols, chunk, k // chunk


# (device index, stream) -> the splitk bodies' arrival counters (v3's and
# v2's), zero between calls: the last CTA of each column block resets its
# counter.  Two launches running at once on one buffer would corrupt each
# other, so the buffer is per stream (launches on one stream run one at a
# time, so v2 and v3 share it); a call splits k only below
# SPLITK_TARGET_CTAS column blocks, so that many counters serve every call.
# A CUDA graph keeps the address of its capture stream's buffer: it must
# not replay while another launch on that buffer runs (an eager call on the
# capture stream, or a replay of another graph captured there).
_SPLITK_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _splitk_chunk_fits(e: int, k: int, n: int, group: int, chunk: int) -> bool:
    """Whether the splitk bodies take ``chunk`` k rows a CTA: all of k (no
    split), or a divisor of the group, a multiple of 4, where the column
    blocks number fewer than ``SPLITK_TARGET_CTAS`` (the stream's counters
    serve that many blocks)."""
    if chunk == k:
        return True
    return (chunk > 0 and group % chunk == 0 and chunk % 4 == 0
            and e * -(-n // SPLITK_COLS) < SPLITK_TARGET_CTAS)


def _splitk_plan(body: str, e: int, m: int, k: int, n: int, group: int,
                 chunk: Optional[int] = None, tuned: bool = False) -> Tuple[int, int, int]:
    """``(cols, chunk, splits)`` of a launch of ``body`` (zeros for the
    bodies that do not split k): :func:`_v3_decode_plan`'s, or ``chunk``
    where a caller names one, refused where the splitk bodies do not take
    it, or with ``tuned`` (the autotuner's) replaced by the rule's."""
    if body != "splitk":
        return 0, 0, 0
    if chunk is None:
        return _v3_decode_plan(e, m, k, n, group)
    if not _splitk_chunk_fits(e, k, n, group, chunk):
        if tuned:
            return _v3_decode_plan(e, m, k, n, group)
        raise ValueError(f"the splitk bodies take chunk {k} or a divisor of group {group}, a "
                         f"multiple of 4, below {SPLITK_TARGET_CTAS} column blocks; got {chunk} "
                         f"(e {e}, n {n})")
    return SPLITK_COLS, chunk, k // chunk


def _splitk_buffers(plan: Tuple[int, int, int], e: int, m: int, n: int,
                    device: torch.device, stream: int, partial: torch.dtype = torch.int32):
    """For a splitk ``plan`` that splits k: a ``torch.empty`` scratch for its
    ``(e, splits, m, n)`` partials (int32 for v3, f64 for v2) and the
    stream's counters; None and None for any other plan."""
    if plan[2] <= 1:
        return None, None
    counters = _SPLITK_COUNTERS.get((device.index, stream))
    if counters is None:
        counters = torch.zeros(SPLITK_TARGET_CTAS, dtype=torch.int32, device=device)
        _SPLITK_COUNTERS[(device.index, stream)] = counters
    scratch = torch.empty((e, plan[2], m, n), dtype=partial, device=device)
    return scratch, counters


def _choice(body: Optional[str], chunk: Optional[int], picked: str) -> Optional[int]:
    """The named chunk where the named body runs (or none was named)."""
    return chunk if body in (None, picked) else None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def pvq_matmul_q_cuda(
    x_q: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    act_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
    group: int, activation: str = "none", out_dtype: torch.dtype = torch.float32,
    _body: Optional[str] = None, _chunk: Optional[int] = None, _tuned: bool = False,
) -> torch.Tensor:
    """Kernel v3; the body and plan as for :func:`pvq_matmul_cuda`."""
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
    body = _pick_body(_body, m, k, n, group, xc, wc, _tuned)
    plan = _splitk_plan(body, 1, m, k, n, group, _choice(_body, _chunk, body), _tuned)
    stream = _stream(x_q)
    scratch, counters = _splitk_buffers(plan, 1, m, n, x_q.device, stream)
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    status = build.launcher("pvq_matmul_q_launch")(
        xc.data_ptr(), wc.data_ptr(), sc.data_ptr(), ac.data_ptr(), a_mode,
        _ptr(bc), ACTIVATIONS.index(activation),
        out.data_ptr(), int(out_dtype == torch.bfloat16), m, k, n, group,
        V3_BODIES.index(body), *plan, _ptr(scratch), _ptr(counters), stream,
    )
    build.check(status, f"pvq_matmul_q ({body} body)")
    LAUNCHES["pvq_matmul_q"] += 1
    V3_BODY_LAUNCHES[body] += 1
    return out


# ---------------------------------------------------------------------------
# batched kernels v2 / v3: one launch over a stack of expert matrices
# ---------------------------------------------------------------------------


def _check_batched(x, w_pulses, scales, group, activation):
    """Shapes of a batched call: ``x (E, m, k)``, pulses ``(E, k, n)`` int8,
    scales ``(E, k // group, n)``; returns ``(e, m, k, n)``."""
    if x.ndim != 3 or w_pulses.ndim != 3 or scales.ndim != 3:
        raise ValueError(f"batched operands must be 3-D, got {tuple(x.shape)}, "
                         f"{tuple(w_pulses.shape)}, {tuple(scales.shape)}")
    e, m, k = x.shape
    e2, k2, n = w_pulses.shape
    if e != e2 or scales.shape[0] != e:
        raise ValueError(f"expert axes differ: {e}, {e2}, {scales.shape[0]}")
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if k % group:
        raise ValueError(f"contraction dim {k} must be a group ({group}) multiple")
    if w_pulses.dtype != torch.int8:
        raise ValueError(f"pulses must be int8, got {w_pulses.dtype}")
    if tuple(scales.shape) != (e, k // group, n):
        raise ValueError(f"scales {tuple(scales.shape)} != {(e, k // group, n)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    return e, m, k, n


def _batched_per_tile(act_scale, e, m, k, group) -> bool:
    """Whether a batched v3 scale is per tile ``(E, m, k // group)``; else
    it must be per row ``(E, m, 1)``."""
    shape = tuple(act_scale.shape)
    if shape == (e, m, k // group) and k > group:
        return True
    if shape == (e, m, 1):
        return False
    raise ValueError(f"act_scale {shape} fits neither {(e, m, 1)} nor {(e, m, k // group)}")


def pvq_matmul_batched_plain(
    x: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor, *,
    group: int, activation: str = "none",
) -> torch.Tensor:
    """Kernel v2 per expert: ``act(sum_g (x[e]_g @ W[e]_g) * rho[e]_g)``;
    each slice is :func:`pvq_matmul_plain`'s arithmetic in its order (the
    group dot in f64, rounded to f32 once)."""
    e, m, k, n = _check_batched(x, w_pulses, scales, group, activation)
    xd = x.to(torch.float64)
    acc = torch.zeros((e, m, n), dtype=torch.float32, device=x.device)
    for g in range(k // group):
        sl = slice(g * group, (g + 1) * group)
        dot = (xd[:, :, sl] @ w_pulses[:, sl].to(torch.float64)).to(torch.float32)
        acc = acc + dot * scales[:, g : g + 1].to(torch.float32)
    return _apply_activation(acc, activation).to(x.dtype)


def pvq_matmul_batched_cuda(
    x: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor, *,
    group: int, activation: str = "none", _body: Optional[str] = None,
    _chunk: Optional[int] = None, _tuned: bool = False,
) -> torch.Tensor:
    """Batched kernel v2; the body and plan as for :func:`pvq_matmul_cuda`."""
    e, m, k, n = _check_batched(x, w_pulses, scales, group, activation)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pvq_matmul_batched takes f32 or bf16 x, got {x.dtype}")
    xc = _cuda_operand(x, x.dtype, "x")
    wc = _cuda_operand(w_pulses, torch.int8, "w_pulses")
    sc = _cuda_operand(scales, torch.float32, "scales")
    body = _pick_v2_body(_body, m, k, n, group, xc, wc, _tuned)
    plan = _splitk_plan(body, e, m, k, n, group, _choice(_body, _chunk, body), _tuned)
    stream = _stream(x)
    scratch, counters = _splitk_buffers(plan, e, m, n, x.device, stream, torch.float64)
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    status = build.launcher("pvq_matmul_batched_launch")(
        xc.data_ptr(), wc.data_ptr(), sc.data_ptr(), ACTIVATIONS.index(activation),
        out.data_ptr(), int(x.dtype == torch.bfloat16), e, m, k, n, group,
        V2_BODIES.index(body), *plan, _ptr(scratch), _ptr(counters), stream,
    )
    build.check(status, f"pvq_matmul_batched ({body} body)")
    LAUNCHES["pvq_matmul_batched"] += 1
    V2_BODY_LAUNCHES[body] += 1
    return out


def pvq_matmul_q_batched_plain(
    x_q: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    act_scale: torch.Tensor, *, group: int, activation: str = "none",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Kernel v3 per expert: ``act(a[e] (.) sum_g rho[e]_g * int32(x_q[e]_g
    @ W[e]_g))`` with a per-row ``(E, m, 1)`` or per-tile
    ``(E, m, k // group)`` scale; each slice is
    :func:`pvq_matmul_q_plain`'s arithmetic, bit for bit (the integer
    contractions are exact)."""
    e, m, k, n = _check_batched(x_q, w_pulses, scales, group, activation)
    if x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be pre-quantized int8, got {x_q.dtype}")
    per_tile = _batched_per_tile(act_scale, e, m, k, group)
    a = act_scale.to(torch.float32)
    acc = torch.zeros((e, m, n), dtype=torch.float32, device=x_q.device)
    for g in range(k // group):
        sl = slice(g * group, (g + 1) * group)
        part = int_dot(x_q[:, :, sl], w_pulses[:, sl], group) * scales[:, g : g + 1].to(torch.float32)
        if per_tile:
            part = part * a[:, :, g : g + 1]
        acc = acc + part
    y = acc if per_tile else acc * a
    return _apply_activation(y, activation).to(out_dtype)


def pvq_matmul_q_batched_cuda(
    x_q: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor,
    act_scale: torch.Tensor, *, group: int, activation: str = "none",
    out_dtype: torch.dtype = torch.float32, _body: Optional[str] = None,
    _chunk: Optional[int] = None, _tuned: bool = False,
) -> torch.Tensor:
    """Batched kernel v3; the body and plan as for :func:`pvq_matmul_cuda`."""
    e, m, k, n = _check_batched(x_q, w_pulses, scales, group, activation)
    if x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be pre-quantized int8, got {x_q.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pvq_matmul_q_batched writes f32 or bf16, got {out_dtype}")
    a_mode = 2 if _batched_per_tile(act_scale, e, m, k, group) else 0
    xc = _cuda_operand(x_q, torch.int8, "x_q")
    wc = _cuda_operand(w_pulses, torch.int8, "w_pulses")
    sc = _cuda_operand(scales, torch.float32, "scales")
    ac = _cuda_operand(act_scale, torch.float32, "act_scale")
    body = _pick_body(_body, m, k, n, group, xc, wc, _tuned)
    plan = _splitk_plan(body, e, m, k, n, group, _choice(_body, _chunk, body), _tuned)
    stream = _stream(x_q)
    scratch, counters = _splitk_buffers(plan, e, m, n, x_q.device, stream)
    out = torch.empty((e, m, n), dtype=out_dtype, device=x_q.device)
    status = build.launcher("pvq_matmul_q_batched_launch")(
        xc.data_ptr(), wc.data_ptr(), sc.data_ptr(), ac.data_ptr(), a_mode,
        ACTIVATIONS.index(activation), out.data_ptr(), int(out_dtype == torch.bfloat16),
        e, m, k, n, group, V3_BODIES.index(body), *plan, _ptr(scratch), _ptr(counters), stream,
    )
    build.check(status, f"pvq_matmul_q_batched ({body} body)")
    LAUNCHES["pvq_matmul_q_batched"] += 1
    V3_BODY_LAUNCHES[body] += 1
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


#: kernel v4's CTA (csrc/pvq_attn_decode.cuh): query rows (kM) and warps
#: (kM x W) at most, and the H100's shared memory a CTA
V4_KM_MAX = 8
V4_WARPS_MAX = 16
V4_SMEM_MAX = 232448


def _v4_row_bytes(hd: int) -> int:
    """A staged K or V position's bytes in kernel v4 (``attn_row_bytes``):
    hd rounded up to 16 and the P @ V lanes' quads, padded to 16 mod 32."""
    nq = -(-hd // 4)
    quads = nq if nq >= 32 else 1 << (nq - 1).bit_length()
    words = max(-(-hd // 16) * 4, quads)
    return 4 * (words + (12 - words % 8) % 8)


def _v4_smem_bytes(km: int, w: int, hd: int, group: int) -> int:
    """Kernel v4's shared memory a CTA (``attn_layout``): W blocks' K and V
    tiles and scales, the kM query rows, each pair's requantized
    probabilities, then the f32 block outputs, acc and the per-pair and
    per-row values.  It does not depend on m."""
    ng = hd // group
    tiles = 2 * w * ATTN_BS * _v4_row_bytes(hd) + 2 * w * ATTN_BS * ng * 4
    q = km * -(-hd // 16) * 16
    floats = w * km * hd + km * hd + km * w * ng + 4 * km * w + 3 * km
    return tiles + q + km * w * ng * ATTN_BS + 4 * floats


def _v4_blocks(s: int) -> int:
    """128-column blocks of planes of capacity ``s`` (at least one)."""
    return max(1, -(-s // ATTN_BS))


@functools.lru_cache(maxsize=None)
def _v4_plan(m: int, s: int, hd: int, group: int) -> Tuple[int, int, int]:
    """``(km, w, passes)`` of kernel v4 for rows of ``m`` query rows over
    planes of capacity ``s``: CTAs of ``km`` query rows (all of a decode
    row's, at most 8) and ``km x w`` warps, one a (query row, block) pair,
    so a pass takes ``w`` 128-column blocks and a row of ``s`` positions
    makes ``passes`` of them (balanced: ``w`` is the fewest blocks a pass
    that keeps that count, and fewer where shared memory falls short).
    Chosen from the planes' capacity, never from ``kv_len`` (on the device:
    reading it would sync)."""
    km = max(1, min(m, V4_KM_MAX))
    nblk = _v4_blocks(s)
    w = -(-nblk // -(-nblk // (V4_WARPS_MAX // km)))
    while _v4_smem_bytes(km, w, hd, group) > V4_SMEM_MAX:
        if w == 1:
            raise ValueError(f"pvq_attn_q: head dim {hd} (group {group}) leaves no plan within "
                             f"{V4_SMEM_MAX} bytes of shared memory")
        w -= 1
    return km, w, -(-nblk // w)


def _check_v4_plan(plan, s: int, hd: int, group: int) -> Tuple[int, int, int]:
    """A forced plan (the checks that run every plan on the card): what the
    kernel takes, with ``passes`` the count its ``w`` gives at ``s``."""
    km, w, passes = plan
    nblk = _v4_blocks(s)
    if not (1 <= km <= V4_KM_MAX and w >= 1 and km * w <= V4_WARPS_MAX
            and passes == -(-nblk // w) and _v4_smem_bytes(km, w, hd, group) <= V4_SMEM_MAX):
        raise ValueError(f"pvq_attn_q: plan {tuple(plan)} does not fit S {s}, head dim {hd}, "
                         f"group {group}")
    return km, w, passes


def _pick_v4_plan(plan, m: int, s: int, hd: int, group: int,
                  tuned: bool = False) -> Tuple[int, int, int]:
    """:func:`_v4_plan`'s plan, or ``plan`` where a caller names one (see
    :func:`pvq_attn_q_cuda`)."""
    if plan is None:
        return _v4_plan(m, s, hd, group)
    try:
        return _check_v4_plan(plan, s, hd, group)
    except ValueError:
        if tuned:
            return _v4_plan(m, s, hd, group)
        raise


def pvq_attn_q_cuda(
    q_i8, act_scale, k_pulses, k_scales, v_pulses, v_scales, kv_len, *,
    group: int, sm_scale: float, _plan: Optional[Tuple[int, int, int]] = None,
    _tuned: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel v4.  It reads a packed cache's ``(b, S, n_kv, X)`` planes in
    place (never copied into per-row order), with the plan of
    :func:`_v4_plan`, or ``_plan`` where a caller names one: a check that
    forces it (refused where the kernel does not take it) or, with
    ``_tuned``, the autotuner's choice (the rule's where it does not fit)."""
    bh, m, hd, s, ng, n_kv = _check_attn(
        q_i8, act_scale, k_pulses, k_scales, v_pulses, v_scales, kv_len, group
    )
    km, w, _ = _pick_v4_plan(_plan, m, s, hd, group, _tuned)
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
        km, w, acc.data_ptr(), m_run.data_ptr(), l_run.data_ptr(), _stream(q_i8),
    )
    build.check(status, "pvq_attn_q")
    LAUNCHES["pvq_attn_q"] += 1
    return acc, m_run, l_run
