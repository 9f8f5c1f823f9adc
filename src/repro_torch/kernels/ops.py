"""Kernel dispatch layer (port of ``repro.kernels.ops``).

Every caller goes through this module.  Each call first looks its key up
in the autotuner (``kernels.autotune``: the body and splitk chunk of a
matmul, kernel v4's plan, the encoder's ``delta_max``), on both routes, as
the reference's dispatch does; a tuned entry wins, else the rule decides
(``pvq_matmul._v3_body``, ``_v2_body``, ``_v3_decode_plan``, ``_v4_plan``,
``pvq_encode.DELTA_MAX``).  Then the route is chosen by the device of the
operands, and there are exactly two:

* a CUDA tensor launches the hand-written Hopper kernel with that choice
  (where the operands do not fit a tuned body, the rule's runs: both are
  exact), or raises;
* a CPU tensor runs the kernel's plain PyTorch version.

There is no fallback between them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import autotune
from . import pvq_encode as enc
from . import pvq_matmul as mm


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no PVQ kernel route for device {t.device}")


def _quantize_x(x, act_quant, group=None):
    """Resolve the ActQuant contract: ``(x, None)`` for float activations,
    or int8 ``x`` with f32 scales (per-row ``(m,1)``, per-tile ``(m,k/G)``)."""
    if act_quant is None:
        return x, None
    from ..core.quantize import quantize_activations

    if act_quant.mode == "per_tile":
        if group is None:
            raise ValueError("per_tile activation quantization needs the weight group")
        return quantize_activations(x, act_quant, tile=group)
    return quantize_activations(x, act_quant)


# ---------------------------------------------------------------------------
# matmuls (kernels v2 / v3 and their expert-batched forms)
# ---------------------------------------------------------------------------


def pvq_matmul(
    x: torch.Tensor,
    w_pulses: torch.Tensor,
    scales: torch.Tensor,
    *,
    group: int = 128,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    act_quant=None,
) -> torch.Tensor:
    """``act(x @ (pulses * rho) + bias)``; with ``act_quant`` x is quantized
    to int8 and the int8 x int8 kernel v3 runs, else the float-activation
    kernel v2."""
    out_dtype = x.dtype
    x, act_scale = _quantize_x(x, act_quant, group=group)
    tuned = _tuned(autotune.get_tiles(x.shape[0], x.shape[-1], w_pulses.shape[-1], group=group,
                                      dtype=x.dtype, device=x.device))
    cuda = _route(x) == "cuda"
    if act_scale is not None:
        if cuda:
            return mm.pvq_matmul_q_cuda(x, w_pulses, scales, act_scale, bias, group=group,
                                        activation=activation, out_dtype=out_dtype, **tuned)
        return mm.pvq_matmul_q_plain(x, w_pulses, scales, act_scale, bias, group=group,
                                     activation=activation, out_dtype=out_dtype)
    if cuda:
        return mm.pvq_matmul_cuda(x, w_pulses, scales, bias, group=group,
                                  activation=activation, **tuned)
    return mm.pvq_matmul_plain(x, w_pulses, scales, bias, group=group, activation=activation)


def _tuned(tiles) -> dict:
    """A matmul wrapper's arguments for the autotuner's ``(body, chunk)``."""
    body, chunk = tiles
    return {"_body": body, "_chunk": chunk or None, "_tuned": True}


def packed_matmul(
    x: torch.Tensor,
    packed,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    act_quant=None,
) -> torch.Tensor:
    """``act(x @ dequant(packed) + bias)`` on a matmul-layout ``PackedPVQ``
    without dequantizing.  ``x`` (m, d_in) is zero-padded to ``k_pad``
    BEFORE quantizing, so per-tile scale groups line up with rho groups."""
    if packed.layout != "matmul":
        raise ValueError(f"packed_matmul needs layout='matmul', got {packed.layout!r}")
    if packed.pulses.ndim != 2:
        raise ValueError(
            f"packed_matmul takes one matrix; got stacked pulses {tuple(packed.pulses.shape)}"
        )
    k_pad = packed.pulses.shape[0]
    d_in = int(packed.shape[-2])
    if x.shape[-1] not in (d_in, k_pad):
        raise ValueError(
            f"x feature dim {x.shape[-1]} matches neither the packed leaf's "
            f"logical d_in {d_in} nor its padded k_pad {k_pad}"
        )
    if x.shape[-1] != k_pad:
        x = torch.nn.functional.pad(x, (0, k_pad - x.shape[-1]))
    return pvq_matmul(
        x, packed.pulses, packed.scales, group=packed.group, bias=bias,
        activation=activation, act_quant=act_quant,
    )


def packed_matmul_stacked(
    x: torch.Tensor,
    packed,
    *,
    activation: str = "none",
    act_quant=None,
    act_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched ``act(x[e] @ dequant(packed[e]))`` over an expert-stacked
    matmul-layout ``PackedPVQ`` (pulses ``(E, k_pad, n)``): the MoE
    expert-bank contraction, one launch of the batched kernel.

    ``x`` is ``(E, m, d_in | k_pad)``.  ``act_quant`` quantizes it here
    (int8, batched v3); ``act_scale`` ``(E, m, 1)`` marks ``x`` as
    already-quantized int8 (``moe_forward`` quantizes its dispatch buffer
    once for the up and gate matmuls); neither runs batched v2 on float x.
    ``x`` is zero-padded to ``k_pad`` BEFORE quantizing.
    """
    if packed.layout != "matmul":
        raise ValueError(f"packed_matmul_stacked needs layout='matmul', got {packed.layout!r}")
    if packed.pulses.ndim != 3:
        raise ValueError(
            f"packed_matmul_stacked takes one stacked expert bank; got pulses "
            f"{tuple(packed.pulses.shape)} (expected (E, k_pad, n): slice any layer axis first)"
        )
    e, k_pad, _ = packed.pulses.shape
    if x.ndim != 3 or x.shape[0] != e:
        raise ValueError(f"x must be (E={e}, m, d_in) matching the expert axis, got {tuple(x.shape)}")
    d_in = int(packed.shape[-2])
    if x.shape[-1] not in (d_in, k_pad):
        raise ValueError(
            f"x feature dim {x.shape[-1]} matches neither the packed bank's "
            f"logical d_in {d_in} nor its padded k_pad {k_pad}"
        )
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    if x.shape[-1] != k_pad:
        x = torch.nn.functional.pad(x, (0, k_pad - x.shape[-1]))
    if act_scale is not None:
        if x.dtype != torch.int8:
            raise ValueError(f"pre-quantized dispatch (act_scale given) needs int8 x, got {x.dtype}")
        act_scale = act_scale.to(torch.float32)
    else:
        x, act_scale = _quantize_x(x, act_quant, group=packed.group)
    tuned = _tuned(autotune.get_tiles(x.shape[1], k_pad, packed.pulses.shape[-1],
                                      group=packed.group, dtype=x.dtype, e=e, device=x.device))
    cuda = _route(x) == "cuda"
    if act_scale is not None:
        if cuda:
            return mm.pvq_matmul_q_batched_cuda(x, packed.pulses, packed.scales, act_scale,
                                                group=packed.group, activation=activation,
                                                out_dtype=out_dtype, **tuned)
        return mm.pvq_matmul_q_batched_plain(x, packed.pulses, packed.scales, act_scale,
                                             group=packed.group, activation=activation,
                                             out_dtype=out_dtype)
    if cuda:
        return mm.pvq_matmul_batched_cuda(x, packed.pulses, packed.scales, group=packed.group,
                                          activation=activation, **tuned)
    return mm.pvq_matmul_batched_plain(x, packed.pulses, packed.scales, group=packed.group,
                                       activation=activation)


# ---------------------------------------------------------------------------
# attention decode over a packed KV cache (kernel v4)
# ---------------------------------------------------------------------------


def pvq_attn_decode(q: torch.Tensor, kv, kv_len: torch.Tensor, *, sm_scale: float):
    """Packed flash-decode contraction of ``q (b, q_len, n_heads, hd)`` against
    a ``PackedKV``'s planes (a ``PagedKV`` is gathered through its page
    table first) for ``kv_len (b,)`` packed positions.

    The grouped-query layout is folded into the kernel's rows as
    ``(b * n_kv, q_len * gpr, hd)``; the cache is never expanded to
    ``n_heads``.  Returns UNNORMALIZED ``(acc, m, l)`` shaped
    ``(b, q_len, n_kv, gpr, hd)`` / ``(..., 1)`` / ``(..., 1)``.
    """
    from ..core.packed import is_paged_kv
    from ..core.quantize import ActQuant, quantize_activations

    if is_paged_kv(kv):
        # the slot-major view through the page table (a paged v4 would read
        # the pages through the table itself)
        kv = kv.gather()
    b, q_len, n_heads, hd = q.shape
    n_kv = kv.k_pulses.shape[2]
    if n_heads % n_kv:
        raise ValueError(f"n_heads {n_heads} not a multiple of n_kv {n_kv}")
    gpr = n_heads // n_kv
    m = q_len * gpr

    qg = q.reshape(b, q_len, n_kv, gpr, hd).permute(0, 2, 1, 3, 4).reshape(b * n_kv, m, hd)
    q_i8, a_scale = quantize_activations(qg, ActQuant(mode="per_row"))

    # the planes go in their own (b, S, n_kv, X) layout: row bh of the
    # kernel is (batch bh // n_kv, kv head bh % n_kv)
    kv_len_bh = kv_len.to(torch.int32)[:, None].expand(b, n_kv).reshape(b * n_kv)
    s = kv.k_pulses.shape[1]
    km, w = autotune.get_attn_tiles(m, hd, s, group=kv.group, dtype=torch.int8,
                                    device=q.device)
    args = (q_i8, a_scale, kv.k_pulses, kv.k_scales, kv.v_pulses, kv.v_scales, kv_len_bh)
    if _route(q) == "cuda":
        plan = (km, w, -(-mm._v4_blocks(s) // w))
        acc, m_run, l_run = mm.pvq_attn_q_cuda(*args, group=kv.group, sm_scale=sm_scale,
                                               _plan=plan, _tuned=True)
    else:
        acc, m_run, l_run = mm.pvq_attn_q_plain(*args, group=kv.group, sm_scale=sm_scale)

    def from_bh(x):  # (b*n_kv, m, X) -> (b, q_len, n_kv, gpr, X)
        return x.reshape(b, n_kv, q_len, gpr, x.shape[-1]).permute(0, 2, 1, 3, 4)

    return from_bh(acc), from_bh(m_run), from_bh(l_run)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def pvq_encode(
    w: torch.Tensor, *, k_pulses: int, delta_max: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched PVQ projection of ``w (g, n)`` onto P(n, K): returns
    ``(pulses int32 (g, n), rho_ls f32 (g,))``.  ``delta_max`` defaults to
    the autotuner's (a tuned entry, else ``pvq_encode.DELTA_MAX``); an
    explicit value wins."""
    if delta_max is None:
        delta_max = autotune.get_encode_params(w.shape[0], w.shape[-1], k_pulses,
                                               dtype=w.dtype, device=w.device)
    delta_max = int(delta_max)
    fn = enc.pvq_encode_batch_cuda if _route(w) == "cuda" else enc.pvq_encode_batch_plain
    return fn(w, k_pulses=k_pulses, delta_max=delta_max)


def pulses_to_int8(pulses: torch.Tensor) -> torch.Tensor:
    """The int32 -> int8 pulse boundary: lossless for K <= 127; for K > 127
    the clamp is lossy and callers refit rho against the stored pulses."""
    return torch.clamp(pulses, -127, 127).to(torch.int8)


def encode_weight_matrix(
    w: torch.Tensor, *, group: int = 128, k_pulses: int, delta_max: Optional[int] = None
):
    """Encode ``w (..., k, n)`` (leading stack axes allowed, each matrix
    encoded on its own) into the matmul layout: returns
    ``(pulses int8 (..., k_pad, n), scales f32 (..., k_pad // G, n), k_pad)``.
    Each (group slice, output column) is one pyramid code; the groups are
    taken column-major, as the reference does."""
    *lead, k, n = w.shape
    pad = (-k) % group
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    k_pad = k + pad
    ng = k_pad // group
    wg = w.transpose(-1, -2).reshape(-1, group)  # (... * n * ng, group)
    pulses, rho = pvq_encode(wg, k_pulses=k_pulses, delta_max=delta_max)
    pulses = pulses_to_int8(pulses).reshape(*lead, n, ng, group)
    pulses = pulses.permute(*range(len(lead)), -2, -1, -3).reshape(*lead, k_pad, n)
    scales = rho.reshape(*lead, n, ng).transpose(-1, -2).to(torch.float32)
    return pulses.contiguous(), scales.contiguous(), k_pad


def pvq_encode_grouped_fast(
    flat: torch.Tensor, group: int, k: int, delta_max: Optional[int] = None,
    scale_mode: str = "ls",
):
    """Grouped encode of a flat vector: ``(pulses int32 (G, group), rho (G,))``.
    The kernel (or its plain version) emits the ``ls`` scale; other modes
    are recomputed from the pulses.  Zero padding never receives pulses."""
    from ..core.pvq import _scales

    pad = (-flat.shape[0]) % group
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    wg = flat.reshape(-1, group)
    pulses, rho = pvq_encode(wg, k_pulses=k, delta_max=delta_max)
    if scale_mode != "ls":
        rho = _scales(wg, pulses, scale_mode)
    return pulses, rho
