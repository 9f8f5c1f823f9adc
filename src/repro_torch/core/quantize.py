"""Activation / KV-cache quantization contracts, the PVQ policy and the
dequantized simulation (PyTorch port of ``repro.core.quantize``).

``ActQuant`` says how activations are quantized to symmetric int8 before the
int8 x int8 matmul kernel; ``KVQuant`` says how the decode KV cache is
PVQ-packed; ``QuantPolicy`` maps parameter paths to ``(n_over_k, group)``.
The process defaults (``set_default_act_quant`` / ``set_default_kv_quant``)
are what ``launch/serve.py --act-int8 / --kv-pvq`` set once.
``quantize_tree`` encodes every matching leaf and expands it back to dense
(``serve --pvq-sim``); ``total_bits`` prices its codes.
``act_matmul_error_bound`` bounds the gap that int8 activations open
against f32 ones on a packed matmul.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import codes as codes_lib
from .pvq import PVQCode, pvq_decode_grouped, pvq_encode, pvq_encode_grouped

ACT_QUANT_MODES = ("per_row", "per_tile", "per_tensor")

#: ``ActQuant(granularity=...)`` convenience spellings -> canonical mode
ACT_QUANT_GRANULARITIES = {
    "row": "per_row",
    "tile": "per_tile",
    "tensor": "per_tensor",
}

#: int8 symmetric range; the activation scale maps max|x| onto this bound
ACT_QMAX = 127


@dataclasses.dataclass(frozen=True)
class ActQuant:
    """Symmetric int8 activation quantization contract.

    mode: ``per_row`` (one scale per row, the serving default), ``per_tile``
    (one scale per row x weight-group tile) or ``per_tensor``.
    ``granularity`` (``row``/``tile``/``tensor``) overrides ``mode``.
    """

    mode: str = "per_row"
    granularity: Optional[str] = None

    def __post_init__(self) -> None:
        if self.granularity is not None:
            if self.granularity not in ACT_QUANT_GRANULARITIES:
                raise ValueError(
                    f"ActQuant granularity {self.granularity!r} not in "
                    f"{tuple(ACT_QUANT_GRANULARITIES)}"
                )
            object.__setattr__(self, "mode", ACT_QUANT_GRANULARITIES[self.granularity])
        if self.mode not in ACT_QUANT_MODES:
            raise ValueError(f"ActQuant mode {self.mode!r} not in {ACT_QUANT_MODES}")


_DEFAULT_ACT_QUANT: Optional[ActQuant] = None


def set_default_act_quant(aq: Optional[ActQuant]) -> Optional[ActQuant]:
    """Set the process-wide default ActQuant; returns the previous value."""
    global _DEFAULT_ACT_QUANT
    prev = _DEFAULT_ACT_QUANT
    _DEFAULT_ACT_QUANT = aq
    return prev


def default_act_quant() -> Optional[ActQuant]:
    return _DEFAULT_ACT_QUANT


@contextlib.contextmanager
def act_quant_scope(aq: Optional[ActQuant]):
    """Scoped override of the process default (A/B comparisons, tests)."""
    prev = set_default_act_quant(aq)
    try:
        yield aq
    finally:
        set_default_act_quant(prev)


def _round_clip(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    # torch.round is round-half-to-even, like jnp.round
    return torch.clamp(torch.round(x * inv), -ACT_QMAX, ACT_QMAX).to(torch.int8)


def _inverse(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(
        scale > 0, 1.0 / torch.clamp(scale, min=1e-30), torch.zeros_like(scale)
    )


def quantize_activations(
    x: torch.Tensor, aq: ActQuant = ActQuant(), *, tile: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``x (..., k)``.

    Returns ``(q int8 (..., k), scale f32)``: scale ``(..., 1)`` for
    per_row / per_tensor (``max|.| / 127``), ``(..., k // tile)`` for
    per_tile.  ``|x - q * s| <= s / 2``; all-zero rows/tiles get scale 0.
    """
    xf = x.to(torch.float32)
    if aq.mode == "per_tile":
        if tile is None:
            raise ValueError("per_tile quantization needs the tile width")
        k = xf.shape[-1]
        if k % tile:
            raise ValueError(f"tile {tile} does not divide k={k}")
        xt = xf.reshape(xf.shape[:-1] + (k // tile, tile))
        scale = xt.abs().amax(dim=-1) / ACT_QMAX
        q = _round_clip(xt, _inverse(scale)[..., None]).reshape(xf.shape)
        _probe_act_quant(q, scale)
        return q, scale
    if aq.mode == "per_row":
        amax = xf.abs().amax(dim=-1, keepdim=True)
    else:  # per_tensor
        amax = xf.abs().amax().expand(xf.shape[:-1] + (1,)).clone()
    scale = amax / ACT_QMAX
    q = _round_clip(xf, _inverse(scale))
    _probe_act_quant(q, scale)
    return q, scale


def graph_capturing() -> bool:
    """Whether a CUDA graph is being captured on the current stream (never
    where torch has no card)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _probe_act_quant(q: torch.Tensor, scale: torch.Tensor) -> None:
    """Clamp-rate / zero-scale probe (no-op unless telemetry is enabled).
    It reads its values back to the host, so it bails while a CUDA graph
    is being captured (the captured decode step): the eager prefill and
    graft feed it."""
    from repro_torch.runtime import obs

    if not obs.enabled() or graph_capturing():
        return
    obs.counter("quant.act_quant_calls").inc()
    if q.numel():
        obs.histogram("quant.act_clamp_frac").record(
            float((q.abs() == ACT_QMAX).sum()) / q.numel()
        )
    if scale.numel():
        obs.histogram("quant.act_zero_scale_frac").record(
            float((scale == 0).sum()) / scale.numel()
        )


def act_matmul_error_bound(
    act_scale: torch.Tensor,  # (m, 1) per-row | (m, k//group) per-tile f32 scales
    w_pulses: torch.Tensor,  # (k, n) int8 PVQ pulses
    w_scales: torch.Tensor,  # (k // group, n) f32 per-group rho
    group: int,
) -> torch.Tensor:
    """Exact worst-case |int8-act output - f32-act output| per logit, (m, n):

        |sum_i e_i * W_in|  <=  0.5 * sum_g a_mg * |rho_gn| * L1(pulses_gn)

    where ``a_mg`` is the activation scale covering group g of row m (the
    row's one scale, or column g of a per-tile scale matrix).  The L1 is
    taken from the pulses actually stored, so the bound holds after the
    K > 127 int8 clamp too; zero scales (all-pad rows) give a zero bound."""
    k, n = w_pulses.shape
    l1 = torch.abs(w_pulses.to(torch.float32)).reshape(k // group, group, n).sum(dim=1)
    weighted = torch.abs(w_scales.to(torch.float32)) * l1  # (k//group, n)
    a = act_scale.to(torch.float32)
    if a.shape[-1] == 1:
        return 0.5 * a * weighted.sum(dim=0)[None, :]
    if a.shape[-1] != k // group:
        raise ValueError(
            f"per-tile act_scale has {a.shape[-1]} groups, weight has {k // group}"
        )
    return 0.5 * (a @ weighted)


@dataclasses.dataclass(frozen=True)
class KVQuant:
    """PVQ compression contract for the attention KV cache: blocks of
    ``block`` tokens are encoded per (token, kv-head, sub-head group of
    ``group`` dims) as int8 pulses on P(group, k) plus one f32 rho."""

    block: int = 32
    group: int = 32
    k: int = 127

    def __post_init__(self) -> None:
        if self.block < 1:
            raise ValueError(f"KVQuant block must be >= 1, got {self.block}")
        if self.group < 1:
            raise ValueError(f"KVQuant group must be >= 1, got {self.group}")
        if not (1 <= self.k <= 127):
            raise ValueError(
                f"KVQuant k must be in [1, 127] (int8 pulse plane), got {self.k}"
            )


_DEFAULT_KV_QUANT: Optional[KVQuant] = None


def set_default_kv_quant(kvq: Optional[KVQuant]) -> Optional[KVQuant]:
    """Set the process-wide default KVQuant; returns the previous value."""
    global _DEFAULT_KV_QUANT
    prev = _DEFAULT_KV_QUANT
    _DEFAULT_KV_QUANT = kvq
    return prev


def default_kv_quant() -> Optional[KVQuant]:
    return _DEFAULT_KV_QUANT


@contextlib.contextmanager
def kv_quant_scope(kvq: Optional[KVQuant]):
    """Scoped override of the process default (A/B comparisons, tests)."""
    prev = set_default_kv_quant(kvq)
    try:
        yield kvq
    finally:
        set_default_kv_quant(prev)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which tensors to quantize and how.

    rules: (path_regex, n_over_k, group) triples, first match wins;
    scale_mode: 'paper' or 'ls'; skip_regex: tensors never quantized.
    """

    rules: Tuple[Tuple[str, float, Optional[int]], ...] = (("", 1.0, None),)
    scale_mode: str = "paper"
    skip_regex: str = r"(norm|scale|bias_only|rope|decay|a_log|dt_bias|time_|ln_)"

    def match(self, path: str) -> Optional[Tuple[float, Optional[int]]]:
        if re.search(self.skip_regex, path):
            return None
        for pat, n_over_k, group in self.rules:
            if re.search(pat, path):
                return (n_over_k, group)
        return None


def _path_str(path) -> str:
    """The ``/``-joined keys of a parameter path."""
    return "/".join(str(p) for p in path)


def k_for(n: int, n_over_k: float) -> int:
    return max(int(round(n / n_over_k)), 1)


def quantize_array(
    w: torch.Tensor, n_over_k: float, group: Optional[int], scale_mode: str = "paper"
) -> Tuple[torch.Tensor, PVQCode, Dict[str, Any]]:
    """Quantize one tensor. Returns (dequantized tensor, code, stats)."""
    flat = w.reshape(-1)
    n = flat.shape[0]
    if group is None:
        k = k_for(n, n_over_k)
        code = pvq_encode(flat, k, scale_mode)
        deq = code.dequantize().reshape(w.shape).to(w.dtype)
        eff_n = n
    else:
        k = k_for(group, n_over_k)
        code = pvq_encode_grouped(flat, group, k, scale_mode)
        deq = pvq_decode_grouped(code, n).reshape(w.shape).to(w.dtype)
        eff_n = group
    err = torch.linalg.vector_norm(deq.to(torch.float32) - w.to(torch.float32))
    ref = torch.linalg.vector_norm(w.to(torch.float32))
    stats = {
        "N": eff_n,
        "K": k,
        "n_over_k": n_over_k,
        "rel_err": float(err / torch.clamp(ref, min=1e-30)),
        "numel": int(n),
    }
    return deq, code, stats


def quantize_tree(
    params: Any, policy: QuantPolicy
) -> Tuple[Any, Dict[str, PVQCode], Dict[str, Dict[str, Any]]]:
    """PVQ-quantize every matching leaf. Returns (dequantized tree, codes,
    stats); leaves are visited in sorted key order, as the reference's
    pytree walk visits them."""
    codes: Dict[str, PVQCode] = {}
    stats: Dict[str, Dict[str, Any]] = {}

    def visit(tree, path):
        if isinstance(tree, dict):
            return {key: visit(tree[key], path + (key,)) for key in sorted(tree)}
        if not isinstance(tree, torch.Tensor) or tree.ndim == 0:
            return tree
        pstr = _path_str(path)
        m = policy.match(pstr)
        if m is None or tree.numel() < 8:
            return tree
        n_over_k, group = m
        deq, code, st = quantize_array(tree, n_over_k, group, policy.scale_mode)
        codes[pstr] = code
        stats[pstr] = st
        return deq

    return visit(params, ()), codes, stats


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def tree_compression_report(codes: Dict[str, PVQCode]) -> Dict[str, Dict[str, float]]:
    """Paper §VI/§VII: per-tensor pulse histograms + bits/weight estimates."""
    out = {}
    for path, code in codes.items():
        pulses = _host(code.pulses).ravel()
        rep = codes_lib.pulse_histogram(pulses)
        rep.update(codes_lib.compression_report(pulses))
        out[path] = rep
    return out


def total_bits(codes: Dict[str, PVQCode], scheme: str = "golomb") -> Dict[str, float]:
    """Aggregate compressed size across a model (weights only, + scales at f32)."""
    total_w_bits = 0.0
    total_scale_bits = 0.0
    numel = 0
    for code in codes.values():
        pulses = _host(code.pulses).ravel()
        numel += pulses.size
        if scheme == "golomb":
            total_w_bits += float(codes_lib.golomb_length(pulses).sum())
        elif scheme == "rle":
            _, nbits, _ = codes_lib.rle_encode(pulses)
            total_w_bits += nbits
        else:
            raise ValueError(scheme)
        total_scale_bits += 32.0 * np.prod(tuple(code.scale.shape))
    return {
        "numel": numel,
        "weight_bits": total_w_bits,
        "scale_bits": total_scale_bits,
        "bits_per_weight": (total_w_bits + total_scale_bits) / max(numel, 1),
        "vs_fp32_ratio": 32.0 * numel / max(total_w_bits + total_scale_bits, 1),
        "vs_bf16_ratio": 16.0 * numel / max(total_w_bits + total_scale_bits, 1),
    }
