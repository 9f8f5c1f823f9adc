"""Activation / KV-cache quantization contracts and the PVQ policy
(PyTorch port of the serving half of ``repro.core.quantize``).

``ActQuant`` says how activations are quantized to symmetric int8 before the
int8 x int8 matmul kernel; ``KVQuant`` says how the decode KV cache is
PVQ-packed; ``QuantPolicy`` maps parameter paths to ``(n_over_k, group)``.
The process defaults (``set_default_act_quant`` / ``set_default_kv_quant``)
are what ``launch/serve.py --act-int8 / --kv-pvq`` set once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Optional, Tuple

import torch

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


def k_for(n: int, n_over_k: float) -> int:
    return max(int(round(n / n_over_k)), 1)
