"""PVQ-aware training: STE projection, mixed optimization, K-annealing
(paper §IV; port of ``repro.core.qat``).

The paper sketches three recipes beyond post-training quantization:
  (a) mixed optimization with w constrained to rho * P(N,K): the forward
      uses the quantized weights and the backward passes gradients straight
      through to the latent float weights (the STE the paper uses for bsign
      nets, eq. 18);
  (b) hybrid: train float -> PVQ -> continue training with (a) as refinement;
  (c) K-annealing: start from a large K and anneal down to the target.

Also the bsign activation with its STE (paper eqs. 17-18), used by the
binary PVQ nets C and D.  Both estimators are ``torch.autograd.Function``s.
"""

from __future__ import annotations

from typing import Optional

import torch

from .pvq import pvq_encode


# ---------------------------------------------------------------------------
# Straight-through PVQ projection
# ---------------------------------------------------------------------------


def _pvq_qdq(w: torch.Tensor, k: int, group: Optional[int], scale_mode: str) -> torch.Tensor:
    flat = w.reshape(-1)
    if group is None:
        # the paper's whole-tensor projection (exact greedy / LR switch)
        deq = pvq_encode(flat, k, scale_mode).dequantize()
    else:
        # grouped QAT path through the kernel layer (the encode kernel on a
        # CUDA tensor, its plain version on the CPU); imported here so that
        # core does not import kernels at import time
        from ..kernels import ops as kernel_ops

        n = flat.shape[0]
        pulses, scale = kernel_ops.pvq_encode_grouped_fast(flat, group, k, scale_mode=scale_mode)
        deq = (scale[:, None] * pulses.to(torch.float32)).reshape(-1)[:n]
    return deq.reshape(w.shape).to(w.dtype)


class _PVQSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, k, group, scale_mode):
        return _pvq_qdq(w.detach(), k, group, scale_mode)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def pvq_ste(w: torch.Tensor, k: int, group: Optional[int] = None,
            scale_mode: str = "paper") -> torch.Tensor:
    """Quantize-dequantize with identity gradient (straight-through)."""
    return _PVQSTE.apply(w, k, group, scale_mode)


# ---------------------------------------------------------------------------
# bsign with STE (paper eqs. 17-18)
# ---------------------------------------------------------------------------


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class _BSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sign(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _BSignClipped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def bsign(x: torch.Tensor) -> torch.Tensor:
    """+1 if x >= 0 else -1, with d/dx := 1 (straight-through estimator)."""
    return _BSign.apply(x)


def bsign_clipped_ste(x: torch.Tensor) -> torch.Tensor:
    """bsign with the hardtanh-window STE (gradient zero for |x| > 1), the
    refinement used by BinaryNet/QNN; beyond-paper option."""
    return _BSignClipped.apply(x)


# ---------------------------------------------------------------------------
# K-annealing schedule (paper §IV)
# ---------------------------------------------------------------------------


def k_annealing_schedule(k_start: int, k_target: int, n_steps: int):
    """Geometric anneal from k_start down to k_target over n_steps:
    returns step -> K (a python int)."""
    if k_start < k_target:
        raise ValueError("k_start must be >= k_target")
    stages = max(n_steps, 1)

    def k_at(step: int) -> int:
        t = min(max(step, 0), stages) / stages
        k = k_start * (k_target / k_start) ** t
        return max(int(round(k)), k_target)

    return k_at


def k_annealing_stages(k_start: int, k_target: int, n_stages: int):
    """Discrete stage list [(K, fraction_of_steps)], duplicates removed."""
    ks = []
    for i in range(n_stages):
        t = i / max(n_stages - 1, 1)
        k = int(round(k_start * (k_target / k_start) ** t))
        ks.append(max(k, k_target))
    seen, out = set(), []
    for k in ks:
        if k not in seen:
            seen.add(k)
            out.append(k)
    frac = 1.0 / len(out)
    return [(k, frac) for k in out]
