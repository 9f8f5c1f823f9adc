"""Plain oracles for the kernels (port of ``repro.kernels.ref``)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.pvq import _greedy_topup, _presearch, _scales


def pvq_matmul_ref(
    x: torch.Tensor, w_pulses: torch.Tensor, scales: torch.Tensor, *, group: int
) -> torch.Tensor:
    """``y = x @ (rho-expanded * pulses)``; groups tile the contraction dim."""
    k, _ = w_pulses.shape
    assert k % group == 0
    w = w_pulses.to(torch.float32) * torch.repeat_interleave(scales.to(torch.float32), group, dim=0)
    return (x.to(torch.float32) @ w).to(x.dtype)


def pvq_encode_ref(w: torch.Tensor, k_pulses: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy projection: ``(pulses int32 (g, n), rho_ls f32 (g,))``."""
    absw = torch.abs(w.to(torch.float32))
    y = _presearch(absw, k_pulses)
    y = _greedy_topup(absw, y, k_pulses)
    pulses = (torch.sign(w.to(torch.float32)) * y).to(torch.int32)
    return pulses, _scales(w, pulses, "ls")
