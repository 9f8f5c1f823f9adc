"""Layers shared by the reference models: RMSNorm, RoPE (the half-split
form the port uses), SwiGLU and the dtype a configuration states."""

from __future__ import annotations

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["serving"]["param_dtype"])


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(torch.float32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """``x (..., seq, heads, dim)``, ``positions (..., seq)``: the first half
    of each head rotated against the second."""
    dim = x.shape[-1]
    freqs = 1.0 / torch.pow(torch.full((dim // 2,), float(theta), device=x.device),
                            torch.arange(0, dim, 2, device=x.device).float() / dim)
    ang = positions[..., None].float() * freqs
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., : dim // 2], x[..., dim // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu_gate(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(g) * u
