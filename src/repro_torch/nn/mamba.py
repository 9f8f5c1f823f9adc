"""Mamba-1 selective SSM block, Jamba's mixer (port of ``repro.nn.mamba``).

Recurrence (per channel i, state dim n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t
with input-dependent dt, B, C.  The reference's ``lax.scan`` over time is a
Python loop over time in f32; decode carries the ``conv`` window and the
``ssm`` state.  ``a_log`` and ``d_skip`` stay f32 and raw, and so does
``conv_kernel`` (``PACK_SKIP_REGEX``): the depthwise causal conv and the
recurrence are plain PyTorch, as the reference's ``jnp`` glue.  The four
projections are dense layers, packed under ``serve --pvq`` (``dt_proj``
with its bias in the kernel's epilogue).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .layers import Params, dense, init_dense


class SSMConfig(NamedTuple):
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


def MambaCache(conv: torch.Tensor, ssm: torch.Tensor) -> dict:
    """The SSM cache as a dict (the reference's ``mamba/conv``,
    ``mamba/ssm`` paths)."""
    return {"conv": conv, "ssm": ssm}


def init_mamba(gen, d_model: int, cfg: SSMConfig, *, dtype, device) -> Params:
    """The reference's names, shapes and distributions (other numbers)."""
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or math.ceil(d_model / 16)
    f32 = torch.float32
    kw = dict(dtype=dtype, device=device)
    p: Params = {"in_proj": init_dense(gen, d_model, 2 * d_inner, **kw)}
    conv = torch.randn((cfg.d_conv, d_inner), generator=gen, dtype=f32, device=device)
    p["conv_kernel"] = (conv * 0.1).to(dtype)
    p["conv_bias"] = torch.zeros((d_inner,), **kw)
    p["x_proj"] = init_dense(gen, d_inner, dt_rank + 2 * cfg.d_state, **kw)
    p["dt_proj"] = init_dense(gen, dt_rank, d_inner, bias=True, **kw)
    # A_log and D stay f32: they parameterize the recurrence
    a = torch.arange(1, cfg.d_state + 1, dtype=f32, device=device)
    p["a_log"] = torch.log(a).expand(d_inner, cfg.d_state).contiguous()
    p["d_skip"] = torch.ones((d_inner,), dtype=f32, device=device)
    p["out_proj"] = init_dense(gen, d_inner, d_model, **kw)
    # the dt bias starts softplus(dt) around 0.01
    dt_bias = torch.log(torch.expm1(torch.tensor(0.01, dtype=f32)))
    p["dt_proj"]["bias"] = torch.full((d_inner,), float(dt_bias), dtype=f32,
                                      device=device).to(dtype)
    return p


def _split_xz(p: Params, x: torch.Tensor, d_inner: int):
    xz = dense(p["in_proj"], x)
    return xz[..., :d_inner], xz[..., d_inner:]


def _conv_causal(p: Params, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time; u: (b, s, d_inner)."""
    k = p["conv_kernel"].to(u.dtype)  # (w, d)
    w, s = k.shape[0], u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, w - 1, 0))
    out = torch.zeros_like(u)
    for i in range(w):
        out = out + pad[:, i : i + s, :] * k[i]
    return out + p["conv_bias"].to(u.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_params(p: Params, u: torch.Tensor, cfg: SSMConfig):
    """``(dt f32 (b, s, d_inner), A (d_inner, n), B f32, C f32)``."""
    dt_rank = p["dt_proj"]["kernel"].shape[0]
    proj = dense(p["x_proj"], u)
    dt, b_mat, c_mat = torch.split(proj, [dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = softplus(dense(p["dt_proj"], dt).to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))
    return dt, a, b_mat.to(torch.float32), c_mat.to(torch.float32)


def mamba_forward(p: Params, x: torch.Tensor, cfg: SSMConfig, *, return_state: bool = False):
    """Training and prefill; x: (b, s, d_model).  With ``return_state`` also
    the decode cache after the last token."""
    d_inner = p["out_proj"]["kernel"].shape[0]
    u_pre, z = _split_xz(p, x, d_inner)
    u = torch.nn.functional.silu(_conv_causal(p, u_pre))
    dt, a, b_mat, c_mat = _ssm_params(p, u, cfg)
    uf = u.to(torch.float32)
    b, s, _ = x.shape
    h = torch.zeros((b, d_inner, cfg.d_state), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)  # (b, d_inner, n)
        dbx = (dt[:, t] * uf[:, t])[..., None] * b_mat[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, c_mat[:, t]))
    y = torch.stack(ys, dim=1)  # (b, s, d_inner)
    y = y + uf * p["d_skip"].to(torch.float32)
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    out = dense(p["out_proj"], y)
    if return_state:
        w = cfg.d_conv
        window = torch.nn.functional.pad(u_pre, (0, 0, w - 1, 0))[:, -(w - 1):, :]
        return out, MambaCache(conv=window, ssm=h)
    return out


def init_mamba_cache(batch: int, d_model: int, cfg: SSMConfig, dtype, device) -> dict:
    d_inner = cfg.expand * d_model
    return MambaCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_inner, cfg.d_state), dtype=torch.float32, device=device),
    )


def mamba_decode(p: Params, x: torch.Tensor, cache: dict, cfg: SSMConfig) -> Tuple[torch.Tensor, dict]:
    """One-token step; x: (b, 1, d_model).  The new cache's tensors are new
    (the captured step copies them into its static buffers)."""
    d_inner = p["out_proj"]["kernel"].shape[0]
    u, z = _split_xz(p, x, d_inner)  # (b, 1, d_inner)
    window = torch.cat([cache["conv"].to(u.dtype), u], dim=1)  # (b, w, d_inner)
    k = p["conv_kernel"].to(u.dtype)
    u_conv = torch.einsum("bwd,wd->bd", window, k)[:, None, :] + p["conv_bias"].to(u.dtype)
    u_act = torch.nn.functional.silu(u_conv)
    dt, a, b_mat, c_mat = _ssm_params(p, u_act, cfg)
    uf = u_act.to(torch.float32)
    da = torch.exp(dt[:, 0, :, None] * a)  # (b, d_inner, n)
    dbx = dt[:, 0, :, None] * b_mat[:, 0, None, :] * uf[:, 0, :, None]
    h = da * cache["ssm"] + dbx
    y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0])[:, None, :]
    y = y + uf * p["d_skip"].to(torch.float32)
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    out = dense(p["out_proj"], y)
    return out, MambaCache(conv=window[:, 1:], ssm=h)
