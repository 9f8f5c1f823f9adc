"""RWKV-6 "Finch" block: attention-free time mixing with a data-dependent
decay (port of ``repro.nn.rwkv``).

Per head (head size M): state S in R^{M x M},
    y_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
with the decay ``w_t = exp(-exp(w0 + lora_w(x~_t)))`` and the token-shift
mix coefficients produced by a small LoRA ("ddlerp").

The decay, bonus and LoRA leaves (``time_*``) parameterize the recurrence,
not a dot product: the pack policy keeps them raw (``PACK_SKIP_REGEX``),
and their matmuls are plain PyTorch, as the reference's ``jnp`` glue.  The
r/k/v/g/out projections and the channel mix are dense layers, packed under
``serve --pvq``.  The reference's ``lax.scan`` over time is a Python loop
over time in f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .layers import Params, dense, init_dense, init_layernorm, layernorm


class RWKVConfig(NamedTuple):
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


def init_rwkv_time_mix(gen, d_model: int, cfg: RWKVConfig, *, dtype, device) -> Params:
    """The reference's names, shapes and distributions (other numbers)."""
    h = d_model // cfg.head_size
    f32 = torch.float32

    def normal(shape, std):
        t = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return (t * std).to(dtype)

    dense_kw = dict(dtype=dtype, device=device)
    return {
        # ddlerp token shift: 5 targets (r, w, k, v, g)
        "time_mix_base": torch.full((5, d_model), 0.5, dtype=f32, device=device),
        "time_mix_w1": normal((d_model, 5 * cfg.mix_lora), 0.01),
        "time_mix_w2": normal((5, cfg.mix_lora, d_model), 0.01),
        # data-dependent decay LoRA
        "time_decay_base": torch.full((d_model,), -6.0, dtype=f32, device=device),
        "time_decay_w1": normal((d_model, cfg.decay_lora), 0.01),
        "time_decay_w2": normal((cfg.decay_lora, d_model), 0.01),
        "time_faaaa": torch.full((h, cfg.head_size), 0.1, dtype=f32, device=device),  # u bonus
        "wr": init_dense(gen, d_model, d_model, **dense_kw),
        "wk": init_dense(gen, d_model, d_model, **dense_kw),
        "wv": init_dense(gen, d_model, d_model, **dense_kw),
        "wg": init_dense(gen, d_model, d_model, **dense_kw),
        "out": init_dense(gen, d_model, d_model, **dense_kw),
        "ln_x": init_layernorm(d_model, dtype, device),
    }


def init_rwkv_channel_mix(gen, d_model: int, d_ff: int, *, dtype, device) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "cmix_base": torch.full((2, d_model), 0.5, dtype=torch.float32, device=device),
        "wk": init_dense(gen, d_model, d_ff, **kw),
        "wv": init_dense(gen, d_ff, d_model, **kw),
        "wr": init_dense(gen, d_model, d_model, **kw),
    }


def _shifted(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` moved one token later, ``x_prev`` (zeros when None) in front."""
    b, _, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, x_prev: torch.Tensor, cfg: RWKVConfig) -> torch.Tensor:
    """The data-dependent token-shift mix of the 5 targets: ``(5, b, s, d)``
    f32 from f32 ``x`` and ``x_prev``.  The bf16 LoRA leaves meet f32
    activations: ``dense`` casts the kernel to x's dtype, as the
    reference's, so the LoRA runs in f32 (JAX's promotion)."""
    dx = x_prev - x
    base = p["time_mix_base"].to(torch.float32)  # (5, d)
    xx = x + dx * base[0]  # the first row seeds the mix
    lora = torch.tanh(dense({"kernel": p["time_mix_w1"]}, xx))  # (b, s, 5 L)
    b, s, _ = x.shape
    lora = lora.reshape(b, s, 5, cfg.mix_lora)
    delta = torch.einsum("bsfl,fld->fbsd", lora, p["time_mix_w2"].to(lora.dtype))
    return x[None] + dx[None] * (base[:, None, None, :] + delta.to(torch.float32))


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """w_t in (0, 1): ``exp(-exp(w0 + lora(xw)))`` in f32; xw: (b, s, d)."""
    lora = dense({"kernel": p["time_decay_w2"]},
                 torch.tanh(dense({"kernel": p["time_decay_w1"]}, xw)))
    logw = p["time_decay_base"].to(torch.float32) + lora.to(torch.float32)
    return torch.exp(-torch.exp(logw))


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: RWKVConfig, *,
                  x_prev: Optional[torch.Tensor] = None, state: Optional[torch.Tensor] = None,
                  return_state: bool = False):
    """x: (b, s, d); ``x_prev`` (b, d) the last token of the previous
    segment; ``state`` (b, h, m, m) f32 (zeros when None).  Returns the
    output, and with ``return_state`` the new state (a new tensor)."""
    b, s, d = x.shape
    m = cfg.head_size
    h = d // m
    f32 = torch.float32
    mixed = _ddlerp(p, x.to(f32), _shifted(x, x_prev).to(f32), cfg)
    xr, xw, xk, xv, xg = (mixed[i].to(x.dtype) for i in range(5))

    r = dense(p["wr"], xr).reshape(b, s, h, m).to(f32)
    k = dense(p["wk"], xk).reshape(b, s, h, m).to(f32)
    v = dense(p["wv"], xv).reshape(b, s, h, m).to(f32)
    g = torch.nn.functional.silu(dense(p["wg"], xg))
    w = _decay(p, xw).reshape(b, s, h, m)  # f32 in (0, 1)
    u = p["time_faaaa"].to(f32)[None, :, :, None]  # (1, h, m, 1)

    if state is None:
        state = torch.zeros((b, h, m, m), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (b, h, m, m)
        ys.append(torch.einsum("bhm,bhmn->bhn", r[:, t], state + u * kv))
        state = w[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(x.dtype)
    y = layernorm(p["ln_x"], y)  # group-norm proxy over channels
    out = dense(p["out"], y * g)
    return (out, state) if return_state else out


def rwkv_channel_mix(p: Params, x: torch.Tensor, *,
                     x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    f32 = torch.float32
    base = p["cmix_base"].to(f32)
    dx = (_shifted(x, x_prev) - x).to(f32)
    xk = (x.to(f32) + dx * base[0]).to(x.dtype)
    xr = (x.to(f32) + dx * base[1]).to(x.dtype)
    k = torch.relu(dense(p["wk"], xk))
    k = k * k
    return torch.sigmoid(dense(p["wr"], xr)) * dense(p["wv"], k)
