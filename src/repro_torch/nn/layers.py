"""Basic layers: norms, dense, FFN, embeddings and positions (port of
``repro.nn.layers``).

Parameters are plain dicts of tensors with the reference's names, so the
quantization policy matches the same paths (``*/kernel`` packed,
``*_scale`` skipped).  A packed kernel (``PackedPVQ``) runs through
``kernels.ops.packed_matmul``; its pulses are never expanded.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..core.packed import is_packed
from ..kernels import ops
from ..kernels.pvq_matmul import int_dot

Params = Dict[str, Any]


def truncated_normal_init(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """Normal truncated to [-2, 2], scaled by ``scale / sqrt(fan_in)``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (t * (scale / fan_in**0.5)).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> Params:
    return {"rms_scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32-internal RMSNorm; the output keeps x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["rms_scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> Params:
    return {"ln_scale": torch.ones((d,), dtype=dtype, device=device),
            "ln_bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32-internal LayerNorm (population variance); the output keeps x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["ln_scale"].to(torch.float32) + p["ln_bias"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def init_dense(gen, d_in: int, d_out: int, *, bias: bool = False, dtype, device,
               scale: float = 1.0) -> Params:
    p = {"kernel": truncated_normal_init(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor, *, act_quant=None) -> torch.Tensor:
    """Dense layer on a float ``kernel`` or a packed PVQ one."""
    if is_packed(p["kernel"]):
        return pvq_dense(p, x, act_quant=act_quant)
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def pvq_quantize_dense(p: Params, *, group: int = 128, k_pulses: int) -> Params:
    """A float dense param dict as the packed serving artifact:
    ``{"kernel": PackedPVQ (matmul layout) [, "bias"]}``, the same dict shape,
    so ``dense``/``pvq_dense`` apply it as they apply the float layer.  The
    bias stays float: it rides the kernel's fused epilogue."""
    from ..core.packed import pack_matmul

    q: Params = {"kernel": pack_matmul(p["kernel"].to(torch.float32), group=group, k=k_pulses)}
    if "bias" in p:
        q["bias"] = p["bias"]
    return q


def pvq_dense(p: Params, x: torch.Tensor, *, activation: str = "none", act_quant=None) -> torch.Tensor:
    """Packed dense layer: x goes to the kernel in f32 (int8 after
    quantization when an ``ActQuant`` is in effect, by default the process
    one) and the result comes back in x's dtype."""
    from ..core.quantize import default_act_quant

    if act_quant is None:
        act_quant = default_act_quant()
    lead, k_in = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k_in).to(torch.float32)
    y = ops.packed_matmul(xf, p["kernel"], bias=p.get("bias"), activation=activation,
                          act_quant=act_quant)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def init_ffn(gen, d_model: int, d_ff: int, kind: str, *, bias: bool = False, dtype,
             device) -> Params:
    """kind: 'swiglu' | 'geglu' (gated: ``wi_gate`` and ``wi_up``) or
    'gelu' | 'relu' | 'relu2' (``wi_up`` alone); the kind is passed to
    :func:`ffn` at apply time."""
    if kind not in ("swiglu", "geglu", "gelu", "relu", "relu2"):
        raise ValueError(kind)
    p: Params = {}
    if kind in ("swiglu", "geglu"):
        p["wi_gate"] = init_dense(gen, d_model, d_ff, bias=bias, dtype=dtype, device=device)
    p["wi_up"] = init_dense(gen, d_model, d_ff, bias=bias, dtype=dtype, device=device)
    p["wo"] = init_dense(gen, d_ff, d_model, bias=bias, dtype=dtype, device=device)
    return p


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind in ("swiglu", "silu"):
        return torch.nn.functional.silu(x)
    if kind in ("geglu", "gelu"):
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu":
        return torch.relu(x)
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(kind)


def ffn(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        h = _act(kind, dense(p["wi_gate"], x)) * dense(p["wi_up"], x)
    else:
        h = _act(kind, dense(p["wi_up"], x))
    return dense(p["wo"], h)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d: int, *, dtype, device) -> Params:
    t = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return {"embedding": (t * 0.02).to(dtype)}


def _packed_embed_rows(table, tokens: torch.Tensor) -> torch.Tensor:
    """Gather + dequantize only the token rows of a flat-packed embedding
    (the group divides d, so a row is ``d // group`` whole codes)."""
    vocab, d = table.shape
    g = table.group
    pp = table.pulses.reshape(vocab, d // g, g)
    sc = table.scales.reshape(vocab, d // g)
    rows = pp[tokens].to(torch.float32) * sc[tokens][..., None]
    return rows.reshape(*tokens.shape, d)


def _packed_unembed(table, x: torch.Tensor, act_quant=None) -> torch.Tensor:
    """Tied-head logits against a packed embedding without dequantizing it:
    per group one ``x_g @ pulses_g^T`` and one rho multiply on the logits.
    With an ``ActQuant`` the x operand is per-row int8 and each group dot
    is an exact integer contraction; the row scale multiplies once at the
    end.  Plain PyTorch, as the reference's jnp (not a kernel)."""
    vocab, d = table.shape
    g = table.group
    n_groups = d // g
    act_scale = None
    if act_quant is not None:
        from ..core.quantize import quantize_activations

        xs, act_scale = quantize_activations(x, act_quant)
    else:
        xs = x.to(torch.float32)
    pp = table.pulses.reshape(vocab, n_groups, g)
    sc = table.scales.reshape(vocab, n_groups).to(torch.float32)
    logits = torch.zeros(x.shape[:-1] + (vocab,), dtype=torch.float32, device=x.device)
    for gi in range(n_groups):
        xg = xs[..., gi * g : (gi + 1) * g]
        pg = pp[:, gi].transpose(0, 1)  # (g, vocab)
        if act_scale is not None:
            dot = int_dot(xg, pg, g)
        else:
            dot = xg @ pg.to(torch.float32)
        logits = logits + dot * sc[:, gi]
    if act_scale is not None:
        logits = logits * act_scale
    return logits


def init_positional(gen, max_len: int, d: int, *, dtype, device) -> Params:
    t = torch.randn((max_len, d), generator=gen, dtype=torch.float32, device=device)
    return {"pos_embedding": (t * 0.02).to(dtype)}


def sinusoidal_positions(length: int, d: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``(length, d)``: sin of ``pos * 10000^(-2i/d)`` in the first half,
    cos in the second (the whisper encoder's fixed positions)."""
    pos = torch.arange(length, device=device).to(torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device).to(torch.float32)[None, :]
    inv = torch.exp(-math.log(10000.0) * 2.0 * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def embed(p: Params, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    table = p["embedding"]
    out = _packed_embed_rows(table, tokens) if is_packed(table) else table[tokens]
    return out.to(dtype) if dtype is not None else out


def unembed(p: Params, x: torch.Tensor, *, act_quant=None) -> torch.Tensor:
    """Tied output head: logits in f32."""
    from ..core.quantize import default_act_quant

    table = p["embedding"]
    if is_packed(table):
        if act_quant is None:
            act_quant = default_act_quant()
        return _packed_unembed(table, x, act_quant)
    return x.to(torch.float32) @ table.to(torch.float32).transpose(0, 1)
