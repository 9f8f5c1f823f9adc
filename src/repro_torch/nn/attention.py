"""Attention: GQA with RoPE, causal prefill, and KV-cache decode over a dense
or a PVQ-packed cache (port of the dense/``PackedKV`` parts of
``repro.nn.attention``).  Float matmuls here run in full f32 (TF32 is off
for the package)."""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ..core.packed import PackedKV, is_packed_kv
from .layers import Params, dense, init_dense

NEG_INF = -1e30


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, device=device).to(torch.float32) / head_dim
    return 1.0 / torch.pow(torch.full_like(exps, float(theta)), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_attention(gen, d_model, n_heads, n_kv_heads, head_dim, *, dtype, device) -> Params:
    return {
        "wq": init_dense(gen, d_model, n_heads * head_dim, dtype=dtype, device=device),
        "wk": init_dense(gen, d_model, n_kv_heads * head_dim, dtype=dtype, device=device),
        "wv": init_dense(gen, d_model, n_kv_heads * head_dim, dtype=dtype, device=device),
        "wo": init_dense(gen, n_heads * head_dim, d_model, dtype=dtype, device=device),
    }


def KVCache(k: torch.Tensor, v: torch.Tensor) -> dict:
    return {"k": k, "v": v}


def init_kv_cache(batch, max_len, n_kv, head_dim, dtype=None, *, quantized=None, device="cuda"):
    """Zero decode cache: a dense ``KVCache`` dict or a ``PackedKV``.
    ``quantized=None`` defers to the process ``KVQuant`` default."""
    from ..core.quantize import KVQuant, default_kv_quant

    dtype = torch.bfloat16 if dtype is None else dtype
    if quantized is None:
        quantized = default_kv_quant()
    if quantized is True:
        quantized = KVQuant()
    if quantized:
        return PackedKV.init(batch, max_len, n_kv, head_dim, kvq=quantized, dtype=dtype, device=device)
    shape = (batch, max_len, n_kv, head_dim)
    z = torch.zeros(shape, dtype=dtype, device=device)
    return KVCache(k=z, v=z.clone())


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def full_causal_attention(q, k, v, *, scale: float, q_offset: int = 0) -> torch.Tensor:
    """q: (b, s, h, hd); k/v: (b, s, n_kv, hd); grouped (no KV expansion).
    Scores in f32; probabilities cast to v's dtype, as the reference does."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    qg = _group_q(q, n_kv).to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(torch.float32), v.to(torch.float32))
    return out.to(v.dtype).reshape(b, sq, h, v.shape[-1])


def chunked_causal_attention(q, k, v, *, scale: float, q_chunk: int = 512) -> torch.Tensor:
    """Causal attention one query chunk at a time (exact; peak memory
    O(q_chunk * seq)).  Short sequences take one chunk."""
    b, s, h, hd = q.shape
    if s % q_chunk != 0:
        q_chunk = next((c for c in range(q_chunk - q_chunk % 128, 127, -128) if s % c == 0), 0)
    if not q_chunk or s <= q_chunk:
        return full_causal_attention(q, k, v, scale=scale)
    outs = []
    for i in range(s // q_chunk):
        lo = i * q_chunk
        outs.append(
            full_causal_attention(q[:, lo : lo + q_chunk], k, v, scale=scale, q_offset=lo)
        )
    return torch.cat(outs, dim=1)


def decode_attention(q, cache_k, cache_v, *, scale: float, length: Optional[torch.Tensor] = None):
    """One-token attention against a dense cache of S entries."""
    b, sq, h, hd = q.shape
    n_kv = cache_k.shape[2]
    qg = _group_q(q, n_kv).to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bqhgk", qg, cache_k.to(torch.float32)) * scale
    if length is not None:
        valid = torch.arange(cache_k.shape[1], device=q.device)[None, :] < length[:, None]
        scores = torch.where(valid[:, None, None, None, :], scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(cache_v.dtype)
    out = torch.einsum("bqhgk,bkhd->bqhgd", probs.to(torch.float32), cache_v.to(torch.float32))
    return out.to(cache_v.dtype).reshape(b, sq, h, cache_v.shape[-1])


def decode_attention_packed(
    q: torch.Tensor, kv: PackedKV, *, scale: float, length: torch.Tensor,
    filled: Optional[int] = None, exact: bool = False,
) -> torch.Tensor:
    """Decode attention over a PVQ-packed cache: the packed leg (kernel v4,
    positions below ``packed_end(filled)``) and the exact f32 tail leg,
    merged by logsumexp.  ``exact=True`` dequantizes the whole cache and
    runs the dense path (the oracle)."""
    from ..kernels import ops

    if filled is None:
        filled = int(length.max())
    if exact:
        kd, vd = kv.dense_kv(filled, dtype=torch.float32)
        return decode_attention(q, kd, vd, scale=scale, length=length)

    b, sq, h, hd = q.shape
    n_kv = kv.tail_k.shape[-2]
    blk = kv.block
    pe = kv.packed_end(filled)
    kv_len = torch.clamp(length, max=pe)
    acc_p, m_p, l_p = ops.pvq_attn_decode(q, kv, kv_len, sm_scale=scale)

    qg = _group_q(q, n_kv).to(torch.float32)
    tk = kv.tail_k.to(torch.float32)
    tv = kv.tail_v.to(torch.float32)
    s_t = torch.einsum("bqhgd,bthd->bqhgt", qg, tk) * scale
    valid = (torch.arange(blk, device=q.device)[None, :] < (length - pe)[:, None])[:, None, None, None, :]
    s_t = torch.where(valid, s_t, torch.full_like(s_t, NEG_INF))
    m_t = s_t.amax(dim=-1, keepdim=True)
    m_tot = torch.maximum(m_p, m_t)
    p_t = torch.where(valid, torch.exp(s_t - m_tot), torch.zeros_like(s_t))
    l_t = p_t.sum(dim=-1, keepdim=True)
    acc_t = torch.einsum("bqhgt,bthd->bqhgd", p_t, tv)
    alpha = torch.exp(m_p - m_tot)
    out = (acc_p * alpha + acc_t) / (l_p * alpha + l_t)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim):
    b, s, _ = x.shape
    q = dense(p["wq"], x).reshape(b, s, n_heads, head_dim)
    k = dense(p["wk"], x).reshape(b, s, n_kv_heads, head_dim)
    v = dense(p["wv"], x).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def attention_forward(
    p: Params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
    rope_theta: Optional[float] = 10000.0, q_chunk: int = 512, return_kv: bool = False,
):
    """Prefill self-attention over the full sequence.  ``return_kv`` also
    returns the (rope'd) k and v, which are exactly what
    :func:`attention_prefill_cache` would project again."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if rope_theta is not None:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = chunked_causal_attention(q, k, v, scale=1.0 / math.sqrt(head_dim), q_chunk=q_chunk)
    y = dense(p["wo"], out.reshape(b, s, n_heads * head_dim))
    return (y, k, v) if return_kv else y


def kv_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, quantized=None):
    """Prompt-time cache from the prefill's k/v: a ``PackedKV`` (full
    blocks encoded now, the remainder in the tail) when a KVQuant is in
    effect, else a dense ``KVCache``."""
    from ..core.quantize import KVQuant, default_kv_quant

    if quantized is None:
        quantized = default_kv_quant()
    if quantized is True:
        quantized = KVQuant()
    if quantized:
        return PackedKV.from_dense(k, v, kvq=quantized)
    return KVCache(k=k, v=v)


def attention_prefill_cache(
    p: Params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
    rope_theta: Optional[float] = 10000.0, quantized=None,
):
    b, s, _ = x.shape
    _, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if rope_theta is not None:
        k = apply_rope(k, torch.arange(s, device=x.device)[None, :], rope_theta)
    return kv_cache_from_prefill(k, v, quantized)


def attention_decode(
    p: Params, x: torch.Tensor, cache, pos: int, *, n_heads: int, n_kv_heads: int,
    head_dim: int, rope_theta: Optional[float] = 10000.0,
) -> Tuple[torch.Tensor, Any]:
    """Single-token decode with a cache append at host position ``pos``
    (lockstep batch; the cache is updated in place)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    if rope_theta is not None:
        q = apply_rope(q, posb, rope_theta)
        k = apply_rope(k, posb, rope_theta)
    scale = 1.0 / math.sqrt(head_dim)
    length = posb[:, 0] + 1
    if is_packed_kv(cache):
        cache.append(k, v, pos)
        out = decode_attention_packed(q, cache, scale=scale, length=length, filled=pos + 1)
    else:
        cache["k"][:, pos : pos + 1] = k.to(cache["k"].dtype)
        cache["v"][:, pos : pos + 1] = v.to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], scale=scale, length=length)
    y = dense(p["wo"], out.reshape(b, 1, n_heads * head_dim))
    return y, cache
