"""Multi-head Latent Attention (DeepSeek-V2) with compressed-KV decode (port
of ``repro.nn.mla``).

Prefill: decompress the latent kv to per-head K/V and run causal attention.
Decode: the *absorbed* form, with W_uk folded into the query and W_uv into
the output, so the cache holds only the ``kv_lora_rank + rope_dim`` latent
per token.  The latent cache stays dense under ``--kv-pvq`` by the
reference's design: it is already a learned compression, and there are no
per-head K/V rows for ``PackedKV`` to block-encode.  The ``wk_b``/``wv_b``
b-projections are reshaped per head at decode, so the pack policy leaves
them dense (``PACK_SKIP_REGEX``); ``materialize`` still accepts a packed
leaf.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.packed import materialize
from .attention import NEG_INF, apply_rope, chunked_causal_attention, put_rows
from .layers import Params, dense, init_dense, init_rmsnorm, rmsnorm


class MLAConfig(NamedTuple):
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None  # None -> direct q projection
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128


def MLACache(c_kv: torch.Tensor, k_rope: torch.Tensor) -> dict:
    return {"c_kv": c_kv, "k_rope": k_rope}


def init_mla(gen, d_model: int, n_heads: int, cfg: MLAConfig, *, dtype, device) -> Params:
    qk_head = cfg.nope_head_dim + cfg.rope_head_dim

    def dense_p(d_in, d_out):
        return init_dense(gen, d_in, d_out, dtype=dtype, device=device)

    p: Params = {}
    if cfg.q_lora_rank:
        p["wq_a"] = dense_p(d_model, cfg.q_lora_rank)
        p["q_norm"] = init_rmsnorm(cfg.q_lora_rank, dtype, device)
        p["wq_b"] = dense_p(cfg.q_lora_rank, n_heads * qk_head)
    else:
        p["wq"] = dense_p(d_model, n_heads * qk_head)
    p["wkv_a"] = dense_p(d_model, cfg.kv_lora_rank)
    p["kv_norm"] = init_rmsnorm(cfg.kv_lora_rank, dtype, device)
    p["wk_rope"] = dense_p(d_model, cfg.rope_head_dim)
    p["wk_b"] = dense_p(cfg.kv_lora_rank, n_heads * cfg.nope_head_dim)
    p["wv_b"] = dense_p(cfg.kv_lora_rank, n_heads * cfg.v_head_dim)
    p["wo"] = dense_p(n_heads * cfg.v_head_dim, d_model)
    return p


def _queries(p: Params, x: torch.Tensor, n_heads: int, cfg: MLAConfig, positions):
    b, s, _ = x.shape
    qk_head = cfg.nope_head_dim + cfg.rope_head_dim
    if "wq_a" in p:
        q = dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x)))
    else:
        q = dense(p["wq"], x)
    q = q.reshape(b, s, n_heads, qk_head)
    q_nope, q_rope = q[..., : cfg.nope_head_dim], q[..., cfg.nope_head_dim :]
    return q_nope, apply_rope(q_rope, positions)


def _latents(p: Params, x: torch.Tensor, cfg: MLAConfig, positions):
    c_kv = rmsnorm(p["kv_norm"], dense(p["wkv_a"], x))  # (b, s, r)
    k_rope = dense(p["wk_rope"], x)  # (b, s, rope_dim), shared across heads
    k_rope = apply_rope(k_rope[:, :, None, :], positions)[:, :, 0, :]
    return c_kv, k_rope


def mla_forward(p: Params, x: torch.Tensor, *, n_heads: int, cfg: MLAConfig, q_chunk: int = 512,
                return_cache: bool = False):
    """Prefill: decompressed causal attention.  ``return_cache`` also
    returns the latent cache, exactly what :func:`mla_prefill_cache` would
    compute again."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _queries(p, x, n_heads, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)
    k_nope = dense(p["wk_b"], c_kv).reshape(b, s, n_heads, cfg.nope_head_dim)
    v = dense(p["wv_b"], c_kv).reshape(b, s, n_heads, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k_rope_h = k_rope[:, :, None, :].expand(b, s, n_heads, cfg.rope_head_dim)
    k = torch.cat([k_nope, k_rope_h.to(k_nope.dtype)], dim=-1)
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    out = chunked_causal_attention(q, k, v, scale=scale, q_chunk=q_chunk)
    y = dense(p["wo"], out.reshape(b, s, n_heads * cfg.v_head_dim))
    return (y, MLACache(c_kv=c_kv, k_rope=k_rope)) if return_cache else y


def mla_prefill_cache(p: Params, x: torch.Tensor, cfg: MLAConfig) -> dict:
    s = x.shape[1]
    c_kv, k_rope = _latents(p, x, cfg, torch.arange(s, device=x.device)[None, :])
    return MLACache(c_kv=c_kv, k_rope=k_rope)


def mla_decode(p: Params, x: torch.Tensor, cache: dict, pos, *, n_heads: int,
               cfg: MLAConfig) -> Tuple[torch.Tensor, dict]:
    """Absorbed decode at ``pos`` (the cache is updated in place): a host
    int (the eager lockstep step) or a ``(b,)`` device tensor of per-row
    positions (the captured step: the latent writes are an ``index_copy_``
    and the length mask is per row, so nothing reads a position on the
    host).  Scores contract in f32 from the cache dtype, as the reference's
    ``preferred_element_type=f32``; the other contractions stay in the
    compute dtype."""
    b = x.shape[0]
    at_device = isinstance(pos, torch.Tensor)
    if at_device:
        posb = pos.to(torch.int64).reshape(b, 1)
    else:
        posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _queries(p, x, n_heads, cfg, posb)  # (b, 1, h, *)
    c_new, kr_new = _latents(p, x, cfg, posb)
    if at_device:
        put_rows(cache["c_kv"], c_new, posb[:, 0])
        put_rows(cache["k_rope"], kr_new, posb[:, 0])
    else:
        cache["c_kv"][:, pos : pos + 1] = c_new.to(cache["c_kv"].dtype)
        cache["k_rope"][:, pos : pos + 1] = kr_new.to(cache["k_rope"].dtype)

    r = cfg.kv_lora_rank
    wk_b = materialize(p["wk_b"]["kernel"]).reshape(r, n_heads, cfg.nope_head_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b.to(q_nope.dtype))
    f32 = torch.float32
    scores_nope = torch.einsum("bhr,bsr->bhs", q_abs.to(f32), cache["c_kv"].to(q_abs.dtype).to(f32))
    scores_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(f32),
                               cache["k_rope"].to(q_rope.dtype).to(f32))
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    scores = (scores_nope + scores_rope) * scale
    valid = torch.arange(cache["c_kv"].shape[1], device=x.device)[None, :] < posb + 1
    scores = torch.where(valid[:, None, :], scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(cache["c_kv"].dtype)
    out_lat = torch.einsum("bhs,bsr->bhr", probs, cache["c_kv"])  # (b, h, r)
    wv_b = materialize(p["wv_b"]["kernel"]).reshape(r, n_heads, cfg.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", out_lat.to(x.dtype), wv_b.to(x.dtype))
    y = dense(p["wo"], out.reshape(b, 1, n_heads * cfg.v_head_dim))
    return y, cache
