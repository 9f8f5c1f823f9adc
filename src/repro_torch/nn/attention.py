"""Attention: GQA with RoPE (or none), causal, prefix-LM and bidirectional
prefill, KV-cache decode over a dense, a PVQ-packed or a paged PVQ cache,
the engine's chunked prefill, and enc-dec cross-attention (port of
``repro.nn.attention``).  Float matmuls here run in full f32 (TF32 is off
for the package)."""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ..core.packed import PackedKV, PagedKV, is_packed_kv, is_paged_kv
from ..parallel.sharding import merge_last, split_last
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


def init_attention(gen, d_model, n_heads, n_kv_heads, head_dim, *, bias: bool = False, dtype,
                   device) -> Params:
    kw = dict(bias=bias, dtype=dtype, device=device)
    return {
        "wq": init_dense(gen, d_model, n_heads * head_dim, **kw),
        "wk": init_dense(gen, d_model, n_kv_heads * head_dim, **kw),
        "wv": init_dense(gen, d_model, n_kv_heads * head_dim, **kw),
        "wo": init_dense(gen, n_heads * head_dim, d_model, **kw),
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


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, n_kv, hd) -> (b, s, n_heads, hd) by repeating each kv head."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _prefer_grouped(h: int, n_kv: int) -> bool:
    """Grouped-q einsums avoid n_heads/n_kv x KV traffic, BUT splitting the
    head axis (h -> n_kv x g) makes an h-divisible model sharding
    inexpressible, forcing a reshard of the full q tensor.  Prefer the
    expanded-KV path exactly when h shards cleanly and n_kv does not."""
    from ..parallel.sharding import active_mesh, mesh_shape

    mesh = active_mesh()
    if mesh is None:
        return True
    tp = mesh_shape(mesh).get("model", 1)
    if h % tp == 0 and n_kv % tp != 0:
        return False
    return True


def full_causal_attention(q, k, v, *, scale: float, q_offset: int = 0, prefix_len: int = 0,
                          causal: bool = True) -> torch.Tensor:
    """q: (b, s, h, hd); k/v: (b, s, n_kv, hd); grouped (no KV expansion).
    Scores in f32; probabilities cast to v's dtype, as the reference does.
    ``prefix_len > 0`` gives the prefix-LM mask (every query sees the first
    ``prefix_len`` keys, causal after: the VLM's patches); ``causal=False``
    masks nothing (the encoder)."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    if causal and not _prefer_grouped(h, n_kv):
        k, v = _expand_kv(k, h), _expand_kv(v, h)
        n_kv = h
    qg = _group_q(q, n_kv).to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if prefix_len:
            mask = mask | (kpos[None, :] < prefix_len)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(torch.float32), v.to(torch.float32))
    return out.to(v.dtype).reshape(b, sq, h, v.shape[-1])


def chunked_causal_attention(q, k, v, *, scale: float, q_chunk: int = 512,
                             prefix_len: int = 0) -> torch.Tensor:
    """Causal (or prefix-LM) attention one query chunk at a time (exact;
    peak memory O(q_chunk * seq)).  Short sequences take one chunk."""
    b, s, h, hd = q.shape
    if s % q_chunk != 0:
        q_chunk = next((c for c in range(q_chunk - q_chunk % 128, 127, -128) if s % c == 0), 0)
    if not q_chunk or s <= q_chunk:
        return full_causal_attention(q, k, v, scale=scale, prefix_len=prefix_len)
    if not _prefer_grouped(h, k.shape[2]):
        k, v = _expand_kv(k, h), _expand_kv(v, h)
    outs = []
    for i in range(s // q_chunk):
        lo = i * q_chunk
        outs.append(
            full_causal_attention(q[:, lo : lo + q_chunk], k, v, scale=scale, q_offset=lo,
                                  prefix_len=prefix_len)
        )
    return torch.cat(outs, dim=1)


def decode_attention(q, cache_k, cache_v, *, scale: float, length: Optional[torch.Tensor] = None):
    """One-token attention against a dense cache of S entries.

    When the cache sequence axis is sharded (cp over data / cache_seq_tp
    over model), q and the scores are explicitly constrained so the S-axis
    sharding wins over head-sharded queries (otherwise the propagation
    gathers the whole cache every token); the softmax's max and sum over
    the sharded S axis then reduce across its shards."""
    from ..parallel.sharding import constrain, current_policy

    b, sq, h, hd = q.shape
    n_kv = cache_k.shape[2]
    qg = _group_q(q, n_kv).to(torch.float32)
    seq_sharded = current_policy().cache_seq_tp or current_policy().context_parallel
    if seq_sharded:
        qg = constrain(qg, "dp", None, None, None, None)  # replicate q over model
    scores = torch.einsum("bqhgd,bkhd->bqhgk", qg, cache_k.to(torch.float32)) * scale
    if seq_sharded:
        scores = constrain(scores, "dp", None, None, None, "seq")
    if length is not None:
        valid = torch.arange(cache_k.shape[1], device=q.device)[None, :] < length[:, None]
        scores = torch.where(valid[:, None, None, None, :], scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(cache_v.dtype)
    out = torch.einsum("bqhgk,bkhd->bqhgd", probs.to(torch.float32), cache_v.to(torch.float32))
    if seq_sharded:
        out = constrain(out, "dp", None, None, None, None)
    return out.to(cache_v.dtype).reshape(b, sq, h, cache_v.shape[-1])


def decode_attention_packed(
    q: torch.Tensor, kv, *, scale: float, length: torch.Tensor,
    filled=None, exact: bool = False,
) -> torch.Tensor:
    """Decode attention over a PVQ-packed cache (``PackedKV``, or the
    engine's ``PagedKV``, gathered at the kernel's dispatch): the packed
    leg (kernel v4, positions below ``packed_end(filled)``) and the exact
    f32 tail leg, merged by logsumexp.  ``filled`` is the physical fill: a
    host int on the eager lockstep path, a per-row ``(b,)`` tensor on the
    captured step and the engine's.  ``exact=True`` dequantizes the whole cache and runs the
    dense path (the oracle)."""
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
    if isinstance(pe, torch.Tensor):
        kv_len = torch.minimum(length, pe)
    else:
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
    q = split_last(dense(p["wq"], x), n_heads, head_dim)
    k = split_last(dense(p["wk"], x), n_kv_heads, head_dim)
    v = split_last(dense(p["wv"], x), n_kv_heads, head_dim)
    return q, k, v


def attention_forward(
    p: Params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
    rope_theta: Optional[float] = 10000.0, causal: bool = True, q_chunk: int = 512,
    prefix_len: int = 0, return_kv: bool = False, head_constraint=None,
):
    """Self-attention over the full sequence: causal (with the prefix-LM
    mask over the first ``prefix_len`` keys when it is set) or, with
    ``causal=False``, bidirectional (the encoder).  ``return_kv`` also
    returns the (rope'd) k and v, which are exactly what
    :func:`attention_prefill_cache` would project again.
    ``head_constraint`` lays out q, k and v (heads on the model axis)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if rope_theta is not None:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if head_constraint is not None:
        q, k, v = head_constraint(q), head_constraint(k), head_constraint(v)
    scale = 1.0 / math.sqrt(head_dim)
    if causal:
        out = chunked_causal_attention(q, k, v, scale=scale, q_chunk=q_chunk,
                                       prefix_len=prefix_len)
    else:
        out = full_causal_attention(q, k, v, scale=scale, causal=False)
    y = dense(p["wo"], merge_last(out, n_heads * head_dim))
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
    p: Params, x: torch.Tensor, cache, pos, *, n_heads: int, n_kv_heads: int,
    head_dim: int, rope_theta: Optional[float] = 10000.0, fill: Optional[bool] = None,
) -> Tuple[torch.Tensor, Any]:
    """Single-token decode with a cache append at ``pos`` (the cache is
    updated in place).  ``pos`` is a host int (the eager lockstep step) or
    a ``(b,)`` device tensor of per-row positions (the captured step, and
    the engine's ``PagedKV`` slot pool): RoPE, the append and the length
    mask are then per row and read no position on the host; ``fill`` is
    the host's block-fill choice for a packed cache (``PackedKV.append``,
    ``PagedKV.append``)."""
    if isinstance(pos, torch.Tensor):
        return _attention_decode_at(p, x, cache, pos, n_heads=n_heads, n_kv_heads=n_kv_heads,
                                    head_dim=head_dim, rope_theta=rope_theta, fill=fill)
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
        write_row(cache["k"], k, pos)
        write_row(cache["v"], v, pos)
        out = decode_attention(q, cache["k"], cache["v"], scale=scale, length=length)
    y = dense(p["wo"], merge_last(out, n_heads * head_dim))
    return y, cache


def write_row(t: torch.Tensor, rows: torch.Tensor, pos: int) -> None:
    """``t[:, pos] = rows[:, 0]`` for a ``(b, S, ...)`` cache tensor, in place,
    at a host position.  On a DTensor cache each rank writes its own shard:
    ``rows`` is laid out like ``t`` with the sequence dim whole, and the
    rank whose sequence shard holds ``pos`` writes the row there (DTensor
    has no in-place strategy for a slice of a sharded dim)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        t[:, pos : pos + 1] = rows.to(t.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = t.device_mesh
    seq_sharded = [isinstance(p, Shard) and p.dim == 1 for p in t.placements]
    like = [Replicate() if s else p for p, s in zip(t.placements, seq_sharded)]
    if isinstance(rows, DTensor):
        local_rows = rows.redistribute(mesh, like).to_local()
    else:
        local_rows = distribute_tensor(rows, mesh, like, src_data_rank=None).to_local()
    lo, n = 0, t.shape[1]
    coord = mesh.get_coordinate()
    for m, s in enumerate(seq_sharded):
        if s:  # DTensor splits a dim over its mesh dims in order, major first
            n //= mesh.size(m)
            lo += coord[m] * n
    if lo <= pos < lo + n:
        t.to_local()[:, pos - lo : pos - lo + 1] = local_rows.to(t.dtype)


def put_rows(t: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor) -> None:
    """``t[i, pos[i]] = rows[i, 0]`` for every row ``i`` of a ``(b, S, ...)``
    cache tensor, in place: one ``index_copy_`` on its flattened rows at
    device positions ``pos (b,)``."""
    b, s = t.shape[:2]
    idx = torch.arange(b, device=t.device) * s + pos.to(torch.int64)
    t.view(b * s, *t.shape[2:]).index_copy_(0, idx, rows[:, 0].to(t.dtype))


def _attention_decode_at(p, x, cache, pos, *, n_heads, n_kv_heads, head_dim, rope_theta, fill):
    """:func:`attention_decode` at device positions ``pos (b,)``, over any
    cache: a per-row append (``index_copy_``), then kernel v4 over a packed
    or paged cache, whose ``filled`` is the device tensor ``pos + 1``, or
    the dense f32 attention over a dense one.  At equal positions it gives
    the host-int form's logits bit for bit."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    posb = pos.to(torch.int64).reshape(b, 1)
    if rope_theta is not None:
        q = apply_rope(q, posb, rope_theta)
        k = apply_rope(k, posb, rope_theta)
    scale = 1.0 / math.sqrt(head_dim)
    length = posb[:, 0] + 1
    if is_paged_kv(cache) or is_packed_kv(cache):
        cache.append(k, v, posb[:, 0], fill=fill)
        out = decode_attention_packed(q, cache, scale=scale, length=length, filled=length)
    else:
        put_rows(cache["k"], k, posb[:, 0])
        put_rows(cache["v"], v, posb[:, 0])
        out = decode_attention(q, cache["k"], cache["v"], scale=scale, length=length)
    y = dense(p["wo"], merge_last(out, n_heads * head_dim))
    return y, cache


def attention_prefill_chunk(
    p: Params, x: torch.Tensor, cache: PagedKV, *, slot, start, page_ids,
    real_len, n_heads: int, n_kv_heads: int, head_dim: int,
    rope_theta: Optional[float] = 10000.0,
) -> Tuple[torch.Tensor, PagedKV]:
    """Chunked prefill of ``x (1, C, d)``, one slot's ``C`` (a page
    multiple) tokens at absolute positions ``start .. start + C - 1``
    (``start`` page-aligned), over the paged pool (updated in place):

    1. project and rope the chunk;
    2. graft its complete blocks into the allocator's pages ``page_ids``
       (:meth:`PagedKV.graft_chunk`);
    3. attend with two legs merged by online softmax:

       * packed: the slot's prior context ``[0, start)`` through its page
         table, kernel v4 with ``C x gpr`` query rows on the slot's gather
         and ``kv_len = start`` (0 on the first chunk: the kernel returns
         the empty row, ``m = ATTN_NEG_INF`` and ``l = 0``, and the merge
         weight ``alpha`` is 0);
       * chunk: exact causal f32 attention within the chunk (rows past
         ``real_len`` compute garbage that stays behind the engine's masks).

    ``slot``, ``start``, ``page_ids`` and ``real_len`` are host integers
    (the eager engine) or device tensors (the captured chunk: the RoPE
    positions and ``kv_len`` are built from the device ``start``, and the
    graft and the gather take the device indices; see
    :meth:`PagedKV.graft_chunk`).  Both give the same output and bytes.

    Returns ``(y (1, C, d), cache)``.
    """
    from ..kernels import ops

    b, c, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if isinstance(start, torch.Tensor):
        start_t = start.reshape(1).to(torch.int64)
    else:
        start_t = torch.full((1,), int(start), dtype=torch.int64, device=x.device)
    if rope_theta is not None:
        positions = (start_t + torch.arange(c, device=x.device))[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    scale = 1.0 / math.sqrt(head_dim)

    cache.graft_chunk(k, v, slot, page_ids, start, real_len)

    kv_len = start_t.to(torch.int32)
    acc_p, m_p, l_p = ops.pvq_attn_decode(q, cache.gather_slot(slot), kv_len, sm_scale=scale)

    # every query row sees at least its own diagonal, so the merged
    # denominator is never zero
    qg = _group_q(q, n_kv_heads).to(torch.float32)
    s_c = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.to(torch.float32)) * scale
    idx = torch.arange(c, device=x.device)
    mask = (idx[None, :] <= idx[:, None])[None, :, None, None, :]
    s_c = torch.where(mask, s_c, torch.full_like(s_c, NEG_INF))
    m_c = s_c.amax(dim=-1, keepdim=True)
    m_tot = torch.maximum(m_p, m_c)
    p_c = torch.where(mask, torch.exp(s_c - m_tot), torch.zeros_like(s_c))
    l_c = p_c.sum(dim=-1, keepdim=True)
    acc_c = torch.einsum("bqhgk,bkhd->bqhgd", p_c, v.to(torch.float32))
    alpha = torch.exp(m_p - m_tot)
    out = (acc_p * alpha + acc_c) / (l_p * alpha + l_c)
    out = out.reshape(b, c, n_heads, head_dim).to(q.dtype)
    y = dense(p["wo"], out.reshape(b, c, n_heads * head_dim))
    return y, cache


def cross_attention_forward(p: Params, x: torch.Tensor, enc_kv: dict, *, n_heads: int,
                            head_dim: int) -> torch.Tensor:
    """Decoder states ``x (b, s, d)`` attending to the encoder's keys and
    values ``enc_kv`` (:func:`cross_kv`: ``(b, s_enc, n_heads, hd)``, every
    position, no mask).  Scores in f32, probabilities in v's dtype."""
    b, s, _ = x.shape
    q = split_last(dense(p["wq"], x), n_heads, head_dim)
    scale = 1.0 / math.sqrt(head_dim)
    kf, vf = enc_kv["k"], enc_kv["v"]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf.to(torch.float32)) * scale
    probs = torch.softmax(scores, dim=-1).to(vf.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32), vf.to(torch.float32))
    out = out.to(vf.dtype)
    return dense(p["wo"], merge_last(out, n_heads * head_dim))


def cross_kv(p: Params, enc_out: torch.Tensor, *, n_heads: int, head_dim: int) -> dict:
    """The cross-attention cache: the encoder output's keys and values,
    written once at prefill and read in full every step (always dense)."""
    b, s, _ = enc_out.shape
    k = split_last(dense(p["wk"], enc_out), n_heads, head_dim)
    v = split_last(dense(p["wv"], enc_out), n_heads, head_dim)
    return KVCache(k=k, v=v)
