"""Block assembly for every family of the reference (port of
``repro.nn.transformer``).

A model is a list of segments ``(repeats, pattern)``:

    dense / vlm    -> [(L, (attn+ffn,))]
    moe (DeepSeek) -> [(first_dense, (mla+dense0,)), (L-k, (mla+moe,))]
    hybrid (Jamba) -> [(L/p, (p-long super-block: attn at p/2, mamba else,
                       MoE on odd slots))]
    ssm (RWKV6)    -> [(L, (rwkv+cmix,))]
    encdec         -> encoder [(Le, (attn_nc+ffn,))] + decoder
                      [(Ld, (attn+cross+ffn,))]

Per-segment parameters are stacked along a leading ``repeats`` axis, as in
the reference; where the reference runs ``lax.scan`` over that axis, the
port runs a Python loop over the stacked layer params.  Decode caches are a
list with one entry per layer.  The recurrent mixers' decode entries
(``mamba``: ``conv`` and ``ssm``; ``rwkv_state``, ``rwkv_shift_att`` and
``rwkv_shift_ffn``) come back from a step as new tensors, where the
attention caches are written in place; the captured step copies them into
its static cache (``launch.serve``).

Train mode carries the MoE aux loss up the stack and a generator per layer
(:func:`fold_in`, the counterpart of ``jax.random.fold_in``): segment ``i``
of a model's generator, then layer ``r`` and block ``b`` of the segment's.
The reference's remat policy (``jax.checkpoint`` over the scan body) is a
memory policy, not a numerical one; it comes with the multi-device code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.packed import is_packed
from . import attention as attn_lib
from . import layers as L
from . import mamba as mamba_lib
from . import mla as mla_lib
from . import moe as moe_lib
from . import rwkv as rwkv_lib
from .layers import Params


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str  # 'attn' | 'mla' | 'mamba' | 'rwkv'
    ffn: str  # 'dense' | 'dense0' | 'moe' | 'cmix'
    causal: bool = True
    cross: bool = False


Segment = Tuple[int, Tuple[BlockSpec, ...]]


def segment_plan(cfg: ModelConfig, role: str = "decoder") -> List[Segment]:
    if role == "encoder":
        return [(cfg.encoder_layers, (BlockSpec("attn", "dense", causal=False),))]
    if cfg.rwkv is not None:
        return [(cfg.n_layers, (BlockSpec("rwkv", "cmix"),))]
    if cfg.hybrid_period:
        p = cfg.hybrid_period
        pat = tuple(
            BlockSpec(
                "attn" if i == p // 2 else "mamba",
                "moe" if (cfg.moe is not None and i % cfg.moe_period == cfg.moe_period - 1)
                else "dense",
            )
            for i in range(p)
        )
        if cfg.n_layers % p:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not divide into "
                             f"super-blocks of {p}")
        return [(cfg.n_layers // p, pat)]
    mixer = "mla" if cfg.mla is not None else "attn"
    if cfg.moe is not None:
        segs: List[Segment] = []
        if cfg.first_dense:
            segs.append((cfg.first_dense, (BlockSpec(mixer, "dense0"),)))
        segs.append((cfg.n_layers - cfg.first_dense, (BlockSpec(mixer, "moe"),)))
        return segs
    cross = cfg.encoder_layers > 0
    return [(cfg.n_layers, (BlockSpec(mixer, "dense", cross=cross),))]


def _init_norm(cfg: ModelConfig, dtype, device) -> Params:
    if cfg.norm == "layernorm":
        return L.init_layernorm(cfg.d_model, dtype, device)
    return L.init_rmsnorm(cfg.d_model, dtype, device)


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.layernorm(p, x) if cfg.norm == "layernorm" else L.rmsnorm(p, x)


def init_block(gen, cfg: ModelConfig, spec: BlockSpec, device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    p: Params = {"ln_mix": _init_norm(cfg, dtype, device)}
    if spec.mixer == "attn":
        p["mixer"] = attn_lib.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, bias=cfg.attn_bias,
            dtype=dtype, device=device,
        )
    elif spec.mixer == "mla":
        p["mixer"] = mla_lib.init_mla(gen, d, cfg.n_heads, cfg.mla, dtype=dtype, device=device)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_lib.init_mamba(gen, d, cfg.ssm, dtype=dtype, device=device)
    elif spec.mixer == "rwkv":
        p["mixer"] = rwkv_lib.init_rwkv_time_mix(gen, d, cfg.rwkv, dtype=dtype, device=device)
    else:
        raise ValueError(spec.mixer)
    if spec.cross:
        p["ln_cross"] = _init_norm(cfg, dtype, device)
        p["cross"] = attn_lib.init_attention(
            gen, d, cfg.n_heads, cfg.n_heads, cfg.resolved_head_dim, bias=cfg.attn_bias,
            dtype=dtype, device=device,
        )
    p["ln_ffn"] = _init_norm(cfg, dtype, device)
    if spec.ffn == "dense":
        p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, cfg.ffn_activation, bias=cfg.attn_bias,
                              dtype=dtype, device=device)
    elif spec.ffn == "dense0":
        p["ffn"] = L.init_ffn(gen, d, cfg.d_ff_dense or cfg.d_ff, cfg.ffn_activation,
                              dtype=dtype, device=device)
    elif spec.ffn == "moe":
        p["ffn"] = moe_lib.init_moe(gen, d, cfg.moe, dtype=dtype, device=device)
    elif spec.ffn == "cmix":
        p["ffn"] = rwkv_lib.init_rwkv_channel_mix(gen, d, cfg.d_ff, dtype=dtype, device=device)
    else:
        raise ValueError(spec.ffn)
    return p


def _stack_into(stacked: Any, r: int, tree: Any, repeats: int) -> Any:
    """Write layer ``r``'s params (tensors or ``PackedPVQ``) into the
    stacked tree (allocated on the first layer), so a stack never needs a
    second copy of itself; a stack of one is a view of its layer."""
    if isinstance(tree, dict):
        if stacked is None:
            stacked = {}
        for k, v in tree.items():
            stacked[k] = _stack_into(stacked.get(k), r, v, repeats)
        return stacked
    if is_packed(tree):
        if repeats == 1:
            return dataclasses.replace(tree, pulses=tree.pulses[None], scales=tree.scales[None])
        if stacked is None:
            stacked = dataclasses.replace(
                tree, pulses=tree.pulses.new_empty((repeats,) + tuple(tree.pulses.shape)),
                scales=tree.scales.new_empty((repeats,) + tuple(tree.scales.shape)))
        stacked.pulses[r] = tree.pulses
        stacked.scales[r] = tree.scales
        return stacked
    if repeats == 1:
        return tree[None]
    if stacked is None:
        stacked = torch.empty((repeats,) + tuple(tree.shape), dtype=tree.dtype, device=tree.device)
    stacked[r] = tree
    return stacked


def init_segment(gen, cfg: ModelConfig, seg: Segment, device, pack=None) -> Params:
    """Layer params stacked along a leading ``repeats`` axis, initialized one
    layer at a time in order.  ``pack(name, block)`` (``Model.init``'s
    packing at init) turns each block's leaves into what they are packed to
    in the stack, as soon as the block is built, so that no more than one
    block is ever dense."""
    repeats, pattern = seg
    stacked = None
    for r in range(repeats):
        layer = {}
        for i, spec in enumerate(pattern):
            block = init_block(gen, cfg, spec, device)
            layer[f"b{i}"] = block if pack is None else pack(f"b{i}", block)
        stacked = _stack_into(stacked, r, layer, repeats)
    return stacked


def unstack_layers(seg_params: Any, repeats: int) -> List[Any]:
    """Layers ``0 .. repeats - 1`` of a stacked segment (views, no copies),
    each stacked tensor split by one ``unbind``: its backward writes the stacked
    gradient once, where ``repeats`` indexings would each add a
    stack-sized gradient."""
    if isinstance(seg_params, dict):
        per_key = {k: unstack_layers(v, repeats) for k, v in seg_params.items()}
        return [{k: layers[r] for k, layers in per_key.items()} for r in range(repeats)]
    if is_packed(seg_params):
        return [seg_params.stack_item(r) for r in range(repeats)]
    return list(torch.unbind(seg_params, 0))


def fold_in(gen: Optional[torch.Generator], *data: int) -> Optional[torch.Generator]:
    """A new generator on ``gen``'s device, seeded by ``gen``'s seed and
    ``data``: a pure function of both, as ``jax.random.fold_in`` is of its
    key (``gen``'s own draws do not move it).  None stays None."""
    if gen is None:
        return None
    mixed = np.random.SeedSequence([gen.initial_seed(), *data]).generate_state(2, np.uint32)
    out = torch.Generator(device=gen.device)
    out.manual_seed((int(mixed[0]) << 31) | (int(mixed[1]) >> 1))
    return out


def _ffn(cfg, spec: BlockSpec, p: Params, h: torch.Tensor, *, train: bool = False,
         rng: Optional[torch.Generator] = None,
         x_prev: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(y, aux_loss or None)``: the MoE FFN returns its Switch aux loss;
    ``x_prev`` is the channel mix's last token before ``h`` (decode)."""
    if spec.ffn in ("dense", "dense0"):
        return L.ffn(p, h, cfg.ffn_activation), None
    if spec.ffn == "moe":
        return moe_lib.moe_forward(p, h, cfg.moe, train=train, rng=rng)
    if spec.ffn == "cmix":
        return rwkv_lib.rwkv_channel_mix(p, h, x_prev=x_prev), None
    raise ValueError(spec.ffn)


def _last_token(h: torch.Tensor) -> torch.Tensor:
    """The token shift's carry: the last row of ``h``, a tensor of its own."""
    return h[:, -1, :].clone()


def block_forward(cfg, spec: BlockSpec, p: Params, x: torch.Tensor, *, mode: str,
                  enc_out: Optional[torch.Tensor] = None, prefix_len: int = 0,
                  rng: Optional[torch.Generator] = None):
    """Returns ``(x, aux_loss or None, cache_entry_or_None)``; mode is
    'train' or 'prefill'.  The aux loss is the MoE FFN's (None for a dense
    FFN).  ``enc_out`` is the encoder's output (a cross block attends to
    it and, in prefill, caches its keys and values); ``prefix_len`` the
    VLM's patch prefix (the prefix-LM mask).  ``rng`` (train only) feeds
    the MoE router jitter; None keeps every layer deterministic."""
    cache: Dict[str, Any] = {}
    h = _norm(cfg, p["ln_mix"], x)
    if spec.mixer == "attn":
        y, k, v = attn_lib.attention_forward(
            p["mixer"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, causal=spec.causal,
            prefix_len=prefix_len, return_kv=True,
        )
        if mode == "prefill":
            cache["kv"] = attn_lib.kv_cache_from_prefill(k, v)
    elif spec.mixer == "mla":
        y, mc = mla_lib.mla_forward(p["mixer"], h, n_heads=cfg.n_heads, cfg=cfg.mla,
                                    return_cache=True)
        if mode == "prefill":
            cache["mla"] = mc
    elif spec.mixer == "mamba":
        if mode == "prefill":
            y, cache["mamba"] = mamba_lib.mamba_forward(p["mixer"], h, cfg.ssm, return_state=True)
        else:
            y = mamba_lib.mamba_forward(p["mixer"], h, cfg.ssm)
    elif spec.mixer == "rwkv":
        if mode == "prefill":
            y, cache["rwkv_state"] = rwkv_lib.rwkv_time_mix(p["mixer"], h, cfg.rwkv,
                                                            return_state=True)
            cache["rwkv_shift_att"] = _last_token(h)
        else:
            y = rwkv_lib.rwkv_time_mix(p["mixer"], h, cfg.rwkv)
    else:
        raise ValueError(spec.mixer)
    x = x + y
    if spec.cross:
        h = _norm(cfg, p["ln_cross"], x)
        enc_kv = attn_lib.cross_kv(p["cross"], enc_out, n_heads=cfg.n_heads,
                                   head_dim=cfg.resolved_head_dim)
        x = x + attn_lib.cross_attention_forward(p["cross"], h, enc_kv, n_heads=cfg.n_heads,
                                                 head_dim=cfg.resolved_head_dim)
        if mode == "prefill":
            cache["cross"] = enc_kv
    h = _norm(cfg, p["ln_ffn"], x)
    y, aux = _ffn(cfg, spec, p["ffn"], h, train=(mode == "train"), rng=rng)
    if spec.ffn == "cmix" and mode == "prefill":
        cache["rwkv_shift_ffn"] = _last_token(h)
    x = x + y
    return x, aux, (cache if mode == "prefill" else None)


def block_decode(cfg, spec: BlockSpec, p: Params, x: torch.Tensor, cache: Dict[str, Any], pos,
                 fill: Optional[bool] = None):
    """``pos``: a host int (the eager lockstep step) or a ``(b,)`` device
    tensor of per-row positions (the captured step, the engine's slots);
    ``fill``: the host's block-fill choice for a packed or paged cache."""
    new_cache = dict(cache)
    h = _norm(cfg, p["ln_mix"], x)
    if spec.mixer == "attn":
        y, new_cache["kv"] = attn_lib.attention_decode(
            p["mixer"], h, cache["kv"], pos, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, fill=fill,
        )
    elif spec.mixer == "mla":
        y, new_cache["mla"] = mla_lib.mla_decode(p["mixer"], h, cache["mla"], pos,
                                                 n_heads=cfg.n_heads, cfg=cfg.mla)
    elif spec.mixer == "mamba":
        y, new_cache["mamba"] = mamba_lib.mamba_decode(p["mixer"], h, cache["mamba"], cfg.ssm)
    elif spec.mixer == "rwkv":
        y, new_cache["rwkv_state"] = rwkv_lib.rwkv_time_mix(
            p["mixer"], h, cfg.rwkv, x_prev=cache["rwkv_shift_att"], state=cache["rwkv_state"],
            return_state=True)
        new_cache["rwkv_shift_att"] = _last_token(h)
    else:
        raise ValueError(spec.mixer)
    x = x + y
    if spec.cross:
        h = _norm(cfg, p["ln_cross"], x)
        x = x + attn_lib.cross_attention_forward(p["cross"], h, cache["cross"],
                                                 n_heads=cfg.n_heads,
                                                 head_dim=cfg.resolved_head_dim)
    h = _norm(cfg, p["ln_ffn"], x)
    x = x + _ffn(cfg, spec, p["ffn"], h, x_prev=cache.get("rwkv_shift_ffn"))[0]
    if spec.ffn == "cmix":
        new_cache["rwkv_shift_ffn"] = _last_token(h)
    return x, new_cache


def init_block_cache(cfg, spec: BlockSpec, batch: int, cache_len: int, device, *,
                     enc_len: int = 0, paged: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """Zero decode cache of one block: the attention KV cache (dense or
    packed, by the process ``KVQuant``), the dense MLA latent cache or a
    recurrent mixer's state (Mamba's ``conv`` window and f32 ``ssm`` state;
    RWKV's f32 ``rwkv_state`` and its token shifts), and a cross block's
    encoder KV over ``enc_len`` positions (always dense: written once, read
    in full every step, never appended).
    ``paged=(n_pages, max_pages)`` builds the engine's slot-pool cache
    instead (``batch`` is the slot count): a ``PagedKV`` page pool, which
    needs an active ``KVQuant`` (pages are PVQ blocks) and plain attention
    blocks."""
    dtype = getattr(torch, cfg.compute_dtype)
    if paged is not None:
        from ..core.packed import PagedKV
        from ..core.quantize import default_kv_quant

        if spec.mixer != "attn" or spec.cross:
            raise NotImplementedError(
                f"paged slot-pool cache supports plain attention blocks only, "
                f"got mixer={spec.mixer!r} cross={spec.cross}"
            )
        kvq = default_kv_quant()
        if kvq is None:
            raise ValueError(
                "paged slot-pool cache needs an active KVQuant default "
                "(pages are PVQ blocks) — set_default_kv_quant(...) first"
            )
        n_pages, max_pages = paged
        return {"kv": PagedKV.init(batch, n_pages, max_pages, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, kvq=kvq, dtype=dtype, device=device)}
    c: Dict[str, Any] = {}
    if spec.mixer == "mla":
        c["mla"] = mla_lib.MLACache(
            c_kv=torch.zeros((batch, cache_len, cfg.mla.kv_lora_rank), dtype=dtype, device=device),
            k_rope=torch.zeros((batch, cache_len, cfg.mla.rope_head_dim), dtype=dtype, device=device),
        )
    elif spec.mixer == "mamba":
        c["mamba"] = mamba_lib.init_mamba_cache(batch, cfg.d_model, cfg.ssm, dtype, device)
    elif spec.mixer == "rwkv":
        m = cfg.rwkv.head_size
        c["rwkv_state"] = torch.zeros((batch, cfg.d_model // m, m, m), dtype=torch.float32,
                                      device=device)
        c["rwkv_shift_att"] = torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)
    else:
        c["kv"] = attn_lib.init_kv_cache(batch, cache_len, cfg.n_kv_heads,
                                         cfg.resolved_head_dim, dtype, device=device)
    if spec.cross:
        c["cross"] = attn_lib.init_kv_cache(batch, enc_len, cfg.n_heads, cfg.resolved_head_dim,
                                            dtype, quantized=False, device=device)
    if spec.ffn == "cmix":
        c["rwkv_shift_ffn"] = torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)
    return c


def run_segment(cfg, seg: Segment, seg_params: Params, x: torch.Tensor, *, mode: str,
                enc_out: Optional[torch.Tensor] = None, prefix_len: int = 0,
                rng: Optional[torch.Generator] = None):
    """Returns ``(x, aux, caches or None)``: in train mode ``aux`` is the
    layers' aux losses summed (an f32 scalar, 0 without MoE), in prefill
    None (the serving callers drop it, and their steps stay as they were);
    layer ``r``'s block ``i`` draws from ``fold_in(fold_in(rng, r), i)``."""
    repeats, pattern = seg
    train = mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
    caches: Optional[List[Dict[str, Any]]] = [] if mode == "prefill" else None
    for r, p_r in enumerate(unstack_layers(seg_params, repeats)):
        rng_r = fold_in(rng, r)
        layer_cache = {}
        for i, spec in enumerate(pattern):
            x, aux_i, c = block_forward(cfg, spec, p_r[f"b{i}"], x, mode=mode, enc_out=enc_out,
                                        prefix_len=prefix_len, rng=fold_in(rng_r, i))
            if train and aux_i is not None:
                aux = aux + aux_i
            if c is not None:
                layer_cache[f"b{i}"] = c
        if caches is not None:
            caches.append(layer_cache)
    return x, aux, caches


def decode_segment(cfg, seg: Segment, seg_params: Params, seg_cache: List[Dict[str, Any]],
                   x: torch.Tensor, pos, fill: Optional[bool] = None):
    repeats, pattern = seg
    new_cache = []
    for r, p_r in enumerate(unstack_layers(seg_params, repeats)):
        c_r = {}
        for i, spec in enumerate(pattern):
            x, c_r[f"b{i}"] = block_decode(cfg, spec, p_r[f"b{i}"], x, seg_cache[r][f"b{i}"], pos,
                                           fill)
        new_cache.append(c_r)
    return x, new_cache


def block_chunk(cfg, spec: BlockSpec, p: Params, x: torch.Tensor, cache: Dict[str, Any],
                slot, start, page_ids, real_len):
    """Chunked-prefill twin of :func:`block_decode` over the paged cache:
    plain attention blocks only (``init_block_cache(paged=...)`` rejects
    every other mixer).  The indices are host integers or device tensors
    (``attention_prefill_chunk``)."""
    if spec.mixer != "attn" or spec.cross:
        raise NotImplementedError(
            f"chunked prefill supports plain attention blocks only, "
            f"got mixer={spec.mixer!r} cross={spec.cross}"
        )
    new_cache = dict(cache)
    h = _norm(cfg, p["ln_mix"], x)
    y, new_cache["kv"] = attn_lib.attention_prefill_chunk(
        p["mixer"], h, cache["kv"], slot=slot, start=start, page_ids=page_ids,
        real_len=real_len, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
    )
    x = x + y
    h = _norm(cfg, p["ln_ffn"], x)
    x = x + _ffn(cfg, spec, p["ffn"], h)[0]
    return x, new_cache


def chunk_segment(cfg, seg: Segment, seg_params: Params, seg_cache: List[Dict[str, Any]],
                  x: torch.Tensor, slot, start, page_ids, real_len):
    repeats, pattern = seg
    new_cache = []
    for r, p_r in enumerate(unstack_layers(seg_params, repeats)):
        c_r = {}
        for i, spec in enumerate(pattern):
            x, c_r[f"b{i}"] = block_chunk(cfg, spec, p_r[f"b{i}"], x, seg_cache[r][f"b{i}"],
                                          slot, start, page_ids, real_len)
        new_cache.append(c_r)
    return x, new_cache


def init_plan_cache(cfg, plan: List[Segment], batch: int, cache_len: int, device="cuda", *,
                    enc_len: int = 0, paged: Optional[Tuple[int, int]] = None):
    return {
        f"seg{si}": [
            {f"b{i}": init_block_cache(cfg, spec, batch, cache_len, device, enc_len=enc_len,
                                       paged=paged)
             for i, spec in enumerate(pattern)}
            for _ in range(repeats)
        ]
        for si, (repeats, pattern) in enumerate(plan)
    }
