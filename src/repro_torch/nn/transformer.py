"""Block assembly for the dense family (port of ``repro.nn.transformer``).

A model is a list of segments ``(repeats, pattern)``.  Per-segment
parameters are stacked along a leading ``repeats`` axis, as in the
reference; where the reference runs ``lax.scan`` over that axis, the port
runs a Python loop over the stacked layer params.  Decode caches are a
list with one entry per layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.packed import is_packed
from . import attention as attn_lib
from . import layers as L
from .layers import Params


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str  # 'attn' (the only mixer ported)
    ffn: str  # 'dense'
    causal: bool = True
    cross: bool = False


Segment = Tuple[int, Tuple[BlockSpec, ...]]


def segment_plan(cfg: ModelConfig, role: str = "decoder") -> List[Segment]:
    if cfg.family != "dense" or role != "decoder":
        raise NotImplementedError(f"{cfg.family}/{role} stacks are not ported yet")
    return [(cfg.n_layers, (BlockSpec("attn", "dense"),))]


def _init_norm(cfg: ModelConfig, dtype, device) -> Params:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return L.init_rmsnorm(cfg.d_model, dtype, device)


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x)


def init_block(gen, cfg: ModelConfig, spec: BlockSpec, device) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    return {
        "ln_mix": _init_norm(cfg, dtype, device),
        "mixer": attn_lib.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, dtype=dtype, device=device
        ),
        "ln_ffn": _init_norm(cfg, dtype, device),
        "ffn": L.init_ffn(gen, d, cfg.d_ff, cfg.ffn_activation, dtype=dtype, device=device),
    }


def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_segment(gen, cfg: ModelConfig, seg: Segment, device) -> Params:
    repeats, pattern = seg
    layers = [
        {f"b{i}": init_block(gen, cfg, spec, device) for i, spec in enumerate(pattern)}
        for _ in range(repeats)
    ]
    return _stack(layers)


def layer_params(seg_params: Any, r: int) -> Any:
    """Layer ``r`` of a stacked segment (views, no copies)."""
    if isinstance(seg_params, dict):
        return {k: layer_params(v, r) for k, v in seg_params.items()}
    if is_packed(seg_params):
        return seg_params.stack_item(r)
    return seg_params[r]


def block_forward(cfg, spec: BlockSpec, p: Params, x: torch.Tensor, *, mode: str):
    """Returns ``(x, cache_entry_or_None)``; mode is 'train' or 'prefill'."""
    cache: Dict[str, Any] = {}
    h = _norm(cfg, p["ln_mix"], x)
    y, k, v = attn_lib.attention_forward(
        p["mixer"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, return_kv=True,
    )
    if mode == "prefill":
        cache["kv"] = attn_lib.kv_cache_from_prefill(k, v)
    x = x + y
    h = _norm(cfg, p["ln_ffn"], x)
    x = x + L.ffn(p["ffn"], h, cfg.ffn_activation)
    return x, (cache if mode == "prefill" else None)


def block_decode(cfg, spec: BlockSpec, p: Params, x: torch.Tensor, cache: Dict[str, Any], pos: int):
    new_cache = dict(cache)
    h = _norm(cfg, p["ln_mix"], x)
    y, kv = attn_lib.attention_decode(
        p["mixer"], h, cache["kv"], pos, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
    )
    new_cache["kv"] = kv
    x = x + y
    h = _norm(cfg, p["ln_ffn"], x)
    x = x + L.ffn(p["ffn"], h, cfg.ffn_activation)
    return x, new_cache


def init_block_cache(cfg, spec: BlockSpec, batch: int, cache_len: int, device) -> Dict[str, Any]:
    dtype = getattr(torch, cfg.compute_dtype)
    return {
        "kv": attn_lib.init_kv_cache(
            batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim, dtype, device=device
        )
    }


def run_segment(cfg, seg: Segment, seg_params: Params, x: torch.Tensor, *, mode: str):
    repeats, pattern = seg
    caches: Optional[List[Dict[str, Any]]] = [] if mode == "prefill" else None
    for r in range(repeats):
        p_r = layer_params(seg_params, r)
        layer_cache = {}
        for i, spec in enumerate(pattern):
            x, c = block_forward(cfg, spec, p_r[f"b{i}"], x, mode=mode)
            if c is not None:
                layer_cache[f"b{i}"] = c
        if caches is not None:
            caches.append(layer_cache)
    return x, caches


def decode_segment(cfg, seg: Segment, seg_params: Params, seg_cache: List[Dict[str, Any]],
                   x: torch.Tensor, pos: int):
    repeats, pattern = seg
    new_cache = []
    for r in range(repeats):
        p_r = layer_params(seg_params, r)
        c_r = {}
        for i, spec in enumerate(pattern):
            x, c_r[f"b{i}"] = block_decode(cfg, spec, p_r[f"b{i}"], x, seg_cache[r][f"b{i}"], pos)
        new_cache.append(c_r)
    return x, new_cache


def init_plan_cache(cfg, plan: List[Segment], batch: int, cache_len: int, device="cuda"):
    return {
        f"seg{si}": [
            {f"b{i}": init_block_cache(cfg, spec, batch, cache_len, device) for i, spec in enumerate(pattern)}
            for _ in range(repeats)
        ]
        for si, (repeats, pattern) in enumerate(plan)
    }
