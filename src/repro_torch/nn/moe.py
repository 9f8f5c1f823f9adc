"""Mixture-of-Experts: shared + routed experts, top-k routing and GShard-style
capacity dispatch (port of ``repro.nn.moe``, its serving path).

Dispatch tensors are built per routing *group* (a contiguous slice of
tokens).  Capacity per group:
    C = ceil(group_size * top_k * capacity_factor / n_experts)
Tokens over capacity are dropped (GShard semantics); the residual path
carries them unchanged.

``ShardingPolicy.moe_light_combine`` (``parallel.sharding``; on from
``launch.steps.policy_for(..., opt_level=1)``) folds the gate values into
per-slot scalars instead of the f32 (g, s, E, C) combine tensor.  One-hot
rows are built by comparison with an ``arange`` (the same values as
``one_hot``, which reads its input's range on the host: no such read on a
shape-only dry-run tensor).  In train mode
a ``torch.Generator`` drives the router jitter: no torch generator gives
``jax.random``'s draws, so the noise is the reference's in law, not in
value.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..parallel.sharding import constrain
from .layers import Params, _act, ffn, init_ffn


class MoEConfig(NamedTuple):
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0  # DeepSeek shared experts (always-on)
    d_expert: int = 1024  # expert FFN hidden dim
    capacity_factor: float = 1.25
    group_size: int = 4096  # routing group (tokens)
    activation: str = "swiglu"
    # multiplicative router-logit noise (training only)
    router_jitter: float = 0.0


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, *, dtype, device) -> Params:
    """Same shapes, names and distributions as the reference (other
    numbers): the router stays f32, the expert banks are stacked
    ``(E, d_model, f)`` / ``(E, f, d_model)``."""
    e, f = cfg.n_experts, cfg.d_expert
    glu = cfg.activation in ("swiglu", "geglu")

    def normal(shape, std):
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(std)

    std = 1.0 / math.sqrt(d_model)
    p: Params = {
        "router": {"kernel": normal((d_model, e), std)},
        "wi_up_experts": normal((e, d_model, f), std).to(dtype),
        "wo_experts": normal((e, f, d_model), 1.0 / math.sqrt(f)).to(dtype),
    }
    if glu:
        p["wi_gate_experts"] = normal((e, d_model, f), std).to(dtype)
    if cfg.n_shared:
        p["shared"] = init_ffn(gen, d_model, cfg.d_expert * cfg.n_shared, cfg.activation,
                               dtype=dtype, device=device)
    return p


def routing_group_size(cfg: MoEConfig, t: int) -> int:
    """Tokens per routing group for a t-token batch."""
    return min(cfg.group_size, t)


def routing_capacity(cfg: MoEConfig, s: int) -> int:
    """Capacity slots per (group, expert) for group size ``s``."""
    return max(int(math.ceil(s * cfg.top_k * cfg.capacity_factor / cfg.n_experts)), 1)


def dispatch_gemm_rows(cfg: MoEConfig, t: int) -> int:
    """Rows (m = groups * capacity) of the per-expert dispatch GEMM that
    ``moe_forward`` hands to ``ops.packed_matmul_stacked``."""
    gs = routing_group_size(cfg, t)
    return (-(-t // gs)) * routing_capacity(cfg, gs)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` for the MoE's three buffer contractions.
    On DTensors each is written as copied, contiguous operands into one
    ``bmm``: ``einsum`` reshapes permuted views, and DTensor can describe a
    local shard as contiguous when it is not, so a view of it fails (a
    copy, not ``contiguous()``, which trusts that description)."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(eq, a, b)

    def packed(t):
        return t.clone(memory_format=torch.contiguous_format)

    if eq == "gsd,gsec->gecd":  # dispatch: per group, (E C, s) @ (s, d)
        g, s, d = a.shape
        e, c = b.shape[2:]
        disp = packed(packed(b).reshape(g, s, e * c).transpose(1, 2))
        return torch.bmm(disp, packed(a)).reshape(g, e, c, d)
    if eq == "gecd,gsec->gsd":  # combine: per group, (s, E C) @ (E C, d)
        g, e, c, d = a.shape
        s = b.shape[1]
        return torch.bmm(packed(b).reshape(g, s, e * c), packed(a).reshape(g, e * c, d))
    if eq == "gecd,edf->gecf":  # expert FFN: per expert, (g C, d) @ (d, f)
        g, e, c, d = a.shape
        y = torch.bmm(packed(a.permute(1, 0, 2, 3)).reshape(e, g * c, d), packed(b))
        return packed(y.reshape(e, g, c, -1).permute(1, 0, 2, 3))
    raise ValueError(eq)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``one_hot(idx, n)`` in ``dtype``; an index outside ``[0, n)`` gives a
    zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_argmax(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k via k argmax+mask rounds (ties go to the first maximal index,
    as ``jnp.argmax``)."""
    vals, idxs = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        oh = _one_hot(i, probs.shape[-1], probs.dtype)
        vals.append(torch.sum(p * oh, dim=-1))
        idxs.append(i)
        p = p * (1.0 - oh)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def _acc(total: Optional[torch.Tensor], term: torch.Tensor) -> torch.Tensor:
    return term if total is None else total + term


def _routing(
    logits: torch.Tensor, cfg: MoEConfig, *, light: bool = False,
    token_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
    """logits: (g, s, E).  Returns ``(dispatch (g,s,E,C) bf16, combine
    (g,s,E,C) f32 | None, slot_gate (g,E,C) f32 | None, aux_loss)``.

    ``light=True``: instead of the f32 (g,s,E,C) combine tensor, fold the
    gate values into per-slot scalars (g,E,C) — each slot holds exactly one
    token, so combine == dispatch * slot_gate broadcast.

    ``token_mask`` (g, s) bool marks the real tokens: padding never claims a
    capacity slot and stays out of the aux statistics.  A token whose slot
    position is past the capacity gets an all-zero slot row (the
    reference's ``one_hot`` of an out-of-range index), i.e. it is dropped.
    """
    g, s, e = logits.shape
    c = routing_capacity(cfg, s)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate_vals, gate_idx = _topk_argmax(probs, cfg.top_k)  # (g, s, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot_top1 = _one_hot(gate_idx[..., 0], e, torch.float32)
    if token_mask is None:
        me = probs.mean(dim=(0, 1))
        ce = onehot_top1.mean(dim=(0, 1))
    else:
        mask_f = token_mask.to(torch.float32)
        denom = torch.clamp(mask_f.sum(), min=1.0)
        me = (probs * mask_f[..., None]).sum(dim=(0, 1)) / denom
        ce = (onehot_top1 * mask_f[..., None]).sum(dim=(0, 1)) / denom
    aux = e * torch.sum(me * ce)

    dev = logits.device
    # the (g, s, E, C) sums start from the first choice's terms, not from
    # zeros: the same values (every term is >= 0), laid out like the
    # logits on a mesh, where a fresh zeros tensor would be a whole
    # replicated copy on every rank
    dispatch = combine = slot_gate = None
    fill = torch.zeros((g, e), dtype=torch.int64, device=dev)
    slots = torch.arange(c, device=dev)
    for j in range(cfg.top_k):
        oh = _one_hot(gate_idx[..., j], e, torch.int64)  # (g, s, E)
        if token_mask is not None:
            oh = oh * token_mask[..., None].to(oh.dtype)
        pos = torch.cumsum(oh, dim=1) - 1 + fill[:, None, :]  # (g, s, E)
        pos_tok = torch.sum(pos * oh, dim=-1)  # (g, s)
        keep = pos_tok < c
        # one_hot(pos_tok, c) * keep: out-of-range positions give zero rows
        slot_oh = ((pos_tok[..., None] == slots) & keep[..., None]).to(torch.float32)
        contrib = oh[..., None].to(torch.float32) * slot_oh[:, :, None, :]  # (g,s,E,C)
        dispatch = _acc(dispatch, contrib.to(torch.bfloat16))
        if light:
            slot_gate = _acc(slot_gate, torch.einsum("gsec,gs->gec", contrib, gate_vals[..., j]))
        else:
            combine = _acc(combine, contrib * gate_vals[..., j][..., None, None])
        fill = fill + torch.sum(oh * keep[..., None].to(oh.dtype), dim=1)
    return dispatch, combine, slot_gate, aux


#: MoE activation -> fused matmul-epilogue name (kernels.pvq_matmul.ACTIVATIONS)
_KERNEL_ACT = {"swiglu": "silu", "silu": "silu", "geglu": "gelu",
               "gelu": "gelu", "relu": "relu", "relu2": "relu2"}


def _fold_dispatch(buf: torch.Tensor) -> torch.Tensor:
    """(g, E, C, d) dispatch buffer -> per-expert matrices (E, g*C, d), in
    the buffer's dtype."""
    g, e, c, d = buf.shape
    return buf.permute(1, 0, 2, 3).reshape(e, g * c, d)


def _quantize_dispatch(buf: torch.Tensor, act_quant):
    """Quantize the folded dispatch buffer ONCE (per-row int8): the
    ``(int8 (E, g*C, d), scales (E, g*C, 1))`` pair feeds both the up and
    the gate expert matmuls.  Empty capacity slots get zero scales."""
    from ..kernels import ops

    return ops.quantize_rows(_fold_dispatch(buf), buf.shape[-1], act_quant)


def _expert_matmul(buf: torch.Tensor, w, *, activation: str = "none", act_quant=None,
                   x_quant=None) -> torch.Tensor:
    """Contract the (g, E, C, d) dispatch buffer against a stacked expert
    bank (E, d, f): a dense einsum, or the batched kernel when the bank is
    an expert-stacked ``PackedPVQ`` (v3 with ``x_quant``/``act_quant``, else
    v2).  ``x_quant`` is :func:`_quantize_dispatch`'s pre-quantized pair."""
    from ..core.packed import is_packed

    if not is_packed(w):
        y = _einsum("gecd,edf->gecf", buf, w.to(buf.dtype))
        return _act(activation, y) if activation != "none" else y
    from ..kernels import ops

    g, e, c, _ = buf.shape
    if x_quant is not None:
        xb, act_scale = x_quant
        y = ops.packed_matmul_stacked(xb, w, activation=activation, act_scale=act_scale)
    else:
        xb = _fold_dispatch(buf)
        if act_quant is None:
            xb = xb.to(torch.float32)  # v2 rounds its f64 sums to x's dtype: f32
        y = ops.packed_matmul_stacked(xb, w, activation=activation, act_quant=act_quant)
    f = y.shape[-1]
    return y.reshape(e, g, c, f).permute(1, 0, 2, 3).to(buf.dtype)


def moe_forward(p: Params, x: torch.Tensor, cfg: MoEConfig, *, expert_constraint=None,
                train: bool = False, rng: Optional[torch.Generator] = None,
                act_quant=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out (b, s, d), aux_loss)``.

    ``expert_constraint`` lays out the (g, E, C, d) dispatch buffer
    (experts on the model axis: the token-to-expert all-to-all) and the
    expert output buffer before the combine (on a mesh, DTensor's
    propagation does not infer a layout there that its reshapes can take).

    ``train=True`` with a generator ``rng`` (on x's device) multiplies the
    router logits by uniform noise in ``1 +- cfg.router_jitter``; without
    either, or at zero jitter, the forward is the deterministic one.

    ``act_quant`` (default: the process ``ActQuant``) runs the packed expert
    contractions int8 x int8: the dispatch buffer is quantized ONCE for the
    up and gate matmuls, the hidden ``h`` once for ``wo``.  The router
    always takes f32 logits.
    """
    from ..core.packed import is_packed
    from ..core.quantize import default_act_quant

    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gs = routing_group_size(cfg, t)
    pad = (-t) % gs
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))])
    g = tokens.shape[0] // gs
    # groups over the data axes, tokens of a group whole: DTensor cannot
    # flatten the gradient back to tokens when a group's tokens are sharded
    xg = constrain(tokens.reshape(g, gs, d), "dp", None, None)
    token_mask = None
    if pad:
        token_mask = (torch.arange(g * gs, device=x.device) < t).reshape(g, gs)

    logits = torch.einsum("gsd,de->gse", xg.to(torch.float32),
                          p["router"]["kernel"].to(torch.float32))
    if train and cfg.router_jitter > 0.0 and rng is not None:
        noise = torch.empty_like(logits).uniform_(1.0 - cfg.router_jitter,
                                                  1.0 + cfg.router_jitter, generator=rng)
        logits = logits * noise
    from ..parallel.sharding import current_policy

    light = current_policy().moe_light_combine
    dispatch, combine, slot_gate, aux = _routing(logits, cfg, light=light, token_mask=token_mask)

    # dispatch: each slot holds at most one token, so this sum is exact
    buf = _einsum("gsd,gsec->gecd", xg, dispatch.to(xg.dtype))
    if expert_constraint is not None:
        buf = expert_constraint(buf)

    if act_quant is None:
        act_quant = default_act_quant()
    glu = "wi_gate_experts" in p
    act = _KERNEL_ACT[cfg.activation]
    xq = (_quantize_dispatch(buf, act_quant)
          if act_quant is not None and is_packed(p["wi_up_experts"]) else None)
    if glu:
        up = _expert_matmul(buf, p["wi_up_experts"], x_quant=xq)
        h = _expert_matmul(buf, p["wi_gate_experts"], activation=act, x_quant=xq) * up
    else:
        h = _expert_matmul(buf, p["wi_up_experts"], activation=act, x_quant=xq)
    out_buf = _expert_matmul(h, p["wo_experts"],
                             act_quant=act_quant if is_packed(p["wo_experts"]) else None)

    # combine: the gate-weighted sum of a token's (up to top_k) slots
    if light:
        out_buf = out_buf * slot_gate[..., None].to(out_buf.dtype)
    if expert_constraint is not None:
        out_buf = expert_constraint(out_buf)
    if light:
        out = _einsum("gecd,gsec->gsd", out_buf, dispatch.to(out_buf.dtype))
    else:
        out = _einsum("gecd,gsec->gsd", out_buf, combine.to(out_buf.dtype))
    out = out.reshape(-1, d)[:t].reshape(b, s, d)
    if cfg.n_shared:
        out = out + ffn(p["shared"], x, cfg.activation)
    return out, aux
