"""Operations and bytes that a step's inputs need, computed from the
configuration's shapes (each input byte read once, each output byte
written once), for the kernels' rooflines and the whole step's share of
the chip's peak.

Byte counts:

* v3 (``pvq_matmul_q``, int8 x int8): int8 pulses at 1 B each, one f32
  rho per ``group`` weights of the group-padded contraction, the int8
  activations and their f32 row scales in, f32 outputs out.
* batched v3 (the expert banks): as v3 for every expert of the bank (all
  of them: at the cells' batches each is hit, see ``PERF.md``); rows and
  operations are the (token, expert) pairs the router picks, not the
  capacity slots.
* v4 (``pvq_attn_q``): per (sequence, KV head) row, the packed positions'
  K and V pulses (1 B each) and their f32 scales, the int8 queries and
  their scales in, the f32 accumulators and the softmax's running max and
  sum out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


def k_pad(k: int, group: int) -> Tuple[int, int]:
    """(group-padded contraction, effective group) of a ``(k, n)`` matrix:
    a contraction under one group takes the largest power-of-two divisor of
    it that the group halves to."""
    g = group
    if k < group:
        while g > 1 and k % g:
            g //= 2
    return -(-k // g) * g, g


def v3(m: int, k: int, n: int, group: int) -> Tuple[float, float]:
    kp, g = k_pad(k, group)
    ops = 2.0 * m * k * n
    nbytes = kp * n + 4.0 * (kp // g) * n + m * kp + 4.0 * m + 4.0 * m * n
    return ops, nbytes


def v3_batched(experts: int, pairs: int, k: int, n: int, group: int) -> Tuple[float, float]:
    kp, g = k_pad(k, group)
    ops = 2.0 * pairs * k * n
    nbytes = experts * (kp * n + 4.0 * (kp // g) * n) + pairs * kp + 4.0 * pairs + 4.0 * pairs * n
    return ops, nbytes


def v4(rows: int, kv_len: int, head_dim: int, group: int) -> Tuple[float, float]:
    """One (sequence, KV head) row block: ``rows`` queries (heads per KV
    head times query positions) over ``kv_len`` packed positions."""
    ops = 4.0 * rows * kv_len * head_dim
    per_pos = 2 * head_dim + 2 * 4 * (head_dim // group)
    nbytes = kv_len * per_pos + rows * head_dim + 4.0 * rows + 4.0 * rows * head_dim + 8.0 * rows
    return ops, nbytes


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The widths a count needs, from a configuration file's keys."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    group: int
    kv_group: int
    mla: bool = False
    q_dim: int = 0  # MLA: nope + rope head dim
    v_dim: int = 0
    kv_rank: int = 0
    rope_dim: int = 0
    experts: int = 0
    top_k: int = 0
    shared: int = 0
    expert_ff: int = 0
    dense_layers: int = 0
    dense_ff: int = 0

    @classmethod
    def of(cls, cfg: dict) -> "Shapes":
        srv = cfg["serving"]
        h = cfg["num_attention_heads"]
        common = dict(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"], heads=h,
                      kv_heads=cfg["num_key_value_heads"], vocab=cfg["vocab_size"],
                      group=srv["weights"]["group"],
                      kv_group=srv.get("kv_cache", {}).get("group", 0))
        if "kv_lora_rank" in cfg:
            nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
            return cls(**common, head_dim=nope + rope, ff=cfg["moe_intermediate_size"],
                       mla=True, q_dim=nope + rope, v_dim=cfg["v_head_dim"],
                       kv_rank=cfg["kv_lora_rank"], rope_dim=rope,
                       experts=cfg["n_routed_experts"], top_k=cfg["num_experts_per_tok"],
                       shared=cfg["n_shared_experts"], expert_ff=cfg["moe_intermediate_size"],
                       dense_layers=cfg["first_k_dense_replace"],
                       dense_ff=cfg["intermediate_size"])
        return cls(**common, head_dim=cfg.get("head_dim") or cfg["hidden_size"] // h,
                   ff=cfg["intermediate_size"])


Call = Tuple[str, float, float]  # (kernel, ops, bytes)


def layer_matmuls(s: Shapes, layer: int) -> List[Tuple[int, int]]:
    """The 2-D packed matrices ``(k, n)`` one token row meets in ``layer``."""
    d = s.d
    if s.mla:
        # wk_rope, wk_b and wv_b stay dense
        mats = [(d, s.heads * s.q_dim), (d, s.kv_rank), (s.heads * s.v_dim, d)]
        ff = s.dense_ff if layer < s.dense_layers else s.expert_ff * s.shared
    else:
        hd = s.head_dim
        mats = [(d, s.heads * hd), (d, s.kv_heads * hd), (d, s.kv_heads * hd), (s.heads * hd, d)]
        ff = s.ff
    return mats + [(d, ff), (d, ff), (ff, d)]


def step_calls(s: Shapes, rows: int, head_rows: int) -> List[Call]:
    """Kernel calls of one pass of ``rows`` token rows through every layer
    (v3 and batched v3), plus the untied head over ``head_rows`` rows."""
    out: List[Call] = []
    for layer in range(s.layers):
        for k, n in layer_matmuls(s, layer):
            out.append(("v3", *v3(rows, k, n, s.group)))
        if s.mla and layer >= s.dense_layers:
            pairs = rows * s.top_k
            for k, n in ((s.d, s.expert_ff), (s.d, s.expert_ff), (s.expert_ff, s.d)):
                out.append(("v3_batched", *v3_batched(s.experts, pairs, k, n, s.group)))
    if s.mla and head_rows:  # the untied lm_head is a packed matmul; the tied one is not
        out.append(("v3", *v3(head_rows, s.d, s.vocab, s.group)))
    return out


def attention_calls(s: Shapes, q_rows: int, kv_lens: List[int]) -> List[Call]:
    """Kernel v4 over every layer: for each sequence, ``q_rows`` query
    positions against its ``kv_len`` packed positions, one row block per
    KV head."""
    gpr = s.heads // s.kv_heads
    out: List[Call] = []
    for kv_len in kv_lens:
        ops, nb = v4(q_rows * gpr, kv_len, s.head_dim, s.kv_group)
        out.append(("v4", s.layers * s.kv_heads * ops, s.layers * s.kv_heads * nb))
    return out


def model_ops(s: Shapes, head: bool) -> Tuple[float, float]:
    """``(a, b)``: the model's operations for one token at context ``ctx``
    (it attends to ``ctx`` positions) are ``a + b * ctx``.  2 per
    multiply-add of every matrix the token meets (for MoE the ``top_k``
    routed and the shared experts, not capacity slots), attention at its
    context, and the output head when ``head``."""
    a = b = 0.0
    for layer in range(s.layers):
        a += sum(2.0 * k * n for k, n in layer_matmuls(s, layer))
        if s.mla:
            # wk_rope, wk_b, wv_b
            a += 2.0 * (s.d * s.rope_dim + s.kv_rank * s.heads * (s.q_dim - s.rope_dim + s.v_dim))
            if layer >= s.dense_layers:
                a += s.top_k * 3 * 2.0 * s.d * s.expert_ff
            b += 2.0 * s.heads * (s.q_dim + s.v_dim)
        else:
            b += 4.0 * s.heads * s.head_dim
    if head:
        a += 2.0 * s.d * s.vocab
    return a, b


def model_ops_per_token(s: Shapes, ctx: int, head: bool) -> float:
    a, b = model_ops(s, head)
    return a + b * ctx


def total(calls: List[Call], kernel: str) -> Dict[str, float]:
    from .peaks import bound_s

    sel = [(o, b) for k, o, b in calls if k == kernel]
    return {"calls": len(sel), "ops": sum(o for o, _ in sel), "bytes": sum(b for _, b in sel),
            "bound_s": sum(bound_s(o, b) for o, b in sel)}
