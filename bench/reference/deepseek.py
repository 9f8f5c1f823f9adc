"""DeepSeek-V2 (MLA, routed and shared experts, a leading dense layer) as
served in lockstep batches: PVQ weights, int8 activations into every packed
matmul and expert bank, the MLA latent cache dense.  The router, the
shared RoPE key projection (``wk_rope``) and the latent's up-projections
(``wk_b``, ``wv_b``) stay dense, their inputs unquantized.

Routing is the configuration's: softmax over the routed experts, the
``top_k`` largest (ties to the lower index) with their weights
renormalised, and at most ``capacity`` tokens an expert in each routing
group (``ceil(group * top_k * capacity_factor / experts)``), filled in
token order one choice rank at a time; a choice past the capacity is
dropped.  Groups are how the served batch meets the layer: the prompt's
tokens, sequence after sequence, in groups of ``routing_group_size``; each
decode step's tokens, one per sequence, as one group."""

from __future__ import annotations

import math
import torch

from . import pvq
from .common import param_dtype, rms, rope, silu_gate


def _routing(logits: torch.Tensor, top_k: int, capacity: int):
    """``logits (G, S, E)`` -> ``(experts (G, S, k), gates (G, S, k), kept
    (G, S, k) bool)``."""
    probs = torch.softmax(logits, dim=-1)
    p = probs.clone()
    vals, idxs = [], []
    for _ in range(top_k):
        i = p.argmax(-1)
        vals.append(torch.gather(p, -1, i[..., None])[..., 0])
        idxs.append(i)
        p = p.scatter(-1, i[..., None], 0.0)
    vals, idxs = torch.stack(vals, -1), torch.stack(idxs, -1)
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    g, s, e = logits.shape
    fill = torch.zeros((g, e), dtype=torch.int64, device=logits.device)
    kept = []
    for j in range(top_k):
        oh = torch.nn.functional.one_hot(idxs[..., j], e)
        pos = (torch.cumsum(oh, dim=1) - 1 + fill[:, None, :]).gather(-1, idxs[..., j, None])[..., 0]
        keep = pos < capacity
        kept.append(keep)
        fill = fill + (oh * keep[..., None]).sum(1)
    return idxs, gates, torch.stack(kept, -1)


def forward(cfg: dict, ws, tokens: torch.Tensor, prompt_len: int, logits_from: int,
            qmax: int = 127, attn_rows: int = 8) -> torch.Tensor:
    """Teacher-forced logits ``(b, s - logits_from, vocab)`` of the batch
    ``tokens (b, s)`` whose first ``prompt_len`` positions were the prompt
    (prefilled together) and the rest decoded one step at a time."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rdim, vdim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, vocab = cfg["kv_lora_rank"], cfg["vocab_size"]
    experts, top_k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    eff, dense_ff = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    n_dense, layers = cfg["first_k_dense_replace"], cfg["num_hidden_layers"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    srv = cfg["serving"]
    wcfg = srv["weights"]
    dt = param_dtype(cfg)
    b, s = tokens.shape
    dev = tokens.device

    def mat(name, layer, shape):
        return pvq.matmul_weight(ws.get(name, layer, shape, dt), wcfg["group"], wcfg["n_over_k"])

    emb = pvq.flat_weight(ws.get("embed/embedding", None, (vocab, d), dt), wcfg["group"],
                          wcfg["embedding_n_over_k"])
    x = emb[tokens]
    del emb
    pos = torch.arange(s, device=dev)
    gsz = min(cfg["routing_group_size"], b * prompt_len)
    for layer in range(layers):
        seg, r = ("seg0", layer) if layer < n_dense else ("seg1", layer - n_dense)
        at = f"segments/{seg}/b0"
        h = rms(x, ws.get(f"{at}/ln_mix/rms_scale", r, (d,), dt), eps)
        ha = pvq.act(h, qmax)
        q = (ha @ mat(f"{at}/mixer/wq/kernel", r, (d, heads * (nope + rdim)))).view(
            b, s, heads, nope + rdim)
        q_nope, q_rope = q[..., :nope], rope(q[..., nope:], pos, theta)
        c = rms(ha @ mat(f"{at}/mixer/wkv_a/kernel", r, (d, rank)),
                ws.get(f"{at}/mixer/kv_norm/rms_scale", r, (rank,), dt), eps)
        wk_rope = ws.get(f"{at}/mixer/wk_rope/kernel", r, (d, rdim), dt).float()
        kr = rope((h @ wk_rope)[:, :, None, :], pos, theta)[:, :, 0, :]
        wk_b = ws.get(f"{at}/mixer/wk_b/kernel", r, (rank, heads * nope), dt).float()
        wv_b = ws.get(f"{at}/mixer/wv_b/kernel", r, (rank, heads * vdim), dt).float()
        out = torch.empty((b, s, heads, vdim), device=dev)
        causal = pos[None, :] <= pos[:, None]
        scale = 1.0 / math.sqrt(nope + rdim)
        for lo in range(0, b, attn_rows):
            sl = slice(lo, lo + attn_rows)
            kn = (c[sl] @ wk_b).view(-1, s, heads, nope)
            vv = (c[sl] @ wv_b).view(-1, s, heads, vdim)
            sc = (torch.einsum("bthd,bjhd->bhtj", q_nope[sl], kn)
                  + torch.einsum("bthd,bjd->bhtj", q_rope[sl], kr[sl])) * scale
            p = torch.softmax(sc.masked_fill(~causal, -math.inf), dim=-1)
            out[sl] = torch.einsum("bhtj,bjhd->bthd", p, vv)
        del q, q_nope, q_rope, c, kr, wk_b, wv_b
        wo = mat(f"{at}/mixer/wo/kernel", r, (heads * vdim, d))
        x = x + pvq.act(out.view(b, s, heads * vdim), qmax) @ wo
        del out, wo
        h = rms(x, ws.get(f"{at}/ln_ffn/rms_scale", r, (d,), dt), eps)
        if layer < n_dense:
            x = x + _ffn(mat, f"{at}/ffn", r, pvq.act(h, qmax), d, dense_ff, qmax)
        else:
            x = x + _moe(cfg, ws, mat, f"{at}/ffn", r, h, prompt_len, gsz, qmax)
    x = pvq.act(rms(x[:, logits_from:], ws.get("final_norm/rms_scale", None, (d,), dt), eps),
                qmax)
    return x @ mat("lm_head/kernel", None, (d, vocab))


def _ffn(mat, at: str, r, ha: torch.Tensor, d: int, ff: int, qmax: int) -> torch.Tensor:
    g = ha @ mat(f"{at}/wi_gate/kernel", r, (d, ff))
    u = ha @ mat(f"{at}/wi_up/kernel", r, (d, ff))
    return pvq.act(silu_gate(g, u), qmax) @ mat(f"{at}/wo/kernel", r, (ff, d))


def _moe(cfg, ws, mat, at: str, r, h: torch.Tensor, prompt_len: int, gsz: int, qmax: int) -> torch.Tensor:
    d, experts, top_k = cfg["hidden_size"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    eff, cf = cfg["moe_intermediate_size"], cfg["capacity_factor"]
    b, s, _ = h.shape
    router = ws.get(f"{at}/router/kernel", r, (d, experts), torch.float32)
    logits = h @ router
    # the prompt's groups, then one group per decode position
    lp = logits[:, :prompt_len].reshape(-1, gsz, experts)
    ld = logits[:, prompt_len:].transpose(0, 1)  # (s - prompt_len, b, E)
    picks = []
    for lg in (lp, ld):
        if lg.shape[1]:
            cap = max(math.ceil(lg.shape[1] * top_k * cf / experts), 1)
            picks.append(_routing(lg, top_k, cap))
    idx_p, gate_p, keep_p = (t.reshape(b, prompt_len, top_k) for t in picks[0])
    parts = [(idx_p, gate_p, keep_p)]
    if len(picks) > 1:
        parts.append(tuple(t.transpose(0, 1) for t in picks[1]))
    idx = torch.cat([p[0] for p in parts], 1).reshape(-1, top_k)
    gate = torch.cat([p[1] for p in parts], 1).reshape(-1, top_k)
    keep = torch.cat([p[2] for p in parts], 1).reshape(-1, top_k)
    hf = h.reshape(-1, d)
    ha = pvq.act(hf, qmax)
    up = mat(f"{at}/wi_up_experts", r, (experts, d, eff))
    gt = mat(f"{at}/wi_gate_experts", r, (experts, d, eff))
    dn = mat(f"{at}/wo_experts", r, (experts, eff, d))
    out = torch.zeros_like(hf)
    for e in range(experts):
        tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = ha[tok]
        ye = pvq.act(silu_gate(xe @ gt[e], xe @ up[e]), qmax) @ dn[e]
        out.index_add_(0, tok, ye * gate[tok, slot, None])
    del up, gt, dn
    out = out + _ffn(mat, f"{at}/shared", r, ha, d, eff * cfg["n_shared_experts"], qmax)
    return out.view(b, s, d)
