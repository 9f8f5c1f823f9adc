"""The dense decoder (SmolLM, the Llama layer layout) as served: PVQ
weights, int8 activations into every packed matmul and the tied head, and
attention whose keys and values before a cut are read from PVQ KV pages;
and as trained with PVQ-aware training (:func:`train_steps`).

The cut is per query position: the engine reads a context's complete
blocks from its pages (with the queries quantized to int8, as the packed
leg takes them) and the rest exactly.  Which blocks are pages when a query
reads them follows from how the context was scheduled, which the caller
passes as ``cuts``."""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.utils.checkpoint

from . import pvq
from .common import param_dtype, rms, rope, silu_gate

SEG = "segments/seg0/b0"


def forward(cfg: dict, ws, seqs: List[torch.Tensor], cuts: List[torch.Tensor],
            logits_from: List[int], qmax: int = 127) -> List[torch.Tensor]:
    """Teacher-forced logits ``(len - logits_from[i], vocab)`` of each
    sequence ``seqs[i]`` (token ids on the device) at its positions from
    ``logits_from[i]``.  ``qmax`` is the activations' integer range (127:
    int8)."""
    d, heads, kvh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // heads
    ff, vocab, layers = cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    srv = cfg["serving"]
    wq_cfg, kvq = srv["weights"], srv["kv_cache"]
    dt = param_dtype(cfg)

    def mat(name: str, layer: Optional[int], shape) -> torch.Tensor:
        return pvq.matmul_weight(ws.get(name, layer, shape, dt), wq_cfg["group"],
                                 wq_cfg["n_over_k"])

    emb = pvq.flat_weight(ws.get("embed/embedding", None, (vocab, d), dt), wq_cfg["group"],
                          wq_cfg["embedding_n_over_k"])
    xs = [emb[s] for s in seqs]
    for layer in range(layers):
        ln1 = ws.get(f"{SEG}/ln_mix/rms_scale", layer, (d,), dt)
        ln2 = ws.get(f"{SEG}/ln_ffn/rms_scale", layer, (d,), dt)
        wq = mat(f"{SEG}/mixer/wq/kernel", layer, (d, heads * hd))
        wk = mat(f"{SEG}/mixer/wk/kernel", layer, (d, kvh * hd))
        wv = mat(f"{SEG}/mixer/wv/kernel", layer, (d, kvh * hd))
        wo = mat(f"{SEG}/mixer/wo/kernel", layer, (heads * hd, d))
        wg = mat(f"{SEG}/ffn/wi_gate/kernel", layer, (d, ff))
        wu = mat(f"{SEG}/ffn/wi_up/kernel", layer, (d, ff))
        wd = mat(f"{SEG}/ffn/wo/kernel", layer, (ff, d))
        for i, x in enumerate(xs):
            s = x.shape[0]
            pos = torch.arange(s, device=x.device)
            h = pvq.act(rms(x, ln1, eps), qmax)
            q = rope((h @ wq).view(s, heads, hd), pos, theta)
            k = rope((h @ wk).view(s, kvh, hd), pos, theta)
            v = (h @ wv).view(s, kvh, hd)
            a = attention(q, k, v, cuts[i], kvq["group"], kvq["k"], qmax)
            x = x + pvq.act(a.reshape(s, heads * hd), qmax) @ wo
            h = pvq.act(rms(x, ln2, eps), qmax)
            x = x + pvq.act(silu_gate(h @ wg, h @ wu), qmax) @ wd
            xs[i] = x
        del wq, wk, wv, wo, wg, wu, wd
    fin = ws.get("final_norm/rms_scale", None, (d,), dt)
    return [pvq.act(rms(x[lo:], fin, eps), qmax) @ emb.T for x, lo in zip(xs, logits_from)]


def attention(q, k, v, cut, group: int, kv_k: int, qmax: int) -> torch.Tensor:
    """Causal GQA of one sequence: ``q (s, heads, hd)``, ``k``/``v`` ``(s,
    kv_heads, hd)``; key ``j`` of query ``t`` is read from its PVQ page
    (against the query quantized to ``qmax``) when ``j < cut[t]``."""
    s, heads, hd = q.shape
    gpr = heads // k.shape[1]
    kx, vx = k.repeat_interleave(gpr, 1), v.repeat_interleave(gpr, 1)
    kp = pvq.kv_pages(k, group, kv_k).repeat_interleave(gpr, 1)
    vp = pvq.kv_pages(v, group, kv_k).repeat_interleave(gpr, 1)
    scale = 1.0 / math.sqrt(hd)
    s_exact = torch.einsum("thd,jhd->htj", q, kx) * scale
    s_page = torch.einsum("thd,jhd->htj", pvq.act(q, qmax), kp) * scale
    j = torch.arange(s, device=q.device)
    paged = j[None, :] < cut[:, None]
    causal = j[None, :] <= j[:, None]
    sc = torch.where(paged, s_page, s_exact).masked_fill(~causal, -math.inf)
    p = torch.softmax(sc, dim=-1)
    pf = paged.to(p.dtype)
    return (torch.einsum("htj,jhd->thd", p * pf, vp)
            + torch.einsum("htj,jhd->thd", p * (1.0 - pf), vx))


# ---------------------------------------------------------------------------
# Training: the QAT loss and AdamW, as the configuration's ``training`` states
# ---------------------------------------------------------------------------


def train_leaves(cfg: dict) -> dict:
    """``{path: (shape, stacked)}`` of the trained parameters; a stacked
    leaf holds every layer (its first axis), made layer by layer."""
    d, heads, kvh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // heads
    ff, vocab, layers = cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    per_layer = {
        "ln_mix/rms_scale": (d,), "mixer/wq/kernel": (d, heads * hd),
        "mixer/wk/kernel": (d, kvh * hd), "mixer/wv/kernel": (d, kvh * hd),
        "mixer/wo/kernel": (heads * hd, d), "ln_ffn/rms_scale": (d,),
        "ffn/wi_gate/kernel": (d, ff), "ffn/wi_up/kernel": (d, ff), "ffn/wo/kernel": (ff, d),
    }
    out = {"embed/embedding": ((vocab, d), False)}
    out.update({f"{SEG}/{k}": ((layers, *v), True) for k, v in per_layer.items()})
    out["final_norm/rms_scale"] = ((d,), False)
    return out


def make_leaf(ws, path: str, shape, stacked: bool, dtype) -> torch.Tensor:
    if not stacked:
        return ws.get(path, None, shape, dtype)
    return torch.stack([ws.get(path, r, shape[1:], dtype) for r in range(shape[0])])


def projected(path: str) -> bool:
    """The leaves the QAT projection reaches: every matrix (the kernels and
    the embedding), not the norms' scales."""
    return path.endswith("/kernel") or path.endswith("embedding")


class _STE(torch.autograd.Function):
    """The PVQ projection forward, the identity backward."""

    @staticmethod
    def forward(ctx, w, group, k):
        rows = w.detach().reshape(-1, group)
        p, _ = pvq.encode(rows, k)
        pp = (p * p).sum(-1)
        rho = torch.where(pp > 0, rows.norm(dim=-1) / pp.clamp(min=1).sqrt(), torch.zeros_like(pp))
        return (p * rho[:, None]).reshape(w.shape)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class FP8MatMul(torch.autograd.Function):
    """``a @ b`` with both operands of the forward product and of each of
    the backward's two rounded to float8 e4m3, each tensor under one scale
    (its largest magnitude at the format's largest, 448): the control."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def train_loss(cfg: dict, w: dict, tokens: torch.Tensor, targets: torch.Tensor,
               matmul=None) -> torch.Tensor:
    """Mean cross-entropy of ``tokens (b, s)`` against ``targets`` with the
    weights ``w`` (f32), causal attention at every position; ``matmul``
    takes the place of every matrix product (the control's)."""
    d, heads, kvh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // heads
    eps, theta, layers = cfg["rms_norm_eps"], cfg["rope_theta"], cfg["num_hidden_layers"]
    mm = matmul or torch.matmul
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)
    causal = pos[None, :] <= pos[:, None]
    def layer(x, i):
        at = lambda name: w[f"{SEG}/{name}"][i]  # noqa: E731
        h = rms(x, at("ln_mix/rms_scale"), eps)
        q = rope(mm(h, at("mixer/wq/kernel")).view(b, s, heads, hd), pos, theta)
        k = rope(mm(h, at("mixer/wk/kernel")).view(b, s, kvh, hd), pos, theta)
        v = mm(h, at("mixer/wv/kernel")).view(b, s, kvh, hd)
        k, v = k.repeat_interleave(heads // kvh, 2), v.repeat_interleave(heads // kvh, 2)
        sc = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~causal, -math.inf), dim=-1)
        a = mm(p, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, heads * hd)
        x = x + mm(a, at("mixer/wo/kernel"))
        h = rms(x, at("ln_ffn/rms_scale"), eps)
        return x + mm(silu_gate(mm(h, at("ffn/wi_gate/kernel")), mm(h, at("ffn/wi_up/kernel"))),
                      at("ffn/wo/kernel"))

    x = w["embed/embedding"][tokens]
    for i in range(layers):
        # recomputed in the backward pass, so that one layer's activations
        # are held at a time
        x = torch.utils.checkpoint.checkpoint(layer, x, i, use_reentrant=False)
    logits = mm(rms(x, w["final_norm/rms_scale"], eps), w["embed/embedding"].T)
    return torch.nn.functional.cross_entropy(logits.reshape(b * s, -1), targets.reshape(-1))


def lr_at(opt: dict, step: int) -> float:
    """The cosine schedule: linear warm-up to ``lr``, then a cosine down to
    ``floor`` of it at ``total``."""
    peak, warm, total, floor = opt["lr"], opt["warmup"], opt["total"], opt["floor"]
    if step < warm:
        return peak * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


def train_steps(cfg: dict, ws, batches, opt: dict, matmul=None) -> dict:
    """AdamW on the QAT loss from the seed's weights, one step a batch
    (``(tokens, targets)``): every step projects each matrix onto the
    pyramid (``training.qat``: groups of the flattened leaf, ``k`` pulses,
    the ``paper`` scale ``||w|| / ||p||``) with the identity gradient,
    clips the gradients by their global norm, and adds the decay to the
    step on matrices only; parameters are stored in the stated dtype.
    Returns each step's loss and global gradient norm (before clipping),
    each leaf's first gradient as the optimizer takes it (after clipping)
    and its change over the steps, as norms."""
    tr = cfg["training"]
    dt = getattr(torch, tr["param_dtype"])
    group, k = tr["qat"]["group"], tr["qat"]["k"]
    params = {p: make_leaf(ws, p, shape, st, dt) for p, (shape, st) in train_leaves(cfg).items()}
    start = {p: v.clone() for p, v in params.items()}
    mu = {p: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for p, v in params.items()}
    nu = {p: torch.zeros_like(m) for p, m in mu.items()}
    losses, gnorms, grad1 = [], [], {}
    for step, (tokens, targets) in enumerate(batches, 1):
        lat = {p: v.to(torch.float32, copy=True).requires_grad_(True) for p, v in params.items()}
        w = {p: _STE.apply(v, group, k) if projected(p) else v for p, v in lat.items()}
        with torch.enable_grad():
            loss = train_loss(cfg, w, tokens, targets, matmul)
            grads = dict(zip(lat, torch.autograd.grad(loss, list(lat.values()))))
        del w, lat
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        gnorms.append(float(gnorm))
        clip = torch.clamp(opt["clip_norm"] / gnorm.clamp(min=1e-12), max=1.0)
        b1c, b2c, lr = 1.0 - opt["b1"] ** step, 1.0 - opt["b2"] ** step, lr_at(opt, step)
        for p, g in grads.items():
            g = g * clip
            if step == 1:
                grad1[p] = float(g.norm())
            mu[p].mul_(opt["b1"]).add_((1.0 - opt["b1"]) * g)
            nu[p].mul_(opt["b2"]).add_((1.0 - opt["b2"]) * g * g)
            delta = (mu[p] / b1c) / (torch.sqrt(nu[p] / b2c) + opt["eps"])
            if params[p].ndim >= 2:
                delta = delta + opt["weight_decay"] * params[p].to(torch.float32)
            params[p] = (params[p].to(torch.float32) - lr * delta).to(dt)
        del grads
    change = {p: float((params[p].to(torch.float32) - start[p].to(torch.float32)).norm())
              for p in params}
    return {"loss": losses, "grad_norm": gnorms, "grad1": grad1, "change": change}
