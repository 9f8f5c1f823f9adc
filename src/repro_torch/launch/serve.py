"""Batched serving entry point (port of ``repro.launch.serve``): prefill a batch
of prompts, then greedy-decode with the KV cache, optionally from packed
PVQ weights, int8 activations and a PVQ-compressed KV cache.

    python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 128 --gen 32 --pvq --act-int8 --kv-pvq \\
        --agreement-min 0.99
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --batch 4 --prompt-len 128 --gen 32 --pvq --act-int8 --agreement-min 0.99

It runs on the CUDA card unless ``--device cpu`` is given, and never drops
to the CPU by itself.  ``--agreement-min T`` also scores the same tokens on
the reference leg (f32 activations, dense KV cache: kernel v2 on the packed
weights) and exits 1 if teacher-forced top-1 agreement is below T.  The
JSON report adds ``kernel_launches`` (the CUDA launches of each kernel),
``v3_body_launches`` (kernel v3's launches by body: splitk, direct, mma),
``v2_body_launches`` (kernel v2's, the f32 leg's: direct, mma, splitk), the
packed MoE expert banks' bytes, and on a card the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from ..configs import get_config
from ..core.packed import _fit_group, expert_leaves, packed_stats, quantize_params
from ..core.quantize import (
    ActQuant,
    KVQuant,
    QuantPolicy,
    act_quant_scope,
    default_kv_quant,
    kv_quant_scope,
    set_default_act_quant,
    set_default_kv_quant,
)
from ..kernels import launches, reset_launches, v2_body_launches, v3_body_launches
from ..nn.models import build_model
from ..runtime import obs


def bucket_len(n: int, multiple: int) -> int:
    """Round ``n`` up to a positive multiple (the cache-length buckets)."""
    m = max(int(multiple), 1)
    return max(m, -(-int(n) // m) * m)


def serving_policy(cfg, n_over_k: float = 1.0) -> QuantPolicy:
    """The packing policy of ``serve --pvq``: the embedding at the config's
    embedding N/K ratio, every dense kernel at ``n_over_k``, ``ls`` scales."""
    return QuantPolicy(
        rules=(("embedding", cfg.pvq.n_over_k_embed, cfg.pvq.group),
               ("kernel|experts", n_over_k, cfg.pvq.group)),
        scale_mode="ls",
    )


def _expert_report(params) -> dict:
    """Weight-bytes report for the packed MoE expert banks (if any)."""
    ex = expert_leaves(params)
    if not ex:
        return {}
    packed_bytes = sum(leaf.nbytes_packed for leaf in ex.values())
    dense_bytes = sum(leaf.nbytes_dense for leaf in ex.values())
    return {
        "packed_expert_tensors": len(ex),
        "packed_expert_bytes": packed_bytes,
        "dense_expert_bytes": dense_bytes,
        "expert_compression_ratio": round(dense_bytes / max(packed_bytes, 1), 3),
    }


def _decode_bucket() -> int:
    kvq = default_kv_quant()
    return int(kvq.block) if kvq else 32


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, tokens: torch.Tensor, *, gen: int, cache_len: int,
             timings: Optional[dict] = None) -> torch.Tensor:
    """Greedy decode; tokens (b, s) -> (b, s + gen).  A ``timings`` dict
    receives ``prefill_s`` and ``decode_s`` (host clock, the device
    synchronized at the prefill/decode boundary and at the end)."""
    cache_len = bucket_len(cache_len, _decode_bucket())
    t0 = time.perf_counter()
    with obs.span("serve/generate", args={
        "batch": int(tokens.shape[0]), "gen": int(gen), "cache_len": cache_len,
    }):
        with obs.span("serve/prefill"):
            logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
        out = [tokens]
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        if timings is not None:
            _sync(tokens.device)
            t1 = time.perf_counter()
            timings["prefill_s"] = t1 - t0
        pos0 = tokens.shape[1]
        for i in range(gen):
            out.append(tok)
            logits, cache = model.decode_step(params, cache, tok, pos0 + i)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        if timings is not None:
            _sync(tokens.device)
            timings["decode_s"] = time.perf_counter() - t1
        return torch.cat(out, dim=1)


def teacher_forced_logits(model, params, seq: torch.Tensor, *, prompt_len: int) -> torch.Tensor:
    """Next-token logits along a FIXED sequence through the decode path:
    (b, seq_len - prompt_len, vocab) predicting positions prompt_len.."""
    with obs.span("serve/teacher_forced", args={
        "batch": int(seq.shape[0]), "seq_len": int(seq.shape[1]),
    }):
        cache_len = bucket_len(seq.shape[1], _decode_bucket())
        logits, cache = model.prefill(params, {"tokens": seq[:, :prompt_len]}, cache_len=cache_len)
        steps = [logits[:, -1, :]]
        for i in range(seq.shape[1] - prompt_len - 1):
            tok = seq[:, prompt_len + i : prompt_len + i + 1]
            logits, cache = model.decode_step(params, cache, tok, prompt_len + i)
            steps.append(logits[:, -1, :])
        return torch.stack(steps, dim=1)


def top1_agreement(logits_a, logits_b) -> dict:
    """Top-1 agreement of two logit tensors over the same contexts.

    Strict agreement is argmax equality.  The headline number also excuses
    a disagreement when the reference margin ``a[argmax a] - a[argmax b]``
    is at most the measured perturbation ``max |a - b|`` at that position
    AND below 5% of the reference logits' (population) std there.
    """
    a = torch.as_tensor(logits_a).to(torch.float32)
    b = torch.as_tensor(logits_b).to(device=a.device, dtype=torch.float32)
    pa = torch.argmax(a, dim=-1)
    pb = torch.argmax(b, dim=-1)
    strict = pa == pb
    noise = (a - b).abs().amax(dim=-1)
    margin = torch.gather(a, -1, pa[..., None])[..., 0] - torch.gather(a, -1, pb[..., None])[..., 0]
    tie_cap = 0.05 * torch.std(a, dim=-1, correction=0)
    agree = strict | ((margin <= noise) & (margin <= tie_cap))
    out = {
        "top1_agreement": float(agree.to(torch.float32).mean()),
        "top1_agreement_strict": float(strict.to(torch.float32).mean()),
        "ties_excused": int((agree & ~strict).sum()),
    }
    if obs.enabled():
        obs.counter("quality.tokens_total").add(int(strict.numel()))
        obs.counter("quality.tokens_agree").add(int(agree.sum()))
        obs.counter("quality.ties_excused").add(out["ties_excused"])
        obs.histogram("quality.ref_margin").record_many(margin.double().cpu().numpy().ravel())
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--pvq", action="store_true",
                    help="serve the packed PVQ artifact (int8 pulses streamed into the kernels)")
    ap.add_argument("--act-int8", action="store_true",
                    help="per-row int8 activations into the int8 x int8 kernel; requires --pvq")
    ap.add_argument("--kv-pvq", action="store_true",
                    help="PVQ-compress the decode KV cache (packed attention kernel)")
    ap.add_argument("--kv-block", type=int, default=32)
    ap.add_argument("--kv-group", type=int, default=32)
    ap.add_argument("--max-kv-bytes-ratio", type=float, default=0.35, metavar="R")
    ap.add_argument("--agreement-min", type=float, default=None, metavar="T")
    ap.add_argument("--n-over-k", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' (plain versions)")
    return ap


def run(argv=None, *, return_state: bool = False):
    """Parse ``argv``, serve, and return ``(report, exit_code)`` (plus, with
    ``return_state``, a dict holding the model, packed params, generated
    tokens and both legs' teacher-forced logits); the process quantization
    defaults are restored afterwards."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.act_int8 and not args.pvq:
        ap.error("--act-int8 quantizes the packed matmul activations; it requires --pvq")
    if args.agreement_min is not None and not (args.act_int8 or args.kv_pvq):
        ap.error("--agreement-min compares a quantized path against the f32 reference; "
                 "it requires --act-int8 and/or --kv-pvq")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain versions")
    if args.metrics_out:
        obs.set_enabled(True)
    prev_aq, prev_kvq = set_default_act_quant(None), set_default_kv_quant(None)
    try:
        report, rc, state = _serve(args)
        return (report, rc, state) if return_state else (report, rc)
    finally:
        set_default_act_quant(prev_aq)
        set_default_kv_quant(prev_kvq)
        if args.metrics_out:
            obs.write(args.metrics_out)


def main(argv=None) -> int:
    report, rc = run(argv)
    print(json.dumps(report))
    return rc


def _serve(args):
    """Returns ``(report, exit_code, state)``."""
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = model.init(args.seed, device=device)
    report = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if args.metrics_out:
        report["metrics_out"] = args.metrics_out
    reset_launches()

    if args.pvq:
        t0 = time.time()
        with obs.span("serve/pack"):
            # each dense leaf is released as soon as it is packed
            params = quantize_params(params, serving_policy(cfg, args.n_over_k))
            _sync(device)
        st = packed_stats(params)
        report["pvq_mode"] = "packed"
        report["pvq_tensors"] = st["packed_tensors"]
        report["packed_bytes"] = st["packed_bytes"]
        report["weight_compression_ratio"] = round(st["weight_compression_ratio"], 3)
        report["pvq_encode_s"] = round(time.time() - t0, 2)
        report.update(_expert_report(params))

    if args.act_int8:
        set_default_act_quant(ActQuant(mode="per_row"))
        report["act_quant"] = "int8:per_row"
    if args.kv_pvq:
        kvq = KVQuant(block=args.kv_block, group=args.kv_group)
        set_default_kv_quant(kvq)
        hd = cfg.resolved_head_dim
        g = _fit_group(kvq.group, hd)
        packed_bpt = 2 * (hd + 4 * (hd // g))
        dense_bpt = 2 * hd * 4
        report["kv_quant"] = f"pvq:block{kvq.block}:g{g}:k{kvq.k}"
        report["kv_bytes_per_token_per_head"] = packed_bpt
        report["kv_bytes_ratio_vs_f32"] = round(packed_bpt / dense_bpt, 3)
        if packed_bpt / dense_bpt > args.max_kv_bytes_ratio:
            report["kv_bytes_fail"] = (
                f"packed KV bytes ratio {packed_bpt / dense_bpt:.3f} > allowed {args.max_kv_bytes_ratio}"
            )
            return report, 1, {}

    gen = torch.Generator(device="cpu")
    gen.manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen).to(device)

    _sync(device)
    timings: dict = {}
    t0 = time.time()
    out = generate(model, params, tokens, gen=args.gen, cache_len=args.prompt_len + args.gen,
                   timings=timings)
    dt = time.time() - t0
    report.update({
        "arch": cfg.name, "batch": args.batch,
        "generated_shape": list(out.shape),
        "tokens_per_s": round(args.batch * args.gen / dt, 1),
        "wall_s": round(dt, 3),
        "prefill_s": round(timings["prefill_s"], 4),
        "decode_ms_per_step": round(1e3 * timings["decode_s"] / max(args.gen, 1), 3),
        "kernel_launches_generate": launches(),
    })

    rc = 0
    state = {"model": model, "params": params, "seq": out}
    if args.agreement_min is not None:
        lg_q = teacher_forced_logits(model, params, out, prompt_len=args.prompt_len)
        state["logits_q"] = lg_q
        with act_quant_scope(None), kv_quant_scope(None):
            lg_f = teacher_forced_logits(model, params, out, prompt_len=args.prompt_len)
        state["logits_f"] = lg_f
        ag = top1_agreement(lg_f, lg_q)
        report["logits_finite"] = bool(torch.isfinite(lg_q).all() and torch.isfinite(lg_f).all())
        report["act_int8_top1_agreement"] = round(ag["top1_agreement"], 4)
        report["act_int8_top1_agreement_strict"] = round(ag["top1_agreement_strict"], 4)
        report["act_int8_ties_excused"] = ag["ties_excused"]
        if ag["top1_agreement"] < args.agreement_min:
            report["agreement_fail"] = (
                f"top-1 agreement {ag['top1_agreement']:.4f} < required {args.agreement_min}"
            )
            rc = 1
    report["kernel_launches"] = launches()
    report["v3_body_launches"] = v3_body_launches()
    report["v2_body_launches"] = v2_body_launches()
    if device.type == "cuda":
        report["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return report, rc, state


if __name__ == "__main__":
    raise SystemExit(main())
