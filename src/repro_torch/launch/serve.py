"""Batched serving entry point (port of ``repro.launch.serve``): prefill a batch
of prompts, then greedy-decode with the KV cache, optionally from packed
PVQ weights, int8 activations and a PVQ-compressed KV cache.

    python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 128 --gen 32 --pvq --act-int8 --kv-pvq \\
        --agreement-min 0.99
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --batch 4 --prompt-len 128 --gen 32 --pvq --act-int8 --agreement-min 0.99

``--engine`` (with ``--kv-pvq``) serves a Poisson request trace through the
continuous-batching engine (``launch.engine``) instead, times the
fixed-batch ``generate`` loop run sequentially over the same trace, and
with ``--agreement-min`` scores every engine token against that fixed-batch
oracle (``engine_token_agreement``)::

    python -m repro_torch.launch.serve --arch smollm-360m --engine \
        --engine-slots 4 --requests 8 --rate 0 --prompt-len 128 --gen 32 \
        --pvq --act-int8 --kv-pvq --prefill-chunk 4 --shared-prefix 128 \
        --agreement-min 0.99 --min-prefix-hits 1

It runs on the CUDA card unless ``--device cpu`` is given, and never drops
to the CPU by itself.  On the card every decode step, the fixed-batch
loop's and the engine's, is a replay of a captured CUDA graph of
``Model.decode_step`` (the counterpart of the reference's jitted step),
and so are the engine's prefill, graft and chunk steps;
``TRACE_COUNTS["decode_step"]`` and the counter
``serve.decode_step_traces`` count the fixed-batch loop's captures, and
the report's ``decode_step_captures`` holds the count of this run,
``engine_trace_counts`` the engine's (the reference's keys) and
``engine_warmup_trace_counts`` those its warm-up made.  On the CPU the
same steps run eagerly; ``generate``, ``teacher_forced_logits`` and
``PVQEngine`` take ``eager=True`` for the host-index steps (a
comparison's other leg).

``--artifact model.pvqz`` (written by ``repro_torch.launch.export``) skips
the encode: the entropy-coded file is decoded leaf by leaf on the host
straight into ``PackedPVQ`` on the device, identical pulses and scales, no
re-encode, and served through the same packed path, so the logits equal
those of the in-memory ``--pvq`` parameters it was exported from.
``--pvq`` packs each part of the model as soon as it is built
(``Model.init(pack=...)``, the same bytes as packing the whole dense init),
so the dense model never exists whole on the card: jamba-1.5-large-398b's
super-block is ~88 GB in bf16 and ~46 GB packed.
``--pvq-sim`` encodes and expands every matching leaf back to dense
(``quantize_tree``: the paper tables' numerics, none of the memory win).

``--tune`` pre-tunes the kernels' choices for this configuration's GEMM
and kernel-v4 shapes (the reference's shape set, ``tune_config``) into the
autotuner's cache (``REPRO_TORCH_PVQ_TUNE_CACHE``) before the first step,
so every later dispatch, and every captured graph, takes them; the report
adds ``tuned_tiles``, ``tune_cache``, ``tune_wall_s`` and ``tune_stats``.

``--agreement-min T`` also scores the same tokens on the reference leg
(f32 activations, dense KV cache: kernel v2 on the packed weights) and
exits 1 if teacher-forced top-1 agreement is below T.  The
JSON report adds ``kernel_launches`` (the CUDA launches of each kernel),
``v3_body_launches`` (kernel v3's launches by body: splitk, direct, mma),
``v2_body_launches`` (kernel v2's, the f32 leg's: direct, mma, splitk), the
packed MoE expert banks' bytes, and on a card the peak device memory.  A
replayed graph adds the launches its capture recorded
(``launch.capture``), so the counts are the card's launches, the same for
a captured run as for an eager one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import weakref
from typing import Dict, Optional

import torch

from ..configs import get_config
from ..core.packed import (
    _fit_group,
    expert_leaves,
    is_packed_kv,
    matmul_plan,
    packed_stats,
)
from ..core.quantize import (
    ActQuant,
    KVQuant,
    QuantPolicy,
    act_quant_scope,
    default_act_quant,
    default_kv_quant,
    kv_quant_scope,
    quantize_tree,
    set_default_act_quant,
    set_default_kv_quant,
    total_bits,
)
from ..kernels import launches, reset_launches, v2_body_launches, v3_body_launches
from ..nn.models import build_model
from ..runtime import obs
from .capture import CapturedStep
from .engine import bucket_len, check_engine_model, param_device

# Captures of the fixed-batch decode step (the reference counts its jit's
# traces here): a second generate() of the same shape captures nothing.
TRACE_COUNTS: dict = {"decode_step": 0}
_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


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


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` of a parameter or cache tree: dicts, lists and
    dataclasses (``PackedPVQ``, ``PackedKV``) are walked."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{path}/{i}")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}/{f.name}")
    else:
        yield path, tree


def _step_key(params, cache) -> tuple:
    """What a capture bakes in: the parameters' addresses and shapes, the
    active ``ActQuant`` and ``KVQuant`` (so the f32 leg gets its own graph,
    never the int8 one), and the cache's kinds and shapes (batch and the
    bucketed ``cache_len``)."""
    p = tuple((path, t.data_ptr(), tuple(t.shape)) for path, t in _leaves(params)
              if isinstance(t, torch.Tensor))
    c = tuple((path, tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else (path, t)
              for path, t in _leaves(cache))
    return p, default_act_quant(), default_kv_quant(), c


def _fill_block(cache) -> Optional[int]:
    """The block of the cache's ``PackedKV`` layers (None without one): a
    lockstep step at ``pos`` with ``(pos + 1) % block == 0`` encodes one."""
    stack = [cache]
    while stack:
        c = stack.pop()
        if is_packed_kv(c):
            return c.block
        if isinstance(c, dict):
            stack.extend(c.values())
        elif isinstance(c, list):
            stack.extend(c)
    return None


def _write_back(static, new) -> None:
    """Copy the tensors of a step's new cache that are not the static
    cache's own into the static cache's (the recurrent states: Mamba's
    ``conv`` and ``ssm``, RWKV's ``rwkv_*``, which a decode step returns as
    new tensors where the attention caches are written in place)."""
    for (_, dst), (_, src) in zip(_leaves(static), _leaves(new)):
        if isinstance(dst, torch.Tensor) and src is not dst:
            dst.copy_(src)


class _StaticStep:
    """One shape of the lockstep decode step: static token and position
    buffers and the cache they decode over (the first prefill's of this
    key, kept; a later prefill is copied into it), and on a card up to two
    captured graphs, without and with a KV block fill (``fill``).  The
    step writes every new state into the static cache, inside the captured
    body, so each replay reads the last one's."""

    def __init__(self, params, cache, batch: int, device):
        self.params, self.cache = params, cache
        self.tok = torch.zeros((batch, 1), dtype=torch.int64, device=device)
        self.pos = torch.zeros((batch,), dtype=torch.int64, device=device)
        self.graphs: Dict[bool, CapturedStep] = {}

    def load(self, cache) -> None:
        for (_, dst), (_, src) in zip(_leaves(self.cache), _leaves(cache)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def _body(self, model, fill: bool):
        logits, new_cache = model.decode_step(self.params, self.cache, self.tok, self.pos,
                                              fill=fill)
        _write_back(self.cache, new_cache)
        return logits, torch.argmax(logits[:, -1, :], dim=-1)[:, None]

    def run(self, model, tok: torch.Tensor, pos: int, fill: bool):
        """``(logits (b, 1, vocab), next token (b, 1))`` of the step feeding
        ``tok`` at ``pos``; from a graph, they hold until the next replay."""
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        if self.tok.device.type != "cuda":
            return self._body(model, fill)
        graph = self.graphs.get(fill)
        if graph is not None:
            return graph.replay()
        graph = self.graphs[fill] = CapturedStep(lambda: self._body(model, fill), self.tok.device)
        TRACE_COUNTS["decode_step"] += 1
        obs.counter("serve.decode_step_traces").inc()
        return graph.out


def _captured_step(model) -> Dict[tuple, _StaticStep]:
    """The model's captured decode steps by :func:`_step_key` (the
    counterpart of the reference's one ``_jit_step`` per model); they live
    as long as the model."""
    steps = _STEPS.get(model)
    if steps is None:
        steps = _STEPS[model] = {}
    return steps


def _lockstep(model, params, cache, tokens: torch.Tensor, *, eager: bool):
    """``step(tok (b, 1), pos) -> (logits, next token)`` over the prefill's
    ``cache``: on a card the captured step (a new key captures, a known one
    takes the cache into its static one), on the CPU the same device-position
    step run eagerly, with ``eager`` the host-int ``Model.decode_step``."""
    if eager:
        state = [cache]

        def step(tok, pos):
            logits, state[0] = model.decode_step(params, state[0], tok, pos)
            return logits, torch.argmax(logits[:, -1, :], dim=-1)[:, None]

        return step
    batch, device = tokens.shape[0], tokens.device
    if device.type == "cuda":
        steps = _captured_step(model)
        key = _step_key(params, cache)
        static = steps.get(key)
        if static is None:
            static = steps[key] = _StaticStep(params, cache, batch, device)
        else:
            static.load(cache)
    else:
        static = _StaticStep(params, cache, batch, device)
    blk = _fill_block(cache)

    def step(tok, pos):
        return static.run(model, tok, pos, blk is not None and (pos + 1) % blk == 0)

    return step


def _prefix_len(batch: dict) -> int:
    """A VLM's patch prefix: the rows of the cache before the first token."""
    return int(batch["patches"].shape[1]) if "patches" in batch else 0


def generate(model, params, tokens: torch.Tensor, *, gen: int, cache_len: int,
             extra_batch: Optional[dict] = None, timings: Optional[dict] = None,
             eager: bool = False, step_logits: Optional[list] = None) -> torch.Tensor:
    """Greedy decode; tokens (b, s) -> (b, s + gen).  ``extra_batch`` holds
    an enc-dec model's ``frames`` or a VLM's ``patches``; a VLM decodes
    at positions after its patch prefix (the reference's ``generate``
    does not: it decodes at ``s + i``, over the prefix's cache rows).
    Each decode step is a replay of the model's captured step on a card,
    and that step run eagerly on the CPU; ``eager=True`` runs the host-int
    step instead.  ``cache_len`` is rounded up to the KV block, so the
    prompt lengths of a bucket share one capture.  A ``timings`` dict
    receives ``prefill_s`` and ``decode_s`` (host clock, the device
    synchronized at the prefill/decode boundary and at the end); a
    ``step_logits`` list receives each decode step's logits ``(b, vocab)``."""
    cache_len = bucket_len(cache_len, _decode_bucket())
    t0 = time.perf_counter()
    with obs.span("serve/generate", args={
        "batch": int(tokens.shape[0]), "gen": int(gen), "cache_len": cache_len,
    }):
        batch = {"tokens": tokens, **(extra_batch or {})}
        with obs.span("serve/prefill"):
            logits, cache = model.prefill(params, batch, cache_len=cache_len)
        out = [tokens]
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        if timings is not None:
            _sync(tokens.device)
            t1 = time.perf_counter()
            timings["prefill_s"] = t1 - t0
        step = _lockstep(model, params, cache, tokens, eager=eager)
        del logits, cache
        pos0 = _prefix_len(batch) + tokens.shape[1]
        for i in range(gen):
            out.append(tok)
            logits, tok = step(tok, pos0 + i)
            tok = tok.clone()  # a graph's output: the next replay overwrites it
            if step_logits is not None:
                step_logits.append(logits[:, -1, :].clone())
        if timings is not None:
            _sync(tokens.device)
            timings["decode_s"] = time.perf_counter() - t1
        return torch.cat(out, dim=1)


def teacher_forced_logits(model, params, seq: torch.Tensor, *, prompt_len: int,
                          extra_batch: Optional[dict] = None, eager: bool = False) -> torch.Tensor:
    """Next-token logits along a FIXED sequence through the decode path (the
    captured step on a card, ``eager`` as for :func:`generate`, a VLM's
    positions after its prefix as there):
    (b, seq_len - prompt_len, vocab) predicting positions prompt_len.."""
    with obs.span("serve/teacher_forced", args={
        "batch": int(seq.shape[0]), "seq_len": int(seq.shape[1]),
    }):
        cache_len = bucket_len(seq.shape[1], _decode_bucket())
        batch = {"tokens": seq[:, :prompt_len], **(extra_batch or {})}
        logits, cache = model.prefill(params, batch, cache_len=cache_len)
        steps = [logits[:, -1, :]]
        step = _lockstep(model, params, cache, seq, eager=eager)
        del cache
        pos0 = _prefix_len(batch) + prompt_len
        for i in range(seq.shape[1] - prompt_len - 1):
            tok = seq[:, prompt_len + i : prompt_len + i + 1]
            logits, _ = step(tok, pos0 + i)
            steps.append(logits[:, -1, :].clone())  # a graph's output, as above
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


def engine_token_agreement(model, params, requests, outputs) -> dict:
    """Token-level agreement of the engine with the fixed-batch decode
    oracle: each request's prompt and engine output are teacher-forced
    through the fixed-batch path (prefill and lockstep ``decode_step``,
    same quantized contracts) and each engine token is compared with the
    oracle's argmax on the identical context.  A disagreement is excused
    when the oracle calls it a near-tie: its margin over the engine's pick
    is at most 5% of the logits' (population) std."""
    agree = total = excused = 0
    device = param_device(params)
    for req in requests:
        gen = outputs.get(req.rid)
        if not gen:
            continue
        seq = torch.tensor([list(req.prompt) + list(gen)], dtype=torch.int64, device=device)
        lg = teacher_forced_logits(model, params, seq, prompt_len=len(req.prompt))[0]
        lg = lg.to(torch.float32)
        oracle = torch.argmax(lg, dim=-1)
        toks = torch.tensor(gen, dtype=torch.int64, device=lg.device)
        match = oracle == toks
        margin = (torch.gather(lg, -1, oracle[:, None])[:, 0]
                  - torch.gather(lg, -1, toks[:, None])[:, 0])
        tie = margin <= 0.05 * torch.std(lg, dim=-1, correction=0)
        n_agree = int((match | tie).sum())
        n_excused = int((~match & tie).sum())
        agree += n_agree
        excused += n_excused
        total += len(gen)
        if obs.enabled():
            obs.counter("quality.tokens_total").add(len(gen))
            obs.counter("quality.tokens_agree").add(n_agree)
            obs.counter("quality.ties_excused").add(n_excused)
            obs.gauge("quality.agreement_running").set(agree / max(total, 1))
    return {
        "engine_token_agreement": agree / max(total, 1),
        "engine_tokens_compared": total,
        "engine_ties_excused": excused,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--pvq", action="store_true",
                    help="serve the packed PVQ artifact (int8 pulses streamed into the kernels)")
    ap.add_argument("--pvq-sim", action="store_true",
                    help="dequantized simulation: encode, then expand back to dense "
                    "(paper-table numerics, no memory win)")
    ap.add_argument("--artifact", default=None, metavar="MODEL.PVQZ",
                    help="serve a .pvqz artifact (repro_torch.launch.export): the entropy-coded "
                    "pulses decode leaf by leaf into PackedPVQ with no re-encode")
    ap.add_argument("--act-int8", action="store_true",
                    help="per-row int8 activations into the int8 x int8 kernel; requires --pvq "
                    "or --artifact")
    ap.add_argument("--kv-pvq", action="store_true",
                    help="PVQ-compress the decode KV cache (packed attention kernel)")
    ap.add_argument("--kv-block", type=int, default=32)
    ap.add_argument("--kv-group", type=int, default=32)
    ap.add_argument("--max-kv-bytes-ratio", type=float, default=0.35, metavar="R")
    ap.add_argument("--agreement-min", type=float, default=None, metavar="T")
    ap.add_argument("--n-over-k", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tune", action="store_true",
                    help="pre-tune the kernels' bodies, splitk chunks and v4 plans for this "
                    "configuration's GEMM and attention shapes into the autotuner's cache "
                    "(REPRO_TORCH_PVQ_TUNE_CACHE); every later dispatch takes them")
    ap.add_argument("--metrics-out", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' (plain versions)")
    ap.add_argument("--engine", action="store_true",
                    help="serve a Poisson request trace through the continuous-batching "
                    "engine (paged PVQ KV cache); requires --kv-pvq.  Also times the "
                    "fixed-batch generate() loop run sequentially over the same trace")
    ap.add_argument("--engine-slots", type=int, default=4,
                    help="with --engine: decode slot-pool size")
    ap.add_argument("--engine-pages", type=int, default=None,
                    help="with --engine: physical KV pages (default slots x max_pages; "
                    "fewer oversubscribes the pool and exercises eviction)")
    ap.add_argument("--requests", type=int, default=16, help="with --engine: trace length")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="with --engine: Poisson arrival rate (req/s); 0 or inf: all at t=0")
    ap.add_argument("--min-speedup", type=float, default=None, metavar="S",
                    help="with --engine: exit 1 if engine tokens/s is below S x the "
                    "sequential fixed-batch baseline")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="P",
                    help="with --engine: prompts longer than P pages stream in P-page "
                    "chunks interleaved with decode; also enables the prefix page cache")
    ap.add_argument("--prefill-batch", type=int, default=1, metavar="B",
                    help="with --engine: admit up to B same-bucket waiting requests "
                    "through one prefill")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="with --engine --prefill-chunk: disable the shared-prefix page cache")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="with --engine: prepend one common N-token prefix to every prompt")
    ap.add_argument("--min-prefix-hits", type=int, default=None, metavar="H",
                    help="with --engine: exit 1 if the prefix page cache recorded fewer "
                    "than H page hits")
    return ap


def run(argv=None, *, return_state: bool = False):
    """Parse ``argv``, serve, and return ``(report, exit_code)`` (plus, with
    ``return_state``, a dict holding the model, packed params, generated
    tokens and both legs' teacher-forced logits, or with ``--engine`` what
    ``_serve_engine`` returns); the process quantization defaults and the
    telemetry switch are restored afterwards."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.act_int8 and not (args.pvq or args.artifact):
        ap.error("--act-int8 quantizes the packed matmul activations; "
                 "it requires --pvq or --artifact")
    if args.agreement_min is not None and not (args.act_int8 or args.kv_pvq):
        ap.error("--agreement-min compares a quantized path against the f32 reference; "
                 "it requires --act-int8 and/or --kv-pvq")
    if args.engine and not args.kv_pvq:
        ap.error("--engine pages the PVQ-compressed KV cache (page = kv block); "
                 "it requires --kv-pvq")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain versions")
    prev_obs = obs.set_enabled(True) if args.metrics_out else None
    prev_aq, prev_kvq = set_default_act_quant(None), set_default_kv_quant(None)
    try:
        report, rc, state = _serve(args)
        return (report, rc, state) if return_state else (report, rc)
    finally:
        set_default_act_quant(prev_aq)
        set_default_kv_quant(prev_kvq)
        if args.metrics_out:
            obs.write(args.metrics_out)
            obs.set_enabled(prev_obs)


def main(argv=None) -> int:
    report, rc = run(argv)
    print(json.dumps(report))
    return rc


def tune_config(cfg, args, device) -> dict:
    """``--tune``: the autotuner over the reference's shape set for ``cfg``
    and the serve flags in ``args``: the decode (m = batch) and prefill (m
    = batch x prompt) GEMMs of a block; with ``--engine`` the slot pool's,
    the chunk's and the batched admission's; the MoE dispatch GEMMs
    (expert-batched here, so their keys carry the expert count); each for
    f32 activations and, with ``--act-int8``, int8; with ``--kv-pvq``
    kernel v4's decode shape and the engine's.  Beyond the reference's set:
    the decode GEMMs of the attention projections whose width is not d
    (K/V of GQA and MQA, a q of ``n_heads x hd != d``), and a VLM's v4
    planes count its patch prefix.  Returns the report's ``tuned_tiles``
    (the reference's key strings), ``tune_cache``, ``tune_wall_s`` and
    ``tune_stats``."""
    from ..kernels import autotune
    from ..nn.moe import dispatch_gemm_rows

    t_tune = time.time()
    autotune.reset_tune_stats()
    d_model = cfg.d_model
    d_ff = getattr(cfg, "d_ff", 0) or 4 * d_model
    group = cfg.pvq.group or 128
    shapes = {
        (args.batch, d_model, d_model),
        (args.batch, d_model, d_ff),
        (args.batch, d_ff, d_model),
        (args.batch * args.prompt_len, d_model, d_ff),
    }
    # the attention projections' own widths where they are not d (gemma's
    # one KV head of 256, starcoder2's four of 128)
    hd = cfg.resolved_head_dim
    if cfg.mla is None:
        shapes |= {(args.batch, d_model, cfg.n_kv_heads * hd),
                   (args.batch, cfg.n_heads * hd, d_model)}
    if args.engine:
        shapes |= {(args.engine_slots, d_model, d_model), (args.engine_slots, d_model, d_ff),
                   (args.engine_slots, d_ff, d_model)}
        if args.prefill_chunk:
            c_tok = args.prefill_chunk * max(args.kv_block, 1)
            shapes |= {(c_tok, d_model, d_model), (c_tok, d_model, d_ff), (c_tok, d_ff, d_model)}
        if args.prefill_batch > 1:
            b_tok = args.prefill_batch * bucket_len(
                max(args.shared_prefix + args.prompt_len, 1), max(args.kv_block, 1))
            shapes.add((b_tok, d_model, d_ff))
    experts = set()
    if cfg.moe is not None:
        mo = cfg.moe
        for t in (args.batch, args.batch * args.prompt_len):
            m_exp = dispatch_gemm_rows(mo, t)
            experts |= {(m_exp, d_model, mo.d_expert), (m_exp, mo.d_expert, d_model)}
    tuned = {}
    fields = ("body", "chunk", "us")
    for m, k, n in sorted(shapes | experts):
        g, k_pad = matmul_plan(group, k)
        for e in ([None] if (m, k, n) in shapes else []) + (
                [cfg.moe.n_experts] if (m, k, n) in experts else []):
            ent = autotune.autotune(m, k_pad, n, group=g, e=e, device=device)
            tuned[f"{m}x{k_pad}x{n}"] = {f: ent[f] for f in fields}
            if args.act_int8:
                ent = autotune.autotune(m, k_pad, n, group=g, dtype=torch.int8, e=e,
                                        device=device)
                tuned[f"{m}x{k_pad}x{n}:int8"] = {f: ent[f] for f in fields}
    if args.kv_pvq:
        hd = cfg.resolved_head_dim
        g = _fit_group(args.kv_group, hd)
        blk = max(args.kv_block, 1)
        m_q = max(cfg.n_heads // cfg.n_kv_heads, 1)
        # a VLM's planes also hold its patch prefix
        s_planes = -(-(cfg.prefix_len + args.prompt_len) // blk) * blk + args.gen
        # v4 over the lockstep batch's rows, the slot pool's, one slot's chunk
        ea = autotune.autotune_attn(m_q, hd, s_planes, group=g, device=device,
                                    bh=args.batch * cfg.n_kv_heads)
        tuned[f"attn{m_q}x{hd}x{s_planes}:int8"] = {f: ea[f] for f in ("km", "w", "us")}
        if args.engine:
            s_pool = bucket_len(args.shared_prefix + args.prompt_len + args.gen, blk)
            attn_shapes = [(m_q, hd, s_pool, args.engine_slots * cfg.n_kv_heads)]
            if args.prefill_chunk:
                attn_shapes.append((args.prefill_chunk * blk * m_q, hd, s_pool, cfg.n_kv_heads))
            autotune.tune_attn_shapes(attn_shapes, group=g, device=device)
            for mm_, _, ss, bh in attn_shapes:
                ent = autotune.autotune_attn(mm_, hd, ss, group=g, device=device, bh=bh)
                tuned[f"attn{mm_}x{hd}x{ss}:int8:engine"] = {f: ent[f] for f in ("km", "w", "us")}
    return {"tuned_tiles": tuned, "tune_cache": str(autotune.cache_path()),
            "tune_wall_s": round(time.time() - t_tune, 2), "tune_stats": autotune.tune_stats()}


def _load_artifact(path: str, params, device, report: dict):
    """``--artifact``: ``params`` (the model's init, for its structure,
    dtypes and devices) with every leaf from the ``.pvqz`` at ``path``.
    The wall of the load (host decode and the copies to the device) is the
    ``artifact/cold_start`` span, the gauge ``artifact.cold_start_s`` and
    the report's ``artifact_decode_s``; with telemetry on, the report also
    gets each codec's decode rate (``artifact_decode_mb_s``)."""
    import os

    from ..checkpoint.artifact import load_pvqz, read_toc

    t0 = time.time()
    with obs.span("artifact/cold_start", args={"path": path}):
        params = load_pvqz(path, target=params, device=device)
        _sync(device)
    cold_s = time.time() - t0
    # entropy=False: the at-rest bits/weight is in the export report and
    # the TOC; re-pricing every pulse stream at startup would double the cost
    st = packed_stats(params, entropy=False)
    report["pvq_mode"] = "artifact"
    report["artifact"] = path
    report["artifact_bytes"] = os.path.getsize(path)
    report["artifact_meta"] = read_toc(path).get("meta", {})
    report["pvq_tensors"] = st["packed_tensors"]
    report["artifact_decode_s"] = round(cold_s, 2)
    if obs.enabled():
        obs.gauge("artifact.cold_start_s").set(cold_s)
        # the per-codec throughput counters, folded into the startup report
        snap = {(m["name"], m["labels"].get("codec")): m["value"]
                for m in obs.registry().snapshot()
                if m["name"].startswith("artifact.decode_") and m["kind"] == "counter"}
        mbps = {}
        for (name, codec), sym in snap.items():
            if name != "artifact.decode_symbols":
                continue
            secs = snap.get(("artifact.decode_s", codec), 0.0)
            if secs:
                mbps[codec] = round(sym / secs / 1e6, 1)
        if mbps:
            report["artifact_decode_mb_s"] = mbps
    report.update(_expert_report(params))
    return params


def stub_inputs(cfg, batch: int, length: int, seed: int, device) -> dict:
    """The stub frontends' inputs, standard normal from ``seed`` as the
    reference's serve makes them (there from the prompt's key): an enc-dec
    model's ``frames`` ``(batch, length, d)``, a VLM's ``patches``
    ``(batch, prefix_len, d)``; else empty."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    if cfg.family == "encdec":
        return {"frames": torch.randn((batch, length, cfg.d_model), generator=gen).to(device)}
    if cfg.family == "vlm":
        return {"patches": torch.randn((batch, cfg.prefix_len, cfg.d_model),
                                       generator=gen).to(device)}
    return {}


def _serve(args):
    """Returns ``(report, exit_code, state)``."""
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.engine:
        check_engine_model(cfg)
    model = build_model(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    # --pvq packs each block as soon as it is built (Model.init's pack): the
    # dense model never exists whole on the card
    pack = (serving_policy(cfg, args.n_over_k)
            if args.pvq and not (args.pvq_sim or args.artifact) else None)
    t_init = time.time()
    with obs.span("serve/pack" if pack is not None else "serve/init"):
        params = model.init(args.seed, device=device, pack=pack)
        _sync(device)
    init_s = time.time() - t_init
    report = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if args.metrics_out:
        report["metrics_out"] = args.metrics_out
    if args.tune:
        report.update(tune_config(cfg, args, device))

    if args.artifact:
        params = _load_artifact(args.artifact, params, device, report)
    elif args.pvq_sim:
        t0 = time.time()
        params, codes, _ = quantize_tree(params, serving_policy(cfg, args.n_over_k))
        _sync(device)
        report["pvq_mode"] = "dequant-sim"
        report["pvq_tensors"] = len(codes)
        report.update({k: round(v, 3) for k, v in total_bits(codes).items()
                       if "ratio" in k or "bits_per" in k})
        report["pvq_encode_s"] = round(time.time() - t0, 2)
    elif args.pvq:
        # entropy=False: pricing every pulse stream is the export's work
        st = packed_stats(params, entropy=False)
        report["pvq_mode"] = "packed"
        report["pvq_tensors"] = st["packed_tensors"]
        report["packed_bytes"] = st["packed_bytes"]
        report["weight_compression_ratio"] = round(st["weight_compression_ratio"], 3)
        report.update(_expert_report(params))
        # the init's wall: its random draws and the packing interleave
        report["pvq_encode_s"] = round(init_s, 2)

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

    if args.engine:
        return _serve_engine(args, cfg, model, params, report, device)

    gen = torch.Generator(device="cpu")
    gen.manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen).to(device)
    extra = stub_inputs(cfg, args.batch, args.prompt_len, args.seed + 1, device)

    _sync(device)
    timings: dict = {}
    captures0 = TRACE_COUNTS["decode_step"]
    t0 = time.time()
    out = generate(model, params, tokens, gen=args.gen, cache_len=args.prompt_len + args.gen,
                   extra_batch=extra, timings=timings)
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
    state = {"model": model, "params": params, "seq": out, "extra_batch": extra}
    if args.agreement_min is not None:
        lg_q = teacher_forced_logits(model, params, out, prompt_len=args.prompt_len,
                                     extra_batch=extra)
        state["logits_q"] = lg_q
        with act_quant_scope(None), kv_quant_scope(None):
            lg_f = teacher_forced_logits(model, params, out, prompt_len=args.prompt_len,
                                         extra_batch=extra)
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
    report["decode_step_captures"] = TRACE_COUNTS["decode_step"] - captures0
    report["kernel_launches"] = launches()
    report["v3_body_launches"] = v3_body_launches()
    report["v2_body_launches"] = v2_body_launches()
    if device.type == "cuda":
        report["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return report, rc, state


def _serve_engine(args, cfg, model, params, report, device):
    """``--engine``: the trace through ``PVQEngine``, then the fixed-batch
    baseline (``generate`` over the same trace, one request at a time,
    warmed on one request of each cache-length bucket, so that its
    captures stay out of the timed loop, as the engine's warm-up keeps
    its own out of the engine's), then the gates.  Returns ``(report,
    exit_code, state)``; ``state`` holds the model, params, trace, the
    engine (its cache and ``trace_counts``), its outputs and its
    constructor arguments."""
    from .engine import PVQEngine, poisson_trace

    max_len = bucket_len(args.shared_prefix + args.prompt_len + args.gen, args.kv_block)
    trace = poisson_trace(
        args.requests, rate=args.rate, vocab=cfg.vocab_size,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        max_new=args.gen, seed=args.seed + 2, shared_prefix=args.shared_prefix,
    )
    engine_kwargs = dict(
        n_slots=args.engine_slots, max_len=max_len, n_pages=args.engine_pages,
        prefill_chunk=args.prefill_chunk, prefill_batch=args.prefill_batch,
        prefix_cache=not args.no_prefix_cache,
    )
    eng = PVQEngine(model, params, **engine_kwargs)
    eng.warmup(prompt_lens=[len(r.prompt) for r in trace])
    warm_counts = dict(eng.trace_counts)
    _sync(device)
    launches_before = launches()
    res = eng.run(trace)
    engine_launches = {k: v - launches_before[k] for k, v in launches().items()}
    outputs = res.pop("outputs")
    report["arch"] = cfg.name
    report.update({f"engine_{k}": v for k, v in res.items()})
    report["engine_kernel_launches"] = engine_launches
    report["engine_warmup_trace_counts"] = warm_counts
    captures0 = TRACE_COUNTS["decode_step"]

    prompts = {r.rid: torch.tensor([r.prompt], dtype=torch.int64, device=device) for r in trace}
    buckets = {bucket_len(len(r.prompt) + args.gen, _decode_bucket()): r for r in trace}
    for r in buckets.values():
        generate(model, params, prompts[r.rid], gen=args.gen, cache_len=len(r.prompt) + args.gen)
    _sync(device)
    t0 = time.time()
    base_tokens = 0
    for r in trace:
        out = generate(model, params, prompts[r.rid], gen=args.gen,
                       cache_len=len(r.prompt) + args.gen)
        base_tokens += out.shape[1] - len(r.prompt)
    _sync(device)
    base_dt = time.time() - t0
    report["baseline_tokens_per_s"] = round(base_tokens / max(base_dt, 1e-9), 2)
    report["baseline_wall_s"] = round(base_dt, 2)
    speedup = res["tokens_per_s"] / max(report["baseline_tokens_per_s"], 1e-9)
    report["engine_speedup_vs_fixed_batch"] = round(speedup, 3)

    rc = 0
    if args.agreement_min is not None:
        ag = engine_token_agreement(model, params, trace, outputs)
        report["engine_token_agreement"] = round(ag["engine_token_agreement"], 4)
        report["engine_tokens_compared"] = ag["engine_tokens_compared"]
        report["engine_ties_excused"] = ag["engine_ties_excused"]
        if ag["engine_token_agreement"] < args.agreement_min:
            report["agreement_fail"] = (
                f"engine token agreement {ag['engine_token_agreement']:.4f}"
                f" < required {args.agreement_min}"
            )
            rc = 1
    if rc == 0 and args.min_speedup is not None and speedup < args.min_speedup:
        report["speedup_fail"] = f"engine speedup {speedup:.3f}x < required {args.min_speedup}x"
        rc = 1
    if rc == 0 and args.min_prefix_hits is not None and res["prefix_hits"] < args.min_prefix_hits:
        report["prefix_cache_fail"] = (
            f"prefix cache hits {res['prefix_hits']} < required {args.min_prefix_hits}"
        )
        rc = 1
    report["decode_step_captures"] = TRACE_COUNTS["decode_step"] - captures0
    report["kernel_launches"] = launches()
    report["v3_body_launches"] = v3_body_launches()
    report["v2_body_launches"] = v2_body_launches()
    if device.type == "cuda":
        report["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    state = {"model": model, "params": params, "trace": trace, "engine": eng,
             "outputs": outputs, "engine_kwargs": engine_kwargs}
    return report, rc, state


if __name__ == "__main__":
    raise SystemExit(main())
