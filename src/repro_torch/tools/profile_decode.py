"""Where one decode step's (or one prefill's) time goes, on the card.

    python -m repro_torch.tools.profile_decode --batch 4 --prompt-len 128 --steps 4
    python -m repro_torch.tools.profile_decode --arch deepseek-v2-lite-16b --steps 4
    python -m repro_torch.tools.profile_decode --arch deepseek-v2-lite-16b --prefill
    python -m repro_torch.tools.profile_decode --arch deepseek-v2-lite-16b --prefill --f32
    python -m repro_torch.tools.profile_decode --arch deepseek-v2-lite-16b --f32 --steps 4
    python -m repro_torch.tools.profile_decode --prompt-len 157 --steps 1
    python -m repro_torch.tools.profile_decode --engine --steps 4
    python -m repro_torch.tools.profile_decode --engine --prefill --prompt-len 256 --batch 2
    python -m repro_torch.tools.profile_decode --engine --prefill --compare --prompt-len 256 \
        --batch 2
    python -m repro_torch.tools.profile_decode --compare --steps 4
    python -m repro_torch.tools.profile_decode --arch gemma-2b --steps 4
    python -m repro_torch.tools.profile_decode --arch whisper-small --prefill

``--arch`` takes every ported configuration (``configs.ARCHS``): an
enc-dec model gets ``serve``'s frames, a VLM its patches; ``--engine``
refuses both, as ``serve --engine`` does.  Packs the model (as ``serve --pvq``), prefills with ``--act-int8 --kv-pvq``
in effect (an MLA model's latent cache stays dense), runs two warm-up
decode steps, then traces ``--steps`` decode steps with ``torch.profiler``
(CPU + CUDA activity).  The decode steps are the captured step that
``serve`` replays (``decode_step: "captured"``; a first pass over the same
positions captures every graph they need, so the traced steps only
replay), or with ``--eager`` the host-int step (``"eager"``); ``--compare``
traces the eager steps and then the captured ones in one process and
prints both reports.  With ``--prefill`` it traces one prefill of the
batch instead, after a warm one.  ``--f32`` runs either as the f32 leg of
``serve --agreement-min`` (f32 activations and a dense cache, kernel v2 on
the packed weights, as ``serve.teacher_forced_logits`` runs it).  Prints
one JSON object: the host wall time per step (or prefill), the device time
summed over every CUDA kernel (ours included: CUPTI traces them by name),
the device's idle share, the launch count, kernels v3's and v2's device
time, calls and share, each also by route (the 2-D matrices against the
expert-batched banks, told apart by the Route tag in the kernels' names)
and by body, kernel v4's (packed-KV attention) and the encoder's device
time, calls and share, the host's launch calls a step (kernel and graph
launches, copies and fills, from the CUDA API events), and the kernels
with the most device time.  The
traced steps start at position ``prompt_len + 2``: the step at a position
p with (p + 1) % 32 == 0 completes a KV block and PVQ-encodes it, so
``--prompt-len 157 --steps 1`` traces that block-fill step alone and
``--prompt-len 158 --steps 1`` the step after it, which fills none.

``--engine`` traces the continuous-batching engine instead (``launch.engine``,
KV block 32, group 32): ``--batch`` slots, each admitted with a
``--prompt-len`` prompt through one batched prefill, two warm decode steps,
then ``--steps`` engine decode steps over the paged pool; with
``--prefill``, two traces: one batched admission (``traced:
"prefill_graft"``: the prefill of ``--batch`` prompts of ``--prompt-len``
tokens at ``prefill_batch = --batch`` and their graft), then one request
of ``--prompt-len`` tokens in 128-token chunks (``--prefill-chunk 4``),
the last chunk traced after the earlier ones ran (``"chunk"``: it reads
``prompt_len - 128`` packed positions through kernel v4).  The engine's
steps are its captured graphs (``warmup`` captures them first), or with
``--eager`` its host-index steps; ``--compare`` traces both.  The report
adds the page gather's device time (``index_select``'s kernels).
"""

from __future__ import annotations

import argparse
import json
import re
import time
from typing import Optional

import torch

from ..configs import get_config
from ..core.quantize import ActQuant, KVQuant, act_quant_scope, kv_quant_scope
from ..launch import serve
from ..launch.engine import check_engine_model
from ..launch.serve import bucket_len, serving_policy
from ..nn.models import build_model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill", action="store_true",
                    help="trace one prefill (after a warm one) instead of decode steps")
    ap.add_argument("--f32", action="store_true",
                    help="the f32 leg (f32 activations, dense cache): kernel v2")
    ap.add_argument("--engine", action="store_true",
                    help="trace the continuous-batching engine's decode steps (or, with "
                    "--prefill, one batched prefill and graft, and one chunk)")
    ap.add_argument("--eager", action="store_true",
                    help="trace the eager decode step instead of the captured one")
    ap.add_argument("--compare", action="store_true",
                    help="trace the eager decode steps, then the captured ones")
    args = ap.parse_args(argv)
    if args.compare and (args.eager or args.prefill and not args.engine):
        ap.error("--compare traces decode steps (or, with --engine, the engine's prefill "
                 "and chunk) both ways; it takes no --eager, nor --prefill without --engine")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_decode measures the card: no CUDA device")
    if args.engine and args.f32:
        ap.error("--engine serves the quantized path; it takes no --f32")
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    # serve --pvq's packing at init: no dense copy of the model on the card
    params = model.init(args.seed, device="cuda", pack=serving_policy(cfg))
    gen = torch.Generator().manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen).cuda()
    # an enc-dec model's frames, a VLM's patches (serve's, from the same seed)
    extra = serve.stub_inputs(cfg, args.batch, args.prompt_len, args.seed + 1, "cuda")
    batch = {"tokens": tokens, **extra}
    kv_block = 32
    kvq = None if args.f32 else KVQuant(block=kv_block, group=32)
    kinds = ("eager", "captured") if args.compare else ("eager" if args.eager else "captured",)
    if args.engine:
        check_engine_model(cfg)
        with act_quant_scope(ActQuant()), kv_quant_scope(kvq):
            for kind in kinds:
                _profile_engine(args, cfg, model, params, tokens, profile, ProfilerActivity, kind)
        return 0
    with act_quant_scope(None if args.f32 else ActQuant()), kv_quant_scope(kvq):
        cache_len = bucket_len(args.prompt_len + WARM + args.steps, kv_block)
        if args.prefill:
            logits, cache = model.prefill(params, batch, cache_len=cache_len)
            del logits, cache
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, cache = model.prefill(params, batch, cache_len=cache_len)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(json.dumps(_report(prof, wall, 1, args, cfg, "prefill")))
            return 0
        for kind in kinds:
            eager = kind == "eager"
            if not eager:  # capture every graph the traced positions need
                _decode_pass(model, params, batch, cache_len, WARM + args.steps, eager)
            step = _decode_pass(model, params, batch, cache_len, WARM, eager)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(json.dumps(_report(prof, wall, args.steps, args, cfg, "step", kind)))
    return 0


#: decode steps run before the traced ones
WARM = 2


def _decode_pass(model, params, batch, cache_len: int, steps: int, eager: bool):
    """Prefill ``batch``, then ``steps`` decode steps from ``serve``'s
    lockstep step (captured, or the host-int step with ``eager``; a VLM's
    positions after its patch prefix); returns a function that runs the
    next step each call."""
    tokens = batch["tokens"]
    logits, cache = model.prefill(params, batch, cache_len=cache_len)
    step = serve._lockstep(model, params, cache, tokens, eager=eager)
    state = {"tok": torch.argmax(logits[:, -1], -1)[:, None],
             "pos": serve._prefix_len(batch) + tokens.shape[1]}
    del logits, cache

    def one():
        _, tok = step(state["tok"], state["pos"])
        state["tok"], state["pos"] = tok.clone(), state["pos"] + 1

    for _ in range(steps):
        one()
    return one


def _profile_engine(args, cfg, model, params, tokens, profile, activity, kind: str) -> None:
    """``--engine``: trace engine decode steps (``kind``: the captured or the
    eager steps; the engine's warm-up captures every graph), or one batched
    prefill and graft and one chunk (``--prefill``)."""
    from ..launch.engine import PVQEngine, Request

    chunk = 4  # pages a chunk: 128 tokens at KV block 32
    prompts = [[int(t) for t in row] for row in tokens.cpu()]
    eager = kind == "eager"
    traced = []
    if args.prefill:
        eng = PVQEngine(model, params, n_slots=args.batch, max_len=args.prompt_len + 32,
                        prefill_batch=args.batch, eager=eager)
        eng.warmup([args.prompt_len])
        for i, prompt in enumerate(prompts):
            eng.pending.append(Request(rid=i, prompt=prompt, max_new_tokens=2))
        traced.append((eng.admit_pending, "prefill_graft"))
        eng = PVQEngine(model, params, n_slots=args.batch, max_len=args.prompt_len + 32,
                        prefill_chunk=chunk, eager=eager)
        eng.warmup()
        eng.pending.append(Request(rid=0, prompt=prompts[0], max_new_tokens=1))
        eng.admit_pending()
        for _ in range(-(-args.prompt_len // eng.chunk_tokens) - 1):
            eng._prefill_step()
        traced.append((eng._prefill_step, "chunk"))
        units = 1
    else:
        eng = PVQEngine(model, params, n_slots=args.batch,
                        max_len=args.prompt_len + 2 + args.steps + 1, prefill_batch=args.batch,
                        eager=eager)
        eng.warmup([args.prompt_len])
        for i, prompt in enumerate(prompts):
            eng.pending.append(Request(rid=i, prompt=prompt, max_new_tokens=4 + args.steps))
        eng.admit_pending()
        for _ in range(2):
            eng.step()
        traced.append((eng.step, "engine_step"))
        units = args.steps
    for fn, unit in traced:
        torch.cuda.synchronize()
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps(_report(prof, wall, units, args, cfg, unit, kind)))


#: the CUDA API calls (``cuda*`` and ``cu*``) that put work on the
#: device: the host's launches
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")


def _report(prof, wall: float, units: int, args, cfg, unit: str,
            kind: Optional[str] = None) -> dict:
    """Device time by kernel name, launches and idle share over ``units``
    traced steps (or one prefill), per ``unit``; ``kind`` names the decode
    step (captured or eager)."""
    kernels = {}
    host_launches = 0
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = float(evt.device_time_total)
            entry = kernels.setdefault(evt.name, [0.0, 0])
            entry[0] += us
            entry[1] += 1
        elif HOST_LAUNCH.match(evt.name):
            host_launches += 1
    device_us = sum(v[0] for v in kernels.values())
    # kernels v3 and v2 (2-D and batched, every body), and their tensor-core
    # bodies alone
    def by_name(*parts):
        hits = [v for name, v in kernels.items() if all(p in name for p in parts)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def split(groups):
        return {key: {f"ms_per_{unit}": us / 1e3 / units, f"calls_per_{unit}": n / units}
                for key, (us, n) in groups}

    v3_us, v3_calls = by_name("pvq_matmul_q_")
    v3_by_route = split((("2d", by_name("pvq_matmul_q_", "OneMatrix")),
                         ("batched", by_name("pvq_matmul_q_", "ExpertStack"))))
    v3_by_body = split((("splitk", by_name("pvq_matmul_q_splitk")),
                        ("mma", by_name("pvq_matmul_q_mma")),
                        ("direct", by_name("pvq_matmul_q_kernel"))))
    v2_us, v2_calls = by_name("pvq_matmul_f_")
    v2_by_route = split((("2d", by_name("pvq_matmul_f_", "OneMatrix")),
                         ("batched", by_name("pvq_matmul_f_", "ExpertStack"))))
    v2_by_body = split((("splitk", by_name("pvq_matmul_f_splitk")),
                        ("mma", by_name("pvq_matmul_f_mma")),
                        ("direct", by_name("pvq_matmul_f_kernel"))))
    v4_us, v4_calls = by_name("pvq_attn")
    enc_us, enc_calls = by_name("pvq_encode")
    # the page gather (index_select): one of two kernels, by shape
    gather_us, gather_calls = (a + b for a, b in zip(by_name("indexSelect"),
                                                     by_name("vectorized_gather")))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[: args.top]
    unit_ms = 1e3 * wall / units
    device_ms = device_us / 1e3 / units
    return {
        "arch": cfg.name, "device": torch.cuda.get_device_name(0), "batch": args.batch,
        "prompt_len": args.prompt_len, "traced": unit, f"{unit}s": units,
        "decode_step": kind,
        f"wall_ms_per_{unit}": unit_ms,
        f"device_ms_per_{unit}": device_ms,
        "device_idle_share": max(1.0 - device_ms / unit_ms, 0.0) if device_us else None,
        f"kernel_launches_per_{unit}": sum(v[1] for v in kernels.values()) / units,
        f"host_launch_calls_per_{unit}": host_launches / units,
        f"v3_ms_per_{unit}": v3_us / 1e3 / units,
        f"v3_calls_per_{unit}": v3_calls / units,
        "v3_by_route": v3_by_route,
        "v3_by_body": v3_by_body,
        "v3_share_of_device_time": v3_us / device_us if device_us else None,
        f"v2_ms_per_{unit}": v2_us / 1e3 / units,
        f"v2_calls_per_{unit}": v2_calls / units,
        "v2_by_route": v2_by_route,
        "v2_by_body": v2_by_body,
        "v2_share_of_device_time": v2_us / device_us if device_us else None,
        f"v4_ms_per_{unit}": v4_us / 1e3 / units,
        f"v4_calls_per_{unit}": v4_calls / units,
        "v4_share_of_device_time": v4_us / device_us if device_us else None,
        f"encode_ms_per_{unit}": enc_us / 1e3 / units,
        f"encode_calls_per_{unit}": enc_calls / units,
        "encode_share_of_device_time": enc_us / device_us if device_us else None,
        f"gather_ms_per_{unit}": gather_us / 1e3 / units,
        f"gather_calls_per_{unit}": gather_calls / units,
        "gather_share_of_device_time": gather_us / device_us if device_us else None,
        "leg": "f32" if args.f32 else "served",
        "top_kernels": [
            {"name": name[:80], f"ms_per_{unit}": us / 1e3 / units, f"calls_per_{unit}": n / units}
            for name, (us, n) in top
        ],
    }


if __name__ == "__main__":
    raise SystemExit(main())
