"""Where one decode step's time goes, on the card.

    python -m repro_torch.tools.profile_decode --batch 4 --prompt-len 128 --steps 4

Packs the model (as ``serve --pvq``), prefills with ``--act-int8 --kv-pvq``
in effect, runs two warm-up decode steps, then traces ``--steps`` decode
steps with ``torch.profiler`` (CPU + CUDA activity).  Prints one JSON
object: the host wall time per step, the device time per step summed over
every CUDA kernel (ours included: CUPTI traces them by name), the device's
idle share of the step, and the kernels with the most device time.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config
from ..core.packed import quantize_params
from ..core.quantize import ActQuant, KVQuant, act_quant_scope, kv_quant_scope
from ..nn.models import build_model
from ..launch.serve import bucket_len, serving_policy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_decode measures the card: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = quantize_params(model.init(args.seed, device="cuda"), serving_policy(cfg))
    gen = torch.Generator().manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen).cuda()
    kvq = KVQuant(block=32, group=32)
    warm = 2
    with act_quant_scope(ActQuant()), kv_quant_scope(kvq):
        cache_len = bucket_len(args.prompt_len + warm + args.steps, kvq.block)
        logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        pos = args.prompt_len
        for _ in range(warm):
            logits, cache = model.decode_step(params, cache, tok, pos)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            pos += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                logits, cache = model.decode_step(params, cache, tok, pos)
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                pos += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    kernels = {}
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = float(evt.device_time_total)
            entry = kernels.setdefault(evt.name, [0.0, 0])
            entry[0] += us
            entry[1] += 1
    device_us = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[: args.top]
    step_ms = 1e3 * wall / args.steps
    report = {
        "arch": cfg.name, "device": torch.cuda.get_device_name(0), "batch": args.batch,
        "prompt_len": args.prompt_len, "steps": args.steps,
        "wall_ms_per_step": step_ms,
        "device_ms_per_step": device_us / 1e3 / args.steps,
        "device_idle_share": (max(1.0 - device_us / 1e3 / args.steps / step_ms, 0.0)
                              if device_us else None),
        "kernel_launches_per_step": sum(v[1] for v in kernels.values()) / args.steps,
        "top_kernels": [
            {"name": name[:80], "ms_per_step": us / 1e3 / args.steps, "calls_per_step": n / args.steps}
            for name, (us, n) in top
        ],
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
