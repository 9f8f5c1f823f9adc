"""Where a training step's time goes on the card, by batch and sequence.

    python -m repro_torch.tools.profile_train --shapes 8x64,8x512,1x2048,2x2048

Builds ``launch.train``'s state and ``--pvq-qat`` step (the full-width
``--arch`` in its config's dtype; K is the config's N/K at group 256,
256 for smollm-360m), then for each ``BxS`` shape, one after another in
this process: one warm step, the median host wall of ``STEPS`` steps (the
card synchronized after each), and one ``torch.profiler`` trace of
``STEPS`` steps.  Every step starts from the same initial state (its
update is dropped).  Prints one JSON line a shape: tokens a step, host wall
ms a step and tokens/s, device ms a step (every CUDA kernel), the idle
share (1 - device ms / untraced host wall), kernels a step, the encoder's
device ms, the top kernels, and the peak device memory of the shape's
steps.  A shape that does not fit in device memory prints ``"oom": true``,
and the next shape runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import torch

from ..configs import get_config
from ..data import TokenLoader, TokenTask
from ..launch import train
from ..nn.models import build_model
from ..optim import AdamW, cosine_schedule

#: timed steps, then traced steps, a shape
STEPS = 3
#: kernels listed a shape, by device time
TOP = 8


def _shape(text: str):
    b, s = text.lower().split("x")
    return int(b), int(s)


def profile_shape(step_fn, state, batch) -> dict:
    """Host wall, device time and peak memory of ``STEPS`` steps from
    ``state`` on ``batch`` (after one warm step)."""
    steps = STEPS
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    step_fn(state, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = {}
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            entry = kernels.setdefault(evt.name, [0.0, 0])
            entry[0] += float(evt.device_time_total)
            entry[1] += 1
    device_ms = sum(v[0] for v in kernels.values()) / 1e3 / steps
    wall_ms = statistics.median(walls)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "host_wall_ms_per_step": walls, "host_wall_ms_median": wall_ms,
        "traced_wall_ms_per_step": traced_ms,
        "device_ms_per_step": device_ms,
        "idle_share": max(1.0 - device_ms / wall_ms, 0.0),
        "kernels_per_step": sum(v[1] for v in kernels.values()) / steps,
        "encode_ms_per_step": sum(v[0] for n, v in kernels.items() if "pvq_encode" in n)
        / 1e3 / steps,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "top_kernels": [{"name": n[:80], "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": c / steps} for n, (us, c) in ranked],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--shapes", default="8x64,8x512,1x2048,2x2048",
                    help="comma-separated BATCHxSEQ, run in order")
    args = ap.parse_args(argv)
    shapes = [_shape(t) for t in args.shapes.split(",")]
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card: no CUDA device")

    cfg = get_config(args.arch)
    model = build_model(cfg)
    optimizer = AdamW(lr=cosine_schedule(3e-3, warmup=20, total=100))
    pvq_k = round(256 / cfg.pvq.n_over_k)
    state, step_fn = train.make_state_and_step(model, optimizer, pvq_qat=True, pvq_k=pvq_k,
                                               device="cuda")
    task = TokenTask(cfg.vocab_size, seed=0)
    for b, s in shapes:
        out = {"arch": cfg.name, "device": torch.cuda.get_device_name(0), "batch": b, "seq": s,
               "tokens_per_step": b * s, "pvq_k": pvq_k, "oom": False}
        batch = TokenLoader(task, b, s, seed=0, device="cuda").device_batch(0)
        try:
            out.update(profile_shape(step_fn, state, batch))
            out["tokens_per_s"] = 1e3 * b * s / out["host_wall_ms_median"]
        except torch.cuda.OutOfMemoryError:
            out.update(oom=True, peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
