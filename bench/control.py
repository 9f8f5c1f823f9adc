"""Readings that set a cell's limits (not part of a benchmark run): for
each seed, one run of the cell, the numbers its check compares (the
program's: the lower readings), and the same numbers for the control and
any fault the driver plants in the reference put in the program's place
(the upper readings).  The serving cells' control is the reference with
activations of the next lower precision (int4 where int8 is stated); the
training cell's, the reference with its matrix products in float8 where
bfloat16 is stated, beside half the batch left out.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--out readings.jsonl]

One JSON line per seed on standard output (and appended to ``--out``)."""

from __future__ import annotations

import argparse
import json
import sys
import time

T_PROCESS = time.perf_counter()

from pathlib import Path  # noqa: E402

if not __package__:  # run as a script: the checkout's root holds ``bench``
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as bench_run  # noqa: E402


def readings(name, cell, cfg, mix, *, seed, seconds, device, t_process) -> dict:
    import torch

    from bench.core.registry import driver
    from bench.core.weights import WeightSource
    from bench.drivers.common import Run

    r = Run(name=name, cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=False,
            device=torch.device(device), t_process=t_process, keep=True)
    drv = driver(cell["driver"])
    drv.run(r)
    t = time.perf_counter()
    upper = drv.control_readings(r, WeightSource(r.seed, r.device))
    return {"workload": name, "seed": seed,
            "program": {k: c["value"] for k, c in r.checks.items()}, **upper,
            "failed": r.failed, "attempted": r.attempted,
            "served_checked": r.obs.get("served_checked"), "setup_s": r.setup_s,
            "metrics": r.e2e, "control_s": time.perf_counter() - t,
            "memory_peak_bytes": r.memory_peak_bytes,
            "device": torch.cuda.get_device_name(0) if r.device.type == "cuda" else "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench_run._environment()
    from bench.core import registry

    w = {x["name"]: x for x in registry.benchmark()["workloads"]}[args.workload]
    cell, cfg, mix = registry.cell(args.workload), registry.config(w["config"]), \
        registry.traffic(w["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, cell, cfg, mix, seed=seed,
                                   seconds=args.seconds, device="cuda:0",
                                   t_process=time.perf_counter()))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
