"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``BENCHMARK.json`` lists both) with the device's busy
time over a traced span of steady steps.  Every run checks what the timed
path served against the plain reference (``bench/reference``) once the
window has closed, and prints each number compared beside its limit as the
last lines of standard error and last in the result.  Exits with 2 and
prints no result when the cell's chips are not there, and with 3 when the
process holds JAX or the JAX package once the window has closed."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    autotuner pointed at a file no run writes, so every run takes the
    rules; libraries kept from loading JAX."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["REPRO_TORCH_PVQ_TUNE_CACHE"] = str(build / "bench" / "untuned.json")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def execute(name: str, cell: dict, cfg: dict, mix: dict, listed: dict, *, seed: int,
            seconds: float, trace: bool, device, t_process: float) -> dict:
    """Drive one run and reduce it to the result line's object."""
    import torch

    from bench.core import guard, trace as trace_lib
    from bench.core.registry import driver, metric_module
    from bench.drivers.common import Run

    r = Run(name=name, cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace,
            device=torch.device(device), t_process=t_process)
    driver(cell["driver"]).run(r)
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    metrics = {}
    if not trace:
        values = dict(r.e2e, setup_s=r.setup_s)
        for m in listed["end_to_end"]:
            metrics[m["name"]] = {"value": _finite(values[m["name"]]), "unit": m["unit"]}
    else:
        for m in listed["per_layer"]:
            v = metric_module(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": _finite(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
           "kind": torch.cuda.get_device_name(r.device) if r.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": r.memory_peak_bytes}
    out = {"correct": bool(r.correct), "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": dev}
    if trace and r.summary is not None:
        dev["busy_s"] = r.summary.busy_s
        dev["window_s"] = r.summary.window_s
        out["breakdown"] = {"device_ops": r.summary.top_ops(10),
                            "idle_gaps": trace_lib.idle_gaps(r.summary, 10)}
        print(f"trace: {len(r.summary.events)} device events; starting and stopping the "
              f"profiler held the host {r.obs.get('trace_overhead_s', 0.0):.3f} s",
              file=sys.stderr)
    phases = ", ".join(f"{k} {v:.2f} s" for k, v in r.obs.get("setup_phases", {}).items())
    print(f"setup: {r.setup_s:.2f} s ({phases})", file=sys.stderr)
    print(f"host: {_host_note(r)}", file=sys.stderr)
    out["checks"] = r.checks
    return out


def _host_note(r) -> str:
    """What the host did in the window, to read beside a run that is slow
    as a whole: the engine's decode steps (their number and median host
    wall), the CPU the process last ran on, its threads, the load."""
    from bench.core.stats import percentile

    out = []
    steps = r.obs.get("spans", {}).get("decode") or []
    if steps:
        out.append(f"{len(steps)} decode steps, median {1e3 * percentile(steps, 50):.3f} ms")
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        status = dict(line.split(":", 1) for line in
                      Path("/proc/self/status").read_text().splitlines() if ":" in line)
        out.append(f"cpu {stat[36]}, {status['Threads'].strip()} threads, "
                   f"load {Path('/proc/loadavg').read_text().split()[:3]}")
    except (OSError, IndexError, KeyError):
        pass
    return "; ".join(out)


def _finite(v: float) -> float:
    """A value for the JSON line: an infinite one (a tail over a request
    that was never served) is written as 1e18."""
    return v if math.isfinite(v) else 1e18


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from bench.core import registry

    bench = registry.benchmark()
    wl = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in wl:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    w = wl[args.workload]
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    cfg = registry.config(w["config"])
    mix = registry.traffic(w["traffic"])
    try:
        out = execute(args.workload, cell, cfg, mix, registry.metrics_of(args.workload, bench),
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda:0", t_process=T_PROCESS)
    except ForbiddenModules as e:
        print(f"the process holds {', '.join(e.args[0])} after the window", file=sys.stderr)
        return 3
    for key, c in out["checks"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
