"""Find a serving cell's knee once, by a sweep on the chip (not part of a
benchmark run): the cell's engine is built once, then served the cell's
traffic mix at each rate for ``--seconds``; for each rate one JSON line
with the tails and whether the queue grew (the mean wait from due to
admission of the window's last third of requests against its first
third).  The knee is the highest rate whose queue does not grow; the cell
runs at about four fifths of it (``rate_per_s`` in its traffic file).

    python3 bench/sweep.py --workload smollm-engine-chat --rates 1,2,3,4 --seconds 30
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if not __package__:  # run as a script: the checkout's root holds ``bench``
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch

    from bench.core import registry, stats, traffic
    from bench.core.weights import WeightSource
    from bench.drivers.common import build_params, port_config, quant_scopes, serving_policy
    from bench.drivers.engine import warm_prefixes
    from repro_torch.launch.engine import PVQEngine, Request
    from repro_torch.nn.models import build_model

    w = {x["name"]: x for x in registry.benchmark()["workloads"]}[args.workload]
    cell, cfg, mix = registry.cell(args.workload), registry.config(w["config"]), \
        registry.traffic(w["traffic"])
    port = port_config(cfg)
    with quant_scopes(cfg):
        model = build_model(port)
        params = build_params(model, serving_policy(port, cfg),
                              WeightSource(args.seed, "cuda:0"))
        eng = PVQEngine(model, params, **cell["engine"])
        rates = [float(x) for x in args.rates.split(",")]
        lens = set()
        for rate in rates:
            lens |= set(traffic.prompt_lengths(dict(mix, rate_per_s=rate), args.seconds))
        eng.warmup(prompt_lens=sorted(lens))
        warm_prefixes(eng, mix, args.seed, cfg["vocab_size"])
        for rate in rates:
            m = dict(mix, rate_per_s=rate)
            specs = traffic.poisson(m, args.seed, args.seconds, cfg["vocab_size"])
            reqs = [Request(rid=s.rid, prompt=list(s.prompt), max_new_tokens=s.max_new,
                            arrival=s.arrival) for s in specs]
            eng.finished.clear()
            steps0 = eng.stats["steps"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(reqs)
            t_end = time.perf_counter()
            ttft = [q.first_token_t - (t0 + q.arrival) for q in reqs]
            tpot = [(q.finish_t - q.first_token_t) / max(len(q.generated) - 1, 1) for q in reqs]
            queue = [q.admit_t - (t0 + q.arrival) for q in sorted(reqs, key=lambda q: q.arrival)]
            third = max(len(queue) // 3, 1)
            line = {
                "workload": args.workload, "rate_per_s": rate, "requests": len(reqs),
                "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
                "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90),
                "tpot_p90_ms": 1e3 * stats.percentile(tpot, 90),
                "queue_first_third_s": stats.mean(queue[:third]),
                "queue_last_third_s": stats.mean(queue[-third:]),
                "drain_s": t_end - t0 - args.seconds,
                "decode_steps": eng.stats["steps"] - steps0,
                "tokens_per_s": sum(len(q.generated) for q in reqs) / (t_end - t0),
                "device": torch.cuda.get_device_name(0),
            }
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
