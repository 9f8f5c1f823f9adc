"""The paper's tables from the port (counterpart of the reference's
``benchmarks/paper_tables.py`` and ``examples/paper_repro.py``).

    python -m repro_torch.tools.paper_tables [--nets A,B,C,D] [--device cuda]
        [--out tables.json]

* Tables 1-4: nets A-D trained on the synthetic MNIST/CIFAR stand-ins
  (``data.synthetic``), accuracy before/after the per-layer PVQ, the
  least-squares rho, the §V fold check on the ReLU nets (A, B), and the
  training's ms per step (``paper.experiment.run_net`` at the benchmark's
  fast steps: A 300, B 250, C 250, D 150).
* Tables 5-8: pulse statistics and bits/weight at the paper's layer sizes
  and N/K ratios on Laplacian weights (``core.pvq.pvq_encode_np``).
* §III: the op counts of a PVQ dot product (K-1 adds, one multiply);
  §II: the enumeration size N_p(8, 4) = 2816.

Each row is printed as one JSON line (and Tables 1-4 in the reference's
text form); ``--out`` writes them all to one JSON file.  The training runs
on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

FAST_STEPS = {"A": 300, "B": 250, "C": 250, "D": 150}
TABLE_OF = {"A": "T1", "B": "T2", "C": "T3", "D": "T4"}


def tables_1_to_4(nets: str = "ABCD", *, device="cuda",
                  results: Optional[list] = None) -> List[dict]:
    """One row per net; ``results`` (a list) also receives each ``RepoResult``."""
    from ..paper.experiment import format_result, run_net

    rows = []
    for net_id in nets:
        n = FAST_STEPS[net_id]
        r = run_net(net_id, steps=n, check_fold=(net_id in "AB"), device=device)
        print(format_result(r), flush=True)
        if results is not None:
            results.append(r)
        rows.append({
            "table": TABLE_OF[net_id], "net": net_id, "steps": n,
            "acc_before_pct": round(100 * r.acc_before, 2),
            "acc_after_pct": round(100 * r.acc_after, 2),
            "drop_pts": round(r.drop_pct, 2),
            "acc_ls_pct": round(100 * r.acc_after_ls, 2),
            "fold_check": r.fold_check,
            "zeros_pct": {k: round(t["0_pct"], 2) for k, t in r.weight_tables.items()},
            "train_ms_per_step": 1e3 * r.train_s / max(n, 1),
            "wall_s": r.wall_s,
        })
    return rows


def tables_5_to_8() -> List[dict]:
    """Pulse statistics at the paper's N/K ratios on Laplacian weights."""
    from ..core.codes import compression_report, pulse_histogram
    from ..core.pvq import pvq_encode_np

    rows = []
    rng = np.random.default_rng(0)
    for n, n_over_k, label in (
        (401920, 5.0, "T5:FC0(A)"),
        (9248, 1.0, "T6:CONV1(B)"),
        (2097664, 4.0, "T6:FC4(B)"),
        (401920, 2.5, "T7:FC0(C)"),
        (896, 0.4, "T8:CONV0(D)"),
    ):
        t0 = time.time()
        w = rng.laplace(size=n)
        k = max(int(round(n / n_over_k)), 1)
        y, _ = pvq_encode_np(w, k)
        h = pulse_histogram(y)
        rep = compression_report(y)
        rows.append({
            "table": label, "N": n, "K": k,
            "zeros_pct": round(h["0_pct"], 2),
            "pm1_pct": round(h["+-1_pct"], 2),
            "pm23_pct": round(h["+-2..3_pct"], 2),
            "golomb_bits_per_weight": round(rep["golomb_bits_per_weight"], 3),
            "rle_bits_per_weight": round(rep["rle_bits_per_weight"], 3),
            "host_s": time.time() - t0,
        })
    return rows


def opcount_rows(device="cuda") -> List[dict]:
    """§III: a dot product with a PVQ code costs K-1 adds + 1 multiply;
    §II: N_p(8, 4) = 2816."""
    from ..core.enumeration import index_bits, num_points
    from ..core.pvq import dot_op_counts, pvq_encode

    rows = []
    for n, k in ((1024, 128), (4096, 512), (256, 256)):
        w = torch.from_numpy(np.random.default_rng(n).laplace(size=n).astype(np.float32))
        c = dot_op_counts(pvq_encode(w.to(device), k))
        rows.append({
            "table": "S3:opcount", "N": n, "K": k,
            "pvq_adds": c["pvq_adds"], "pvq_muls": c["pvq_muls"],
            "naive_adds": c["naive_adds"], "naive_muls": c["naive_muls"],
            "mult_reduction": round(c["naive_muls"] / max(c["pvq_muls"], 1), 1),
        })
    rows.append({"table": "S2:enumeration", "N": 8, "K": 4, "num_points": num_points(8, 4),
                 "bits": index_bits(8, 4), "expected": 2816})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nets", default="A,B,C,D", help="comma-separated nets of Tables 1-4")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--out", default=None, help="write every row to this JSON file")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    nets = "".join(n.strip() for n in args.nets.split(","))
    out = {"device": (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                      else "cpu"),
           "tables_1_4": tables_1_to_4(nets, device=args.device),
           "tables_5_8": tables_5_to_8(),
           "opcount_enumeration": opcount_rows(args.device)}
    for key in ("tables_1_4", "tables_5_8", "opcount_enumeration"):
        for row in out[key]:
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
