"""Render the dry-run tables from dry-run JSON directories (port of
``repro.launch.report``; the same text from the same records).

    PYTHONPATH=src python -m repro_torch.launch.report \
        --baseline experiments/dryrun --optimized experiments/dryrun_opt
"""

from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path
from typing import Dict, Optional


def load(dirpath: str) -> Dict[tuple, dict]:
    out = {}
    for f in sorted(glob.glob(str(Path(dirpath) / "*.json"))):
        r = json.loads(open(f).read())
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(cells: Dict[tuple, dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute | memory* | collective | bound | MODEL_FLOPS/HLO | mem_analytic (decode) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | — | — | — | N/A | — | {r['reason'][:40]} |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | FAILED | | | | | |")
            continue
        roof = r["roofline"]
        ana = r.get("analytic_decode")
        ana_s = fmt_s(ana["memory_s_analytic"]) if ana else "—"
        lines.append(
            f"| {arch} | {shape} | {fmt_s(roof['compute_s'])} | {fmt_s(roof['memory_s'])} "
            f"| {fmt_s(roof['collective_s'])} | {roof['bottleneck']} "
            f"| {min(roof['useful_ratio'], 99):.2f} | {ana_s} |"
        )
    return "\n".join(lines)


def before_after_table(base: Dict[tuple, dict], opt: Dict[tuple, dict], mesh="single") -> str:
    lines = [
        "| arch | shape | term | baseline | optimized | delta |",
        "|---|---|---|---|---|---|",
    ]
    for key in sorted(base):
        arch, shape, m = key
        if m != mesh or key not in opt:
            continue
        b, o = base[key], opt[key]
        if b["status"] != "ok" or o["status"] != "ok":
            continue
        rb, ro = b["roofline"], o["roofline"]
        dom = rb["bottleneck"]
        term = {"compute": "compute_s", "memory": "memory_s", "collective": "collective_s"}[dom]
        delta = (ro[term] - rb[term]) / max(rb[term], 1e-12)
        lines.append(
            f"| {arch} | {shape} | {dom} | {fmt_s(rb[term])} | {fmt_s(ro[term])} | {100*delta:+.1f}% |"
        )
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="experiments/dryrun")
    ap.add_argument("--optimized", default="experiments/dryrun_opt")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    base = load(args.baseline)
    print("## Baseline roofline (single-pod)\n")
    print(roofline_table(base, args.mesh))
    if Path(args.optimized).exists():
        opt = load(args.optimized)
        if opt:
            print("\n## Optimized roofline (single-pod)\n")
            print(roofline_table(opt, args.mesh))
            print("\n## Before/after on the dominant term\n")
            print(before_after_table(base, opt, args.mesh))


if __name__ == "__main__":
    main()
