"""Multi-node dry-run: trace every (architecture x input shape) step on the
H100 production meshes and record memory, cost and roofline terms (port
of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out experiments/dryrun] [--skip-existing]
        [--seq-shard] [--opt-level N] [--extrapolate-depth]

Each cell runs in a process of its own, which initialises the fake
process group at the mesh's size (256 or 512 ranks; ``launch.mesh``),
builds the step (``launch.steps``) on shape-only inputs
(``launch.inputs``: fake tensors, nothing allocated) and runs it once as
rank 0.  DTensor partitions every op as it would on the cluster, and
``roofline.OpCounter`` counts what that rank does beneath DTensor:

* FLOPs on its local shards (``torch.utils.flop_counter``'s formulas on
  the local matmuls: no global count is divided by the GPU count);
* HBM bytes, the sum of each local op's inputs and outputs (like XLA's
  "bytes accessed", an unfused upper bound);
* collectives, with their bytes and mesh axis (``roofline.collective_bytes``);
* peak memory: the arguments' local bytes, and the peak of live op outputs
  (temporaries).

The records keep the reference's keys (``status``, ``chips``,
``memory_analysis``, ``params_total``, ``params_active``, ``roofline``,
``analytic_decode``); ``trace_s`` stands in for ``lower_s``/``compile_s``.
An eager trace counts every layer, so the reference's depth extrapolation
(XLA counts a loop body once) is not needed for the counts;
``--extrapolate-depth`` traces the two shallow variants of
:func:`_depth_variants` instead and extrapolates, for cells whose full
trace is too slow.  The roofline terms are estimates from the H100 SXM5
datasheet constants (``roofline``), not times measured on a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional

from ..configs import ARCHS, SHAPES, cell_applicable, get_config
from ..parallel.sharding import ShardingPolicy, mesh_shape, param_leaves
from . import roofline as roofline_lib


def _depth_variants(cfg):
    """Two reduced-depth configs differing by exactly +1 repeat in every
    segment, plus the number of additional repeats in the full model:
    ``C_full = C_small + extra * (C_big - C_small)``."""
    dc = dataclasses

    if cfg.encoder_layers:  # enc-dec: both stacks scale together
        small = dc.replace(cfg, n_layers=1, encoder_layers=1, unroll_layers=True)
        big = dc.replace(cfg, n_layers=2, encoder_layers=2, unroll_layers=True)
        extra = cfg.n_layers - 1
    elif cfg.hybrid_period:
        p = cfg.hybrid_period
        small = dc.replace(cfg, n_layers=p, unroll_layers=True)
        big = dc.replace(cfg, n_layers=2 * p, unroll_layers=True)
        extra = cfg.n_layers // p - 1
    elif cfg.moe is not None and cfg.first_dense:
        small = dc.replace(cfg, n_layers=cfg.first_dense + 1, unroll_layers=True)
        big = dc.replace(cfg, n_layers=cfg.first_dense + 2, unroll_layers=True)
        extra = (cfg.n_layers - cfg.first_dense) - 1
    else:
        small = dc.replace(cfg, n_layers=1, unroll_layers=True)
        big = dc.replace(cfg, n_layers=2, unroll_layers=True)
        extra = cfg.n_layers - 1
    return small, big, extra


def trace_costs(cfg, shape, mesh, policy, opt_level=0) -> dict:
    """One traced step: ``{flops, hbm_bytes, coll, args_bytes, temp_bytes}``
    for one rank."""
    from ..nn.models import build_model
    from .steps import make_step

    bundle = make_step(build_model(cfg), mesh, shape, policy, opt_level=opt_level)
    counter, args_bytes, _ = bundle.trace()
    return {
        "flops": counter.flops,
        "hbm_bytes": counter.hbm_bytes,
        "coll": roofline_lib.collective_bytes(counter.collectives),
        "args_bytes": args_bytes,
        "temp_bytes": counter.peak,
    }


def extrapolated_costs(cfg, shape, mesh, policy, opt_level=0) -> dict:
    """Depth-extrapolated ``{flops, hbm_bytes, coll}`` from the two shallow
    variants of :func:`_depth_variants`."""
    small_cfg, big_cfg, extra = _depth_variants(cfg)
    a = trace_costs(small_cfg, shape, mesh, policy, opt_level)
    b = trace_costs(big_cfg, shape, mesh, policy, opt_level)

    def ext(x, y):
        return x + extra * (y - x)

    ka, kb = a["coll"], b["coll"]
    return {
        "flops": max(ext(a["flops"], b["flops"]), 0.0),
        "hbm_bytes": max(ext(a["hbm_bytes"], b["hbm_bytes"]), 0.0),
        "coll": {
            "total_bytes": max(ext(ka["total_bytes"], kb["total_bytes"]), 0.0),
            "per_kind_bytes": {k: ext(ka["per_kind_bytes"][k], kb["per_kind_bytes"][k])
                               for k in ka["per_kind_bytes"]},
            "per_kind_counts": {k: int(ext(ka["per_kind_counts"][k], kb["per_kind_counts"][k]))
                                for k in ka["per_kind_counts"]},
            "per_axis_bytes": {k: ext(ka["per_axis_bytes"].get(k, 0.0),
                                      kb["per_axis_bytes"].get(k, 0.0))
                               for k in set(ka["per_axis_bytes"]) | set(kb["per_axis_bytes"])},
        },
    }


def param_counts(cfg, params) -> tuple:
    """``(params_total, params_active)``: every leaf's elements, and the
    routed experts' counted at ``top_k / n_experts`` (the reference's
    MODEL_FLOPS count)."""
    total = active = 0
    for path, leaf in param_leaves(params):
        n = math.prod(leaf.shape)
        total += n
        if cfg.moe is not None and "experts" in path and "shared" not in path:
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        active += n
    return total, active


def run_cell(arch: str, shape_name: str, multi_pod: bool, policy: Optional[ShardingPolicy] = None,
             opt_level: int = 0, *, extrapolate_depth: bool = False, cfg=None,
             mesh_dims=None) -> dict:
    """One cell in this process (which must not hold another process group:
    the fake world is initialised here at the mesh's size).  ``cfg``
    overrides the registry's config of ``arch``, ``mesh_dims`` (``(shape,
    axis names)``) the production mesh (tests: a reduced config on a small
    mesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..nn.models import build_model
    from . import inputs as inputs_lib
    from .mesh import PRODUCTION_SHAPES, fake_world, mesh_chip_count

    cfg = cfg or get_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    t0 = time.time()
    dims, names = mesh_dims or PRODUCTION_SHAPES[multi_pod]
    fake_world(math.prod(dims))
    mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
    chips = mesh_chip_count(mesh)
    if extrapolate_depth:
        costs = extrapolated_costs(cfg, shape, mesh, policy, opt_level)
        costs.update({k: None for k in ("args_bytes", "temp_bytes")})
    else:
        costs = trace_costs(cfg, shape, mesh, policy, opt_level)
    trace_s = time.time() - t0

    model = build_model(cfg)
    pshape = inputs_lib.params_shape(model, max_seq=shape.seq_len)
    n_total, n_active = param_counts(cfg, pshape)
    mf = roofline_lib.model_flops_for(cfg, shape, n_active)
    roof = roofline_lib.analyze_corrected(flops=costs["flops"], hbm_bytes=costs["hbm_bytes"],
                                          coll=costs["coll"], chips=chips, model_flops=mf)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "chips": chips,
        "mesh_shape": mesh_shape(mesh),
        "trace_s": round(trace_s, 1),
        "depth_extrapolated": extrapolate_depth,
        "memory_analysis": {
            "argument_size_in_bytes": costs["args_bytes"],
            "temp_size_in_bytes": costs["temp_bytes"],
        },
        "cost_flops_per_chip_raw": costs["flops"],
        "cost_bytes_per_chip_raw": costs["hbm_bytes"],
        "params_total": n_total,
        "params_active": n_active,
        "roofline": roof.as_dict(),
        "constants": {"peak_flops": roofline_lib.PEAK_FLOPS, "hbm_bw": roofline_lib.HBM_BW,
                      "nvlink_bw": roofline_lib.NVLINK_BW, "net_bw": roofline_lib.NET_BW,
                      "card": "H100 SXM5 80GB, 700 W (datasheet)"},
    }
    if shape.kind == "decode":
        rec["analytic_decode"] = roofline_lib.analytic_decode_memory(cfg, shape, mesh_shape(mesh),
                                                                     n_total)
    return rec


def _cell_to_file(path: str, arch, shape_name, multi, seq_shard, opt_level, extrapolate) -> None:
    """A cell in a child process (the fake process group is process-global),
    its record (or its failure) written to ``path``."""
    try:
        policy = ShardingPolicy(seq_shard=True) if seq_shard else None
        rec = run_cell(arch, shape_name, multi, policy, opt_level=opt_level,
                       extrapolate_depth=extrapolate)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": "multi" if multi else "single",
               "status": "failed", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    Path(path).write_text(json.dumps(rec, indent=2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id (default: all)")
    ap.add_argument("--shape", default=None, help="single shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--seq-shard", action="store_true", help="enable sequence parallelism")
    ap.add_argument("--opt-level", type=int, default=0, help="§Perf ladder: 0=baseline 1/2=optimized")
    ap.add_argument("--extrapolate-depth", action="store_true",
                    help="trace two shallow variants and extrapolate (faster)")
    args = ap.parse_args(argv)

    import multiprocessing as mp

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    ctx = mp.get_context("spawn")

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                path = outdir / f"{tag}.json"
                if args.skip_existing and path.exists():
                    print(f"[dryrun] {tag}: exists, skipping")
                    continue
                print(f"[dryrun] {tag}: tracing ...", flush=True)
                proc = ctx.Process(target=_cell_to_file, args=(
                    str(path), arch, shape_name, multi, args.seq_shard, args.opt_level,
                    args.extrapolate_depth))
                proc.start()
                proc.join()
                if not path.exists() or proc.exitcode:
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape_name, "mesh": "multi" if multi else "single",
                        "status": "failed", "error": f"cell process exit code {proc.exitcode}"}))
                rec = json.loads(path.read_text())
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (
                        f" compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s"
                        f" coll={r['collective_s']:.3e}s bound={r['bottleneck']}"
                        f" (trace {rec['trace_s']}s; H100 datasheet estimates)"
                    )
                elif status == "failed":
                    failures.append(tag)
                    extra = " " + rec["error"][:200]
                elif status == "skipped":
                    extra = " " + rec["reason"]
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)

    print(f"[dryrun] done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
