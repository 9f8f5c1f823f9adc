"""Export CLI: model parameters -> ``.pvqz`` compressed artifact (PyTorch
port of ``repro.launch.export``, paper §VI).

    # a transformer config (packed with the serving policy):
    python -m repro_torch.launch.export --arch smollm-360m --n-over-k 2.0 \\
        --out model.pvqz
    python -m repro_torch.launch.export --arch smollm-360m --reduced \\
        --n-over-k 2.0 --out model.pvqz --device cpu

    # one of the paper's own nets (§VII; fc layers at their Table N/K ratios):
    python -m repro_torch.launch.export --paper-net A --out a.pvqz \\
        --max-bits-per-weight 1.65

Packs the parameters ONCE into ``PackedPVQ`` leaves (``--arch``: every
matmul leaf with the serving policy, ``quantize_params``; ``--paper-net``:
the fc kernels at ``--group``, ``SequentialNet.pvq_kernel_encode``, conv
kernels and biases raw), the encoder kernel packing every leaf on the
card, entropy-codes the pulse streams on the host into the single-file
container, and prints the per-leaf bits/weight report.
``--max-bits-per-weight`` and ``--max-expert-bits-per-weight`` turn the
report into gates (exit 1 when the artifact, or its MoE expert leaves
alone, miss the budget).  It runs on the CUDA card unless ``--device cpu``
is given.

``repro_torch.launch.serve --artifact model.pvqz`` consumes an ``--arch``
file and restores the identical pulses and scales with no re-encode;
``checkpoint.load_pvqz`` reads either kind.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import torch

from ..checkpoint.artifact import write_pvqz


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def export_arch(args) -> tuple:
    """(params with PackedPVQ leaves, meta) for a transformer config."""
    from ..configs import get_config
    from ..core.packed import quantize_params
    from ..core.quantize import QuantPolicy
    from ..nn.models import build_model

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(args.seed, device=device, max_seq=args.max_seq)
    policy = QuantPolicy(
        rules=(("embedding", cfg.pvq.n_over_k_embed, cfg.pvq.group),
               ("kernel|experts", args.n_over_k, cfg.pvq.group)),
        scale_mode="ls",
    )
    qparams = quantize_params(params, policy)
    _sync(device)
    meta = {"kind": "arch", "arch": cfg.name, "reduced": bool(args.reduced),
            "n_over_k": args.n_over_k, "seed": args.seed}
    return qparams, meta


def pack_paper_net(net_id: str, params, *, group: int, seed: int) -> tuple:
    """(params with the fc kernels packed, meta) for one of the §VII nets
    from its float ``params``: each fc kernel packed at its layer's Table
    N/K ratio through ``pvq_quantize_dense``; conv kernels (4-D, HWIO) and
    biases stay raw."""
    from ..configs.paper_nets import PAPER_NETS
    from ..nn.sequential import SequentialNet

    net = SequentialNet(PAPER_NETS[net_id])
    merged = dict(params)
    merged.update(net.pvq_kernel_encode(params, group=group))
    meta = {"kind": "paper_net", "net": net_id, "group": group, "seed": seed}
    return merged, meta


def export_paper_net(args) -> tuple:
    """(params with packed fc kernels, meta) for one of the §VII nets,
    initialised from ``--seed`` on ``--device``."""
    from ..configs.paper_nets import PAPER_NETS
    from ..nn.sequential import SequentialNet

    device = torch.device(args.device)
    params = SequentialNet(PAPER_NETS[args.paper_net]).init(args.seed, device=device)
    qparams, meta = pack_paper_net(args.paper_net, params, group=args.group, seed=args.seed)
    _sync(device)
    return qparams, meta


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--arch", default=None, help="transformer config name")
    src.add_argument("--paper-net", default=None, choices=("A", "B", "C", "D"),
                     help="one of the paper's §VII experiment nets")
    ap.add_argument("--out", required=True, help="output .pvqz path")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-over-k", type=float, default=1.0, help="kernel N/K ratio")
    ap.add_argument("--group", type=int, default=256,
                    help="PVQ group size for paper-net FC kernels")
    ap.add_argument("--codec", default="auto",
                    help="pulse codec: auto|golomb|rle|enum|nibble|int8")
    ap.add_argument("--chunk", type=int, default=1024,
                    help="symbols per decodable chunk of the entropy streams")
    ap.add_argument("--max-seq", type=int, default=32,
                    help="length of a learned positional table when the config sets no "
                    "max_position")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-bits-per-weight", type=float, default=None,
                    help="fail (exit 1) if the packed artifact exceeds this")
    ap.add_argument("--max-expert-bits-per-weight", type=float, default=None,
                    help="fail (exit 1) if the MoE expert leaves alone "
                    "(*_experts pulse streams + scales) exceed this")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' (plain versions)")
    return ap


def run(argv=None):
    """Parse ``argv``, export, and return ``(report, exit_code)``."""
    from ..core.packed import EXPERT_LEAF_REGEX

    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.arch and not args.paper_net:
        args.arch = "smollm-360m"
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain versions")

    t0 = time.time()
    qparams, meta = export_paper_net(args) if args.paper_net else export_arch(args)
    encode_s = time.time() - t0

    t0 = time.time()
    report = write_pvqz(args.out, qparams, codec=args.codec, chunk=args.chunk, meta=meta)
    report["encode_s"] = round(encode_s, 2)
    report["write_s"] = round(time.time() - t0, 2)

    # aggregate view of the MoE expert bank (the weight-bytes headline):
    # bits/weight over the expert leaves only, weighted by their numel
    expert = {k: v for k, v in report["leaves"].items()
              if re.search(EXPERT_LEAF_REGEX, k) and v.get("codec") != "raw"}
    if expert:
        numel = sum(v["numel"] for v in expert.values())
        bits = sum(v["bits_per_weight"] * v["numel"] for v in expert.values())
        report["expert_leaves"] = len(expert)
        report["expert_numel"] = numel
        report["expert_bits_per_weight"] = round(bits / max(numel, 1), 4)

    rc = 0
    if (args.max_bits_per_weight is not None
            and report["bits_per_weight"] > args.max_bits_per_weight):
        report["gate_fail"] = (f"{report['bits_per_weight']} bits/weight exceeds the "
                               f"--max-bits-per-weight {args.max_bits_per_weight} gate")
        rc = 1
    elif args.max_expert_bits_per_weight is not None:
        ebpw = report.get("expert_bits_per_weight")
        if ebpw is None:
            report["gate_fail"] = ("--max-expert-bits-per-weight set but no packed "
                                   "*_experts leaves were exported")
            rc = 1
        elif ebpw > args.max_expert_bits_per_weight:
            report["gate_fail"] = (f"{ebpw} expert bits/weight exceeds the "
                                   f"--max-expert-bits-per-weight "
                                   f"{args.max_expert_bits_per_weight} gate")
            rc = 1
    return report, rc


def main(argv=None) -> int:
    report, rc = run(argv)
    print(json.dumps(report, indent=1))
    if rc:
        print(f"FAIL: {report['gate_fail']}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
