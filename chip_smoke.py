#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; exits
non-zero (printing no result) without either.  In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every hand-written kernel from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   full-width smollm-360m main-path shapes (the encoder, v3 and v4 must be
   identical; v2 within ``rtol=1e-5``), and times the kernel, the plain
   version and one PyTorch yardstick call (CUDA events, median of runs, L2
   flushed before every timed launch, as the decode path finds it cold);
4. serves full-width smollm-360m from random weights (``--pvq --act-int8
   --kv-pvq --agreement-min 0.99``, batch 4, prompt 128, 32 new tokens)
   with every kernel launch count set to 0 just before and read just after;
   requires finite logits of the expected shape and every kernel launched;
   then runs the same tokens and packed weights through the plain versions
   on the card: the served leg's teacher-forced logits must be identical
   to the kernel path's, and the f32 leg (kernel v2) must agree with its
   plain path at CI's top-1 threshold (0.99);
5. serves the reduced model the same way, where the serve gate (top-1
   agreement >= 0.99 of the served leg with the f32 leg, CI's
   configuration) must hold;
6. prints the ``kernels`` line, then ``{"ok": true, "device": ...}`` last.

Any failed phase, kernel mismatch or missed gate raises.  The full-width
served leg's agreement with its f32 leg is printed, not gated: the JAX
reference misses 0.99 there too (``tests/test_torch_fidelity.py``,
PERF.md), because random full-width weights leave near-tie margins that
int8 activations and the packed KV cache flip.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores

BATCH, PROMPT, GEN, KV_BLOCK, KV_GROUP = 4, 128, 32, 32, 32
FULL_SERVE = [
    "--arch", "smollm-360m", "--batch", str(BATCH), "--prompt-len", str(PROMPT),
    "--gen", str(GEN), "--pvq", "--act-int8", "--kv-pvq", "--kv-block", str(KV_BLOCK),
    "--kv-group", str(KV_GROUP), "--agreement-min", "0.99", "--seed", "0",
]
REDUCED_SERVE = [
    "--arch", "smollm-360m", "--reduced", "--batch", "2", "--prompt-len", "20", "--gen", "6",
    "--pvq", "--act-int8", "--kv-pvq", "--kv-block", "8", "--kv-group", "16",
    "--agreement-min", "0.99", "--seed", "0",
]
# one decoder layer's packed matmuls at full width: (k_pad, n) of
# wq, wk, wv, wo, wi_gate, wi_up, wo(ffn); group 256
LAYER_SHAPES = [(1024, 960), (1024, 320), (1024, 320), (1024, 960),
                (1024, 2560), (1024, 2560), (2560, 960)]
GROUP = 256
DECODE_M = 4
AGREEMENT_MIN = 0.99  # CI's serve gate
PREFILL_M = 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median CUDA-event time of a call, the L2 flushed before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def check_close(name, got, want, rtol):
    """``|kernel - plain| <= rtol * |plain| + rtol * max|plain|`` elementwise."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) or 1.0
    if not bool(((got - want).abs() <= rtol * want.abs() + rtol * scale).all()):
        fail(f"{name}: max |kernel - plain| {max_err(got, want):.3e} beyond rtol {rtol:g} "
             f"(max|plain| {scale:.3e})")
    return max_err(got, want)


def check_matmuls(torch, timer, mm, ops, quantize):
    """Kernels v3 (int8 x) and v2 (f32 x) at one layer's decode shapes and
    the prefill FFN shape; returns their kernel-line entries and details."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    layer = []
    for k, n in LAYER_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda")
        pulses, scales, _ = ops.encode_weight_matrix(w, group=GROUP, k_pulses=GROUP)
        layer.append((pulses, scales))
    rows = []
    totals = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, err=0.0)
              for name in ("pvq_matmul_q", "pvq_matmul")}
    cases = [(DECODE_M, i) for i in range(len(LAYER_SHAPES))] + [(PREFILL_M, 4)]
    for m, i in cases:
        k, n = LAYER_SHAPES[i]
        pulses, scales = layer[i]
        x = torch.randn(m, k, generator=gen, device="cuda")
        x_q, a = quantize(x)
        w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=0)
        for name in ("pvq_matmul_q", "pvq_matmul"):
            if name == "pvq_matmul_q":
                def kern(): return mm.pvq_matmul_q_cuda(x_q, pulses, scales, a, group=GROUP)
                def plain(): return mm.pvq_matmul_q_plain(x_q, pulses, scales, a, group=GROUP)
                nbytes = m * k + k * n + 4 * (k // GROUP) * n + 4 * m + 4 * m * n
                nops, rate = 2.0 * m * k * n, INT8_OPS_PER_S
            else:
                def kern(): return mm.pvq_matmul_cuda(x, pulses, scales, group=GROUP)
                def plain(): return mm.pvq_matmul_plain(x, pulses, scales, group=GROUP)
                nbytes = 4 * m * k + k * n + 4 * (k // GROUP) * n + 4 * m * n
                nops, rate = 2.0 * m * k * n, F32_FLOPS_PER_S
            # v3 is identical to its plain version by construction; v2's f32
            # sums run in another order
            tol = 0.0 if name == "pvq_matmul_q" else 1e-5
            err = check_close(f"{name} m{m} k{k} n{n}", kern(), plain(), tol)
            t_k, t_p = timer(kern), timer(plain)
            t_lib = timer(lambda: torch.matmul(x, w_deq))
            b_ms, b_by = bound_ms(nbytes, nops, rate)
            rows.append({"kernel": name, "m": m, "k": k, "n": n, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": err})
            if m == DECODE_M:
                tot = totals[name]
                tot["ms"] += t_k
                tot["plain_ms"] += t_p
                tot["library_ms"] += t_lib
                tot["bytes"] += nbytes
                tot["ops"] += nops
                tot["err"] = max(tot["err"], err)
    entries = {}
    for name, tot in totals.items():
        rate = INT8_OPS_PER_S if name == "pvq_matmul_q" else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], rate)
        entries[name] = {
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/pvq_matmul.cu",
            "replaces": ("src/repro/kernels/pvq_matmul.py:596" if name == "pvq_matmul_q"
                         else "src/repro/kernels/pvq_matmul.py:229"),
            "shape": f"one decoder layer's 7 matmuls, m={DECODE_M}, group {GROUP}",
            "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": tot["library_ms"],
        }
    return entries, rows


def check_attention(torch, timer, mm, quant):
    """Kernel v4 at the full-width decode shape, on planes in the packed
    cache's own (batch 4, S 160, 5 kv heads, X) layout: BH = 20 rows of
    m = 3 query heads per kv head, hd 64, group 32."""
    b, n_kv, m, hd, group, s = BATCH, 5, 3, 64, 32, 160
    bh, ng = b * n_kv, hd // group
    gen = torch.Generator(device="cuda").manual_seed(2)
    q_i8, a = quant(torch.randn(bh, m, hd, generator=gen, device="cuda"))
    kp = torch.randint(-20, 21, (b, s, n_kv, hd), generator=gen, device="cuda", dtype=torch.int8)
    vp = torch.randint(-20, 21, (b, s, n_kv, hd), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand(b, s, n_kv, ng, generator=gen, device="cuda") * 0.1
    vs = torch.rand(b, s, n_kv, ng, generator=gen, device="cuda") * 0.1
    kv_len = torch.full((bh,), s, dtype=torch.int32, device="cuda")
    scale = hd ** -0.5
    args = (q_i8, a, kp, ks, vp, vs, kv_len)

    def kern(): return mm.pvq_attn_q_cuda(*args, group=group, sm_scale=scale)
    def plain(): return mm.pvq_attn_q_plain(*args, group=group, sm_scale=scale)

    err = 0.0
    for name, got, want in zip(("acc", "m", "l"), kern(), plain()):
        err = max(err, check_close(f"pvq_attn_q {name}", got, want, 0.0))

    def rows(t):  # (b, S, n_kv, X) -> (BH, 1, S, X)
        return t.permute(0, 2, 1, 3).reshape(bh, 1, s, t.shape[-1])

    kd = rows(kp).float() * torch.repeat_interleave(rows(ks), group, dim=-1)
    vd = rows(vp).float() * torch.repeat_interleave(rows(vs), group, dim=-1)
    qf = (q_i8.float() * a)[:, None]
    t_lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(qf, kd, vd, scale=scale))
    nbytes = bh * m * hd + 4 * bh * m + 2 * bh * s * hd + 2 * 4 * bh * s * ng + 4 * bh \
        + 4 * bh * m * hd + 2 * 4 * bh * m
    nops = 2.0 * 2 * bh * m * s * hd
    b_ms, b_by = bound_ms(nbytes, nops, INT8_OPS_PER_S)
    return {
        "name": "pvq_attn_q", "route": "cuda", "source": "src/repro_torch/kernels/csrc/pvq_attn.cu",
        "replaces": "src/repro/kernels/pvq_matmul.py:813",
        "shape": f"BH {bh} (batch {b} x {n_kv} kv heads, cache layout), m {m}, hd {hd}, "
                 f"group {group}, S {s}",
        "max_abs_err": err, "ms": timer(kern), "plain_ms": timer(plain),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_lib,
    }


def _encode_ops(torch, w, k, delta_max):
    """Operations the encode needs on these rows: per lane the floor
    allocation (~8), 32 bisection compare+count rounds, the tree sums (~8),
    and ~6 per greedy step actually taken by the row."""
    absw = w.abs()
    l1 = absw.sum(-1, keepdim=True)
    y = torch.floor(absw * (k / torch.where(l1 > 0, l1, torch.ones_like(l1))))
    rem = torch.clamp(k - y.sum(-1), min=0, max=delta_max)
    g, n = w.shape
    return float(g * n * (8 + 64 + 8) + 6 * n * rem.sum())


def check_encode(torch, timer, enc):
    """The encoder on one layer's weights (40320 groups of 256, K 256) and
    on the tied embedding (737280 groups of 64, K 128)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [
        ("layer", torch.randn(40320, 256, generator=gen, device="cuda") * 0.03, 256),
        ("embedding", torch.randn(737280, 64, generator=gen, device="cuda") * 0.02, 128),
    ]
    ms = plain_ms = nbytes = nops = 0.0
    rows = []
    for what, w, k in cases:
        p, rho = enc.pvq_encode_batch_cuda(w, k_pulses=k)
        p_ref, rho_ref = enc.pvq_encode_batch_plain(w, k_pulses=k)
        bad = int((p != p_ref).any(-1).sum())
        if bad or not torch.equal(rho, rho_ref):
            fail(f"pvq_encode_batch ({what}): {bad} of {w.shape[0]} groups differ from the plain version")
        t_k = timer(lambda: enc.pvq_encode_batch_cuda(w, k_pulses=k), reps=5)
        t_p = timer(lambda: enc.pvq_encode_batch_plain(w, k_pulses=k), reps=3, warmup=1)
        g, n = w.shape
        b = 4 * g * n + 4 * g * n + 4 * g
        o = _encode_ops(torch, w, k, enc.DELTA_MAX)
        rows.append({"kernel": "pvq_encode_batch", "case": what, "groups": g, "n": n, "k": k,
                     "ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms(b, o, F32_FLOPS_PER_S)[0]})
        ms, plain_ms, nbytes, nops = ms + t_k, plain_ms + t_p, nbytes + b, nops + o
    b_ms, b_by = bound_ms(nbytes, nops, F32_FLOPS_PER_S)
    return {
        "name": "pvq_encode_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pvq_encode.cu",
        "replaces": "src/repro/kernels/pvq_encode.py:177",
        "shape": "one layer's weights (40320 x 256, K 256) + embedding (737280 x 64, K 128)",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }, rows


@contextlib.contextmanager
def plain_versions(mm, enc):
    """For the duration, each kernel wrapper's CUDA entry point is answered
    by its plain version on the same CUDA tensors, so the main path runs end
    to end on the card with no kernel launched and the same glue ops.  The
    package has no such switch: this patches the attributes ``ops`` reads."""
    saved = [(mod, name, getattr(mod, name + "_cuda"))
             for mod, name in ((mm, "pvq_matmul"), (mm, "pvq_matmul_q"),
                               (mm, "pvq_attn_q"), (enc, "pvq_encode_batch"))]
    try:
        for mod, name, _ in saved:
            setattr(mod, name + "_cuda", getattr(mod, name + "_plain"))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name + "_cuda", fn)


def serve_full(torch, serve, kernels_mod, mm, enc, quant, argv=FULL_SERVE):
    """The main path at full width, then the same teacher-forced tokens and
    packed parameters through the plain versions on the card."""
    kernels_mod.reset_launches()
    t0 = time.time()
    report, rc, state = serve.run(argv, return_state=True)
    counts = kernels_mod.launches()
    report["phase_wall_s"] = round(time.time() - t0, 2)
    print(json.dumps({"serve": "full", **report}), flush=True)
    if not state:
        fail(f"full serve stopped early: {report}")
    if report.get("generated_shape") != [BATCH, PROMPT + GEN] or not report.get("logits_finite"):
        fail(f"full serve produced {report.get('generated_shape')} / finite={report.get('logits_finite')}")
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        fail(f"full serve never launched {missing}: {counts}")
    if rc != 0 and "agreement_fail" not in report:
        fail(f"full serve exited {rc}: {report}")

    t0 = time.time()
    with plain_versions(mm, enc):
        with quant.act_quant_scope(quant.ActQuant()), \
                quant.kv_quant_scope(quant.KVQuant(KV_BLOCK, KV_GROUP)):
            plain_q = serve.teacher_forced_logits(state["model"], state["params"], state["seq"],
                                                  prompt_len=PROMPT)
        with quant.act_quant_scope(None), quant.kv_quant_scope(None):
            plain_f = serve.teacher_forced_logits(state["model"], state["params"], state["seq"],
                                                  prompt_len=PROMPT)
    legs = {}
    for leg, kern, plain in (("int8_kv_pvq", state["logits_q"], plain_q),
                             ("f32", state["logits_f"], plain_f)):
        ag = serve.top1_agreement(plain, kern)
        legs[leg] = {
            "identical": torch.equal(kern, plain),
            "max_abs_logit_diff": float((kern - plain).abs().max()),
            "rel_l2_logit_diff": float((kern - plain).norm() / plain.norm()),
            "agreement": ag["top1_agreement"], "agreement_strict": ag["top1_agreement_strict"],
        }
    print(json.dumps({"full_width_kernels_vs_plain_on_card": legs,
                      "seconds": round(time.time() - t0, 2)}), flush=True)
    print(json.dumps({"full_width_f32_leg_agreement": {
        "required_by_ci_at_reduced": 0.99, "measured": report["act_int8_top1_agreement"],
        "strict": report["act_int8_top1_agreement_strict"],
    }}), flush=True)
    # the served leg runs kernels v3, v4 and the encoder, each identical to
    # its plain version by construction: the logits must be too
    if not legs["int8_kv_pvq"]["identical"]:
        fail(f"full-width served leg: kernel path differs from the plain path {legs['int8_kv_pvq']}")
    # the f32 leg runs kernel v2, whose f32 sums run in another order than
    # the plain version's: CI's agreement threshold holds it
    if legs["f32"]["agreement"] < AGREEMENT_MIN:
        fail(f"full-width f32 leg: kernel path vs plain path agreement {legs['f32']}")
    return counts


def serve_reduced(serve, argv):
    report, rc = serve.run(argv)
    print(json.dumps({"serve": "reduced", **report}), flush=True)
    if rc != 0 or report.get("act_int8_top1_agreement", 0.0) < AGREEMENT_MIN:
        fail(f"reduced serve exited {rc}: {report.get('agreement_fail') or report}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    import repro_torch.kernels as kernels_mod
    from repro_torch.core import quantize as quant
    from repro_torch.core.quantize import quantize_activations
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pvq_encode as enc
    from repro_torch.kernels import pvq_matmul as mm
    from repro_torch.launch import serve

    t0 = time.time()
    build.build_all()
    print(json.dumps({"phase": "build", "seconds": round(time.time() - t0, 2)}), flush=True)

    timer = Timer(torch)
    entries, rows = check_matmuls(torch, timer, mm, ops, quantize_activations)
    entries["pvq_attn_q"] = check_attention(torch, timer, mm, quantize_activations)
    entries["pvq_encode_batch"], enc_rows = check_encode(torch, timer, enc)
    for row in rows + enc_rows:
        print(json.dumps({"kernel_check": row}), flush=True)
    del timer

    counts = serve_full(torch, serve, kernels_mod, mm, enc, quant)
    serve_reduced(serve, REDUCED_SERVE)

    order = ("pvq_encode_batch", "pvq_matmul_q", "pvq_attn_q", "pvq_matmul")
    line = []
    for name in order:
        e = dict(entries[name])
        e["launches"] = counts[name]
        line.append(e)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
