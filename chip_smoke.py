#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-3 only (no result line)
    python3 chip_smoke.py --kernels-only --tree DIR   # the same rows on DIR's kernels
    python3 chip_smoke.py --paper          # the build and phase 10 only (no result line)
    python3 chip_smoke.py --train          # the build and phase 11 only (no result line)
    python3 chip_smoke.py --families       # the build and phase 12 only (no result line)
    python3 chip_smoke.py --recurrent      # the build and phase 13 only (no result line)

Needs one CUDA card and the repository checkout around this file; exits
non-zero (printing no result) without either.  ``--tree DIR`` (with
``--kernels-only``) runs phases 1-3 on the kernels of another checkout
DIR, e.g. a parent commit unpacked with ``git archive``, so one call can
time two trees' bodies with the same rows (parent, new, new, parent).  In
order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every hand-written kernel from ``src/repro_torch/kernels/csrc``,
   and prints what ``nvcc -Xptxas -v`` reports for kernels v3's and v2's
   decode bodies, for kernel v4 and for each instance of the encoder
   (registers, spills);
3. holds each kernel against its plain PyTorch version on the card at the
   full-width main-path shapes (smollm-360m for the encoder, v2, v3 and v4;
   deepseek-v2-lite-16b's 2-D decode matrices for v3 and v2 too, and its
   expert banks for the batched v2 and v3): the
   encoder, v3, batched v3 and v4 must be identical, v2 and batched v2
   within ``rtol=1e-5``; it times the kernel, the plain version and one
   PyTorch yardstick call (CUDA events, median of runs, L2 flushed before
   every timed launch, as the decode path finds it cold).  Each decode row
   (v3, v2, v4 and their batched forms) also gives ``device_ms`` beside
   ``ms`` for the kernel and its yardstick: the mean device time of the
   call's kernels under ``torch.profiler`` over 20 launches, each after an
   L2 flush, without the wrapper's host time that ``ms`` holds; v2's decode
   rows (its splitk body) also time v2's direct body on the same inputs
   (``direct_ms``, ``direct_device_ms``); v4 is timed at smollm's decode
   (S 160), CI's prompt-512 smoke at full width (S 520) and smollm's
   published context (S 2048, batch 4 and 1), the first also with the L2 warm
   (``warm_ms``, ``warm_device_ms``).  v3 and v2 at
   prefill (one smollm layer's 7 matmuls and deepseek's lm_head at m 512,
   one MoE layer's banks at m 60; v2's banks in f32 and bf16 x) must take
   their tensor-core bodies (int8 for v3, f64 for v2), and are timed beside
   their direct bodies on the same inputs; v2's 2-D prefill rows also give
   ``device_ms``.  The encoder is held identical and timed (``ms`` and
   ``device_ms``) on one smollm layer's weights, the tied embedding, a
   smollm block-fill step's KV encode and one deepseek MoE layer's up bank;
   the families' and the recurrent slice's rows (items 12 and 13) are held
   and timed here too;
4. serves full-width smollm-360m from random weights (``--pvq --act-int8
   --kv-pvq --agreement-min 0.99``, batch 4, prompt 128, 32 new tokens)
   with every kernel launch count set to 0 just before and read just after;
   requires finite logits of the expected shape, every kernel of the
   path launched, v3's splitk (decode) and tensor-core bodies and v2's
   splitk and tensor-core bodies among them (v2's in the f32 leg's decode
   and prefill), no call of at most 8 rows on v3's or v2's direct body
   where its splitk body fits it, and no v2 call above 8 rows on v2's
   direct body.  Its decode steps are replays of captured CUDA graphs
   (``launch.capture``); then ``generate`` and both legs'
   ``teacher_forced_logits`` run again on the same parameters and prompts,
   captured (a second ``generate`` of the shape: no capture) and through
   the eager step: the tokens, each step's logits and both legs'
   teacher-forced logits must be identical, the captured and the eager
   calls' kernel launch counts equal (replays accounted) and at most 2
   graphs a key; ``decode_ms_per_step`` both ways, the captures and the
   peak memory are printed beside the card's name and power limit; then
   runs the same tokens and packed weights through the
   plain versions on the card (eager): the served leg's teacher-forced
   logits must be identical to the kernel path's, and the f32 leg (kernel
   v2) must agree with its plain path at CI's top-1 threshold (0.99);
5. frees that model and does the same for full-width deepseek-v2-lite-16b
   (``--pvq --act-int8 --agreement-min 0.99``, batch 4, prompt 128, 32 new
   tokens; its MLA latent cache is dense, so kernel v4 is not on this
   path); it also counts the MoE routing decisions in which the f32 leg's
   kernel path and plain path differ, and prints the peak device memory;
6. serves both reduced models the same way, where the serve gate (top-1
   agreement >= 0.99 of the served leg with the f32 leg, CI's
   configuration) must hold, then CI's long-context ``--kv-pvq`` smoke
   (reduced smollm, batch 1, prompt 512, 8 new tokens) under the same
   gate, with kernel v4 launched and ``kv_bytes_ratio_vs_f32 <= 0.35``,
   and CI's prompt-8 ``--pvq --act-int8`` smoke (batch 2, 8 new tokens);
7. runs the continuous-batching engine (``serve --engine``, its decode,
   prefill, graft and chunk steps captured as CUDA graphs by the warm-up,
   whose ``trace_counts`` must be the reference engine's for the same flags
   with the port's two decode graphs, and no capture in the timed run),
   each run with the launch counts set to 0 just before it and read just
   after, each rerun on the same trace through the eager engine, where its
   tokens and every real page must be identical, and through the plain
   versions on the card, where its tokens must be identical; each prints
   the host wall of a batched prefill with its graft and of a chunk,
   captured against eager, beside TTFT and the ITL of decode steps that
   share an iteration with prefill work: CI's two
   engine smokes at reduced size
   with CI's flags; the first must pass its agreement and speedup gates, the
   chunked one its prefix-hit gate, and prints its agreement (the JAX
   reference's own run misses that gate, 0.9792 at CI's seed) and its
   speedup over the sequential loop (both captured), then full-width
   smollm-360m: run (a),
   batched admission
   (``--engine-slots 4 --requests 8 --prompt-len 128 --gen 32
   --prefill-batch 2``), and run (b), the same with chunked prefill and
   prefix hits (``--prefill-chunk 4 --shared-prefix 128``: kernel v4 at
   its chunk caller with 384 query rows); each prints its engine report,
   the launches of v4 from the chunk caller and of the encoder from graft
   and append, and its ``engine_token_agreement`` (printed at full width,
   like the fixed-batch phases' f32-leg agreement); before that, the
   kernel phase times v4 at the chunk caller's shape (BH 5, m 384, hd 64,
   kv_len 256 of 416 and 1920 of 2048 positions) against SDPA under the
   same length mask;
8. the tune phase (``serve --tune``, the autotuner's cache a fresh file):
   full-width smollm-360m served with the first phase's flags plus
   ``--tune``, then engine run (a) with ``--tune``, then the autotuner
   over deepseek-v2-lite-16b's ``--tune`` shape set (``serve.tune_config``,
   expert banks included; no second deepseek serve), then the first serve
   again on the same cache; the searches must be more than 0, every served
   token and the f32 leg identical to the untuned serves of this process,
   and the second serve all hits (no search, no miss, as many hits as the
   first made lookups); prints, for every key, the rule's choice and its
   median time beside the tuned choice and its time;
9. the artifact phase (``.pvqz``): exports smollm-360m at published
   widths with its whole embedding and 4 of its 32 layers (the cut is
   printed; the harness's ``depth_cut``, not a flag of the package) at N/K
   2.0 from seed 0 (``launch.export``'s ``run`` in-process, which calls
   ``write_pvqz``; the encoder kernel packs every leaf, the host
   entropy-codes the pulse streams),
   cold-starts it (``load_pvqz``) with the first phase's flags (``serve --artifact ...
   --act-int8 --kv-pvq --agreement-min 0.99``, the launch counts set to 0
   just before and read just after: the encoder, v3, v4 and v2 must
   launch), then serves the in-memory ``--pvq --n-over-k 2.0`` parameters
   of the same seed: every leaf's pulses and scales, the prefill logits
   (f32 and int8 activations), the tokens and both legs' teacher-forced
   logits must be identical; the agreement is printed, not gated; then
   CI's reduced artifact smoke (export, ``serve --artifact --act-int8
   --agreement-min 0.99``, logits bit-exact on a fresh-seed target) and its
   deepseek expert export gate (<= 2.5 bits/weight); prints the file's
   bytes and bits/weight, ``encode_s``, ``write_s``, the cold start's
   ``artifact_decode_s`` (host decode and copies to the card) and each
   codec's decode MB/s, beside the card's name and the host CPU's model;
10. the paper phase (the §VII nets A-D at published width, seed 0):
   ``SequentialNet.pvq_kernel_encode`` at group 256 (export's) and 128
   (``kernel_apply``'s default) and ``kernel_apply`` at m 4 and 2048 with
   f32 activations (v2) and ``ActQuant()`` (v3), the launch counts set to 0
   just before and read just after (every net's 10-column head on the
   direct bodies); then the same calls through the plain versions on the
   card: the packed codes and v3's logits identical, v2's within rtol 1e-5;
   times ``kernel_apply`` at m 2048, and v3 and v2 on net A's head (2048 x
   512 x 10, the direct bodies) and net B's fc (2048 x 4096 x 512) against
   their plain versions and ``torch.matmul``, and traces ``kernel_apply``
   at m 2048 and three training steps of nets A and B under
   ``torch.profiler`` (device ms against host wall, the top kernels);
   CI's first artifact gate
   (``export --paper-net A --max-bits-per-weight 1.65``, loaded back to
   leaves identical to the in-memory packing), printing ``bits_per_weight``,
   ``write_s`` and the file's bytes; Tables 1-4 at the benchmark's fast
   steps (``tools.paper_tables``: accuracy before/after PVQ, the LS rho, the
   fold check on A and B, train ms per step), where net A must meet the
   reference test's gates (``acc_before > 0.5``, ``acc_after > 0.3``, fold
   argmax agreement > 0.99, every layer's zeros > 60%); and its wall time;
11. the train phase (``launch.train``, smollm-360m at full width in bf16,
   ``--steps 8 --batch 8 --seq 64 --pvq-qat --pvq-k 256 --ckpt-every 0``,
   eager steps), the launch counts set to 0 just before and read just
   after: every step's loss and grad norm finite, no restore, the encoder
   launched once per projected leaf (8) every step and its plain version
   never, no other kernel; the final checkpoint restored into a fresh
   state bit for bit; step 1 again with the encoder's plain version on the
   card: every leaf's STE pulses and rho identical and the step-1 loss
   identical; one ``torch.profiler`` trace of two steps (device ms against
   host wall, the encoder's device ms a step), the projection timed on the
   kernel and on the plain version; the full-width step-1 gradients through
   ``make_ef_compressor`` (default ``CompressionConfig``: group 256, K 128)
   and ``packed_update`` on one full-width packed leaf (the first layer
   stack's ``wi_gate``, 32 x 960 x 2560), each identical on the kernel and
   the plain version, with ``wire_bytes``; then reduced smollm-360m: 30
   ``--pvq-qat --pvq-k 128`` steps (batch 8, sequence 32) whose last loss
   is below its first (``tests/test_integration.py:33-43``), and an
   injected failure at step 17 of a 30-step run with ``--ckpt-every 5``
   (one restore, step 15 run twice, the loss falling); prints host wall
   ms a step, ``save_s``, ``restore_s``, the checkpoint's bytes and the
   peak device memory beside the card's name and power limit;
12. the families phase: serves gemma-2b (18 layers), paligemma-3b (18
   layers, a 256-patch prefix) and whisper-small (12 encoder and 12
   decoder layers, frames as long as the prompt) at published width and
   depth, and starcoder2-15b and granite-8b at published width with 4
   decoder layers (the cut printed), each with the first phase's flags
   (batch 4, prompt 128, 32 tokens), the launch counts set to 0 just
   before and read just after: finite logits of the expected shape, the
   encoder, v3, v4 and v2 launched, the step captured; a second
   ``generate`` of the same shape captures nothing, gives the same tokens
   and times the steady decode step; the served leg's teacher-forced
   logits again through the plain versions on the card must be identical
   (so the plain path's tokens are the served ones); the
   f32 leg's agreement is printed, not gated; prints packed bytes and the
   ratio against bf16, decode ms a step captured, tokens/s, prefill s,
   peak GB and the phase's wall per model; then the five reduced (CI's
   int8 flags with the PVQ KV cache) gated at 0.99; with ``--families``
   it then times (in the whole run, phase 3 does, since torch.profiler
   lost device events in traces taken after the train phase) kernel v4
   at gemma-2b's decode (BH 4, m 8, hd 256, group 32, S 160 and 2048), v3
   and v2 over one gemma-2b layer at m 4 and m 512, v3 and v2 with the
   bias epilogue over one starcoder2-15b layer at m 4 (each identical, v2
   within rtol 1e-5, against its plain version), and gemma-2b's tied head
   (glue, ``layers.unembed`` on the 256,000 x 2048 packed embedding);
13. the recurrent phase: serves rwkv6-1.6b at published width and depth
   (24 layers, no attention), jamba-1.5-large-398b at published widths
   with one super-block (8 of 72 layers: 7 Mamba + 1 attention, 4 MoE of
   16 experts + 4 dense FFN; ~46 GB packed as it is built, its peak device
   memory gated under 75 GB) and deepseek-v2-236b at published widths
   with 4 of 60 layers (q-LoRA MLA, 1 dense + 3 MoE layers of 160
   experts), the cuts printed, each as item 12 serves its models, with the
   kernels of its own path required (the encoder, v3 and v2 everywhere;
   the batched v3 and v2 on the MoE models; v4 on jamba only: rwkv6 has
   no attention and deepseek's MLA cache is dense); then the three
   reduced with item 12's flags, rwkv6 and deepseek gated at 0.99, jamba's
   agreement printed beside the reference's 0.75 (the reference misses
   its own gate there); with ``--recurrent`` it then times (in the whole
   run, phase 3 does) v4 at jamba's attention (BH 32 = batch 4 x 8 kv
   heads, m 8, hd 128, S 160), v3 and v2 at m 4 over one rwkv6-1.6b layer
   and jamba's ``x_proj`` (n 544) and ``dt_proj`` (k 512, with bias), and
   the batched v3 and v2 over jamba's 16-expert 8192 x 24576 bank and
   deepseek-v2-236b's 160-expert 5120 x 1536 bank at m 1, each identical
   (v2 within rtol 1e-5) to its plain version;
14. prints the ``kernels`` line, then ``{"ok": true, "device": ...}`` last.

Except in the tune phase the autotuner's cache is a path that does not
exist, so every other phase runs the rules' choices, as without the tuner.

Any failed phase, kernel mismatch or missed gate raises.  The full-width
served legs' agreement with their f32 legs is printed, not gated: the JAX
reference misses 0.99 there too on smollm (``tests/test_torch_fidelity.py``,
PERF.md), because random full-width weights leave near-tie margins that
int8 activations and the packed KV cache flip.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
from functools import partial
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores
F64_TC_FLOPS_PER_S = 67e12  # f64 tensor-core peak (kernel v2's contraction)

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
# CI's long-context PVQ-KV serve smoke (ci.yml:88-98), as CI runs it: 16
# full KV blocks plus the tail at prompt 512, kernel v4 on every decode step
CI_LONG_SERVE = [
    "--arch", "smollm-360m", "--reduced", "--batch", "1", "--prompt-len", "512", "--gen", "8",
    "--pvq", "--act-int8", "--kv-pvq", "--agreement-min", "0.99",
]
KV_BYTES_RATIO_MAX = 0.35  # CI's gate on that smoke
# CI's int8-activation serve smoke (ci.yml:79-87): dense KV cache
CI_PROMPT8_SERVE = [
    "--arch", "smollm-360m", "--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "8",
    "--pvq", "--act-int8", "--agreement-min", "0.99",
]
# CI's two engine smokes (ci.yml:99-132) with CI's flags, and the
# full-width engine runs (a) batched admission and (b) chunked prefill with
# prefix hits; each: (argv, agreement gated, kernels its path must launch)
ENGINE_KERNELS = ("pvq_encode_batch", "pvq_matmul_q", "pvq_attn_q")
CI_ENGINE_SATURATE = [
    "--arch", "smollm-360m", "--reduced", "--prompt-len", "12", "--gen", "8", "--engine",
    "--engine-slots", "3", "--requests", "6", "--rate", "0", "--pvq", "--act-int8", "--kv-pvq",
    "--kv-block", "8", "--kv-group", "16", "--agreement-min", "0.99", "--min-speedup", "1.0",
]
CI_ENGINE_CHUNKED = [
    "--arch", "smollm-360m", "--reduced", "--prompt-len", "24", "--gen", "8", "--engine",
    "--engine-slots", "2", "--requests", "6", "--rate", "0", "--pvq", "--act-int8", "--kv-pvq",
    "--kv-block", "8", "--kv-group", "16", "--prefill-chunk", "2", "--prefill-batch", "2",
    "--shared-prefix", "64", "--agreement-min", "0.99", "--min-speedup", "1.0",
    "--min-prefix-hits", "1",
]
FULL_ENGINE_A = [
    "--arch", "smollm-360m", "--engine", "--engine-slots", "4", "--requests", "8", "--rate", "0",
    "--prompt-len", str(PROMPT), "--gen", str(GEN), "--pvq", "--act-int8", "--kv-pvq",
    "--kv-block", str(KV_BLOCK), "--kv-group", str(KV_GROUP), "--prefill-batch", "2",
    "--agreement-min", "0.99",
]
FULL_ENGINE_B = FULL_ENGINE_A + ["--prefill-chunk", "4", "--shared-prefix", "128",
                                 "--min-prefix-hits", "1"]
# (what, argv, the serve gates that must hold).  CI's chunked smoke prints
# its agreement and speedup: the JAX reference's own run misses the former
# at CI's seed (REFERENCE_CI_CHUNKED_AGREEMENT, python -m repro.launch.serve
# with those flags on the CPU), and the eager engine's speedup over the
# eager sequential loop at this size is host noise around 1 (PERF.md)
ENGINE_RUNS = [("ci engine saturate", CI_ENGINE_SATURATE, ("agreement", "speedup")),
               ("ci engine chunked", CI_ENGINE_CHUNKED, ("prefix_cache",)),
               ("smollm-360m engine (a)", FULL_ENGINE_A, ()),
               ("smollm-360m engine (b)", FULL_ENGINE_B, ("prefix_cache",))]
REFERENCE_CI_CHUNKED_AGREEMENT = 0.9792
# the JAX reference engine's trace_counts (its jitted decode, prefill,
# graft and chunk steps) for CI's two engine smokes, run with CI's flags on
# the CPU; tests/test_torch_engine.py runs the reference and holds it to them
REFERENCE_TRACE_COUNTS = {
    "ci engine saturate": {"decode": 1, "prefill": 2, "graft": 2, "chunk": 0},
    "ci engine chunked": {"decode": 1, "prefill": 0, "graft": 0, "chunk": 1},
}
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_FULL_SERVE = [
    "--arch", MOE_ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN),
    "--pvq", "--act-int8", "--agreement-min", "0.99", "--seed", "0",
]
MOE_REDUCED_SERVE = [
    "--arch", MOE_ARCH, "--reduced", "--batch", "2", "--prompt-len", "20", "--gen", "6",
    "--pvq", "--act-int8", "--agreement-min", "0.99", "--seed", "0",
]
# the kernels each full-width path must launch
SMOLLM_KERNELS = ("pvq_encode_batch", "pvq_matmul_q", "pvq_attn_q", "pvq_matmul")
MOE_KERNELS = ("pvq_encode_batch", "pvq_matmul_q", "pvq_matmul", "pvq_matmul_q_batched",
               "pvq_matmul_batched")
# one MoE layer's expert banks at full width: (what, k_pad, n) of up/gate
# (d 2048 -> d_expert 1408) and wo (1408 -> 2048, k padded to 1536); 64
# experts; m = dispatch rows per expert: 1 at decode (4 tokens, capacity 1),
# 60 at prefill (512 tokens, capacity 60)
EXPERTS = 64
BANK_SHAPES = [("up/gate", 2048, 1408), ("wo", 1536, 2048)]
MOE_DECODE_M, MOE_PREFILL_M = 1, 60
# one decoder layer's packed matmuls at full width: (k_pad, n) of
# wq, wk, wv, wo, wi_gate, wi_up, wo(ffn); group 256
LAYER_SHAPES = [(1024, 960), (1024, 320), (1024, 320), (1024, 960),
                (1024, 2560), (1024, 2560), (2560, 960)]
GROUP = 256
DECODE_M = 4
AGREEMENT_MIN = 0.99  # CI's serve gate
PREFILL_M = 512
# deepseek-v2-lite-16b's untied lm_head (d 2048 -> vocab 102400), the widest
# 2-D v3 call of a prefill
LM_HEAD = (2048, 102400)
# deepseek-v2-lite-16b's 2-D v3 matrices at decode (m 4): (what, k_pad, n)
DEEPSEEK_DECODE_SHAPES = [("mla wq", 2048, 3072), ("shared up/gate", 2048, 2816),
                          ("shared down", 2816, 2048), ("dense ffn up/gate", 2048, 10944),
                          ("dense ffn down", 11008, 2048), ("lm_head", *LM_HEAD)]
MMA_SOURCE = "src/repro_torch/kernels/csrc/pvq_matmul_mma.cuh"
F_MMA_SOURCE = "src/repro_torch/kernels/csrc/pvq_matmul_f_mma.cuh"
SPLITK_SOURCE = "src/repro_torch/kernels/csrc/pvq_matmul_splitk.cuh"
F_SPLITK_SOURCE = "src/repro_torch/kernels/csrc/pvq_matmul_f_splitk.cuh"
DEVICE_MS_BY = ("torch.profiler: mean device time of the call's kernels over 20 launches, "
                "the L2 flushed before each (the flush's kernel left out)")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median CUDA-event time of a call, the L2 flushed before each launch
    (``__call__``); ``device_later`` queues a call whose device time alone
    ``measure_device`` fills in afterwards."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
        # the same fill kernel on 16 bytes: marks launches without evicting L2
        self.mark = torch.empty(16, dtype=torch.uint8, device="cuda")
        self.queued = []  # (fn, [(target dict, key, weight)], flush)

    def __call__(self, fn, reps: int = 15, warmup: int = 2, flush: bool = True) -> float:
        torch = self.torch
        clear = self.flush if flush else self.mark
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            clear.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_later(self, fn, *targets, flush: bool = True) -> None:
        """Queues ``fn`` (already warm; its tensors bound, e.g. by
        ``functools.partial``): ``measure_device`` adds weight times its
        device ms to ``target[key]`` for each ``(target, key, weight)``.
        With ``flush=False`` the L2 stays warm between its launches."""
        self.queued.append((fn, targets, flush))

    def _trace(self, calls, reps):
        """One ``torch.profiler`` trace of ``calls`` (``(fn, flush)`` pairs):
        a lone flush first (its kernel's name marks the flushes), then for
        each call ``reps`` times a flush (or the same fill kernel on 16
        bytes, which leaves L2 warm) and the call; the kernels between two
        marks, in device order, are one launch's.  Returns each launch's
        device us, or None where the trace lost events."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            self.flush.zero_()
            torch.cuda.synchronize()
            for fn, flush in calls:
                clear = self.flush if flush else self.mark
                for _ in range(reps):
                    clear.zero_()
                    fn()
            torch.cuda.synchronize()
        kernels = sorted((evt.time_range.start, evt.name, float(evt.device_time_total))
                         for evt in prof.events()
                         if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA)
        launches = []
        for _, name, us in kernels[1:]:
            if name == kernels[0][1]:
                launches.append(0.0)
            elif launches:
                launches[-1] += us
        if len(launches) != reps * len(calls) or min(launches, default=0.0) <= 0.0:
            print(f"chip_smoke: torch.profiler kept {len(launches)} flushed launches of "
                  f"{len(calls)} calls x {reps}, or a launch with no kernel", file=sys.stderr)
            return None
        return launches

    def measure_device(self, reps: int = 20, per_trace: int = 20, attempts: int = 3) -> None:
        """Device time of every queued call (``DEVICE_MS_BY``), ``per_trace``
        calls a trace; a trace that lost events (it happened in about one run
        in seven with 77 calls in one trace) is taken again, up to
        ``attempts`` times."""
        for at in range(0, len(self.queued), per_trace):
            chunk = self.queued[at:at + per_trace]
            for _ in range(attempts):
                launches = self._trace([(fn, flush) for fn, _, flush in chunk], reps)
                if launches is not None:
                    break
            else:
                fail(f"torch.profiler lost device events in {attempts} traces in a row")
            for i, (_, targets, _) in enumerate(chunk):
                ms = sum(launches[i * reps:(i + 1) * reps]) / reps / 1e3
                for target, key, weight in targets:
                    target[key] = target.get(key, 0.0) + weight * ms
        self.queued.clear()


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


def _new_total():
    return dict(ms=0.0, direct_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, err=0.0)


def _decode_total(direct=False):
    total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, library_device_ms=0.0,
                 bytes=0.0, ops=0.0, err=0.0)
    if direct:
        total.update(direct_ms=0.0, direct_device_ms=0.0)
    return total


def decode_row(timer, head, kern, plain, library, nbytes, nops, rate, *, tol=0.0,
               body_launches=None, direct=None, times=1, total=None):
    """A decode shape (``head`` names it): the kernel against its plain
    version within ``tol`` (v3 and v4: identical), timed by events (``ms``)
    beside the plain version and its yardstick; the device time of kernel
    and yardstick (``device_ms``, ``library_device_ms``) is queued on the
    timer.  With ``body_launches`` the v3 or v2 body that ran; with
    ``direct`` (the same call on the direct body) that body too, held to
    the same tolerance and timed the same way (``direct_ms``,
    ``direct_device_ms``).  ``times`` adds the row that many times into
    ``total``.  ``kern``, ``direct`` and ``library`` must hold their tensors
    (``functools.partial``)."""
    what = json.dumps(head)
    before = body_launches() if body_launches else None
    want = plain()
    err = check_close(what, kern(), want, tol)
    row = dict(head)
    if body_launches:
        row["body"] = [b for b, c in body_launches().items() if c != before[b]]
    timed = [(kern, "ms", "device_ms")]
    if direct is not None:
        check_close(f"{what} (direct body)", direct(), want, tol)
        timed.append((direct, "direct_ms", "direct_device_ms"))
    del want
    b_ms, b_by = bound_ms(nbytes, nops, rate)
    timed.append((library, "library_ms", "library_device_ms"))
    for fn, key, _ in timed:
        row[key] = timer(fn)
    row.update({"plain_ms": timer(plain), "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": err})
    for fn, _, key in timed:
        targets = [(row, key, 1)] + ([(total, key, times)] if total is not None else [])
        timer.device_later(fn, *targets)
    if total is not None:
        for _, key, _ in timed:
            total[key] += times * row[key]
        total["plain_ms"] += times * row["plain_ms"]
        total["bytes"] += times * nbytes
        total["ops"] += times * nops
        total["err"] = max(total["err"], err)
    return row


def decode_entry(total, rate, **head):
    """``total`` turned, in place, into a kernels-line entry led by ``head``
    (its device times arrive with ``Timer.measure_device``)."""
    err = total.pop("err")
    b_ms, b_by = bound_ms(total.pop("bytes"), total.pop("ops"), rate)
    numbers = dict(total)
    total.clear()
    total.update(head)
    total.update(numbers, max_abs_err=err, bound_ms=b_ms, bound_by=b_by, device_ms_by=DEVICE_MS_BY)
    return total


def prefill_row(timer, body_launches, what, call, plain, library, nbytes, nops, *, rtol=0.0,
                rate=INT8_OPS_PER_S, times=1, total=None):
    """A v3 or v2 prefill shape (``body_launches`` reads the kernel's body
    counts): the body the rule picks must be the tensor-core one and agree
    with the plain version within ``rtol`` (v3: identical); it is timed
    beside the direct body on the same inputs, the plain version and the
    yardstick.  ``times`` adds the row that many times into ``total``."""
    before = body_launches()
    got = call(None)
    body = [b for b, c in body_launches().items() if c != before[b]]
    if body != ["mma"]:
        fail(f"{what}: took the {body} body, not mma")
    want = plain()
    err = check_close(f"{what} (mma body)", got, want, rtol)
    check_close(f"{what} (direct body)", call("direct"), want, rtol)
    del got, want
    t_k, t_d = timer(lambda: call(None)), timer(lambda: call("direct"))
    t_p, t_lib = timer(plain), timer(library)
    b_ms, b_by = bound_ms(nbytes, nops, rate)
    row = {"ms": t_k, "direct_ms": t_d, "plain_ms": t_p, "library_ms": t_lib, "bound_ms": b_ms,
           "bound_by": b_by, "max_abs_err": err, "faster_than_direct": t_k < t_d}
    if total is not None:
        for key, v in (("ms", t_k), ("direct_ms", t_d), ("plain_ms", t_p), ("library_ms", t_lib),
                       ("bytes", nbytes), ("ops", nops)):
            total[key] += times * v
        total["err"] = max(total["err"], err)
    return row


def prefill_entry(total, shape, source=MMA_SOURCE, rate=INT8_OPS_PER_S):
    b_ms, b_by = bound_ms(total["bytes"], total["ops"], rate)
    return {"shape": shape, "source": source, "ms": total["ms"],
            "direct_ms": total["direct_ms"], "plain_ms": total["plain_ms"],
            "library_ms": total["library_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": total["err"], "faster_than_direct": total["ms"] < total["direct_ms"]}


def v3_bytes(m, k, n, e=1):
    """Bytes v3 must move: int8 x and pulses, f32 rho, per-row a, f32 out."""
    return e * (m * k + k * n + 4 * (k // GROUP) * n + 4 * m + 4 * m * n)


def v2_bytes(m, k, n, e=1, itemsize=4):
    """Bytes v2 must move: x and out in x's dtype, int8 pulses, f32 rho."""
    return e * (itemsize * m * k + k * n + 4 * (k // GROUP) * n + itemsize * m * n)


def check_matmuls(torch, timer, mm, ops, quantize, kernels_mod):
    """Kernels v3 (int8 x) and v2 (f32 x) at one layer's decode shapes and
    deepseek's 2-D decode shapes (v2 against its direct body too), v2 at the
    prefill FFN shape, and v3 and v2 at prefill: one layer's 7 matmuls and
    deepseek's lm_head at m 512, each against its direct body too; returns
    their kernel-line entries and details."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    layer = []
    for k, n in LAYER_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda")
        pulses, scales, _ = ops.encode_weight_matrix(w, group=GROUP, k_pulses=GROUP)
        layer.append((pulses, scales))
    rows = []
    totals = {"pvq_matmul_q": _decode_total(), "pvq_matmul": _decode_total(direct=True)}
    m = DECODE_M
    for (k, n), (pulses, scales) in zip(LAYER_SHAPES, layer):
        x = torch.randn(m, k, generator=gen, device="cuda")
        x_q, a = quantize(x)
        w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=0)
        # v3 is identical to its plain version by construction; v2's f64
        # group sums run in another order (the same f32 value unless a sum
        # lies on an f32 rounding boundary)
        for name, kern, plain, direct, nbytes, rate, tol, bodies in (
            ("pvq_matmul_q", partial(mm.pvq_matmul_q_cuda, x_q, pulses, scales, a, group=GROUP),
             partial(mm.pvq_matmul_q_plain, x_q, pulses, scales, a, group=GROUP), None,
             v3_bytes(m, k, n), INT8_OPS_PER_S, 0.0, kernels_mod.v3_body_launches),
            ("pvq_matmul", partial(mm.pvq_matmul_cuda, x, pulses, scales, group=GROUP),
             partial(mm.pvq_matmul_plain, x, pulses, scales, group=GROUP),
             partial(mm.pvq_matmul_cuda, x, pulses, scales, group=GROUP, _body="direct"),
             v2_bytes(m, k, n), F64_TC_FLOPS_PER_S, 1e-5, kernels_mod.v2_body_launches),
        ):
            rows.append(decode_row(timer, {"kernel": name, "m": m, "k": k, "n": n}, kern, plain,
                                   partial(torch.matmul, x, w_deq), nbytes, 2.0 * m * k * n,
                                   rate, tol=tol, body_launches=bodies, direct=direct,
                                   total=totals[name]))
    # v2 at the prefill FFN shape (v3's prefill rows are below)
    k, n = LAYER_SHAPES[4]
    pulses, scales = layer[4]
    m = PREFILL_M
    x = torch.randn(m, k, generator=gen, device="cuda")
    w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=0)
    def kern(): return mm.pvq_matmul_cuda(x, pulses, scales, group=GROUP)
    def plain(): return mm.pvq_matmul_plain(x, pulses, scales, group=GROUP)
    err = check_close(f"pvq_matmul m{m} k{k} n{n}", kern(), plain(), 1e-5)
    b_ms, b_by = bound_ms(v2_bytes(m, k, n), 2.0 * m * k * n, F64_TC_FLOPS_PER_S)
    rows.append({"kernel": "pvq_matmul", "m": m, "k": k, "n": n, "ms": timer(kern),
                 "plain_ms": timer(plain), "library_ms": timer(lambda: torch.matmul(x, w_deq)),
                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
    del w_deq
    # v3 and v2 (f32 x; against its direct body too) at deepseek's 2-D
    # decode shapes, m 4
    ds_decode, ds_decode_v2 = _decode_total(), _decode_total(direct=True)
    m = DECODE_M
    for what, k, n in DEEPSEEK_DECODE_SHAPES:
        pulses = torch.randint(-9, 10, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        scales = torch.rand(k // GROUP, n, generator=gen, device="cuda") * 0.01
        x = torch.randn(m, k, generator=gen, device="cuda")
        x_q, a = quantize(x)
        w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=0)
        rows.append(decode_row(
            timer, {"kernel": "pvq_matmul_q", "matrix": f"deepseek {what}", "m": m, "k": k, "n": n},
            partial(mm.pvq_matmul_q_cuda, x_q, pulses, scales, a, group=GROUP),
            partial(mm.pvq_matmul_q_plain, x_q, pulses, scales, a, group=GROUP),
            partial(torch.matmul, x, w_deq), v3_bytes(m, k, n), 2.0 * m * k * n, INT8_OPS_PER_S,
            body_launches=kernels_mod.v3_body_launches, total=ds_decode))
        rows.append(decode_row(
            timer, {"kernel": "pvq_matmul", "matrix": f"deepseek {what}", "m": m, "k": k, "n": n},
            partial(mm.pvq_matmul_cuda, x, pulses, scales, group=GROUP),
            partial(mm.pvq_matmul_plain, x, pulses, scales, group=GROUP),
            partial(torch.matmul, x, w_deq), v2_bytes(m, k, n), 2.0 * m * k * n,
            F64_TC_FLOPS_PER_S, tol=1e-5, body_launches=kernels_mod.v2_body_launches,
            direct=partial(mm.pvq_matmul_cuda, x, pulses, scales, group=GROUP, _body="direct"),
            total=ds_decode_v2))
    # v3 and v2 at prefill: one layer's 7 matmuls, then deepseek's lm_head
    prefill = {"smollm_layer_m512": _new_total(), "deepseek_lm_head_m512": _new_total()}
    v2_prefill = {"smollm_layer_m512": _new_total(), "deepseek_lm_head_m512": _new_total()}
    v2_device = []
    lm_pulses = torch.randint(-9, 10, LM_HEAD, generator=gen, device="cuda", dtype=torch.int8)
    lm_scales = torch.rand(LM_HEAD[0] // GROUP, LM_HEAD[1], generator=gen, device="cuda") * 0.01
    shapes = [("smollm_layer_m512", k, n, layer[i]) for i, (k, n) in enumerate(LAYER_SHAPES)]
    shapes.append(("deepseek_lm_head_m512", *LM_HEAD, (lm_pulses, lm_scales)))
    m = PREFILL_M
    for key, k, n, (pulses, scales) in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda")
        x_q, a = quantize(x)
        w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=0)
        def call(body): return mm.pvq_matmul_q_cuda(x_q, pulses, scales, a, group=GROUP, _body=body)
        def plain(): return mm.pvq_matmul_q_plain(x_q, pulses, scales, a, group=GROUP)
        row = prefill_row(timer, kernels_mod.v3_body_launches, f"pvq_matmul_q m{m} k{k} n{n}",
                          call, plain, lambda: torch.matmul(x, w_deq), v3_bytes(m, k, n),
                          2.0 * m * k * n, total=prefill[key])
        rows.append({"kernel": "pvq_matmul_q", "m": m, "k": k, "n": n, **row})
        # v2 (the f32 leg) on the same f32 x: within rtol 1e-5 of plain
        def call_f(body): return mm.pvq_matmul_cuda(x, pulses, scales, group=GROUP, _body=body)
        def plain_f(): return mm.pvq_matmul_plain(x, pulses, scales, group=GROUP)
        row = prefill_row(timer, kernels_mod.v2_body_launches, f"pvq_matmul m{m} k{k} n{n}",
                          call_f, plain_f, lambda: torch.matmul(x, w_deq), v2_bytes(m, k, n),
                          2.0 * m * k * n, rtol=1e-5, rate=F64_TC_FLOPS_PER_S,
                          total=v2_prefill[key])
        row.update(kernel="pvq_matmul", m=m, k=k, n=n)
        rows.append(row)
        # the kernel and the yardstick, for their device times (queued below)
        v2_device.append((key, row, partial(mm.pvq_matmul_cuda, x, pulses, scales, group=GROUP),
                          partial(torch.matmul, x, w_deq)))
        del w_deq
    del lm_pulses, lm_scales
    entries = {}
    for name, tot in totals.items():
        v3 = name == "pvq_matmul_q"
        entries[name] = decode_entry(
            tot, INT8_OPS_PER_S if v3 else F64_TC_FLOPS_PER_S, name=name, route="cuda",
            source=SPLITK_SOURCE if v3 else F_SPLITK_SOURCE,
            replaces=("src/repro/kernels/pvq_matmul.py:596" if v3
                      else "src/repro/kernels/pvq_matmul.py:229"),
            shape=f"one decoder layer's 7 matmuls, m={DECODE_M}, group {GROUP}")
    ds_shape = "deepseek's 2-D decode matrices: " + ", ".join(
        f"{what} {k} x {n}" for what, k, n in DEEPSEEK_DECODE_SHAPES) + f", m={DECODE_M}"
    entries["pvq_matmul_q"]["decode"] = {"deepseek_2d_m4": decode_entry(
        ds_decode, INT8_OPS_PER_S, shape=ds_shape)}
    entries["pvq_matmul"]["decode"] = {"deepseek_2d_m4": decode_entry(
        ds_decode_v2, F64_TC_FLOPS_PER_S, shape=ds_shape + ", f32 x")}
    entries["pvq_matmul_q"]["prefill"] = {
        "smollm_layer_m512": prefill_entry(
            prefill["smollm_layer_m512"],
            f"one decoder layer's 7 matmuls, m={PREFILL_M}, group {GROUP}"),
        "deepseek_lm_head_m512": prefill_entry(
            prefill["deepseek_lm_head_m512"],
            f"lm_head k {LM_HEAD[0]} n {LM_HEAD[1]}, m={PREFILL_M}, group {GROUP}"),
    }
    entries["pvq_matmul"]["prefill"] = {
        key: prefill_entry(v2_prefill[key], f"{shape}, m={PREFILL_M}, group {GROUP}, f32 x",
                           F_MMA_SOURCE, F64_TC_FLOPS_PER_S)
        for key, shape in (("smollm_layer_m512", "one decoder layer's 7 matmuls"),
                           ("deepseek_lm_head_m512", f"lm_head k {LM_HEAD[0]} n {LM_HEAD[1]}"))
    }
    for key, row, kern, library in v2_device:
        entry = entries["pvq_matmul"]["prefill"][key]
        timer.device_later(kern, (row, "device_ms", 1), (entry, "device_ms", 1))
        timer.device_later(library, (row, "library_device_ms", 1), (entry, "library_device_ms", 1))
    return entries, rows


# kernel v4's timed rows: (what, batch, S) at smollm-360m's full width (5
# kv heads, m = 3 query heads per kv head, hd 64, KV group 32), planes in
# the packed cache's own (batch, S, 5, X) layout and every position live:
# smollm's decode (prompt 128 + 32 new tokens), CI's prompt-512 --kv-pvq
# smoke (batch 1, 512 + 8), and smollm's published context at batch 4 and
# at batch 1 (5 CTAs: whether the grid is too thin for a row's passes)
ATTN_ROWS = [("smollm decode", BATCH, 160), ("ci long-context smoke", 1, 520),
             ("smollm published context", BATCH, 2048),
             ("smollm published context, batch 1", 1, 2048)]
ATTN_N_KV, ATTN_M, ATTN_HD, ATTN_GROUP = 5, 3, 64, 32
ATTN_SOURCE = "src/repro_torch/kernels/csrc/pvq_attn_decode.cuh"


def attn_bytes(bh, m, s, hd, ng):
    """Bytes v4 must move: int8 q and its f32 scale, the int8 K/V planes and
    their f32 scales for S live positions, kv_len, f32 acc, m and l."""
    return bh * m * hd + 4 * bh * m + 2 * bh * s * hd + 2 * 4 * bh * s * ng + 4 * bh \
        + 4 * bh * m * hd + 2 * 4 * bh * m


def check_attention(torch, timer, mm, quant, rows_spec=ATTN_ROWS,
                    geometry=(ATTN_N_KV, ATTN_M, ATTN_HD, ATTN_GROUP), seed=2):
    """Kernel v4 at each of ``rows_spec`` (``(what, batch, S)``; by default
    ``ATTN_ROWS``) at ``geometry`` (kv heads, query rows a kv head, head
    dim, group; by default smollm-360m's): identical to its plain version,
    timed (events and device) beside the plain version and
    ``scaled_dot_product_attention`` on the dequantized f32 K/V; the first
    row also with the L2 warm between launches (``warm_ms``,
    ``warm_device_ms``), as the decode step finds it right after the layer
    that wrote the cache.  The entry's numbers are the first row's, each
    row is under ``decode``."""
    n_kv, m, hd, group = geometry
    ng = hd // group
    scale = hd ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(seed)
    plan = getattr(mm, "_v4_plan", None)  # a parent tree (--tree) may not have one
    entry = {"name": "pvq_attn_q", "route": "cuda", "source": ATTN_SOURCE,
             "replaces": "src/repro/kernels/pvq_matmul.py:813", "device_ms_by": DEVICE_MS_BY}
    rows = {}
    for i, (what, b, s) in enumerate(rows_spec):
        bh = b * n_kv
        q_i8, a = quant(torch.randn(bh, m, hd, generator=gen, device="cuda"))
        kp = torch.randint(-20, 21, (b, s, n_kv, hd), generator=gen, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-20, 21, (b, s, n_kv, hd), generator=gen, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand(b, s, n_kv, ng, generator=gen, device="cuda") * 0.1
        vs = torch.rand(b, s, n_kv, ng, generator=gen, device="cuda") * 0.1
        kv_len = torch.full((bh,), s, dtype=torch.int32, device="cuda")
        args = (q_i8, a, kp, ks, vp, vs, kv_len)
        kern = partial(mm.pvq_attn_q_cuda, *args, group=group, sm_scale=scale)
        plain = partial(mm.pvq_attn_q_plain, *args, group=group, sm_scale=scale)
        err = 0.0
        for name, got, want in zip(("acc", "m", "l"), kern(), plain()):
            err = max(err, check_close(f"pvq_attn_q {what} {name}", got, want, 0.0))

        def planes(t):  # (b, S, n_kv, X) -> (BH, 1, S, X)
            return t.permute(0, 2, 1, 3).reshape(bh, 1, s, t.shape[-1])

        kd = planes(kp).float() * torch.repeat_interleave(planes(ks), group, dim=-1)
        vd = planes(vp).float() * torch.repeat_interleave(planes(vs), group, dim=-1)
        qf = (q_i8.float() * a)[:, None]
        library = partial(torch.nn.functional.scaled_dot_product_attention, qf, kd, vd,
                          scale=scale)
        b_ms, b_by = bound_ms(attn_bytes(bh, m, s, hd, ng), 2.0 * 2 * bh * m * s * hd,
                              INT8_OPS_PER_S)
        row = {"what": what, "shape": f"BH {bh} (batch {b} x {n_kv} kv heads, cache layout), "
                                      f"m {m}, hd {hd}, group {group}, S {s}",
               "plan": list(plan(m, s, hd, group)) if plan else None,
               "max_abs_err": err, "ms": timer(kern), "plain_ms": timer(plain),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": timer(library)}
        # the first row's device times go into the entry too
        into = [row] + ([entry] if i == 0 else [])
        timer.device_later(kern, *[(t, "device_ms", 1) for t in into])
        timer.device_later(library, *[(t, "library_device_ms", 1) for t in into])
        if i == 0:
            row["warm_ms"] = timer(kern, flush=False)
            row["library_warm_ms"] = timer(library, flush=False)
            timer.device_later(kern, *[(t, "warm_device_ms", 1) for t in into], flush=False)
            timer.device_later(library, *[(t, "library_warm_device_ms", 1) for t in into],
                               flush=False)
            entry.update({k: v for k, v in row.items() if k != "what"})
        rows[f"S{s}_batch{b}"] = row
    entry["decode"] = rows
    return entry


# kernel v4 at its chunked-prefill caller (attention_prefill_chunk): one
# slot's gather at smollm's full width (batch 1 x 5 kv heads), a 128-token
# chunk's 128 x 3 query rows, kv_len = the chunk's start: (what, S, kv_len)
ATTN_CHUNK_ROWS = [("chunk at 256, 416-position gather", 416, 256),
                   ("chunk at 1920, smollm's published context", 2048, 1920)]
ATTN_CHUNK_M = 128 * ATTN_M


def check_attention_chunk(torch, timer, mm, quant):
    """Kernel v4 at each of ``ATTN_CHUNK_ROWS``: identical to its plain
    version, timed (events and device) beside it and beside
    ``scaled_dot_product_attention`` on the dequantized f32 K/V under the
    same ``kv_len`` mask.  The bound counts the ``kv_len`` live positions."""
    n_kv, m, hd, group = ATTN_N_KV, ATTN_CHUNK_M, ATTN_HD, ATTN_GROUP
    ng, bh = hd // group, ATTN_N_KV
    scale = hd ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(5)
    plan = getattr(mm, "_v4_plan", None)
    rows = {}
    for what, s, kv_len in ATTN_CHUNK_ROWS:
        q_i8, a = quant(torch.randn(bh, m, hd, generator=gen, device="cuda"))
        planes = [torch.randint(-20, 21, (1, s, n_kv, hd), generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(1, s, n_kv, ng, generator=gen, device="cuda") * 0.1
                  for _ in range(2)]
        kv = torch.full((bh,), kv_len, dtype=torch.int32, device="cuda")
        args = (q_i8, a, planes[0], scales[0], planes[1], scales[1], kv)
        kern = partial(mm.pvq_attn_q_cuda, *args, group=group, sm_scale=scale)
        plain = partial(mm.pvq_attn_q_plain, *args, group=group, sm_scale=scale)
        err = 0.0
        for name, got, want in zip(("acc", "m", "l"), kern(), plain()):
            err = max(err, check_close(f"pvq_attn_q {what} {name}", got, want, 0.0))

        def dense(pl, sc):  # (1, S, n_kv, X) -> (BH, 1, S, hd) f32
            d = pl.float() * torch.repeat_interleave(sc, group, dim=-1)
            return d[0].permute(1, 0, 2)[:, None]

        mask = (torch.arange(s, device="cuda") < kv_len)[None, None, None, :]
        library = partial(torch.nn.functional.scaled_dot_product_attention,
                          (q_i8.float() * a)[:, None], dense(planes[0], scales[0]),
                          dense(planes[1], scales[1]), attn_mask=mask, scale=scale)
        b_ms, b_by = bound_ms(attn_bytes(bh, m, kv_len, hd, ng), 2.0 * 2 * bh * m * kv_len * hd,
                              INT8_OPS_PER_S)
        row = {"what": what, "shape": f"BH {bh} (one slot x {n_kv} kv heads), m {m} "
                                      f"(128 tokens x {ATTN_M}), hd {hd}, group {group}, "
                                      f"S {s}, kv_len {kv_len}",
               "plan": list(plan(m, s, hd, group)) if plan else None,
               "max_abs_err": err, "ms": timer(kern), "plain_ms": timer(plain, reps=5),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": timer(library)}
        timer.device_later(kern, (row, "device_ms", 1))
        timer.device_later(library, (row, "library_device_ms", 1))
        rows[f"S{s}_kv{kv_len}"] = row
    return rows


def check_batched(torch, timer, mm, quantize, kernels_mod):
    """Batched kernels v3 and v2 at one MoE layer's expert-bank shapes, at
    decode and prefill; the entries total one decode step's MoE layer (up,
    gate and wo: the up/gate shape counts twice), and their ``prefill`` the
    same layer at prefill (v2 in f32 and bf16 x), against the direct body
    too.  The yardstick is ``torch.bmm`` of the f32 x (for bf16 x, its
    values in f32) and the dequantized f32 banks."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    totals = {"pvq_matmul_q_batched": _decode_total(),
              "pvq_matmul_batched": _decode_total(direct=True)}
    prefill = _new_total()
    v2_prefill = {dtype: _new_total() for dtype in (torch.float32, torch.bfloat16)}
    banks = {}
    for what, k, n in BANK_SHAPES:
        pulses = torch.randint(-9, 10, (EXPERTS, k, n), generator=gen, device="cuda",
                               dtype=torch.int8)
        scales = torch.rand(EXPERTS, k // GROUP, n, generator=gen, device="cuda") * 0.01
        banks[what] = (pulses, scales)
    for m in (MOE_DECODE_M, MOE_PREFILL_M):
        for what, k, n in BANK_SHAPES:
            pulses, scales = banks[what]
            x = torch.randn(EXPERTS, m, k, generator=gen, device="cuda")
            x_q, a = quantize(x)
            w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=1)
            e = EXPERTS
            times = 2 if what == "up/gate" else 1
            if m == MOE_PREFILL_M:
                def call(body): return mm.pvq_matmul_q_batched_cuda(x_q, pulses, scales, a,
                                                                    group=GROUP, _body=body)
                def plain(): return mm.pvq_matmul_q_batched_plain(x_q, pulses, scales, a, group=GROUP)
                row = prefill_row(timer, kernels_mod.v3_body_launches,
                                  f"pvq_matmul_q_batched E{e} m{m} k{k} n{n}", call, plain,
                                  lambda: torch.bmm(x, w_deq), v3_bytes(m, k, n, e),
                                  2.0 * e * m * k * n, times=times, total=prefill)
                rows.append({"kernel": "pvq_matmul_q_batched", "bank": what, "experts": e,
                             "m": m, "k": k, "n": n, **row})
                for dtype, tot in v2_prefill.items():
                    xd = x.to(dtype)
                    x32 = xd.float()
                    def call_f(body): return mm.pvq_matmul_batched_cuda(xd, pulses, scales,
                                                                        group=GROUP, _body=body)
                    def plain_f(): return mm.pvq_matmul_batched_plain(xd, pulses, scales, group=GROUP)
                    row = prefill_row(timer, kernels_mod.v2_body_launches,
                                      f"pvq_matmul_batched E{e} m{m} k{k} n{n} {dtype}", call_f,
                                      plain_f, lambda: torch.bmm(x32, w_deq),
                                      v2_bytes(m, k, n, e, xd.element_size()), 2.0 * e * m * k * n,
                                      rtol=1e-5, rate=F64_TC_FLOPS_PER_S, times=times, total=tot)
                    rows.append({"kernel": "pvq_matmul_batched", "bank": what, "experts": e,
                                 "x": str(dtype), "m": m, "k": k, "n": n, **row})
                del w_deq
                continue
            for name, kern, plain, direct, nbytes, rate, tol, bodies in (
                ("pvq_matmul_q_batched",
                 partial(mm.pvq_matmul_q_batched_cuda, x_q, pulses, scales, a, group=GROUP),
                 partial(mm.pvq_matmul_q_batched_plain, x_q, pulses, scales, a, group=GROUP), None,
                 v3_bytes(m, k, n, e), INT8_OPS_PER_S, 0.0, kernels_mod.v3_body_launches),
                ("pvq_matmul_batched",
                 partial(mm.pvq_matmul_batched_cuda, x, pulses, scales, group=GROUP),
                 partial(mm.pvq_matmul_batched_plain, x, pulses, scales, group=GROUP),
                 partial(mm.pvq_matmul_batched_cuda, x, pulses, scales, group=GROUP,
                         _body="direct"),
                 v2_bytes(m, k, n, e), F64_TC_FLOPS_PER_S, 1e-5, kernels_mod.v2_body_launches),
            ):
                rows.append(decode_row(
                    timer, {"kernel": name, "bank": what, "experts": e, "m": m, "k": k, "n": n},
                    kern, plain, partial(torch.bmm, x, w_deq), nbytes, 2.0 * e * m * k * n, rate,
                    tol=tol, body_launches=bodies, direct=direct, times=times,
                    total=totals[name]))
    entries = {}
    for name, tot in totals.items():
        v3 = name == "pvq_matmul_q_batched"
        entries[name] = decode_entry(
            tot, INT8_OPS_PER_S if v3 else F64_TC_FLOPS_PER_S, name=name, route="cuda",
            source=SPLITK_SOURCE if v3 else F_SPLITK_SOURCE,
            replaces=("src/repro/kernels/pvq_matmul.py:619 (pvq_matmul_q_batched), "
                      "src/repro/kernels/pvq_matmul.py:555 (_kernel_q_dma)"
                      if v3 else "src/repro/kernels/pvq_matmul.py:250"),
            shape=f"one MoE layer's expert banks (up, gate, wo), {EXPERTS} experts, "
                  f"m={MOE_DECODE_M}, group {GROUP}")
    banks_m60 = (f"one MoE layer's expert banks (up, gate, wo), {EXPERTS} experts, "
                 f"m={MOE_PREFILL_M}, group {GROUP}")
    entries["pvq_matmul_q_batched"]["prefill"] = {"moe_layer_m60": prefill_entry(prefill, banks_m60)}
    entries["pvq_matmul_batched"]["prefill"] = {
        f"moe_layer_m60_{name}": prefill_entry(v2_prefill[dtype], f"{banks_m60}, {name} x",
                                               F_MMA_SOURCE, F64_TC_FLOPS_PER_S)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
    }
    return entries, rows


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


# the encoder's rows: (what, groups, n, K, the weights' scale, in the
# entry's total).  One smollm layer's weights and the tied embedding (the
# entry's numbers, as the encoder was first timed); a smollm block-fill
# step's KV encode (K and V of 4 sequences x 32 positions x 5 kv heads x 2
# groups of 32, one of its 64 launches); one deepseek MoE layer's up bank
# (64 experts x 2048 x 1408 in groups of 256)
ENCODE_ROWS = [("layer", 40320, 256, 256, 0.03, True),
               ("embedding", 737280, 64, 128, 0.02, True),
               ("kv block-fill", 1280, 32, 127, 1.0, False),
               ("deepseek moe up bank", 720896, 256, 256, 0.03, False)]


def check_encode(torch, timer, enc):
    """The encoder at each of ``ENCODE_ROWS``: identical to its plain
    version, timed by events (``ms``, median of 5) and by torch.profiler
    (``device_ms``) beside the plain version.  The entry totals the layer
    and embedding rows, so its numbers compare with earlier runs."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    entry = {"name": "pvq_encode_batch", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/pvq_encode.cu",
             "replaces": "src/repro/kernels/pvq_encode.py:177",
             "shape": "one layer's weights (40320 x 256, K 256) + embedding (737280 x 64, K 128)",
             "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
             "device_ms_by": DEVICE_MS_BY}
    nbytes = nops = 0.0
    rows = []
    for what, g, n, k, scale, in_total in ENCODE_ROWS:
        w = torch.randn(g, n, generator=gen, device="cuda") * scale
        p, rho = enc.pvq_encode_batch_cuda(w, k_pulses=k)
        p_ref, rho_ref = enc.pvq_encode_batch_plain(w, k_pulses=k)
        bad = int((p != p_ref).any(-1).sum())
        if bad or not torch.equal(rho, rho_ref):
            fail(f"pvq_encode_batch ({what}): {bad} of {g} groups differ from the plain version")
        del p, rho, p_ref, rho_ref
        kern = partial(enc.pvq_encode_batch_cuda, w, k_pulses=k)
        t_k = timer(kern, reps=5)
        t_p = timer(partial(enc.pvq_encode_batch_plain, w, k_pulses=k), reps=3, warmup=1)
        b = 4 * g * n + 4 * g * n + 4 * g
        o = _encode_ops(torch, w, k, enc.DELTA_MAX)
        row = {"kernel": "pvq_encode_batch", "case": what, "groups": g, "n": n, "k": k,
               "ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms(b, o, F32_FLOPS_PER_S)[0],
               "max_abs_err": 0.0}
        timer.device_later(kern, (row, "device_ms", 1),
                           *([(entry, "device_ms", 1)] if in_total else []))
        rows.append(row)
        if in_total:
            entry["ms"] += t_k
            entry["plain_ms"] += t_p
            nbytes, nops = nbytes + b, nops + o
    entry["bound_ms"], entry["bound_by"] = bound_ms(nbytes, nops, F32_FLOPS_PER_S)
    return entry, rows


def _plain_for_cuda(plain):
    """``plain`` answering for a CUDA entry point: the dispatch's tile
    arguments (``_body``, ``_chunk``, ``_plan``, ``_tuned``) are dropped."""
    def call(*args, **kwargs):
        return plain(*args, **{k: v for k, v in kwargs.items() if not k.startswith("_")})
    return call


@contextlib.contextmanager
def plain_versions(mm, enc):
    """For the duration, each kernel wrapper's CUDA entry point is answered
    by its plain version on the same CUDA tensors, so the main path runs end
    to end on the card with no kernel launched and the same glue ops.  The
    package has no such switch: this patches the attributes ``ops`` reads."""
    saved = [(mod, name, getattr(mod, name + "_cuda"))
             for mod, name in ((mm, "pvq_matmul"), (mm, "pvq_matmul_q"),
                               (mm, "pvq_matmul_batched"), (mm, "pvq_matmul_q_batched"),
                               (mm, "pvq_attn_q"), (enc, "pvq_encode_batch"))]
    try:
        for mod, name, _ in saved:
            setattr(mod, name + "_cuda", _plain_for_cuda(getattr(mod, name + "_plain")))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name + "_cuda", fn)


@contextlib.contextmanager
def v2_direct_above_eight(mm):
    """Counts the kernel v2 calls of more than 8 rows that the body rule
    sends to the direct body while active (a harness-only wrapper of
    ``pvq_matmul._v2_body``, which the wrappers look up at each call)."""
    inner, log = mm._v2_body, {"calls": 0, "shapes": set()}

    def logged(m, k, n, group, *rest):
        body = inner(m, k, n, group, *rest)
        if m > 8 and body == "direct":
            log["calls"] += 1
            log["shapes"].add((m, k, n, group))
        return body

    mm._v2_body = logged
    try:
        yield log
    finally:
        mm._v2_body = inner


@contextlib.contextmanager
def v3_direct_where_splitk_fits(mm):
    """Counts the kernel v3 calls of at most 8 rows that the body rule sends
    to the direct body although the splitk body takes their operands (a
    harness-only wrapper of ``pvq_matmul._v3_body``)."""
    inner, log = mm._v3_body, {"calls": 0, "shapes": set()}

    def logged(m, k, n, group, x_ptr, w_ptr):
        body = inner(m, k, n, group, x_ptr, w_ptr)
        if m <= 8 and body == "direct" and mm._splitk_fits(k, n, group, x_ptr, w_ptr):
            log["calls"] += 1
            log["shapes"].add((m, k, n, group))
        return body

    mm._v3_body = logged
    try:
        yield log
    finally:
        mm._v3_body = inner


@contextlib.contextmanager
def v2_direct_where_splitk_fits(mm):
    """Counts the kernel v2 calls of at most 8 rows that the body rule sends
    to the direct body although v2's splitk body takes their operands (a
    harness-only wrapper of ``pvq_matmul._v2_body``)."""
    inner, log = mm._v2_body, {"calls": 0, "shapes": set()}

    def logged(m, k, n, group, x_ptr, w_ptr, x_dtype):
        body = inner(m, k, n, group, x_ptr, w_ptr, x_dtype)
        if m <= 8 and body == "direct" and mm._v2_splitk_fits(k, n, group, x_ptr, w_ptr, x_dtype):
            log["calls"] += 1
            log["shapes"].add((m, k, n, group, str(x_dtype)))
        return body

    mm._v2_body = logged
    try:
        yield log
    finally:
        mm._v2_body = inner


class RoutingLog:
    """Records the top-k expert indices of every MoE routing call while
    ``active`` (a harness-only wrapper of ``nn.moe._topk_argmax``), so the
    f32 leg's routing through the kernels can be compared with its routing
    through the plain versions."""

    def __init__(self, moe):
        self.moe, self.calls, self.active = moe, [], False
        self.inner = moe._topk_argmax

        def recorded(probs, k):
            vals, idx = self.inner(probs, k)
            if self.active:
                self.calls.append(idx.clone())
            return vals, idx

        moe._topk_argmax = recorded

    @contextlib.contextmanager
    def recording(self):
        self.active = True
        try:
            yield self.calls
        finally:
            self.active = False

    def close(self):
        self.moe._topk_argmax = self.inner


def _launch_counts(kernels_mod):
    return (kernels_mod.launches(), kernels_mod.v3_body_launches(),
            kernels_mod.v2_body_launches())


def decode_legs(torch, serve, quant, kernels_mod, state, prompt, gen, kvq, *, eager):
    """The full-width path's decode work again on its model, parameters and
    tokens: ``generate`` on the prompt (its tokens, each step's logits and
    ``decode_ms_per_step``), then the served leg's and the f32 leg's
    teacher-forced logits; captured (replays of the serve's graphs) or, with
    ``eager``, the host-int step.  Also returns the launch counts of these
    calls and their peak device memory."""
    model, params, seq = state["model"], state["params"], state["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launches()
    timings, logits = {}, []
    with quant.act_quant_scope(quant.ActQuant()), quant.kv_quant_scope(kvq):
        tokens = serve.generate(model, params, seq[:, :prompt], gen=gen, cache_len=prompt + gen,
                               timings=timings, eager=eager, step_logits=logits)
        lg_q = serve.teacher_forced_logits(model, params, seq, prompt_len=prompt, eager=eager)
    with quant.act_quant_scope(None), quant.kv_quant_scope(None):
        lg_f = serve.teacher_forced_logits(model, params, seq, prompt_len=prompt, eager=eager)
    torch.cuda.synchronize()
    return {"tokens": tokens, "step_logits": torch.stack(logits, 1), "logits_q": lg_q,
            "logits_f": lg_f, "decode_ms_per_step": 1e3 * timings["decode_s"] / gen,
            "launches": _launch_counts(kernels_mod),
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}


def captured_vs_eager(torch, serve, quant, kernels_mod, state, report, prompt, gen, kvq, smi):
    """The full-width serve ran captured: its tokens and both legs'
    teacher-forced logits must equal the eager step's on the same
    parameters and prompts bit for bit, and so must a second captured
    ``generate`` of the same shape, which must capture nothing and launch
    on the card (replays accounted) what the eager calls launch.  Prints
    ``decode_ms_per_step`` both ways, the captures per key and the peak
    memory, beside the card's name and power limit.  Returns the eager
    run's outputs (for the plain-path comparison)."""
    captures = serve.TRACE_COUNTS["decode_step"]
    cap = decode_legs(torch, serve, quant, kernels_mod, state, prompt, gen, kvq, eager=False)
    recaptured = serve.TRACE_COUNTS["decode_step"] - captures
    eager = decode_legs(torch, serve, quant, kernels_mod, state, prompt, gen, kvq, eager=True)
    keys = serve._captured_step(state["model"])
    per_key = sorted(len(static.graphs) for static in keys.values())
    same = {
        "served_tokens": torch.equal(state["seq"], eager["tokens"])
        and torch.equal(cap["tokens"], eager["tokens"]),
        "served_step_logits": torch.equal(cap["step_logits"], eager["step_logits"]),
        "served_leg_teacher_forced": torch.equal(state["logits_q"], eager["logits_q"])
        and torch.equal(cap["logits_q"], eager["logits_q"]),
        "f32_leg_teacher_forced": torch.equal(state["logits_f"], eager["logits_f"])
        and torch.equal(cap["logits_f"], eager["logits_f"]),
        "kernel_launches": cap["launches"] == eager["launches"],
    }
    print(json.dumps({"captured_vs_eager": {
        "arch": report["arch"], "card": smi, "identical": same,
        "decode_ms_per_step": {"serve_first_generate_captured": report["decode_ms_per_step"],
                               "captured": cap["decode_ms_per_step"],
                               "eager": eager["decode_ms_per_step"]},
        "decode_step_captures": report["decode_step_captures"],
        "captures_by_second_generate": recaptured, "graphs_per_key": per_key,
        "kernel_launches": {"captured": cap["launches"][0], "eager": eager["launches"][0]},
        "v3_body_launches": {"captured": cap["launches"][1], "eager": eager["launches"][1]},
        "v2_body_launches": {"captured": cap["launches"][2], "eager": eager["launches"][2]},
        "peak_device_memory_bytes": {"serve_captured": report["peak_device_memory_bytes"],
                                     "decode_legs_captured": cap["peak_device_memory_bytes"],
                                     "decode_legs_eager": eager["peak_device_memory_bytes"]},
    }}), flush=True)
    if not all(same.values()):
        fail(f"{report['arch']}: the captured step differs from the eager step: {same}")
    if recaptured or not per_key or max(per_key) > 2:
        fail(f"{report['arch']}: {recaptured} captures in a second generate of the same shape, "
             f"graphs per key {per_key}")
    return eager


def serve_full(torch, serve, kernels_mod, mm, enc, quant, routing, argv, *, kvq, expect, smi):
    """The main path at full width (the decode step captured), then the same
    prompts and tokens through the eager step (identical, see
    ``captured_vs_eager``), then the teacher-forced tokens and packed
    parameters through the plain versions on the card.  ``kvq`` is the
    served leg's KV contract (None: dense cache); ``expect`` names the
    kernels the path must launch.  Returns the launch counts, kernel v3's
    by body, kernel v2's by body, and the served tokens and both legs'
    teacher-forced logits (on the host, for the tune phase)."""
    batch, prompt, gen = (int(argv[argv.index(f) + 1]) for f in ("--batch", "--prompt-len", "--gen"))
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launches()
    t0 = time.time()
    with v2_direct_above_eight(mm) as v2_direct, \
            v2_direct_where_splitk_fits(mm) as v2_direct_small, \
            v3_direct_where_splitk_fits(mm) as v3_direct:
        report, rc, state = serve.run(argv, return_state=True)
    counts = kernels_mod.launches()
    bodies = kernels_mod.v3_body_launches()
    v2_bodies = kernels_mod.v2_body_launches()
    report["phase_wall_s"] = round(time.time() - t0, 2)
    print(json.dumps({"serve": "full", **report}), flush=True)
    if not state:
        fail(f"full serve stopped early: {report}")
    if report.get("generated_shape") != [batch, prompt + gen] or not report.get("logits_finite"):
        fail(f"full serve produced {report.get('generated_shape')} / finite={report.get('logits_finite')}")
    missing = [name for name in expect if counts[name] <= 0]
    if missing:
        fail(f"full serve never launched {missing}: {counts}")
    # prefill and the teacher-forced legs run v3 at m > 8: the tensor cores
    if bodies["mma"] <= 0:
        fail(f"full serve never launched v3's mma body: {bodies}")
    # decode runs v3 at m <= 8: the contraction split over CTAs
    if bodies["splitk"] <= 0:
        fail(f"full serve never launched v3's splitk body: {bodies}")
    if v3_direct["calls"]:
        fail(f"full serve ran {v3_direct['calls']} v3 calls of at most 8 rows on the direct "
             f"body where the splitk body fits: {sorted(v3_direct['shapes'])}")
    # the f32 leg's prefill runs v2 at m > 8: the f64 tensor cores
    if v2_bodies["mma"] <= 0:
        fail(f"full serve never launched v2's mma body: {v2_bodies}")
    if v2_direct["calls"]:
        fail(f"full serve ran {v2_direct['calls']} v2 calls above 8 rows on the direct body: "
             f"{sorted(v2_direct['shapes'])}")
    # the f32 leg's decode runs v2 at m <= 8: the contraction split over CTAs
    if v2_bodies["splitk"] <= 0:
        fail(f"full serve never launched v2's splitk body: {v2_bodies}")
    if v2_direct_small["calls"]:
        fail(f"full serve ran {v2_direct_small['calls']} v2 calls of at most 8 rows on the "
             f"direct body where the splitk body fits: {sorted(v2_direct_small['shapes'])}")
    if rc != 0 and "agreement_fail" not in report:
        fail(f"full serve exited {rc}: {report}")
    if report["decode_step_captures"] < 1:
        fail(f"full serve captured no decode step: {report}")

    # the eager step's legs, with their routing decisions recorded (the
    # captured run's equal them: captured_vs_eager)
    routing.calls.clear()
    with routing.recording():
        eager = captured_vs_eager(torch, serve, quant, kernels_mod, state, report, prompt, gen,
                                  kvq, smi)
    kernel_routes = list(routing.calls)

    t0 = time.time()
    routing.calls.clear()
    with plain_versions(mm, enc), routing.recording():
        with quant.act_quant_scope(quant.ActQuant()), quant.kv_quant_scope(kvq):
            plain_q = serve.teacher_forced_logits(state["model"], state["params"], state["seq"],
                                                  prompt_len=prompt, eager=True)
        n_q = len(routing.calls)
        with quant.act_quant_scope(None), quant.kv_quant_scope(None):
            plain_f = serve.teacher_forced_logits(state["model"], state["params"], state["seq"],
                                                  prompt_len=prompt, eager=True)
    legs = {}
    served = "int8_kv_pvq" if kvq else "int8"
    for leg, kern, plain in ((served, eager["logits_q"], plain_q),
                             ("f32", eager["logits_f"], plain_f)):
        ag = serve.top1_agreement(plain, kern)
        legs[leg] = {
            "identical": torch.equal(kern, plain),
            "max_abs_logit_diff": float((kern - plain).abs().max()),
            "rel_l2_logit_diff": float((kern - plain).norm() / plain.norm()),
            "agreement": ag["top1_agreement"], "agreement_strict": ag["top1_agreement_strict"],
        }
    if routing.calls:
        # the kernel run's last teacher-forced leg is its f32 leg
        plain_f_routes = routing.calls[n_q:]
        kern_f_routes = kernel_routes[len(kernel_routes) - len(plain_f_routes):]
        kern_q_routes = kernel_routes[-2 * len(plain_f_routes):-len(plain_f_routes)]
        legs["f32"]["routing_decisions"] = sum(int(r.numel()) for r in plain_f_routes)
        legs["f32"]["routing_decisions_differing"] = sum(
            int((a != b).sum()) for a, b in zip(kern_f_routes, plain_f_routes))
        # how far the served leg's routing is from the f32 leg's (kernel path)
        legs["f32"]["served_vs_f32_routing_decisions_differing"] = sum(
            int((a != b).sum()) for a, b in zip(kern_q_routes, kern_f_routes))
    print(json.dumps({"full_width_kernels_vs_plain_on_card": legs, "arch": report["arch"],
                      "seconds": round(time.time() - t0, 2),
                      "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}), flush=True)
    print(json.dumps({"full_width_f32_leg_agreement": {
        "arch": report["arch"], "required_by_ci_at_reduced": 0.99,
        "measured": report["act_int8_top1_agreement"],
        "strict": report["act_int8_top1_agreement_strict"],
    }}), flush=True)
    # the served leg runs kernels v3 (2-D and batched), v4 and the encoder,
    # each identical to its plain version by construction: the logits must
    # be too
    if not legs[served]["identical"]:
        fail(f"full-width served leg: kernel path differs from the plain path {legs[served]}")
    # the f32 leg runs kernel v2 (2-D and batched), whose f64 group sums run
    # in another order than the plain version's: CI's agreement threshold
    # holds it
    if legs["f32"]["agreement"] < AGREEMENT_MIN:
        fail(f"full-width f32 leg: kernel path vs plain path agreement {legs['f32']}")
    kept = {k: state[k].cpu() for k in ("seq", "logits_q", "logits_f")}
    return counts, bodies, v2_bodies, kept


def serve_reduced(serve, argv, kernels_mod, expect=(), what="reduced", gated=True):
    """A reduced serve: exit 0 and the serve gate (agreement >= 0.99); the
    kernels named in ``expect`` launched (counts set to 0 just before).
    With ``gated=False`` the agreement is printed, not gated (a config the
    reference misses the gate on): the serve must still run to its end."""
    kernels_mod.reset_launches()
    report, rc = serve.run(argv)
    counts = kernels_mod.launches()
    print(json.dumps({"serve": what, "gated": gated, **report}), flush=True)
    # an ungated serve may exit 1 on its agreement alone, its logits finite
    missed_gate_only = "agreement_fail" in report and report.get("logits_finite")
    ran = rc == 0 or (not gated and missed_gate_only)
    if not ran or (gated and report.get("act_int8_top1_agreement", 0.0) < AGREEMENT_MIN):
        fail(f"{what} serve exited {rc}: {report.get('agreement_fail') or report}")
    missing = [name for name in expect if counts[name] <= 0]
    if missing:
        fail(f"{what} serve never launched {missing}: {counts}")
    return report


@contextlib.contextmanager
def launches_by_caller(torch, kernels_mod, attention, paged_cls, model_cls, step_cls, engine_cls):
    """Counts kernel v4's launches from ``attention_prefill_chunk``, the
    encoder's from ``PagedKV.graft_chunk`` (graft and chunk grafts) and
    ``PagedKV.append``, and the chunk steps run (calls of
    ``Model.prefill_chunk``) while active, by harness-only wrappers of those
    attributes, which their callers look up at each call.  They count as
    the global launch counts do: what a wrapper counts while a
    ``CapturedStep`` captures (which launches nothing) is taken back and
    added on every replay of that graph.  Yields ``(counts, warm)``:
    ``warm`` holds ``counts`` as ``PVQEngine.warmup`` left them."""
    keys = ("v4_from_chunk", "encoder_from_graft", "encoder_from_append", "chunks_run")
    counts = dict.fromkeys(keys, 0)
    warm = {}
    captured = []  # the counts of the capture under way
    by_graph = weakref.WeakKeyDictionary()  # CapturedStep -> its capture's counts

    def count(key, n):
        if torch.cuda.is_current_stream_capturing():
            captured[-1][key] += n
        else:
            counts[key] += n

    def wrap(fn, kernel, key):
        def counted(*a, **kw):
            before = kernels_mod.LAUNCHES[kernel] if kernel else 0
            try:
                return fn(*a, **kw)
            finally:
                count(key, kernels_mod.LAUNCHES[kernel] - before if kernel else 1)
        return counted

    def init(self, *a, **kw):
        captured.append(dict.fromkeys(keys, 0))
        try:
            saved_init(self, *a, **kw)
        finally:
            by_graph[self] = captured.pop()

    def replay(self):
        out = saved_replay(self)
        for key, n in by_graph.get(self, {}).items():
            counts[key] += n
        return out

    def warmup(self, *a, **kw):
        try:
            return saved_warmup(self, *a, **kw)
        finally:
            warm.update(counts)

    wrapped = [(attention, "attention_prefill_chunk", "pvq_attn_q", "v4_from_chunk"),
               (paged_cls, "graft_chunk", "pvq_encode_batch", "encoder_from_graft"),
               (paged_cls, "append", "pvq_encode_batch", "encoder_from_append"),
               (model_cls, "prefill_chunk", None, "chunks_run")]
    inner = [getattr(owner, name) for owner, name, _, _ in wrapped]
    saved_init, saved_replay = step_cls.__init__, step_cls.replay
    saved_warmup = engine_cls.warmup
    try:
        for (owner, name, kernel, key), fn in zip(wrapped, inner):
            setattr(owner, name, wrap(fn, kernel, key))
        step_cls.__init__, step_cls.replay, engine_cls.warmup = init, replay, warmup
        yield counts, warm
    finally:
        for (owner, name, _, _), fn in zip(wrapped, inner):
            setattr(owner, name, fn)
        step_cls.__init__, step_cls.replay = saved_init, saved_replay
        engine_cls.warmup = saved_warmup


def same_pages(torch, engine_a, engine_b, paged_leaves) -> bool:
    """Whether two engines' paged layers hold the same bytes in every real
    page (the trash page excluded: only the captured fill writes it) and in
    every tail ring."""
    for a, b in zip(paged_leaves(engine_a.cache), paged_leaves(engine_b.cache)):
        real = slice(0, a.trash_page)
        for name in ("k_pages", "k_page_scales", "v_pages", "v_page_scales"):
            if not torch.equal(getattr(a, name)[real], getattr(b, name)[real]):
                return False
        if not (torch.equal(a.tail_k, b.tail_k) and torch.equal(a.tail_v, b.tail_v)):
            return False
    return True


def reference_trace_counts(prompt_lens, page: int, chunk_tokens: int) -> dict:
    """The reference engine's trace_counts for a run without evictions, by
    its rule: its warm-up traces the prefill and the graft once for every
    prompt bucket (page multiples; with chunking only the buckets within
    one chunk, as longer prompts stream in chunks) and the chunk step once
    when it chunks; such a run traces nothing more.  CI's two smokes give
    ``REFERENCE_TRACE_COUNTS``, as the test holds the reference to."""
    buckets = {max(page, -(-int(n) // page) * page) for n in prompt_lens}
    if chunk_tokens:
        buckets = {lb for lb in buckets if lb <= chunk_tokens}
    return {"decode": 1, "prefill": len(buckets), "graft": len(buckets),
            "chunk": int(bool(chunk_tokens))}


@contextlib.contextmanager
def step_walls(engine_cls):
    """Host wall of each batched admission (prefill and graft, which end
    in a sync) and of each chunk (its tokens come back to the host) while
    active (harness-only wrappers of ``PVQEngine`` methods)."""
    walls = {"prefill_graft": [], "chunk": []}
    saved = {name: getattr(engine_cls, name) for name in ("_run_batch_prefill", "_prefill_step")}

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if key == "prefill_graft" or out:
                walls[key].append(time.perf_counter() - t0)
            return out
        return run

    try:
        engine_cls._run_batch_prefill = timed(saved["_run_batch_prefill"], "prefill_graft")
        engine_cls._prefill_step = timed(saved["_prefill_step"], "chunk")
        yield walls
    finally:
        for name, fn in saved.items():
            setattr(engine_cls, name, fn)


def _mean_ms(values):
    return round(1e3 * statistics.fmean(values), 3) if values else None


def serve_engine(torch, serve, kernels_mod, mm, enc, quant, argv, what, gates):
    """One ``serve --engine`` run (its decode, prefill, graft and chunk
    steps captured by the warm-up, none in the run; the captures must be
    the reference's ``trace_counts`` with two decode graphs) with the launch
    counts set to 0 just before it and read just after, then the same trace
    through the eager engine, whose tokens and real pages must be
    identical, and through the plain versions on the card (eager), whose
    tokens must be identical.  The serve gates named in ``gates``
    (``agreement``, ``speedup``, ``prefix_cache``) must hold, the others are
    printed; every kernel of ``ENGINE_KERNELS`` must launch, and in the
    timed run (the warm-up's counts taken off, replays counted as
    launches) v4 from the chunk caller where the run chunks, the encoder
    from graft and append, and as many chunk steps as the report counts.
    Prints the host wall of an admission's
    prefill and graft and of a chunk, captured and eager.  Returns the
    launch counts, the printed summary and the engine's tokens by request."""
    from repro_torch.core.packed import PagedKV
    from repro_torch.launch.capture import CapturedStep
    from repro_torch.launch.engine import PVQEngine, Request, _paged_leaves
    from repro_torch.nn import attention
    from repro_torch.nn.models import Model

    flag = {f: argv[argv.index(f) + 1] for f in ("--kv-block", "--kv-group")}
    metrics = None
    if what == "ci engine saturate":  # CI runs this smoke with --metrics-out
        metrics = str(ROOT / "build" / "engine_obs")
        argv = argv + ["--metrics-out", metrics]
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launches()
    t0 = time.time()
    with launches_by_caller(torch, kernels_mod, attention, PagedKV, Model, CapturedStep,
                            PVQEngine) as (with_warmup, warm), \
            step_walls(PVQEngine) as walls:
        report, rc, state = serve.run(argv, return_state=True)
    counts = kernels_mod.launches()
    report["phase_wall_s"] = round(time.time() - t0, 2)
    print(json.dumps({"serve": what, **report}), flush=True)
    if not state:
        fail(f"{what} stopped early: {report}")
    failed = [k for k in ("agreement", "speedup", "prefix_cache") if f"{k}_fail" in report]
    if rc != 0 and not failed or set(failed) & set(gates):
        fail(f"{what} exited {rc}: {report}")
    # serve stops checking its gates at the first that fails
    if "prefix_cache" in gates and report["engine_prefix_hits"] < 1:
        fail(f"{what}: no prefix hit")
    if "speedup" in gates and report["engine_speedup_vs_fixed_batch"] < 1.0:
        fail(f"{what}: engine speedup {report['engine_speedup_vs_fixed_batch']} < 1.0")
    missing = [name for name in ENGINE_KERNELS if counts[name] <= 0]
    if missing:
        fail(f"{what} never launched {missing}: {counts}")
    # the timed run's launches by caller (the warm-up's taken off)
    by_caller = {k: n - warm[k] for k, n in with_warmup.items()}
    if by_caller["encoder_from_graft"] <= 0 or by_caller["encoder_from_append"] <= 0:
        fail(f"{what}: the encoder did not run from both graft and append: {by_caller}")
    if by_caller["chunks_run"] != report["engine_chunks"]:
        fail(f"{what}: {by_caller['chunks_run']} chunk steps counted, "
             f"{report['engine_chunks']} reported")
    if report["engine_chunks"] and by_caller["v4_from_chunk"] <= 0:
        fail(f"{what}: {report['engine_chunks']} chunks launched no v4: {by_caller}")
    if metrics:
        from repro_torch.runtime import telemetry

        names = {r["name"] for r in telemetry.validate_metrics_jsonl(metrics + "/metrics.jsonl")}
        spans = {e["name"] for e in telemetry.validate_chrome_trace(metrics + "/trace.json")}
        # the captures' counter and gauge beside what CI's schema gate requires
        need = set(telemetry.ENGINE_REQUIRED_METRICS) | {"serve.decode_step_traces",
                                                          "engine.trace_count"}
        if not need <= names or not set(telemetry.ENGINE_REQUIRED_SPANS) <= spans:
            fail(f"{what}: telemetry lacks {sorted(need - names)} "
                 f"{sorted(set(telemetry.ENGINE_REQUIRED_SPANS) - spans)}")
        # CI's gate itself: python -m repro_torch.runtime.telemetry --validate DIR
        # --require-engine
        telemetry.validate_dir(metrics, require_engine=True)

    if what in REFERENCE_TRACE_COUNTS:
        expected = dict(REFERENCE_TRACE_COUNTS[what])
    else:
        if report["engine_evictions"]:
            fail(f"{what}: {report['engine_evictions']} evictions: the reference's retraces "
                 f"are not derived for such a run")
        expected = reference_trace_counts([len(r.prompt) for r in state["trace"]],
                                          state["engine"].page, state["engine"].chunk_tokens)
    expected["decode"] = 2  # the port's decode graphs: without and with a block fill
    if report["engine_trace_counts"] != expected:
        fail(f"{what}: the engine's captures are {report['engine_trace_counts']}, not the "
             f"reference's {expected} (two decode graphs)")
    if report["engine_trace_counts"] != report["engine_warmup_trace_counts"]:
        fail(f"{what}: the timed run captured: {report['engine_warmup_trace_counts']} after "
             f"the warm-up, {report['engine_trace_counts']} after the run")

    def rerun():
        eng = PVQEngine(state["model"], state["params"], eager=True, **state["engine_kwargs"])
        out = eng.run([Request(rid=r.rid, prompt=list(r.prompt),
                               max_new_tokens=r.max_new_tokens) for r in state["trace"]])
        return eng, out

    kvq = quant.KVQuant(int(flag["--kv-block"]), int(flag["--kv-group"]))
    with quant.act_quant_scope(quant.ActQuant()), quant.kv_quant_scope(kvq):
        with step_walls(PVQEngine) as eager_walls:
            eager_eng, eager = rerun()
        t0 = time.time()
        with plain_versions(mm, enc):
            _, plain = rerun()
    eager_identical = (eager["outputs"] == state["outputs"]
                       and same_pages(torch, eager_eng, state["engine"], _paged_leaves))
    del eager_eng
    state.pop("engine")
    identical = plain["outputs"] == state["outputs"]
    summary = {
        "engine_run": what, "device": report["device"],
        "tokens_per_s": report["engine_tokens_per_s"],
        "ttft_p50_s": report["engine_ttft_p50_s"], "ttft_p99_s": report["engine_ttft_p99_s"],
        "itl_p99_s": report["engine_itl_p99_s"],
        "itl_with_prefill_p99_s": report["engine_itl_with_prefill_p99_s"],
        "prefill_graft_wall_ms": _mean_ms(walls["prefill_graft"]),
        "eager_prefill_graft_wall_ms": _mean_ms(eager_walls["prefill_graft"]),
        "chunk_wall_ms": _mean_ms(walls["chunk"]),
        "eager_chunk_wall_ms": _mean_ms(eager_walls["chunk"]),
        "eager_ttft_p50_s": eager["ttft_p50_s"], "eager_ttft_p99_s": eager["ttft_p99_s"],
        "eager_itl_with_prefill_p99_s": eager["itl_with_prefill_p99_s"],
        "decode_steps": report["engine_decode_steps"], "chunks": report["engine_chunks"],
        "prefill_batches": report["engine_prefill_batches"],
        "prefix_hits": report["engine_prefix_hits"],
        "speedup_vs_fixed_batch": report["engine_speedup_vs_fixed_batch"],
        "baseline_tokens_per_s": report["baseline_tokens_per_s"],
        "engine_token_agreement": report.get("engine_token_agreement"),
        "gates": list(gates),
        "peak_device_memory_bytes": report.get("peak_device_memory_bytes"),
        "kernel_launches": counts, "engine_kernel_launches": report["engine_kernel_launches"],
        "v3_body_launches": report["v3_body_launches"], **by_caller,
        "by_caller_with_warmup": with_warmup,
        "tokens_identical_to_plain_on_card": identical,
        "plain_rerun_seconds": round(time.time() - t0, 2),
        "trace_counts": report["engine_trace_counts"],
        "reference_trace_counts": {**expected, "decode": 1},
        "tokens_and_pages_identical_to_eager": eager_identical,
        "eager_tokens_per_s": eager["tokens_per_s"],
        "eager_decode_steps": eager["decode_steps"],
        "decode_step_captures_of_the_fixed_batch_legs": report["decode_step_captures"],
    }
    if what == "ci engine chunked":
        summary["reference_agreement_at_ci_seed"] = REFERENCE_CI_CHUNKED_AGREEMENT
    print(json.dumps(summary), flush=True)
    if not identical:
        fail(f"{what}: engine tokens through the kernels differ from the plain versions'")
    if not eager_identical:
        fail(f"{what}: the captured engine's tokens or real pages differ from the eager engine's")
    return counts, summary, state["outputs"]


# the tune phase: smollm's first phase and engine run (a) with --tune, then
# the same serve again on the same cache (every lookup a hit)
TUNE_SERVE = FULL_SERVE + ["--tune"]
TUNE_ENGINE = FULL_ENGINE_A + ["--tune"]
TUNE_CACHE_ENV = "REPRO_TORCH_PVQ_TUNE_CACHE"


def _choice(entry):
    """An entry's choice and the rule's, as printed."""
    if "body" in entry:
        return [entry["body"], entry["chunk"]], entry["rule"]
    if "km" in entry:
        return [entry["km"], entry["w"]], entry["rule"]
    return entry["delta_max"], entry["rule"]


def tune_phase(torch, serve, kernels_mod, untuned, untuned_engine, smi, cache):
    """``serve --tune`` against the untuned serves of this process, with the
    autotuner's cache at ``cache`` (a fresh path): see the module docstring,
    item 8.  Returns the summary it prints."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune

    t0 = time.time()
    os.environ[TUNE_CACHE_ENV] = str(cache)
    autotune.clear_memory_cache()
    reports, same = {}, {}

    def tuned_serve(what, argv):
        kernels_mod.reset_launches()
        report, rc, state = serve.run(argv, return_state=True)
        if rc != 0 and "agreement_fail" not in report:
            fail(f"tune phase, {what}: exited {rc}: {report}")
        reports[what] = {k: report[k] for k in ("tuned_tiles", "tune_wall_s", "tune_stats")}
        return state

    for what in ("smollm-360m --tune", "smollm-360m --tune, again"):
        state = tuned_serve(what, TUNE_SERVE)
        same[what] = {leg: torch.equal(state[leg].cpu(), untuned[leg])
                      for leg in ("seq", "logits_q", "logits_f")}
        del state
        if what == "smollm-360m --tune":
            gc.collect()
            torch.cuda.empty_cache()
            state = tuned_serve("smollm-360m engine (a) --tune", TUNE_ENGINE)
            same["smollm-360m engine (a) --tune"] = {
                "outputs": state["outputs"] == untuned_engine}
            del state
            gc.collect()
            torch.cuda.empty_cache()
            # deepseek's shape set, expert banks included, without a serve
            cfg = get_config(MOE_ARCH)
            args = serve.build_parser().parse_args(MOE_FULL_SERVE + ["--tune"])
            report = serve.tune_config(cfg, args, torch.device("cuda"))
            reports[f"{MOE_ARCH} shape set"] = {k: report[k] for k in
                                                ("tuned_tiles", "tune_wall_s", "tune_stats")}
    entries = json.loads(Path(cache).read_text())
    rows = []
    for key, entry in sorted(entries.items()):
        tuned, rule = _choice(entry)
        spread = max(entry["spread_us"], entry["rule_spread_us"])
        row = {"tune_key": key, "rule": rule, "rule_us": entry["rule_us"],
               "rule_spread_us": entry["rule_spread_us"], "tuned": tuned, "us": entry["us"],
               "spread_us": entry["spread_us"], "candidates": entry["candidates"],
               "rule_over_tuned": entry["rule_us"] / entry["us"] if entry["us"] else None,
               "beats_rule_beyond_spread": entry["rule_us"] - entry["us"] > spread}
        rows.append(row)
        print(json.dumps(row), flush=True)
    first, again = (reports[w]["tune_stats"] for w in ("smollm-360m --tune",
                                                       "smollm-360m --tune, again"))
    searches = sum(r["tune_stats"]["searches"] for r in reports.values())
    summary = {"tune_phase": {
        "card": smi, "cache": str(cache), "keys": len(entries), "searches": searches,
        "search_s": sum(r["tune_stats"]["search_s"] for r in reports.values()),
        "tune_wall_s": {w: r["tune_wall_s"] for w, r in reports.items()},
        "stats": {w: {k: r["tune_stats"][k] for k in ("hits", "misses", "searches")}
                  for w, r in reports.items()},
        "identical_to_untuned": same,
        "beats_rule_beyond_spread": [r["tune_key"] for r in rows if r["beats_rule_beyond_spread"]],
        "seconds": round(time.time() - t0, 2)}}
    print(json.dumps(summary), flush=True)
    if searches <= 0:
        fail(f"tune phase: no search ran: {summary}")
    if not all(all(v.values()) for v in same.values()):
        fail(f"tune phase: a tuned serve differs from the untuned one: {same}")
    if again["searches"] or again["misses"] or again["hits"] != first["hits"] + first["misses"] \
            or set(again["by_key"]) != set(first["by_key"]):
        fail(f"tune phase: the second --tune serve was not all hits: {again} after {first}")
    if reports["smollm-360m --tune, again"]["tuned_tiles"] != reports["smollm-360m --tune"]["tuned_tiles"]:
        fail("tune phase: the second --tune serve reported other choices")
    return summary


# the artifact phase: full-width smollm exported at CI's artifact ratio,
# then served from the file with the first phase's flags; CI's reduced
# artifact smoke (ci.yml:34-77) and its deepseek expert gate (ci.yml:155-164)
ARTIFACT_N_OVER_K = "2.0"
# the artifact phase's smollm-360m: published widths, the whole embedding,
# 4 of its 32 layers (the host's entropy coding of all 32 took 250-350 s)
ARTIFACT_LAYERS = 4
ARTIFACT_EXPORT = ["--arch", "smollm-360m", "--n-over-k", ARTIFACT_N_OVER_K, "--seed", "0"]
ARTIFACT_FLAGS = [f for f in FULL_SERVE if f != "--pvq"]
IN_MEMORY_SERVE = FULL_SERVE + ["--n-over-k", ARTIFACT_N_OVER_K]
CI_ARTIFACT_EXPORT = ["--arch", "smollm-360m", "--reduced", "--n-over-k", ARTIFACT_N_OVER_K]
CI_ARTIFACT_SERVE = ["--arch", "smollm-360m", "--reduced", "--batch", "2", "--prompt-len", "8",
                     "--gen", "4", "--act-int8", "--agreement-min", "0.99"]
CI_EXPERT_EXPORT = ["--arch", MOE_ARCH, "--reduced", "--n-over-k", ARTIFACT_N_OVER_K,
                    "--max-expert-bits-per-weight", "2.5"]


def host_cpu() -> str:
    """The host CPU's model name and core count (the entropy codecs run there)."""
    name = "unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return f"{name}, {os.cpu_count()} CPUs"


def _same_leaves(torch, a, b) -> bool:
    """Every leaf of two parameter trees identical: packed pulses, scales
    and metadata, raw tensors in value, dtype and shape."""
    from repro_torch.core.packed import is_packed, sorted_leaves

    fa, fb = dict(sorted_leaves(a)), dict(sorted_leaves(b))
    if list(fa) != list(fb):
        return False
    for path, x in fa.items():
        y = fb[path]
        if is_packed(x) != is_packed(y):
            return False
        if is_packed(x):
            if not (torch.equal(x.pulses, y.pulses) and torch.equal(x.scales, y.scales)
                    and (x.group, x.k, x.shape, x.dtype, x.layout, x.scale_mode)
                    == (y.group, y.k, y.shape, y.dtype, y.layout, y.scale_mode)):
                return False
        elif x.dtype != y.dtype or not torch.equal(x, y):
            return False
    return True


def _prefill_logits_equal(torch, quant, model, a, b, tokens) -> dict:
    """Prefill logits of two parameter trees on the same tokens, bitwise,
    with f32 activations and with the served int8 ones."""
    out = {}
    for leg, aq in (("f32", None), ("int8", quant.ActQuant())):
        with quant.act_quant_scope(aq), quant.kv_quant_scope(None):
            la, _ = model.prefill(a, {"tokens": tokens}, cache_len=tokens.shape[1])
            lb, _ = model.prefill(b, {"tokens": tokens}, cache_len=tokens.shape[1])
        out[leg] = bool(torch.equal(la, lb))
    return out


def artifact_phase(torch, serve, kernels_mod, quant, smi, scratch):
    """The ``.pvqz`` slice (module docstring, item 9).  Returns the artifact
    serve's launch counts and the printed summary."""
    from repro_torch.launch import export

    with depth_cut("smollm-360m", ARTIFACT_LAYERS) as cut:
        print(json.dumps({"artifact_phase_depth": cut}), flush=True)
        return _artifact_phase_cut(torch, serve, kernels_mod, quant, smi, scratch, export, cut)


def _artifact_phase_cut(torch, serve, kernels_mod, quant, smi, scratch, export, cut):
    """:func:`artifact_phase` under its depth cut ``cut``."""
    t_phase = time.time()
    path = str(scratch / "smollm-360m.pvqz")
    kernels_mod.reset_launches()
    t0 = time.time()
    exp, rc = export.run(ARTIFACT_EXPORT + ["--out", path])
    export_wall = time.time() - t0
    export_encoder = kernels_mod.launches()["pvq_encode_batch"]
    if rc != 0:
        fail(f"artifact export exited {rc}: {exp.get('gate_fail')}")
    if export_encoder <= 0:
        fail("artifact export: the encoder kernel never launched")
    codecs = {}
    for leaf in exp["leaves"].values():
        codecs[leaf["codec"]] = codecs.get(leaf["codec"], 0) + 1

    gc.collect()
    torch.cuda.empty_cache()
    kernels_mod.reset_launches()
    t0 = time.time()
    art, rc, art_state = serve.run(
        ARTIFACT_FLAGS + ["--artifact", path, "--metrics-out", str(scratch / "obs-art")],
        return_state=True)
    serve_wall = time.time() - t0
    counts = kernels_mod.launches()
    bodies = kernels_mod.v3_body_launches()
    v2_bodies = kernels_mod.v2_body_launches()
    print(json.dumps({"serve": "full, artifact", "phase_wall_s": round(serve_wall, 2), **art}),
          flush=True)
    if not art_state or (rc != 0 and "agreement_fail" not in art):
        fail(f"artifact serve exited {rc}: {art}")
    if art.get("pvq_mode") != "artifact" or not art.get("logits_finite")             or art.get("generated_shape") != [BATCH, PROMPT + GEN]:
        fail(f"artifact serve: {art}")
    missing = [name for name in SMOLLM_KERNELS if counts[name] <= 0]
    if missing:
        fail(f"artifact serve never launched {missing}: {counts}")

    mem, rc, mem_state = serve.run(IN_MEMORY_SERVE, return_state=True)
    if not mem_state or (rc != 0 and "agreement_fail" not in mem):
        fail(f"in-memory serve at N/K {ARTIFACT_N_OVER_K} exited {rc}: {mem}")
    same = {
        "leaves": _same_leaves(torch, art_state["params"], mem_state["params"]),
        "prefill_logits": _prefill_logits_equal(
            torch, quant, mem_state["model"], art_state["params"], mem_state["params"],
            mem_state["seq"][:, :PROMPT]),
        "tokens": bool(torch.equal(art_state["seq"], mem_state["seq"])),
        "served_leg_teacher_forced": bool(torch.equal(art_state["logits_q"],
                                                      mem_state["logits_q"])),
        "f32_leg_teacher_forced": bool(torch.equal(art_state["logits_f"], mem_state["logits_f"])),
    }
    del art_state, mem_state
    gc.collect()
    torch.cuda.empty_cache()

    # CI's reduced artifact smoke (export, cold-start serve, bit-exact
    # logits against the in-memory tree on a fresh-seed target) and its
    # deepseek expert export gate
    ci_path = str(scratch / "sm.pvqz")
    ci_exp, rc = export.run(CI_ARTIFACT_EXPORT + ["--out", ci_path])
    if rc != 0:
        fail(f"ci artifact export exited {rc}")
    ci_serve, rc = serve.run(CI_ARTIFACT_SERVE + ["--artifact", ci_path, "--metrics-out",
                                                   str(scratch / "obs-art-ci")])
    if rc != 0:
        fail(f"ci artifact serve exited {rc}: {ci_serve}")
    ci_exact = _ci_artifact_logits(torch, ci_path)
    if not ci_exact:
        fail("ci artifact smoke: logits from the file differ from the in-memory packed tree")
    dsl, rc = export.run(CI_EXPERT_EXPORT + ["--out", str(scratch / "dsl.pvqz")])
    if rc != 0:
        fail(f"ci deepseek expert export gate: {dsl.get('gate_fail')}")

    summary = {"artifact_phase": {
        "card": smi, "host_cpu": host_cpu(), "arch": "smollm-360m", "depth": cut,
        "n_over_k": float(ARTIFACT_N_OVER_K),
        "file_bytes": exp["file_bytes"], "bits_per_weight": exp["bits_per_weight"],
        "packed_numel": exp["packed_numel"], "compression_vs_dense": exp["compression_vs_dense"],
        "codecs": codecs, "encode_s": exp["encode_s"], "write_s": exp["write_s"],
        "export_wall_s": round(export_wall, 2), "export_encoder_launches": export_encoder,
        "artifact_decode_s": art["artifact_decode_s"],
        "artifact_decode_mb_s": art.get("artifact_decode_mb_s"),
        "serve_wall_s": round(serve_wall, 2), "identical_to_in_memory": same,
        "agreement": {"artifact": art["act_int8_top1_agreement"],
                      "in_memory": mem["act_int8_top1_agreement"], "gated": False},
        "decode_ms_per_step": {"artifact": art["decode_ms_per_step"],
                               "in_memory": mem["decode_ms_per_step"]},
        "kernel_launches": counts, "v3_body_launches": bodies, "v2_body_launches": v2_bodies,
        "ci_reduced": {"file_bytes": ci_exp["file_bytes"],
                       "bits_per_weight": ci_exp["bits_per_weight"],
                       "agreement": ci_serve["act_int8_top1_agreement"],
                       "artifact_decode_mb_s": ci_serve.get("artifact_decode_mb_s"),
                       "logits_bit_exact": ci_exact,
                       "deepseek_expert_bits_per_weight": dsl["expert_bits_per_weight"]},
        "seconds": round(time.time() - t_phase, 2)}}
    print(json.dumps(summary), flush=True)
    flat = [same["leaves"], *same["prefill_logits"].values(), same["tokens"],
            same["served_leg_teacher_forced"], same["f32_leg_teacher_forced"]]
    if not all(flat):
        fail(f"artifact serve differs from the in-memory packed serve: {same}")
    return counts, summary


def _ci_artifact_logits(torch, path, device="cuda") -> bool:
    """CI's bit-exact step: prefill logits from the file, loaded into a
    fresh-seed target, equal those of ``quantize_params`` on the same init."""
    from repro_torch.checkpoint import load_pvqz
    from repro_torch.configs import get_config
    from repro_torch.core.packed import quantize_params
    from repro_torch.launch.serve import serving_policy
    from repro_torch.nn.models import build_model

    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    qparams = quantize_params(model.init(0, device=device),
                              serving_policy(cfg, float(ARTIFACT_N_OVER_K)))
    restored = load_pvqz(path, target=model.init(123, device=device), device=device)
    toks = torch.arange(16, dtype=torch.int64, device=device).reshape(2, 8) % cfg.vocab_size
    lm, _ = model.prefill(qparams, {"tokens": toks}, cache_len=8)
    la, _ = model.prefill(restored, {"tokens": toks}, cache_len=8)
    return bool(torch.equal(lm, la))


# the paper slice (§VII nets A-D at published width, seed 0): the packed
# serving form at export's group and kernel_apply's default, the test set's
# rows and a decode-sized batch; CI's first artifact gate (ci.yml:27-33);
# Tables 1-4 at the benchmark's fast steps
PAPER_NETS_RUN = ("A", "B", "C", "D")
PAPER_GROUPS = (256, 128)
PAPER_M = (4, 2048)
PAPER_EXPORT = ["--paper-net", "A", "--max-bits-per-weight", "1.65", "--seed", "0"]
# the kernel rows the slice adds: (what, net, packed layer, group, m)
PAPER_ROWS = [("net A head 512 x 10 (direct body)", "A", "layer4", 256, 2048),
              ("net B fc 4096 x 512", "B", "layer9", 256, 2048)]


def _paper_bytes(m, k, n, group, v3):
    """Bytes a paper-net matmul must move: x (int8 with its row scale for
    v3, f32 for v2), int8 pulses, f32 rho, f32 out."""
    x = m * k + 4 * m if v3 else 4 * m * k
    return x + k * n + 4 * (k // group) * n + 4 * m * n


def paper_rows(torch, timer, mm, quantize, kparams):
    """The slice's new matmul shapes (``PAPER_ROWS``) through v3 and v2:
    identical (v3) or within rtol 1e-5 (v2) of the plain version, timed
    beside it and ``torch.matmul`` on the dequantized weights (CUDA
    events, L2 flushed), each with its body and bound."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for what, net_id, layer, group, m in PAPER_ROWS:
        pk = kparams[(net_id, group)][layer]["kernel"]
        k, n = pk.pulses.shape
        x = torch.randn(m, k, generator=gen, device="cuda")
        x_q, a = quantize(x)
        w_deq = pk.pulses.float() * torch.repeat_interleave(pk.scales, pk.group, dim=0)
        for name, kern, plain, tol, rate, bodies in (
            ("pvq_matmul_q", partial(mm.pvq_matmul_q_cuda, x_q, pk.pulses, pk.scales, a,
                                     group=pk.group),
             partial(mm.pvq_matmul_q_plain, x_q, pk.pulses, pk.scales, a, group=pk.group),
             0.0, INT8_OPS_PER_S, mm.V3_BODY_LAUNCHES),
            ("pvq_matmul", partial(mm.pvq_matmul_cuda, x, pk.pulses, pk.scales, group=pk.group),
             partial(mm.pvq_matmul_plain, x, pk.pulses, pk.scales, group=pk.group),
             1e-5, F64_TC_FLOPS_PER_S, mm.V2_BODY_LAUNCHES),
        ):
            before = dict(bodies)
            err = check_close(f"{name} {what} m{m}", kern(), plain(), tol)
            body = [b for b in bodies if bodies[b] != before[b]]
            nbytes = _paper_bytes(m, k, n, pk.group, name == "pvq_matmul_q")
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n, rate)
            rows.append({"kernel": name, "matrix": what, "m": m, "k": k, "n": n,
                         "group": pk.group, "body": body, "ms": timer(kern),
                         "plain_ms": timer(plain),
                         "library_ms": timer(partial(torch.matmul, x, w_deq)),
                         "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
        del w_deq
    return rows


def profile_call(torch, fn, reps=5, attempts=3, match=None):
    """One ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after one
    warm call): the device ms a call (every CUDA kernel's time), the host
    wall a call (under the profiler) and the four kernels with the most
    device time, with their ms a call; with ``match``, also ``match_ms``,
    the device ms a call of the kernels whose name holds it.  A trace whose kernel count is not
    a positive multiple of ``reps`` lost events (``Timer.measure_device``)
    and is taken again, up to ``attempts`` times; after that the numbers
    are marked ``lost_events`` (a diagnostic, not a gate: late in a long
    process the profiler has dropped a whole trace's device events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [evt for evt in prof.events()
                   if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA]
        if kernels and len(kernels) % reps == 0:
            break
    by_name = {}
    for evt in kernels:
        by_name[evt.name] = by_name.get(evt.name, 0.0) + float(evt.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    out = {"device_ms": sum(by_name.values()) / reps / 1e3, "wall_ms": 1e3 * wall / reps,
           "kernels_a_call": len(kernels) / reps,
           "lost_events": not kernels or len(kernels) % reps != 0,
           "top": [[name[:90], us / reps / 1e3] for name, us in top]}
    if match is not None:
        out["match_ms"] = sum(us for name, us in by_name.items() if match in name) / reps / 1e3
    return out


def paper_phase(torch, kernels_mod, mm, enc, quant, smi, scratch):
    """The paper slice (module docstring, item 10).  Returns the kernel path's
    launch counts (all, v3's and v2's bodies), its kernel rows and summary."""
    from repro_torch.checkpoint import load_pvqz
    from repro_torch.configs.paper_nets import PAPER_NETS
    from repro_torch.data.synthetic import ClassifyTask
    from repro_torch.launch import export
    from repro_torch.launch.export import pack_paper_net
    from repro_torch.nn.sequential import SequentialNet
    from repro_torch.paper.experiment import train_net
    from repro_torch.tools import paper_tables

    t_phase = time.time()
    nets = {net_id: SequentialNet(PAPER_NETS[net_id]) for net_id in PAPER_NETS_RUN}
    params = {net_id: net.init(0, device="cuda") for net_id, net in nets.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = {(net_id, m): torch.randn(m, *net.cfg.input_shape, generator=gen, device="cuda")
              for net_id, net in nets.items() for m in PAPER_M}
    legs = (("v2", None), ("v3", quant.ActQuant()))

    # (a) the kernel path, the launch counts set to 0 just before and read
    # just after; then the same calls through the plain versions on the card
    torch.cuda.synchronize()
    kernels_mod.reset_launches()
    kparams, out = {}, {}
    for net_id, net in nets.items():
        for group in PAPER_GROUPS:
            kparams[(net_id, group)] = net.pvq_kernel_encode(params[net_id], group=group)
            for m in PAPER_M:
                for leg, aq in legs:
                    out[(net_id, group, m, leg)] = net.kernel_apply(
                        params[net_id], kparams[(net_id, group)], inputs[(net_id, m)],
                        group=group, act_quant=aq)
    torch.cuda.synchronize()
    counts = _launch_counts(kernels_mod)
    kernels_mod.reset_launches()
    errs = {}
    with plain_versions(mm, enc):
        for net_id, net in nets.items():
            for group in PAPER_GROUPS:
                plain_k = net.pvq_kernel_encode(params[net_id], group=group)
                for name, sub in kparams[(net_id, group)].items():
                    if not (torch.equal(sub["kernel"].pulses, plain_k[name]["kernel"].pulses)
                            and torch.equal(sub["kernel"].scales,
                                            plain_k[name]["kernel"].scales)):
                        fail(f"paper net {net_id} group {group} {name}: the encoder's "
                             f"packing differs from its plain version")
                for m in PAPER_M:
                    for leg, aq in legs:
                        got = out[(net_id, group, m, leg)]
                        want = net.kernel_apply(params[net_id], plain_k, inputs[(net_id, m)],
                                                group=group, act_quant=aq)
                        what = f"paper net {net_id} group {group} m {m} {leg}"
                        if got.shape != (m, 10) or not bool(torch.isfinite(got).all()):
                            fail(f"{what}: logits {tuple(got.shape)}, finite "
                                 f"{bool(torch.isfinite(got).all())}")
                        errs[what] = check_close(what, got, want, 1e-5 if leg == "v2" else 0.0)
    if any(kernels_mod.launches().values()):
        fail(f"the plain path launched kernels: {kernels_mod.launches()}")
    launches, v3_bodies, v2_bodies = counts
    n_fc = sum(len(kp) for kp in kparams.values())
    for leg, bodies in (("v3", v3_bodies), ("v2", v2_bodies)):
        if bodies["direct"] != len(kparams) * len(PAPER_M):  # each net's 10-column head
            fail(f"paper nets: {leg} direct body launched {bodies['direct']} times, "
                 f"not once per call: {bodies}")
        if sum(bodies.values()) != n_fc * len(PAPER_M):
            fail(f"paper nets: {leg} launched {sum(bodies.values())} times for "
                 f"{n_fc * len(PAPER_M)} packed fc calls: {bodies}")
    if launches["pvq_encode_batch"] <= 0:
        fail("paper nets: the encoder never launched")

    timer = Timer(torch)
    times = {}
    for net_id, net in nets.items():
        kp = kparams[(net_id, 256)]
        x = inputs[(net_id, 2048)]
        times[net_id] = {
            "pvq_kernel_encode_ms_group256": timer(partial(net.pvq_kernel_encode, params[net_id],
                                                           group=256), reps=5, warmup=1),
            **{f"kernel_apply_{leg}_m2048_ms": timer(partial(
                net.kernel_apply, params[net_id], kp, x, group=256, act_quant=aq))
               for leg, aq in legs},
            "float_apply_m2048_ms": timer(partial(net.apply, params[net_id], x)),
        }
    rows = paper_rows(torch, timer, mm, quant.quantize_activations, kparams)
    del timer
    # where a call's time goes: kernel_apply at m 2048 and three training
    # steps (the data sampled on the host, as run_net does)
    profiles = {}
    for net_id in ("A", "B"):
        net, kp, x = nets[net_id], kparams[(net_id, 256)], inputs[(net_id, 2048)]
        for leg, aq in legs:
            profiles[f"{net_id} kernel_apply {leg} m2048"] = profile_call(
                torch, partial(net.kernel_apply, params[net_id], kp, x, group=256, act_quant=aq))
        task = ClassifyTask(net.cfg.input_shape, noise=6.0, seed=0)
        profiles[f"{net_id} train 3 steps"] = profile_call(
            torch, partial(train_net, net, task, steps=3, init_params=params[net_id]), reps=2)
    for row in rows:
        print(json.dumps({"paper_kernel_row": row}), flush=True)
    kernel_s = time.time() - t_phase

    # (b) CI's first artifact gate: export --paper-net A at <= 1.65 bits/weight
    t0 = time.time()
    path = str(scratch / "paper_a.pvqz")
    exp, rc = export.run(PAPER_EXPORT + ["--out", path])
    if rc != 0:
        fail(f"export --paper-net A exited {rc}: {exp.get('gate_fail')}")
    loaded = load_pvqz(path, device="cuda")
    in_memory, _ = pack_paper_net("A", nets["A"].init(0, device="cuda"), group=256, seed=0)
    if not _same_leaves(torch, loaded, in_memory):
        fail("export --paper-net A: the file's leaves differ from the in-memory packing")
    export_s = time.time() - t0

    # (c) Tables 1-4 on the card (the benchmark's fast steps), the reference
    # test's gates on net A (tests/test_integration.py:75-82)
    t0 = time.time()
    results = []
    table_rows = paper_tables.tables_1_to_4("".join(PAPER_NETS_RUN), device="cuda",
                                            results=results)
    tables_s = time.time() - t0
    a = results[0]
    gates = {"acc_before > 0.5": a.acc_before > 0.5, "acc_after > 0.3": a.acc_after > 0.3,
             "fold argmax agreement > 0.99": a.fold_check["argmax_agreement"] > 0.99,
             "every layer's zeros > 60%": all(t["0_pct"] > 60 for t in a.weight_tables.values())}

    summary = {"paper_phase": {
        "card": smi, "nets": list(PAPER_NETS_RUN), "groups": list(PAPER_GROUPS),
        "m": list(PAPER_M), "kernel_launches": launches, "v3_body_launches": v3_bodies,
        "v2_body_launches": v2_bodies, "max_abs_err_v2": max(
            v for k, v in errs.items() if k.endswith("v2")),
        "times": times, "profiles": profiles,
        "export": {"bits_per_weight": exp["bits_per_weight"], "file_bytes": exp["file_bytes"],
                   "encode_s": exp["encode_s"], "write_s": exp["write_s"],
                   "identical_after_load": True},
        "tables_1_4": table_rows, "net_a_gates": gates,
        "seconds": {"kernel_path": round(kernel_s, 2), "export": round(export_s, 2),
                    "tables_1_4": round(tables_s, 2),
                    "phase": round(time.time() - t_phase, 2)}}}
    print(json.dumps(summary), flush=True)
    if not all(gates.values()):
        fail(f"net A misses the reference test's gates: {gates}")
    return counts, rows, summary


# the training slice: full-width smollm-360m, --pvq-qat at the config's own
# K (group 256, N/K 1), eager steps; the reduced runs mirror
# tests/test_integration.py:33-43 and tests/test_fault_tolerance.py:60
TRAIN_FULL = ["--arch", "smollm-360m", "--steps", "8", "--batch", "8", "--seq", "64",
              "--pvq-qat", "--pvq-k", "256", "--ckpt-every", "0"]
TRAIN_REDUCED = ["--arch", "smollm-360m", "--reduced", "--steps", "30", "--batch", "8",
                 "--seq", "32", "--pvq-qat", "--pvq-k", "128", "--ckpt-every", "0"]
TRAIN_RECOVERY = ["--arch", "smollm-360m", "--reduced", "--steps", "30", "--batch", "8",
                  "--seq", "32", "--ckpt-every", "5"]
TRAIN_PACKED_LEAF = "segments/seg0/b0/ffn/wi_gate/kernel"  # 32 x 960 x 2560
ENCODE_KERNEL_MATCH = "pvq_encode"


def _tree_equal(torch, a, b) -> bool:
    """Two trainer states ``(params, AdamWState)`` identical, leaf for leaf
    (values, dtypes, devices), the step counter too."""
    from repro_torch.checkpoint.checkpointer import _flatten

    fa, fb = _flatten(a), _flatten(b)
    if list(fa) != list(fb):
        return False
    for key, x in fa.items():
        y = fb[key]
        if isinstance(x, int):
            if x != y:
                return False
        elif x.dtype != y.dtype or x.device != y.device or not torch.equal(x, y):
            return False
    return True


@contextlib.contextmanager
def timed_saves(ckpt_cls, times):
    """Appends each blocking ``Checkpointer.save``'s seconds to ``times``
    while active (a harness-only wrapper of the class method)."""
    save = ckpt_cls.save

    def timed(self, step, state, *, block=True):
        t0 = time.perf_counter()
        out = save(self, step, state, block=block)
        if block:
            times.append(time.perf_counter() - t0)
        return out

    ckpt_cls.save = timed
    try:
        yield
    finally:
        ckpt_cls.save = save


@contextlib.contextmanager
def counted_plain_encoder(enc, calls):
    """Counts the calls of the encoder's plain version while active (the
    dispatch reads ``pvq_encode_batch_plain`` from the module at each call)."""
    plain = enc.pvq_encode_batch_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    enc.pvq_encode_batch_plain = counted
    try:
        yield
    finally:
        enc.pvq_encode_batch_plain = plain


def _projected_leaves(params, project_rule):
    from repro_torch.core.packed import sorted_leaves

    return {path: leaf for path, leaf in sorted_leaves(params) if project_rule(path, leaf)}


def train_phase(torch, kernels_mod, mm, enc, smi, scratch):
    """The training slice (module docstring, item 11).  Returns the
    full-width run's launch counts and its summary."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.packed import pack_matmul, packed_update
    from repro_torch.core.quantize import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.grad_compress import CompressionConfig, make_ef_compressor, wire_bytes

    t_phase = time.time()
    policy = QuantPolicy()
    k_full = int(TRAIN_FULL[TRAIN_FULL.index("--pvq-k") + 1])
    n_steps = int(TRAIN_FULL[TRAIN_FULL.index("--steps") + 1])
    sync = torch.cuda.synchronize

    def projected(path, leaf):  # launch.train's --pvq-qat rule
        return leaf.ndim >= 2 and policy.match(path) and leaf.numel() >= train.QAT_MIN_SIZE

    # (a) the full-width run, the launch counts set to 0 just before and
    # read just after; every blocking save timed
    ckpt_dir = scratch / "train_full"
    save_s, plain_calls = [], []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    kernels_mod.reset_launches()
    t0 = time.time()
    with timed_saves(Checkpointer, save_s), counted_plain_encoder(enc, plain_calls):
        report, rc, st = train.run(TRAIN_FULL + ["--ckpt-dir", str(ckpt_dir), "--device", "cuda"],
                                   return_state=True)
    sync()
    run_s = time.time() - t0
    counts = _launch_counts(kernels_mod)
    launches = counts[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runner, model, step_fn, loader = st["runner"], st["model"], st["step_fn"], st["loader"]
    hist = runner.history
    print(json.dumps({"train_full_report": report}), flush=True)
    if rc != 0 or len(hist) != n_steps:
        fail(f"train (full width) exited {rc} after {len(hist)} steps")
    bad = [h["step"] for h in hist
           if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))]
    if bad:
        fail(f"train (full width): loss or grad norm not finite at steps {bad}")
    if runner.restores:
        fail(f"train (full width): {runner.restores} restores (a step raised)")
    n_leaves = len(_projected_leaves(runner.state[0], projected))
    if launches["pvq_encode_batch"] != n_leaves * n_steps or plain_calls:
        fail(f"train (full width): the encoder launched {launches['pvq_encode_batch']} times "
             f"for {n_leaves} projected leaves x {n_steps} steps, its plain version ran "
             f"{len(plain_calls)} times")
    others = {k: v for k, v in launches.items() if k != "pvq_encode_batch" and v}
    if others:
        fail(f"train (full width) launched kernels that training does not use: {others}")
    if len(save_s) != 1:
        fail(f"train (full width): {len(save_s)} blocking saves, expected the final one")

    # (b) the checkpoint restores bit-identical into a fresh state
    final = runner.state
    fresh_state, _ = train.make_state_and_step(model, st["optimizer"], seed=1, device="cuda")
    t0 = time.perf_counter()
    restored, step = st["checkpointer"].restore(fresh_state)
    sync()
    restore_s = time.perf_counter() - t0
    if step != n_steps - 1 or not _tree_equal(torch, restored, final):
        fail(f"train (full width): the checkpoint of step {step} does not restore the saved "
             f"state bit for bit")
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    del restored, fresh_state
    gc.collect()

    # (c) step 1 again: the STE's pulses of every leaf and the step-1 loss on
    # the kernel against the plain version on the card
    init_state, step_fn0 = train.make_state_and_step(
        model, st["optimizer"], pvq_qat=True, pvq_k=k_full, seed=0, device="cuda")
    batch0 = loader.device_batch(0)
    leaves = _projected_leaves(init_state[0], projected)
    kernels_mod.reset_launches()
    pulses = {path: ops.pvq_encode_grouped_fast(leaf.reshape(-1), 256, k_full,
                                                scale_mode="paper")
              for path, leaf in leaves.items()}
    with plain_versions(mm, enc):
        for path, leaf in leaves.items():
            p_plain, rho_plain = ops.pvq_encode_grouped_fast(leaf.reshape(-1), 256, k_full,
                                                             scale_mode="paper")
            if not (torch.equal(pulses[path][0], p_plain)
                    and torch.equal(pulses[path][1], rho_plain)):
                fail(f"train: the STE's encoder on {path} differs from its plain version")
        _, m_plain = step_fn0(init_state, batch0)
    if kernels_mod.launches()["pvq_encode_batch"] != len(leaves):
        fail("train: the plain rerun launched the encoder")
    loss_plain = float(m_plain["loss"])
    if loss_plain != hist[0]["loss"]:
        fail(f"train: step-1 loss {hist[0]['loss']!r} on the kernel, {loss_plain!r} on the "
             f"plain version")
    rows = sum(int(p.shape[0]) for p, _ in pulses.values())
    del pulses

    # (d) where a step's time goes: one profiler trace of 2 steps; the
    # projection alone, kernel and plain version (events)
    prof = profile_call(torch, partial(step_fn0, init_state, batch0), reps=2,
                        match=ENCODE_KERNEL_MATCH)
    enc_device_ms = prof.pop("match_ms")
    project = train.qat_projector(k_full)

    def wall_ms(fn, reps=3):  # median host wall of a call, the card synchronized
        fn()
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    project_ms = wall_ms(partial(project, init_state[0]))
    with plain_versions(mm, enc):
        project_plain_ms = wall_ms(partial(project, init_state[0]), reps=1)
    nbytes = sum(4 * 2 * leaf.numel() + 4 * -(-leaf.numel() // 256) for leaf in leaves.values())
    nops = sum(_encode_ops(torch, torch.nn.functional.pad(
        leaf.reshape(-1).float(), (0, (-leaf.numel()) % 256)).reshape(-1, 256), k_full,
        enc.DELTA_MAX) for leaf in leaves.values())
    enc_bound = bound_ms(nbytes, nops, F32_FLOPS_PER_S)

    # (e) the full-width step-1 gradients through the error-feedback
    # compressor, and packed_update on one full-width packed leaf: kernel
    # against plain version on the card
    _, _, grads = train.loss_and_grads(model, init_state[0], batch0,
                                      train.step_generator(0, 0, "cuda"), project)
    cfg = CompressionConfig()
    init_ef, apply_ef = make_ef_compressor(cfg)
    ef0 = init_ef(grads)
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    dec, ef1 = apply_ef(grads, ef0)
    sync()
    ef_s = time.perf_counter() - t0
    ef_launches = kernels_mod.launches()["pvq_encode_batch"]
    with plain_versions(mm, enc):
        dec_p, ef1_p = apply_ef(grads, ef0)
    if ef_launches <= 0 or not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(dec) + tree_leaves(ef1), tree_leaves(dec_p) + tree_leaves(ef1_p))):
        fail(f"train: the EF compressor on the kernel ({ef_launches} launches) differs from "
             f"its plain version")
    comp_bytes, raw_bytes = wire_bytes(grads, cfg)
    del dec, ef1, dec_p, ef1_p, ef0
    leaf = dict(_projected_leaves(init_state[0], projected))[TRAIN_PACKED_LEAF]
    pk = pack_matmul(leaf, group=256, n_over_k=model.cfg.pvq.n_over_k)
    # a fine-tune's update along the gradient, its RMS 30% of the weights'
    # (steps below half a pulse's quantum re-encode to the same pulses)
    g_leaf = dict(_projected_leaves(grads, projected))[TRAIN_PACKED_LEAF].float()
    delta = -0.3 * g_leaf * (leaf.float().std() / g_leaf.std())
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    pk2 = packed_update(pk, delta)
    sync()
    update_s = time.perf_counter() - t0
    update_launches = kernels_mod.launches()["pvq_encode_batch"]
    with plain_versions(mm, enc):
        pk2_p = packed_update(pk, delta)
    if update_launches <= 0 or not (torch.equal(pk2.pulses, pk2_p.pulses)
                                    and torch.equal(pk2.scales, pk2_p.scales)):
        fail(f"train: packed_update on the kernel ({update_launches} launches) differs from "
             f"its plain version")
    if torch.equal(pk2.pulses, pk.pulses) and torch.equal(pk2.scales, pk.scales):
        fail("train: packed_update left the code unchanged")
    pk2_pulses_changed = int((pk2.pulses != pk.pulses).sum())
    del grads, pk, pk2, pk2_p, delta, init_state, st, runner, final
    gc.collect()
    torch.cuda.empty_cache()
    full_s = time.time() - t_phase

    # (f) reduced: the loss falls over 30 --pvq-qat steps; an injected
    # failure at step 17 restores the last committed step (14)
    t0 = time.time()
    red, rc, red_st = train.run(TRAIN_REDUCED + ["--ckpt-dir", str(scratch / "train_red"),
                                                 "--device", "cuda"], return_state=True)
    red_hist = red_st["runner"].history
    if rc != 0 or not red_hist[-1]["loss"] < red_hist[0]["loss"]:
        fail(f"train (reduced): loss {red_hist[0]['loss']} -> {red_hist[-1]['loss']}, exit {rc}")
    crashed = []

    def injector(step):
        if step == 17 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    rec, rc, rec_st = train.run(TRAIN_RECOVERY + ["--ckpt-dir", str(scratch / "train_rec"),
                                                  "--device", "cuda"],
                                return_state=True, failure_injector=injector)
    rec_hist = rec_st["runner"].history
    reran = [h["step"] for h in rec_hist].count(15)
    if rc != 0 or rec["restores"] != 1 or reran != 2 or not rec_hist[-1]["loss"] < rec_hist[0][
            "loss"]:
        fail(f"train (reduced) recovery: restores {rec['restores']}, step 15 ran {reran} "
             f"times, loss {rec_hist[0]['loss']} -> {rec_hist[-1]['loss']}")
    reduced_s = time.time() - t0

    dts = [1e3 * h["dt"] for h in hist]
    summary = {"train_phase": {
        "card": smi, "argv": TRAIN_FULL, "report": report,
        "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
        "host_wall_ms_per_step": dts, "host_wall_ms_per_step_median_after_first":
            statistics.median(dts[1:]),
        "profile_2_steps": {**prof, "idle_share": 1.0 - prof["device_ms"] / prof["wall_ms"]},
        "encoder": {"launches": launches["pvq_encode_batch"],
                    "launches_per_step": launches["pvq_encode_batch"] / n_steps,
                    "projected_leaves": n_leaves, "group_rows_per_step": rows,
                    "device_ms_per_step": enc_device_ms,
                    "bound_ms_per_step": enc_bound[0], "bound_by": enc_bound[1],
                    "projection_ms_per_step": project_ms,
                    "projection_plain_ms_per_step": project_plain_ms,
                    "plain_calls_in_run": len(plain_calls)},
        "step1_loss_kernel": hist[0]["loss"], "step1_loss_plain": loss_plain,
        "checkpoint": {"save_s": save_s[0], "restore_s": restore_s, "bytes": ckpt_bytes,
                       "bit_identical": True},
        "peak_device_gb": peak_gb,
        "ef_compress": {"encoder_launches": ef_launches, "seconds": ef_s,
                        "wire_bytes": comp_bytes, "raw_f32_bytes": raw_bytes,
                        "ratio": comp_bytes / raw_bytes, "identical_to_plain": True},
        "packed_update": {"leaf": TRAIN_PACKED_LEAF, "encoder_launches": update_launches,
                          "seconds": update_s, "identical_to_plain": True,
                          "pulses_changed": int((pk2_pulses_changed))},
        "reduced": {"report": red, "loss_first": red_hist[0]["loss"],
                    "loss_last": red_hist[-1]["loss"], "recovery": rec},
        "seconds": {"full_run": round(run_s, 2), "full_width_checks": round(full_s, 2),
                    "reduced": round(reduced_s, 2), "phase": round(time.time() - t_phase, 2)}}}
    print(json.dumps(summary), flush=True)
    return counts, summary


# the attention families (gemma-2b, paligemma-3b, whisper-small at published
# width and depth; starcoder2-15b and granite-8b at published width, depth
# cut to FAMILY_CUT_LAYERS): served with the first phase's flags; (arch,
# layers or None for all)
FAMILY_FULL = [("gemma-2b", None), ("paligemma-3b", None), ("whisper-small", None),
               ("starcoder2-15b", 4), ("granite-8b", 4)]
FAMILY_SERVE = ["--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN), "--pvq",
                "--act-int8", "--kv-pvq", "--kv-block", str(KV_BLOCK), "--kv-group",
                str(KV_GROUP), "--agreement-min", "0.99", "--seed", "0"]
# the acceptance flags of each reduced family serve, gated at 0.99
FAMILY_REDUCED = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "4", "--pvq",
                  "--act-int8", "--kv-pvq", "--kv-block", "8", "--kv-group", "16",
                  "--agreement-min", "0.99", "--seed", "0"]
# one gemma-2b layer's packed matmuls (k_pad, n): wq, wk, wv, wo, wi_gate,
# wi_up, wo(ffn); one starcoder2-15b layer's (every one with a bias): wq,
# wk, wv, wo, wi_up, wo(ffn)
GEMMA_LAYER = [(2048, 2048), (2048, 256), (2048, 256), (2048, 2048), (2048, 16384),
               (2048, 16384), (16384, 2048)]
STARCODER2_LAYER = [(6144, 6144), (6144, 512), (6144, 512), (6144, 6144), (6144, 24576),
                    (24576, 6144)]
# kernel v4 at gemma-2b's (and paligemma-3b's) decode: batch 4 x 1 kv head,
# 8 query rows, hd 256, KV group 32; S 160 (prompt 128 + 32) and 2048
FAMILY_ATTN_ROWS = [("gemma-2b decode", BATCH, 160), ("gemma-2b at 2048", BATCH, 2048)]
FAMILY_ATTN_GEOMETRY = (1, 8, 256, KV_GROUP)


@contextlib.contextmanager
def depth_cut(arch, layers):
    """For the duration, ``configs.get_config(arch)`` gives the published
    config with ``layers`` decoder layers (None: unchanged): the harness's
    cut, which the package has no flag for.  Yields the cut's description."""
    import dataclasses

    from repro_torch import configs

    full = configs.ARCHS[arch]
    if layers:
        configs.ARCHS[arch] = dataclasses.replace(full, n_layers=layers)
    try:
        yield {"arch": arch, "n_layers": layers or full.n_layers,
               "published_n_layers": full.n_layers, "cut": bool(layers)}
    finally:
        configs.ARCHS[arch] = full


def family_serve(torch, serve, kernels_mod, mm, enc, quant, arch, layers, smi,
                 expect=SMOLLM_KERNELS, max_peak_gb=None):
    """One family model at published width (``layers`` cuts the depth)
    with ``FAMILY_SERVE``'s flags, the launch counts set to 0 just before
    and read just after: finite logits of the expected shape, the kernels
    of ``expect`` launched (by default the encoder, v3, v4 and v2), the
    decode step captured, the peak device memory under ``max_peak_gb``
    where given; a second
    ``generate`` (replays only: its decode ms a step is the steady one,
    its tokens the served ones); then the served leg's teacher-forced
    logits again through the plain versions on the card, which must be
    identical, so the plain path's tokens are the served ones.  The f32 leg's agreement is printed, not gated.  Returns
    the launch counts, v3's and v2's by body, and the packed embedding and
    a decode-sized activation for the head's timing (gemma only)."""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launches()
    with depth_cut(arch, layers) as cut:
        report, rc, state = serve.run(["--arch", arch] + FAMILY_SERVE, return_state=True)
    counts = kernels_mod.launches()
    bodies = kernels_mod.v3_body_launches()
    v2_bodies = kernels_mod.v2_body_launches()
    serve_wall = time.time() - t0
    if not state or (rc != 0 and "agreement_fail" not in report):
        fail(f"{arch} serve exited {rc}: {report}")
    if report.get("generated_shape") != [BATCH, PROMPT + GEN] or not report.get("logits_finite"):
        fail(f"{arch} serve produced {report.get('generated_shape')} / "
             f"finite={report.get('logits_finite')}")
    missing = [name for name in expect if counts[name] <= 0]
    if missing:
        fail(f"{arch} serve never launched {missing}: {counts}")
    peak_gb = report["peak_device_memory_bytes"] / 1e9
    if max_peak_gb is not None and peak_gb >= max_peak_gb:
        fail(f"{arch} serve peaked at {peak_gb:.2f} GB of device memory, not under {max_peak_gb}")
    if report["decode_step_captures"] < 1:
        fail(f"{arch} serve captured no decode step: {report}")
    prompt = PROMPT
    # the serve's first generate captured its graphs: time a second one
    # (replays only) for the steady decode step
    timings = {}
    captures = serve.TRACE_COUNTS["decode_step"]
    with quant.act_quant_scope(quant.ActQuant()), \
            quant.kv_quant_scope(quant.KVQuant(KV_BLOCK, KV_GROUP)):
        again = serve.generate(state["model"], state["params"], state["seq"][:, :prompt],
                               gen=GEN, cache_len=prompt + GEN,
                               extra_batch=state["extra_batch"], timings=timings)
    recaptured = serve.TRACE_COUNTS["decode_step"] - captures
    t1 = time.time()
    with plain_versions(mm, enc), quant.act_quant_scope(quant.ActQuant()), \
            quant.kv_quant_scope(quant.KVQuant(KV_BLOCK, KV_GROUP)):
        plain_q = serve.teacher_forced_logits(state["model"], state["params"], state["seq"],
                                              prompt_len=prompt,
                                              extra_batch=state["extra_batch"], eager=True)
    plain_s = time.time() - t1
    kern_q = state["logits_q"]
    same = {"served_leg_teacher_forced": bool(torch.equal(kern_q, plain_q)),
            "served_tokens": bool(torch.equal(plain_q.argmax(-1), state["seq"][:, prompt:])),
            "second_generate_tokens": bool(torch.equal(again, state["seq"]))}
    summary = {"family_serve": {
        "arch": arch, "card": smi, "depth": cut, "flags": FAMILY_SERVE,
        "pvq_tensors": report["pvq_tensors"], "packed_bytes": report["packed_bytes"],
        "weight_compression_ratio_vs_bf16": report["weight_compression_ratio"],
        "kv_quant": report.get("kv_quant"),
        "decode_ms_per_step_first_generate": report["decode_ms_per_step"],
        "decode_ms_per_step_captured": round(1e3 * timings["decode_s"] / GEN, 3),
        "captures_by_second_generate": recaptured,
        "tokens_per_s": report["tokens_per_s"], "prefill_s": report["prefill_s"],
        "pvq_encode_s": report["pvq_encode_s"],
        "peak_device_gb": round(peak_gb, 3), "peak_gate_gb": max_peak_gb,
        "decode_step_captures": report["decode_step_captures"],
        "kernel_launches": counts, "v3_body_launches": bodies, "v2_body_launches": v2_bodies,
        "kernels_vs_plain_on_card": same, "plain_rerun_s": round(plain_s, 2),
        "f32_leg_agreement": {"measured": report["act_int8_top1_agreement"],
                              "strict": report["act_int8_top1_agreement_strict"],
                              "gated": False},
        "serve_wall_s": round(serve_wall, 2), "phase_wall_s": round(time.time() - t0, 2)}}
    print(json.dumps(summary), flush=True)
    if not all(same.values()) or recaptured:
        fail(f"{arch}: the kernel path differs from the plain path or a second generate "
             f"captured ({recaptured}): {same}")
    return counts, bodies, v2_bodies, summary


def head_glue_row(torch, timer, quant, embed, x):
    """gemma-2b's tied head on its packed 256,000 x 2048 embedding at a
    decode step (``layers.unembed`` under ``ActQuant``: per group an
    f32 copy of the (256, 256000) pulse slice and an exact int8 dot; glue,
    not a kernel, as the reference's): event and device time beside the
    bytes bound of reading the pulses and scales once, and the f32
    ``torch.matmul`` of x with the dequantized table."""
    from repro_torch.nn import layers

    table = embed["embedding"]
    fn = partial(layers.unembed, embed, x, act_quant=quant.ActQuant())
    row = {"what": "gemma-2b tied head (glue), m 4", "ms": timer(fn, reps=5)}
    deq = table.dequantize(torch.float32)
    library = partial(torch.matmul, x.float(), deq.t())
    row["library_ms"] = timer(library, reps=5)
    vocab, d = table.shape
    nbytes = table.pulses.numel() + 4 * table.scales.numel() + 4 * BATCH * (d + vocab)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * BATCH * d * vocab, INT8_OPS_PER_S)
    row["groups"] = d // table.group
    timer.device_later(fn, (row, "device_ms", 1))
    timer.device_later(library, (row, "library_device_ms", 1))
    return row


def decode_pair(torch, timer, mm, quant, kernels_mod, gen, head, k, n, with_bias, totals,
                times=1):
    """Kernels v3 and v2 at m ``DECODE_M`` over one ``(k, n)`` matrix of
    random pulses and rho from ``gen`` (with a random bias where
    ``with_bias``), each a decode row led by ``head`` (v2 against its direct
    body too), added ``times`` times into ``totals["v3"]`` and
    ``totals["v2"]``.  Returns the two rows and ``(pulses, scales,
    w_deq)`` for further rows on the same matrix."""
    pulses = torch.randint(-9, 10, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    scales = torch.rand(k // GROUP, n, generator=gen, device="cuda") * 0.01
    bias = torch.randn(n, generator=gen, device="cuda") if with_bias else None
    w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=0)
    m = DECODE_M
    x = torch.randn(m, k, generator=gen, device="cuda")
    x_q, a = quant(x)
    lib = partial(torch.addmm, bias, x, w_deq) if with_bias else partial(torch.matmul, x, w_deq)
    extra = 4 * n if with_bias else 0
    head = {"m": m, "k": k, "n": n, "bias": with_bias, **head}
    rows = [decode_row(
        timer, {"kernel": "pvq_matmul_q", **head},
        partial(mm.pvq_matmul_q_cuda, x_q, pulses, scales, a, bias, group=GROUP),
        partial(mm.pvq_matmul_q_plain, x_q, pulses, scales, a, bias, group=GROUP), lib,
        v3_bytes(m, k, n) + extra, 2.0 * m * k * n, INT8_OPS_PER_S,
        body_launches=kernels_mod.v3_body_launches, times=times, total=totals["v3"]),
        decode_row(
        timer, {"kernel": "pvq_matmul", **head},
        partial(mm.pvq_matmul_cuda, x, pulses, scales, bias, group=GROUP),
        partial(mm.pvq_matmul_plain, x, pulses, scales, bias, group=GROUP), lib,
        v2_bytes(m, k, n) + extra, 2.0 * m * k * n, F64_TC_FLOPS_PER_S, tol=1e-5,
        body_launches=kernels_mod.v2_body_launches,
        direct=partial(mm.pvq_matmul_cuda, x, pulses, scales, bias, group=GROUP,
                       _body="direct"), times=times, total=totals["v2"])]
    return rows, (pulses, scales, w_deq)


def family_matmuls(torch, timer, mm, quant, kernels_mod):
    """Kernels v3 and v2 over one gemma-2b layer at m 4 (decode rows: v2
    against its direct body too) and m 512 (prefill rows: the mma bodies
    against their direct bodies), and v3 and v2 with the bias epilogue over
    one starcoder2-15b layer at m 4; random pulses and rho, identical (v3)
    or within rtol 1e-5 (v2) of the plain versions.  Returns the
    ``families`` entries of both kernels and the rows."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    totals = {layer: {"v3": _decode_total(), "v2": _decode_total(direct=True)}
              for layer in ("gemma", "star")}
    prefill = {"v3": _new_total(), "v2": _new_total()}
    for layer, shapes, with_bias in (("gemma", GEMMA_LAYER, False),
                                     ("star", STARCODER2_LAYER, True)):
        for k, n in shapes:
            pair, (pulses, scales, w_deq) = decode_pair(
                torch, timer, mm, quant, kernels_mod, gen,
                {"layer": "gemma-2b" if layer == "gemma" else "starcoder2-15b"}, k, n, with_bias,
                totals[layer])
            rows += pair
            if layer == "gemma":
                m = PREFILL_M
                x = torch.randn(m, k, generator=gen, device="cuda")
                x_q, a = quant(x)
                def call(body): return mm.pvq_matmul_q_cuda(x_q, pulses, scales, a, group=GROUP,
                                                            _body=body)
                def plain(): return mm.pvq_matmul_q_plain(x_q, pulses, scales, a, group=GROUP)
                row = prefill_row(timer, kernels_mod.v3_body_launches,
                                  f"gemma-2b pvq_matmul_q m{m} k{k} n{n}", call, plain,
                                  lambda: torch.matmul(x, w_deq), v3_bytes(m, k, n),
                                  2.0 * m * k * n, total=prefill["v3"])
                rows.append({"kernel": "pvq_matmul_q", "layer": "gemma-2b", "m": m, "k": k,
                             "n": n, **row})
                def call_f(body): return mm.pvq_matmul_cuda(x, pulses, scales, group=GROUP,
                                                            _body=body)
                def plain_f(): return mm.pvq_matmul_plain(x, pulses, scales, group=GROUP)
                row = prefill_row(timer, kernels_mod.v2_body_launches,
                                  f"gemma-2b pvq_matmul m{m} k{k} n{n}", call_f, plain_f,
                                  lambda: torch.matmul(x, w_deq), v2_bytes(m, k, n),
                                  2.0 * m * k * n, rtol=1e-5, rate=F64_TC_FLOPS_PER_S,
                                  total=prefill["v2"])
                rows.append({"kernel": "pvq_matmul", "layer": "gemma-2b", "m": m, "k": k,
                             "n": n, **row})
            del w_deq
    gemma = "one gemma-2b layer's 7 matmuls (d 2048, one KV head of 256, d_ff 16384)"
    star = ("one starcoder2-15b layer's 6 matmuls with bias (d 6144, 4 KV heads of 128, "
            "d_ff 24576, ungated gelu)")
    out = {}
    for name, v3 in (("pvq_matmul_q", True), ("pvq_matmul", False)):
        tag, rate = ("v3", INT8_OPS_PER_S) if v3 else ("v2", F64_TC_FLOPS_PER_S)
        f32 = "" if v3 else ", f32 x"
        out[name] = {
            "gemma_layer_m4": decode_entry(totals["gemma"][tag], rate,
                                           shape=f"{gemma}, m={DECODE_M}{f32}"),
            "starcoder2_layer_bias_m4": decode_entry(totals["star"][tag], rate,
                                                     shape=f"{star}, m={DECODE_M}{f32}"),
            "gemma_layer_m512": prefill_entry(prefill[tag], f"{gemma}, m={PREFILL_M}{f32}",
                                              MMA_SOURCE if v3 else F_MMA_SOURCE, rate),
        }
    return out, rows


# gemma-2b's tied embedding (vocab x d), packed as serve packs it
GEMMA_EMBED = (256000, 2048)


def family_kernel_rows(torch, timer, mm, quant, kernels_mod):
    """The families' kernel rows on ``timer`` (module docstring, item 12):
    v4 at gemma-2b's decode, v3 and v2 over one gemma-2b layer and one
    starcoder2-15b layer with bias (``family_matmuls``), and gemma-2b's
    tied head (glue) on an embedding of its shape drawn from seed 7 and
    packed as ``serve --pvq`` packs it (N/K 0.5, group 256).  Their device
    times arrive with ``timer.measure_device``.  Returns the kernels line's
    ``families`` entries of v3, v2 and v4, and the rows."""
    from repro_torch.core.packed import pack_flat
    from repro_torch.core.quantize import quantize_activations

    attn = check_attention(torch, timer, mm, quantize_activations, FAMILY_ATTN_ROWS,
                           FAMILY_ATTN_GEOMETRY, seed=11)
    entries, rows = family_matmuls(torch, timer, mm, quantize_activations, kernels_mod)
    gen = torch.Generator(device="cuda").manual_seed(7)
    vocab, d = GEMMA_EMBED
    table = pack_flat(torch.randn(vocab, d, generator=gen, device="cuda") * 0.02, group=GROUP,
                      n_over_k=0.5, scale_mode="ls", row_align=d)
    x = torch.randn(BATCH, 1, d, generator=gen, device="cuda")
    glue = head_glue_row(torch, timer, quant, {"embedding": table}, x)
    entries["pvq_attn_q"] = attn
    entries["pvq_matmul_q"]["head_glue"] = glue
    return entries, rows + list(attn["decode"].values()) + [glue]


def families_phase(torch, serve, kernels_mod, mm, enc, quant, smi, kernel_rows=True):
    """The attention families (module docstring, item 12).  With
    ``kernel_rows`` also its kernel rows (``family_kernel_rows``, on a
    timer of its own: ``--families``; the whole script times them in the
    kernel phase).  Returns the launch counts, v3's and v2's by body, each
    by path, and the rows' kernels-line entries (None without them)."""
    t_phase = time.time()
    counts, bodies, v2_bodies, walls = {}, {}, {}, {}
    for arch, layers in FAMILY_FULL:
        path = arch if not layers else f"{arch} ({layers} layers)"
        t0 = time.time()
        counts[path], bodies[path], v2_bodies[path], _ = family_serve(
            torch, serve, kernels_mod, mm, enc, quant, arch, layers, smi)
        gc.collect()
        torch.cuda.empty_cache()
        walls[path] = round(time.time() - t0, 2)
    t0 = time.time()
    reduced = {}
    for arch, _ in FAMILY_FULL:
        rep = serve_reduced(serve, ["--arch", arch] + FAMILY_REDUCED, kernels_mod,
                            expect=SMOLLM_KERNELS, what=f"{arch} reduced")
        reduced[arch] = rep["act_int8_top1_agreement"]
    walls["reduced serves"] = round(time.time() - t0, 2)
    entries = None
    if kernel_rows:
        t0 = time.time()
        timer = Timer(torch)
        entries, rows = family_kernel_rows(torch, timer, mm, quant, kernels_mod)
        timer.measure_device()
        for row in rows:
            print(json.dumps({"family_kernel_check": row}), flush=True)
        walls["kernel rows"] = round(time.time() - t0, 2)
    print(json.dumps({"families_phase": {"card": smi, "reduced_agreement": reduced,
                                         "walls_s": walls,
                                         "seconds": round(time.time() - t_phase, 2)}}),
          flush=True)
    return counts, bodies, v2_bodies, entries


# the recurrent families: rwkv6-1.6b at published width and depth,
# jamba-1.5-large-398b at published widths with one super-block (8 of 72
# layers: 7 Mamba + 1 attention, 4 MoE + 4 dense FFN), deepseek-v2-236b at
# published widths with 4 of 60 layers (1 dense + 3 MoE of 160 experts);
# (arch, layers or None for all, the kernels its path launches): rwkv6 has
# no attention and deepseek's MLA cache is dense, so neither launches v4
RECURRENT_FULL = [
    ("rwkv6-1.6b", None, ("pvq_encode_batch", "pvq_matmul_q", "pvq_matmul")),
    ("jamba-1.5-large-398b", 8, ("pvq_encode_batch", "pvq_matmul_q", "pvq_matmul_q_batched",
                                 "pvq_attn_q", "pvq_matmul", "pvq_matmul_batched")),
    ("deepseek-v2-236b", 4, ("pvq_encode_batch", "pvq_matmul_q", "pvq_matmul_q_batched",
                             "pvq_matmul", "pvq_matmul_batched")),
]
# jamba's super-block: ~46 GB packed, ~88 GB in bf16 (packed as it is built)
JAMBA_PEAK_GB = 75.0
# reduced jamba misses the 0.99 gate in the reference too (0.75 on the
# reference's weights under these flags): printed beside it, not gated
REFERENCE_REDUCED_AGREEMENT = {"jamba-1.5-large-398b": 0.75}
# v3 and v2 at m 4 over the recurrent slice's new 2-D shapes (what, k, n,
# bias, times a layer): one rwkv6-1.6b layer's 8 matmuls, and jamba's
# x_proj (n 544: the splitk body's last 64-column block half full) and
# dt_proj (k 512, with its bias in the epilogue)
RWKV_LAYER = [("rwkv6 wr/wk/wv/wg/out", 2048, 2048, False, 5),
              ("rwkv6 cmix wk", 2048, 7168, False, 1),
              ("rwkv6 cmix wv", 7168, 2048, False, 1),
              ("rwkv6 cmix wr", 2048, 2048, False, 1)]
JAMBA_MAMBA = [("jamba x_proj", 16384, 544, False, 1), ("jamba dt_proj", 512, 16384, True, 1)]
# batched v3 and v2 over one expert bank at decode (m 1 an expert): jamba's
# 16 experts of 8192 x 24576 (up), deepseek-v2-236b's 160 of 5120 x 1536
RECURRENT_BANKS = [("jamba up bank", 16, 8192, 24576), ("deepseek-v2-236b up bank", 160, 5120, 1536)]
# kernel v4 at jamba's attention layer: batch 4 x 8 kv heads, 8 query rows
# a kv head (64 / 8), hd 128, KV group 32, S 160
RECURRENT_ATTN_ROWS = [("jamba decode", BATCH, 160)]
RECURRENT_ATTN_GEOMETRY = (8, 8, 128, KV_GROUP)


def recurrent_matmuls(torch, timer, mm, quant, kernels_mod):
    """Kernels v3 and v2 at m 4 over one rwkv6-1.6b layer and jamba's two
    Mamba projections whose shapes are new (``RWKV_LAYER``,
    ``JAMBA_MAMBA``; v2 against its direct body too), and the batched
    kernels over one bank of each MoE model (``RECURRENT_BANKS``); random
    pulses and rho, v3 identical and v2 within rtol 1e-5 of the plain
    versions.  Returns the ``recurrent`` entries of the four kernels and
    the rows."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows, out = [], {name: {} for name in ("pvq_matmul_q", "pvq_matmul", "pvq_matmul_q_batched",
                                            "pvq_matmul_batched")}
    for shapes, key in ((RWKV_LAYER, "rwkv6_layer_m4"), (JAMBA_MAMBA[:1], "jamba_x_proj_m4"),
                        (JAMBA_MAMBA[1:], "jamba_dt_proj_bias_m4")):
        totals = {"v3": _decode_total(), "v2": _decode_total(direct=True)}
        for what, k, n, with_bias, times in shapes:
            pair, _ = decode_pair(torch, timer, mm, quant, kernels_mod, gen, {"what": what}, k, n,
                                  with_bias, totals, times)
            rows += pair
        shape = "; ".join(f"{w} {k} x {n}{' with bias' if b else ''}{f' x{t}' if t > 1 else ''}"
                          for w, k, n, b, t in shapes)
        out["pvq_matmul_q"][key] = decode_entry(totals["v3"], INT8_OPS_PER_S,
                                                shape=f"{shape}, m={DECODE_M}")
        out["pvq_matmul"][key] = decode_entry(totals["v2"], F64_TC_FLOPS_PER_S,
                                              shape=f"{shape}, m={DECODE_M}, f32 x")
    for what, e, k, n in RECURRENT_BANKS:
        pulses = torch.randint(-9, 10, (e, k, n), generator=gen, device="cuda", dtype=torch.int8)
        scales = torch.rand(e, k // GROUP, n, generator=gen, device="cuda") * 0.01
        w_deq = pulses.float() * torch.repeat_interleave(scales, GROUP, dim=1)
        x = torch.randn(e, MOE_DECODE_M, k, generator=gen, device="cuda")
        x_q, a = quant(x)
        head = {"what": what, "experts": e, "m": MOE_DECODE_M, "k": k, "n": n}
        nops = 2.0 * e * MOE_DECODE_M * k * n
        key = f"{what.split()[0]}_bank_e{e}_m{MOE_DECODE_M}"
        for name, kern, plain, nbytes, rate, tol, bodies in (
            ("pvq_matmul_q_batched",
             partial(mm.pvq_matmul_q_batched_cuda, x_q, pulses, scales, a, group=GROUP),
             partial(mm.pvq_matmul_q_batched_plain, x_q, pulses, scales, a, group=GROUP),
             v3_bytes(MOE_DECODE_M, k, n, e), INT8_OPS_PER_S, 0.0, kernels_mod.v3_body_launches),
            ("pvq_matmul_batched",
             partial(mm.pvq_matmul_batched_cuda, x, pulses, scales, group=GROUP),
             partial(mm.pvq_matmul_batched_plain, x, pulses, scales, group=GROUP),
             v2_bytes(MOE_DECODE_M, k, n, e), F64_TC_FLOPS_PER_S, 1e-5,
             kernels_mod.v2_body_launches),
        ):
            total = _decode_total()
            rows.append(decode_row(timer, {"kernel": name, **head}, kern, plain,
                                   partial(torch.bmm, x, w_deq), nbytes, nops, rate, tol=tol,
                                   body_launches=bodies, total=total))
            out[name][key] = decode_entry(total, rate, shape=f"{what}, {e} experts of {k} x {n}, "
                                                             f"m={MOE_DECODE_M} an expert")
        del w_deq
    return out, rows


def recurrent_kernel_rows(torch, timer, mm, quant, kernels_mod):
    """The recurrent slice's kernel rows on ``timer``: v4 at jamba's
    attention layer (hd 128, 8 kv heads), v3 and v2 over the new 2-D
    shapes, the batched kernels over the new banks.  Their device times
    arrive with ``timer.measure_device``.  Returns the kernels line's
    ``recurrent`` entries and the rows."""
    attn = check_attention(torch, timer, mm, quant, RECURRENT_ATTN_ROWS,
                           RECURRENT_ATTN_GEOMETRY, seed=17)
    entries, rows = recurrent_matmuls(torch, timer, mm, quant, kernels_mod)
    entries["pvq_attn_q"] = attn
    return entries, rows + list(attn["decode"].values())


def recurrent_phase(torch, serve, kernels_mod, mm, enc, quant, smi, kernel_rows=True):
    """The recurrent families (module docstring, item 13): each of
    ``RECURRENT_FULL`` through ``family_serve`` with its own kernels (jamba
    also under ``JAMBA_PEAK_GB``), then the three reduced serves with
    ``FAMILY_REDUCED``'s flags (rwkv6 and deepseek gated at 0.99, jamba
    printed beside the reference's score).  With ``kernel_rows`` also its
    kernel rows on a timer of its own (``--recurrent``; the whole script
    times them in the kernel phase).  Returns the launch counts, v3's and
    v2's by body, each by path, and the rows' entries (None without)."""
    from repro_torch.core.quantize import quantize_activations

    t_phase = time.time()
    counts, bodies, v2_bodies, walls = {}, {}, {}, {}
    for arch, layers, expect in RECURRENT_FULL:
        path = arch if not layers else f"{arch} ({layers} layers)"
        t0 = time.time()
        counts[path], bodies[path], v2_bodies[path], _ = family_serve(
            torch, serve, kernels_mod, mm, enc, quant, arch, layers, smi, expect=expect,
            max_peak_gb=JAMBA_PEAK_GB if arch.startswith("jamba") else None)
        gc.collect()
        torch.cuda.empty_cache()
        walls[path] = round(time.time() - t0, 2)
    t0 = time.time()
    reduced = {}
    for arch, _, expect in RECURRENT_FULL:
        gated = arch not in REFERENCE_REDUCED_AGREEMENT
        rep = serve_reduced(serve, ["--arch", arch] + FAMILY_REDUCED, kernels_mod,
                            expect=expect, what=f"{arch} reduced", gated=gated)
        reduced[arch] = {"measured": rep["act_int8_top1_agreement"], "gated": gated,
                         "reference": REFERENCE_REDUCED_AGREEMENT.get(arch, 1.0)}
    walls["reduced serves"] = round(time.time() - t0, 2)
    entries = None
    if kernel_rows:
        t0 = time.time()
        timer = Timer(torch)
        entries, rows = recurrent_kernel_rows(torch, timer, mm, quantize_activations,
                                              kernels_mod)
        timer.measure_device()
        for row in rows:
            print(json.dumps({"recurrent_kernel_check": row}), flush=True)
        walls["kernel rows"] = round(time.time() - t0, 2)
    print(json.dumps({"recurrent_phase": {"card": smi, "reduced_agreement": reduced,
                                          "walls_s": walls,
                                          "seconds": round(time.time() - t_phase, 2)}}),
          flush=True)
    return counts, bodies, v2_bodies, entries


def start_ptxas_report(build, source="pvq_matmul"):
    """Starts ``nvcc -Xptxas -v`` on ``csrc/<source>.cu`` (a cubin under the
    build directory), beside the library builds."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build._ARCH, "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
           *build.SOURCES[source], "-o", str(build.BUILD_DIR / f"ptxas_{source}.cubin"),
           str(build.CSRC / f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(proc, part="splitk"):
    """Registers, spills and stack of each kernel whose name holds ``part``
    (by default v3's and v2's decode bodies), from the ``-Xptxas -v`` lines
    of ``proc``."""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc -Xptxas -v exited {proc.returncode}:\n{text}")
    found, name = [], None
    for line in text.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            name = hit.group(1) if part in hit.group(1) else None
            if name:
                found.append({"kernel": name})
            continue
        if not name:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            found[-1].update(stack_bytes=int(spill.group(1)), spill_stores=int(spill.group(2)),
                             spill_loads=int(spill.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            found[-1]["registers"] = int(regs.group(1))
    filt = shutil.which("c++filt")
    if filt and found:
        names = subprocess.run([filt], input="\n".join(f["kernel"] for f in found),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(found):
            for f, demangled in zip(found, names):
                f["kernel"] = demangled.replace("(anonymous namespace)::", "").split("(")[0]
    return found


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    kernels_only = "--kernels-only" in args
    paper_only = "--paper" in args
    train_only = "--train" in args
    families_only = "--families" in args
    recurrent_only = "--recurrent" in args
    tree = ROOT
    if "--tree" in args:
        if not kernels_only or args.index("--tree") + 1 >= len(args):
            print("chip_smoke: --tree DIR goes with --kernels-only", file=sys.stderr)
            return 2
        tree = Path(args[args.index("--tree") + 1]).resolve()
    if not (tree / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # until the tune phase, the autotuner's cache is a path that does not
    # exist: every dispatch takes the rules' choices
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    os.environ[TUNE_CACHE_ENV] = str(Path(scratch) / "untuned.json")
    try:
        return run_phases(torch, tree, kernels_only, smi, Path(scratch), paper_only, train_only,
                          families_only, recurrent_only)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run_phases(torch, tree, kernels_only, smi, scratch, paper_only=False,
               train_only=False, families_only=False, recurrent_only=False) -> int:
    import repro_torch.kernels as kernels_mod
    from repro_torch.core import quantize as quant
    from repro_torch.core.quantize import quantize_activations
    from repro_torch.kernels import autotune, build, ops
    from repro_torch.kernels import pvq_encode as enc
    from repro_torch.kernels import pvq_matmul as mm
    from repro_torch.launch import serve
    from repro_torch.nn import moe

    t0 = time.time()
    ptxas = start_ptxas_report(build)
    ptxas_attn = start_ptxas_report(build, "pvq_attn")
    ptxas_enc = start_ptxas_report(build, "pvq_encode")
    build.build_all()
    print(json.dumps({"phase": "build", "tree": str(tree), "seconds": round(time.time() - t0, 2)}),
          flush=True)
    decode_bodies = (ptxas_report(ptxas) + ptxas_report(ptxas_attn, "pvq_attn_q")
                     + ptxas_report(ptxas_enc, "pvq_encode"))
    for key, part in (("ptxas_v3_decode_body", "pvq_matmul_q_splitk"),
                      ("ptxas_v2_decode_body", "pvq_matmul_f_splitk"),
                      ("ptxas_v4", "pvq_attn_q"), ("ptxas_encoder", "pvq_encode")):
        found = [f for f in decode_bodies if part in f["kernel"]]
        if not found:
            fail(f"nvcc -Xptxas -v reported no {part} kernel")
        print(json.dumps({key: found}), flush=True)

    if paper_only:  # the slice's phase alone, without the other main paths
        paper_phase(torch, kernels_mod, mm, enc, quant, smi, scratch)
        return 0
    if train_only:
        train_phase(torch, kernels_mod, mm, enc, smi, scratch)
        return 0
    if families_only:
        families_phase(torch, serve, kernels_mod, mm, enc, quant, smi)
        return 0
    if recurrent_only:
        recurrent_phase(torch, serve, kernels_mod, mm, enc, quant, smi)
        return 0

    timer = Timer(torch)
    entries, rows = check_matmuls(torch, timer, mm, ops, quantize_activations, kernels_mod)
    entries["pvq_attn_q"] = check_attention(torch, timer, mm, quantize_activations)
    entries["pvq_attn_q"]["prefill_chunk"] = check_attention_chunk(torch, timer, mm,
                                                                   quantize_activations)
    entries["pvq_encode_batch"], enc_rows = check_encode(torch, timer, enc)
    batched, batched_rows = check_batched(torch, timer, mm, quantize_activations, kernels_mod)
    entries.update(batched)
    fam_entries, fam_rows = family_kernel_rows(torch, timer, mm, quant, kernels_mod)
    rec_entries, rec_rows = recurrent_kernel_rows(torch, timer, mm, quantize_activations,
                                                  kernels_mod)
    timer.measure_device()
    for row in rows + enc_rows + batched_rows + list(entries["pvq_attn_q"]["prefill_chunk"].values()):
        print(json.dumps({"kernel_check": row}), flush=True)
    for row in fam_rows:
        print(json.dumps({"family_kernel_check": row}), flush=True)
    for name, fam in fam_entries.items():
        entries[name]["families"] = fam
    for row in rec_rows:
        print(json.dumps({"recurrent_kernel_check": row}), flush=True)
    for name, rec in rec_entries.items():
        entries[name]["recurrent"] = rec
    del timer
    if kernels_only:  # the kernels' numbers, without main-path launches
        print(json.dumps({"kernel_entries": list(entries.values())}), flush=True)
        return 0

    routing = RoutingLog(moe)
    counts, bodies, v2_bodies = {}, {}, {}
    counts["smollm-360m"], bodies["smollm-360m"], v2_bodies["smollm-360m"], untuned = serve_full(
        torch, serve, kernels_mod, mm, enc, quant, routing, FULL_SERVE,
        kvq=quant.KVQuant(KV_BLOCK, KV_GROUP), expect=SMOLLM_KERNELS, smi=smi)
    gc.collect()  # the smollm model and its graphs are gone: the card is free for deepseek
    torch.cuda.empty_cache()
    counts[MOE_ARCH], bodies[MOE_ARCH], v2_bodies[MOE_ARCH], _ = serve_full(
        torch, serve, kernels_mod, mm, enc, quant, routing, MOE_FULL_SERVE, kvq=None,
        expect=MOE_KERNELS, smi=smi)
    routing.close()
    gc.collect()
    torch.cuda.empty_cache()
    serve_reduced(serve, REDUCED_SERVE, kernels_mod)
    serve_reduced(serve, MOE_REDUCED_SERVE, kernels_mod)
    long_ctx = serve_reduced(serve, CI_LONG_SERVE, kernels_mod, expect=("pvq_attn_q",),
                             what="ci long-context kv-pvq")
    if not long_ctx.get("kv_bytes_ratio_vs_f32", 1.0) <= KV_BYTES_RATIO_MAX:
        fail(f"ci long-context smoke: kv_bytes_ratio_vs_f32 "
             f"{long_ctx.get('kv_bytes_ratio_vs_f32')} > {KV_BYTES_RATIO_MAX}")
    serve_reduced(serve, CI_PROMPT8_SERVE, kernels_mod, expect=("pvq_matmul_q", "pvq_matmul"),
                  what="ci prompt-8")
    engine, engine_outputs = {}, {}
    for what, argv, gate in ENGINE_RUNS:
        counts[what], engine[what], engine_outputs[what] = serve_engine(
            torch, serve, kernels_mod, mm, enc, quant, argv, what, gate)
        gc.collect()
        torch.cuda.empty_cache()
    tune_phase(torch, serve, kernels_mod, untuned, engine_outputs["smollm-360m engine (a)"], smi,
               scratch / "tune.json")
    gc.collect()
    torch.cuda.empty_cache()
    # back to the rules' choices for the artifact phase
    os.environ[TUNE_CACHE_ENV] = str(scratch / "untuned.json")
    autotune.clear_memory_cache()
    counts["smollm-360m artifact"], _ = artifact_phase(torch, serve, kernels_mod, quant, smi,
                                                       scratch)
    gc.collect()
    torch.cuda.empty_cache()
    (counts["paper nets"], bodies["paper nets"], v2_bodies["paper nets"]), paper_kernel_rows, _ = \
        paper_phase(torch, kernels_mod, mm, enc, quant, smi, scratch)
    for name in ("pvq_matmul_q", "pvq_matmul"):
        entries[name]["paper"] = [r for r in paper_kernel_rows if r["kernel"] == name]
    gc.collect()
    torch.cuda.empty_cache()
    (counts["smollm-360m train"], _, _), train_summary = train_phase(
        torch, kernels_mod, mm, enc, smi, scratch)
    entries["pvq_encode_batch"]["train"] = train_summary["train_phase"]["encoder"]
    gc.collect()
    torch.cuda.empty_cache()
    fam_counts, fam_bodies, fam_v2_bodies, _ = families_phase(
        torch, serve, kernels_mod, mm, enc, quant, smi, kernel_rows=False)
    counts.update(fam_counts)
    bodies.update(fam_bodies)
    v2_bodies.update(fam_v2_bodies)
    gc.collect()
    torch.cuda.empty_cache()
    rec_counts, rec_bodies, rec_v2_bodies, _ = recurrent_phase(
        torch, serve, kernels_mod, mm, enc, quant, smi, kernel_rows=False)
    counts.update(rec_counts)
    bodies.update(rec_bodies)
    v2_bodies.update(rec_v2_bodies)
    run_b = engine["smollm-360m engine (b)"]
    # the timed runs' (replays counted, the warm-up's taken off)
    entries["pvq_attn_q"]["launches_from_chunk_caller"] = {
        what: e["v4_from_chunk"] for what, e in engine.items()}
    entries["pvq_attn_q"]["launches_per_chunk"] = run_b["v4_from_chunk"] / run_b["chunks_run"]

    # each kernel's launches come from the main path that first ported it;
    # launches_by_path has every full-width path's count
    order = (("pvq_encode_batch", "smollm-360m"), ("pvq_matmul_q", "smollm-360m"),
             ("pvq_attn_q", "smollm-360m"), ("pvq_matmul", "smollm-360m"),
             ("pvq_matmul_q_batched", MOE_ARCH), ("pvq_matmul_batched", MOE_ARCH))
    line = []
    for name, path in order:
        e = dict(entries[name])
        e["launches"] = counts[path][name]
        e["launches_by_path"] = {p: c[name] for p, c in counts.items()}
        # the 2-D and batched routes' launches together, by body
        if name in ("pvq_matmul_q", "pvq_matmul_q_batched"):
            e["v3_body_launches_by_path"] = bodies
        if name in ("pvq_matmul", "pvq_matmul_batched"):
            e["v2_body_launches_by_path"] = v2_bodies
        line.append(e)
    print(json.dumps({"chip_smoke_wall_s": round(time.time() - t0, 2)}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
