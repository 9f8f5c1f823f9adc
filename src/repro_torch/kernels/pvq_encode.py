"""Batched PVQ encode (port of ``repro.kernels.pvq_encode.pvq_encode_batch``).

``pvq_encode_batch_cuda`` launches the hand-written kernel
(``csrc/pvq_encode.cu``: one warp per group row, every reduction in
registers, shuffles and warp votes; bit-identical to the plain version);
``pvq_encode_batch_plain`` is the same function in plain PyTorch.  Both
return ``(pulses int32 (g, n), rho_ls f32 (g,))``:
floor allocation, largest-remainder bulk allocation of all but the last
``delta_max`` pulses (bisection over bit patterns, ties to the lower lane),
exact greedy for the rest (first lane wins), sign, and
``rho = max(<w, p> / ||p||^2, 0)`` (0 for zero rows).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import LAUNCHES
from . import build
from ..core.pvq import _scales, pvq_quantize_direction_fast

#: the reference's heuristic default bounding the exact greedy tail
DELTA_MAX = 32
#: the encoder body's version: part of every tuned encoder entry's key, so
#: a change to ``csrc/pvq_encode.cu`` that moves its timing is bumped here
ENCODE_KERNEL_VERSION = 1


def pvq_encode_batch_plain(
    w: torch.Tensor, *, k_pulses: int, delta_max: int = DELTA_MAX
) -> Tuple[torch.Tensor, torch.Tensor]:
    pulses = pvq_quantize_direction_fast(w, k_pulses, delta_max)
    return pulses, _scales(w, pulses, "ls")


def pvq_encode_batch_cuda(
    w: torch.Tensor, *, k_pulses: int, delta_max: int = DELTA_MAX
) -> Tuple[torch.Tensor, torch.Tensor]:
    if w.device.type != "cuda":
        raise ValueError(f"pvq_encode_batch_cuda needs a CUDA tensor, got {w.device}")
    if w.ndim != 2:
        raise ValueError(f"w must be (groups, n), got {tuple(w.shape)}")
    g, n = w.shape
    if not 1 <= n <= 1024:
        raise ValueError(f"group width {n} outside the kernel's 1..1024 lanes")
    w = w.to(torch.float32).contiguous()
    pulses = torch.empty((g, n), dtype=torch.int32, device=w.device)
    rho = torch.empty((g,), dtype=torch.float32, device=w.device)
    status = build.launcher("pvq_encode_launch")(
        w.data_ptr(), g, n, int(k_pulses), int(delta_max),
        pulses.data_ptr(), rho.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    build.check(status, "pvq_encode_batch")
    LAUNCHES["pvq_encode_batch"] += 1
    return pulses, rho
