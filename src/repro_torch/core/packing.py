"""Pulse-tensor packing for storage and for the matmul kernels (port of
``repro.core.packing``).

Two formats:
  * ``int8``  — pulses checked into int8 (lossless for K <= 127: a P(N, K)
    coordinate is bounded by K), plus per-group f32 scales; the layout the
    ``pvq_matmul`` kernels stream.
  * ``nibble`` — 4-bit two's-complement packing (two pulses a byte) for
    layers with |pulse| <= 7 (``core.bitstream.pack_nibbles``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bitstream import pack_nibbles, unpack_nibbles
from .pvq import PVQCode

__all__ = ["pulses_to_int8", "pack_nibbles", "unpack_nibbles", "packed_nbytes"]


def pulses_to_int8(code: PVQCode, *, debug: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 pulses, f32 scales).  ``code.k <= 127`` makes the cast lossless
    without reading the pulses; ``debug=True`` also checks their range (a
    read back to the host)."""
    if code.k > 127:
        raise ValueError(
            f"pulse budget K={code.k} exceeds the int8 coordinate bound 127; "
            "use kernels.ops.pulses_to_int8 for an explicit clamp"
        )
    p = code.pulses
    if debug and p.numel():
        maxabs = int(p.abs().max())
        if maxabs > 127:
            raise ValueError(f"pulse magnitude {maxabs} exceeds int8 range")
    return p.to(torch.int8), code.scale.to(torch.float32)


def packed_nbytes(code: PVQCode, fmt: str = "nibble") -> int:
    """Storage bytes for the code (pulses + scales), for compression reports."""
    n = int(np.prod(code.pulses.shape))
    g = int(np.prod(code.scale.shape))
    if fmt == "nibble":
        return (n + 1) // 2 + 4 * g
    if fmt == "int8":
        return n + 4 * g
    raise ValueError(fmt)
