"""Activation rows for the tests of the per-row int8 boundary
(``ops.quantize_rows``, ``pvq_matmul.act_quant_rows_*``), from a seed with
numpy: normal rows, an all-zero row, a row whose products with the inverse
scale land on exact .5 ties, and a row whose absmax element is negative."""

from __future__ import annotations

import numpy as np
import torch

#: (rows, d_in, k_pad): smollm's d (padded to group 256) and d_ff
SHAPES = [(r, d, k) for r in (1, 32, 257) for d, k in ((960, 1024), (2560, 2560))]

#: the ties row: absmax 127 gives scale 1 and inverse 1, so each of these is
#: its own product, and round half to even takes the even neighbour
TIES = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5], np.float32)
TIES_ROUNDED = np.array([127, 2, -4, 0, 0, 2, -126, 4], np.int8)


def act_rows(seed: int, rows: int, d_in: int, dtype: torch.dtype,
             device="cpu") -> torch.Tensor:
    """``(rows, d_in)`` in ``dtype`` (every value exact in bf16): row 0
    normal (or, for a single row, the ties row), then the zero row, the
    ties row and the negative-absmax row, then normal rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d_in)).astype(np.float32) * 3.0
    special = [_ties(rng, d_in), np.zeros(d_in, np.float32), _ties(rng, d_in),
               _negative_absmax(rng, d_in)]
    if rows > 1:
        special = special[1:]
    for r, row in enumerate(special[:rows]):
        x[r] = row
    return torch.from_numpy(x).to(dtype).to(device)


def _ties(rng, d_in):
    row = (rng.integers(-200, 201, size=d_in) * 0.5).astype(np.float32).clip(-126.5, 126.5)
    row[: len(TIES)] = TIES
    return row


def _negative_absmax(rng, d_in):
    row = rng.normal(size=d_in).astype(np.float32)
    row[d_in // 2] = -40.0
    return row
