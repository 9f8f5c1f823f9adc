"""Group rows for the encoder's tests, from a seed with numpy: rows with exact
ties (equal magnitudes, so equal fractional parts), zero rows, and sparse
rows whose bulk allocation is empty."""

from __future__ import annotations

import numpy as np

KINDS = ("normal", "laplace", "ties", "const", "sparse", "zero")


def encode_rows(seed: int, g: int, n: int, kinds=KINDS) -> np.ndarray:
    """``(g, n)`` float32 rows; row r is of kind ``kinds[r % len(kinds)]``."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((g, n), np.float32)
    for r in range(g):
        kind = kinds[r % len(kinds)]
        if kind == "normal":
            rows[r] = rng.normal(size=n) * 0.03
        elif kind == "laplace":
            rows[r] = rng.laplace(size=n)
        elif kind == "ties":  # few distinct magnitudes, zeros among them
            rows[r] = rng.integers(-4, 5, size=n) * 0.25
        elif kind == "const":  # every magnitude equal: one fractional part
            rows[r] = rng.choice([-0.5, 0.5], size=n)
        elif kind == "sparse":  # at most 3 nonzeros: at most 3 pulses missing
            rows[r, rng.choice(n, size=min(n, 3), replace=False)] = rng.normal(size=min(n, 3))
        elif kind != "zero":
            raise ValueError(f"unknown row kind {kind!r}")
    return rows
