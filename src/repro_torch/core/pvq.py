"""Pyramid Vector Quantization core (PyTorch port of ``repro.core.pvq``).

The pyramid surface P(N, K) is the set of integer vectors with L1 norm K.
A real vector ``w`` is approximated as ``rho * y_hat`` with ``y_hat`` on
P(N, K).  The fast projection used by the encode kernel is:

1. floor-init ``y = floor(K |w| / ||w||_1)``;
2. largest-remainder bulk allocation of all but the last ``delta_max``
   missing pulses (a 32-round bisection over the IEEE bit patterns of the
   fractional parts; ties go to the lower lane);
3. the exact greedy argmax ``(corr + |w_i|)^2 / (energy + 2 y_i + 1)`` for
   the final pulses (first lane wins).

Every float sum over the group axis goes through :func:`tree_sum`, a
pairwise tree of elementwise adds in a fixed order.  The CUDA encode kernel
reduces in exactly that order (and is built without FMA contraction), so
the plain version here and the kernel agree bit for bit on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def tree_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over the last axis as a fixed pairwise tree: zero-pad to a power
    of two, then repeatedly add the upper half onto the lower half."""
    n = x.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x if keepdim else x[..., 0]


def _kdiv(k: int, safe: torch.Tensor) -> torch.Tensor:
    """``k / safe`` as one correctly rounded division (``int / tensor`` in
    PyTorch computes ``reciprocal(safe) * k``, which rounds twice)."""
    return torch.full_like(safe, float(k)) / safe


def _presearch(absw: torch.Tensor, k: int) -> torch.Tensor:
    """Initial integer pulse allocation: floor of the L1-scaled magnitudes."""
    l1 = tree_sum(absw, keepdim=True)
    safe = torch.where(l1 > 0, l1, torch.ones_like(l1))
    y = torch.floor(absw * _kdiv(k, safe))
    return torch.where(l1 > 0, y, torch.zeros_like(y))


def _greedy_topup(
    absw: torch.Tensor, y: torch.Tensor, k: int, n_iter: Optional[int] = None
) -> torch.Tensor:
    """Place the remaining pulses one at a time, each on
    ``argmax_j (C + |w_j|)^2 / (E + 2 y_j + 1)`` (first index wins)."""
    y = y.clone()
    corr = tree_sum(absw * y)
    energy = tree_sum(y * y)
    remaining = (k - tree_sum(y)).to(torch.int32)
    if n_iter is not None:
        remaining = torch.clamp(remaining, max=n_iter)
    steps = k if n_iter is None else min(n_iter, k)
    for _ in range(steps):
        do = remaining > 0
        if not bool(do.any()):
            break  # every later iteration is a masked no-op
        c = corr[..., None] + absw
        score = (c * c) / (energy[..., None] + 2.0 * y + 1.0)
        j = torch.argmax(score, dim=-1, keepdim=True)
        dof = do.to(y.dtype)
        y.scatter_add_(-1, j, dof[..., None])
        corr = corr + torch.gather(absw, -1, j)[..., 0] * dof
        energy = energy + (2.0 * torch.gather(y, -1, j)[..., 0] - 1.0) * dof
        remaining = remaining - do.to(torch.int32)
    return y


def _select_top_r(frac: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """0/1 mask of the ``r`` largest entries of ``frac`` (>= 0) per row, ties
    toward the lower index: a 32-round bisection over the IEEE bit patterns
    (non-negative floats order like their int32 patterns), then an
    equal-rank cumsum.  ``r``: int (..., 1)."""
    fb = frac.to(torch.float32).contiguous().view(torch.int32)
    lead = frac.shape[:-1] + (1,)
    lo = torch.full(lead, -1, dtype=torch.int32, device=frac.device)
    hi = torch.full(lead, 0x7F7FFFFF, dtype=torch.int32, device=frac.device)
    for _ in range(32):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        cnt = (fb > mid).sum(-1, keepdim=True)
        ok = cnt <= r
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
    gt = fb > hi
    extra = r - gt.sum(-1, keepdim=True)
    eq = fb == hi
    eq_rank = torch.cumsum(eq.to(torch.int32), dim=-1)
    return (gt | (eq & (eq_rank <= extra))).to(frac.dtype)


def _largest_remainder_topup(absw: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """All remaining pulses to the largest fractional parts (Hamilton)."""
    l1 = tree_sum(absw, keepdim=True)
    safe = torch.where(l1 > 0, l1, torch.ones_like(l1))
    frac = absw * _kdiv(k, safe) - y
    remaining = (k - tree_sum(y, keepdim=True)).to(torch.int32)
    bump = _select_top_r(frac, remaining)
    return y + torch.where(l1 > 0, bump, torch.zeros_like(bump))


def _sorted_topup(absw: torch.Tensor, y: torch.Tensor, k: int, delta_max: int) -> torch.Tensor:
    """Largest-remainder bulk allocation for all but the last ``delta_max``
    missing pulses, then the exact greedy argmax for those."""
    l1 = tree_sum(absw, keepdim=True)
    safe = torch.where(l1 > 0, l1, torch.ones_like(l1))
    target = absw * _kdiv(k, safe)
    frac = target - y
    remaining = (k - tree_sum(y, keepdim=True)).to(torch.int32)
    bulk = torch.clamp(remaining - delta_max, min=0)
    bump = _select_top_r(frac, bulk)
    y = y + torch.where(l1 > 0, bump, torch.zeros_like(bump))
    return _greedy_topup(absw, y, k, n_iter=delta_max)


def pvq_quantize_direction_fast(w: torch.Tensor, k: int, delta_max: int = 32) -> torch.Tensor:
    """O(N * 32 + N * delta_max) projection of the last axis onto P(N, K);
    int32 pulses with sign.  Bit-exact with the greedy search when the
    floor pre-allocation leaves at most ``delta_max`` pulses."""
    absw = torch.abs(w.to(torch.float32))
    y = _presearch(absw, k)
    y = _sorted_topup(absw, y, k, delta_max)
    return (torch.sign(w.to(torch.float32)) * y).to(torch.int32)


def pvq_quantize_direction(w: torch.Tensor, k: int, greedy_max: int = 1024) -> torch.Tensor:
    """Exact greedy O(NK) projection (K <= greedy_max), else floor +
    largest-remainder completion.  Kept as the test oracle of the fast path."""
    absw = torch.abs(w.to(torch.float32))
    y = _presearch(absw, k)
    if k <= greedy_max:
        y = _greedy_topup(absw, y, k)
    else:
        y = _largest_remainder_topup(absw, y, k)
    return (torch.sign(w.to(torch.float32)) * y).to(torch.int32)


def _scales(w: torch.Tensor, pulses: torch.Tensor, mode: str) -> torch.Tensor:
    """Per-row rho: ``paper`` = ||w|| / ||y||, ``ls`` = max(<w,y> / ||y||^2, 0);
    0 for rows without pulses."""
    y = pulses.to(torch.float32)
    wf = w.to(torch.float32)
    ynorm2 = tree_sum(y * y)
    safe = torch.where(ynorm2 > 0, ynorm2, torch.ones_like(ynorm2))
    if mode == "paper":
        rho = torch.sqrt(tree_sum(wf * wf)) / torch.sqrt(safe)
    elif mode == "ls":
        rho = torch.clamp(tree_sum(wf * y) / safe, min=0.0)
    else:
        raise ValueError(f"unknown scale mode {mode!r}")
    return torch.where(ynorm2 > 0, rho, torch.zeros_like(rho))


@dataclasses.dataclass(frozen=True)
class PVQCode:
    """A product-PVQ code: integer pulses on P(N, K) plus one scale per group."""

    pulses: torch.Tensor  # int32 (..., N), sum(|pulses|, -1) == K (0 for a null row)
    scale: torch.Tensor   # f32 (...,), rho
    k: int                # pulse budget

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.scale[..., None] * self.pulses.to(torch.float32)).to(dtype)


def pvq_encode(w: torch.Tensor, k: int, scale_mode: str = "paper") -> PVQCode:
    """Product-PVQ encode the last axis of ``w`` with pulse budget K."""
    pulses = pvq_quantize_direction(w, k)
    return PVQCode(pulses=pulses, scale=_scales(w, pulses, scale_mode), k=k)


def pvq_decode(code: PVQCode, dtype=torch.float32) -> torch.Tensor:
    return code.dequantize(dtype)


def pvq_encode_grouped(w: torch.Tensor, group: int, k: int,
                       scale_mode: str = "paper") -> PVQCode:
    """Encode the last axis of ``w`` in groups of ``group`` dims (one rho a
    group), zero-padded to a multiple of ``group`` (zeros get no pulses)."""
    pad = (-w.shape[-1]) % group
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    return pvq_encode(w.reshape(*w.shape[:-1], w.shape[-1] // group, group), k, scale_mode)


def pvq_decode_grouped(code: PVQCode, n: int, dtype=torch.float32) -> torch.Tensor:
    flat = code.dequantize(dtype)
    return flat.reshape(*flat.shape[:-2], -1)[..., :n]


# ---------------------------------------------------------------------------
# Dot products with PVQ codes + op-count accounting (paper §III)
# ---------------------------------------------------------------------------


def pvq_dot(code: PVQCode, x: torch.Tensor) -> torch.Tensor:
    """rho * (y_hat . x) — numerically identical to dot(dequantize, x)."""
    acc = torch.sum(code.pulses.to(torch.float32) * x.to(torch.float32), dim=-1)
    return code.scale * acc


def dot_op_counts(code: PVQCode) -> dict:
    """Paper §III claim: y_hat . x costs exactly K-1 adds/subs (unit-pulse
    evaluation) and the scale is ONE multiplication.  Returns the claimed
    counts and the naive counts for comparison (host-side accounting)."""
    pulses = code.pulses.detach().cpu().numpy()
    n = pulses.shape[-1]
    k_actual = int(np.abs(pulses).sum(axis=-1).max()) if pulses.size else 0
    return {
        "N": int(n),
        "K": int(code.k),
        "pvq_adds": max(k_actual - 1, 0),
        "pvq_muls": 1,
        "naive_adds": n - 1,
        "naive_muls": n,
        "nonzero": int((pulses != 0).sum(axis=-1).max()) if pulses.size else 0,
    }


# ---------------------------------------------------------------------------
# Host-side exact encoder (numpy, for the enumeration tools and tables)
# ---------------------------------------------------------------------------


def pvq_encode_np(
    w: np.ndarray, k: int, scale_mode: str = "paper", greedy_max: int = 1024
) -> Tuple[np.ndarray, float]:
    """Single-vector encoder in numpy (f64): the exact greedy search for
    K <= greedy_max, else floor + largest-remainder completion (stable
    order).  Returns ``(int64 pulses, rho)``."""
    w = np.asarray(w, dtype=np.float64)
    absw = np.abs(w)
    l1 = absw.sum()
    if l1 == 0:
        return np.zeros(w.shape, np.int64), 0.0
    y = np.floor(absw * (k / l1))
    if k <= greedy_max:
        corr = float((absw * y).sum())
        energy = float((y * y).sum())
        remaining = int(k - y.sum())
        for _ in range(remaining):
            score = (corr + absw) ** 2 / (energy + 2.0 * y + 1.0)
            j = int(np.argmax(score))
            y[j] += 1
            corr += absw[j]
            energy += 2.0 * y[j] - 1.0
    else:
        frac = absw * (k / l1) - y
        remaining = int(k - y.sum())
        order = np.argsort(-frac, kind="stable")
        rank_of = np.argsort(order, kind="stable")
        y = y + (rank_of < remaining)
    y = (np.sign(w) * y).astype(np.int64)
    ynorm = float(np.sqrt((y.astype(np.float64) ** 2).sum()))
    if scale_mode == "paper":
        rho = float(np.linalg.norm(w) / ynorm)
    else:
        rho = float((w * y).sum() / (ynorm**2))
    return y, rho
