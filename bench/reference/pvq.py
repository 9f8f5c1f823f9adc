"""PVQ weight and KV codes, and symmetric activation quantization, in plain
PyTorch: the formats the serving configuration states, worked out from the
float values.

A code of ``n`` values on ``K`` pulses: ``y = floor(K |w| / ||w||_1)``; all
but the last ``delta`` missing pulses to the largest fractional parts
(ties to the lower index); the rest one at a time to ``argmax_j (C +
|w_j|)^2 / (E + 2 y_j + 1)`` (``C = <|w|, y>``, ``E = ||y||^2``; the first
index wins); signs from ``w``; each pulse clamped to the int8 range; then
``rho = max(<w, p> / ||p||^2, 0)``.
"""

from __future__ import annotations

import torch

DELTA = 32
INT8_MAX = 127


def encode(w: torch.Tensor, k: int, delta: int = DELTA, rows_per_chunk: int = 1 << 20):
    """``w (rows, n)`` -> ``(pulses f32 (rows, n), rho f32 (rows,))``."""
    w = w.to(torch.float32)
    out_p = torch.empty_like(w)
    out_r = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
    for lo in range(0, w.shape[0], rows_per_chunk):
        p, r = _encode(w[lo : lo + rows_per_chunk], k, delta)
        out_p[lo : lo + rows_per_chunk] = p
        out_r[lo : lo + rows_per_chunk] = r
    return out_p, out_r


def _encode(w: torch.Tensor, k: int, delta: int):
    n = w.shape[-1]
    a = w.abs()
    l1 = a.sum(-1, keepdim=True)
    live = l1 > 0
    safe = torch.where(live, l1, torch.ones_like(l1))
    target = a * (torch.full_like(safe, float(k)) / safe)
    y = torch.where(live, torch.floor(target), torch.zeros_like(target))
    missing = k - y.sum(-1, keepdim=True)
    bulk = (missing - delta).clamp(min=0)
    order = torch.sort(target - y, dim=-1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(n, device=w.device).expand_as(order))
    y = y + ((rank < bulk) & live).to(y.dtype)
    corr = (a * y).sum(-1)
    energy = (y * y).sum(-1)
    left = (k - y.sum(-1)).round()
    for _ in range(delta):
        do = left > 0
        if not bool(do.any()):
            break
        score = (corr[:, None] + a) ** 2 / (energy[:, None] + 2.0 * y + 1.0)
        j = score.argmax(-1, keepdim=True)
        dof = do.to(y.dtype)
        yj = torch.gather(y, -1, j)[:, 0]
        y.scatter_add_(-1, j, dof[:, None])
        corr = corr + torch.gather(a, -1, j)[:, 0] * dof
        energy = energy + (2.0 * yj + 1.0) * dof
        left = left - dof
    p = (torch.sign(w) * y).clamp(-INT8_MAX, INT8_MAX)
    pp = (p * p).sum(-1)
    rho = torch.where(pp > 0, ((w * p).sum(-1) / torch.where(pp > 0, pp, torch.ones_like(pp)))
                      .clamp(min=0.0), torch.zeros_like(pp))
    return p, rho


def fit_group(group: int, dim: int) -> int:
    g = group
    while g > 1 and dim % g:
        g //= 2
    return g


def k_pulses(n: int, n_over_k: float) -> int:
    return max(int(round(n / n_over_k)), 1)


def matmul_weight(w: torch.Tensor, group: int, n_over_k: float) -> torch.Tensor:
    """A ``(k, n)`` weight (or a stack ``(..., k, n)``) as its PVQ code
    decodes: groups of ``group`` rows of each column, the contraction
    zero-padded to a whole group (a contraction under one group takes a
    power-of-two divisor of it)."""
    *lead, k, n = w.shape
    g = fit_group(group, k) if k < group else group
    kp = -(-k // g) * g
    wf = torch.nn.functional.pad(w.to(torch.float32), (0, 0, 0, kp - k))
    rows = wf.transpose(-1, -2).reshape(-1, g)
    p, rho = encode(rows, k_pulses(g, n_over_k))
    deq = (p * rho[:, None]).reshape(*lead, n, kp).transpose(-1, -2)
    return deq[..., :k, :].contiguous()


def flat_weight(w: torch.Tensor, group: int, n_over_k: float) -> torch.Tensor:
    """A table coded in row-major groups that divide its rows (the
    embedding)."""
    g = fit_group(group, w.shape[-1])
    p, rho = encode(w.to(torch.float32).reshape(-1, g), k_pulses(g, n_over_k))
    return (p * rho[:, None]).reshape(w.shape)


def kv_pages(x: torch.Tensor, group: int, k: int) -> torch.Tensor:
    """K or V rows ``(..., head_dim)`` as their PVQ KV pages decode."""
    g = fit_group(group, x.shape[-1])
    p, rho = encode(x.to(torch.float32).reshape(-1, g), k)
    return (p * rho[:, None]).reshape(x.shape)


def act(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric per-row quantization to ``[-qmax, qmax]`` of the last axis,
    decoded: ``round(x / s) * s`` with ``s = max|x| / qmax``."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(-1, keepdim=True) / qmax
    inv = torch.where(s > 0, 1.0 / s.clamp(min=1e-30), torch.zeros_like(s))
    return torch.clamp(torch.round(xf * inv), -qmax, qmax) * s
