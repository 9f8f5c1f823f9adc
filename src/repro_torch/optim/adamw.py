"""AdamW with f32 moments, global-norm clipping and a cosine schedule, on
nested dicts of tensors (port of ``repro.optim.adamw``).

The update is the reference's rule, not ``torch.optim.AdamW``'s: the step is
the bias-corrected ``mhat / (sqrt(vhat) + eps)``, the decay is added to the
step (times the learning rate) and only on leaves of rank >= 2, and the
gradients are clipped by their global norm (floored at 1e-12) first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class AdamWState(NamedTuple):
    step: int
    mu: Any  # f32 tree
    nu: Any  # f32 tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], float] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Any) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=0, mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def _lr(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any) -> Tuple[Any, AdamWState, torch.Tensor]:
        """Returns ``(new_params, new_state, grad_norm)``; the global norm
        stays on the device."""
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        gnorm = global_norm(g32)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            g32 = tree_map(lambda g: g * scale, g32)
        step = state.step + 1
        b1c = 1.0 - self.b1 ** step
        b2c = 1.0 - self.b2 ** step
        lr = self._lr(step)

        def upd(p, g, m, v):
            m = self.b1 * m + (1.0 - self.b1) * g
            v = self.b2 * v + (1.0 - self.b2) * g * g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay and p.ndim >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

        out = tree_map(upd, params, g32, state.mu, state.nu)
        pick = lambda i: tree_map(lambda t: t[i], out)
        return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)), gnorm


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """step -> lr: linear warm-up to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``."""

    def lr(step: int) -> float:
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))

    return lr
