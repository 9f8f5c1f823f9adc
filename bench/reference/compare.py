"""How far the served tokens fall below the reference's best, and how far
a training run's readings lie from the reference's."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch


def widest_gap(ref_logits: List[torch.Tensor], tokens: List[torch.Tensor]) -> float:
    """The largest ``max(ref) - ref[token]`` over every served token: 0
    where the reference picks the served token, the logit distance where
    it prefers another.  Non-finite logits read as infinitely far."""
    worst = 0.0
    for lg, tok in zip(ref_logits, tokens):
        lg = lg.reshape(-1, lg.shape[-1])
        tok = tok.reshape(-1).to(lg.device)
        if not bool(torch.isfinite(lg).all()):
            return math.inf
        gap = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def argmax_tokens(logits: List[torch.Tensor]) -> List[torch.Tensor]:
    return [lg.reshape(-1, lg.shape[-1]).argmax(-1) for lg in logits]


#: a leaf whose first gradient in the reference is under this share of the
#: median leaf's moves by round-off alone, and its change is not compared
STILL_LEAF = 1e-3


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """The worst leaf's gap of norms, ``|got - want|``, over the larger of
    its reference norm and the median leaf's."""
    med = statistics.median(want[p] for p in want)
    worst = 0.0
    for p in leaves:
        g, w = got.get(p, math.nan), want[p]
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - w) / max(w, med, 1e-30))
    return worst


def train_gaps(got: dict, want: dict) -> Dict[str, float]:
    """A run's first steps against the reference's (:func:`train_steps`'s
    keys): the widest gap of a step's loss (nats); of a step's global
    gradient norm, as a share of the reference's; of a leaf's first
    gradient (the optimizer's, after clipping) and of a leaf's change over
    the steps, by the worst leaf (``_leaf_gap``), the change over the leaves
    the reference moves by their gradient (``STILL_LEAF``)."""
    def widest(a, b, rel):
        if len(a) != len(b) or not all(math.isfinite(x) for x in a):
            return math.inf
        return max(abs(x - y) / (abs(y) if rel else 1.0) for x, y in zip(a, b))

    g1 = want["grad1"]
    med = statistics.median(g1.values())
    moved = [p for p in g1 if g1[p] >= STILL_LEAF * med]
    return {"loss_gap": widest(got["loss"], want["loss"], False),
            "grad_norm_gap": widest(got["grad_norm"], want["grad_norm"], True),
            "grad1_gap": _leaf_gap(got["grad1"], g1, list(g1)),
            "change_gap": _leaf_gap(got["change"], want["change"], moved)}
