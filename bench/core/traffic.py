"""The one traffic generator: reads a mix's parameters (``bench/traffic/*.json``)
and makes its requests from ``--seed``.

Every seed gets the same work.  The sizes and the gaps between arrivals are
the distribution's quantiles at ``(i + 0.5) / n`` (a stratified sample of
``n`` requests), so their multiset is fixed by the mix and the window, and
the mix's ``pattern_seed`` orders them: a fixed schedule, replayed by every
run.  ``--seed`` draws the tokens (and the weights).  Runs with different
seeds then differ by content, not by how much there is to do or when.

Kinds:

* ``poisson``: open-loop arrivals at ``rate_per_s``; ``n = round(rate *
  seconds)`` requests due in the window, each a prompt and an output length
  from their lognormal distributions (``median``, ``sigma``, clipped to
  ``[min, max]``).  With ``prefixes`` every prompt starts with one of
  ``count`` shared prompts of ``len`` tokens, picked with Zipf weights
  ``k ** -zipf_s`` (the counts are the weights' shares of ``n``); the
  engine's set-up serves each shared prompt once, as a deployment's prefix
  cache holds its system prompts.
* ``batch``: offline calls of ``batch`` sequences of ``prompt_len`` tokens
  and ``gen`` greedy tokens each, back to back; call ``i``'s tokens come
  from the seed and ``i``.
* ``train``: training steps back to back, each on ``batch`` rows of
  ``seq`` tokens (and their next tokens as targets); step ``i``'s rows
  come from the seed and ``i``, uniform over the vocabulary (drawn on the
  device: the same seed gives the same rows on one kind of device).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    rid: int
    arrival: float  # seconds after the window opens: when the request is due
    prompt: List[int]
    max_new: int
    prefix: Optional[int] = None  # which shared prompt it starts with


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator of the seed (any integer) and non-negative salts."""
    s = int(seed) % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, *salt])


def _lognormal_quantiles(d: dict, n: int) -> np.ndarray:
    nd = NormalDist()
    u = (np.arange(n) + 0.5) / n
    vals = [d["median"] * math.exp(d["sigma"] * nd.inv_cdf(float(x))) for x in u]
    return np.clip(np.rint(vals), d["min"], d["max"]).astype(np.int64)


def _exponential_gaps(rate: float, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def _zipf_counts(count: int, s: float, n: int) -> np.ndarray:
    w = np.arange(1, count + 1, dtype=np.float64) ** -s
    share = w / w.sum() * n
    out = np.floor(share).astype(np.int64)
    # the remainder to the largest fractional parts, lower index first
    for i in np.argsort(-(share - out), kind="stable")[: n - out.sum()]:
        out[i] += 1
    return out


def n_requests(mix: dict, seconds: float) -> int:
    return max(int(round(mix["rate_per_s"] * seconds)), 1)


def poisson(mix: dict, seed: int, seconds: float, vocab: int) -> List[RequestSpec]:
    n = n_requests(mix, seconds)
    p = rng(mix["pattern_seed"], 1)
    prompt_lens = p.permutation(_lognormal_quantiles(mix["prompt"], n))
    out_lens = p.permutation(_lognormal_quantiles(mix["output"], n))
    arrivals = np.cumsum(p.permutation(_exponential_gaps(mix["rate_per_s"], n)))
    pre = mix.get("prefixes")
    shared, which = shared_prefixes(mix, seed, vocab), [None] * n
    if pre:
        counts = _zipf_counts(pre["count"], pre["zipf_s"], n)
        which = p.permutation(np.repeat(np.arange(pre["count"]), counts)).tolist()
    g = rng(seed, 1)
    reqs = []
    for i in range(n):
        body = g.integers(0, vocab, int(prompt_lens[i])).tolist()
        head = shared[which[i]] if which[i] is not None else []
        reqs.append(RequestSpec(rid=i, arrival=float(arrivals[i]), prompt=head + body,
                                max_new=int(out_lens[i]), prefix=which[i]))
    return reqs


def shared_prefixes(mix: dict, seed: int, vocab: int) -> List[List[int]]:
    """The mix's shared prompts (none without ``prefixes``)."""
    pre = mix.get("prefixes")
    if not pre:
        return []
    g = rng(seed, 4)
    return [g.integers(0, vocab, pre["len"]).tolist() for _ in range(pre["count"])]


def batch_tokens(mix: dict, seed: int, call: int, vocab: int) -> np.ndarray:
    """Call ``call``'s prompts: ``(batch, prompt_len)`` int64."""
    return rng(seed, 2, call).integers(0, vocab, (mix["batch"], mix["prompt_len"]))


def prompt_lengths(mix: dict, seconds: float) -> List[int]:
    """Every prompt length a poisson mix sends in a window of ``seconds``
    (the same for every seed)."""
    n = n_requests(mix, seconds)
    lens = _lognormal_quantiles(mix["prompt"], n)
    extra = mix["prefixes"]["len"] if mix.get("prefixes") else 0
    return sorted(set(int(x) + extra for x in lens))


def train_batch(mix: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s ``(tokens, targets)``, each ``(batch, seq)`` int64:
    rows drawn on ``device`` (no copy from the host, so the feed never
    waits for the device), and the same rows shifted by one."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, 5, step).integers(0, 1 << 62)))
    rows = torch.randint(0, vocab, (mix["batch"], mix["seq"] + 1), generator=gen,
                         device=device)
    return rows[:, :-1], rows[:, 1:]
