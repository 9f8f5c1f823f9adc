"""Deterministic synthetic datasets (port of ``repro.data.synthetic``; numpy
in both packages, so one seed samples identical batches in each).

* ``TokenTask``: a learnable synthetic language — a random order-2 Markov
  chain over the vocab with Zipfian marginals.  Cross-entropy is reducible
  from log(V) toward the chain's conditional entropy, so training curves are
  meaningful (loss decreases monotonically for a working trainer).
* ``ClassifyTask``: MNIST/CIFAR-like classification — K class prototypes +
  structured noise, image-shaped.  Linearly separable at high SNR, genuinely
  learnable; used by the paper-reproduction experiments (nets A-D) while
  the real MNIST and CIFAR-10 files are not in the repository.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class TokenTask:
    vocab_size: int
    seed: int = 0
    branch: int = 8  # plausible successors per context

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipfian unigram
        ranks = np.arange(1, v + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # order-1 successor table: each token has `branch` likely successors
        self.successors = rng.integers(0, v, size=(v, self.branch))
        self.mix = 0.85  # prob of following the chain vs unigram sample

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> Dict[str, np.ndarray]:
        v = self.vocab_size
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.choice(v, size=batch, p=self.unigram)
        for t in range(seq):
            follow = rng.random(batch) < self.mix
            succ_idx = rng.integers(0, self.branch, size=batch)
            chain_next = self.successors[toks[:, t], succ_idx]
            rand_next = rng.choice(v, size=batch, p=self.unigram)
            toks[:, t + 1] = np.where(follow, chain_next, rand_next)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class ClassifyTask:
    """K-class prototype images + noise (MNIST-like when shape=(784,))."""

    input_shape: Tuple[int, ...]
    n_classes: int = 10
    noise: float = 0.7
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        dim = int(np.prod(self.input_shape))
        # smooth prototypes (low-frequency structure, like digit strokes)
        raw = rng.normal(size=(self.n_classes, dim)).astype(np.float32)
        kernel = np.ones(9) / 9.0
        self.prototypes = np.stack(
            [np.convolve(r, kernel, mode="same") for r in raw]
        ) * 3.0

    def sample(self, rng: np.random.Generator, batch: int) -> Dict[str, np.ndarray]:
        y = rng.integers(0, self.n_classes, size=batch).astype(np.int32)
        x = self.prototypes[y] + rng.normal(
            scale=self.noise, size=(batch, self.prototypes.shape[1])
        ).astype(np.float32)
        return {"x": x.reshape((batch,) + tuple(self.input_shape)), "y": y}

    def test_set(self, n: int = 2048, seed: int = 10_000) -> Dict[str, np.ndarray]:
        return self.sample(np.random.default_rng(seed), n)
