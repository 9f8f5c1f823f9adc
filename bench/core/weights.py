"""Float weights made from ``--seed`` on the device, one tensor per leaf and
layer, so that the program and the reference get the same numbers and the
reference can make each layer again after the window without holding the
model twice.

A leaf is named by its path in the port's parameter tree
(``segments/seg0/b0/mixer/wq/kernel``); a stacked leaf of a segment is
made layer by layer (``layer`` its index).  Norm scales are ones, biases
zeros, the embedding ``N(0, 0.02)``, every other matrix ``N(0, 1 /
fan_in)`` with ``fan_in`` its second-to-last dimension."""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import torch


def leaf_seed(seed: int, path: str, layer: Optional[int]) -> int:
    h = hashlib.blake2b(f"{int(seed)}|{path}|{layer}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


class WeightSource:
    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def get(self, path: str, layer: Optional[int], shape: Sequence[int], dtype) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        name = path.rsplit("/", 1)[-1]
        if name.endswith("_scale"):
            return torch.ones(shape, dtype=dtype, device=self.device)
        if name.endswith("bias"):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        std = 0.02 if name == "embedding" else float(shape[-2]) ** -0.5
        gen = torch.Generator(device=self.device)
        gen.manual_seed(leaf_seed(self.seed, path, layer))
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device)
        return t.mul_(std).to(dtype)
