"""Scale folding / rho propagation through homogeneous networks (paper §V;
port of ``repro.core.fold``).

For positively-homogeneous nonlinearities (f(rho*x) = rho*f(x): ReLU, MaxPool,
identity, avg-pool) the per-layer PVQ scale rho_l passes through the
activation, so an L-layer net evaluates as

    out = (prod_l rho_l) * f_L(What_L . f_{L-1}(... f_1(What_1 . x)))    (eq. 14)

i.e. every layer runs on INTEGER pulse weights and one scalar is applied at
the output (or dropped entirely under argmax: "integer PVQ nets").  For
bsign nets (f(rho*x) = f(x), eq. 16-17) the scales are absorbed layer by
layer ("binary PVQ nets").  ``nn.sequential.SequentialNet.integer_forward``
runs the folded net.
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Tuple

import numpy as np
import torch

from .pvq import PVQCode

Activation = Literal["relu", "bsign", "none"]

HOMOGENEOUS: Tuple[str, ...] = ("relu", "none", "maxpool", "avgpool")
ABSORBING: Tuple[str, ...] = ("bsign",)


@dataclasses.dataclass
class FoldedLayer:
    """One folded layer: integer pulse weights (+ integer-pulse bias) only."""

    w_pulses: torch.Tensor  # int32 (in, out) or conv kernel
    b_pulses: torch.Tensor  # int32 (out,)
    activation: str
    kind: str  # 'dense' | 'conv' | 'maxpool' | 'flatten'
    # the bias pulses enter at the layer's own rho while the input arrives
    # scaled by prod(previous rho): the bias is multiplied by this gain
    # (1 / prod(previous rho)) to keep the layer's arithmetic integer
    bias_gain: float = 1.0


@dataclasses.dataclass
class FoldedNet:
    layers: List[FoldedLayer]
    output_scale: float  # prod of rho_l for homogeneous nets; 1.0 for bsign


def fold_codes(
    layer_codes: List[PVQCode],
    activations: List[str],
) -> Tuple[List[np.ndarray], float]:
    """Given per-layer whole-layer PVQ codes (one rho each) and the layers'
    activation kinds, return the integer pulse tensors (host arrays) and the
    single output scale.  Homogeneous activations propagate rho; absorbing
    ones (bsign) reset the running product to 1 after their layer."""
    if len(layer_codes) != len(activations):
        raise ValueError("one activation kind per coded layer")
    out_scale = 1.0
    pulse_tensors: List[np.ndarray] = []
    for code, act in zip(layer_codes, activations):
        rho = float(code.scale)
        pulse_tensors.append(code.pulses.detach().cpu().numpy())
        if act in ABSORBING:
            out_scale = 1.0  # f(rho x) = f(x): scale absorbed
        elif act in HOMOGENEOUS:
            out_scale *= rho  # f(rho x) = rho f(x): scale passes through
        else:
            raise ValueError(f"activation {act!r} is neither homogeneous nor absorbing")
    return pulse_tensors, out_scale


def check_homogeneity(act_name: str, fn, rho: float = 2.5, n: int = 128, seed: int = 0) -> bool:
    """Empirical check of f(rho x) = rho f(x) (or = f(x) for absorbing)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=gen)
    if act_name in ABSORBING:
        return bool(torch.allclose(fn(rho * x), fn(x)))
    return bool(torch.allclose(fn(rho * x), rho * fn(x), rtol=1e-5, atol=1e-6))
