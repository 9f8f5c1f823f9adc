"""Bring the JAX reference's parameters into the port.

``from_reference_params(tree)`` takes the reference's parameter pytree in
a framework-neutral form (nested dicts of numpy arrays, each ``PackedPVQ``
given as a dict with ``pulses``, ``scales``, ``group``, ``k``, ``shape``,
``dtype``, ``layout`` and ``scale_mode``) and returns the port's
parameters: the same nested dicts with torch tensors and
:class:`~repro_torch.core.packed.PackedPVQ` leaves, stacked ones included
(a MoE expert bank packed under a layer stack is 4-D: ``(repeats, E,
k_pad, n)``).  Leaves without a packed form (the f32 MoE router, the MLA
b-projections, norms) stay tensors.  A sequential net's tree (the paper's
nets A-D: ``{"layer<i>": {"kernel", "bias"}}``) comes across the same way,
its conv kernels as 4-D HWIO tensors in the reference's layout (the port's
``nn.sequential`` keeps that layout and permutes only at ``F.conv2d``).
Both packages then compute on identical weights and identical packed
codes.  ``from_reference_opt_state(state)`` carries the reference's
``AdamWState`` (``step`` a 0-d int array, ``mu`` and ``nu`` trees of numpy
arrays) across as the port's (``step`` a host int), so both packages can
train on from the same ``(params, opt_state)``.  Turning JAX arrays into
numpy is the caller's step, so this module imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.packed import PackedPVQ
from .optim.adamw import AdamWState

PACKED_KEYS = {"pulses", "scales", "group", "k", "shape", "dtype", "layout", "scale_mode"}


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin in numpy
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def from_reference_params(tree: Any, device="cpu") -> Any:
    if isinstance(tree, dict) and PACKED_KEYS.issubset(tree):
        return PackedPVQ(
            pulses=_tensor(tree["pulses"], device).to(torch.int8),
            scales=_tensor(tree["scales"], device).to(torch.float32),
            group=int(tree["group"]),
            k=int(tree["k"]),
            shape=tuple(int(s) for s in tree["shape"]),
            dtype=str(tree["dtype"]),
            layout=str(tree["layout"]),
            scale_mode=str(tree["scale_mode"]),
        )
    if isinstance(tree, dict):
        return {key: from_reference_params(sub, device) for key, sub in tree.items()}
    return _tensor(tree, device)


def from_reference_opt_state(state: Any, device="cpu") -> AdamWState:
    """The reference's ``AdamWState`` (any object with ``step``, ``mu`` and
    ``nu``, their leaves numpy arrays) as the port's."""
    return AdamWState(step=int(np.asarray(state.step)),
                      mu=from_reference_params(state.mu, device),
                      nu=from_reference_params(state.nu, device))
