"""Sequential MLP/CNN substrate for the paper's own experiments (§VII; port
of ``repro.nn.sequential``).

The Keras-example topologies the paper uses (nets A-D): fully connected
stacks with ReLU or bsign activations, and the small CIFAR CNN
(conv/maxpool).  Supports the paper's per-layer PVQ procedure (flatten
weights+bias into ONE vector per layer, single rho), rho-folding
verification, integer-only inference, and the packed serving form whose fc
layers run the hand-written matmul kernels.

Layouts are the reference's, so that whole-layer codes, the fc weights after
a flatten and a ``.pvqz`` file are the same in both packages: conv kernels
are HWIO and activations NHWC; only the ``F.conv2d`` call sees NCHW/OIHW.
The float convs and matmuls run in full f32 (no TF32) on cuDNN's
deterministic algorithms inside every method (:func:`full_f32`): the §V
fold check compares two float paths at ~1e-6, and a seed's training repeats.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.pvq import PVQCode, pvq_encode
from ..core.qat import bsign
from ..core.quantize import k_for
from .layers import pvq_dense, pvq_quantize_dense


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # 'fc' | 'conv' | 'maxpool' | 'flatten' | 'dropout'
    out: int = 0  # fc units or conv channels
    kernel: int = 3  # conv kernel size
    pool: int = 2
    rate: float = 0.0  # dropout
    activation: str = "relu"  # 'relu' | 'bsign' | 'none'
    n_over_k: Optional[float] = None  # paper's N/K for this layer (None = skip PVQ)


@dataclasses.dataclass(frozen=True)
class SequentialConfig:
    name: str
    input_shape: Tuple[int, ...]  # e.g. (784,) or (32, 32, 3)
    layers: Tuple[LayerSpec, ...]
    n_classes: int = 10


@contextlib.contextmanager
def full_f32():
    """Float matmuls and cuDNN convs in full f32 for the scope (TF32 off),
    on cuDNN's deterministic algorithms (its default conv backward adds in
    a varying order, so training from one seed would not repeat); the
    previous settings are restored on exit."""
    flags = ((torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True))
    prev = [getattr(mod, name) for mod, name, _ in flags]
    for mod, name, value in flags:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name, _), value in zip(flags, prev):
            setattr(mod, name, value)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "bsign":
        return bsign(x)
    if name == "none":
        return x
    raise ValueError(name)


def _conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv of NHWC ``x`` with an HWIO ``kernel``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding="same")
    return y.permute(0, 2, 3, 1)


def _maxpool(x: torch.Tensor, pool: int) -> torch.Tensor:
    """VALID max pool of NHWC ``x`` over ``pool x pool`` windows."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), pool, pool).permute(0, 2, 3, 1)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """NHWC (or any rank) to (batch, features) in the reference's order."""
    return x.reshape(x.shape[0], -1) if x.ndim > 2 else x


class SequentialNet:
    def __init__(self, cfg: SequentialConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """He-normal kernels and zero biases from a ``torch.Generator``
        seeded with ``seed`` (the reference's values come from
        ``jax.random``; ``convert.from_reference_params`` carries those)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        params: Dict[str, Any] = {}
        shape = self.cfg.input_shape
        for i, spec in enumerate(self.cfg.layers):
            if spec.kind == "fc":
                d_in = int(np.prod(shape))
                w = torch.randn((d_in, spec.out), generator=gen, device=device)
                params[f"layer{i}"] = {"kernel": w * (2.0 / d_in) ** 0.5,
                                       "bias": torch.zeros(spec.out, device=device)}
                shape = (spec.out,)
            elif spec.kind == "conv":
                cin = shape[-1]
                w = torch.randn((spec.kernel, spec.kernel, cin, spec.out), generator=gen,
                                device=device)
                w = w * (2.0 / (spec.kernel * spec.kernel * cin)) ** 0.5
                params[f"layer{i}"] = {"kernel": w, "bias": torch.zeros(spec.out, device=device)}
                shape = (shape[0], shape[1], spec.out)  # SAME padding
            elif spec.kind == "maxpool":
                shape = (shape[0] // spec.pool, shape[1] // spec.pool, shape[2])
            elif spec.kind == "flatten":
                shape = (int(np.prod(shape)),)
        return params

    def apply(
        self,
        params: Dict[str, Any],
        x: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Float forward; logits (the last fc has activation 'none').
        Dropout runs when ``train`` and draws its masks from ``generator``."""
        with full_f32():
            for i, spec in enumerate(self.cfg.layers):
                if spec.kind == "fc":
                    p = params[f"layer{i}"]
                    x = _act(spec.activation, _flat(x) @ p["kernel"] + p["bias"])
                elif spec.kind == "conv":
                    p = params[f"layer{i}"]
                    x = _act(spec.activation, _conv(x, p["kernel"]) + p["bias"])
                elif spec.kind == "maxpool":
                    x = _maxpool(x, spec.pool)
                elif spec.kind == "flatten":
                    x = _flat(x)
                elif spec.kind == "dropout" and train and generator is not None:
                    keep = torch.rand(x.shape, generator=generator, device=x.device) \
                        < 1.0 - spec.rate
                    x = torch.where(keep, x / (1.0 - spec.rate), torch.zeros_like(x))
        return x

    # ------------------------------------------------------------------ PVQ

    def pvq_encode_layers(
        self, params: Dict[str, Any], scale_mode: str = "paper"
    ) -> Tuple[Dict[str, Any], Dict[str, PVQCode], Dict[str, Dict]]:
        """The paper's §VII procedure: per weight layer, flatten the kernel
        (HWIO order for a conv), append the bias, PVQ the whole as ONE vector
        with K = N / (N/K ratio), and split it back."""
        new_params = dict(params)
        codes: Dict[str, PVQCode] = {}
        stats: Dict[str, Dict] = {}
        for i, spec in enumerate(self.cfg.layers):
            pname = f"layer{i}"
            if pname not in params or spec.n_over_k is None:
                continue
            p = params[pname]
            wflat = p["kernel"].reshape(-1)
            flat = torch.cat([wflat, p["bias"]])
            n = flat.shape[0]
            k = k_for(n, spec.n_over_k)
            code = pvq_encode(flat, k, scale_mode)
            deq = code.dequantize()
            new_params[pname] = {
                "kernel": deq[: wflat.shape[0]].reshape(p["kernel"].shape),
                "bias": deq[wflat.shape[0]:],
            }
            codes[pname] = code
            stats[pname] = {"N": n, "K": k, "n_over_k": spec.n_over_k}
        return new_params, codes, stats

    def pvq_kernel_encode(self, params: Dict[str, Any], *, group: int = 128) -> Dict[str, Any]:
        """Every PVQ-eligible fc layer in the packed serving form: each
        (group, output column) slice its own pyramid code, in the matmul
        layout the kernels stream (``{"kernel": PackedPVQ, "bias"}``), K per
        group from the layer's N/K.  On a CUDA tensor the encoder kernel
        packs it.  Returns {layer_name: packed params}."""
        kparams: Dict[str, Any] = {}
        for i, spec in enumerate(self.cfg.layers):
            pname = f"layer{i}"
            if spec.kind != "fc" or pname not in params or spec.n_over_k is None:
                continue
            kparams[pname] = pvq_quantize_dense(params[pname], group=group,
                                                k_pulses=k_for(group, spec.n_over_k))
        return kparams

    def kernel_apply(
        self,
        params: Dict[str, Any],
        kparams: Dict[str, Any],
        x: torch.Tensor,
        *,
        group: int = 128,
        act_quant=None,
    ) -> torch.Tensor:
        """Forward pass with the packed fc layers on the matmul kernels.

        Each packed layer runs ``pvq_dense`` (``ops.packed_matmul``) with
        the bias and a relu/none activation fused into the kernel's epilogue
        (bsign runs after it); ``act_quant`` (an ``ActQuant``, default the
        process one) quantizes its input to int8 for kernel v3, else kernel
        v2 takes f32.  Unpacked and conv layers run as in :meth:`apply`."""
        with full_f32():
            for i, spec in enumerate(self.cfg.layers):
                pname = f"layer{i}"
                if spec.kind == "fc":
                    x = _flat(x)
                    if pname in kparams:
                        fused = spec.activation if spec.activation in ("relu", "none") else "none"
                        y = pvq_dense(kparams[pname], x, activation=fused, act_quant=act_quant)
                        x = y if fused == spec.activation else _act(spec.activation, y)
                    else:
                        p = params[pname]
                        x = _act(spec.activation, x @ p["kernel"] + p["bias"])
                elif spec.kind == "conv":
                    p = params[pname]
                    x = _act(spec.activation, _conv(x, p["kernel"]) + p["bias"])
                elif spec.kind == "maxpool":
                    x = _maxpool(x, spec.pool)
                elif spec.kind == "flatten":
                    x = _flat(x)
        return x

    def integer_forward(
        self, params: Dict[str, Any], codes: Dict[str, PVQCode], x: torch.Tensor
    ) -> Tuple[torch.Tensor, float]:
        """Paper §V: forward on the integer pulses alone, one output scale.

        Valid for all-ReLU (homogeneous) nets: each layer's bias pulses are
        divided by the running input scale so that rho factors out of the
        whole layer; a bsign layer absorbs the scale (eq. 16).  Returns
        ``(logits of the integer path, cumulative scale)``."""
        run_scale = 1.0
        with full_f32():
            for i, spec in enumerate(self.cfg.layers):
                pname = f"layer{i}"
                if spec.kind in ("fc", "conv"):
                    if spec.kind == "fc":
                        x = _flat(x)
                    if pname in codes:
                        code = codes[pname]
                        rho = float(code.scale)
                        deq = code.pulses.to(torch.float32)
                        shape = params[pname]["kernel"].shape
                        wn = params[pname]["kernel"].numel()
                        w, b = deq[:wn].reshape(shape), deq[wn:]
                        y = x @ w if spec.kind == "fc" else _conv(x, w)
                        x = _act(spec.activation, y + b / run_scale)
                        run_scale = run_scale * rho
                        if spec.activation == "bsign":
                            run_scale = 1.0  # absorbed (eq. 16)
                    elif spec.kind == "fc":
                        p = params[pname]
                        x = _act(spec.activation, x @ p["kernel"] + p["bias"] / run_scale)
                elif spec.kind == "maxpool":
                    x = _maxpool(x, spec.pool)
                elif spec.kind == "flatten":
                    x = _flat(x)
        return x, run_scale


# ---------------------------------------------------------------------------
# Training helpers (the paper experiment and the tests)
# ---------------------------------------------------------------------------


def xent_loss(net: SequentialNet, params, batch, generator: Optional[torch.Generator] = None):
    """Mean cross-entropy; dropout runs when a ``generator`` is given."""
    logits = net.apply(params, batch["x"], train=generator is not None, generator=generator)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["y"].long()[:, None])[:, 0]
    return torch.mean(logz - tgt)


def accuracy(net: SequentialNet, params, x, y) -> float:
    with torch.no_grad():
        logits = net.apply(params, x)
        return float(torch.mean((torch.argmax(logits, -1) == y).to(torch.float32)))
