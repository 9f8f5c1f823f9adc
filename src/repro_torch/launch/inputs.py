"""Shape-only stand-ins for every model input (port of
``repro.launch.inputs``): fake tensors under a ``FakeTensorMode``, which
carry shape, dtype and device and allocate nothing, so a dry-run of a
398B-parameter model holds no weights.

``input_specs(cfg, shape, model)`` returns the step function's inputs keyed
by the step kind:
    train   -> {'batch': {tokens, targets, [frames|patches]}}
    prefill -> {'batch': {tokens, [frames|patches]}}
    decode  -> {'cache': <zeros-shaped cache>, 'token': (b,1), 'pos': 0}

Every function takes the ``FakeTensorMode`` to build in (one is made when
none is given); a trace must run in the mode its inputs were built in.
``pos`` is a host int, as the port's eager decode step takes it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..nn.models import Model

I64 = torch.int64


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _in(mode):
    return mode if mode is not None else fake_mode()


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_targets: bool,
                mode=None) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.compute_dtype)
    with _in(mode):
        batch: Dict[str, Any] = {"tokens": torch.empty((b, s), dtype=I64)}
        if with_targets:
            batch["targets"] = torch.empty((b, s), dtype=I64)
        if cfg.family == "encdec":
            batch["frames"] = torch.empty((b, s, cfg.d_model), dtype=act)
        if cfg.family == "vlm":
            batch["patches"] = torch.empty((b, cfg.prefix_len, cfg.d_model), dtype=act)
    return batch


def params_shape(model: Model, max_seq: int = 0, mode=None):
    """``model.init``'s tree as fake tensors (the init's shape-only path)."""
    with _in(mode):
        return model.init(0, device="cpu", max_seq=max_seq)


def cache_shape(model: Model, batch: int, cache_len: int, enc_len: int = 0, mode=None):
    with _in(mode):
        return model.init_cache(batch, cache_len, device="cpu", enc_len=enc_len)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, model: Model,
                mode=None) -> Dict[str, Any]:
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_targets=True, mode=mode)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_targets=False, mode=mode)}
    if shape.kind == "decode":
        b, s = shape.global_batch, shape.seq_len
        enc_len = s if cfg.family == "encdec" else 0
        with _in(mode):
            token = torch.empty((b, 1), dtype=I64)
        return {
            "cache": cache_shape(model, b, s, enc_len, mode=mode),
            "token": token,
            "pos": 0,
        }
    raise ValueError(shape.kind)

