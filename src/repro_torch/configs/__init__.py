"""Config registry: ``get_config(arch_id)`` for the ported architectures."""

from typing import Dict

from . import deepseek_v2_lite_16b, smollm_360m
from .base import ModelConfig, PVQConfig

ARCHS: Dict[str, ModelConfig] = {c.CONFIG.name: c.CONFIG for c in (smollm_360m, deepseek_v2_lite_16b)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ModelConfig", "PVQConfig", "ARCHS", "get_config"]
