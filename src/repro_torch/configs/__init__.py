"""Config registry: ``get_config(arch_id)`` for the ported architectures."""

from typing import Dict

from . import (
    deepseek_v2_lite_16b,
    gemma_2b,
    granite_8b,
    paligemma_3b,
    smollm_360m,
    starcoder2_15b,
    whisper_small,
)
from .base import ModelConfig, PVQConfig

ARCHS: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (whisper_small, deepseek_v2_lite_16b, granite_8b, smollm_360m, starcoder2_15b,
              gemma_2b, paligemma_3b)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ModelConfig", "PVQConfig", "ARCHS", "get_config"]
