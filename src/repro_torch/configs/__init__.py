"""Config registry: ``get_config(arch_id)`` for every architecture of the reference."""

from typing import Dict

from . import (
    deepseek_v2_236b,
    deepseek_v2_lite_16b,
    gemma_2b,
    granite_8b,
    jamba_1_5_large_398b,
    paligemma_3b,
    rwkv6_1_6b,
    smollm_360m,
    starcoder2_15b,
    whisper_small,
)
from .base import ModelConfig, PVQConfig

ARCHS: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (whisper_small, deepseek_v2_236b, deepseek_v2_lite_16b, granite_8b, smollm_360m,
              starcoder2_15b, gemma_2b, jamba_1_5_large_398b, paligemma_3b, rwkv6_1_6b)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ModelConfig", "PVQConfig", "ARCHS", "get_config"]
