"""Reduced cells for the CPU tests: the port's ``reduced()`` models (the
same families at toy widths) with the configuration files' keys, and
traffic small enough to serve in seconds."""

from __future__ import annotations

import copy

from bench.core import registry


def smollm_cfg() -> dict:
    cfg = copy.deepcopy(registry.config("smollm-360m"))
    cfg.update(port_reduced=True, hidden_size=64, intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=4, head_dim=16, num_hidden_layers=2, vocab_size=128)
    cfg["serving"].update(param_dtype="float32", compute_dtype="float32")
    cfg["serving"]["kv_cache"].update(block=8, group=16)
    cfg["training"].update(param_dtype="float32", compute_dtype="float32")
    return cfg


def deepseek_cfg() -> dict:
    cfg = copy.deepcopy(registry.config("deepseek-v2-lite-16b"))
    cfg.update(port_reduced=True, hidden_size=64, intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=4, num_hidden_layers=2, vocab_size=128,
               moe_intermediate_size=32, n_routed_experts=4, num_experts_per_tok=2,
               n_shared_experts=1, routing_group_size=64, kv_lora_rank=16,
               qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
    cfg["serving"].update(param_dtype="float32", compute_dtype="float32")
    return cfg


def engine_cell() -> dict:
    return {"config": "smollm-360m", "traffic": "tiny", "driver": "engine",
            "engine": {"n_slots": 3, "max_len": 96, "prefill_chunk": 2,
                       "prefill_batch": 2, "prefix_cache": True},
            "check": {"sample": 3, "max_logit_gap": 0.08}}


def chat_mix() -> dict:
    return {"kind": "poisson", "rate_per_s": 4.0, "pattern_seed": 1,
            "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.8, "min": 4, "max": 48},
            "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 2, "max": 12}}


def agent_mix() -> dict:
    mix = chat_mix()
    mix["prefixes"] = {"count": 2, "len": 32, "zipf_s": 1.1}
    mix["prompt"] = {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 16}
    return mix


def batch_cell() -> dict:
    return {"config": "deepseek-v2-lite-16b", "traffic": "tiny", "driver": "batch",
            "check": {"max_logit_gap": 0.25}}


def batch_mix() -> dict:
    return {"kind": "batch", "batch": 4, "prompt_len": 12, "gen": 5}


def train_cell() -> dict:
    """The training cell's settings; the first gradient's limit is wider at
    these widths, where one group of 32 a leaf that the program's encoder
    and the reference's split differently (a rounding tie) moves it by
    0.2%."""
    cell = copy.deepcopy(registry.cell("smollm-qat-train"))
    cell["traffic"] = "tiny"
    cell["check"]["grad1_gap"] = 0.008
    return cell


def train_mix() -> dict:
    return {"kind": "train", "batch": 2, "seq": 16}
