"""rwkv6-1.6b [ssm] "Finch": 24L, d=2048, attn-free wkv6 with data-dependent
decay, d_ff=7168, vocab=65536.  Decay/bonus params are PVQ-exempt
(recurrence params, not dot products — DESIGN.md §4). [arXiv:2404.05892]"""

from ..nn.rwkv import RWKVConfig

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    ffn_activation="relu2",
    norm="layernorm",
    rope_theta=None,
    tie_embeddings=False,
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    supports_decode=True,
    subquadratic=True,  # O(1) state per token; runs long_500k
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
