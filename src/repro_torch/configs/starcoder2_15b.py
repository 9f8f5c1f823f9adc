"""starcoder2-15b [dense]: 40L, d=6144, 48H (kv=4), d_ff=24576, vocab=49152,
GQA + RoPE. [arXiv:2402.19173]"""

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    ffn_activation="gelu",  # starcoder2 uses a non-gated gelu MLP
    attn_bias=True,
    tie_embeddings=True,
    supports_decode=True,
    subquadratic=False,
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
