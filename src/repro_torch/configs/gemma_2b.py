"""gemma-2b [dense]: 18L, d=2048, 8H MQA (kv=1), head_dim=256, d_ff=16384
GeGLU, vocab=256000. [arXiv:2403.08295]"""

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    ffn_activation="geglu",
    tie_embeddings=True,
    supports_decode=True,
    subquadratic=False,
    pvq=PVQConfig(n_over_k=1.0, n_over_k_embed=0.5, group=256),
)
