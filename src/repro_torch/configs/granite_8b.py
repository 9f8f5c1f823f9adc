"""granite-8b [dense]: llama-arch code model. 36L, d=4096, 32H (kv=8),
d_ff=14336, vocab=49152. [arXiv:2405.04324]"""

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    ffn_activation="swiglu",
    tie_embeddings=True,
    supports_decode=True,
    subquadratic=False,
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
