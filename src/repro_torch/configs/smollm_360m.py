"""smollm-360m [dense]: llama-arch small. 32L, d=960, 15H (kv=5), d_ff=2560,
vocab=49152. [hf:HuggingFaceTB/SmolLM-360M]"""

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    ffn_activation="swiglu",
    tie_embeddings=True,
    supports_decode=True,
    subquadratic=False,
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
