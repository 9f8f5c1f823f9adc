"""paligemma-3b [vlm]: SigLIP frontend STUB (input_specs provides patch
embeddings) + gemma-2b backbone: 18L, d=2048, 8H MQA (kv=1), d_ff=16384,
vocab=257216, prefix-LM mask over 256 patch tokens. [arXiv:2407.07726]"""

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    ffn_activation="geglu",
    tie_embeddings=True,
    prefix_len=256,
    supports_decode=True,
    subquadratic=False,
    pvq=PVQConfig(n_over_k=1.0, n_over_k_embed=0.5, group=256),
)
