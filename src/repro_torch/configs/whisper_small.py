"""whisper-small [audio]: enc-dec, 12L, d=768, 12H (kv=12), d_ff=3072,
vocab=51865. Conv audio frontend is a STUB: input_specs provides precomputed
frame embeddings (b, s, d). [arXiv:2212.04356]"""

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    ffn_activation="gelu",
    norm="layernorm",
    attn_bias=True,
    rope_theta=None,          # whisper uses absolute positions
    learned_positions=True,
    max_position=65536,       # sized for the assigned 32k shapes
    tie_embeddings=True,
    supports_decode=True,
    subquadratic=False,
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
