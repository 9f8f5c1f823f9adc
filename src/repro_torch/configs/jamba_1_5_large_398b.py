"""jamba-1.5-large-398b [hybrid]: 72L, d=8192, 64H (kv=8), d_ff=24576,
MoE 16e top-2, Mamba:attn 7:1 interleave (attn at slot 4 of each 8-layer
super-block, MoE on odd slots). [arXiv:2403.19887]"""

from ..nn.mamba import SSMConfig
from ..nn.moe import MoEConfig

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    ffn_activation="swiglu",
    tie_embeddings=False,
    hybrid_period=8,
    moe_period=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(
        n_experts=16, top_k=2, n_shared=0, d_expert=24576,
        capacity_factor=1.25, group_size=1024, activation="swiglu",
    ),
    supports_decode=True,
    subquadratic=True,  # mamba layers are O(1)/token; runs long_500k
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
