"""deepseek-v2-lite-16b [moe]: 27L, d=2048, 16H, MLA kv_lora=512 (no q lora),
expert d_ff=1408, 64 routed experts top-6 + 2 shared, vocab=102400.
First layer dense FFN (d_ff=10944) per the HF config. [arXiv:2405.04434]"""

from ..nn.mla import MLAConfig
from ..nn.moe import MoEConfig
from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    d_ff_dense=10944,
    first_dense=1,
    vocab_size=102400,
    ffn_activation="swiglu",
    tie_embeddings=False,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None, nope_head_dim=128, rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        n_experts=64, top_k=6, n_shared=2, d_expert=1408,
        capacity_factor=1.25, group_size=1024, activation="swiglu",
    ),
    moe_period=1,
    supports_decode=True,
    subquadratic=False,
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
