"""deepseek-v2-236b [moe]: 60L, d=5120, 128H, MLA (kv_lora=512, q_lora=1536),
expert d_ff=1536, 160 routed experts top-6 + 2 shared, vocab=102400.
First layer dense FFN (d_ff=12288) per the HF config. [arXiv:2405.04434]"""

from ..nn.mla import MLAConfig
from ..nn.moe import MoEConfig

from .base import ModelConfig, PVQConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,  # v head dim (MLA nope=128/rope=64 handled by MLAConfig)
    d_ff=1536,     # routed expert hidden
    d_ff_dense=12288,
    first_dense=1,
    vocab_size=102400,
    ffn_activation="swiglu",
    tie_embeddings=False,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, nope_head_dim=128, rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        n_experts=160, top_k=6, n_shared=2, d_expert=1536,
        capacity_factor=1.25, group_size=1024, activation="swiglu",
    ),
    moe_period=1,
    supports_decode=True,
    subquadratic=False,
    # PVQ sweet spot: weight-memory-bound routed experts (DESIGN.md §4)
    pvq=PVQConfig(n_over_k=1.0, group=256),
)
