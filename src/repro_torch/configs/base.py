"""Model configuration schema (PyTorch port of ``repro.configs.base``).

The reference module imports the MLA/MoE/SSM/RWKV config types from its
JAX layer modules, so the port keeps its own copy.  Those families are not
ported yet: their fields exist (so ``dataclasses.asdict`` matches the
reference field for field) but only ``None`` is accepted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class PVQConfig:
    """How PVQ applies to this model's weights."""

    enabled: bool = True
    # N/K ratio for matmul weights; the embedding gets a gentler ratio
    n_over_k: float = 1.0
    n_over_k_embed: float = 0.5  # K = 2N for embeddings (first "layer")
    group: Optional[int] = 256  # per-group rho (None = paper whole-tensor)
    scale_mode: str = "paper"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only 'dense' is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    ffn_activation: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: Optional[float] = 10000.0
    tie_embeddings: bool = True
    attn_bias: bool = False
    learned_positions: bool = False
    max_position: int = 0
    # --- MoE (not ported: None only) ---
    moe: Optional[Any] = None
    moe_period: int = 1
    first_dense: int = 0
    d_ff_dense: int = 0
    # --- MLA (not ported: None only) ---
    mla: Optional[Any] = None
    # --- hybrid / ssm (not ported: None only) ---
    hybrid_period: int = 0
    ssm: Optional[Any] = None
    rwkv: Optional[Any] = None
    # --- enc-dec / vlm (not ported) ---
    encoder_layers: int = 0
    prefix_len: int = 0
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- capability flags ---
    supports_decode: bool = True
    subquadratic: bool = False
    unroll_layers: bool = False
    # --- PVQ ---
    pvq: PVQConfig = dataclasses.field(default_factory=PVQConfig)
    # --- loss ---
    moe_aux_coef: float = 0.01
    z_loss_coef: float = 0.0

    def __post_init__(self) -> None:
        for field in ("moe", "mla", "ssm", "rwkv"):
            if getattr(self, field) is not None:
                raise NotImplementedError(
                    f"{self.name}: {field} configs are not ported yet"
                )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (same values as the
        reference's ``reduced()`` for the dense family)."""
        n_heads = min(self.n_heads, 4)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, self.hybrid_period or 2),
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, n_heads)),
            head_dim=16,
            d_ff=96,
            d_ff_dense=96 if self.d_ff_dense else 0,
            vocab_size=128,
            encoder_layers=2 if self.encoder_layers else 0,
            prefix_len=4 if self.prefix_len else 0,
            first_dense=min(self.first_dense, 1),
            param_dtype="float32",
            compute_dtype="float32",
            max_position=256,
        )
