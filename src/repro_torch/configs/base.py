"""Model configuration schema (PyTorch port of ``repro.configs.base``).

The reference module imports the MLA/MoE/SSM/RWKV config types from its
JAX layer modules; the port keeps its own copies (``repro_torch.nn.mla``,
``.moe``, ``.mamba``, ``.rwkv``), so ``dataclasses.asdict`` matches the
reference field for field.  Every family of the reference is ported: dense,
MoE, VLM (``prefix_len``), enc-dec (``encoder_layers``,
``learned_positions``, ``max_position``), hybrid (``hybrid_period``,
``ssm``) and ssm (``rwkv``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..nn.mamba import SSMConfig
from ..nn.mla import MLAConfig
from ..nn.moe import MoEConfig
from ..nn.rwkv import RWKVConfig


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
    family: str  # 'dense' | 'moe' | 'hybrid' | 'ssm' | 'encdec' | 'vlm'
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
    max_position: int = 0  # for learned positions; 0 -> max_seq at init time
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_period: int = 1  # MoE FFN every `moe_period` layers (others dense)
    first_dense: int = 0  # first k layers always dense FFN (DeepSeek)
    d_ff_dense: int = 0  # hidden dim of those dense FFNs (0 -> d_ff)
    # --- MLA ---
    mla: Optional[MLAConfig] = None
    # --- hybrid / ssm ---
    hybrid_period: int = 0  # jamba: super-block length (attn at p // 2, mamba else)
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    # --- vlm ---
    prefix_len: int = 0  # patch tokens prepended (stub embeddings)
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

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (the reference's
        ``reduced()`` values)."""
        small_moe = None
        if self.moe is not None:
            small_moe = self.moe._replace(
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=32,
                group_size=64,
                n_shared=min(self.moe.n_shared, 1),
            )
        small_mla = None
        if self.mla is not None:
            small_mla = MLAConfig(
                kv_lora_rank=16,
                q_lora_rank=(16 if self.mla.q_lora_rank else None),
                nope_head_dim=8,
                rope_head_dim=4,
                v_head_dim=8,
            )
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
            moe=small_moe,
            mla=small_mla,
            ssm=SSMConfig(d_state=4, d_conv=4, expand=2) if self.ssm else None,
            rwkv=RWKVConfig(head_size=16, decay_lora=8, mix_lora=4) if self.rwkv else None,
            encoder_layers=2 if self.encoder_layers else 0,
            prefix_len=4 if self.prefix_len else 0,
            first_dense=min(self.first_dense, 1),
            param_dtype="float32",
            compute_dtype="float32",
            max_position=256,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if not."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §4)"
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    return True, ""
