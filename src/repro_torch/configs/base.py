"""Config dataclasses for the port's model zoo (mirrors
``repro.configs.base``).

The dense, moe, SSM and hybrid families are ported, so
:class:`ModelConfig` carries the fields the dense GQA, DeepSeek MoE/MLA,
mamba2 and zamba2 paths read; the encdec/VLM sub-configs arrive with
their families (ROADMAP queue 1 item 7, trained under item 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.layers import QuantConfig


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    num_shared: int = 0
    top_k: int = 2
    d_expert: int = 0           # expert FFN hidden size
    capacity_factor: float = 1.25
    first_dense: int = 1        # leading dense layers (deepseek-v2 style)
    dense_ff: int = 0           # FFN width of the dense layers
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0        # 0 = no q compression
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    expand: int = 2
    head_dim: int = 64
    num_groups: int = 1
    conv_dim: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: one weight-shared attention+MLP block applied every
    ``period`` SSM layers."""
    period: int = 6
    shared_num_heads: int = 32
    shared_num_kv_heads: int = 32
    shared_d_ff: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # "dense" | "moe" | "ssm" | "hybrid"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    mlp_type: str = "swiglu"     # swiglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    quant: QuantConfig = field(default_factory=QuantConfig)  # model-level
    attn_impl: str = "chunked"   # full | chunked | flash (forward-only)
    attn_chunk: int = 512
    remat: bool = True           # recompute each block in the backward
    # "nothing" (full recompute, min memory); "dots" (save matmul outputs)
    # is ROADMAP queue 1 item 8
    remat_policy: str = "nothing"
    # attention operand precision: True casts K/V/P to f32; False keeps
    # the operands in the model dtype with f32 scores and rounds P to the
    # operand dtype before P@V (flash-attention numerics)
    attn_f32: bool = True
    # fused scale+mask where() instead of mul + broadcast-bias add
    attn_fused_mask: bool = False
    # causal chunks attend only to keys <= the chunk's end
    attn_causal_skip: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (the JAX
        ``ModelConfig.reduced`` widths)."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
        )
        if self.moe:
            small["moe"] = replace(self.moe, num_experts=8, top_k=2,
                                   d_expert=64, dense_ff=256)
        if self.mla:
            small["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                     qk_nope_dim=16, qk_rope_dim=16, v_dim=16)
        if self.ssm:
            small["ssm"] = replace(self.ssm, state_dim=16, head_dim=16,
                                   chunk_size=32)
        if self.hybrid:
            small["hybrid"] = replace(self.hybrid, period=2,
                                      shared_num_heads=4,
                                      shared_num_kv_heads=2, shared_d_ff=256)
            small["num_layers"] = 4
        small.update(overrides)
        return replace(self, **small)
