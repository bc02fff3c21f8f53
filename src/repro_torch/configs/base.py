"""Config dataclasses for the port's model zoo (mirrors
``repro.configs.base``).

Every family of the JAX registry is ported (dense, moe, ssm, hybrid,
encdec, vlm), so :class:`ModelConfig` carries the fields the dense GQA,
DeepSeek MoE/MLA, mamba2, zamba2, whisper and llava paths read, and
:class:`ShapeConfig` the assigned input-shape cells that
``models.registry.input_specs`` sizes their inputs from.
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
class EncDecConfig:
    enc_layers: int = 6
    enc_seq: int = 1500          # whisper: 30 s of audio @ 2x conv stride


@dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 576       # llava-next base grid (anyres tiles stubbed)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | encdec | hybrid | ssm | vlm
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
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    quant: QuantConfig = field(default_factory=QuantConfig)  # model-level
    attn_impl: str = "chunked"   # full | chunked | flash (forward-only)
    attn_chunk: int = 512
    remat: bool = True           # recompute each block in the backward
    # decode attention: "dense" = plain cache update + SDPA (baseline);
    # "sharded" = flash-decode over the mesh's model group
    # (serve.decode_attention; taken under an active activation_sharding
    # context whose model axis owns the cache's shard)
    decode_attn: str = "dense"
    # "nothing" (full recompute, min memory); "dots" (save the outputs of
    # the matmuls with no batch dims, JAX's dots_with_no_batch_dims_saveable)
    remat_policy: str = "nothing"
    # serving param sharding (read by the dry run, launch.dryrun): "fsdp"
    # (as training: weights sharded over data + model, gathered at use) |
    # "tp" (replicated over data, sharded over model only:
    # parallel.sharding.param_specs(serve_tp=True))
    serve_param_sharding: str = "fsdp"
    # attention operand precision: True casts K/V/P to f32; False keeps
    # the operands in the model dtype with f32 scores and rounds P to the
    # operand dtype before P@V (flash-attention numerics)
    attn_f32: bool = True
    # sharded flash-decode operand handling: "f32" (baseline) repeats KV to
    # full H in f32; "bf16_grouped" keeps the cache-dtype operands and
    # GQA-grouped products with f32 accumulation (no repeat)
    decode_attn_precision: str = "f32"
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
        if self.encdec:
            small["encdec"] = replace(self.encdec, enc_layers=2, enc_seq=64)
        if self.vlm:
            small["vlm"] = VLMConfig(num_patches=16)
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
