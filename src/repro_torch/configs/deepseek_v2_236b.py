"""DeepSeek-V2-236B [arXiv:2405.04434; hf]: MLA kv_lora=512 + q_lora=1536,
160 routed + 2 shared experts, top-6."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    num_heads=128, num_kv_heads=128, d_ff=1536, vocab_size=102400,
    head_dim=128, mlp_type="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(num_experts=160, num_shared=2, top_k=6, d_expert=1536,
                  first_dense=1, dense_ff=12288))
