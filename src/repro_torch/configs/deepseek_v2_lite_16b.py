"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf]: MLA kv_lora=512,
64 routed + 2 shared experts, top-6 (the HF config; 160 routed experts
is the 236B config)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", num_layers=27, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=102400,
    head_dim=128, mlp_type="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, d_expert=1408,
                  first_dense=1, dense_ff=10944))
