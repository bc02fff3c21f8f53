"""Zamba2-1.2B [arXiv:2411.15242; hf]: Mamba2 backbone + shared attention
block every 6 layers, ssm_state=64."""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32000,
    head_dim=64, mlp_type="swiglu",
    ssm=SSMConfig(state_dim=64, expand=2, head_dim=64, num_groups=1,
                  conv_dim=4, chunk_size=256),
    hybrid=HybridConfig(period=6, shared_num_heads=32,
                        shared_num_kv_heads=32, shared_d_ff=8192))
