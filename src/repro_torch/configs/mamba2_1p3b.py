"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD, ssm_state=128."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=50280,
    head_dim=64, mlp_type="swiglu",
    ssm=SSMConfig(state_dim=128, expand=2, head_dim=64, num_groups=1,
                  conv_dim=4, chunk_size=256))
