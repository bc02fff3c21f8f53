"""The paper's own evaluation network (Section IV.A, Fig 13): a small MLP
whose matmuls run under each LUNA multiplier mode (mirrors
``repro.configs.luna_mlp``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="luna-mlp", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    head_dim=16, mlp_type="gelu")
