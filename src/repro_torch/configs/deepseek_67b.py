"""DeepSeek-67B [arXiv:2401.02954; hf]: llama-arch, 95L, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense", num_layers=95, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=22016, vocab_size=102400,
    head_dim=128, mlp_type="swiglu")
