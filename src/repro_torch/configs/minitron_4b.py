"""Minitron-4B [arXiv:2407.14679; hf]: pruned Nemotron, GQA kv=8, 256k vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense", num_layers=32, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=9216, vocab_size=256000,
    head_dim=128, mlp_type="gelu")  # nemotron uses squared-relu; gelu proxy
