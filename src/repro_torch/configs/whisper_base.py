"""Whisper-base [arXiv:2212.04356]: enc-dec; conv frontend STUBBED
(input_specs provides precomputed frame embeddings)."""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec", num_layers=6, d_model=512,
    num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
    head_dim=64, mlp_type="gelu",
    encdec=EncDecConfig(enc_layers=6, enc_seq=1500))
