"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
anyres tiling STUBBED (input_specs provides precomputed patch embeddings)."""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    head_dim=128, mlp_type="swiglu", rope_theta=1000000.0,
    vlm=VLMConfig(num_patches=576))
