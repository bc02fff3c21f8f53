"""Code-space LUNA GEMM: the model-level ``luna_*`` quant modes."""
