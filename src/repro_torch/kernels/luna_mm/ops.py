"""Public wrappers around the LUNA GEMM kernel (mirrors
``repro.kernels.luna_mm.ops``): the code-space GEMM and the float-in /
float-out quantize -> integer kernel -> zero-point-correct -> rescale
pipeline.

JAX pads the codes to its Pallas block sizes; the Hopper kernel masks
ragged edges itself (zero padding is exact in every mode anyway: a zero
code adds zero to each digit plane and to ``colsum(W)``).  CUDA tensors
launch the kernel, CPU tensors take ``luna_mm_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import calibrate, luna_epilogue, quantize
from repro_torch.kernels.luna_mm.luna_mm import luna_mm


def luna_mm_codes(y_codes: torch.Tensor, w_codes: torch.Tensor, *,
                  mode: str = "opt_dc") -> torch.Tensor:
    """Code-space LUNA GEMM: (M, K) x (K, N) codes in [0, 16) -> (M, N)
    int32."""
    return luna_mm(y_codes.to(torch.int8).contiguous(),
                   w_codes.to(torch.int8).contiguous(), mode)


def luna_matmul_f32_kernel(x: torch.Tensor, w: torch.Tensor, *,
                           mode: str = "opt_dc", bits: int = 4,
                           x_across=(), w_across=()) -> torch.Tensor:
    """Float GEMM through the integer kernel (dynamic PTQ, zero-point
    algebra): ``repro_torch.core.quant.luna_matmul_f32`` (its
    ``x_across``/``w_across`` too) with the contraction in
    :func:`luna_mm_codes`.  x: (..., K), w: (K, N)."""
    if bits != 4:
        raise NotImplementedError(
            f"the LUNA GEMM kernel implements the paper's 4-bit datapath, "
            f"not bits={bits}: ROADMAP queue 2 kernel 6 (other widths)")
    x_qp = calibrate(x, bits, axis=None, across=x_across)
    w_qp = calibrate(w, bits, axis=-1, across=w_across)
    qx = quantize(x, x_qp)
    qw = quantize(w, w_qp)
    k = x.shape[-1]
    acc = luna_mm_codes(qx.reshape(-1, k), qw, mode=mode)
    acc = acc.reshape(*x.shape[:-1], w.shape[-1])
    return luna_epilogue(acc, qx, qw, x_qp, w_qp)
