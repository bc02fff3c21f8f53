"""Plain PyTorch versions of the LUT GEMM kernels.

:func:`lut_gemm_ref` is JAX's ``repro.kernels.lut_gemm.ref.lut_gemm_ref``:
the full 16-entry codebook read per code, the scale folded into the weight
before the matmul.  The two D&C versions follow the Pallas kernels'
operation order (``repro/kernels/lut_gemm/lut_gemm.py``): the zero point is
subtracted before the matmul and the scale applied to the f32 product
after it.  (The JAX oracle
``repro.kernels.lut_gemm.ref.lut_gemm_dc_ref`` folds the scale in BEFORE
the matmul instead; the port's CPU engine path, ``ops.quantized_matmul``,
keeps that order for token parity with the JAX engine.)
"""
from __future__ import annotations

import torch


def lut_gemm_ref(x: torch.Tensor, w_codes: torch.Tensor,
                 codebook: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (CB[q] * scale)`` -> (M, N) f32 (full-table, paper Fig 1)."""
    w = codebook[w_codes.long()] * scale[None, :]
    return x.float() @ w


def dc_dequant(w_codes: torch.Tensor, hi_tab: torch.Tensor,
               lo_tab: torch.Tensor, zero_point: torch.Tensor,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' in-register dequant, ``HI[q>>2] + LO[q&3] (+ RES[q])
    - zp``, as a (K, N) f32 tensor."""
    q = w_codes.long()
    w_q = hi_tab[q >> 2] + lo_tab[q & 3]
    if residual is not None:
        w_q = w_q + residual[q]
    return w_q - zero_point[None, :]


def lut_gemm_dc_ref(x: torch.Tensor, w_codes: torch.Tensor,
                    hi_tab: torch.Tensor, lo_tab: torch.Tensor,
                    zero_point: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    """``(x @ (HI[q>>2] + LO[q&3] - zp)) * scale`` -> (M, N) f32."""
    w = dc_dequant(w_codes, hi_tab, lo_tab, zero_point)
    return (x.float() @ w) * scale[None, :]


def lut_gemm_dc_res_ref(x: torch.Tensor, w_codes: torch.Tensor,
                        hi_tab: torch.Tensor, lo_tab: torch.Tensor,
                        residual: torch.Tensor, zero_point: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """``(x @ (HI[q>>2] + LO[q&3] + RES[q] - zp)) * scale`` -> (M, N) f32
    (non-affine NF4; ``residual`` is zero at pruned codes)."""
    w = dc_dequant(w_codes, hi_tab, lo_tab, zero_point, residual)
    return (x.float() @ w) * scale[None, :]
