"""Public wrappers over the LUT GEMM kernels (mirrors
``repro.kernels.lut_gemm.ops``).

* :func:`nf4_matmul_kernel` — NF4 codebook weights through the full-table
  :func:`~repro_torch.kernels.lut_gemm.lut_gemm.lut_gemm` (paper Fig 1);
  the model-level ``lut_nf4`` mode on the card.
* :func:`lut4_matmul_kernel` / :func:`nf4dc_matmul_kernel` — uniform-int4
  or NF4 weights frozen by ``quantize_weight`` through the D&C kernels.
* :func:`quantized_matmul` — the engine's decode-step matmul over a frozen
  :class:`~repro_torch.core.quant.QuantizedWeight`.

JAX pads every operand to its Pallas block sizes; the Hopper kernels mask
ragged edges themselves, so nothing is padded here.  Each wrapper runs its
kernel on CUDA tensors and the kernel's plain version on CPU tensors.

``quantized_matmul`` dispatches on the container's ``kernel`` tag:

* ``"lut_dc"`` — on CUDA the hand-written :func:`lut_gemm_dc` kernel;
  ``"nf4_dc"`` — on CUDA :func:`lut_gemm_dc_res` (scale applied after the
  matmul, the Pallas kernels' order).  On the CPU both mirror JAX's jnp
  evaluation exactly — D&C dequant through the mux tree, the scale folded
  into the weight BEFORE the matmul — so the CPU port emits the JAX
  engine's tokens.
* ``"dequant"`` (int4) and ``"nf4_dequant"`` (the direct NF4 oracle) are
  plain dequantize-then-matmul on every device, as in JAX: separate
  evaluation modes, not fallbacks.

Output dtype follows ``x``.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import NF4_CODEBOOK, codebook_dequant
from repro_torch.core.quant import (QuantizedWeight, dequantize, nf4_encode,
                                    quantize_weight)
from repro_torch.kernels.lut_gemm.lut_gemm import (lut_gemm, lut_gemm_dc,
                                                   lut_gemm_dc_res)


def codebook_quantize(w: torch.Tensor, codebook
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel absmax normalise + nearest-codebook-entry encode
    -> (codes (K, N) int8, scale (N,) f32).  The normalisation runs in
    ``w``'s dtype, as in JAX."""
    scale = torch.clamp_min(torch.amax(torch.abs(w), dim=0), 1e-8)
    codes = nf4_encode(w / scale, codebook)
    return codes, scale.float()


def nf4_matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(x @ NF4[codes]) * absmax`` -> (M, N) f32 through the full-table
    LUT GEMM.  x: (M, K) f32/bf16; w: (K, N) float."""
    codes, scale = codebook_quantize(w, NF4_CODEBOOK)
    return lut_gemm(x, codes, torch.as_tensor(NF4_CODEBOOK, device=w.device),
                    scale)


def lut4_matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Uniform-int4 weights (``quantize_weight``'s ``lut_dc`` calibration,
    the one the engine freezes) through the D&C sub-table kernel."""
    qw = quantize_weight(w, kernel="lut_dc")
    return lut_gemm_dc(x, qw.codes, qw.hi_tab, qw.lo_tab, qw.zero_point,
                       qw.scale)


def nf4dc_matmul_kernel(x: torch.Tensor, w: torch.Tensor,
                        prune_threshold: float | None = None
                        ) -> torch.Tensor:
    """NF4 weights (``quantize_weight``'s ``nf4_dc``; a ``prune_threshold``
    reproduces ``quant="nf4p"``) through the residual-corrected D&C
    kernel."""
    qw = quantize_weight(w, kernel="nf4_dc", prune_threshold=prune_threshold)
    return lut_gemm_dc_res(x, qw.codes, qw.hi_tab, qw.lo_tab, qw.residual,
                           qw.zero_point, qw.scale)


def _cpu_weight(qw: QuantizedWeight) -> torch.Tensor:
    """JAX's jnp dequant (``ops.py:60-73``), operation for operation."""
    q = qw.codes.to(torch.int32)
    if qw.kernel == "lut_dc":
        w_q = (codebook_dequant(q >> 2, qw.hi_tab)
               + codebook_dequant(q & 3, qw.lo_tab))
    else:                                   # "nf4_dc"
        w_q = (codebook_dequant(q >> 2, qw.hi_tab)
               + codebook_dequant(q & 3, qw.lo_tab)
               + codebook_dequant(q, qw.residual))
    return (w_q - qw.zero_point[None, :]) * qw.scale[None, :]


def quantized_matmul(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """``x @ dequant(qw)``; ``x``: (..., K), ``qw.codes``: (K, N)."""
    assert qw.codes.ndim == 2, (
        f"quantized_matmul expects a per-layer 2-D weight, got "
        f"{tuple(qw.codes.shape)}")
    if qw.kernel in ("lut_dc", "nf4_dc"):
        if x.device.type == "cuda":
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            if qw.kernel == "lut_dc":
                out = lut_gemm_dc(x2, qw.codes, qw.hi_tab, qw.lo_tab,
                                  qw.zero_point, qw.scale)
            else:
                out = lut_gemm_dc_res(x2, qw.codes, qw.hi_tab, qw.lo_tab,
                                      qw.residual, qw.zero_point, qw.scale)
            return out.reshape(*x.shape[:-1], -1).to(x.dtype)
        w = _cpu_weight(qw)
    elif qw.kernel == "nf4_dequant":        # full-table oracle (15 selects)
        cb = torch.as_tensor(NF4_CODEBOOK, device=qw.codes.device)
        w = codebook_dequant(qw.codes.to(torch.int32), cb) * qw.scale[None, :]
    else:                                   # "dequant": conventional math
        w = dequantize(qw.codes.to(torch.int32), qw.qparams)
    return (x.float() @ w).to(x.dtype)
