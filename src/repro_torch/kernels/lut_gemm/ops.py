"""Public wrappers over the LUT GEMM kernels (mirrors
``repro.kernels.lut_gemm.ops``).

* :func:`nf4_matmul_kernel` — NF4 codebook weights through the full-table
  :func:`~repro_torch.kernels.lut_gemm.lut_gemm.lut_gemm` (paper Fig 1);
  the model-level ``lut_nf4`` mode on the card.  Under autograd it runs
  :class:`NF4MatmulFn`, whose backward is a second ``lut_gemm`` over the
  transposed codes.
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
from repro_torch.device import takes_kernels
from repro_torch.kernels.lut_gemm.lut_gemm import (lut_gemm, lut_gemm_dc,
                                                   lut_gemm_dc_res)


def codebook_quantize(w: torch.Tensor, codebook, split: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel absmax normalise + nearest-codebook-entry encode
    -> (codes (K, N) int8, scale (N,) f32).  The normalisation runs in
    ``w``'s dtype, as in JAX.  ``split``: ``w`` is this rank's block of
    rows in a row-parallel split, and the absmax the whole K's
    (``core.layers.nf4_absmax``), so the codes are the matching block of
    the whole weight's."""
    from repro_torch.core.layers import nf4_absmax
    scale = nf4_absmax(w, split)
    codes = nf4_encode(w / scale, codebook)
    return codes, scale.float()


def nf4_matmul_kernel(x: torch.Tensor, w: torch.Tensor,
                      split: bool = False) -> torch.Tensor:
    """``(x @ NF4[codes]) * absmax`` -> (M, N) f32 through the full-table
    LUT GEMM.  x: (M, K) f32/bf16; w: (K, N) float (``split``: this
    rank's rows of a row-parallel split; the result is its partial sum).
    Where x or w needs a gradient the call goes through
    :class:`NF4MatmulFn` (the same forward result, bitwise)."""
    codes, scale = codebook_quantize(w, NF4_CODEBOOK, split)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return NF4MatmulFn.apply(x, codes, scale)
    return lut_gemm(x, codes, torch.as_tensor(NF4_CODEBOOK, device=w.device),
                    scale)


class NF4MatmulFn(torch.autograd.Function):
    """``out = (x @ CB[q]) * absmax`` with the gradients ``jax.grad`` takes
    of JAX's ``_nf4_matmul`` (the codes carry none).  x: (M, K) f32/bf16;
    codes: (K, N) int8; absmax: (N,) f32.

    * forward: y0 = ``lut_gemm(x, q, CB, 1)``, out = y0 * absmax.  Every
      kernel applies the scale as one f32 multiply after its sum, so this
      is the one-launch forward's result bitwise; y0 is kept;
    * dx = g · ŵᵀ with ŵ[k, n] = CB[q[k, n]] · absmax[n]: ``lut_gemm(g ⊙
      absmax, qᵀ, CB, 1)``, the same kernel over the transposed codes (in
      x's dtype: a bf16 step's M = B·S rows run ``lut_gemm_wgmma.cu``);
    * d absmax[n] = Σ_m g[m, n] · y0[m, n] (JAX's Σ_k CB[q[k, n]] ·
      (xᵀg)[k, n], with no K × N product).  The chain on to w (through
      ``clamp_min(amax(|w|, 0), 1e-8)``) is torch's autograd.

    On CPU tensors ``lut_gemm`` is its plain version (``lut_gemm_ref``),
    used by the tests; the CPU model path is JAX's library order instead
    (``core.layers._nf4_matmul``).  :attr:`backward_launches` counts the
    backward's ``lut_gemm`` calls on the card."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, x, codes, absmax):
        cb = torch.as_tensor(NF4_CODEBOOK, device=x.device)
        y0 = lut_gemm(x, codes, cb, torch.ones_like(absmax))
        ctx.save_for_backward(codes, absmax, y0)
        ctx.x_dtype = x.dtype
        return y0 * absmax

    @staticmethod
    def backward(ctx, g):
        codes, absmax, y0 = ctx.saved_tensors
        g = g.float()
        gx = gabs = None
        if ctx.needs_input_grad[0]:
            cb = torch.as_tensor(NF4_CODEBOOK, device=g.device)
            gs = (g * absmax).to(ctx.x_dtype).contiguous()
            gx = lut_gemm(gs, codes.t().contiguous(), cb,
                          torch.ones(codes.shape[0], device=g.device))
            gx = gx.to(ctx.x_dtype)
            NF4MatmulFn.backward_launches += g.device.type == "cuda"
        if ctx.needs_input_grad[2]:
            gabs = (g * y0).sum(0)
        return gx, None, gabs


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
        if takes_kernels(x):
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
