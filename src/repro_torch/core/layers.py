"""``quant_matmul``: the one matmul every projection routes through
(mirrors ``repro.core.layers``), so one ``--quant`` flag turns the model
into a LUNA-quantized one.  Modes:

  bf16              — no quantization
  int8              — symmetric int8 dynamic quantization
  int4_dequant      — weight-only uniform int4, dequant then matmul (the
                      "conventional math" baseline the paper argues against)
  luna_conventional — full-LUT LUNA (exact; paper Fig 1)
  luna_dc           — exact D&C LUNA (paper Figs 2/3; optimized table)
  luna_approx       — ApproxD&C, Z_LSB := 0 (paper Fig 9)
  luna_approx2      — ApproxD&C2, Z_LSB := W (paper Fig 10)
  lut_nf4           — NF4 codebook weights through the programmable LUT

Every mode quantizes dynamically on each call.  A frozen
:class:`QuantizedWeight` (the engine's ``EngineConfig(quant=...)`` decode
tree) goes to the LUT GEMM its ``kernel`` tag selects whatever the config.

Device routing (the port's rule, in place of JAX's ``use_pallas`` switch,
which the port drops): on CUDA tensors the ``luna_*`` modes run the
hand-written LUNA GEMM (``kernels.luna_mm``) and ``lut_nf4`` the full-table
LUT GEMM (``kernels.lut_gemm``, scale applied after the product as in the
Pallas kernel); on CPU tensors every mode is JAX's library path, operation
for operation, so the CPU port emits the JAX engine's tokens.

Training: the ``luna_*`` modes run through ``ste_luna_matmul`` (JAX's
route when ``use_pallas`` is off), whose forward is the same kernel or
library path and whose backward is the plain product's.  ``int8``,
``int4_dequant`` and ``lut_nf4`` take ``jax.grad``'s gradients of JAX's
functions: the rounded codes carry none, the scales do (so ``int8``'s
reach x and w only at their max-|·| elements, and ``int4_dequant``'s and
``lut_nf4``'s w only through its per-channel min/max or absmax; x gets
g·ŵᵀ).  On the CPU that is torch's autograd of the library path; on the
card ``int8`` differentiates through the scales around its integer
product and ``lut_nf4`` runs ``kernels.lut_gemm.ops.NF4MatmulFn``, whose
backward is the LUT GEMM kernel again, over the transposed codes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import lut
from repro_torch.core.luna import LunaMode
from repro_torch.core.quant import (QuantizedWeight, calibrate, dequantize,
                                    nf4_encode, quantize, ste_luna_matmul)
from repro_torch.device import takes_kernels
from repro_torch.parallel.act_sharding import rows_axes

LUNA_MODE_OF = {
    "luna_conventional": LunaMode.CONVENTIONAL,
    "luna_dc": LunaMode.OPT_DC,
    "luna_approx": LunaMode.APPROX_DC,
    "luna_approx2": LunaMode.APPROX_DC2,
}

QUANT_MODES = ("bf16", "int8", "int4_dequant", "lut_nf4", *LUNA_MODE_OF)


@dataclass(frozen=True)
class QuantConfig:
    """Model-level quantization.  ``targets``: the projection groups to
    quantize (router/embeddings/LM head stay full precision).  JAX's
    ``use_pallas`` is dropped: the port selects the kernel by device."""
    mode: str = "bf16"
    bits: int = 4
    targets: tuple = ("attn", "mlp", "moe")

    def __post_init__(self):
        if self.mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}; one of {QUANT_MODES}")

    def applies(self, group: str) -> bool:
        return self.mode != "bf16" and group in self.targets


def _int_mm_exact(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> exact int32.

    CUDA's ``torch.matmul`` has no integer path and f32 is not exact past
    2**24, so on the card ``torch._int_mm`` (cuBLAS int8 GEMM with int32
    accumulation) runs where its shape rules hold (M > 16, K and N
    multiples of 8) and a float64 product (every partial sum an integer
    below 2**53, so exact) elsewhere.  On the CPU an int32 matmul.
    """
    m, k = qx.shape
    n = qw.shape[1]
    if not takes_kernels(qx):
        return qx.to(torch.int32) @ qw.to(torch.int32)
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(qx.contiguous(), qw.contiguous())
    return (qx.double() @ qw.double()).to(torch.int32)


def _k_axes(split: bool) -> tuple[str, ...]:
    """The mesh axes a row-parallel split cuts K over."""
    return ("model",) if split else ()


def _int8_matmul(x: torch.Tensor, w: torch.Tensor, split: bool = False
                 ) -> torch.Tensor:
    # x's per-tensor scale spans the step's whole batch (JAX's jnp.min/max
    # of the global x) and, split, the whole K
    xq = calibrate(x, 8, axis=None, symmetric=True,
                   across=rows_axes() + _k_axes(split))
    wq = calibrate(w, 8, axis=-1, symmetric=True, across=_k_axes(split))
    qx = (quantize(x, xq) - xq.zero_point).to(torch.int8)
    qw = (quantize(w, wq) - wq.zero_point).to(torch.int8)
    acc = _int_mm_exact(qx.reshape(-1, x.shape[-1]), qw)
    acc = acc.reshape(*x.shape[:-1], w.shape[-1])
    return acc.float() * (xq.scale * wq.scale)


def _int4_dequant_matmul(x: torch.Tensor, w: torch.Tensor,
                         split: bool = False) -> torch.Tensor:
    wq = calibrate(w, 4, axis=-1, across=_k_axes(split))
    w_hat = dequantize(quantize(w, wq), wq).to(x.dtype)
    return x @ w_hat


def nf4_absmax(w: torch.Tensor, split: bool = False) -> torch.Tensor:
    """NF4's per-column scale: ``max(|w|)`` over K, at least 1e-8;
    ``split``: over the whole K a row-parallel split cuts."""
    amax = torch.amax(torch.abs(w), dim=0)
    if split:
        from repro_torch.parallel.tensor_parallel import mesh_amax
        amax = mesh_amax(amax, ("model",))
    return torch.clamp_min(amax, 1e-8)


def _nf4_matmul(x: torch.Tensor, w: torch.Tensor, split: bool = False
                ) -> torch.Tensor:
    """Weight-only NF4 through the mux tree (JAX's library order: the
    absmax scale folded into the weight before the matmul)."""
    absmax = nf4_absmax(w, split)
    codes = nf4_encode(w / absmax).to(torch.int32)
    cb = torch.as_tensor(lut.NF4_CODEBOOK, device=w.device)
    w_hat = lut.codebook_dequant(codes, cb) * absmax
    return x @ w_hat.to(x.dtype)


def quant_matmul(x: torch.Tensor, w, cfg: QuantConfig | None = None,
                 group: str = "mlp", split_k: bool = False) -> torch.Tensor:
    """``x @ w`` under the configured quantization mode.

    ``x``: (..., K); ``w``: (K, N) or a frozen :class:`QuantizedWeight`.
    Output dtype follows ``x``.  ``split_k``: ``x`` and ``w`` are this
    rank's blocks of K in a row-parallel split over the mesh's model axis
    (the result is a partial sum): ``int8``, ``int4_dequant`` and
    ``lut_nf4`` calibrate over the whole K (``calibrate(across=)``,
    :func:`nf4_absmax`); the ``luna_*`` modes are never split
    (``parallel.tensor_parallel.splits_quant``).  ``int8``'s activation
    scale also spans the step's rows (``act_sharding.rows_axes``).
    """
    if isinstance(w, QuantizedWeight):
        from repro_torch.kernels.lut_gemm import ops as lut_ops
        return lut_ops.quantized_matmul(x, w)
    if cfg is None or not cfg.applies(group):
        return x @ w
    if cfg.mode in LUNA_MODE_OF:
        # without autograd this is the plain forward: the kernel on CUDA
        # tensors, the library path on CPU ones
        return ste_luna_matmul(x.float(), w.float(),
                               LUNA_MODE_OF[cfg.mode].value, cfg.bits,
                               rows_axes() + _k_axes(split_k),
                               _k_axes(split_k)).to(x.dtype)
    if cfg.mode == "int8":
        return _int8_matmul(x, w, split_k).to(x.dtype)
    if cfg.mode == "int4_dequant":
        return _int4_dequant_matmul(x, w, split_k)
    if takes_kernels(x):                             # lut_nf4
        from repro_torch.kernels.lut_gemm import ops as lut_ops
        out = lut_ops.nf4_matmul_kernel(
            x.reshape(-1, x.shape[-1]).contiguous(), w, split=split_k)
        return out.reshape(*x.shape[:-1], -1).to(x.dtype)
    return _nf4_matmul(x, w, split_k)
