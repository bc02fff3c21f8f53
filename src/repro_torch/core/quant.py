"""Affine quantizers, the real-valued LUNA matmul, its straight-through
estimator for training and the frozen 4-bit decode weights (mirrors
``repro.core.quant``).

Real tensors map to unsigned codes with asymmetric affine quantization,
``x ~= s * (q - z)``, ``q in [0, 2**bits)``, and the integer-GEMM identity
recovers the real product from the code-space LUNA accumulation::

    x @ w ~= s_x s_w [ L(q_x, q_w) - z_x colsum(q_w) - rowsum(q_x) z_w
                       + K z_x z_w ]

(:func:`luna_matmul_f32`).  :class:`QuantizedWeight`
freezes a projection into 4-bit codes plus per-channel params at engine
construction; :func:`quantize_decode_params` walks a parameter tree and
replaces every decode-projection leaf.  The D&C sub-tables stored beside
the codes are the paper's Fig 2/3 split of the 16-entry code LUT: a code
``q = 4*q_hi + q_lo`` reads ``HI[q_hi] + LO[q_lo]`` (6 selects, not 15).

Bitwise parity with the JAX package: ``torch.round`` and ``jnp.round``
both round half to even, and the NF4 encoder keeps the FIRST nearest
codebook entry, as ``jnp.argmin`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple

import torch

from repro_torch.core.luna import LunaMode, luna_matmul
from repro_torch.device import takes_kernels


class QParams(NamedTuple):
    scale: torch.Tensor       # per-tensor () or per-channel (N,)
    zero_point: torch.Tensor  # same shape as scale, unsigned-code zero point
    bits: int


def calibrate(x: torch.Tensor, bits: int = 4, axis: int | None = None,
              symmetric: bool = False, across: tuple[str, ...] = ()
              ) -> QParams:
    """Min/max affine calibration to unsigned codes.

    ``axis``: the kept (per-channel) axis; None = per-tensor.
    ``across``: mesh axes whose ranks hold the other blocks of the
    dimensions the reduction runs over (a row-parallel projection's K over
    ``model``, a step's rows over the batch axes), so the minima and
    maxima are the whole dimensions' (``parallel.tensor_parallel.
    mesh_amin`` / ``mesh_amax``).
    """
    qmax = (1 << bits) - 1
    if axis is None:
        lo, hi = torch.min(x), torch.max(x)
    else:
        red = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        lo, hi = torch.amin(x, dim=red), torch.amax(x, dim=red)
    if across:
        from repro_torch.parallel.tensor_parallel import (mesh_amax,
                                                          mesh_amin)
        lo, hi = mesh_amin(lo, across), mesh_amax(hi, across)
    if symmetric:
        amax = torch.maximum(lo.abs(), hi.abs())
        lo, hi = -amax, amax
    # divide by a tensor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which can miss the correctly rounded quotient
    scale = torch.clamp_min(hi - lo, 1e-8) / torch.full_like(hi, qmax)
    zp = torch.clamp(torch.round(-lo / scale), 0, qmax)
    return QParams(scale.float(), zp.float(), bits)


def quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Real -> unsigned integer codes (int32 carrier)."""
    qmax = (1 << qp.bits) - 1
    codes = torch.round(x / qp.scale + qp.zero_point)
    return torch.clamp(codes, 0, qmax).to(torch.int32)


def dequantize(codes: torch.Tensor, qp: QParams) -> torch.Tensor:
    return (codes.float() - qp.zero_point) * qp.scale


def quant_error(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    return dequantize(quantize(x, qp), qp) - x


def luna_epilogue(acc: torch.Tensor, qx: torch.Tensor, qw: torch.Tensor,
                  x_qp: QParams, w_qp: QParams) -> torch.Tensor:
    """Zero-point correction and rescale of the int32 LUNA accumulator, in
    JAX's float order: ``acc - zx*colsum - rowsum*zw + k*zx*zw``, then
    ``(sx*sw) * corrected``."""
    k = qx.shape[-1]
    acc = acc.float()
    colsum_qw = torch.sum(qw, dim=0).float()                     # (N,)
    rowsum_qx = torch.sum(qx, dim=-1, keepdim=True).float()
    zx, zw = x_qp.zero_point, w_qp.zero_point
    corrected = (acc
                 - zx * colsum_qw
                 - rowsum_qx * zw
                 + k * zx * zw)
    return (x_qp.scale * w_qp.scale) * corrected


def luna_matmul_f32(x: torch.Tensor, w: torch.Tensor, mode: LunaMode | str,
                    bits: int = 4, x_qp: QParams | None = None,
                    w_qp: QParams | None = None, *,
                    x_across: tuple[str, ...] = (),
                    w_across: tuple[str, ...] = ()) -> torch.Tensor:
    """Float-in/float-out matmul with LUNA integer arithmetic inside.

    ``x``: (..., K); ``w``: (K, N).  Dynamic per-tensor activation quant,
    per-output-channel weight quant unless QParams are given (static PTQ).
    ``x_across`` / ``w_across``: the mesh axes whose ranks hold the other
    blocks of x's rows and K / of w's K (:func:`calibrate`'s
    ``across``), so each rank's codes are those of the whole tensors.
    The integer core is :func:`repro_torch.core.luna.luna_matmul`; the
    card's kernel route is ``kernels.luna_mm.ops.luna_matmul_f32_kernel``.
    """
    mode = LunaMode(mode)
    x_qp = x_qp or calibrate(x, bits, axis=None, across=x_across)
    w_qp = w_qp or calibrate(w, bits, axis=-1, across=w_across)
    qx = quantize(x, x_qp)
    qw = quantize(w, w_qp)
    acc = luna_matmul(qx, qw, bits=bits, mode=mode)
    return luna_epilogue(acc, qx, qw, x_qp, w_qp)


class _SteLunaMatmul(torch.autograd.Function):
    """Forward: the exact LUNA integer path; backward: the plain product's
    gradients (JAX's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, w, mode, bits, x_across, w_across):
        ctx.save_for_backward(x, w)
        kw = {"x_across": x_across, "w_across": w_across}
        if takes_kernels(x):
            from repro_torch.kernels.luna_mm import ops as luna_ops
            return luna_ops.luna_matmul_f32_kernel(
                x, w, mode=LunaMode(mode).value, bits=bits, **kw)
        return luna_matmul_f32(x, w, mode, bits, **kw)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.einsum("...n,kn->...k", g, w)
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx.to(x.dtype), gw.to(w.dtype), None, None, None, None


def ste_luna_matmul(x: torch.Tensor, w: torch.Tensor, mode: LunaMode | str,
                    bits: int = 4, x_across: tuple[str, ...] = (),
                    w_across: tuple[str, ...] = ()) -> torch.Tensor:
    """QAT matmul: the forward is :func:`luna_matmul_f32` (on CUDA tensors
    the ``luna_mm`` kernel's route; ``x_across``/``w_across`` as its),
    the backward pretends it was ``x @ w``: ``gx = g wᵀ``, ``gw = xᵀ g``.
    ``x``: (..., K) f32, ``w``: (K, N) f32."""
    return _SteLunaMatmul.apply(x, w, mode, bits, x_across, w_across)


#: evaluation strategies for a frozen 4-bit weight: "lut_dc" sums the two
#: 2-bit D&C sub-tables; "dequant" is direct affine dequant (the same
#: grid); "nf4_dc" evaluates the NF4 codebook as HI + LO + a per-code
#: residual; "nf4_dequant" is the direct 16-entry NF4 lookup (the oracle).
WEIGHT_KERNELS = ("lut_dc", "dequant", "nf4_dc", "nf4_dequant")

#: |residual| threshold for pruned sub-tables (quant="nf4p"): keeps half
#: of the NF4 residual table's 16 entries.
NF4P_PRUNE_THRESHOLD = 0.05


@dataclass(frozen=True)
class QuantizedWeight:
    """A projection weight frozen to unsigned 4-bit codes.

    ``codes``: (..., K, N) int8 in [0, 16); ``scale``/``zero_point``:
    (..., N) f32; ``hi_tab``/``lo_tab``: (..., 4) f32 D&C sub-tables;
    ``residual``: None (affine kernels) or (..., 16) f32 per-code
    correction, zeros where pruned.  ``kernel`` is the static tag that
    selects the evaluation strategy (see ``WEIGHT_KERNELS``).
    """
    codes: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    hi_tab: torch.Tensor
    lo_tab: torch.Tensor
    residual: torch.Tensor | None = None
    kernel: str = "lut_dc"

    def _map(self, fn) -> "QuantizedWeight":
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                kw[k] = fn(v)
        return QuantizedWeight(**kw)

    def to(self, device) -> "QuantizedWeight":
        return self._map(lambda t: t.to(device))

    def __getitem__(self, i) -> "QuantizedWeight":
        """Slice the leading (stacked-layer) axis of every child."""
        return self._map(lambda t: t[i])

    def shard(self, spec: tuple, mesh) -> "QuantizedWeight":
        """This rank's block under the (K, N) weight's ``spec``
        (``parallel.sharding``): ``codes`` cut on both dimensions,
        ``scale`` and ``zero_point`` with N; the tables stay whole, as
        computed from the whole weight (a shard is never recalibrated).
        Each cut is its own contiguous tensor, so the kernels' alignment
        rules see a fresh base."""
        from repro_torch.parallel.fsdp import shard_leaf
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        kw["codes"] = shard_leaf(self.codes, spec, mesh)
        for name in ("scale", "zero_point"):
            kw[name] = shard_leaf(kw[name], spec[-1:], mesh)
        return QuantizedWeight(**kw)

    @property
    def qparams(self) -> QParams:
        return QParams(self.scale, self.zero_point, 4)


def _nf4_dc_tables(prune_threshold: float | None):
    """(hi, lo, residual) least-squares D&C split of the NF4 codebook, the
    residual optionally pruned (dropped codes read 0)."""
    from repro_torch.core.lut import (NF4_CODEBOOK, dc_decompose_codebook,
                                      prune_residual, scatter_residual)
    hi_tab, lo_tab, residual = dc_decompose_codebook(NF4_CODEBOOK)
    if prune_threshold is not None:
        kept_idx, kept_val = prune_residual(residual, prune_threshold)
        residual = scatter_residual(kept_idx, kept_val)
    return hi_tab, lo_tab, residual


def nf4_encode(wn: torch.Tensor, codebook=None) -> torch.Tensor:
    """Nearest codebook entry (default NF4) of each normalised weight,
    FIRST minimum on ties (``jnp.argmin`` semantics), distances in f32 (a
    bf16 ``wn`` promotes against JAX's f32 codebook).  A running
    strict-``<`` minimum over the entries keeps the temporaries at the
    weight's own size instead of a (K, N, 16) distance tensor.  The codes
    carry no gradient, so nothing here is recorded for autograd."""
    from repro_torch.core.lut import NF4_CODEBOOK
    if codebook is None:
        codebook = NF4_CODEBOOK
    wn = wn.detach().float()
    best_d = torch.full_like(wn, float("inf"))
    codes = torch.zeros(wn.shape, dtype=torch.int8, device=wn.device)
    for j, c in enumerate(torch.as_tensor(codebook).tolist()):
        d = torch.abs(wn - c)
        codes.masked_fill_(d < best_d, j)
        best_d = torch.minimum(d, best_d)
    return codes


def quantize_weight(w: torch.Tensor, kernel: str = "lut_dc",
                    prune_threshold: float | None = None) -> QuantizedWeight:
    """Freeze a (…, K, N) float weight to a :class:`QuantizedWeight`.

    Affine kernels calibrate per output channel over K and carry the exact
    code-space split ``HI[i] = 4i``, ``LO[j] = j``.  NF4 kernels scale
    each output channel by its absmax (zero point 0), encode against the
    NF4 codebook, and carry its least-squares D&C split plus residual,
    pruned below ``prune_threshold`` when given.  Extra leading axes
    (stacked layers) are quantized slice by slice.
    """
    if kernel not in WEIGHT_KERNELS:
        raise ValueError(f"unknown weight kernel {kernel!r}; "
                         f"one of {WEIGHT_KERNELS}")
    if w.ndim > 2:
        parts = [quantize_weight(wi, kernel, prune_threshold) for wi in w]
        kw = {}
        for f in fields(QuantizedWeight):
            vals = [getattr(p, f.name) for p in parts]
            kw[f.name] = (torch.stack(vals) if isinstance(vals[0],
                                                          torch.Tensor)
                          else vals[0])
        return QuantizedWeight(**kw)
    dev = w.device
    wf = w.float()
    if kernel in ("nf4_dc", "nf4_dequant"):
        scale = torch.clamp_min(torch.amax(wf.abs(), dim=0), 1e-8)
        codes = nf4_encode(wf / scale[None, :])
        hi_tab, lo_tab, residual = _nf4_dc_tables(prune_threshold)
        return QuantizedWeight(codes, scale.float(), torch.zeros_like(scale),
                               hi_tab.to(dev), lo_tab.to(dev),
                               residual=residual.to(dev), kernel=kernel)
    qp = calibrate(wf, bits=4, axis=-1)
    codes = quantize(wf, qp).to(torch.int8)
    hi_tab = 4.0 * torch.arange(4, dtype=torch.float32, device=dev)
    lo_tab = torch.arange(4, dtype=torch.float32, device=dev)
    return QuantizedWeight(codes, qp.scale, qp.zero_point, hi_tab, lo_tab,
                           kernel=kernel)


#: decode-projection leaf names eligible for engine-level quantization
#: (the JAX package's set; the port's dense family reaches the first
#: four attention and the three MLP names).
DECODE_QUANT_TARGETS = frozenset({
    "wq", "wk", "wv", "wo", "w_dq", "w_uq", "w_dkv",      # attention
    "w_up", "w_gate", "w_down",                            # mlp / shared moe
    "w_in", "w_out",                                       # mamba2 mixer
})

#: dict keys whose subtrees hold quant_matmul-consumed projections.
_QUANT_PARENT_KEYS = frozenset({"attn", "mlp", "m", "shared"})

#: EngineConfig(quant=...) mode -> (weight kernel, residual prune
#: threshold); "nf4_direct" is the test oracle, not an engine mode.
DECODE_QUANT_KERNELS = {
    "lut4": ("lut_dc", None),
    "int4": ("dequant", None),
    "nf4": ("nf4_dc", None),
    "nf4p": ("nf4_dc", NF4P_PRUNE_THRESHOLD),
    "nf4_direct": ("nf4_dequant", None),
}


def quantize_decode_params(params, quant: str):
    """Walk a parameter tree (dicts and lists of tensors), freezing every
    decode projection to 4-bit.  A leaf is quantized iff its key is in
    ``DECODE_QUANT_TARGETS``, some ancestor key is in the quant-parent
    set, and it is a float matrix; everything else passes through as the
    same tensor object (no copy).  Leaves are quantized one at a time on
    their own device, so the peak extra memory is one leaf's f32 copy."""
    kernel, prune = DECODE_QUANT_KERNELS[quant]

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path) for v in node)
        if (path and path[-1] in DECODE_QUANT_TARGETS
                and any(p in _QUANT_PARENT_KEYS for p in path[:-1])
                and isinstance(node, torch.Tensor) and node.ndim >= 2
                and node.is_floating_point()):
            return quantize_weight(node, kernel, prune)
        return node

    return walk(params, ())


#: the draft-weight mode for self-speculative decoding: the pruned-LUT NF4
#: tree is the cheapest decode path the engine owns, so the draft budget is
#: spent there and the decode precision verifies.
SPEC_DRAFT_QUANT = "nf4p"


def quantize_draft_params(params, quant: str = SPEC_DRAFT_QUANT):
    """Draft-model weights for self-speculative decoding
    (``repro.core.quant.quantize_draft_params``): the same model with its
    decode projections frozen in their pruned-LUT form (default
    :data:`SPEC_DRAFT_QUANT`); no second set of weights and no separate
    cache layout.  An engine that already decodes at the draft mode
    (``EngineConfig(quant="nf4p")``) aliases its decode model instead."""
    return quantize_decode_params(params, quant)
