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

:func:`lut_gemm_tc_emulate` (and, for the full table,
:func:`lut_gemm_tc_full_emulate`) is the tensor-core decode kernel's
arithmetic step by step (``csrc/lut_gemm_tc.cu``), and
:func:`lut_gemm_wgmma_emulate` the prefill kernel's
(``csrc/lut_gemm_wgmma.cu``); the CPU tests hold them to JAX's kernels and
to the bitwise x = I contract.
"""
from __future__ import annotations

import torch

#: the tensor-core kernel's geometry (csrc/lut_gemm_tc.cu): K rows an MMA
#: step, warps a block (each a contiguous run of the block's steps)
TC_KSTEP = 16
TC_WARPS = 8
#: the prefill kernel's (csrc/lut_gemm_wgmma.cu): K rows a stage (the unit
#: of its K slices), each four 16-row wgmma steps
WG_BK = 64


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


def tc_table(hi_tab: torch.Tensor, lo_tab: torch.Tensor,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """The 16 f32 values ``T[q] = HI[q>>2] + LO[q&3] (+ RES[q])`` in the
    plain version's order, as the kernel's prologue builds them."""
    q = torch.arange(16, device=hi_tab.device)
    t = hi_tab[q >> 2] + lo_tab[q & 3]
    return t if residual is None else t + residual


def _trunc_bf16(v: torch.Tensor) -> torch.Tensor:
    return (v.view(torch.int32) & -65536).view(torch.float32)


def tc_pieces(table: torch.Tensor) -> list[torch.Tensor]:
    """The table's bf16 pieces (as f32 tensors) the kernel multiplies by,
    all into one accumulator: ``p1`` = T truncated to bf16, ``p2`` the same
    of ``T - p1``, ``p3 = T - p1 - p2``, trailing pieces that are zero for
    all 16 codes left out (the kernel's block-uniform skip)."""
    p1 = _trunc_bf16(table)
    r1 = table - p1
    p2 = _trunc_bf16(r1)
    pieces = [p1, p2, r1 - p2]
    while len(pieces) > 1 and not bool(pieces[-1].any()):
        pieces.pop()
    return pieces


def tc_split_steps(rank: int, k: int, splits: int) -> range:
    """The 16-row K steps that cluster rank ``rank`` of ``splits`` sums."""
    steps = -(-k // TC_KSTEP)
    per = -(-steps // splits)
    lo = min(steps, rank * per)
    return range(lo, min(steps, lo + per))


def tc_warp_steps(split: range, warp: int) -> range:
    """The steps warp ``warp`` of a block sums: a contiguous run of its
    slice's steps."""
    per = -(-len(split) // TC_WARPS)
    lo = min(split.stop, split.start + warp * per)
    return range(lo, min(split.stop, lo + per))


def tc_zero_point(acc: torch.Tensor, rowsum: torch.Tensor,
                  zero_point: torch.Tensor) -> torch.Tensor:
    """One warp's split with its zero point, ``fmaf(-rowsum, zp, acc)``:
    the product and sum in f64 (the product of two f32 values is exact
    there), rounded to f32 once."""
    fma = acc.double() - rowsum.double()[:, None] * zero_point.double()
    return fma.float()


def _tc_sum(x: torch.Tensor, w_codes: torch.Tensor, table: torch.Tensor,
            zero_point: torch.Tensor | None, splits: int) -> torch.Tensor:
    """The tensor-core kernel's unscaled sum (see
    :func:`lut_gemm_tc_emulate`); ``zero_point`` None: the full-table mode,
    no rowsum and no zero point."""
    m, k = x.shape
    steps = -(-k // TC_KSTEP)
    xf = torch.zeros((m, steps * TC_KSTEP), dtype=torch.float32)
    xf[:, :k] = x.to(torch.bfloat16).float()
    q = torch.zeros((steps * TC_KSTEP, w_codes.shape[1]), dtype=torch.long)
    q[:k] = w_codes.long()
    weights = [p[q] for p in tc_pieces(table)]
    n = q.shape[1]
    total = torch.zeros((m, n))
    for rank in range(splits):
        split = tc_split_steps(rank, k, splits)
        block = None
        for warp in range(TC_WARPS):
            acc, rs = torch.zeros((m, n)), torch.zeros(m)
            for s in tc_warp_steps(split, warp):
                xs = xf[:, s * TC_KSTEP:(s + 1) * TC_KSTEP]
                rs = rs + xs.sum(dim=1)
                for w in weights:
                    acc = acc + xs @ w[s * TC_KSTEP:(s + 1) * TC_KSTEP]
            part = (acc if zero_point is None
                    else tc_zero_point(acc, rs, zero_point))
            block = part if block is None else block + part
        total = total + block
    return total


def lut_gemm_tc_emulate(x: torch.Tensor, w_codes: torch.Tensor,
                        hi_tab: torch.Tensor, lo_tab: torch.Tensor,
                        zero_point: torch.Tensor, scale: torch.Tensor,
                        residual: torch.Tensor | None = None, *,
                        splits: int) -> torch.Tensor:
    """The tensor-core kernel's arithmetic on the CPU -> (M, N) f32.

    x (M, K) bf16 values; the codes' table cut into :func:`tc_pieces`; K
    zero-filled to whole 16-row steps; cluster rank r of ``splits`` sums
    :func:`tc_split_steps`, each of its warps :func:`tc_warp_steps`: per
    step the f32 product of the step's x with each piece's weights, added
    to the warp's f32 accumulator in piece order, and ``rowsum(x)`` the
    same way (an all-ones A); each warp's split takes its zero point
    (:func:`tc_zero_point`).  The warps are summed in warp order, the
    ranks in rank order, then scaled.  The kernel's fragment
    order (a thread's four k of a step are its rows 4t .. 4t+3) permutes
    the k inside one tensor-core product, whose sum order the hardware
    fixes: here it is the f32 matmul's.
    """
    table = tc_table(hi_tab, lo_tab, residual)
    return _tc_sum(x, w_codes, table, zero_point, splits) * scale[None, :]


def lut_gemm_tc_full_emulate(x: torch.Tensor, w_codes: torch.Tensor,
                             codebook: torch.Tensor, scale: torch.Tensor, *,
                             splits: int) -> torch.Tensor:
    """The tensor-core kernel's full-table mode on the CPU -> (M, N) f32:
    as :func:`lut_gemm_tc_emulate` with ``T[q] = CB[q]`` cut into
    :func:`tc_pieces` as it is, no rowsum and no zero point."""
    return _tc_sum(x, w_codes, codebook, None, splits) * scale[None, :]


def wgmma_split_stages(rank: int, k: int, splits: int) -> range:
    """The ``WG_BK``-row stages that cluster rank ``rank`` of ``splits``
    of the prefill kernel sums."""
    stages = -(-k // WG_BK)
    per = -(-stages // splits)
    lo = min(stages, rank * per)
    return range(lo, min(stages, lo + per))


def lut_gemm_wgmma_emulate(x: torch.Tensor, w_codes: torch.Tensor,
                           codebook: torch.Tensor, scale: torch.Tensor, *,
                           splits: int) -> torch.Tensor:
    """The prefill kernel's arithmetic on the CPU -> (M, N) f32.

    x (M, K) bf16 values; the codebook cut into :func:`tc_pieces`; K
    zero-filled to whole ``WG_BK``-row stages (TMA's zero fill); cluster
    rank r of ``splits`` sums :func:`wgmma_split_stages` into one f32
    accumulator, per 16-row step the f32 product of the step's x with each
    piece's weights added in piece order; the ranks' sums added in rank
    order, then scaled.  A wgmma's own sum order over its 16 k is the
    hardware's: here it is the f32 matmul's.
    """
    m, k = x.shape
    rows = -(-k // WG_BK) * WG_BK
    xf = torch.zeros((m, rows), dtype=torch.float32)
    xf[:, :k] = x.to(torch.bfloat16).float()
    q = torch.zeros((rows, w_codes.shape[1]), dtype=torch.long)
    q[:k] = w_codes.long()
    weights = [p[q] for p in tc_pieces(codebook)]
    total = None
    for rank in range(splits):
        acc = torch.zeros((m, q.shape[1]))
        for stage in wgmma_split_stages(rank, k, splits):
            for s in range(stage * WG_BK, (stage + 1) * WG_BK, TC_KSTEP):
                xs = xf[:, s:s + TC_KSTEP]
                for w in weights:
                    acc = acc + xs @ w[s:s + TC_KSTEP]
        total = acc if total is None else total + acc
    return total * scale[None, :]
