"""Plain PyTorch versions of the LUNA GEMM kernels (mirrors
``repro.kernels.luna_mm.ref``): :func:`luna_mm_ref`, digit-split int32
math with no tiling, the plain version of both kernels; and
:func:`luna_mm_tc_emulate`, the tensor-core kernel's arithmetic step by
step (``csrc/luna_mm_tc.cu``), which the CPU tests hold to it."""
from __future__ import annotations

import torch

from repro_torch.core.luna import LunaMode, int_matmul


def luna_mm_ref(y_codes: torch.Tensor, w_codes: torch.Tensor,
                mode: str = "opt_dc") -> torch.Tensor:
    """``Z[m, n] = sum_k L(W[k, n], Y[m, k])`` -> (M, N) int32.

    ``y_codes`` (M, K) and ``w_codes`` (K, N): unsigned codes in [0, 16).
    """
    mode = LunaMode(mode)
    y = y_codes.to(torch.int32)
    w = w_codes.to(torch.int32)
    hi = y >> 2
    if mode == LunaMode.APPROX_DC:
        return int_matmul(hi, w) << 2
    if mode == LunaMode.APPROX_DC2:
        return (int_matmul(hi, w) << 2) + torch.sum(
            w, dim=0, dtype=torch.int32)[None, :]
    return int_matmul(y, w)  # all exact modes equal the true product


def tc_operands(y_tile: torch.Tensor, mode: LunaMode) -> list[torch.Tensor]:
    """The A operands the tensor-core kernel multiplies one K tile of Y by,
    all into one accumulator: the hi plane pre-scaled (``y & 12`` = 4 hi),
    the lo plane ``y & 3``, approx_dc2's all-ones operand (its product is
    the tile's colsum(W) in every row)."""
    if mode == LunaMode.CONVENTIONAL:
        return [y_tile]
    ops = [y_tile & 12]
    if mode in (LunaMode.DC, LunaMode.OPT_DC):
        ops.append(y_tile & 3)
    elif mode == LunaMode.APPROX_DC2:
        ops.append(torch.ones_like(y_tile))
    return ops


def tc_k_tiles(split: int, per: int, k_tiles: int) -> range:
    """The K tiles split ``split`` of the kernel sums."""
    return range(split * per, min((split + 1) * per, k_tiles))


def luna_mm_tc_emulate(y_codes: torch.Tensor, w_codes: torch.Tensor,
                       mode: str, *, splits: int, per: int,
                       block: tuple[int, int, int] = (128, 128, 128)
                       ) -> torch.Tensor:
    """The tensor-core kernel's arithmetic on the CPU -> (M, N) int32.

    Y and W are zero-filled to whole (``block`` = BM, BN, BK) tiles, as
    TMA reads past their edges; K's tiles go in ``splits`` slices of
    ``per`` (the wrapper's ``tc_split_plan``); each slice's accumulator
    sums, K tile by K tile, the products of :func:`tc_operands` with the
    tile of W (each exact: below 2^53 in float64); the slices are summed
    in index order, then cropped to (M, N).  Every (BM, BN) output tile
    owns its accumulator and reads only its own rows and columns, so one
    product over all row and column tiles per K tile computes each.
    """
    mode = LunaMode(mode)
    bm, bn, bk = block
    m, k = y_codes.shape
    n = w_codes.shape[1]
    k_tiles = -(-k // bk)
    if not (splits * per >= k_tiles > (splits - 1) * per):
        raise ValueError(f"{splits} slices of {per} tiles do not cover "
                         f"{k_tiles} K tiles")
    y = torch.zeros((-(-m // bm) * bm, k_tiles * bk), dtype=torch.int32)
    w = torch.zeros((k_tiles * bk, -(-n // bn) * bn), dtype=torch.int32)
    y[:m, :k] = y_codes.to(torch.int32)
    w[:k, :n] = w_codes.to(torch.int32)
    ws = torch.zeros((splits, *y.shape[:1], w.shape[1]), dtype=torch.int32)
    for split in range(splits):
        for t in tc_k_tiles(split, per, k_tiles):
            y_tile = y[:, t * bk:(t + 1) * bk]
            w_tile = w[t * bk:(t + 1) * bk].double()
            for a in tc_operands(y_tile, mode):
                ws[split] += (a.double() @ w_tile).to(torch.int32)
    out = ws[0]
    for split in range(1, splits):
        out = out + ws[split]
    return out[:m, :n].contiguous()
