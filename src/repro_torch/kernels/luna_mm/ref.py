"""Plain PyTorch version of the LUNA GEMM kernel (mirrors
``repro.kernels.luna_mm.ref``): digit-split int32 math, no tiling."""
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
