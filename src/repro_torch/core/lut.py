"""Lookup-table machinery: codebooks, mux-tree selection, the D&C split
(mirrors ``repro.core.lut``).

The paper's select logic is a binary tree of 2:1 muxes (15 for a 16-entry
table).  Here it is a tree of ``torch.where`` selects on the index bits —
``2**b - 1`` selects for a ``2**b``-entry table, the paper's mux count.
"""
from __future__ import annotations

import numpy as np
import torch

# The NF4 codebook (QLoRA, Dettmers et al. 2023): a non-linear 16-entry LUT
# the mux tree evaluates at the same hardware cost as uniform int4.  The
# port keeps its own copy (it imports nothing of the JAX package).
NF4_CODEBOOK = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)


def mux_tree_select(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` through a binary tree of 2:1 selects on idx bits.

    ``table``: ``(2**b, *S)`` where ``S`` broadcasts against ``idx.shape``.
    """
    n = table.shape[0]
    b = n.bit_length() - 1
    assert n == 1 << b, f"table size {n} not a power of two"
    level = table
    for bit in range(b):
        sel = ((idx >> bit) & 1).bool()
        level = torch.where(sel[None], level[1::2], level[0::2])
    return level[0]


def codebook_dequant(codes: torch.Tensor, codebook: torch.Tensor
                     ) -> torch.Tensor:
    """Dequantize integer codes through an arbitrary codebook (mux tree)."""
    return mux_tree_select(codebook.reshape(-1, *([1] * codes.ndim)), codes)


def dc_decompose_codebook(codebook, digit_bits: int = 2
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares additive D&C split of a ``2**(2*digit_bits)``-entry LUT:
    ``T[q] ~= HI[q >> digit_bits] + LO[q & (2**digit_bits - 1)]`` plus the
    per-entry residual.  Row means form HI (grand mean kept), centred
    column means form LO.  Returns ``(hi_tab, lo_tab, residual)`` in f32.
    """
    d = 1 << digit_bits
    grid = torch.as_tensor(codebook, dtype=torch.float32).reshape(d, d)
    # grand mean summed row by row, then over the row sums in order: the
    # order XLA's reduction takes, so the tables match JAX's to 0 ulp
    row_sums = grid.sum(dim=1)
    total = row_sums[0]
    for r in row_sums[1:]:
        total = total + r
    mean = total / grid.numel()
    hi_tab = torch.mean(grid, dim=1)
    lo_tab = torch.mean(grid, dim=0) - mean
    residual = (grid - hi_tab[:, None] - lo_tab[None, :]).reshape(-1)
    return hi_tab, lo_tab, residual


def prune_residual(residual: torch.Tensor, threshold: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep residual entries with ``|r| >= threshold``; returns
    ``(kept_idx int32, kept_val f32)``, the sparse pruned sub-table."""
    res = torch.as_tensor(residual, dtype=torch.float32)
    kept_idx = torch.nonzero(res.abs() >= threshold).reshape(-1)
    return kept_idx.to(torch.int32), res[kept_idx]


def scatter_residual(kept_idx: torch.Tensor, kept_val: torch.Tensor,
                     size: int = 16) -> torch.Tensor:
    """Densify a pruned residual: dropped codes read 0."""
    out = torch.zeros(size, dtype=torch.float32, device=kept_val.device)
    out[kept_idx.long()] = kept_val
    return out


def residual_table_bytes(n_kept: int, n_codes: int = 16,
                         value_bytes: int = 4, index_bytes: int = 1
                         ) -> tuple[int, int]:
    """(dense, pruned) storage bytes of a residual sub-table."""
    dense = n_codes * value_bytes
    pruned = n_kept * (value_bytes + index_bytes)
    return dense, pruned
