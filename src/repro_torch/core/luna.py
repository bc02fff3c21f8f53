"""LUNA-CIM core arithmetic: divide-and-conquer LUT multiplication (mirrors
``repro.core.luna``).

The paper splits an ``n``-bit product ``W x Y`` (weight-stationary) into
radix-4 digits of the input ``Y``::

    W * Y = sum_d (W * y_d) << (2*d),        y_d in {0,1,2,3}

Each partial product ``W * y_d`` reads the 4-entry table ``{0, W, 2W, 3W}``
(paper Figs 2/3).  The approximate variants replace the lowest digit's
partial product: ApproxD&C (Figs 4-9) sets it to 0, ApproxD&C2 (Figs
10-12) to ``W`` (as if ``y_lo == 01``).

Everything here is bit-exact integer arithmetic on unsigned code tensors
(int32 carriers), equal to the JAX module bitwise.  A digit plane
contracts with the weight codes in one integer matmul (:func:`_plane_matmul`);
the hand-written kernel of :mod:`repro_torch.kernels.luna_mm` computes the
same integers on the card.
"""
from __future__ import annotations

import enum
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import takes_kernels

DIGIT_BITS = 2  # the paper's radix-4 split
RADIX = 1 << DIGIT_BITS


class LunaMode(str, enum.Enum):
    """Multiplier variants, one per paper figure."""

    CONVENTIONAL = "conventional"  # Fig 1: full 2^n-entry LUT (exact)
    DC = "dc"                      # Fig 2: divide & conquer (exact)
    OPT_DC = "opt_dc"              # Fig 3: optimized storage D&C (exact)
    APPROX_DC = "approx_dc"        # Figs 4/9: Z_LSB := 0
    APPROX_DC2 = "approx_dc2"      # Fig 10: Z_LSB := W

    @property
    def is_exact(self) -> bool:
        return self in (LunaMode.CONVENTIONAL, LunaMode.DC, LunaMode.OPT_DC)


def num_digits(bits: int, digit_bits: int = DIGIT_BITS) -> int:
    if bits % digit_bits:
        raise ValueError(f"bits={bits} not divisible by digit_bits={digit_bits}")
    return bits // digit_bits


def split_digits(codes: torch.Tensor, bits: int,
                 digit_bits: int = DIGIT_BITS) -> list[torch.Tensor]:
    """Split unsigned codes into radix-``2**digit_bits`` digits, LSB first."""
    mask = (1 << digit_bits) - 1
    return [(codes >> (digit_bits * d)) & mask
            for d in range(num_digits(bits, digit_bits))]


def combine_partials(partials: Sequence[torch.Tensor],
                     digit_bits: int = DIGIT_BITS) -> torch.Tensor:
    """Shift-add combine of per-digit partial products (LSB first): the
    paper's HA/FA adder tree as int32 adds."""
    out = partials[0]
    for d, pp in enumerate(partials[1:], start=1):
        out = out + (pp << (digit_bits * d))
    return out


# ---------------------------------------------------------------------------
# Element-wise multiplier semantics (the paper's single LUNA unit)
# ---------------------------------------------------------------------------

def luna_product(w: torch.Tensor, y: torch.Tensor, bits: int = 4,
                 mode: LunaMode = LunaMode.OPT_DC,
                 digit_bits: int = DIGIT_BITS) -> torch.Tensor:
    """Element-wise ``W*Y`` with the selected LUNA multiplier variant.

    ``w``/``y`` are unsigned integer codes in ``[0, 2**bits)``.  Exact modes
    return the true product; approx modes the paper's approximation.
    """
    mode = LunaMode(mode)
    w = w.to(torch.int32)
    y = y.to(torch.int32)
    digits = split_digits(y, bits, digit_bits)
    partials = [w * d for d in digits]
    if mode == LunaMode.APPROX_DC:
        partials[0] = torch.zeros_like(partials[0])
    elif mode == LunaMode.APPROX_DC2:
        partials[0] = torch.broadcast_to(w, partials[0].shape)
    return combine_partials(partials, digit_bits)


# ---------------------------------------------------------------------------
# Matmul semantics (a LUNA array: one unit per (k, n) weight)
# ---------------------------------------------------------------------------

def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` -> int32.

    On the CPU an int32 matmul (exact).  CUDA has no integer matmul for
    these operands, so on the card the product runs in float64: every
    partial sum of code products is an integer far below 2**53, hence
    exact in any order.
    """
    if takes_kernels(a):
        return (a.double() @ b.double()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def _plane_matmul(y_plane: torch.Tensor, w: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """Digit-plane matmul (the lookup of the 4-entry table, which is linear
    in W): integer codes -> int32.  ``bits`` is kept for the JAX
    signature: JAX picks an int8 or int32 carrier by it; int32 here holds
    every width exactly."""
    del bits
    return int_matmul(y_plane, w)


def luna_matmul(y_codes: torch.Tensor, w_codes: torch.Tensor, bits: int = 4,
                mode: LunaMode = LunaMode.OPT_DC,
                digit_bits: int = DIGIT_BITS) -> torch.Tensor:
    """``Z[m, n] = sum_k luna_product(W[k, n], Y[m, k])`` in int32.

    Each digit plane of Y contracts against W in its own integer matmul and
    the shift-add happens once on the int32 accumulators.  The approx modes
    drop the low plane (APPROX_DC) or replace it by ``colsum(W)`` broadcast
    over rows (APPROX_DC2).
    """
    mode = LunaMode(mode)
    planes = split_digits(y_codes.to(torch.int32), bits, digit_bits)
    acc = torch.zeros(y_codes.shape[:-1] + (w_codes.shape[-1],),
                      dtype=torch.int32, device=y_codes.device)
    for d in range(len(planes)):
        if d == 0:
            if mode == LunaMode.APPROX_DC:
                continue
            if mode == LunaMode.APPROX_DC2:
                colsum = torch.sum(w_codes.to(torch.int32), dim=0,
                                   dtype=torch.int32)
                acc = acc + colsum  # broadcast over leading dims
                continue
        acc = acc + (_plane_matmul(planes[d], w_codes, bits)
                     << (digit_bits * d))
    return acc


# ---------------------------------------------------------------------------
# Optimized-storage table reconstruction (paper Fig 3)
# ---------------------------------------------------------------------------

def optimized_table_storage(w: int, bits: int = 4) -> dict:
    """The stored bits of the optimized D&C table for weight ``w``.

    Paper Fig 3: of the 4-entry table {0, W, 2W, 3W} only ``1 + bits +
    (bits+1)`` bits are stored: one literal 0, the ``bits`` bits of W, and
    the ``bits+1`` MSBs of 3W (the LSB of 3W equals the LSB of W).
    """
    assert 0 <= w < (1 << bits)
    t3 = 3 * w
    return {
        "zero_bit": 0,
        "w_bits": w,                      # `bits` cells
        "t3_msbs": t3 >> 1,               # `bits + 1` cells
        "num_cells": 1 + bits + (bits + 1),
    }


def optimized_table_reconstruct(storage: dict, bits: int = 4) -> list[int]:
    """Rebuild the full 4-entry table from the stored bits (Fig 3 wiring)."""
    w = storage["w_bits"]
    t3 = (storage["t3_msbs"] << 1) | (w & 1)  # LSB of 3W == LSB of W
    return [0, w, w << 1, t3]


# ---------------------------------------------------------------------------
# Statistical analyses (paper Figs 5, 6, 7/8, 11/12)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lsb_product_distribution(bits: int = 4, digit_bits: int = DIGIT_BITS):
    """Fig 5: distribution of the LSB-side product ``W * y_lo``, W uniform
    over [0, 2**bits), y_lo uniform over [0, 2**digit_bits).  Returns
    (values, probabilities, max value).  P(0) = 0.296 for 4b."""
    ws = np.arange(1 << bits)
    ys = np.arange(1 << digit_bits)
    prods = (ws[:, None] * ys[None, :]).ravel()
    max_val = ((1 << bits) - 1) * ((1 << digit_bits) - 1)
    n_out_bits = bits + digit_bits
    counts = np.bincount(prods, minlength=1 << n_out_bits)
    return np.arange(1 << n_out_bits), counts / counts.sum(), max_val


def impossible_lsb_products(bits: int = 4,
                            digit_bits: int = DIGIT_BITS) -> list[int]:
    """Values in [0, 2**(bits+digit_bits)) that ``W*y_lo`` never takes."""
    vals, probs, _ = lsb_product_distribution(bits, digit_bits)
    return [int(v) for v, p in zip(vals, probs) if p == 0.0]


def hamming_distance_profile(bits: int = 4, digit_bits: int = DIGIT_BITS):
    """Fig 6: mean per-bit Hamming distance of each candidate constant to
    the true LSB product, weighted by the product distribution (argmin 0,
    mean 0.275 for 4b)."""
    vals, probs, _ = lsb_product_distribution(bits, digit_bits)
    n_out_bits = bits + digit_bits
    cands = np.arange(1 << n_out_bits)
    xor = cands[:, None] ^ vals[None, :]
    hd = np.zeros_like(xor, dtype=np.float64)
    for b in range(n_out_bits):
        hd += (xor >> b) & 1
    return cands, (hd * probs[None, :]).sum(axis=1) / n_out_bits


def error_table(mode: LunaMode, bits: int = 4) -> np.ndarray:
    """Figs 7/11: error surface ``exact - approx`` over all (W, Y) codes
    (ApproxD&C error in [0, 45], ApproxD&C2 in [-15, 30] for 4b)."""
    n = 1 << bits
    w = torch.arange(n, dtype=torch.int32)[:, None]
    y = torch.arange(n, dtype=torch.int32)[None, :]
    exact = w * y
    approx = luna_product(torch.broadcast_to(w, (n, n)),
                          torch.broadcast_to(y, (n, n)), bits, mode)
    return (exact - approx).numpy()


def mean_abs_error(mode: LunaMode, bits: int = 4) -> float:
    """Expected |error| under uniform codes: the analytic core of Fig 13."""
    return float(np.abs(error_table(LunaMode(mode), bits)).mean())
