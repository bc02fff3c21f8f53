"""Wrapper of the hand-written Hopper LUNA GEMM kernel.

:func:`luna_mm` computes ``Z[m, n] = sum_k L(W[k, n], Y[m, k])`` in int32
on unsigned 4-bit codes, ``L`` the paper's multiplier in one of the
:class:`~repro_torch.core.luna.LunaMode` modes.  Replaces the Pallas
``repro/kernels/luna_mm/luna_mm.py:77 luna_mm``.

A CUDA tensor launches the kernel (``csrc/luna_mm.cu``, built on first
use) on ``torch.cuda.current_stream()``, or the call raises; a CPU tensor
takes the plain version :func:`~repro_torch.kernels.luna_mm.ref.luna_mm_ref`.
Nothing falls back.  ``luna_mm.launches`` counts kernel launches.

Kernel and plain version agree bitwise: the result is integer.  The codes
must lie in [0, 16) (the kernel reads the digit planes off the low four
bits of each byte); the wrapper checks types and shapes, not values.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.luna import LunaMode
from repro_torch.kernels.luna_mm.ref import luna_mm_ref

#: the kernel's geometry (mirrors the constants in csrc/luna_mm.cu)
BLOCK_N = 512
KSPLIT_MAX = 1024
M_TILE_MAX = 16
#: blocks to aim for: four per SM of an H100 (132 SMs)
TARGET_BLOCKS = 4 * 132

#: LunaMode -> the kernel's mode number (dc and opt_dc are one datapath)
MODE_ID = {LunaMode.CONVENTIONAL: 0, LunaMode.DC: 1, LunaMode.OPT_DC: 1,
           LunaMode.APPROX_DC: 2, LunaMode.APPROX_DC2: 3}


def split_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(m_tile, splits, k_split) for an (M, K) x (K, N) problem: enough
    K-splits to put ~``TARGET_BLOCKS`` blocks on the card, every slice a
    multiple of 32 rows and at most ``KSPLIT_MAX``."""
    m_tile = next(t for t in (1, 2, 4, 8, M_TILE_MAX)
                  if t >= min(m, M_TILE_MAX))
    tiles = -(-n // BLOCK_N) * -(-m // m_tile)
    want = max(1, -(-TARGET_BLOCKS // tiles))
    k_split = -(-k // want)
    k_split = min(KSPLIT_MAX, -(-k_split // 32) * 32)
    return m_tile, -(-k // k_split), k_split


def _lib():
    from repro_torch.kernels._build import load_library
    lib = load_library("luna_mm")
    fn = lib.luna_mm_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        geometry = (lib.luna_mm_block_n(), lib.luna_mm_ksplit_max(),
                    lib.luna_mm_m_tile_max())
        if geometry != (BLOCK_N, KSPLIT_MAX, M_TILE_MAX):
            raise RuntimeError(f"luna_mm.cu geometry {geometry} differs "
                               "from the wrapper's")
    return fn


def _check(y_codes, w_codes):
    if (y_codes.ndim != 2 or w_codes.ndim != 2
            or y_codes.shape[1] != w_codes.shape[0]):
        raise ValueError(f"shapes y {tuple(y_codes.shape)}, w "
                         f"{tuple(w_codes.shape)}: want (M, K) and (K, N)")
    for name, t in (("y_codes", y_codes), ("w_codes", w_codes)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
    if y_codes.device != w_codes.device:
        raise ValueError(f"operands on several devices: {y_codes.device}, "
                         f"{w_codes.device}")


def _launch(y_codes, w_codes, mode: LunaMode) -> torch.Tensor:
    if not (y_codes.is_contiguous() and w_codes.is_contiguous()):
        raise ValueError("luna_mm takes contiguous operands")
    m, k = y_codes.shape
    n = w_codes.shape[1]
    m_tile, splits, k_split = split_plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.int32, device=y_codes.device)
    ws = (out if splits == 1 else
          torch.empty((splits, m, n), dtype=torch.int32,
                      device=y_codes.device))
    vec = (k % 4 == 0 and n % 4 == 0 and y_codes.data_ptr() % 4 == 0
           and w_codes.data_ptr() % 4 == 0)
    stream = torch.cuda.current_stream(y_codes.device).cuda_stream
    with torch.cuda.device(y_codes.device):
        err = _lib()(y_codes.data_ptr(), w_codes.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), m, k, n, MODE_ID[mode], m_tile, splits,
                     k_split, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"luna_mm kernel launch failed: cudaError_t {err}")
    return out


def luna_mm(y_codes: torch.Tensor, w_codes: torch.Tensor,
            mode: str = "opt_dc") -> torch.Tensor:
    """``Z = sum_k L(W[k, n], Y[m, k])`` -> (M, N) int32.

    y_codes: (M, K) int8, w_codes: (K, N) int8, codes in [0, 16).
    """
    mode = LunaMode(mode)
    _check(y_codes, w_codes)
    if y_codes.device.type == "cpu":
        return luna_mm_ref(y_codes, w_codes, mode)
    if y_codes.device.type != "cuda":
        raise ValueError(f"luna_mm runs on cuda or cpu, not "
                         f"{y_codes.device}")
    out = _launch(y_codes, w_codes, mode)
    luna_mm.launches += 1
    return out


luna_mm.launches = 0
