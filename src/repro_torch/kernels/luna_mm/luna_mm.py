"""Wrappers of the hand-written Hopper LUNA GEMM kernels.

:func:`luna_mm` computes ``Z[m, n] = sum_k L(W[k, n], Y[m, k])`` in int32
on unsigned 4-bit codes, ``L`` the paper's multiplier in one of the
:class:`~repro_torch.core.luna.LunaMode` modes.  Replaces the Pallas
``repro/kernels/luna_mm/luna_mm.py:77 luna_mm``.

``w_codes`` is the (K, N) operand of JAX's signature, either row-major
(strides (N, 1)) or K-major (strides (1, K): ``w_nk.t()`` of an (N, K)
tensor).  A CUDA tensor launches a kernel on
``torch.cuda.current_stream()``, or the call raises; which kernel is fixed
by shape, layout and alignment alone (:func:`takes_tc`), never by a
failure:

* the tensor-core kernel (``csrc/luna_mm_tc.cu``: TMA-fed
  ``wgmma.m64n128k32`` on u8 codes, the digit planes masked out of the Y
  fragment in registers) for M >= ``TC_MIN_M``, K and N multiples of 16
  and 16-byte aligned bases.  It takes W K-major: a row-major W is first
  transposed into a scratch (N, K) copy by the same library, inside the
  call;
* the ``__dp4a`` kernel (``csrc/luna_mm.cu``) for the rest: decode-size M,
  ragged K or N, misaligned bases.  It takes W row-major: a K-major W gets
  a row-major copy.

``TC_MIN_M`` was set from device-only times (CUDA-graph replays, codes
cold in L2) of both kernels over one yi-9b layer's 7 projections, modes
approx_dc2 / dc, on an H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase
3b, its ``luna_route`` line; ``PERF.md`` section 6):

=====  ===============  =====================  ===================
M      dp4a ms          tensor core, row W ms  tensor core, K W ms
=====  ===============  =====================  ===================
8      0.154 / 0.164    0.241 / 0.241          0.114 / 0.114
16     0.188 / 0.261    0.240 / 0.240          0.112 / 0.114
32     0.264 / 0.441    0.238 / 0.238          0.111 / 0.111
64     0.477 / 0.834    0.241 / 0.242          0.110 / 0.110
128    1.037 / 1.385    0.264 / 0.266          0.134 / 0.135
=====  ===============  =====================  ===================

A row-major W pays the transpose (about 0.1 ms a layer), so the
tensor-core kernel wins from M = 32 on; a K-major W from the smallest M
measured, 8.

Both build on first use.  A CPU tensor takes the plain version
:func:`~repro_torch.kernels.luna_mm.ref.luna_mm_ref`; nothing falls back.
A ``meta`` tensor (the dry run, ``repro_torch.launch.dryrun``) returns
empty outputs of the kernel's shapes and records its cost formula
(``launch.cost``) without computing anything.
``luna_mm.launches`` counts every launch, ``luna_mm.launches_tc`` those of
the tensor-core kernel.

Kernels and plain version agree bitwise: the result is integer.  The codes
must lie in [0, 16) (the kernels read the digit planes off the low four
bits of each byte); the wrapper checks types and shapes, not values.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.luna import LunaMode
from repro_torch.kernels.luna_mm.ref import luna_mm_ref
from repro_torch.launch import cost

#: the __dp4a kernel's geometry (mirrors the constants in csrc/luna_mm.cu)
BLOCK_N = 512
KSPLIT_MAX = 1024
M_TILE_MAX = 16
#: blocks to aim for: four per SM of an H100 (132 SMs)
TARGET_BLOCKS = 4 * 132

#: the tensor-core kernel's tiles (BM, BN, BK in csrc/luna_mm_tc.cu)
TC_BLOCK_M = 128
TC_BLOCK_N = 128
TC_BLOCK_K = 128
#: its blocks (one per SM: 128 KB of shared memory each) to aim for
TC_TARGET_BLOCKS = 132
#: the least M the tensor-core kernel takes, by W's layout ("row": the
#: transpose is part of the call; "k": no copy)
TC_MIN_M = {"row": 32, "k": 8}
#: K and N multiple of this, and bases aligned to it in bytes (TMA's rules)
TC_ALIGN = 16

#: LunaMode -> the kernels' mode number (dc and opt_dc are one datapath)
MODE_ID = {LunaMode.CONVENTIONAL: 0, LunaMode.DC: 1, LunaMode.OPT_DC: 1,
           LunaMode.APPROX_DC: 2, LunaMode.APPROX_DC2: 3}


def split_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(m_tile, splits, k_split) of the __dp4a kernel for an (M, K) x (K,
    N) problem: enough K-splits to put ~``TARGET_BLOCKS`` blocks on the
    card, every slice a multiple of 32 rows and at most ``KSPLIT_MAX``."""
    m_tile = next(t for t in (1, 2, 4, 8, M_TILE_MAX)
                  if t >= min(m, M_TILE_MAX))
    tiles = -(-n // BLOCK_N) * -(-m // m_tile)
    want = max(1, -(-TARGET_BLOCKS // tiles))
    k_split = -(-k // want)
    k_split = min(KSPLIT_MAX, -(-k_split // 32) * 32)
    return m_tile, -(-k // k_split), k_split


def tc_split_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(splits, per) of the tensor-core kernel: K's ``TC_BLOCK_K`` tiles
    in ``splits`` slices of ``per`` tiles.  Split only when the output
    tiles fill at most half of ``TC_TARGET_BLOCKS``: then as many slices
    as fill it."""
    tiles = -(-m // TC_BLOCK_M) * -(-n // TC_BLOCK_N)
    k_tiles = -(-k // TC_BLOCK_K)
    want = min(k_tiles, max(1, TC_TARGET_BLOCKS // tiles))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def w_layout(w_codes: torch.Tensor) -> str | None:
    """``"row"`` for a row-major (K, N) ``w_codes``, ``"k"`` for a K-major
    one (strides (1, K)), else None."""
    if w_codes.is_contiguous():
        return "row"
    if w_codes.t().is_contiguous():
        return "k"
    return None


def takes_tc(m: int, k: int, n: int, w_layout: str | None,
             aligned: bool) -> bool:
    """Whether a CUDA call of this shape runs the tensor-core kernel (else
    the __dp4a kernel).  ``aligned``: both bases ``TC_ALIGN``-byte
    aligned."""
    return (aligned and w_layout in TC_MIN_M and m >= TC_MIN_M[w_layout]
            and k % TC_ALIGN == 0 and n % TC_ALIGN == 0)


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


def _tc_lib():
    """The tensor-core kernel's library, its entry points typed on first
    use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("luna_mm_tc")
    if lib.luna_mm_tc_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.luna_mm_tc_launch.argtypes = [p, p, p, p] + [i] * 6 + [p]
        lib.luna_mm_tc_launch.restype = ctypes.c_int
        lib.luna_mm_tc_transpose.argtypes = [p, p, i, i, p]
        lib.luna_mm_tc_transpose.restype = ctypes.c_int
        geometry = (lib.luna_mm_tc_block_m(), lib.luna_mm_tc_block_n(),
                    lib.luna_mm_tc_block_k())
        if geometry != (TC_BLOCK_M, TC_BLOCK_N, TC_BLOCK_K):
            raise RuntimeError(f"luna_mm_tc.cu geometry {geometry} differs "
                               "from the wrapper's")
    return lib


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
    """The __dp4a kernel; ``w_codes`` row-major."""
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


def _launch_tc(y_codes, w_codes, layout: str, mode: LunaMode) -> torch.Tensor:
    """The tensor-core kernel; ``w_codes`` row-major (``layout`` "row":
    transposed first) or K-major ("k")."""
    m, k = y_codes.shape
    n = w_codes.shape[1]
    dev = y_codes.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _tc_lib()
    with torch.cuda.device(dev):
        if layout == "row":
            w_nk = torch.empty((n, k), dtype=torch.int8, device=dev)
            err = lib.luna_mm_tc_transpose(w_codes.data_ptr(),
                                           w_nk.data_ptr(), k, n, stream)
            if err != 0:
                raise RuntimeError(f"luna_mm tensor-core transpose launch "
                                   f"failed: cudaError_t {err}")
        else:
            w_nk = w_codes.t()
        splits, per = tc_split_plan(m, k, n)
        out = torch.empty((m, n), dtype=torch.int32, device=dev)
        ws = (out if splits == 1 else
              torch.empty((splits, m, n), dtype=torch.int32, device=dev))
        err = lib.luna_mm_tc_launch(y_codes.data_ptr(), w_nk.data_ptr(),
                                    ws.data_ptr(), out.data_ptr(), m, k, n,
                                    MODE_ID[mode], splits, per, stream)
    if err != 0:
        raise RuntimeError(f"luna_mm tensor-core kernel launch failed: "
                           f"cudaError_t {err}")
    return out


def luna_mm(y_codes: torch.Tensor, w_codes: torch.Tensor,
            mode: str = "opt_dc") -> torch.Tensor:
    """``Z = sum_k L(W[k, n], Y[m, k])`` -> (M, N) int32.

    y_codes: (M, K) int8, contiguous; w_codes: (K, N) int8, row-major or
    K-major; codes in [0, 16).
    """
    mode = LunaMode(mode)
    _check(y_codes, w_codes)
    if y_codes.device.type == "cpu":
        return luna_mm_ref(y_codes, w_codes, mode)
    m, k = y_codes.shape
    n = w_codes.shape[1]
    if cost.ACTIVE is not None:
        cost.ACTIVE.kernel("luna_mm", *cost.luna_mm_cost(m, k, n,
                                                         mode.value))
    if y_codes.device.type == "meta":
        return torch.empty((m, n), dtype=torch.int32, device="meta")
    if y_codes.device.type != "cuda":
        raise ValueError(f"luna_mm runs on cuda, cpu or meta, not "
                         f"{y_codes.device}")
    layout = w_layout(w_codes)
    if layout is None or not y_codes.is_contiguous():
        raise ValueError("luna_mm takes a contiguous y_codes and a "
                         "row-major or K-major w_codes")
    aligned = (y_codes.data_ptr() % TC_ALIGN == 0
               and w_codes.data_ptr() % TC_ALIGN == 0)
    tc = takes_tc(m, k, n, layout, aligned)
    if tc:
        out = _launch_tc(y_codes, w_codes, layout, mode)
    else:
        out = _launch(y_codes, w_codes.contiguous(), mode)
    luna_mm.launches += 1
    luna_mm.launches_tc += tc
    return out


luna_mm.launches = 0
luna_mm.launches_tc = 0
