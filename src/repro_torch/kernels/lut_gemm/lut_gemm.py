"""Wrappers of the hand-written Hopper LUT GEMM kernels.

* :func:`lut_gemm` — ``(x @ CB[q]) * scale``, the full 16-entry codebook
  GEMM (paper Fig 1; the model-level ``lut_nf4`` mode on the card).
  Replaces the Pallas ``repro/kernels/lut_gemm/lut_gemm.py:78 lut_gemm``.
* :func:`lut_gemm_dc` — ``(x @ (HI[q>>2] + LO[q&3] - zp)) * scale``, the
  affine D&C sub-table GEMM (``quant="lut4"``).  Replaces the Pallas
  ``repro/kernels/lut_gemm/lut_gemm.py:214 lut_gemm_dc``.
* :func:`lut_gemm_dc_res` — the same plus a per-code residual ``RES[q]``
  (non-affine NF4, ``quant="nf4"``/``"nf4p"``).  Replaces the Pallas
  ``lut_gemm.py:168 lut_gemm_dc_res``.

A CUDA tensor launches a kernel on ``torch.cuda.current_stream()``, or the
call raises; a ``meta`` tensor (the dry run, ``repro_torch.launch.
dryrun``) returns empty outputs of the kernel's shape and records its cost
formula (``launch.cost``), computing nothing; a CPU tensor takes the plain
version in ``ref.py`` (for
:func:`lut_gemm`, JAX's ``lut_gemm_ref``, which folds the scale into the
weight before the matmul; the kernels apply it after, as the Pallas
kernel does).  Nothing falls back.  Which kernel a call launches is fixed
by dtype, shape and alignment alone (:func:`takes_tc` for the D&C
wrappers, :func:`route` for :func:`lut_gemm`):

* the tensor-core decode kernel (``csrc/lut_gemm_tc.cu``: ``mma.sync``
  bf16 on exact bf16 pieces of the 16-entry table, split-K summed on chip,
  one launch; a full-table mode for :func:`lut_gemm`) for bf16 x, 1 <= M
  <= ``TC_MAX_M``, N % 16 == 0, K % 4 == 0 and 16-byte aligned bases: the
  decode projections of the main path;
* for :func:`lut_gemm` at M >= ``WGMMA_MIN_M`` (bf16 x, K % 16 == 0, N %
  16 == 0, 16-byte aligned bases) the tensor-core prefill kernel
  (``csrc/lut_gemm_wgmma.cu``: TMA-fed ``wgmma`` with the weight's three
  exact bf16 pieces looked up into the A registers, split-K summed on
  chip, one launch): the prefill projections of ``lut_nf4``;
* the f32-FMA kernel (``csrc/lut_gemm.cu``, split-K through a workspace
  and a second pass) for the rest: f32 x, unaligned or ragged shapes, and
  the D&C calls at M > ``TC_MAX_M``.

All build on first use.  Each wrapper counts its launches in a plain
integer attribute, ``launches``; the tensor-core decode kernel's in
``launches_tc`` and (:func:`lut_gemm`) the prefill kernel's in
``launches_wgmma``.

Tolerance of kernel against plain version on the card: rtol = atol =
``KERNEL_RTOL``/``KERNEL_ATOL`` (1e-4).  All sum up to 11008 f32 products
per output in different orders (the f32 kernel: split-K slices of <= 1024
rows in k order, the slices summed in index order; the tensor-core
kernels: 16-row steps on the tensor cores, each table piece's products
exact, warps and cluster ranks summed in a fixed order, then (D&C) the
zero point as ``fmaf(-rowsum(x), zp, acc)``; the plain version: the
library matmul's own tiling), which moves results by ~1e-6 at unit output
scale;
the bound leaves two orders of margin.  The tensor-core kernel's zero
point adds no cancellation beyond f32's: its two terms, ``x @ T`` and
``rowsum(x) * zp``, are of the size of ``x @ (T - zp)`` itself (the zero
point sits inside the table's range), so the f32 roundings of each are
of the size of the plain version's own.  The dequantized weight itself (``x`` = rows of I) must
match bitwise on every kernel: there ``acc = T[q]`` exactly (the three
bf16 pieces sum back to T) and ``rowsum = 1``, so ``T[q] - zp`` is rounded
once, as the plain version does (full table: ``CB[q] * scale``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.lut_gemm.ref import (lut_gemm_dc_ref,
                                              lut_gemm_dc_res_ref,
                                              lut_gemm_ref)
from repro_torch.launch import cost

KERNEL_RTOL = 1e-4
KERNEL_ATOL = 1e-4

#: the kernel's geometry (mirrors the constants in csrc/lut_gemm.cu)
BLOCK_N = 512
KSPLIT_MAX = 1024
M_TILE_MAX = 8
#: blocks to aim for: four per SM of an H100 (132 SMs)
TARGET_BLOCKS = 4 * 132

#: the tensor-core kernel's geometry (mirrors csrc/lut_gemm_tc.cu): columns
#: a block, the largest M (four n8 tiles), the largest cluster (K slices
#: summed through distributed shared memory), K rows an MMA step
TC_BLOCK_N = 128
TC_MAX_M = 32
TC_MAX_CLUSTER = 16
TC_KSTEP = 16
#: SMs of an H100; the kernel fits two blocks an SM at M <= 8, one above
SMS = 132
#: bases of x and the codes aligned to this many bytes (16-byte loads)
TC_ALIGN = 16

#: the prefill kernel's geometry (mirrors csrc/lut_gemm_wgmma.cu): columns
#: a block, K rows a stage (one TMA box), the largest cluster (K slices
#: summed through distributed shared memory), its row tiles (the wgmma's
#: N: multiples of 16 from the first to the second)
WG_BLOCK_N = 128
WG_BK = 64
WG_MAX_CLUSTER = 8
WG_TILE_M = (64, 176)
#: a block's fixed cost (table build, pipeline fill, split-K sum) in
#: stages, for the split plan
WG_FIXED_STAGES = 4
#: the smallest M :func:`lut_gemm` sends to the prefill kernel (set from
#: chip_smoke.py phase 3c's device-only times of a yi-9b layer)
WGMMA_MIN_M = 33


def split_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(m_tile, splits, k_split) for an (M, K) x (K, N) problem: enough
    K-splits to put ~``TARGET_BLOCKS`` blocks on the card, every slice a
    multiple of 32 rows and at most ``KSPLIT_MAX``."""
    m_tile = next(t for t in (1, 2, 4, M_TILE_MAX) if t >= min(m, M_TILE_MAX))
    tiles = -(-n // BLOCK_N) * -(-m // m_tile)
    want = max(1, -(-TARGET_BLOCKS // tiles))
    k_split = -(-k // want)
    k_split = min(KSPLIT_MAX, -(-k_split // 32) * 32)
    return m_tile, -(-k // k_split), k_split


def takes_tc(m: int, k: int, n: int, x_dtype: torch.dtype,
             aligned: bool) -> bool:
    """Whether a CUDA call of :func:`lut_gemm_dc` / :func:`lut_gemm_dc_res`
    of this shape runs the tensor-core kernel (else the f32-FMA kernel).
    ``aligned``: both bases ``TC_ALIGN``-byte aligned."""
    return (x_dtype == torch.bfloat16 and 1 <= m <= TC_MAX_M
            and n % 16 == 0 and k % 4 == 0 and aligned)


def tc_split_plan(m: int, k: int, n: int) -> int:
    """The tensor-core kernel's K slices (its cluster size): as many as fill
    the card's block slots (two an SM at M <= 8, one above) beside the
    ``TC_BLOCK_N``-column tiles, at most ``TC_MAX_CLUSTER``, and no more
    than leave every slice some of the 16-row K steps.  The kernel takes
    fewer where the card cannot hold that many clusters at once (it asks
    ``cudaOccupancyMaxActiveClusters``): a second wave of a few clusters
    would double the call's time."""
    tiles = -(-n // TC_BLOCK_N)
    slots = (2 if m <= 8 else 1) * SMS
    steps = -(-k // TC_KSTEP)
    splits = max(1, min(TC_MAX_CLUSTER, steps, slots // tiles))
    return -(-steps // -(-steps // splits))


def route(m: int, k: int, n: int, x_dtype: torch.dtype,
          aligned: bool) -> str:
    """The kernel a CUDA call of :func:`lut_gemm` of this shape runs:
    ``"tc"`` (``lut_gemm_tc.cu``'s full-table mode), ``"wgmma"``
    (``lut_gemm_wgmma.cu``) or ``"fma"`` (``lut_gemm.cu``).  ``aligned``:
    both bases ``TC_ALIGN``-byte aligned."""
    if x_dtype == torch.bfloat16 and aligned and n % 16 == 0:
        if 1 <= m <= TC_MAX_M and k % 4 == 0:
            return "tc"
        if m >= WGMMA_MIN_M and k % 16 == 0:
            return "wgmma"
    return "fma"


def wgmma_tile_m(m: int) -> int:
    """Rows of x a block of the prefill kernel takes (the wgmma's N): M
    cut into as few tiles as the largest ``WG_TILE_M`` allows, evenly,
    rounded up to a multiple of 16, at least the smallest.  A tile's
    lookups and stream cost about the same whatever its rows (a yi-9b layer
    on 64- and 128-row tiles took ~0.2 ms a tile at every M on an H100 80GB
    HBM3 at 700 W, chip_smoke.py phase 3c), so fewer tiles are faster."""
    lo, hi = WG_TILE_M
    per = -(-m // -(-m // hi))
    return max(lo, -(-per // 16) * 16)


def wgmma_split_plan(m: int, k: int, n: int, clusters=None) -> int:
    """The prefill kernel's K slices (its cluster size, <=
    ``WG_MAX_CLUSTER``), in whole ``WG_BK``-row stages, every slice some:
    the one whose output tiles finish first, counted as waves of clusters
    (``clusters(s)``: clusters of s blocks the card holds at once; by
    default one block on each of ``SMS`` SMs) times the stages a block runs
    plus its fixed cost; the fewer slices on a tie."""
    tiles = -(-n // WG_BLOCK_N) * -(-m // wgmma_tile_m(m))
    stages = -(-k // WG_BK)
    best = None
    for s in range(1, min(WG_MAX_CLUSTER, stages) + 1):
        per = -(-stages // s)
        fit = SMS // s if clusters is None else clusters(s)
        if -(-stages // per) != s or fit <= 0:
            continue
        cost = -(-tiles // fit) * (per + WG_FIXED_STAGES)
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


def _lib():
    """The built library, its two entry points typed on first use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("lut_gemm")
    if lib.lut_gemm_dc_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lut_gemm_dc_launch.argtypes = [p, i, p, p, p, p, p, p, p, p, i,
                                           i, i, i, i, i, i, p]
        lib.lut_gemm_full_launch.argtypes = [p, i, p, p, p, p, p, i, i, i, i,
                                             i, i, i, p]
        lib.lut_gemm_dc_launch.restype = ctypes.c_int
        lib.lut_gemm_full_launch.restype = ctypes.c_int
        geometry = (lib.lut_gemm_block_n(), lib.lut_gemm_ksplit_max(),
                    lib.lut_gemm_m_tile_max())
        if geometry != (BLOCK_N, KSPLIT_MAX, M_TILE_MAX):
            raise RuntimeError(f"lut_gemm.cu geometry {geometry} differs "
                               "from the wrapper's")
    return lib


def _tc_lib():
    """The tensor-core kernel's library, its entry point typed on first
    use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("lut_gemm_tc")
    if lib.lut_gemm_tc_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lut_gemm_tc_launch.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.lut_gemm_tc_full_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.lut_gemm_tc_launch.restype = ctypes.c_int
        lib.lut_gemm_tc_full_launch.restype = ctypes.c_int
        geometry = (lib.lut_gemm_tc_block_n(), lib.lut_gemm_tc_max_m(),
                    lib.lut_gemm_tc_max_cluster(), lib.lut_gemm_tc_kstep())
        if geometry != (TC_BLOCK_N, TC_MAX_M, TC_MAX_CLUSTER, TC_KSTEP):
            raise RuntimeError(f"lut_gemm_tc.cu geometry {geometry} differs "
                               "from the wrapper's")
    return lib


def _wgmma_lib():
    """The prefill kernel's library, its entry point typed on first use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("lut_gemm_wgmma")
    if lib.lut_gemm_wgmma_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lut_gemm_wgmma_launch.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.lut_gemm_wgmma_launch.restype = ctypes.c_int
        lib.lut_gemm_wgmma_max_clusters.argtypes = [i, i]
        lib.lut_gemm_wgmma_max_clusters.restype = ctypes.c_int
        geometry = (lib.lut_gemm_wgmma_block_n(),
                    lib.lut_gemm_wgmma_block_k(),
                    lib.lut_gemm_wgmma_max_cluster(),
                    (lib.lut_gemm_wgmma_min_tile_m(),
                     lib.lut_gemm_wgmma_max_tile_m()))
        if geometry != (WG_BLOCK_N, WG_BK, WG_MAX_CLUSTER, WG_TILE_M):
            raise RuntimeError(f"lut_gemm_wgmma.cu geometry {geometry} "
                               "differs from the wrapper's")
    return lib


@functools.cache
def _wgmma_clusters(device: int, bm: int, splits: int) -> int:
    """Clusters of ``splits`` blocks of the ``bm``-row prefill kernel the
    card holds at once."""
    with torch.cuda.device(device):
        n = _wgmma_lib().lut_gemm_wgmma_max_clusters(bm, splits)
    if n < 0:
        raise RuntimeError(f"lut_gemm_wgmma occupancy query failed: "
                           f"cudaError_t {-n}")
    return n


def _check(x, w_codes, tables, scale, zero_point=None):
    if x.ndim != 2 or w_codes.ndim != 2 or x.shape[1] != w_codes.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, codes "
                         f"{tuple(w_codes.shape)}: want (M, K) and (K, N)")
    n = w_codes.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {w_codes.dtype}")
    vecs = (*tables, ("scale", scale, n),
            *(() if zero_point is None else (("zero_point", zero_point, n),)))
    for name, t, size in vecs:
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise ValueError(f"{name} must be float32 of shape ({size},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    devs = {t.device for t in (x, w_codes, *(t for _, t, _ in vecs))}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _launch(x, w_codes, scale, hi_tab=None, lo_tab=None, residual=None,
            zero_point=None, codebook=None):
    """D&C (``hi_tab``/``lo_tab``/``zero_point``, optional ``residual``)
    or full table (``codebook``)."""
    ops = (x, w_codes, scale, hi_tab, lo_tab, residual, zero_point, codebook)
    if not all(t.is_contiguous() for t in ops if t is not None):
        raise ValueError("lut_gemm kernels take contiguous operands")
    m, k = x.shape
    n = w_codes.shape[1]
    m_tile, splits, k_split = split_plan(m, k, n)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    vec = n % 4 == 0 and w_codes.data_ptr() % 4 == 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), int(x.dtype == torch.bfloat16), w_codes.data_ptr())
    tail = (m, k, n, m_tile, splits, k_split, int(vec), stream)
    with torch.cuda.device(x.device):
        if codebook is not None:
            err = _lib().lut_gemm_full_launch(
                *head, codebook.data_ptr(), scale.data_ptr(), ws.data_ptr(),
                out.data_ptr(), *tail)
        else:
            err = _lib().lut_gemm_dc_launch(
                *head, hi_tab.data_ptr(), lo_tab.data_ptr(),
                None if residual is None else residual.data_ptr(),
                zero_point.data_ptr(), scale.data_ptr(), ws.data_ptr(),
                out.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"lut_gemm kernel launch failed: cudaError_t "
                           f"{err}")
    return out


def _launch_tc(x, w_codes, scale, hi_tab, lo_tab, residual, zero_point):
    """The tensor-core kernel (``residual`` None: ``lut_gemm_dc``)."""
    ops = (x, w_codes, scale, hi_tab, lo_tab, residual, zero_point)
    if not all(t.is_contiguous() for t in ops if t is not None):
        raise ValueError("lut_gemm kernels take contiguous operands")
    m, k = x.shape
    n = w_codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _tc_lib().lut_gemm_tc_launch(
            x.data_ptr(), w_codes.data_ptr(), hi_tab.data_ptr(),
            lo_tab.data_ptr(), None if residual is None else
            residual.data_ptr(), zero_point.data_ptr(), scale.data_ptr(),
            out.data_ptr(), m, k, n, tc_split_plan(m, k, n), stream)
    if err != 0:
        raise RuntimeError(f"lut_gemm tensor-core kernel launch failed: "
                           f"cudaError_t {err}")
    return out


def _launch_full(x, w_codes, codebook, scale, kernel: str):
    """A full-table call on the tensor-core decode kernel (``"tc"``) or
    the prefill kernel (``"wgmma"``)."""
    ops = (x, w_codes, codebook, scale)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("lut_gemm kernels take contiguous operands")
    m, k = x.shape
    n = w_codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), w_codes.data_ptr(), codebook.data_ptr(),
            scale.data_ptr(), out.data_ptr(), m, k, n)
    with torch.cuda.device(x.device):
        if kernel == "tc":
            err = _tc_lib().lut_gemm_tc_full_launch(
                *head, tc_split_plan(m, k, n), stream)
        else:
            bm, dev = wgmma_tile_m(m), x.device.index
            splits = wgmma_split_plan(
                m, k, n, lambda s: _wgmma_clusters(dev, bm, s))
            err = _wgmma_lib().lut_gemm_wgmma_launch(*head, bm, splits,
                                                     stream)
    if err != 0:
        raise RuntimeError(f"lut_gemm {kernel} kernel launch failed: "
                           f"cudaError_t {err}")
    return out


def _launch_dc(x, w_codes, scale, hi_tab, lo_tab, residual, zero_point):
    """One D&C call on the kernel :func:`takes_tc` names; returns (out,
    whether it was the tensor-core kernel)."""
    m, k = x.shape
    n = w_codes.shape[1]
    aligned = (x.data_ptr() % TC_ALIGN == 0
               and w_codes.data_ptr() % TC_ALIGN == 0)
    if takes_tc(m, k, n, x.dtype, aligned):
        return _launch_tc(x, w_codes, scale, hi_tab, lo_tab, residual,
                          zero_point), True
    return _launch(x, w_codes, scale, hi_tab, lo_tab, residual,
                   zero_point), False


def _cost(x, w_codes, table_bytes: int, vec_bytes: int = 8):
    """(operations, bytes) of one call (``cost.lut_gemm_cost``)."""
    m, k = x.shape
    return cost.lut_gemm_cost(m, k, w_codes.shape[1], x.element_size(),
                              table_bytes, vec_bytes)


def _meta_out(x, w_codes) -> torch.Tensor:
    """The kernels' (M, N) f32 output on ``meta`` (the dry run: nothing
    is computed)."""
    return torch.empty((x.shape[0], w_codes.shape[1]), dtype=torch.float32,
                       device=x.device)


def lut_gemm_dc(x: torch.Tensor, w_codes: torch.Tensor, hi_tab: torch.Tensor,
                lo_tab: torch.Tensor, zero_point: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``(x @ (HI[q>>2] + LO[q&3] - zp)) * scale`` -> (M, N) f32.

    x: (M, K) f32/bf16; w_codes: (K, N) int8 in [0, 16); hi_tab/lo_tab:
    (4,) f32 code-space sub-tables; zero_point/scale: (N,) f32.
    """
    _check(x, w_codes, (("hi_tab", hi_tab, 4), ("lo_tab", lo_tab, 4)),
           scale, zero_point)
    if x.device.type == "cpu":
        return lut_gemm_dc_ref(x, w_codes, hi_tab, lo_tab, zero_point, scale)
    if cost.ACTIVE is not None:
        cost.ACTIVE.kernel("lut_gemm_dc", *_cost(x, w_codes,
                                                 cost.DC_TABLE_BYTES))
    if x.device.type == "meta":
        return _meta_out(x, w_codes)
    if x.device.type != "cuda":
        raise ValueError(f"lut_gemm_dc runs on cuda, cpu or meta, not "
                         f"{x.device}")
    out, tc = _launch_dc(x, w_codes, scale, hi_tab, lo_tab, None,
                         zero_point)
    lut_gemm_dc.launches += 1
    lut_gemm_dc.launches_tc += tc
    return out


def lut_gemm_dc_res(x: torch.Tensor, w_codes: torch.Tensor,
                    hi_tab: torch.Tensor, lo_tab: torch.Tensor,
                    residual: torch.Tensor, zero_point: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``(x @ (HI[q>>2] + LO[q&3] + RES[q] - zp)) * scale`` -> (M, N) f32.

    As :func:`lut_gemm_dc` plus residual: (16,) f32 per-code correction
    (zeros at pruned codes).
    """
    _check(x, w_codes, (("hi_tab", hi_tab, 4), ("lo_tab", lo_tab, 4),
                        ("residual", residual, 16)), scale, zero_point)
    if x.device.type == "cpu":
        return lut_gemm_dc_res_ref(x, w_codes, hi_tab, lo_tab, residual,
                                   zero_point, scale)
    if cost.ACTIVE is not None:
        cost.ACTIVE.kernel("lut_gemm_dc_res", *_cost(
            x, w_codes, cost.DC_RES_TABLE_BYTES))
    if x.device.type == "meta":
        return _meta_out(x, w_codes)
    if x.device.type != "cuda":
        raise ValueError(f"lut_gemm_dc_res runs on cuda, cpu or meta, not "
                         f"{x.device}")
    out, tc = _launch_dc(x, w_codes, scale, hi_tab, lo_tab, residual,
                         zero_point)
    lut_gemm_dc_res.launches += 1
    lut_gemm_dc_res.launches_tc += tc
    return out


def lut_gemm(x: torch.Tensor, w_codes: torch.Tensor, codebook: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """``(x @ CB[q]) * scale`` -> (M, N) f32: the full 16-entry codebook.

    x: (M, K) f32/bf16; w_codes: (K, N) int8 in [0, 16); codebook: (16,)
    f32; scale: (N,) f32 per output channel.
    """
    _check(x, w_codes, (("codebook", codebook, 16),), scale)
    if x.device.type == "cpu":
        return lut_gemm_ref(x, w_codes, codebook, scale)
    if cost.ACTIVE is not None:
        cost.ACTIVE.kernel("lut_gemm", *_cost(x, w_codes,
                                              cost.FULL_TABLE_BYTES, 4))
    if x.device.type == "meta":
        return _meta_out(x, w_codes)
    if x.device.type != "cuda":
        raise ValueError(f"lut_gemm runs on cuda, cpu or meta, not "
                         f"{x.device}")
    m, k = x.shape
    aligned = (x.data_ptr() % TC_ALIGN == 0
               and w_codes.data_ptr() % TC_ALIGN == 0)
    kernel = route(m, k, w_codes.shape[1], x.dtype, aligned)
    if kernel == "fma":
        out = _launch(x, w_codes, scale, codebook=codebook)
    else:
        out = _launch_full(x, w_codes, codebook, scale, kernel)
    lut_gemm.launches += 1
    lut_gemm.launches_tc += kernel == "tc"
    lut_gemm.launches_wgmma += kernel == "wgmma"
    return out


lut_gemm_dc.launches = 0
lut_gemm_dc.launches_tc = 0
lut_gemm_dc_res.launches = 0
lut_gemm_dc_res.launches_tc = 0
lut_gemm.launches = 0
lut_gemm.launches_tc = 0
lut_gemm.launches_wgmma = 0
