"""Wrappers of the hand-written Hopper flash-attention kernels.

:func:`flash_attention` — the online-softmax attention forward over q
(B*H, S, D) against k/v (B*Hkv, S, D), GQA without repeating K/V.
Replaces the Pallas ``repro/kernels/flash_attention/flash_attention.py:70
flash_attention``.

A CUDA tensor launches a kernel on ``torch.cuda.current_stream()``, or the
call raises; which kernel is fixed by type and head width alone
(:func:`takes_wgmma`), never by a failure:

* bf16 at D in ``TC_HEAD_DIMS`` (64, 128): the tensor-core kernel
  (``csrc/flash_attention_wgmma.cu``: wgmma on TMA-fed K/V tiles; P is
  rounded to bf16 for the P V product);
* f32, and bf16 at D in (16, 32): the SIMT kernel
  (``csrc/flash_attention.cu``: f32 FMAs).

Both build on first use.  A ``meta`` tensor (the dry run,
``repro_torch.launch.dryrun``) returns empty outputs of the kernel's shapes
and records its cost formula (``launch.cost``) without computing anything.
A CPU tensor takes the plain version of the kernel its type and width
select: ``ref.attention_ref``, with ``p_dtype=torch.bfloat16,
block_k=BLOCK_K`` for the tensor-core kernel.  Nothing falls back.
``flash_attention.launches`` counts every kernel launch,
``flash_attention.launches_tc`` those of the tensor-core kernel.  The
kernels are forward-only, as the TPU kernel is: they have no backward.

Tolerances of a kernel against its plain version (:func:`reference` gives
both, on the same input values taken in f32):

* SIMT kernel: ``attention_ref``, JAX's oracle (see :func:`tolerance`).
  ``F32_TOL`` = 2e-5 rtol and atol for f32 inputs (the bound of JAX's
  ``test_flash_vs_ref``: both sum the same f32 products in different
  orders, and the kernel's exp is ``expf``).  For bf16 inputs the output
  is rounded to bf16 once, to nearest, which adds at most half a bf16 ulp,
  2^-8 of the magnitude: ``BF16_RTOL`` = 4e-3 (2^-8 + ``F32_TOL``),
  ``BF16_ATOL`` = ``F32_TOL``.
* Tensor-core kernel: ``ref.attention_ref_tiled`` over the kernel's KV
  tiles (``BLOCK_K`` = 128 keys), which rounds p = exp(s - m) to nearest
  bf16 against the running max as the kernel does.  Its bound per element
  is ``BF16_ATOL + BF16_RTOL * |plain| + flips``: half an output ulp from
  the store and the f32 summation order, as above, plus ``flips``, the
  rare bf16 rounding of one p sent the other way because the kernel's f32
  s, m and exp (``ex2.approx``, a 2^-22 relative error) differ from the
  plain version's in the last bits: one bf16 ulp of p times |v| / l for
  each term whose f32 p lies within ``FLIP_ETA`` = 2^-16 (relative) of a
  rounding midpoint, 15x the ~1e-6 such differences reach.  A truncating
  store, a dropped KV tile or p truncated instead of rounded exceed it
  (``tests/test_torch_flash_attention.py``, on emulations).

``BF16_TOL`` = 2e-2 is JAX's ``test_flash_bf16`` bound, bf16 inputs
against the f32 reference on the f32 values they were rounded from (input
rounding included); both kernels are held to it too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_tiled)
from repro_torch.launch import cost

F32_TOL = 2e-5
BF16_RTOL = 4e-3
BF16_ATOL = F32_TOL
BF16_TOL = 2e-2
FLIP_ETA = 2.0 ** -16

#: head widths the kernels are instantiated for (JAX's test widths and
#: yi-9b's 128)
HEAD_DIMS = (16, 32, 64, 128)
#: bf16 head widths of the tensor-core kernel
TC_HEAD_DIMS = (64, 128)
#: query rows per block of the SIMT kernel (BQ in csrc/flash_attention.cu)
BLOCK_Q = 64
#: keys per KV tile of the tensor-core kernel (BK in
#: csrc/flash_attention_wgmma.cu): its running max steps per tile
BLOCK_K = 128
_DTYPES = (torch.float32, torch.bfloat16)


def takes_wgmma(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a CUDA call of this type and head width runs the
    tensor-core kernel (else the SIMT kernel)."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


def tolerance(dtype: torch.dtype) -> dict:
    """``rtol``/``atol`` of the SIMT kernel's output on ``dtype`` inputs
    against ``attention_ref`` on the same values taken in f32."""
    if dtype == torch.bfloat16:
        return {"rtol": BF16_RTOL, "atol": BF16_ATOL}
    return {"rtol": F32_TOL, "atol": F32_TOL}


def reference(q, k, v, *, sm_scale: float, causal: bool = True,
              num_q_heads: int, num_kv_heads: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(plain, bound)``: the plain version of the kernel that takes this
    call (on the same input values in f32) and the largest ``|kernel -
    plain|`` its stated tolerance allows, per element; both f32."""
    kw = dict(sm_scale=sm_scale, causal=causal, num_q_heads=num_q_heads,
              num_kv_heads=num_kv_heads)
    qf, kf, vf = q.float(), k.float(), v.float()
    if takes_wgmma(q.dtype, q.shape[-1]):
        plain, flips = attention_ref_tiled(
            qf, kf, vf, p_dtype=torch.bfloat16, block_k=BLOCK_K,
            flip_eta=FLIP_ETA, **kw)
        return plain, BF16_ATOL + BF16_RTOL * plain.abs() + flips
    plain = attention_ref(qf, kf, vf, **kw)
    tol = tolerance(q.dtype)
    return plain, tol["atol"] + tol["rtol"] * plain.abs()


def tolerance_share(got: torch.Tensor, plain: torch.Tensor,
                    bound: torch.Tensor) -> float:
    """max ``|got - plain| / bound``: above 1 fails the stated tolerance."""
    return ((got.float() - plain).abs() / bound).max().item()


def _lib():
    """The SIMT kernel's library, its entry point typed on first use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [p] * 4 + [i] * 5 + [ctypes.c_float, i, i, p])
        lib.flash_attention_launch.restype = ctypes.c_int
        if lib.flash_attention_block_q() != BLOCK_Q:
            raise RuntimeError("flash_attention.cu's block size differs "
                               "from the wrapper's")
    return lib


def _tc_lib():
    """The tensor-core kernel's library, typed on first use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("flash_attention_wgmma")
    if lib.flash_attention_wgmma_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_wgmma_launch.argtypes = (
            [p] * 4 + [i] * 5 + [ctypes.c_float, i, p])
        lib.flash_attention_wgmma_launch.restype = ctypes.c_int
        if lib.flash_attention_wgmma_block_k() != BLOCK_K:
            raise RuntimeError("flash_attention_wgmma.cu's KV tile differs "
                               "from the wrapper's")
    return lib


def _check(q, k, v, num_q_heads, num_kv_heads):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B*H,S,D), (B*Hkv,S,D)")
    bh, s, d = q.shape
    if num_q_heads < 1 or num_kv_heads < 1 or bh % num_q_heads \
            or num_q_heads % num_kv_heads:
        raise ValueError(f"{num_kv_heads} kv heads must divide "
                         f"{num_q_heads} query heads, which divide B*H = "
                         f"{bh}")
    want = (bh // num_q_heads * num_kv_heads, s, d)
    if tuple(k.shape) != want:
        raise ValueError(f"k/v must be {want}, got {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{ {q.device, k.device, v.device} }")


def _launch(q, k, v, sm_scale, causal, num_q_heads, num_kv_heads, tc):
    bh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"not {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous operands")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    args = (bh, s, d, num_q_heads, num_kv_heads, float(sm_scale),
            int(causal))
    with torch.cuda.device(q.device):
        if tc:
            err = _tc_lib().flash_attention_wgmma_launch(*ptrs, *args,
                                                         stream)
        else:
            err = _lib().flash_attention_launch(
                *ptrs, *args, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {'wgmma' if tc else 'SIMT'} "
                           f"kernel launch failed: cudaError_t {err}")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = True, num_q_heads: int,
                    num_kv_heads: int) -> torch.Tensor:
    """q: (B*H, S, D); k/v: (B*Hkv, S, D), f32 or bf16 -> (B*H, S, D) in
    q's dtype.  Forward only: autograd does not see through it."""
    _check(q, k, v, num_q_heads, num_kv_heads)
    tc = takes_wgmma(q.dtype, q.shape[-1])
    if q.device.type == "cpu":
        rounded = dict(p_dtype=torch.bfloat16, block_k=BLOCK_K) if tc else {}
        return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                             num_q_heads=num_q_heads,
                             num_kv_heads=num_kv_heads, **rounded)
    if cost.ACTIVE is not None:
        bh, s, d = q.shape
        cost.ACTIVE.kernel("flash_attention", *cost.flash_cost(
            bh // num_q_heads, s, num_q_heads, num_kv_heads, d,
            q.element_size(), causal))
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    out = _launch(q, k, v, sm_scale, causal, num_q_heads, num_kv_heads, tc)
    flash_attention.launches += 1
    flash_attention.launches_tc += tc
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
