"""Wrapper of the hand-written Hopper flash-attention kernel.

:func:`flash_attention` — the online-softmax attention forward over q
(B*H, S, D) against k/v (B*Hkv, S, D), GQA without repeating K/V.
Replaces the Pallas ``repro/kernels/flash_attention/flash_attention.py:70
flash_attention``.

A CUDA tensor launches the kernel (``csrc/flash_attention.cu``, built on
first use) on ``torch.cuda.current_stream()``, or the call raises; a CPU
tensor takes the plain version
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`.  Nothing
falls back.  ``flash_attention.launches`` counts kernel launches.  The
kernel is forward-only, as the TPU kernel is: it has no backward.

Tolerance of kernel against plain version (``attention_ref`` on the same
input values taken in f32, so its output is f32 and unrounded; see
:func:`tolerance`): ``F32_TOL`` = 2e-5 rtol and atol for f32 inputs (the
bound of JAX's ``test_flash_vs_ref``: both sum the same f32 products in
different orders, and the kernel's exp is ``expf``).  For bf16 inputs the
kernel's output is rounded to bf16 once, to nearest, which adds at most
half a bf16 ulp, 2^-8 of the magnitude: ``BF16_RTOL`` = 4e-3 (2^-8 +
``F32_TOL``), ``BF16_ATOL`` = ``F32_TOL``.  A store that truncates instead
overshoots that by up to another half ulp.  ``BF16_TOL`` = 2e-2 is JAX's
``test_flash_bf16`` bound, bf16 inputs against the f32 reference on the
f32 values they were rounded from (input rounding included).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

F32_TOL = 2e-5
BF16_RTOL = 4e-3
BF16_ATOL = F32_TOL
BF16_TOL = 2e-2

#: head widths the kernel is instantiated for (JAX's test widths and
#: yi-9b's 128)
HEAD_DIMS = (16, 32, 64, 128)
#: query rows per block (mirrors BQ in csrc/flash_attention.cu)
BLOCK_Q = 64
_DTYPES = (torch.float32, torch.bfloat16)


def tolerance(dtype: torch.dtype) -> dict:
    """``rtol``/``atol`` of the kernel's output on ``dtype`` inputs against
    ``attention_ref`` on the same values taken in f32."""
    if dtype == torch.bfloat16:
        return {"rtol": BF16_RTOL, "atol": BF16_ATOL}
    return {"rtol": F32_TOL, "atol": F32_TOL}


def _lib():
    """The built library, its entry point typed on first use."""
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


def _launch(q, k, v, sm_scale, causal, num_q_heads, num_kv_heads):
    bh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"not {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous operands")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d,
            num_q_heads, num_kv_heads, float(sm_scale), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = True, num_q_heads: int,
                    num_kv_heads: int) -> torch.Tensor:
    """q: (B*H, S, D); k/v: (B*Hkv, S, D), f32 or bf16 -> (B*H, S, D) in
    q's dtype.  Forward only: autograd does not see through it."""
    _check(q, k, v, num_q_heads, num_kv_heads)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                             num_q_heads=num_q_heads,
                             num_kv_heads=num_kv_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    out = _launch(q, k, v, sm_scale, causal, num_q_heads, num_kv_heads)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
