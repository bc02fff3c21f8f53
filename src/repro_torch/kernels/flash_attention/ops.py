"""Public attention entry point (mirrors
``repro.kernels.flash_attention.ops``): the flash kernel or the plain
oracle.

``mha`` takes JAX's (B, S, H, D) layout, transposes and flattens to
(B*H, S, D) as JAX does, and returns (B, S, H, D).  ``use_flash=True``
sends CUDA tensors to the hand-written kernels and CPU tensors to their
plain version (as JAX runs its Pallas kernel in interpret mode on the
CPU; see ``flash_attention.flash_attention``); ``use_flash=False`` always
takes ``attention_ref``, JAX's oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def check_tiling(s: int) -> None:
    """JAX's flash wrapper tiles S by bq = min(256, S) and bkv = min(512,
    S) and asserts both divide S; the port takes the same inputs."""
    if s % min(256, s) or s % min(512, s):
        raise ValueError(
            f"flash attention needs S divisible by min(256, S) and "
            f"min(512, S) (JAX's tiling), got S = {s}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        sm_scale: float, causal: bool = True, use_flash: bool = False
        ) -> torch.Tensor:
    """Multi-head attention with GQA.

    q: (B, S, H, D); k/v: (B, S, Hkv, D) -> (B, S, H, D).  k/v of
    another length raise ``TypeError``, as JAX's reshape of k/v to the
    query's length does (whisper's cross-attention under ``flash``).  The
    flash route is forward-only: under autograd (grad enabled and q, k or
    v requiring grad) it raises, as ``jax.grad`` through JAX's kernel
    fails; training uses ``attn_impl="full"`` or ``"chunked"``.
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[1] != s or v.shape[1] != s:
        raise TypeError(
            f"cannot reshape k/v of length {k.shape[1]} to the query's "
            f"length {s}: attention here takes one S (JAX's mha)")
    if use_flash:
        check_tiling(s)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "flash attention is forward-only: JAX's flash_attention "
                "kernel has no backward; train with attn_impl='full' or "
                "'chunked'")
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * hkv, s, d)
    vf = v.transpose(1, 2).reshape(b * hkv, s, d)
    fn = flash_attention if use_flash else attention_ref
    out = fn(qf, kf, vf, sm_scale=sm_scale, causal=causal, num_q_heads=h,
             num_kv_heads=hkv)
    return out.reshape(b, h, s, d).transpose(1, 2)
