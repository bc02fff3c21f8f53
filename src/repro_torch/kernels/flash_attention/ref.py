"""Plain PyTorch oracle for flash attention (mirrors
``repro.kernels.flash_attention.ref``): materialises the score matrix.

:func:`attention_ref` with its defaults is JAX's oracle.  With
``p_dtype=torch.bfloat16`` it is the plain version of a kernel that rounds
the softmax numerator to bf16 before the P V product
(:func:`attention_ref_tiled`).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _grouped(q, k, v, num_q_heads, num_kv_heads):
    """q, k, v as f32 (B, Hkv, group, S, D); k/v expanded over the group
    without copying."""
    bh, s, d = q.shape
    b = bh // num_q_heads
    group = num_q_heads // num_kv_heads
    qq = q.reshape(b, num_kv_heads, group, s, d).float()
    kk = k.reshape(b, num_kv_heads, 1, s, d).float().expand(qq.shape)
    vv = v.reshape(b, num_kv_heads, 1, s, d).float().expand(qq.shape)
    return qq, kk, vv


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, causal: bool = True,
                  num_q_heads: int = 1, num_kv_heads: int = 1,
                  p_dtype: torch.dtype | None = None,
                  block_k: int | None = None) -> torch.Tensor:
    """q: (B*H, S, D); k/v: (B*Hkv, S, D) -> (B*H, S, D) in q's dtype.

    Head h of batch b reads kv head b*Hkv + h // (H/Hkv).  f32 scores
    times ``sm_scale``, the causal mask at -1e30, softmax, then P @ V in
    f32.  ``p_dtype`` (and ``block_k``) select the rounded-numerator
    variant, :func:`attention_ref_tiled`; the default is JAX's oracle.
    """
    if p_dtype is not None:
        out, _ = attention_ref_tiled(
            q, k, v, sm_scale=sm_scale, causal=causal,
            num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            p_dtype=p_dtype, block_k=block_k)
        return out.to(q.dtype)
    bh, s, d = q.shape
    qq, kk, vv = _grouped(q, k, v, num_q_heads, num_kv_heads)
    scores = torch.einsum("bhgqd,bhgkd->bhgqk", qq, kk)
    scores = scores * sm_scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhgkd->bhgqd", p, vv)
    return out.reshape(bh, s, d).to(q.dtype)


def _ulp(p: torch.Tensor, p_dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``p_dtype`` at each (normal, non-negative) f32 ``p``."""
    _, e = torch.frexp(p)                  # p = f * 2^e, f in [0.5, 1)
    return torch.ldexp(torch.full_like(p, torch.finfo(p_dtype).eps), e - 1)


def attention_ref_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sm_scale: float, causal: bool = True,
                        num_q_heads: int = 1, num_kv_heads: int = 1,
                        p_dtype: torch.dtype = torch.bfloat16,
                        block_k: int | None = None, flip_eta: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The online softmax of a flash kernel that rounds P, in plain f32.

    Over KV tiles of ``block_k`` keys (the whole row when None), in order:
    f32 scores times ``sm_scale``, the causal mask at -1e30 and columns
    past S absent; the running max ``m``; ``p = exp(s - m)`` in f32;
    ``l = l * corr + sum(p)`` from the f32 ``p``; ``acc = acc * corr +
    round(p) @ v`` with ``round`` to nearest ``p_dtype``; ``corr =
    exp(m_prev - m_new)``; ``o = acc / max(l, 1e-30)``.  Returns ``(o,
    flips)``, both f32 (B*H, S, D): ``flips`` bounds what a kernel of the
    same arithmetic can differ by through roundings of ``p`` that its own
    f32 ``s``, ``m`` and ``exp`` send the other way: the sum over the terms
    whose f32 ``p`` lies within ``flip_eta * p`` of a rounding midpoint of
    one ``p_dtype`` ulp of ``p`` times ``|v| * corr / l`` (0 when
    ``flip_eta`` is 0).
    """
    bh, s, d = q.shape
    qq, kk, vv = _grouped(q, k, v, num_q_heads, num_kv_heads)
    bk = s if block_k is None else block_k
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full(qq.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qq.shape, device=q.device)
    flips = torch.zeros_like(acc)
    for k0 in range(0, s, bk):
        kt, vt = kk[..., k0:k0 + bk, :], vv[..., k0:k0 + bk, :]
        st = torch.einsum("bhgqd,bhgkd->bhgqk", qq, kt) * sm_scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[-2], device=q.device)
            st = torch.where(cols[None, :] <= rows, st, NEG_INF)
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pr = p.to(p_dtype).float()
        acc = acc * corr + torch.einsum("bhgqk,bhgkd->bhgqd", pr, vt)
        if flip_eta:
            ulp = _ulp(p, p_dtype)
            near = (0.5 * ulp - (p - pr).abs()) <= flip_eta * p
            amb = torch.where(near & (p > 0), ulp, 0.0)
            flips = flips * corr + torch.einsum("bhgqk,bhgkd->bhgqd", amb,
                                                vt.abs())
        m = m_new
    den = l.clamp_min(1e-30)
    return (acc / den).reshape(bh, s, d), (flips / den).reshape(bh, s, d)
