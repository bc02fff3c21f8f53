"""Plain PyTorch oracle for flash attention (mirrors
``repro.kernels.flash_attention.ref``): materialises the score matrix."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, causal: bool = True,
                  num_q_heads: int = 1, num_kv_heads: int = 1
                  ) -> torch.Tensor:
    """q: (B*H, S, D); k/v: (B*Hkv, S, D) -> (B*H, S, D) in q's dtype.

    Head h of batch b reads kv head b*Hkv + h // (H/Hkv).  f32 scores
    times ``sm_scale``, the causal mask at -1e30, softmax, then P @ V in
    f32.
    """
    bh, s, d = q.shape
    b = bh // num_q_heads
    group = num_q_heads // num_kv_heads
    qq = q.reshape(b, num_kv_heads, group, s, d).float()
    kk = k.reshape(b, num_kv_heads, 1, s, d).float()
    vv = v.reshape(b, num_kv_heads, 1, s, d).float()
    scores = torch.einsum("bhgqd,bhgkd->bhgqk", qq, kk.expand(qq.shape))
    scores = scores * sm_scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhgkd->bhgqd", p, vv.expand(qq.shape))
    return out.reshape(bh, s, d).to(q.dtype)
