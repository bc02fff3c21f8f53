"""GQA attention over a dense KV slab or a paged block pool (mirrors
``repro.models.attention``).

Tensor convention: activations (B, S, D); per-head tensors (B, S, H, Dh);
KV caches are preallocated (B, S_max, Hkv, Dh) slabs, or (num_blocks,
block_size, Hkv, Dh) pools read through per-row block tables.  Unlike
JAX's functional updates, the cache writes here are IN PLACE
(``index_put_`` / slice assignment) and the returned cache holds the same
tensors.

Ported: the ``full`` and ``chunked`` SDPA impls with f32 operands (JAX's
default ``attn_f32=True``), ``flash`` (the hand-written kernel of
``kernels.flash_attention``, taken under JAX's condition: a cacheless
full-sequence forward), the scalar-index and per-row cache writes, paged
decode through a block table, and speculation's verify windows: S > 1
tokens a row at per-row positions with ``n_valid`` real ones, on the slab
or the pool (:class:`~repro_torch.models.common.WindowTarget`).  Sharded
decode is ROADMAP queue 1 item 9.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.core.layers import quant_matmul
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.common import (PagedRows, WindowTarget, apply_rope,
                                       paged_gather, paged_write, set_leaf,
                                       write_window)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, Hkv, Dh)
    v: torch.Tensor   # (B, S_max, Hkv, Dh)


def _per_row(q_offset, kv_len) -> bool:
    """True when offsets are per-row (B,) tensors (mixed-depth decode)."""
    return any(isinstance(v, torch.Tensor) and v.ndim == 1
               for v in (q_offset, kv_len))


def _bias(sq: int, sk: int, q_offset, causal: bool, kv_len=None,
          device=None) -> torch.Tensor:
    """Additive f32 mask bias (0 or -1e30; f32 keeps -1e30 finite).

    Scalar offsets -> (sq, sk); per-row (B,) ``q_offset``/``kv_len`` ->
    (B, 1, sq, sk).
    """
    cols = torch.arange(sk, device=device)
    if _per_row(q_offset, kv_len):
        off = torch.as_tensor(q_offset if q_offset is not None else 0,
                              device=device)
        rows = torch.arange(sq, device=device)[None, :, None] \
            + off.reshape(-1, 1, 1)
        ok = torch.ones((rows.shape[0], sq, sk), dtype=torch.bool,
                        device=device)
        if causal:
            ok &= rows >= cols[None, None, :]
        if kv_len is not None:
            kv = torch.as_tensor(kv_len, device=device).reshape(-1, 1, 1)
            ok &= cols[None, None, :] < kv
        return torch.where(ok, 0.0, -1e30).float()[:, None]
    rows = torch.arange(sq, device=device)[:, None] \
        + (q_offset if q_offset is not None else 0)
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= rows >= cols[None, :]
    if kv_len is not None:
        ok &= cols[None, :] < kv_len
    return torch.where(ok, 0.0, -1e30).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, q_offset=0, kv_len=None, impl: str = "chunked",
         chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Sk, Hkv, Dh) -> (B, Sq, H, Dh).

    KV heads are repeated up to H (head h reads kv head h // group), and
    scores, softmax and the P@V product run on f32 copies.  ``impl="flash"``
    takes the flash kernel (forward-only) for a cacheless forward of more
    than one token, as JAX does; with a cache it runs the full path.
    """
    b, sq, h, dh = q.shape
    g = h // k.shape[2]
    if impl == "flash" and sq > 1 and kv_len is None:
        return mha(q, k, v, sm_scale=float(1.0 / dh ** 0.5), causal=causal,
                   use_flash=True)
    if impl not in ("full", "chunked", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    kf, vf = k.float(), v.float()

    def attend(qc, off):
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kf)
        s = s * scale.to(s.device) + _bias(qc.shape[1], kf.shape[1], off,
                                           causal, kv_len, s.device)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)

    if impl == "chunked" and sq > chunk and sq % chunk == 0:
        return torch.cat([attend(q[:, i:i + chunk], i + q_offset)
                          for i in range(0, sq, chunk)], dim=1)
    return attend(q, q_offset)


def gqa_shapes(cfg) -> dict[str, tuple[int, int]]:
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    return {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
            "wo": (h * dh, d)}


class GQAAttention(nn.Module):
    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        for name in gqa_shapes(cfg):
            set_leaf(self, name, params[name])

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: KVCache | None = None, cache_index=None,
                paged: PagedRows | None = None,
                window: WindowTarget | None = None, n_valid=None):
        """Returns (out (B, S, D), cache).  ``cache_index``: a Python int
        (prefill writes a (B, S) block at that offset) or a (B,) tensor of
        per-row decode depths (S must be 1 unless ``window`` is given).
        ``paged``: the step's block table and write targets
        (:class:`PagedRows`); the cache leaves are then paged pools, the
        new K/V is written at each row's logical depth through the table
        and attention reads the gathered logical-order view.  ``window``:
        a verify window's targets (S tokens a row from ``cache_index``,
        slab or pool); ``n_valid`` (B,): its real tokens a row, the rest
        write nowhere (or on the garbage block) and are masked out of
        attention through ``kv_len``."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q = quant_matmul(x, self.wq, cfg.quant, "attn").reshape(b, s, h, dh)
        k = quant_matmul(x, self.wk, cfg.quant, "attn").reshape(b, s, hkv, dh)
        v = quant_matmul(x, self.wv, cfg.quant, "attn").reshape(b, s, hkv, dh)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        kv_len, q_offset = None, 0
        if cache is not None:
            per_row = (isinstance(cache_index, torch.Tensor)
                       and cache_index.ndim == 1)
            if window is not None:
                write_window(cache.k, k, window)
                write_window(cache.v, v, window)
                if window.table is not None:
                    k = paged_gather(cache.k, window.table)
                    v = paged_gather(cache.v, window.table)
                else:
                    k, v = cache.k, cache.v
                kv_len = cache_index + (s if n_valid is None else n_valid)
                q_offset = cache_index
            elif (per_row or paged is not None) and s != 1:
                raise ValueError("a multi-token per-row write needs its "
                                 "window target (decode_window)")
            elif paged is not None:
                # paged decode: write at the row's logical depth through
                # the table, attend over the gathered logical-order view
                paged_write(cache.k, k, paged)
                paged_write(cache.v, v, paged)
                k = paged_gather(cache.k, paged.table)
                v = paged_gather(cache.v, paged.table)
                kv_len, q_offset = cache_index + 1, cache_index
            else:
                if per_row:
                    # per-row decode: each slab row writes at its own depth
                    rows = torch.arange(b, device=x.device)
                    cache.k[rows, cache_index] = k[:, 0].to(cache.k.dtype)
                    cache.v[rows, cache_index] = v[:, 0].to(cache.v.dtype)
                else:
                    cache.k[:, cache_index:cache_index + s] = \
                        k.to(cache.k.dtype)
                    cache.v[:, cache_index:cache_index + s] = \
                        v.to(cache.v.dtype)
                k, v = cache.k, cache.v
                kv_len = cache_index + s
                q_offset = cache_index

        out = sdpa(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len,
                   impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        out = out.reshape(b, s, h * dh)
        return quant_matmul(out, self.wo, cfg.quant, "attn"), cache
