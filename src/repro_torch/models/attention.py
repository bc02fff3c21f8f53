"""GQA and MLA attention over a dense KV slab or a paged block pool
(mirrors ``repro.models.attention``).

Tensor convention: activations (B, S, D); per-head tensors (B, S, H, Dh);
GQA caches are preallocated (B, S_max, Hkv, Dh) slabs, or (num_blocks,
block_size, Hkv, Dh) pools read through per-row block tables; MLA's
compressed caches have no head axis: c_kv (…, R) and the shared k_rope
(…, dr).  Unlike JAX's functional updates, the cache writes here are IN
PLACE (``index_put_`` / slice assignment) and the returned cache holds the
same tensors.

Ported: the ``full`` and ``chunked`` SDPA impls with JAX's three knobs
(``attn_f32``: f32 operands, or f32 scores with P rounded to the operand
dtype before P@V; ``attn_fused_mask``: one ``where`` for scale and mask at
scalar offsets; ``attn_causal_skip``: a causal chunk reads keys up to its
own end, as JAX's unrolled chunk loop does), ``flash`` (the hand-written
kernel of ``kernels.flash_attention``, taken under JAX's condition: a
cacheless full-sequence forward), the scalar-index and per-row cache
writes, paged decode through a block table, speculation's verify
windows: S > 1 tokens a row at per-row positions with ``n_valid`` real
ones, on the slab or the pool (:class:`~repro_torch.models.common.
WindowTarget`), and whisper's bidirectional encoder (``causal=False``)
and cross-attention (``kv_x``: k/v from the encoder's output, no rope,
no cache; under ``flash`` the one-S kernel route, which takes it only
where the decoder's length equals the encoder's, as JAX's).  MLA
(DeepSeek-V2) scores the absorbed form in f32:
``q_nope·W_uk`` against c_kv plus ``q_rope`` against k_rope, then
``p·c_kv`` and ``·W_uv``, JAX's association.  Sharded decode
(``cfg.decode_attn="sharded"``, JAX's branches): a one-token decode step
under an active :func:`~repro_torch.parallel.act_sharding.
activation_sharding` context whose model axis owns the layer's cache
(:func:`~repro_torch.serve.decode_attention.owns_shard`: a one-rank axis,
or a :class:`KVShard` that ``shard_cache`` cut) runs
:mod:`repro_torch.serve.decode_attention` over the mesh's model group,
GQA in f32 or ``bf16_grouped``, MLA on the f32 absorbed ``q_nope·W_uk``
and ``·W_uv``; verify windows and prefill stay on the local path.
Tensor-parallel GQA (``GQAAttention.split``, set by
:func:`repro_torch.parallel.tensor_parallel.plan` on a sharded model):
the block computes its ``model`` shard of the heads, Megatron's
column-parallel ``wq``/``wk``/``wv`` and row-parallel ``wo``
(:meth:`GQAAttention._split_forward`); tensor-parallel MLA
(``MLAAttention.split``): its ``model`` shard of the heads, ``wq`` (or
``w_uq``), ``w_uk`` and ``w_uv`` by columns and ``wo`` by rows, the
compressed cache the same on every rank (:class:`MLAAttention`).
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
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.act_sharding import (current_mesh, model_rank,
                                               model_size)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, Hkv, Dh) [GQA] or c_kv (B, S_max, R) [MLA]
    v: torch.Tensor   # (B, S_max, Hkv, Dh) [GQA] or k_rope (B, S_max, dr)


class KVShard(KVCache):
    """A ``KVCache`` whose leaves hold this rank's shard along the model
    axis (:func:`repro_torch.serve.decode_attention.shard_cache`); the
    sharded decode takes it at any axis size."""
    __slots__ = ()


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
         chunk: int = 512, f32_operands: bool = True,
         fused_mask: bool = False, causal_skip: bool = False
         ) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Sk, Hkv, Dh) -> (B, Sq, H, Dh).

    KV heads are repeated up to H (head h reads kv head h // group), and
    scores, softmax and the P@V product run in f32.  ``f32_operands=False``
    rounds P to the operand dtype before P@V (the f32 scores are the same:
    a product of two bf16 values is exact in f32).  ``fused_mask`` masks
    with one ``where`` at scalar offsets (per-row offsets keep the bias
    add).  ``causal_skip``: with ``q_offset == 0`` each causal chunk reads
    keys up to its own end.  ``impl="flash"`` takes the flash kernel
    (forward-only) for a cacheless forward of more than one token, as JAX
    does; with a cache it runs the full path.
    """
    b, sq, h, dh = q.shape
    g = h // k.shape[2]
    if impl == "flash" and sq > 1 and kv_len is None:
        return mha(q, k, v, sm_scale=float(1.0 / dh ** 0.5), causal=causal,
                   use_flash=True)
    if impl not in ("full", "chunked", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    scale = scale.to(q.device)
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    kf, vf = k.float(), v.float()

    def masked(s, off):
        sq_c, sk_c = s.shape[-2:]
        if not fused_mask or _per_row(off, kv_len):
            return s * scale + _bias(sq_c, sk_c, off, causal, kv_len,
                                     s.device)
        rows = torch.arange(sq_c, device=s.device)[:, None] + off
        cols = torch.arange(sk_c, device=s.device)[None, :]
        ok = (rows >= cols if causal else
              torch.ones((sq_c, sk_c), dtype=torch.bool, device=s.device))
        if kv_len is not None:
            ok = ok & (cols < kv_len)
        return torch.where(ok[None, None], s * scale, -1e30)

    def attend(qc, off, kend):
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kf[:, :kend])
        p = torch.softmax(masked(s, off), dim=-1)
        if not f32_operands:
            p = p.to(k.dtype).float()
        return torch.einsum("bhqk,bkhd->bqhd", p, vf[:, :kend]).to(q.dtype)

    sk = kf.shape[1]
    if impl == "chunked" and sq > chunk and sq % chunk == 0:
        skip = (causal_skip and causal and isinstance(q_offset, int)
                and q_offset == 0)
        return torch.cat([attend(q[:, i:i + chunk], i + q_offset,
                                 i + chunk if skip else sk)
                          for i in range(0, sq, chunk)], dim=1)
    return attend(q, q_offset, sk)


def write_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor, *,
                cache_index, paged: PagedRows | None = None,
                window: WindowTarget | None = None, n_valid=None):
    """Write a step's new (B, S, ...) ``k``/``v`` leaves into ``cache`` IN
    PLACE and return what attention reads: ``(k_all, v_all, kv_len,
    q_offset)``.  ``cache_index``: a Python int (a (B, S) block at that
    offset of a slab) or a (B,) tensor of per-row depths (S must be 1
    unless ``window`` is given).  ``paged``: the step's block table and
    write targets; the leaves are then pools written at each row's logical
    depth, and attention reads the gathered logical-order view.
    ``window``: a verify window's targets (slab or pool); ``n_valid``
    (B,): its real tokens a row, the rest write nowhere (or on the garbage
    block) and are masked out through ``kv_len``.  The leaves' trailing
    shape is free: GQA's (Hkv, Dh), MLA's (R,) and (dr,)."""
    b, s = k.shape[:2]
    per_row = isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1
    if window is not None:
        write_window(cache.k, k, window)
        write_window(cache.v, v, window)
        if window.table is not None:
            k_all = paged_gather(cache.k, window.table)
            v_all = paged_gather(cache.v, window.table)
        else:
            k_all, v_all = cache.k, cache.v
        kv_len = cache_index + (s if n_valid is None else n_valid)
        return k_all, v_all, kv_len, cache_index
    if (per_row or paged is not None) and s != 1:
        raise ValueError("a multi-token per-row write needs its window "
                         "target (decode_window)")
    if paged is not None:
        # paged decode: write at the row's logical depth through the
        # table, attend over the gathered logical-order view
        paged_write(cache.k, k, paged)
        paged_write(cache.v, v, paged)
        return (paged_gather(cache.k, paged.table),
                paged_gather(cache.v, paged.table), cache_index + 1,
                cache_index)
    if per_row:
        # per-row decode: each slab row writes at its own depth
        rows = torch.arange(b, device=k.device)
        cache.k[rows, cache_index] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, cache_index] = v[:, 0].to(cache.v.dtype)
    else:
        cache.k[:, cache_index:cache_index + s] = k.to(cache.k.dtype)
        cache.v[:, cache_index:cache_index + s] = v.to(cache.v.dtype)
    return cache.k, cache.v, cache_index + s, cache_index


def gqa_heads(cfg, num_heads=None, num_kv_heads=None, head_dim=None
              ) -> tuple[int, int, int]:
    """(heads, KV heads, head dim): the overrides where given, else
    ``cfg``'s (JAX's ``gqa_attention`` keywords; the hybrid's shared block
    passes its own)."""
    return (num_heads or cfg.num_heads, num_kv_heads or cfg.num_kv_heads,
            head_dim or cfg.resolved_head_dim)


def gqa_shapes(cfg, num_heads=None, num_kv_heads=None, head_dim=None
               ) -> dict[str, tuple[int, int]]:
    d = cfg.d_model
    h, hkv, dh = gqa_heads(cfg, num_heads, num_kv_heads, head_dim)
    return {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
            "wo": (h * dh, d)}


class GQAAttention(nn.Module):
    """``num_heads``, ``num_kv_heads``, ``head_dim``: overrides of
    ``cfg``'s (the hybrid's shared block).  ``split``: None, or the
    mode of the K/V leaves that ``tensor_parallel.plan`` set
    (``tensor_parallel.LOCAL``: column shards; ``WHOLE``: whole leaves):
    the block computes its ``model`` shard of the heads
    (:meth:`_split_forward`)."""

    def __init__(self, cfg, params: dict, *, num_heads=None,
                 num_kv_heads=None, head_dim=None):
        super().__init__()
        self.cfg = cfg
        self.heads = gqa_heads(cfg, num_heads, num_kv_heads, head_dim)
        self.split = None
        for name in gqa_shapes(cfg):
            set_leaf(self, name, params[name])

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: KVCache | None = None, cache_index=None,
                paged: PagedRows | None = None,
                window: WindowTarget | None = None, n_valid=None,
                causal: bool = True, kv_x: torch.Tensor | None = None):
        """Returns (out (B, S, D), cache).  ``kv_x`` (B, Sk, D): the
        cross-attention source (the encoder's output): k and v are
        projected from it, neither q nor k is rotated, no cache is read
        or written, and attention is not causal (JAX's ``kv_x``).
        ``causal=False``: bidirectional self-attention (the encoder).
        ``cache_index``: a Python int
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
        if self.split is not None:
            return self._split_forward(x, positions, cache, cache_index,
                                       paged, window, n_valid, causal)
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, dh = self.heads
        src = x if kv_x is None else kv_x
        sk = src.shape[1]
        q = quant_matmul(x, self.wq, cfg.quant, "attn").reshape(b, s, h, dh)
        k = quant_matmul(src, self.wk, cfg.quant, "attn").reshape(
            b, sk, hkv, dh)
        v = quant_matmul(src, self.wv, cfg.quant, "attn").reshape(
            b, sk, hkv, dh)
        if kv_x is None:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

        kv_len, q_offset = None, 0
        mesh = (current_mesh() if cache is not None and kv_x is None
                and s == 1 and window is None
                and cfg.decode_attn == "sharded" else None)
        if mesh is not None:
            from repro_torch.serve import decode_attention as da
            if da.owns_shard(cache, mesh):
                out, _, _ = da.sharded_gqa_decode(
                    q, cache.k, cache.v, k, v, cache_index, mesh,
                    sm_scale=1.0 / float(dh) ** 0.5,
                    grouped_bf16=cfg.decode_attn_precision == "bf16_grouped",
                    block_table=None if paged is None else paged.table)
                out = out.reshape(b, s, h * dh)
                return quant_matmul(out, self.wo, cfg.quant, "attn"), cache
        if cache is not None and kv_x is None:
            k, v, kv_len, q_offset = write_cache(
                cache, k, v, cache_index=cache_index, paged=paged,
                window=window, n_valid=n_valid)

        out = self._sdpa(q, k, v, causal=causal and kv_x is None,
                         q_offset=q_offset, kv_len=kv_len)
        out = out.reshape(b, s, h * dh)
        return quant_matmul(out, self.wo, cfg.quant, "attn"), cache

    def _sdpa(self, q, k, v, **kw):
        cfg = self.cfg
        return sdpa(q, k, v, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                    f32_operands=cfg.attn_f32,
                    fused_mask=cfg.attn_fused_mask,
                    causal_skip=cfg.attn_causal_skip, **kw)

    def _split_forward(self, x, positions, cache, cache_index, paged,
                       window, n_valid, causal):
        """The block split over the mesh's model axis (Megatron's
        attention): ``x`` enters through ``tensor_parallel.copy``; ``wq``
        holds this rank's heads' columns and ``wo`` their rows, whose
        partial output ``tensor_parallel.reduce`` sums.  Cacheless, the
        rank attends over its own heads: K/V from its column shards
        (whole KV heads), or, where the KV heads do not divide the axis,
        the KV heads its query heads read, projected from the whole
        ``wk``/``wv``.  With a cache (prefill, the decode step, verify
        windows) q/k/v are gathered to every head first
        (``tensor_parallel.gather``, fresh tensors: the cache write never
        aliases them), the step runs as unsplit on the cache's layout
        (the sharded decode's: sequence-sharded, all heads), and the rank
        keeps its heads of the output for ``wo``."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, dh = self.heads
        m, r = model_size(), model_rank()
        hq = h // m
        kv_shard = self.split == tp.LOCAL
        x = tp.copy(x)

        def proj(w, split_k=False):
            return quant_matmul(x, w, cfg.quant, "attn", split_k)
        if cache is None:
            q = proj(self.wq).reshape(b, s, hq, dh)
            if kv_shard:
                k, v = (proj(w).reshape(b, s, hkv // m, dh)
                        for w in (self.wk, self.wv))
            else:
                # the KV heads this rank's query heads read
                g = h // hkv
                lo, hi = r * hq // g, ((r + 1) * hq - 1) // g + 1
                cols = slice(lo * dh, hi * dh)
                k, v = (proj(w[:, cols]).reshape(b, s, hi - lo, dh)
                        for w in (self.wk, self.wv))
                if hq % g and g % hq:     # the heads straddle groups
                    idx = (torch.arange(r * hq, (r + 1) * hq,
                                        device=x.device) // g - lo)
                    k, v = k.index_select(2, idx), v.index_select(2, idx)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            out = self._sdpa(q, k, v, causal=causal).reshape(b, s, hq * dh)
            return tp.reduce(quant_matmul(out, self.wo, cfg.quant, "attn",
                                          True)), cache

        q = tp.gather(proj(self.wq)).reshape(b, s, h, dh)
        k, v = ((tp.gather(proj(w)) if kv_shard else proj(w))
                .reshape(b, s, hkv, dh) for w in (self.wk, self.wv))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        mesh = (current_mesh() if s == 1 and window is None
                and cfg.decode_attn == "sharded" else None)
        out = None
        if mesh is not None:
            from repro_torch.serve import decode_attention as da
            if da.owns_shard(cache, mesh):
                out, _, _ = da.sharded_gqa_decode(
                    q, cache.k, cache.v, k, v, cache_index, mesh,
                    sm_scale=1.0 / float(dh) ** 0.5,
                    grouped_bf16=cfg.decode_attn_precision == "bf16_grouped",
                    block_table=None if paged is None else paged.table)
        if out is None:
            k, v, kv_len, q_offset = write_cache(
                cache, k, v, cache_index=cache_index, paged=paged,
                window=window, n_valid=n_valid)
            out = self._sdpa(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
        out = out.reshape(b, s, h * dh)[..., r * hq * dh:(r + 1) * hq * dh]
        return tp.reduce(quant_matmul(out, self.wo, cfg.quant, "attn",
                                      True)), cache


def mla_shapes(cfg) -> dict[str, tuple[int, int]]:
    """MLA's projections (JAX's ``init_mla``): q through ``wq``, or
    ``w_dq``→``w_uq`` when ``q_lora_rank > 0``; ``w_dkv`` to c_kv and the
    shared k_rope; ``w_uk``/``w_uv`` (used reshaped, never frozen); ``wo``."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    shapes = {"w_dkv": (d, m.kv_lora_rank + m.qk_rope_dim),
              "w_uk": (m.kv_lora_rank, h * m.qk_nope_dim),
              "w_uv": (m.kv_lora_rank, h * m.v_dim),
              "wo": (h * m.v_dim, d)}
    if m.q_lora_rank:
        shapes["w_dq"] = (d, m.q_lora_rank)
        shapes["w_uq"] = (m.q_lora_rank, h * qd)
    else:
        shapes["wq"] = (d, h * qd)
    return shapes


class MLAAttention(nn.Module):
    """DeepSeek-V2's multi-head latent attention with the compressed
    cache ``KVCache(k=c_kv (…, R), v=k_rope (…, dr))`` (JAX's
    ``mla_attention``).

    ``split`` (set by ``tensor_parallel.plan``): the block computes its
    ``model`` shard of the heads.  ``x`` enters through
    ``tensor_parallel.copy``; ``wq`` (or ``w_uq`` after the whole
    ``w_dq``), ``w_uk`` and ``w_uv`` hold this rank's ``H/m`` heads'
    columns and ``wo`` their rows, whose partial output
    ``tensor_parallel.reduce`` sums.  ``w_dkv`` is whole: every rank
    computes the same compressed c_kv and k_rope, writes the same cache
    (one for every head) and attends with its own heads
    (:func:`mla_absorbed` on ``H/m`` heads).  Under
    ``decode_attn="sharded"`` the sequence-sharded cache's decode takes
    every head: ``q_abs`` and ``q_rope`` are gathered over heads first
    (``tensor_parallel.gather``), and the rank keeps its heads of the
    context for ``w_uv`` and ``wo``."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self.split = False
        for name in mla_shapes(cfg):
            set_leaf(self, name, params[name])

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: KVCache | None = None, cache_index=None,
                paged: PagedRows | None = None,
                window: WindowTarget | None = None, n_valid=None):
        """Returns (out (B, S, D), cache); the arguments as
        :meth:`GQAAttention.forward`'s."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        if self.split:
            x = tp.copy(x)
        h = cfg.num_heads // (model_size() if self.split else 1)
        nope, rank = m.qk_nope_dim, m.kv_lora_rank
        qd = nope + m.qk_rope_dim
        if m.q_lora_rank:
            q = quant_matmul(quant_matmul(x, self.w_dq, cfg.quant, "attn"),
                             self.w_uq, cfg.quant, "attn")
        else:
            q = quant_matmul(x, self.wq, cfg.quant, "attn")
        q = q.reshape(b, s, h, qd)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        dkv = quant_matmul(x, self.w_dkv, cfg.quant, "attn")
        c_kv, k_rope = dkv[..., :rank], dkv[..., rank:]
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)

        kv_len, q_offset = None, 0
        mesh = (current_mesh() if cache is not None and s == 1
                and window is None and cfg.decode_attn == "sharded"
                else None)
        if mesh is not None:
            from repro_torch.serve import decode_attention as da
            if da.owns_shard(cache, mesh):
                q_abs = torch.einsum(
                    "bqhd,rhd->bqhr", q_nope.float(),
                    self.w_uk.reshape(rank, h, nope).float())
                if self.split:
                    # the sequence-sharded cache attends every head
                    q_abs, q_rope = tp.gather(q_abs, 2), tp.gather(q_rope, 2)
                ctx_c, _, _ = da.sharded_mla_decode(
                    q_abs, q_rope.float(), cache.k, cache.v, c_kv, k_rope,
                    cache_index, mesh, sm_scale=1.0 / float(qd) ** 0.5,
                    block_table=None if paged is None else paged.table)
                if self.split:
                    r = model_rank()
                    ctx_c = ctx_c[:, :, r * h:(r + 1) * h]
                ctx = torch.einsum(
                    "bqhr,rhd->bqhd", ctx_c.float(),
                    self.w_uv.reshape(rank, h, m.v_dim).float())
                ctx = ctx.reshape(b, s, h * m.v_dim).to(x.dtype)
                return self._out(ctx), cache
        if cache is not None:
            c_kv, k_rope, kv_len, q_offset = write_cache(
                cache, c_kv, k_rope, cache_index=cache_index, paged=paged,
                window=window, n_valid=n_valid)

        ctx = mla_absorbed(cfg, self.w_uk, self.w_uv, q_nope, q_rope, c_kv,
                           k_rope, q_offset, kv_len)
        return self._out(ctx), cache

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """``wo`` on ctx (B, S, H·v): split, this rank's heads' rows and
        the ranks' partials summed."""
        out = quant_matmul(ctx, self.wo, self.cfg.quant, "attn", self.split)
        return tp.reduce(out) if self.split else out


def mla_absorbed(cfg, w_uk: torch.Tensor, w_uv: torch.Tensor,
                 q_nope: torch.Tensor, q_rope: torch.Tensor,
                 c_kv: torch.Tensor, k_rope: torch.Tensor, q_offset,
                 kv_len) -> torch.Tensor:
    """MLA's attention in the absorbed form, in f32: scores ``q_nope·W_uk``
    against c_kv plus ``q_rope`` against k_rope, softmax, ``p·c_kv`` then
    ``·W_uv`` (JAX's association), in ``attn_chunk`` query chunks when S
    is a multiple of it.  Returns ctx (B, S, H * v_dim) in q's dtype."""
    m = cfg.mla
    b, s, h, nope = q_nope.shape
    rank, qd = m.kv_lora_rank, nope + m.qk_rope_dim
    # q_nope^T (W_uk c) == (q_nope W_uk^T)^T c
    sk = c_kv.shape[1]
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(),
                         w_uk.reshape(rank, h, nope).float())
    q_r = q_rope.float()
    c_f, r_f = c_kv.float(), k_rope.float()
    dev = q_nope.device
    inv_sqrt = (1.0 / torch.sqrt(torch.tensor(
        float(qd), dtype=torch.float32))).to(dev)

    def chunk(qa, qr, off):
        s_c = torch.einsum("bqhr,bkr->bhqk", qa, c_f)
        s_r = torch.einsum("bqhd,bkd->bhqk", qr, r_f)
        bias = _bias(qa.shape[1], sk, off, True, kv_len, dev)
        if bias.ndim == 2:            # scalar offsets: broadcast (B, H)
            bias = bias[None, None]
        p = torch.softmax((s_c + s_r) * inv_sqrt + bias, dim=-1)
        return torch.einsum("bhqk,bkr->bqhr", p, c_f)        # (B, cq, H, R)

    cq = cfg.attn_chunk
    if s > cq and s % cq == 0:
        ctx_c = torch.cat([chunk(q_abs[:, i:i + cq], q_r[:, i:i + cq],
                                 i + q_offset) for i in range(0, s, cq)],
                          dim=1)
    else:
        ctx_c = chunk(q_abs, q_r, q_offset)
    ctx = torch.einsum("bqhr,rhd->bqhd", ctx_c,
                       w_uv.reshape(rank, h, m.v_dim).float())
    return ctx.reshape(b, s, h * m.v_dim).to(q_nope.dtype)
