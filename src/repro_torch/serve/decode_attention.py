"""Sharded decode attention: flash-decode over the mesh's model group
(mirrors ``repro.serve.decode_attention``).

Each rank of the model axis owns a contiguous part of the cache, writes
the new token's K/V only where it lands in that part, computes the
online-softmax partials (m, l, o) over it, and the ranks combine them with
three small all-reduces of (B, H, ·) statistics over the **model** group
(:func:`_combine`): ``all_reduce(MAX)`` of m, then ``all_reduce(SUM)`` of
``l·corr`` and of ``o·corr``.  The collectives run at any group size,
one rank included, so a one-card mesh runs the real path.

**Layout contract.**  JAX's ``shard_map`` cuts global arrays; here each
rank holds only its own shard, and :func:`shard_cache` cuts a whole
cache (for example one a replicated prefill wrote) into it:

* dense mode: the cache leaves are (B / data, S / model, ...): this
  rank's batch rows (its coordinate on the batch axes) and its
  contiguous columns; q and the new K/V hold the same rows;
* paged mode (``block_table`` given): the leaves are pools of
  (num_blocks / model, block_size, ...): this rank's contiguous blocks,
  with every row on every rank (JAX replicates the batch-shaped inputs
  in paged mode: the pool is shared state, so every rank applies every
  row's write that lands in its blocks).

``index`` (a position in the whole sequence: an int, or a (B,) tensor of
the rank's rows) and ``block_table`` (global physical block ids) stay
global.  Where the model axis does not divide a cache's axis, JAX keeps
the dense path (``repro.models.attention``); :func:`shard_cache` then
leaves the leaf whole (a plain ``KVCache``), and the models take the dense
path for it.  A one-rank model axis owns every leaf whole.

**Writes are in place**, as every cache write of the port: the rank
whose part holds the new token writes that one row; no cache is copied
(JAX's ``jnp.where(in_range, updated, cache)`` reads as a copy).

``grouped_bf16`` (``decode_attn_precision="bf16_grouped"``): GQA-grouped
products on the cache-dtype operands with f32 accumulation (JAX's
``preferred_element_type=f32``), no K/V repeat and no f32 copy of the
cache; P is rounded to the cache dtype before P·V.  The products are
``torch.bmm``: JAX computes them with ``dot_general`` outside any Pallas
kernel.  On CUDA ``torch.bmm(..., out_dtype=torch.float32)``; the CPU
build has no such kernel, so there both operands are cast to f32, which is
exact (a product of two bf16 values fits f32).

``sharded_gqa_decode.calls``, ``sharded_mla_decode.calls`` and
``all_reduce.calls`` count the calls made, as the kernels' ``launches``.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.device import takes_kernels
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.attention import KVCache, KVShard

NEG = -1e30


def _counted(fn):
    """``fn`` with a ``calls`` counter that each call adds one to (kept on
    the returned function itself, so a caller that wraps the module's
    name, as a profiler range does, leaves it counting)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        run.calls += 1
        return fn(*args, **kwargs)
    run.calls = 0
    return run


@_counted
def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def _model_axis(mesh) -> tuple[int, int, object]:
    """(model axis size, this rank's coordinate on it, its group)."""
    return (mesh.shape["model"], mesh.coords["model"],
            mesh.groups["model"])


def _local_update(cache: torch.Tensor, new: torch.Tensor, index, rank: int,
                  s_shard: int) -> torch.Tensor:
    """Write ``new`` (B, 1, ...) into the rank-local slice (B, s_shard,
    ...) at global ``index``, IN PLACE.  ``index``: an int (every row at
    one depth; written only by the rank that owns the column) or a (B,)
    tensor (each row at its own depth: a row whose column another rank
    owns writes back the value it read, at a clamped column, with no host
    synchronisation; the rows are distinct, so no two writes meet)."""
    if isinstance(index, torch.Tensor) and index.ndim == 1:
        li = index.long() - rank * s_shard
        keep = (li >= 0) & (li < s_shard)
        li = li.clamp(0, s_shard - 1)
        rows = torch.arange(cache.shape[0], device=cache.device)
        cur = cache[rows, li]
        keep = keep.reshape((-1,) + (1,) * (cur.ndim - 1))
        cache[rows, li] = torch.where(keep, new[:, 0].to(cache.dtype), cur)
        return cache
    li = int(index) - rank * s_shard
    if 0 <= li < s_shard:
        cache[:, li] = new[:, 0].to(cache.dtype)
    return cache


def _paged_local_update(pool: torch.Tensor, new: torch.Tensor,
                        phys: torch.Tensor, off: torch.Tensor, rank: int,
                        nb_shard: int, msize: int) -> torch.Tensor:
    """Write ``new`` (B, 1, ...) into the rank-local block slice IN PLACE.

    ``phys``/``off``: (B,) GLOBAL physical block id and in-block offset of
    each row's write.  One rank owns every block; with more, only the rows
    whose block this rank owns write (selected on the host: a clamped
    target could meet an owned row's, and which of two writes to one
    element wins is unspecified).  Rows parked on the garbage block all
    write there, as :func:`~repro_torch.models.common.paged_write`'s."""
    if msize == 1:
        pool[phys, off] = new[:, 0].to(pool.dtype)
        return pool
    local = phys - rank * nb_shard
    sel = ((local >= 0) & (local < nb_shard)).nonzero()[:, 0]
    pool[local[sel], off[sel]] = new[sel, 0].to(pool.dtype)
    return pool


def _paged_local_view(pool: torch.Tensor, block_table: torch.Tensor,
                      rank: int, nb_shard: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's logical-order view gathered from the rank-local block
    slice: (view (B, nblk * bs, ...), owned (B, nblk * bs) bool).  Columns
    in blocks another rank owns gather a clamped block and are masked."""
    bs = pool.shape[1]
    local = block_table.long() - rank * nb_shard          # (B, nblk)
    owned = (local >= 0) & (local < nb_shard)
    g = pool[local.clamp(0, nb_shard - 1)]                # (B, nblk, bs, ...)
    view = g.reshape((block_table.shape[0], -1) + tuple(pool.shape[2:]))
    return view, owned.repeat_interleave(bs, dim=1)


def _valid_cols(cols: torch.Tensor, idx) -> torch.Tensor:
    """(B or 1, 1, Ss) bool mask of cache columns at or before ``idx``."""
    if isinstance(idx, torch.Tensor) and idx.ndim == 1:
        return cols[None, None, :] <= idx[:, None, None]
    return cols[None, None, :] <= idx


def _combine(m_loc, l_loc, o_loc, dtype, group) -> torch.Tensor:
    """One small cross-rank combine of the online-softmax partials over
    the model ``group``: three all-reduces.  Returns (B, 1, H, ·)."""
    m = all_reduce(m_loc.clone(), dist.ReduceOp.MAX, group)
    corr = torch.exp(m_loc - m)
    denom = all_reduce(l_loc * corr, dist.ReduceOp.SUM, group)
    o = all_reduce(o_loc * corr, dist.ReduceOp.SUM, group)
    return (o / torch.clamp_min(denom, 1e-30)).to(dtype)[:, None]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with f32 results, f32 accumulation."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if takes_kernels(a):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _gqa_partials(q, k_c, v_c, ok, *, g: int, sm_scale: float,
                  grouped_bf16: bool):
    """Rank-local online-softmax partials over a (B, Ss, Hkv, dh) KV view.

    ``ok``: (B or 1, 1, Ss) bool validity of each column.  Returns (m_loc,
    l_loc, o_loc): (B, H, 1), (B, H, 1), (B, H, dh), f32."""
    b, _, h, dh = q.shape
    s_len, hkv = k_c.shape[1], k_c.shape[2]
    if grouped_bf16:
        qg = q[:, 0].reshape(b * hkv, g, dh)
        kg = k_c.transpose(1, 2).reshape(b * hkv, s_len, dh)
        s_loc = _bmm_f32(qg, kg.transpose(1, 2)) * sm_scale
        s_loc = s_loc.reshape(b, h, s_len)
    else:
        kf = torch.repeat_interleave(k_c, g, dim=2).float()
        s_loc = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kf) * sm_scale
    s_loc = torch.where(ok, s_loc, NEG)
    m_loc = s_loc.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s_loc - m_loc), 0.0)
    l_loc = p.sum(dim=-1, keepdim=True)
    if grouped_bf16:
        pg = p.reshape(b * hkv, g, s_len).to(k_c.dtype)
        vg = v_c.transpose(1, 2).reshape(b * hkv, s_len, dh)
        o_loc = _bmm_f32(pg, vg).reshape(b, h, dh)
    else:
        vf = torch.repeat_interleave(v_c, g, dim=2).float()
        o_loc = torch.einsum("bhk,bkhd->bhd", p, vf)
    return m_loc, l_loc, o_loc


def _paged_rows(block_table, index, bs: int, b: int, device):
    """(B,) positions, physical blocks and offsets of the rows' writes."""
    idx = (index.long() if isinstance(index, torch.Tensor)
           else torch.full((b,), int(index), dtype=torch.long,
                           device=device))
    idx = idx.expand(b)
    rows = torch.arange(b, device=device)
    return idx, block_table[rows, idx // bs].long(), idx % bs


@_counted
def sharded_gqa_decode(q, k_cache, v_cache, k_new, v_new, index, mesh, *,
                       sm_scale: float, grouped_bf16: bool = False,
                       block_table=None):
    """q: (B, 1, H, dh); k_new/v_new: (B, 1, Hkv, dh); the caches this
    rank's shard (the module's layout contract): dense (B, S_shard, Hkv,
    dh), or paged pools (num_blocks_shard, bs, Hkv, dh) with
    ``block_table`` (B, nblk).  Writes the new K/V in place and returns
    (out (B, 1, H, dh), k_cache, v_cache)."""
    msize, rank, group = _model_axis(mesh)
    b, h = q.shape[0], q.shape[2]
    g = h // k_new.shape[2]
    if block_table is not None:
        nb_shard, bs = k_cache.shape[0], k_cache.shape[1]
        idx, phys, off = _paged_rows(block_table, index, bs, b, q.device)
        _paged_local_update(k_cache, k_new, phys, off, rank, nb_shard, msize)
        _paged_local_update(v_cache, v_new, phys, off, rank, nb_shard, msize)
        k_c, owned = _paged_local_view(k_cache, block_table, rank, nb_shard)
        v_c, _ = _paged_local_view(v_cache, block_table, rank, nb_shard)
        cols = torch.arange(k_c.shape[1], device=q.device)
        ok = (owned & (cols[None, :] <= idx[:, None]))[:, None]
    else:
        s_shard = k_cache.shape[1]
        _local_update(k_cache, k_new, index, rank, s_shard)
        _local_update(v_cache, v_new, index, rank, s_shard)
        k_c, v_c = k_cache, v_cache
        cols = rank * s_shard + torch.arange(s_shard, device=q.device)
        ok = _valid_cols(cols, index)
    m_loc, l_loc, o_loc = _gqa_partials(q, k_c, v_c, ok, g=g,
                                        sm_scale=sm_scale,
                                        grouped_bf16=grouped_bf16)
    return _combine(m_loc, l_loc, o_loc, q.dtype, group), k_cache, v_cache



def _mla_partials(qa, qr, c_c, r_c, ok, *, sm_scale: float):
    """Rank-local partials over a (B, Ss, R) / (B, Ss, dr) compressed
    view, in f32."""
    cf, rf = c_c.float(), r_c.float()
    s_loc = (torch.einsum("bhr,bkr->bhk", qa[:, 0].float(), cf)
             + torch.einsum("bhd,bkd->bhk", qr[:, 0].float(), rf)) * sm_scale
    s_loc = torch.where(ok, s_loc, NEG)
    m_loc = s_loc.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s_loc - m_loc), 0.0)
    l_loc = p.sum(dim=-1, keepdim=True)
    o_loc = torch.einsum("bhk,bkr->bhr", p, cf)            # (B, H, R)
    return m_loc, l_loc, o_loc


@_counted
def sharded_mla_decode(q_abs, q_rope, c_cache, r_cache, c_new, r_new, index,
                       mesh, *, sm_scale: float, block_table=None):
    """MLA's absorbed-form decode over the compressed cache's shard.

    q_abs: (B, 1, H, R); q_rope: (B, 1, H, dr); dense mode: c_cache (B,
    S_shard, R) / r_cache (B, S_shard, dr); paged mode: pools
    (num_blocks_shard, bs, R) / (…, dr).  Writes the new entries in place
    and returns (ctx_c (B, 1, H, R), c_cache, r_cache)."""
    msize, rank, group = _model_axis(mesh)
    b = q_abs.shape[0]
    if block_table is not None:
        nb_shard, bs = c_cache.shape[0], c_cache.shape[1]
        idx, phys, off = _paged_rows(block_table, index, bs, b,
                                     q_abs.device)
        _paged_local_update(c_cache, c_new, phys, off, rank, nb_shard, msize)
        _paged_local_update(r_cache, r_new, phys, off, rank, nb_shard, msize)
        c_c, owned = _paged_local_view(c_cache, block_table, rank, nb_shard)
        r_c, _ = _paged_local_view(r_cache, block_table, rank, nb_shard)
        cols = torch.arange(c_c.shape[1], device=q_abs.device)
        ok = (owned & (cols[None, :] <= idx[:, None]))[:, None]
    else:
        s_shard = c_cache.shape[1]
        _local_update(c_cache, c_new, index, rank, s_shard)
        _local_update(r_cache, r_new, index, rank, s_shard)
        c_c, r_c = c_cache, r_cache
        cols = rank * s_shard + torch.arange(s_shard, device=q_abs.device)
        ok = _valid_cols(cols, index)
    m_loc, l_loc, o_loc = _mla_partials(q_abs, q_rope, c_c, r_c, ok,
                                        sm_scale=sm_scale)
    return (_combine(m_loc, l_loc, o_loc, q_abs.dtype, group), c_cache,
            r_cache)



def owns_shard(cache, mesh) -> bool:
    """Whether the models' sharded decode takes ``cache`` (a layer's
    ``KVCache``) under ``mesh``: a one-rank model axis owns every leaf
    whole; with more ranks, only a :class:`KVShard` that
    :func:`shard_cache` cut is this rank's part (a whole leaf takes the
    dense path, as JAX's where the axis does not divide)."""
    return mesh is not None and "model" in mesh.axis_names and (
        mesh.shape["model"] == 1 or isinstance(cache, KVShard))


def _cut(t: torch.Tensor, dim: int, parts: int, part: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, part * n, n).clone()


def shard_cache(cache, mesh, *, paged: bool = False):
    """This rank's shard of a whole cache (a ``KVCache`` or a list of
    them, one a layer), by the module's layout contract: dense leaves cut
    to this rank's batch rows and, where the model axis divides the
    sequence, its columns (a :class:`KVShard`); paged pools cut to its
    blocks where the model axis divides their number (a ``KVShard``, every
    row kept).  A leaf the model axis does not divide stays whole, a plain
    ``KVCache`` (the dense path).  The shard is a copy."""
    if isinstance(cache, list):
        return [shard_cache(c, mesh, paged=paged) for c in cache]
    msize, rank, _ = _model_axis(mesh)
    k, v = cache
    if not paged:
        rows = 1
        for a in batch_axes(mesh):
            rows *= mesh.shape[a]
        row = 0
        for a in batch_axes(mesh):
            row = row * mesh.shape[a] + mesh.coords[a]
        if k.shape[0] % rows:
            raise ValueError(f"{rows} batch shards do not divide the "
                             f"cache's {k.shape[0]} rows")
        k, v = _cut(k, 0, rows, row), _cut(v, 0, rows, row)
    dim = 0 if paged else 1
    if k.shape[dim] % msize:
        return KVCache(k, v)
    return KVShard(_cut(k, dim, msize, rank), _cut(v, dim, msize, rank))
