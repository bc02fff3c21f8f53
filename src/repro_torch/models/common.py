"""Shared model building blocks (mirrors ``repro.models.common``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.serve.paged import GARBAGE_BLOCK


@dataclass(frozen=True)
class CacheSpec:
    """Cache-layout request of ``init_cache`` (``repro.models.common.
    CacheSpec``).  With ``spec=None`` (or a spec without paging) the cache
    is a dense slab of per-slot (batch, s_max, ...) rows.  A paged spec
    turns every KV leaf into a pool of ``num_blocks`` fixed
    ``block_size``-token blocks read and written through per-row block
    tables; a family with nothing to page (recurrent state) rejects it
    (:func:`reject_paged_spec`)."""
    block_size: int | None = None
    num_blocks: int | None = None

    def __post_init__(self):
        if (self.block_size is None) != (self.num_blocks is None):
            raise ValueError(
                "CacheSpec paging needs BOTH block_size and num_blocks "
                f"(got block_size={self.block_size}, "
                f"num_blocks={self.num_blocks})")

    @property
    def paged(self) -> bool:
        return self.block_size is not None


def reject_paged_spec(spec: CacheSpec | None, family: str, why: str) -> None:
    """Shared guard for families with nothing to page."""
    if spec is not None and spec.paged:
        raise ValueError(f"family {family!r} rejects a paged CacheSpec: "
                         f"{why}")


class PagedRows(NamedTuple):
    """Where one decode step's rows meet a paged pool, computed once a
    step and read by every layer: the (B, nblk) block table, and each
    row's physical block and offset for its new token."""
    table: torch.Tensor
    block: torch.Tensor
    offset: torch.Tensor


def paged_rows(block_table: torch.Tensor, index, block_size: int
               ) -> PagedRows:
    """``index``: (B,) logical positions of the new tokens (or one int for
    every row).  The physical target of row ``b`` is
    ``block_table[b, index // block_size]`` at ``index % block_size``."""
    b = block_table.shape[0]
    idx = (index.long() if isinstance(index, torch.Tensor) else
           torch.full((b,), index, dtype=torch.long,
                      device=block_table.device))
    rows = torch.arange(b, device=block_table.device)
    return PagedRows(block_table, block_table[rows, idx // block_size].long(),
                     idx % block_size)


class WindowTarget(NamedTuple):
    """Where a speculative window's (B, W) new tokens land, computed once
    a step and read by every layer.  ``index`` (B, W): the slab column
    (dense) or the physical block (paged); ``offset`` (B, W): the offset
    in the block (paged) or None; ``keep`` (B, W) bool: which entries of a
    dense slab write (None: all); ``table``: the (B, nblk) block table
    attention gathers through (paged) or None."""
    index: torch.Tensor
    offset: torch.Tensor | None
    keep: torch.Tensor | None
    table: torch.Tensor | None


def _window_index(index: torch.Tensor, s: int, n_valid):
    """(B, W) logical positions of the window and its (B, W) validity
    (None when ``n_valid`` is None: every entry is real)."""
    ar = torch.arange(s, device=index.device)
    idx = index.long()[:, None] + ar[None, :]
    if n_valid is None:
        return idx, None
    return idx, ar[None, :] < n_valid.long()[:, None]


def dense_window(index: torch.Tensor, s: int, s_max: int,
                 n_valid=None) -> WindowTarget:
    """A dense (B, S_max, ...) slab's window target: row ``b``'s token
    ``i`` lands at ``index[b] + i``.  JAX drops the entries at or beyond
    ``n_valid`` (an out-of-range scatter index); the port cannot index
    out of range on the card, so each such entry is redirected to a column
    no real entry of its row writes (``index - 1``, or the last column
    for a row at 0) and writes back the value already there: the slab is
    unchanged outside the real entries.  The real entries must lie below
    ``s_max`` (the engine's window clamp keeps them below ``s_max - 1``)."""
    idx, ok = _window_index(index, s, n_valid)
    keep = None
    if ok is not None:
        start = index.long()[:, None]
        sink = torch.where(start >= 1, start - 1, s_max - 1)
        idx = torch.where(ok, idx, sink)
        keep = ok
    return WindowTarget(idx, None, keep, None)


def paged_window(block_table: torch.Tensor, index: torch.Tensor, s: int,
                 block_size: int, n_valid=None) -> WindowTarget:
    """A paged pool's window target: row ``b``'s token ``i`` lands at
    logical position ``index[b] + i`` through the row's block table.
    Entries at or beyond ``n_valid`` (JAX drops them: an out-of-range
    physical id) go to the garbage block (:data:`GARBAGE_BLOCK`), which is
    never read unmasked; the table column is clamped into the table, so
    no entry indexes past its width."""
    idx, ok = _window_index(index, s, n_valid)
    col = torch.clamp(idx // block_size, max=block_table.shape[1] - 1)
    phys = torch.gather(block_table.long(), 1, col)
    if ok is not None:
        phys = torch.where(ok, phys, GARBAGE_BLOCK)
    return WindowTarget(phys, idx % block_size, None, block_table)


def write_window(cache: torch.Tensor, new: torch.Tensor,
                 target: WindowTarget) -> torch.Tensor:
    """Write a (B, W, ...) window into a slab or pool IN PLACE at
    ``target`` (:func:`dense_window` / :func:`paged_window`) and return
    it.  Garbage-block entries of several rows collide there (which write
    wins is unspecified on CUDA; the block is never read unmasked); a
    dense slab's redirected entries write back what they read."""
    new = new.to(cache.dtype)
    if target.offset is not None:
        cache[target.index, target.offset] = new
        return cache
    rows = torch.arange(new.shape[0], device=new.device)[:, None]
    if target.keep is not None:
        keep = target.keep.reshape(target.keep.shape
                                   + (1,) * (new.ndim - 2))
        new = torch.where(keep, new, cache[rows, target.index])
    cache[rows, target.index] = new
    return cache


def dense_write_window(cache: torch.Tensor, new: torch.Tensor,
                       index: torch.Tensor, n_valid=None) -> torch.Tensor:
    """JAX's ``dense_write_window``: an S-token window per row into a
    dense (B, S_max, ...) slab, in place (see :func:`dense_window`)."""
    return write_window(cache, new, dense_window(index, new.shape[1],
                                                 cache.shape[1], n_valid))


def paged_write_window(pool: torch.Tensor, new: torch.Tensor,
                       block_table: torch.Tensor, index: torch.Tensor,
                       n_valid=None) -> torch.Tensor:
    """JAX's ``paged_write_window``: :func:`paged_write` generalized to an
    S-token window per row, in place (see :func:`paged_window`)."""
    return write_window(pool, new, paged_window(
        block_table, index, new.shape[1], pool.shape[1], n_valid))


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """Logical-order view of each row's paged cache (a copy).

    ``pool``: (num_blocks, block_size, ...); ``block_table``: (B, nblk)
    physical block ids in logical order, each in range (the backend builds
    them; an id out of range faults instead of being clipped, as JAX
    clips it).  Returns (B, nblk * block_size, ...): column ``j`` is
    logical token ``j`` of the row.  Unreserved entries point at the
    garbage block; their columns lie beyond the row's ``kv_len`` and the
    caller masks them."""
    g = pool[block_table]
    return g.reshape((block_table.shape[0], -1) + tuple(pool.shape[2:]))


def paged_write(pool: torch.Tensor, new: torch.Tensor, rows: PagedRows
                ) -> torch.Tensor:
    """Write one new token per row into a paged pool at its logical depth
    (``rows``: the step's :class:`PagedRows`), IN PLACE, and return the
    pool; with :func:`paged_rows` it is JAX's ``paged_write``.  ``new``:
    (B, 1, ...).  Rows parked on the garbage block all write there
    (duplicate indices: which write wins is unspecified on CUDA; the
    garbage block is never read unmasked)."""
    pool[rows.block, rows.offset] = new[:, 0].to(pool.dtype)
    return pool


TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def set_leaf(module: nn.Module, name: str, value) -> None:
    """A float tensor becomes a (frozen) parameter sharing its storage; a
    ``QuantizedWeight`` stays a plain attribute.  ``model.requires_grad_()``
    makes every float leaf trainable."""
    if isinstance(value, torch.Tensor):
        module.register_parameter(name, nn.Parameter(value,
                                                     requires_grad=False))
    else:
        setattr(module, name, value)


def remat_of(cfg, fn):
    """``fn`` recomputed in the backward instead of saving its activations
    (JAX wraps each block in ``jax.checkpoint`` under ``remat_policy_of``):
    ``torch.utils.checkpoint`` without reentrancy; only the block's inputs
    stay alive between forward and backward.  Policy ``"nothing"`` saves
    nothing inside the block; ``"dots"`` (save the matmul outputs) is
    ROADMAP queue 1 item 8."""
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' is not ported yet: ROADMAP queue 1 item 8")
    if cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")

    def recomputed(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return recomputed


def dtype_of(cfg) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, out: torch.Tensor,
               scale: float | None = None) -> torch.Tensor:
    """Fill an (in, out) weight in place with N(0, 1) / sqrt(in) drawn in
    f32 from ``gen`` (on the weight's device), then cast."""
    scale = scale if scale is not None else 1.0 / out.shape[0] ** 0.5
    draw = torch.randn(out.shape, generator=gen, device=out.device,
                       dtype=torch.float32)
    return out.copy_(draw.mul_(scale))


def embed_init(gen: torch.Generator, out: torch.Tensor) -> torch.Tensor:
    """Fill a (vocab, dim) embedding in place with N(0, 0.02^2)."""
    return dense_init(gen, out, scale=0.02)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * weight.float()).to(dt)


def token_positions(s: int, cache_index, device) -> torch.Tensor:
    """Absolute positions of ``s`` new tokens appended at ``cache_index``
    (a Python int, or a (B,) int tensor of per-row depths).  Returns
    (1, S) or (B, S)."""
    ar = torch.arange(s, device=device)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        return cache_index[:, None] + ar[None, :]
    return ar[None, :] + cache_index


def gather_last(hidden: torch.Tensor, last_pos: torch.Tensor) -> torch.Tensor:
    """hidden: (B, S, D) -> (B, 1, D) at per-row ``last_pos`` (B,)."""
    idx = last_pos.long().reshape(-1, 1, 1).expand(-1, 1, hidden.shape[-1])
    return torch.gather(hidden, 1, idx)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    # a tensor divisor keeps the quotient correctly rounded on CUDA too
    return 1.0 / (theta ** (ar / torch.full_like(ar, head_dim)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions broadcast to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs
    if x.ndim == angles.ndim + 1:                      # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)
