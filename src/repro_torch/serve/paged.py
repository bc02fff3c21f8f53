"""Host-side block accounting for the paged KV cache (a copy of
``repro.serve.paged``: the port keeps its own, importing nothing of the
JAX package).

The engine's cache slab becomes a pool of ``num_blocks`` fixed-size blocks
of ``block_size`` tokens each.  A request owns only the blocks its
prompt + generation budget needs; freeing a slot returns its blocks to the
pool (no full ``max_seq`` row rewrites).  The device-side gather/scatter
lives in ``repro_torch.models.common`` (:func:`paged_gather` /
:func:`paged_write`); this module is the pure-python allocator the engine
drives between its device calls.

Blocks are REFCOUNTED so the prefix cache (``repro_torch.serve.prefix_cache``)
can share one physical copy of a common prompt head across many owners: a
block's count is the number of owners holding it (each admitted request's
block table, plus each radix-tree node caching it).  ``alloc`` hands out
count-1 blocks; ``ref`` adds an owner; ``release`` drops one and the block
only returns to the free pool when its LAST owner lets go.  Copy-on-write
discipline: a block with more than one owner must never be written in
place (``writable`` is the predicate) — the engine redirects shared-range
scatter writes to the garbage block and recomputes divergent tails into
freshly-allocated private blocks.

Physical block 0 is reserved as the *garbage block*: free decode lanes and
unreserved block-table entries point at it, so every lane always has a
legal write target and reads from it are masked by the per-row ``kv_len``.
"""
from __future__ import annotations

GARBAGE_BLOCK = 0


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def blocks_needed(prompt_len: int, max_new: int, max_seq: int,
                  block_size: int) -> int:
    """Blocks a request needs for its whole lifetime (prompt + decode),
    reserved at admission so decode can never run out mid-request.  The one
    source of truth — the engine and the prefix cache both call this."""
    return ceil_div(min(prompt_len + max_new, max_seq), block_size)


class BlockAllocator:
    """Refcounted free-list over ``num_blocks`` blocks; block 0 is never
    handed out.  ``alloc``/``release`` are O(1) per block: the LIFO free
    list is mirrored by a free-SET so the no-double-free invariant check
    does not scan the list (refcounted sharing multiplies release traffic —
    every cached prefix adds an owner whose release must stay cheap)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved garbage "
                             f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list; block 0 (garbage) is never in it
        self._free = list(range(num_blocks - 1, GARBAGE_BLOCK, -1))
        self._free_set = set(self._free)
        self._refs = [0] * num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, block: int) -> int:
        """Number of owners currently holding ``block``."""
        return self._refs[block]

    def writable(self, block: int) -> bool:
        """Copy-on-write predicate: only a sole owner may write in place."""
        return self._refs[block] == 1

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` blocks at refcount 1, or None (and no change) if the
        pool is short."""
        if n < 0 or n > len(self._free):
            return None
        out = []
        for _ in range(n):
            b = self._free.pop()
            self._free_set.discard(b)
            self._refs[b] = 1
            out.append(b)
        return out

    def ref(self, blocks: list[int]) -> None:
        """Add an owner to already-held blocks (prefix sharing)."""
        for b in blocks:
            assert GARBAGE_BLOCK < b < self.num_blocks, b
            assert self._refs[b] > 0, f"ref of unheld block {b}"
            self._refs[b] += 1

    def release(self, blocks: list[int]) -> None:
        """Drop one owner per block; a block returns to the free pool only
        when its refcount reaches 0 (never earlier — cached copies survive
        the request that built them)."""
        for b in blocks:
            assert GARBAGE_BLOCK < b < self.num_blocks, b
            assert b not in self._free_set, f"double free of block {b}"
            assert self._refs[b] > 0, f"release of unheld block {b}"
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
                self._free_set.add(b)
