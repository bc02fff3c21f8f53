"""Cache substrates behind one protocol (mirrors ``repro.serve.backend``):
the engine never branches on family or substrate.

* :class:`DenseSlab` — per-slot (max_batch, max_seq, ...) rows; a slot
  holds a full row for its lifetime (the reference).
* :class:`PagedPool` — every KV leaf is a pool of ``num_blocks`` fixed
  ``block_size``-token blocks with per-slot block tables; admission
  reserves only the request's lifetime block budget and backpressures when
  the pool is short (attention families).
* :class:`RecurrentState` — dense O(1)-per-slot recurrent state plus the
  snapshot/seed hooks the prefix cache needs (ssm).
* :class:`HybridComposite` — the split substrate: the attention KV leaves
  in the block pool, the recurrent state dense per slot (hybrid).

The caches are one flat list of named tuples of tensors (``KVCache``,
``SSMCache``) whose leading axis is the slot, or for a pool the block.
The paged substrates tell a layer's substrate by its type, as JAX
discovers it structurally per leaf: ``KVCache`` leaves are pools,
``SSMCache`` leaves dense per slot.
Unlike JAX's functional updates, every write here is IN PLACE and the
returned tree holds the same tensors.  JAX's guarantees rest on
immutability, so the port keeps them explicitly: a block with more than
one owner is never written (the copy-on-write redirect of
:meth:`PagedPool.cow_table` / :meth:`PagedPool.decode_tables` sends those
writes to the garbage block), a recurrent snapshot is a copy, and seeding
copies the snapshot into the staging row.

Speculation's ``rollback`` is bookkeeping on every substrate, as in JAX:
rejected K/V beyond a row's rewound pointer is dead weight the next writes
overwrite (the draft's and the verify window's writes land at the row's
own future positions, or on the garbage block past its reservation), and
recurrent state is re-committed by the engine from the untouched
pre-verify caches (the models return recurrent state as new tensors).

The engine hands over its lock (:meth:`CacheBackend.bind_lock`): pool
accounting and the tables are mutated only while it is held, and the
mutating entry points assert it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import CacheSpec, paged_gather
from repro_torch.models.ssm import SSMCache
from repro_torch.serve.paged import (GARBAGE_BLOCK, BlockAllocator,
                                     blocks_needed, ceil_div)

#: families the port's engine serves (JAX's); all tolerate right-padded
#: prefill rows (attention masks pad columns causally, the recurrent
#: families mask them out of the carried state)
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")

#: served families with attention KV leaves a block pool can back (moe's
#: MLA leaves are (…, R) and (…, dr), with no head axis; the hybrid's
#: shared-attention KV, beside its dense SSM state; "ssm" is excluded:
#: its whole cache is O(1) recurrent state per slot)
PAGED_FAMILIES = ("dense", "moe", "hybrid")

#: served families whose cache carries recurrent state the prefix cache
#: snapshots
RECURRENT_FAMILIES = ("ssm", "hybrid")


class CacheBackend:
    """Base substrate: dense per-slot rows.  Subclasses override the
    reservation, table, snapshot and prefix-policy hooks."""

    paged = False
    needs_state = False

    def __init__(self, model, max_batch: int, max_seq: int,
                 spec: CacheSpec | None = None):
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.caches = model.init_cache(max_batch, max_seq, spec=spec)
        self.stage_len = max_seq
        self._lock = None

    # --- thread discipline ----------------------------------------------
    def bind_lock(self, lock) -> None:
        """The engine's state lock: backend state (pool accounting, slot
        tables) is only mutated while it is held (the tick and the
        engine's public mutators all run under it), so the backend stays
        lock-free with one writer; mutating entry points assert it."""
        self._lock = lock

    def _assert_owned(self) -> None:
        lock = self._lock
        if lock is not None:
            owned = getattr(lock, "_is_owned", None)
            assert owned is None or owned(), \
                "backend state mutated without holding the engine lock"

    # --- device bodies --------------------------------------------------
    def fresh(self, batch: int) -> list[tuple]:
        """Zeroed dense (batch, stage_len) staging caches."""
        return self.model.init_cache(batch, self.stage_len)

    def scatter(self, slab: list[tuple], rows: list[tuple],
                slots: torch.Tensor, tables: torch.Tensor | None
                ) -> list[tuple]:
        """Write ``k`` freshly prefilled staging rows into the slab, in
        place: whole rows of every leaf at ``slots`` (for KV, the prompt's
        and zeros beyond, as JAX's scatter does)."""
        for layer, new in zip(slab, rows):
            for leaf, row in zip(layer, new):
                leaf.index_copy_(0, slots, row.to(leaf.dtype))
        return slab

    # --- decode weights -------------------------------------------------
    def prepare_decode_params(self, model, quant: str | None):
        """The decode-step model, frozen once at construction: ``model``
        itself under ``quant=None``, else a model over the same tree with
        every decode projection replaced by a 4-bit ``QuantizedWeight``
        (every other tensor shared, not copied)."""
        if quant is None:
            self.decode_params = model
        else:
            from repro_torch.core.quant import quantize_decode_params
            tree = quantize_decode_params(model.params_tree(), quant)
            self.decode_params = type(model).from_params(
                model.cfg, tree, device=model.device)
        return self.decode_params

    # --- host-side reservation ------------------------------------------
    def validate_request(self, rid: int, prompt_len: int,
                         max_new: int) -> None:
        """Raise for requests this substrate can NEVER serve."""

    def reservation_need(self, prompt_len: int, max_new: int) -> int:
        """Capacity units :meth:`reserve` would claim (the scheduler's
        stall gate compares failed demands); the dense slab needs only
        the slot the caller already holds."""
        return 0

    def reserve(self, slot: int, prompt_len: int, max_new: int,
                shared: list[int] | None = None, on_short=None) -> bool:
        """Claim the request's lifetime capacity; False = backpressure.
        The dense slab's capacity is the slot, already held."""
        return True

    def free_slot(self, slot: int) -> None:
        """Return a slot's substrate resources (no-op for dense rows)."""

    def rollback(self, slot: int, n: int) -> None:
        """Discard the last ``n`` rejected speculative tokens of ``slot``.
        Dense attention rows are position-indexed: the engine rewinds the
        slot's decode pointer and the rejected K/V beyond it is dead
        weight the next writes overwrite (``kv_len`` masks it meanwhile),
        so this is bookkeeping: it asserts the lock discipline."""
        self._assert_owned()
        assert n >= 0, n

    @property
    def free_capacity(self) -> int:
        """Reservation headroom the scheduler's stall state watches
        (paged: free blocks; dense reservation never fails)."""
        return self.max_batch

    # --- block tables (None for dense substrates) -----------------------
    def admission_tables(self, slots: list[int]):
        return None

    def decode_tables(self, staged_slots: list[int]):
        return None

    def cow_table(self, slot: int, n_shared: int):
        return None

    def finish_tables(self, slot: int, cow):
        return None

    # --- recurrent state ------------------------------------------------
    def capture_grid(self, prefill_bucket: int) -> int:
        """Boundary grid for prefix-cache snapshots/payloads."""
        return prefill_bucket

    def snapshot(self, caches, row: int = 0):
        """Recurrent-state snapshot (a copy) at ``row``; None when there is
        no state to snap."""
        return None

    def seed_snapshot(self, staging, snap):
        """Copy a snapshot into a staging row (identity when stateless)."""
        return staging

    # --- prefix-cache binding -------------------------------------------
    def prefix_cache_kwargs(self) -> dict:
        """Constructor kwargs binding ``PrefixCache`` to this substrate."""
        return {}

    def prefix_payload(self, prompt: list[int], slot: int, state):
        """The per-family storage policy: what a finished prefill of
        ``prompt`` contributes to the radix tree, or None.  Returns
        (tokens, blocks, state)."""
        return None


class DenseSlab(CacheBackend):
    """Reference substrate: full per-slot rows, no sharing, no paging."""


class RecurrentState(DenseSlab):
    """Dense O(1)-per-slot recurrent state (ssm): nothing to page, but the
    prefix cache snapshots (conv, ssd) rows at capture-grid boundaries."""

    needs_state = True

    def rollback(self, slot: int, n: int) -> None:
        """Recurrent state has no positions to rewind: a rejected draft is
        kept OUT of the state rather than removed from it.  The engine's
        commit pass re-runs the window from the pre-verify caches (which
        the verify only read) with dt masked beyond the accept boundary,
        so rejected tokens contribute exactly zero.  Bookkeeping only."""
        super().rollback(slot, n)

    def snapshot(self, caches, row: int = 0):
        return self.model.state_snapshot(caches, row)

    def seed_snapshot(self, staging, snap):
        return self.model.seed_from_snapshot(staging, snap)

    def prefix_payload(self, prompt, slot, state):
        if state is None:
            return None
        return (prompt, None, state)


class PagedPool(CacheBackend):
    """Paged-block KV substrate: refcounted fixed-size blocks with per-slot
    block tables; admission reserves ``blocks_needed`` up front so decode
    can never run out mid-request.  The tables live on the host
    (``block_tables``, numpy) and reach the card once a call, as one
    (rows, blocks_per_row) tensor every layer reads."""

    paged = True

    def __init__(self, model, max_batch: int, max_seq: int,
                 block_size: int, num_blocks: int | None = None):
        self.block_size = block_size
        self.blocks_per_row = ceil_div(max_seq, block_size)
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max_batch * self.blocks_per_row + 1)
        super().__init__(model, max_batch, max_seq,
                         spec=CacheSpec(block_size, self.num_blocks))
        # staged/fresh prefill rows cover whole blocks for the scatter, so
        # the gathered decode view has exactly blocks_per_row * block_size
        # columns (== max_seq when block_size divides it: the dense slab's
        # shape, and the same attention arithmetic)
        self.stage_len = self.blocks_per_row * block_size
        self.allocator = BlockAllocator(self.num_blocks, block_size)
        self.block_tables = np.full(
            (max_batch, self.blocks_per_row), GARBAGE_BLOCK, np.int64)
        self._slot_blocks: list[list[int]] = [[] for _ in range(max_batch)]
        self._device = model.device

    def _to_device(self, table: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(table, device=self._device)

    # --- device bodies --------------------------------------------------
    def scatter(self, slab, rows, slots, tables):
        """Pool leaves: each staging row reshaped into (nblk, block_size,
        ...) blocks and written to the physical ids in ``tables`` (k,
        nblk).  Unreserved entries, and a warm admission's shared range
        (:meth:`cow_table`), point at the garbage block: their writes
        collide there and are never read back.  Dense recurrent leaves
        (the split substrate's ``SSMCache`` layers) land whole rows at
        ``slots``."""
        bs = self.block_size
        for layer, new in zip(slab, rows):
            for leaf, row in zip(layer, new):
                if isinstance(layer, SSMCache):
                    leaf.index_copy_(0, slots, row.to(leaf.dtype))
                    continue
                blocks = row.reshape((row.shape[0], tables.shape[1], bs)
                                     + tuple(row.shape[2:]))
                leaf[tables] = blocks.to(leaf.dtype)
        return slab

    def gather_staging(self, caches, tbl):
        """A 1-row staging tree of ``stage_len`` columns holding the shared
        blocks' KV in logical order (exactly what the cold prefill wrote)
        and the garbage block's beyond them, which the tail prefill
        overwrites or masks; gathered as a copy, the pool is only read.
        Dense recurrent leaves get a fresh zeroed row, for
        :meth:`seed_snapshot` to fill."""
        return [type(layer)(*(
            torch.zeros((1,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                        device=leaf.device)
            if isinstance(layer, SSMCache) else paged_gather(leaf, tbl)
            for leaf in layer))
            for layer in caches]

    # --- reservation ----------------------------------------------------
    def validate_request(self, rid, prompt_len, max_new):
        need = blocks_needed(prompt_len, max_new, self.max_seq,
                             self.block_size)
        if need > self.num_blocks - 1:
            raise ValueError(
                f"request {rid} needs {need} blocks but the pool "
                f"holds {self.num_blocks - 1}")

    def reservation_need(self, prompt_len, max_new):
        return blocks_needed(prompt_len, max_new, self.max_seq,
                             self.block_size)

    def reserve(self, slot, prompt_len, max_new, shared=None, on_short=None):
        """Claim the request's lifetime block budget up front.  A prefix
        hit refs the ``shared`` blocks (copy-on-write share) and allocates
        only the tail privately; when the pool runs short,
        ``on_short(need)`` may free capacity (prefix-cache LRU eviction)
        before backpressuring.  False = pool short."""
        self._assert_owned()
        shared = list(shared) if shared else []
        need = blocks_needed(prompt_len, max_new, self.max_seq,
                             self.block_size) - len(shared)
        assert need >= 0, (need, len(shared))
        # take the request's ref BEFORE any eviction: the extra owner makes
        # the matched node's blocks non-evictable, so on_short can neither
        # free them nor recycle them as this admission's private tail
        if shared:
            self.allocator.ref(shared)
        if need > self.allocator.free_blocks and on_short is not None:
            on_short(need)
        fresh = self.allocator.alloc(need)
        if fresh is None:
            if shared:
                self.allocator.release(shared)
            return False
        blocks = shared + fresh
        self._slot_blocks[slot] = blocks
        self.block_tables[slot, :] = GARBAGE_BLOCK
        self.block_tables[slot, :len(blocks)] = blocks
        return True

    def free_slot(self, slot):
        self._assert_owned()
        if self._slot_blocks[slot]:
            self.allocator.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self.block_tables[slot, :] = GARBAGE_BLOCK

    def rollback(self, slot, n):
        """Rejected drafts occupied positions beyond the rewound pointer.
        Blocks are reserved for the request's lifetime budget at
        admission, so nothing is freed and the table is not truncated:
        the rewound positions stay inside the reservation (the engine's
        window clamp) and the junk K/V there is overwritten as the row
        re-advances.  Validates the accounting instead of mutating it."""
        super().rollback(slot, n)
        assert n == 0 or self._slot_blocks[slot], \
            f"rollback({slot}, {n}) on a slot with no reservation"

    def slot_blocks(self, slot):
        return self._slot_blocks[slot]

    @property
    def free_capacity(self):
        return self.allocator.free_blocks

    # --- block tables ---------------------------------------------------
    def admission_tables(self, slots):
        return self._to_device(self.block_tables[slots])

    def decode_tables(self, staged_slots):
        """The decode tick's tables, one host-to-device copy a tick.
        Mid-admission slots decode masked garbage at position 0: their
        rows are parked on the garbage block so the write can never land
        in a reserved block (a warm admission's table starts with SHARED
        prefix blocks, which must never be written in place)."""
        tables = self.block_tables
        if staged_slots:
            tables = tables.copy()
            for slot in staged_slots:
                tables[slot, :] = GARBAGE_BLOCK
        return self._to_device(tables)

    def cow_table(self, slot, n_shared):
        """Copy-on-write scatter redirect: the staged scatter's shared
        range lands on the garbage block, private tail blocks stay."""
        table = self.block_tables[slot].copy()
        table[:n_shared] = GARBAGE_BLOCK
        return table

    def finish_tables(self, slot, cow):
        table = cow if cow is not None else self.block_tables[slot]
        return self._to_device(table[None])

    def staging_table(self, blocks):
        """(1, blocks_per_row) gather table over ``blocks`` (the shared
        prefix in logical order), garbage elsewhere."""
        table = np.full((1, self.blocks_per_row), GARBAGE_BLOCK, np.int64)
        table[0, :len(blocks)] = blocks
        return table

    # --- prefix-cache binding -------------------------------------------
    def capture_grid(self, prefill_bucket):
        return self.block_size

    def prefix_cache_kwargs(self):
        return {"block_size": self.block_size, "backend": self}

    def prefix_payload(self, prompt, slot, state):
        nb = len(prompt) // self.block_size
        if nb == 0:
            return None
        blocks = self._slot_blocks[slot][:nb]
        return (prompt[:nb * self.block_size], blocks, None)

    # --- block ops (the PrefixCache-facing surface) ---------------------
    def ref(self, blocks):
        self.allocator.ref(blocks)

    def release(self, blocks):
        self.allocator.release(blocks)

    def refcount(self, block):
        return self.allocator.refcount(block)

    def writable(self, block):
        return self.allocator.writable(block)

    @property
    def free_blocks(self):
        return self.allocator.free_blocks


class HybridComposite(PagedPool):
    """Split substrate (hybrid): the shared-attention KV leaves in the
    paged block pool, the O(1) SSM state dense per slot; each leaf gets
    the substrate that pays off (:meth:`PagedPool.scatter` and
    :meth:`PagedPool.gather_staging` route by leaf type).  ``rollback``
    composes both halves' rules with no code of its own: the paged KV
    beyond the rewound pointer is dead weight inside the slot's
    reservation (:meth:`PagedPool.rollback`'s accounting check), and the
    engine re-commits the recurrent half from the pre-verify caches
    (:meth:`RecurrentState.rollback`).  A prefix boundary needs BOTH
    halves, so payloads exist only at block-aligned prompt lengths."""

    needs_state = True
    snapshot = RecurrentState.snapshot
    seed_snapshot = RecurrentState.seed_snapshot

    def prefix_payload(self, prompt, slot, state):
        if state is None or len(prompt) % self.block_size:
            return None
        nb = len(prompt) // self.block_size
        if nb == 0:
            return None
        return (prompt, self._slot_blocks[slot][:nb], state)


def make_backend(model, family: str, config) -> CacheBackend:
    """Pick the substrate for (family, config): the only place that maps
    families to cache substrates.  ``config`` must already be validated
    against the family (``EngineConfig.validate``)."""
    if config.paged:
        cls = HybridComposite if family in RECURRENT_FAMILIES else PagedPool
        return cls(model, config.max_batch, config.max_seq,
                   block_size=config.block_size,
                   num_blocks=config.num_blocks)
    if family in RECURRENT_FAMILIES:
        return RecurrentState(model, config.max_batch, config.max_seq)
    return DenseSlab(model, config.max_batch, config.max_seq)
