"""Cache substrate of the port: the dense slab (mirrors
``repro.serve.backend.DenseSlab``).  The paged pool, recurrent state and
the hybrid composite are ROADMAP queue 1 items 6 and 7.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import KVCache


class DenseSlab:
    """Per-slot (max_batch, max_seq, ...) KV rows; a slot holds a full row
    for its lifetime.  Owns the cache slab and the decode weights."""

    def __init__(self, model, max_batch: int, max_seq: int):
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.caches = model.init_cache(max_batch, max_seq)

    def fresh(self, batch: int) -> list[KVCache]:
        """Zeroed (batch, max_seq) staging caches for a prefill bucket."""
        return self.model.init_cache(batch, self.max_seq)

    def scatter(self, slab: list[KVCache], rows: list[KVCache],
                slots: torch.Tensor) -> list[KVCache]:
        """Write freshly prefilled rows into the slab at ``slots``: whole
        rows (the prompt's KV and zeros beyond), as JAX's scatter does.
        Unlike JAX this writes the slab IN PLACE (``index_copy_``) and
        returns the same tensors."""
        for s, r in zip(slab, rows):
            s.k.index_copy_(0, slots, r.k)
            s.v.index_copy_(0, slots, r.v)
        return slab

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
