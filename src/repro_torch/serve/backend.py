"""Cache substrate of the port: the dense slab (mirrors
``repro.serve.backend.DenseSlab``), which holds the KV rows of the dense
family and the recurrent state of the ssm family alike.  The paged pool
and the hybrid composite are ROADMAP queue 1 items 6 and 7; a map from
family to substrate comes with the first substrate that behaves
differently.
"""
from __future__ import annotations

import torch


class DenseSlab:
    """Per-slot (max_batch, ...) cache rows; a slot holds a full row for
    its lifetime.  Owns the cache slab and the decode weights.  The caches
    are a per-layer list of named tuples of tensors whose leading axis is
    the slot: ``KVCache`` for attention, ``SSMCache`` (conv window, SSD
    state) for ssm.  Admission overwrites every leaf of a slot's whole
    row; free rows step through decode ticks computing ignored state, as
    in JAX."""

    def __init__(self, model, max_batch: int, max_seq: int):
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.caches = model.init_cache(max_batch, max_seq)

    def fresh(self, batch: int) -> list[tuple]:
        """Zeroed (batch, max_seq) staging caches for a prefill bucket."""
        return self.model.init_cache(batch, self.max_seq)

    def scatter(self, slab: list[tuple], rows: list[tuple],
                slots: torch.Tensor) -> list[tuple]:
        """Write freshly prefilled rows into the slab at ``slots``: whole
        rows of every leaf (for KV, the prompt's and zeros beyond), as
        JAX's scatter does.  Unlike JAX this writes the slab IN PLACE
        (``index_copy_``) and returns the same tensors."""
        for layer, new in zip(slab, rows):
            for leaf, row in zip(layer, new):
                leaf.index_copy_(0, slots, row)
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

