"""LLaVA-NeXT-style VLM: stub vision frontend + Mistral-7B text backbone
(mirrors ``repro.models.vlm``).

The modality frontend is a stub: the caller gives precomputed patch
embeddings (B, num_patches, d_model) (``models.registry.input_specs``);
the anyres tiling and the CLIP tower are out of scope.  The multimodal
sequence is [patches; text] over the standard decoder
(:class:`~repro_torch.models.transformer.TransformerLM`, whose tree this
model's ``params_tree()`` is).  Decode positions count the patches.
On a mesh the backbone splits over ``model`` as the dense decoder does
(:meth:`VLM.split_over_model`): its attention heads, FFN hidden dimension
and vocabulary.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import CacheSpec, reject_paged_spec
from repro_torch.models.transformer import TransformerLM


class VLM(nn.Module):
    """VLM on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, cfg, device=None, params: dict | None = None):
        super().__init__()
        if cfg.family != "vlm":
            raise ValueError(f"VLM serves the vlm family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.backbone = TransformerLM(cfg, device=device, params=params)
        self.device = self.backbone.device

    @classmethod
    def from_params(cls, cfg, params: dict, device=None) -> "VLM":
        """A model over an existing (dense) parameter tree (no copies)."""
        return cls(cfg, device=device, params=params)

    def params_tree(self) -> dict:
        return self.backbone.params_tree()

    def split_over_model(self, specs: dict, m: int, serving: bool) -> dict:
        """The backbone's split (``TransformerLM.split_over_model``): this
        model's tree is the backbone's, leaf for leaf, so the paths are
        the same (the patches come in as activations: no leaf of theirs
        to split)."""
        return self.backbone.split_over_model(specs, m, serving)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "VLM":
        self.backbone.init(gen)
        return self

    def _merge(self, patches: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
        """[patches; text]: the patches in the embedding's dtype before the
        text tokens' embeddings."""
        tok = self.backbone.embed_tokens(tokens)
        return torch.cat([patches.to(tok.dtype), tok], dim=1)

    def loss(self, batch: dict):
        """batch: patches (B, P, D), tokens (B, S_text), labels (B, P +
        S_text)[, loss_mask (B, P + S_text), by default zero over the
        patches].  Returns (xent + aux, {"xent"})."""
        embeds = self._merge(batch["patches"], batch["tokens"])
        b, s, _ = embeds.shape
        p = batch["patches"].shape[1]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.cat(
                [torch.zeros((b, p), dtype=torch.float32,
                             device=embeds.device),
                 torch.ones((b, s - p), dtype=torch.float32,
                            device=embeds.device)], dim=1)
        hidden, aux, _ = self.backbone.forward_aux(embeds=embeds,
                                                   training=True)
        xent = self.backbone.xent(hidden, batch["labels"], mask)
        return xent + aux, {"xent": xent}

    def init_cache(self, batch: int, s_max: int, *,
                   spec: CacheSpec | None = None):
        """The backbone's dense slabs; a paged spec is refused (the engine
        does not page modality backbones)."""
        reject_paged_spec(spec, "vlm", "the multimodal backbone is served "
                          "dense (no engine-managed block tables)")
        return self.backbone.init_cache(batch, s_max)

    def prefill(self, tokens, caches, *, patches, last_pos=None):
        """[patches; prompt] forward writing ``caches`` from 0; returns the
        (B, 1, V) logits at ``last_pos`` (default: the last column; an
        index into the merged sequence) and the caches."""
        return self.backbone.prefill(None, caches,
                                     embeds=self._merge(patches, tokens),
                                     last_pos=last_pos)

    def decode_step(self, token, state, index, *, tables=None):
        """``index``: the position in the merged sequence (the patches
        count), an int or a (B,) tensor.  ``tables`` must be None (dense
        backbone cache), accepted for the engine's uniform contract."""
        return self.backbone.decode_step(token, state, index, tables=tables)
