"""Whisper-style encoder-decoder backbone, conv frontend stubbed (mirrors
``repro.models.encdec``).

The audio frontend is a stub: the caller gives precomputed frame
embeddings (B, enc_seq, d_model) in the model's dtype
(``models.registry.input_specs``).  The transformer backbone is real: a
bidirectional encoder (rope on its self-attention, as JAX has it) and a
causal decoder whose blocks run self-attention with a KV cache, cross-
attention to the encoder's output (k/v from ``enc_out``, no rope, no
cache), then a GELU MLP.

``params_tree()`` nests as JAX's tree does: ``{"embed", "lm_head",
"enc_blocks": [{"ln1", "ln2", "attn": {wq, wk, wv, wo}, "mlp": {w_up,
w_down}}, ...], "dec_blocks": [{"ln1", "ln2", "ln3", "self_attn": {...},
"cross_attn": {...}, "mlp": {...}}, ...], "ln_enc", "ln_dec"}``, with
per-layer lists in place of JAX's stacked axes.

Caches are one :class:`~repro_torch.models.attention.KVCache` a decoder
layer (dense slabs, written in place); a paged spec is refused, as JAX
refuses it.  ``prefill`` and ``decode_step`` carry ``(caches, enc_out)``
and every decode step projects the cross K/V from ``enc_out`` again, as
JAX does.  Training: remat (``cfg.remat``) wraps the decoder blocks
only, as JAX checkpoints the decoder's scan body and not the encoder's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import quant_matmul
from repro_torch.device import resolve_device
from repro_torch.models.attention import GQAAttention, KVCache, gqa_shapes
from repro_torch.models.common import (CacheSpec, dense_init, dtype_of,
                                       embed_init, gather_last,
                                       reject_paged_spec, remat_of, rms_norm,
                                       set_leaf, token_positions)
from repro_torch.models.mlp import MLP, mlp_shapes
from repro_torch.models.transformer import chunked_xent


def _mlp_shapes(cfg) -> dict:
    return mlp_shapes(cfg, mlp_type="gelu")


def _empty_params(cfg, device) -> dict:
    """Uninitialised weights (norm weights are f32 ones, as in JAX)."""
    dt = dtype_of(cfg)

    def mats(shapes):
        return {n: torch.empty(s, dtype=dt, device=device)
                for n, s in shapes.items()}

    def ones():
        return torch.ones(cfg.d_model, dtype=torch.float32, device=device)

    return {
        "embed": torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt,
                             device=device),
        "lm_head": torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt,
                               device=device),
        "enc_blocks": [{"ln1": ones(), "ln2": ones(),
                        "attn": mats(gqa_shapes(cfg)),
                        "mlp": mats(_mlp_shapes(cfg))}
                       for _ in range(cfg.encdec.enc_layers)],
        "dec_blocks": [{"ln1": ones(), "ln2": ones(), "ln3": ones(),
                        "self_attn": mats(gqa_shapes(cfg)),
                        "cross_attn": mats(gqa_shapes(cfg)),
                        "mlp": mats(_mlp_shapes(cfg))}
                       for _ in range(cfg.num_layers)],
        "ln_enc": ones(),
        "ln_dec": ones(),
    }


def _attn_tree(cfg, attn: GQAAttention) -> dict:
    return {n: getattr(attn, n) for n in gqa_shapes(cfg)}


class EncBlock(nn.Module):
    """Bidirectional self-attention (rope on) then a GELU MLP."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        set_leaf(self, "ln1", params["ln1"])
        set_leaf(self, "ln2", params["ln2"])
        self.attn = GQAAttention(cfg, params["attn"])
        self.mlp = MLP(cfg, params["mlp"], mlp_type="gelu")

    def forward(self, x, *, positions):
        eps = self.cfg.norm_eps
        a, _ = self.attn(rms_norm(x, self.ln1, eps), positions=positions,
                         causal=False)
        x = x + a
        return x + self.mlp(rms_norm(x, self.ln2, eps))

    def params_tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2,
                "attn": _attn_tree(self.cfg, self.attn),
                "mlp": {n: getattr(self.mlp, n)
                        for n in _mlp_shapes(self.cfg)}}


class DecBlock(nn.Module):
    """Causal self-attention (with the layer's cache), cross-attention to
    the encoder's output, then a GELU MLP."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        for name in ("ln1", "ln2", "ln3"):
            set_leaf(self, name, params[name])
        self.self_attn = GQAAttention(cfg, params["self_attn"])
        self.cross_attn = GQAAttention(cfg, params["cross_attn"])
        self.mlp = MLP(cfg, params["mlp"], mlp_type="gelu")

    def forward(self, x, enc_out, *, positions, cache, cache_index):
        eps = self.cfg.norm_eps
        a, cache = self.self_attn(rms_norm(x, self.ln1, eps),
                                  positions=positions, cache=cache,
                                  cache_index=cache_index)
        x = x + a
        c, _ = self.cross_attn(rms_norm(x, self.ln2, eps),
                               positions=positions, kv_x=enc_out)
        x = x + c
        return x + self.mlp(rms_norm(x, self.ln3, eps)), cache

    def params_tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2, "ln3": self.ln3,
                "self_attn": _attn_tree(self.cfg, self.self_attn),
                "cross_attn": _attn_tree(self.cfg, self.cross_attn),
                "mlp": {n: getattr(self.mlp, n)
                        for n in _mlp_shapes(self.cfg)}}


class EncDecLM(nn.Module):
    """Whisper-style encoder-decoder LM on ``device`` (the card unless
    ``"cpu"``)."""

    def __init__(self, cfg, device=None, params: dict | None = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM serves the encdec family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = _empty_params(cfg, self.device)
        for name in ("embed", "lm_head", "ln_enc", "ln_dec"):
            set_leaf(self, name, params[name])
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, p)
                                        for p in params["enc_blocks"])
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, p)
                                        for p in params["dec_blocks"])

    @classmethod
    def from_params(cls, cfg, params: dict, device=None) -> "EncDecLM":
        """A model over an existing parameter tree (no copies)."""
        return cls(cfg, device=device, params=params)

    def params_tree(self) -> dict:
        return {"embed": self.embed, "lm_head": self.lm_head,
                "enc_blocks": [b.params_tree() for b in self.enc_blocks],
                "dec_blocks": [b.params_tree() for b in self.dec_blocks],
                "ln_enc": self.ln_enc, "ln_dec": self.ln_dec}

    # ---------------- params ----------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "EncDecLM":
        """Random weights drawn from ``gen`` (a generator on this model's
        device), with JAX's distributions: N(0, 0.02^2) embeddings, N(0,
        1/fan_in) projections, unit norm weights.  Returns ``self``."""
        embed_init(gen, self.embed)
        dense_init(gen, self.lm_head)
        for blk in (*self.enc_blocks, *self.dec_blocks):
            tree = blk.params_tree()
            for part in ("attn", "self_attn", "cross_attn", "mlp"):
                for w in tree.get(part, {}).values():
                    dense_init(gen, w)
        return self

    # ---------------- forward ----------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, D), the stubbed frontend's output -> the
        encoder's normed output (B, T_enc, D)."""
        positions = torch.arange(frames.shape[1], device=frames.device)[None]
        x = frames
        for blk in self.enc_blocks:
            x = blk(x, positions=positions)
        return rms_norm(x, self.ln_enc, self.cfg.norm_eps)

    def decode(self, tokens: torch.Tensor, enc_out: torch.Tensor, *,
               caches=None, cache_index=0, training: bool = False):
        """Returns (hidden (B, S, D), caches).  ``cache_index``: a Python
        int, or a (B,) tensor of per-row decode depths (S = 1).
        ``training`` with ``cfg.remat`` recomputes each decoder block in
        the backward."""
        x = F.embedding(tokens, self.embed)
        positions = token_positions(tokens.shape[1], cache_index, x.device)
        remat = training and self.cfg.remat and torch.is_grad_enabled()
        new_caches = [] if caches is not None else None
        for i, blk in enumerate(self.dec_blocks):
            run = remat_of(self.cfg, blk) if remat else blk
            x, c = run(x, enc_out, positions=positions,
                       cache=caches[i] if caches is not None else None,
                       cache_index=cache_index)
            if caches is not None:
                new_caches.append(c)
        return rms_norm(x, self.ln_dec, self.cfg.norm_eps), new_caches

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return quant_matmul(hidden, self.lm_head, None)

    # ---------------- training ----------------
    def loss(self, batch: dict):
        """batch: frames (B, T_enc, D), tokens (B, S), labels (B, S)[,
        loss_mask (B, S)].  Returns (xent, {"xent"})."""
        enc_out = self.encode(batch["frames"])
        hidden, _ = self.decode(batch["tokens"], enc_out, training=True)
        xent = chunked_xent(hidden, self.lm_head, batch["labels"],
                            batch.get("loss_mask"))
        return xent, {"xent": xent}

    # ---------------- serving ----------------
    def init_cache(self, batch: int, s_max: int, *,
                   spec: CacheSpec | None = None) -> list[KVCache]:
        """The decoder's self-attention KV only: one KVCache of (batch,
        s_max, Hkv, Dh) zeros a layer; a paged spec is refused (the engine
        does not page modality backbones)."""
        reject_paged_spec(spec, "encdec", "the decoder KV slab is served "
                          "dense (no engine-managed block tables)")
        cfg = self.cfg
        shape = (batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = dtype_of(cfg)
        return [KVCache(torch.zeros(shape, dtype=dt, device=self.device),
                        torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(cfg.num_layers)]

    def prefill(self, tokens, caches, *, frames, last_pos=None):
        """Encode ``frames``, then the prompt forward writing ``caches``
        from 0; returns the (B, 1, V) logits at ``last_pos`` (default: the
        last column) and the state ``(caches, enc_out)``."""
        enc_out = self.encode(frames)
        hidden, caches = self.decode(tokens, enc_out, caches=caches,
                                     cache_index=0)
        last = (hidden[:, -1:] if last_pos is None
                else gather_last(hidden, last_pos))
        return self.logits(last), (caches, enc_out)

    def decode_step(self, token, state, index, *, tables=None):
        """token: (B, 1); ``index``: int shared by all rows, or a (B,)
        tensor of per-row decoder positions; ``state``: ``(caches,
        enc_out)``.  ``tables`` must be None (dense decoder KV), accepted
        for the engine's uniform contract."""
        if tables is not None:
            raise ValueError("encdec caches are dense (no block table)")
        caches, enc_out = state
        hidden, caches = self.decode(token, enc_out, caches=caches,
                                     cache_index=index)
        return self.logits(hidden), (caches, enc_out)
