"""Decoder-only transformer LM, dense GQA family (mirrors
``repro.models.transformer``).

The JAX model stacks its layers on a leading L axis and runs them under
``lax.scan``; here the layers are an ``nn.ModuleList`` and ``forward`` is
a Python loop.  Parameters live on the module.  ``params_tree()`` returns
them as the JAX tree's nesting with a per-layer list in place of the
stacked axis (``{"embed", "ln_f", "lm_head", "blocks": [{"ln1", "ln2",
"attn": {...}, "mlp": {...}}, ...]}``), and :meth:`TransformerLM.
from_params` builds a model over such a tree without copying, which is how
the engine's frozen 4-bit decode model shares every other tensor with the
full-precision one.

Training: ``forward(..., training=True)`` recomputes each block in the
backward (``cfg.remat``, JAX's ``jax.checkpoint``), and :meth:`loss` is
JAX's sequence-chunked cross entropy (:func:`chunked_xent`), which never
holds (S, V) logits for S > 256.  ``model.requires_grad_()`` makes the
float leaves trainable (they are frozen parameters by default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.layers import quant_matmul
from repro_torch.device import resolve_device
from repro_torch.models.attention import GQAAttention, KVCache, gqa_shapes
from repro_torch.models.common import (CacheSpec, dense_init, dtype_of,
                                       embed_init, gather_last, paged_rows,
                                       remat_of, rms_norm, set_leaf,
                                       token_positions)
from repro_torch.models.mlp import MLP, mlp_shapes


def _empty_params(cfg, device) -> dict:
    """Uninitialised weights (norm weights are f32 ones, as in JAX)."""
    dt = dtype_of(cfg)

    def mat(shape):
        return torch.empty(shape, dtype=dt, device=device)

    def ones():
        return torch.ones(cfg.d_model, dtype=torch.float32, device=device)

    params = {"embed": mat((cfg.vocab_size, cfg.d_model)), "ln_f": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = mat((cfg.d_model, cfg.vocab_size))
    params["blocks"] = [
        {"ln1": ones(), "ln2": ones(),
         "attn": {n: mat(s) for n, s in gqa_shapes(cfg).items()},
         "mlp": {n: mat(s) for n, s in mlp_shapes(cfg).items()}}
        for _ in range(cfg.num_layers)]
    return params


class Block(nn.Module):
    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        set_leaf(self, "ln1", params["ln1"])
        set_leaf(self, "ln2", params["ln2"])
        self.attn = GQAAttention(cfg, params["attn"])
        self.mlp = MLP(cfg, params["mlp"])

    def forward(self, x, *, positions, cache, cache_index, paged=None):
        h = rms_norm(x, self.ln1, self.cfg.norm_eps)
        a, cache = self.attn(h, positions=positions, cache=cache,
                             cache_index=cache_index, paged=paged)
        x = x + a
        h = rms_norm(x, self.ln2, self.cfg.norm_eps)
        return x + self.mlp(h), cache

    def params_tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2,
                "attn": {n: getattr(self.attn, n) for n in gqa_shapes(self.cfg)},
                "mlp": {n: getattr(self.mlp, n) for n in mlp_shapes(self.cfg)}}


class TransformerLM(nn.Module):
    """Dense GQA decoder LM on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, cfg, device=None, params: dict | None = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP queue 1 "
                "item 7")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = _empty_params(cfg, self.device)
        set_leaf(self, "embed", params["embed"])
        set_leaf(self, "ln_f", params["ln_f"])
        if not cfg.tie_embeddings:
            set_leaf(self, "lm_head", params["lm_head"])
        self.blocks = nn.ModuleList(Block(cfg, p) for p in params["blocks"])

    @classmethod
    def from_params(cls, cfg, params: dict, device=None) -> "TransformerLM":
        """A model over an existing parameter tree (no copies)."""
        return cls(cfg, device=device, params=params)

    def params_tree(self) -> dict:
        tree = {"embed": self.embed, "ln_f": self.ln_f}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        tree["blocks"] = [blk.params_tree() for blk in self.blocks]
        return tree

    # ---------------- params ----------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "TransformerLM":
        """Random weights drawn from ``gen`` (a generator on this model's
        device): N(0, 0.02^2) embeddings, N(0, 1/fan_in) projections, unit
        norm weights.  Returns ``self``."""
        embed_init(gen, self.embed)
        if not self.cfg.tie_embeddings:
            dense_init(gen, self.lm_head)
        for blk in self.blocks:
            for name in gqa_shapes(self.cfg):
                dense_init(gen, getattr(blk.attn, name))
            for name in mlp_shapes(self.cfg):
                dense_init(gen, getattr(blk.mlp, name))
        return self

    # ---------------- forward ----------------
    def forward(self, tokens: torch.Tensor, *, caches=None, cache_index=0,
                block_tables: torch.Tensor | None = None,
                training: bool = False):
        """Returns (hidden (B, S, D), caches).  ``block_tables``: (B, nblk)
        when ``caches`` hold paged pools (one tensor for every layer).
        ``training`` with ``cfg.remat`` recomputes each block in the
        backward."""
        x = F.embedding(tokens, self.embed)
        positions = token_positions(tokens.shape[1], cache_index, x.device)
        paged = None
        if block_tables is not None:
            # each row's write target, once for every layer
            paged = paged_rows(block_tables, cache_index,
                               caches[0].k.shape[1])
        new_caches = [] if caches is not None else None
        remat = training and self.cfg.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            run = remat_of(self.cfg, blk) if remat else blk
            x, c = run(x, positions=positions,
                       cache=caches[i] if caches is not None else None,
                       cache_index=cache_index, paged=paged)
            if caches is not None:
                new_caches.append(c)
        return rms_norm(x, self.ln_f, self.cfg.norm_eps), new_caches

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return quant_matmul(hidden, self._head(), None)

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    # ---------------- training ----------------
    def loss(self, batch: dict):
        """batch: tokens (B, S), labels (B, S)[, loss_mask (B, S)].
        Returns (xent + aux, {"xent", "aux"}); aux is 0 for the dense
        family."""
        hidden, _ = self.forward(batch["tokens"], training=True)
        xent = chunked_xent(hidden, self._head(), batch["labels"],
                            batch.get("loss_mask"))
        aux = torch.zeros((), dtype=torch.float32, device=xent.device)
        return xent + aux, {"xent": xent, "aux": aux}

    # ---------------- serving ----------------
    def init_cache(self, batch: int, s_max: int, *,
                   spec: CacheSpec | None = None) -> list[KVCache]:
        """Dense slab caches by default: one KVCache of (batch, s_max, Hkv,
        Dh) zeros per layer.  With a paged ``spec`` every leaf is a pool
        of (num_blocks, block_size, Hkv, Dh) zeros shared by all slots and
        read through per-row block tables (``batch``/``s_max`` then size
        nothing)."""
        cfg = self.cfg
        lead = ((spec.num_blocks, spec.block_size)
                if spec is not None and spec.paged else (batch, s_max))
        shape = lead + (cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = dtype_of(cfg)
        return [KVCache(torch.zeros(shape, dtype=dt, device=self.device),
                        torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(cfg.num_layers)]

    def prefill(self, tokens, caches, *, last_pos=None, cache_index=0):
        """Prompt forward writing ``caches`` at ``cache_index``; returns the
        (B, 1, V) logits at ``last_pos`` (default: the last column).
        Chunked prefill feeds the prompt in pieces, each continuing the
        staged cache at the previous piece's end."""
        hidden, caches = self.forward(tokens, caches=caches,
                                      cache_index=cache_index)
        last = (hidden[:, -1:] if last_pos is None
                else gather_last(hidden, last_pos))
        return self.logits(last), caches

    def decode_step(self, token, state, index, *, tables=None):
        """token: (B, 1); index: int shared by all rows, or a (B,) tensor of
        per-row positions.  ``tables``: (B, nblk) block tables when
        ``state`` holds paged pools.  Under the engine's frozen decode
        model every projection runs the LUT GEMM of its
        ``QuantizedWeight``."""
        hidden, caches = self.forward(token, caches=state, cache_index=index,
                                      block_tables=tables)
        return self.logits(hidden), caches


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor | None = None,
                 chunk: int = 256) -> torch.Tensor:
    """Sequence-chunked cross entropy (JAX's ``chunked_xent``): the
    logits of one ``chunk`` of positions at a time, summed in order.
    Under autograd each chunk is recomputed in the backward, so (S, V)
    logits are never held for S > ``chunk``."""
    b, s, _ = hidden.shape
    if s <= chunk:
        return _xent((hidden @ head).float(), labels, mask)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {chunk}")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)

    def piece(h, lab, m):
        logits = (h @ head).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return ((logz - gold) * m).sum(), m.sum()

    run = piece
    if torch.is_grad_enabled() and (hidden.requires_grad
                                    or head.requires_grad):
        def run(*xs):
            return checkpoint(piece, *xs, use_reentrant=False)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        t, c = run(hidden[:, i:i + chunk], labels[:, i:i + chunk],
                   mask[:, i:i + chunk])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
