"""Decoder-only transformer LM: the dense GQA family and the moe family
(DeepSeek-V2: capacity-routed MoE with shared experts, MLA attention);
mirrors ``repro.models.transformer``.

The JAX model stacks its layers on a leading L axis and runs them under
``lax.scan``; here the layers are an ``nn.ModuleList`` and ``forward`` is
a Python loop.  Parameters live on the module.  ``params_tree()`` returns
them as the JAX tree's nesting with a per-layer list in place of the
stacked axis (``{"embed", "ln_f", "lm_head", "blocks": [{"ln1", "ln2",
"attn": {...}, "mlp": {...}}, ...]}``; the moe family's leading
``first_dense`` blocks under ``"dense_blocks"``, its MoE blocks' feed-
forward under ``"moe": {"router", "w_gate", "w_up", "w_down", "shared":
{...}}``), and :meth:`TransformerLM.from_params` builds a model over such
a tree without copying, which is how the engine's frozen 4-bit decode
model shares every other tensor with the full-precision one.

Caches are one list over all layers, the dense blocks first (JAX keeps a
``(dense_caches, stacked_caches)`` pair).

Training: ``forward(..., training=True)`` recomputes each block in the
backward (``cfg.remat``, JAX's ``jax.checkpoint``), and :meth:`loss` is
JAX's sequence-chunked cross entropy (:func:`chunked_xent`) plus the MoE
blocks' summed load-balance loss, and never holds (S, V) logits for S >
256.  ``model.requires_grad_()`` makes the float leaves trainable (they
are frozen parameters by default).

On a mesh (:meth:`TransformerLM.split_over_model`, which
``parallel.fsdp.shard_model`` and ``parallel.tensor_parallel.
serving_model`` call) the attention blocks (GQA and MLA heads), the dense
MLPs, the MoE feed-forwards (the experts and the shared experts) and the
vocabulary compute their ``model`` shard: a vocab-parallel embedding, a
vocab-split head whose decode logits are gathered, and a vocab-parallel
cross entropy (:func:`chunked_xent`'s ``vocab``), JAX's GSPMD split of
the same specs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.layers import quant_matmul
from repro_torch.device import resolve_device
from repro_torch.models.attention import (GQAAttention, KVCache,
                                          MLAAttention, gqa_shapes,
                                          mla_shapes)
from repro_torch.models.common import (CacheSpec, cache_targets,
                                       dense_init, dtype_of, embed_init,
                                       gather_last, remat_of, rms_norm,
                                       set_leaf, token_positions)
from repro_torch.models.mlp import MLP, mlp_shapes
from repro_torch.models.moe import MoE, moe_shapes
from repro_torch.parallel import act_sharding
from repro_torch.parallel import tensor_parallel as tp

#: the families this module serves (``vlm``: the backbone of
#: :class:`~repro_torch.models.vlm.VLM`)
FAMILIES = ("dense", "moe", "vlm")


def _attn_shapes(cfg) -> dict:
    return mla_shapes(cfg) if cfg.mla else gqa_shapes(cfg)


def _n_dense(cfg) -> int:
    """Leading dense blocks: the moe family's ``first_dense``, else 0
    (every block of the dense family is under ``"blocks"``)."""
    return cfg.moe.first_dense if cfg.moe else 0


def _empty_params(cfg, device) -> dict:
    """Uninitialised weights (norm weights and the router are f32, as in
    JAX)."""
    dt = dtype_of(cfg)

    def mat(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=device)

    def ones():
        return torch.ones(cfg.d_model, dtype=torch.float32, device=device)

    def tree(shapes):
        return {n: tree(s) if isinstance(s, dict)
                else mat(s, torch.float32 if n == "router" else dt)
                for n, s in shapes.items()}

    def block(use_moe: bool, d_ff=None):
        p = {"ln1": ones(), "ln2": ones(), "attn": tree(_attn_shapes(cfg))}
        if use_moe:
            p["moe"] = tree(moe_shapes(cfg))
        else:
            p["mlp"] = tree(mlp_shapes(cfg, d_ff))
        return p

    params = {"embed": mat((cfg.vocab_size, cfg.d_model)), "ln_f": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = mat((cfg.d_model, cfg.vocab_size))
    n_dense = _n_dense(cfg)
    if n_dense:
        params["dense_blocks"] = [block(False, cfg.moe.dense_ff or cfg.d_ff)
                                  for _ in range(n_dense)]
    params["blocks"] = [block(cfg.moe is not None)
                        for _ in range(cfg.num_layers - n_dense)]
    return params


class Block(nn.Module):
    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        set_leaf(self, "ln1", params["ln1"])
        set_leaf(self, "ln2", params["ln2"])
        attn = MLAAttention if cfg.mla else GQAAttention
        self.attn = attn(cfg, params["attn"])
        self.use_moe = "moe" in params
        if self.use_moe:
            self.moe = MoE(cfg, params["moe"])
        else:
            self.mlp = MLP(cfg, params["mlp"])

    def forward(self, x, *, positions, cache, cache_index, paged=None,
                window=None, n_valid=None):
        """Returns (x, cache, aux): ``aux`` is the MoE load-balance loss
        (None for a dense block)."""
        h = rms_norm(x, self.ln1, self.cfg.norm_eps)
        a, cache = self.attn(h, positions=positions, cache=cache,
                             cache_index=cache_index, paged=paged,
                             window=window, n_valid=n_valid)
        x = x + a
        h = rms_norm(x, self.ln2, self.cfg.norm_eps)
        if self.use_moe:
            # a verify window groups the routing by column (JAX passes
            # window = n_valid is not None)
            f, aux = self.moe(h, window=n_valid is not None)
        else:
            f, aux = self.mlp(h), None
        return x + f, cache, aux

    def params_tree(self) -> dict:
        tree = {"ln1": self.ln1, "ln2": self.ln2,
                "attn": {n: getattr(self.attn, n)
                         for n in _attn_shapes(self.cfg)}}
        if self.use_moe:
            tree["moe"] = self.moe.params_tree()
        else:
            tree["mlp"] = {n: getattr(self.mlp, n)
                           for n in mlp_shapes(self.cfg)}
        return tree


class TransformerLM(nn.Module):
    """Dense GQA or moe (MoE + MLA) decoder LM, or the vlm family's
    backbone, on ``device`` (the card unless ``"cpu"``).  ``blocks`` holds
    every layer in order, the moe family's ``first_dense`` dense blocks
    first."""

    def __init__(self, cfg, device=None, params: dict | None = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"TransformerLM serves the {FAMILIES} families, not "
                f"{cfg.family!r}: ROADMAP queue 1 item 7 ported the JAX "
                "registry's six, and registry.model_class picks each one's "
                "class")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = _empty_params(cfg, self.device)
        set_leaf(self, "embed", params["embed"])
        set_leaf(self, "ln_f", params["ln_f"])
        if not cfg.tie_embeddings:
            set_leaf(self, "lm_head", params["lm_head"])
        self.n_dense = len(params.get("dense_blocks", []))
        self.blocks = nn.ModuleList(
            Block(cfg, p) for p in (params.get("dense_blocks", [])
                                    + list(params["blocks"])))
        #: (embedding, head) split over the model axis
        #: (``tensor_parallel.plan``)
        self.vocab_split = (False, False)

    def split_over_model(self, specs: dict, m: int, serving: bool) -> dict:
        """Mark the parts that compute their ``model`` shard under
        ``specs`` (a tree like :meth:`params_tree`) on a model axis of
        ``m``; returns {leaf path: fsdp mode} of the split leaves
        (``tensor_parallel.plan``).  Per block: GQA attention
        (``tensor_parallel.attn_plan``), MLA attention (``mla_plan``), a
        dense MLP (``mlp_plan``; the moe family's ``first_dense`` blocks
        too) and an MoE feed-forward (``moe_plan``: the experts and the
        shared experts).  The vocabulary: the embedding when ``embed``'s
        rows, the head when ``lm_head``'s columns (tied: ``embed``'s rows)
        are split."""
        cfg = self.cfg
        modes = {}
        per = specs.get("dense_blocks", []) + list(specs["blocks"])
        names = ([f"dense_blocks/{i}" for i in range(self.n_dense)]
                 + [f"blocks/{i}" for i in range(len(per) - self.n_dense)])
        for blk, bspec, name in zip(self.blocks, per, names):
            if isinstance(blk.attn, GQAAttention):
                blk.attn.split, got = tp.attn_plan(
                    bspec["attn"], blk.attn.heads, m, serving=serving)
            else:
                blk.attn.split, got = tp.mla_plan(bspec["attn"],
                                                  cfg.num_heads, m)
            modes.update({f"{name}/attn/{k}": v for k, v in got.items()})
            if blk.use_moe:
                blk.moe.split, got = tp.moe_plan(
                    bspec["moe"], cfg.moe.num_experts, m)
                modes.update({f"{name}/moe/{k}": v for k, v in got.items()})
            else:
                blk.mlp.split, got = tp.mlp_plan(bspec["mlp"])
                modes.update({f"{name}/mlp/{k}": v for k, v in got.items()})
        emb = tp.row(specs["embed"])
        head = emb if cfg.tie_embeddings else tp.col(specs["lm_head"])
        self.vocab_split = (emb, head)
        if emb:
            modes["embed"] = tp.LOCAL
        if head and not cfg.tie_embeddings:
            modes["lm_head"] = tp.LOCAL
        return modes

    @classmethod
    def from_params(cls, cfg, params: dict, device=None) -> "TransformerLM":
        """A model over an existing parameter tree (no copies)."""
        return cls(cfg, device=device, params=params)

    def params_tree(self) -> dict:
        tree = {"embed": self.embed, "ln_f": self.ln_f}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        per = [blk.params_tree() for blk in self.blocks]
        if self.n_dense:
            tree["dense_blocks"] = per[:self.n_dense]
        tree["blocks"] = per[self.n_dense:]
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
            for name in _attn_shapes(self.cfg):
                dense_init(gen, getattr(blk.attn, name))
            if not blk.use_moe:
                for name in mlp_shapes(self.cfg):
                    dense_init(gen, getattr(blk.mlp, name))
                continue
            moe = blk.moe
            dense_init(gen, moe.router)
            d, ff = self.cfg.d_model, self.cfg.moe.d_expert
            for name, fan_in in (("w_gate", d), ("w_up", d),
                                 ("w_down", ff)):
                dense_init(gen, getattr(moe, name), scale=1.0 / fan_in ** 0.5)
            if self.cfg.moe.num_shared:
                for name in ("w_gate", "w_up", "w_down"):
                    dense_init(gen, getattr(moe.shared, name))
        return self

    # ---------------- forward ----------------
    def forward(self, tokens: torch.Tensor | None = None, *, embeds=None,
                caches=None, cache_index=0,
                block_tables: torch.Tensor | None = None, n_valid=None,
                training: bool = False):
        """Returns (hidden (B, S, D), caches); :meth:`forward_aux` also
        returns the MoE blocks' summed load-balance loss.  ``embeds`` (B,
        S, D) takes the place of ``tokens``' embeddings (the vlm family's
        patches before its text)."""
        hidden, _, caches = self._run(
            tokens, embeds=embeds, caches=caches, cache_index=cache_index,
            block_tables=block_tables, n_valid=n_valid, training=training)
        return hidden, caches

    def forward_aux(self, tokens: torch.Tensor | None = None, **kw):
        """Returns (hidden (B, S, D), aux, caches): :meth:`forward`'s, and
        the MoE blocks' summed load-balance loss (0 for the dense
        family)."""
        hidden, aux, caches = self._run(tokens, **kw)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        return hidden, aux, caches

    def _run(self, tokens: torch.Tensor | None, *, embeds=None, caches=None,
             cache_index=0, block_tables: torch.Tensor | None = None,
             n_valid=None, training: bool = False):
        """Returns (hidden (B, S, D), aux or None, caches).
        ``block_tables``: (B, nblk) when ``caches`` hold paged pools (one
        tensor for every layer).
        ``n_valid`` (B,), or per-row ``cache_index`` with S > 1: a verify
        window (JAX's ``n_valid`` through the blocks), whose write targets
        are computed once here for every layer.  ``training`` with
        ``cfg.remat`` recomputes each block in the backward."""
        x = embeds if embeds is not None else self.embed_tokens(tokens)
        s = x.shape[1]
        positions = token_positions(s, cache_index, x.device)
        paged, window = cache_targets(
            caches[0] if caches is not None else None, s, cache_index,
            block_tables, n_valid)
        new_caches = [] if caches is not None else None
        remat = training and self.cfg.remat and torch.is_grad_enabled()
        aux = None
        for i, blk in enumerate(self.blocks):
            run = remat_of(self.cfg, blk) if remat else blk
            x, c, aux_i = run(x, positions=positions,
                              cache=caches[i] if caches is not None else None,
                              cache_index=cache_index, paged=paged,
                              window=window, n_valid=n_valid)
            if aux_i is not None:
                aux = aux_i if aux is None else aux + aux_i
            if caches is not None:
                new_caches.append(c)
        return rms_norm(x, self.ln_f, self.cfg.norm_eps), aux, new_caches

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens``' embeddings (vocab-parallel when the embedding is
        split)."""
        if self.vocab_split[0]:
            return tp.embedding(tokens, self.embed)
        return F.embedding(tokens, self.embed)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., V) logits; a vocab-split head's are gathered over the
        model axis, so every rank (greedy, sampling) sees the whole row."""
        if self.vocab_split[1]:
            return tp.gather(quant_matmul(tp.copy(hidden), self._head(),
                                          None))
        return quant_matmul(hidden, self._head(), None)

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    # ---------------- training ----------------
    def loss(self, batch: dict):
        """batch: tokens (B, S) or embeds (B, S, D), labels (B, S)[,
        loss_mask (B, S)].  Returns (xent + aux, {"xent", "aux"}); aux is
        the MoE blocks' summed load-balance loss (0 for the dense
        family)."""
        hidden, aux, _ = self.forward_aux(batch.get("tokens"),
                                          embeds=batch.get("embeds"),
                                          training=True)
        xent = self.xent(hidden, batch["labels"], batch.get("loss_mask"))
        return xent + aux, {"xent": xent, "aux": aux}

    def xent(self, hidden: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
        """:func:`chunked_xent` of ``hidden`` through the head
        (vocab-parallel when the head is split)."""
        head, vocab = self._head(), None
        if self.vocab_split[1]:
            hidden, vocab = tp.copy(hidden), tp.vocab_shard(head.shape[1])
        return chunked_xent(hidden, head, labels, mask, vocab=vocab)

    # ---------------- serving ----------------
    def init_cache(self, batch: int, s_max: int, *,
                   spec: CacheSpec | None = None) -> list[KVCache]:
        """Dense slab caches by default: one KVCache of (batch, s_max, Hkv,
        Dh) zeros per layer (MLA: c_kv (batch, s_max, R) and k_rope
        (batch, s_max, dr)).  With a paged ``spec`` every leaf is a pool
        of (num_blocks, block_size, ...) zeros shared by all slots and
        read through per-row block tables (``batch``/``s_max`` then size
        nothing)."""
        cfg = self.cfg
        lead = ((spec.num_blocks, spec.block_size)
                if spec is not None and spec.paged else (batch, s_max))
        if cfg.mla:
            tails = ((cfg.mla.kv_lora_rank,), (cfg.mla.qk_rope_dim,))
        else:
            tails = ((cfg.num_kv_heads, cfg.resolved_head_dim),) * 2
        dt = dtype_of(cfg)
        return [KVCache(*(torch.zeros(lead + t, dtype=dt, device=self.device)
                          for t in tails))
                for _ in range(cfg.num_layers)]

    def prefill(self, tokens, caches, *, embeds=None, last_pos=None,
                cache_index=0):
        """Prompt forward writing ``caches`` at ``cache_index``; returns the
        (B, 1, V) logits at ``last_pos`` (default: the last column).
        Chunked prefill feeds the prompt in pieces, each continuing the
        staged cache at the previous piece's end.  ``embeds``: as
        :meth:`forward`'s."""
        hidden, caches = self.forward(tokens, embeds=embeds, caches=caches,
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

    def decode_window(self, tokens, state, index, *, tables=None,
                      n_valid=None, last_pos=None):
        """Speculative verify: score a (B, W) window of already chosen
        tokens in one forward.  ``index``: (B,) positions of window column
        0; ``n_valid``: (B,) real tokens a row (the rest write nowhere, or
        on the garbage block, and are masked out of attention; inactive
        rows pass 0).  ``last_pos`` is accepted for the recurrent family's
        signature and ignored: K/V beyond a row's rewound pointer is dead
        weight the next writes overwrite, so the verify-pass cache is the
        committed cache at any accept length.  The writes are in place.
        Returns (logits (B, W, V), caches); logits[:, i] scores the token
        after window column i."""
        del last_pos
        hidden, caches = self.forward(tokens, caches=state, cache_index=index,
                                      block_tables=tables, n_valid=n_valid)
        return self.logits(hidden), caches


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor | None = None,
                 chunk: int = 256, vocab: "tp.VocabShard | None" = None
                 ) -> torch.Tensor:
    """Sequence-chunked cross entropy (JAX's ``chunked_xent``): the
    logits of one ``chunk`` of positions at a time, summed in order.
    Under autograd each chunk is recomputed in the backward, so (S, V)
    logits are never held for S > ``chunk``.

    In a mesh step whose rows are split over ranks (``parallel.
    act_sharding.rows_axes``) the divisor is the GLOBAL token count
    (``act_sharding.batch_sum``), so each rank's loss is its rows' sum
    over the global count and the ranks' losses and gradients sum to
    JAX's; an unmasked mean is the rank's mean over the rank count (every
    rank holds equally many rows).

    ``vocab``: ``head`` holds this rank's columns of the vocabulary
    (``tensor_parallel.vocab_shard``), and the log-partition and gold
    logit come from the ranks' shards (``tensor_parallel.xent_parts``);
    on a one-rank model axis the ops are the unsplit ones."""
    b, s, _ = hidden.shape
    if vocab is not None and vocab.ranks == 1:
        vocab = None
    if s <= chunk:
        return _xent((hidden @ head).float(), labels, mask, vocab)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {chunk}")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)

    def piece(h, lab, m):
        logits = (h @ head).float()
        logz, gold = _logz_gold(logits, lab, vocab)
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
    return tot / torch.clamp_min(act_sharding.batch_sum(cnt.detach()), 1.0)


def _logz_gold(logits, labels, vocab):
    if vocab is not None:
        return tp.xent_parts(logits, labels, vocab)
    logz = torch.logsumexp(logits, dim=-1)
    return logz, torch.gather(logits, -1, labels[..., None].long())[..., 0]


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          mask: torch.Tensor | None = None, vocab=None) -> torch.Tensor:
    logz, gold = _logz_gold(logits.float(), labels, vocab)
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(
            act_sharding.batch_sum(mask.sum().detach()), 1.0)
    n = act_sharding.row_ranks()
    mean = nll.mean()
    return mean if n == 1 else mean / torch.full_like(mean, n)
