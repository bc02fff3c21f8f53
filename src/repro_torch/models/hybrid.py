"""Zamba2-style hybrid LM: a Mamba2 backbone with one weight-SHARED
attention + MLP block applied every ``period`` layers (mirrors
``repro.models.hybrid``).

Layers run in groups: the shared block, then up to ``period`` Mamba2
layers.  The shared block's weights are reused at every application
point, but each application keeps its own KV cache.  The same
engine-facing interface as :class:`~repro_torch.models.transformer.
TransformerLM` and :class:`~repro_torch.models.ssm_lm.SSMLM`:
``init(gen)``, ``from_params``, ``params_tree``, ``forward``, ``logits``,
``loss``, ``init_cache``, ``prefill``, ``decode_step``, ``decode_window``,
``state_snapshot`` and ``seed_from_snapshot``.

``params_tree()`` nests as JAX's tree does: ``{"embed", "lm_head",
"ln_f", "shared": {"ln1", "ln2", "attn": {wq, wk, wv, wo}, "mlp":
{w_gate, w_up, w_down}}, "mamba": [{"ln", "m": {...}}, ...]}`` with a
per-layer list in place of JAX's stacked axis, so the engine's frozen
decode tree freezes JAX's leaves (the shared block's seven projections
and each Mamba2 layer's ``w_in``/``w_out``).

The caches are ONE flat list of named tuples: the ``num_groups`` shared-
block :class:`~repro_torch.models.attention.KVCache` leaves first, then
the ``num_layers`` :class:`~repro_torch.models.ssm.SSMCache` leaves (JAX
keeps an ``(attn_caches, ssm_caches)`` pair).  Under a paged
``CacheSpec`` the KV leaves are block pools and the SSM leaves stay
dense per slot: the split substrate
(:class:`~repro_torch.serve.backend.HybridComposite`), which tells the
halves apart by leaf type.  The KV half is written IN PLACE, as every
attention cache of the port; the SSM half always comes back as new
tensors and the list itself is new, so a caller holding the pre-call
list (speculation's ``pre``) still holds the pre-call recurrent state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import quant_matmul
from repro_torch.device import resolve_device
from repro_torch.models.attention import GQAAttention, KVCache, gqa_shapes
from repro_torch.models.common import (CacheSpec, cache_targets, dense_init,
                                       dtype_of, embed_init, gather_last,
                                       remat_of, rms_norm, set_leaf,
                                       token_positions)
from repro_torch.models.mlp import MLP, mlp_shapes
from repro_torch.models.ssm import (SSMCache, init_mamba2, mamba2_shapes,
                                    snapshot_row, ssm_cache_shape)
from repro_torch.models.ssm_lm import SSMBlock
from repro_torch.models.transformer import chunked_xent


def shared_heads(cfg) -> dict:
    """The shared block's attention overrides: its own heads and KV heads,
    head dim ``d_model // shared_num_heads``."""
    hc = cfg.hybrid
    return dict(num_heads=hc.shared_num_heads,
                num_kv_heads=hc.shared_num_kv_heads,
                head_dim=cfg.d_model // hc.shared_num_heads)


def _shared_mlp_shapes(cfg) -> dict:
    return mlp_shapes(cfg, cfg.hybrid.shared_d_ff, "swiglu")


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
        "ln_f": ones(),
        "shared": {"ln1": ones(), "ln2": ones(),
                   "attn": mats(gqa_shapes(cfg, **shared_heads(cfg))),
                   "mlp": mats(_shared_mlp_shapes(cfg))},
        "mamba": [
            {"ln": ones(),
             "m": {n: torch.empty(shape, dtype=dtype, device=device)
                   for n, (shape, dtype) in mamba2_shapes(cfg).items()}}
            for _ in range(cfg.num_layers)],
    }


class SharedBlock(nn.Module):
    """The weight-shared attention + SwiGLU MLP block (JAX's
    ``HybridLM._shared_attn``)."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        set_leaf(self, "ln1", params["ln1"])
        set_leaf(self, "ln2", params["ln2"])
        self.attn = GQAAttention(cfg, params["attn"], **shared_heads(cfg))
        self.mlp = MLP(cfg, params["mlp"], mlp_type="swiglu")

    def forward(self, x, *, positions, cache, cache_index, paged=None,
                window=None, n_valid=None):
        a, cache = self.attn(rms_norm(x, self.ln1, self.cfg.norm_eps),
                             positions=positions, cache=cache,
                             cache_index=cache_index, paged=paged,
                             window=window, n_valid=n_valid)
        x = x + a
        return x + self.mlp(rms_norm(x, self.ln2, self.cfg.norm_eps)), cache

    def params_tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2,
                "attn": {n: getattr(self.attn, n) for n in gqa_shapes(
                    self.cfg)},
                "mlp": {n: getattr(self.mlp, n)
                        for n in _shared_mlp_shapes(self.cfg)}}


class HybridLM(nn.Module):
    """Zamba2-style hybrid LM on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, cfg, device=None, params: dict | None = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLM serves the hybrid family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        period = cfg.hybrid.period
        self.num_groups = (cfg.num_layers + period - 1) // period
        if params is None:
            params = _empty_params(cfg, self.device)
        set_leaf(self, "embed", params["embed"])
        set_leaf(self, "lm_head", params["lm_head"])
        set_leaf(self, "ln_f", params["ln_f"])
        self.shared = SharedBlock(cfg, params["shared"])
        self.mamba = nn.ModuleList(SSMBlock(cfg, p) for p in params["mamba"])

    @classmethod
    def from_params(cls, cfg, params: dict, device=None) -> "HybridLM":
        """A model over an existing parameter tree (no copies)."""
        return cls(cfg, device=device, params=params)

    def params_tree(self) -> dict:
        return {"embed": self.embed, "lm_head": self.lm_head,
                "ln_f": self.ln_f, "shared": self.shared.params_tree(),
                "mamba": [blk.params_tree() for blk in self.mamba]}

    # ---------------- params ----------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "HybridLM":
        """Random weights drawn from ``gen`` (a generator on this model's
        device), with JAX's distributions: N(0, 0.02^2) embeddings, N(0,
        1/fan_in) projections, unit norm weights, and each Mamba2 layer
        as ``init_mamba2``.  Returns ``self``."""
        embed_init(gen, self.embed)
        dense_init(gen, self.lm_head)
        tree = self.shared.params_tree()
        for part in ("attn", "mlp"):
            for w in tree[part].values():
                dense_init(gen, w)
        for blk in self.mamba:
            init_mamba2(gen, blk.m.params_tree())
        return self

    # ---------------- forward ----------------
    def forward(self, tokens: torch.Tensor, *, caches=None, cache_index=0,
                block_tables: torch.Tensor | None = None, n_valid=None,
                last_pos=None, training: bool = False):
        """Returns (hidden (B, S, D), caches): per group, the shared block
        with that group's KV cache, then up to ``period`` Mamba2 layers.
        ``cache_index``, ``block_tables`` and ``n_valid`` reach the shared
        block (:meth:`TransformerLM.forward`'s meaning; the write targets
        are computed once for every group); ``last_pos`` (B,) reaches the
        Mamba2 layers (positions past it stay out of the recurrent
        state).  ``training`` with ``cfg.remat`` recomputes each Mamba2
        layer in the backward (JAX checkpoints the scan body only).  The
        returned cache list is new: KV leaves the same tensors (written
        in place), SSM leaves new tensors."""
        cfg = self.cfg
        x = F.embedding(tokens, self.embed)
        s = tokens.shape[1]
        positions = token_positions(s, cache_index, x.device)
        g_n = self.num_groups
        attn_caches = caches[:g_n] if caches is not None else None
        ssm_caches = caches[g_n:] if caches is not None else None
        paged, window = cache_targets(
            attn_caches[0] if caches is not None else None, s, cache_index,
            block_tables, n_valid)
        remat = training and cfg.remat and torch.is_grad_enabled()
        new_attn, new_ssm = [], []
        period = cfg.hybrid.period
        for g in range(g_n):
            x, c = self.shared(
                x, positions=positions,
                cache=attn_caches[g] if caches is not None else None,
                cache_index=cache_index, paged=paged, window=window,
                n_valid=n_valid)
            new_attn.append(c)
            for i in range(g * period, min((g + 1) * period,
                                           cfg.num_layers)):
                blk = self.mamba[i]
                run = remat_of(cfg, blk) if remat else blk
                x, c = run(x, ssm_caches[i] if caches is not None else None,
                           last_pos)
                new_ssm.append(c)
        hidden = rms_norm(x, self.ln_f, cfg.norm_eps)
        return hidden, (new_attn + new_ssm if caches is not None else None)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return quant_matmul(hidden, self.lm_head, None)

    # ---------------- training ----------------
    def loss(self, batch: dict):
        """batch: tokens (B, S), labels (B, S)[, loss_mask (B, S)].
        Returns (xent, {"xent"}), JAX's sequence-chunked cross entropy."""
        hidden, _ = self.forward(batch["tokens"], training=True)
        xent = chunked_xent(hidden, self.lm_head, batch["labels"],
                            batch.get("loss_mask"))
        return xent, {"xent": xent}

    # ---------------- serving ----------------
    def init_cache(self, batch: int, s_max: int, *,
                   spec: CacheSpec | None = None) -> list:
        """The split substrate's zeroed caches: ``num_groups`` KVCaches of
        (batch, s_max, Hkv, Dh) slabs, or with a paged ``spec`` of
        (num_blocks, block_size, Hkv, Dh) pools shared by every slot (one
        block table a row, read by every group); then ``num_layers``
        SSMCaches, dense per slot either way (O(1) recurrent state:
        nothing to page)."""
        cfg = self.cfg
        heads = shared_heads(cfg)
        lead = ((spec.num_blocks, spec.block_size)
                if spec is not None and spec.paged else (batch, s_max))
        dt = dtype_of(cfg)
        kv_shape = lead + (heads["num_kv_heads"], heads["head_dim"])
        kv = [KVCache(*(torch.zeros(kv_shape, dtype=dt, device=self.device)
                        for _ in range(2)))
              for _ in range(self.num_groups)]
        conv_s, state_s = ssm_cache_shape(cfg, batch)
        return kv + [SSMCache(
            torch.zeros(conv_s, dtype=dt, device=self.device),
            torch.zeros(state_s, dtype=torch.float32, device=self.device))
            for _ in range(cfg.num_layers)]

    def state_snapshot(self, caches, row: int = 0) -> list[SSMCache]:
        """Prefix-cache export: the SSM half of the split substrate at
        ``row``, copied (:func:`~repro_torch.models.ssm.snapshot_row`);
        the KV for the same boundary lives in the pool's (refcount-
        shared) blocks, not in the snapshot."""
        return [snapshot_row(c, row) for c in caches[self.num_groups:]]

    def seed_from_snapshot(self, staging, snap) -> list:
        """Warm admission: keep the staging KV leaves (the engine has
        gathered the cached prefix's blocks into them) and copy the
        snapshot's recurrent state into the staging row.  The snapshot
        stays the prefix cache's own."""
        for st, sn in zip(staging[self.num_groups:], snap):
            st.conv.copy_(sn.conv)
            st.state.copy_(sn.state)
        return staging

    def prefill(self, tokens, caches, *, last_pos=None, cache_index=0):
        """Prompt forward continuing ``caches``; returns the (B, 1, V)
        logits at ``last_pos`` (default: the last column) and the new
        caches.  ``last_pos``: (B,) each right-padded row's last real
        token: attention masks the pad keys causally, the Mamba2 layers
        keep them out of the recurrent state.  ``cache_index`` > 0
        continues a chunked prefill: the shared block writes the piece at
        that offset, the scan resumes from the carried state."""
        hidden, caches = self.forward(tokens, caches=caches,
                                      cache_index=cache_index,
                                      last_pos=last_pos)
        last = (hidden[:, -1:] if last_pos is None
                else gather_last(hidden, last_pos))
        return self.logits(last), caches

    def decode_step(self, token, state, index, *, tables=None):
        """token: (B, 1); ``index``: an int or (B,) per-row positions (the
        shared block's caches honour per-row depths; the recurrence is
        position-free).  ``tables``: (B, nblk) when the KV leaves are
        paged pools (the split substrate); the SSM state is dense."""
        hidden, caches = self.forward(token, caches=state, cache_index=index,
                                      block_tables=tables)
        return self.logits(hidden), caches

    def decode_window(self, tokens, state, index, *, tables=None,
                      n_valid=None, last_pos=None):
        """Speculative verify / commit over a (B, W) window on either
        substrate: the shared block writes the window at per-row depths
        (``n_valid`` columns real, the rest dropped and masked), the
        Mamba2 layers run the masked scan bounded by ``last_pos``
        (default ``n_valid - 1``).  Verify passes ``last_pos = n_valid -
        1``; a partial-accept commit re-runs from the pre-verify caches
        with ``last_pos`` = the accepted count, and its shared block
        rewrites identical K/V up to the accept point (what lies beyond
        is dead weight).  ``state``'s SSM leaves are only read.  Returns
        (logits (B, W, V), caches)."""
        if last_pos is None and n_valid is not None:
            last_pos = n_valid - 1
        hidden, caches = self.forward(tokens, caches=state, cache_index=index,
                                      block_tables=tables, n_valid=n_valid,
                                      last_pos=last_pos)
        return self.logits(hidden), caches
