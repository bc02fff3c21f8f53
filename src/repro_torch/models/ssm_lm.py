"""Mamba2 (attention-free) LM (mirrors ``repro.models.ssm_lm``).

The same engine-facing interface as :class:`~repro_torch.models.
transformer.TransformerLM`: ``init(gen)``, ``from_params``,
``params_tree``, ``forward``, ``logits``, ``init_cache``, ``prefill``,
``decode_step`` and ``decode_window``, so the engine and
``DenseSlab.prepare_decode_params`` serve it unchanged.  The JAX model
stacks its layers on a leading L axis under ``lax.scan``; here they are
an ``nn.ModuleList`` and the tree's ``blocks`` is a per-layer list of
``{"ln", "m": {...}}``.  The caches are a list of per-layer
:class:`~repro_torch.models.ssm.SSMCache`: conv state (B, K-1, conv
channels) in the model dtype and SSD state (B, H, P, N) in f32.  The
recurrence is position-free, so the cache index is unused.  The prefix
cache snapshots a row of that state (:meth:`SSMLM.state_snapshot`) and
seeds a staging row from it (:meth:`SSMLM.seed_from_snapshot`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import quant_matmul
from repro_torch.device import resolve_device
from repro_torch.models.common import (CacheSpec, dense_init, dtype_of,
                                       embed_init, gather_last,
                                       reject_paged_spec, rms_norm, set_leaf)
from repro_torch.models.ssm import (Mamba2, SSMCache, init_mamba2,
                                    mamba2_shapes, snapshot_row,
                                    ssm_cache_shape)


def _empty_params(cfg, device) -> dict:
    """Uninitialised weights (norm weights are f32 ones, as in JAX)."""
    dt = dtype_of(cfg)

    def ones():
        return torch.ones(cfg.d_model, dtype=torch.float32, device=device)

    return {
        "embed": torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt,
                             device=device),
        "lm_head": torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt,
                               device=device),
        "ln_f": ones(),
        "blocks": [
            {"ln": ones(),
             "m": {n: torch.empty(shape, dtype=dtype, device=device)
                   for n, (shape, dtype) in mamba2_shapes(cfg).items()}}
            for _ in range(cfg.num_layers)],
    }


class SSMBlock(nn.Module):
    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        set_leaf(self, "ln", params["ln"])
        self.m = Mamba2(cfg, params["m"])

    def forward(self, x, cache=None, last_pos=None):
        y, cache = self.m(rms_norm(x, self.ln, self.cfg.norm_eps), cache,
                          last_pos)
        return x + y, cache

    def params_tree(self) -> dict:
        return {"ln": self.ln, "m": self.m.params_tree()}


class SSMLM(nn.Module):
    """Mamba2 LM on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, cfg, device=None, params: dict | None = None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"SSMLM serves the ssm family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = _empty_params(cfg, self.device)
        set_leaf(self, "embed", params["embed"])
        set_leaf(self, "lm_head", params["lm_head"])
        set_leaf(self, "ln_f", params["ln_f"])
        self.blocks = nn.ModuleList(SSMBlock(cfg, p) for p in params["blocks"])

    @classmethod
    def from_params(cls, cfg, params: dict, device=None) -> "SSMLM":
        """A model over an existing parameter tree (no copies)."""
        return cls(cfg, device=device, params=params)

    def params_tree(self) -> dict:
        return {"embed": self.embed, "lm_head": self.lm_head,
                "ln_f": self.ln_f,
                "blocks": [blk.params_tree() for blk in self.blocks]}

    # ---------------- params ----------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "SSMLM":
        """Random weights drawn from ``gen`` (a generator on this model's
        device), as JAX's ``SSMLM.init`` draws them.  Returns ``self``."""
        embed_init(gen, self.embed)
        dense_init(gen, self.lm_head)
        for blk in self.blocks:
            init_mamba2(gen, blk.m.params_tree())
        return self

    # ---------------- forward ----------------
    def forward(self, tokens: torch.Tensor, *, caches=None, last_pos=None):
        """Returns (hidden (B, S, D), caches).  ``last_pos``: (B,) index of
        each row's last REAL token; pad columns past it are masked out of
        the recurrent state."""
        x = F.embedding(tokens, self.embed)
        new_caches = [] if caches is not None else None
        for i, blk in enumerate(self.blocks):
            x, c = blk(x, caches[i] if caches is not None else None,
                       last_pos)
            if caches is not None:
                new_caches.append(c)
        return rms_norm(x, self.ln_f, self.cfg.norm_eps), new_caches

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return quant_matmul(hidden, self.lm_head, None)

    # ---------------- serving ----------------
    def init_cache(self, batch: int, s_max: int, *,
                   spec: CacheSpec | None = None) -> list[SSMCache]:
        """Zeroed recurrent state, one :class:`SSMCache` per layer; O(1)
        per slot, so ``s_max`` is unused and a paged spec is rejected
        (there is nothing to page)."""
        reject_paged_spec(spec, "ssm", "recurrent state is O(1) per slot; "
                          "paged KV pools apply to attention slabs")
        del s_max
        conv_s, state_s = ssm_cache_shape(self.cfg, batch)
        return [SSMCache(
            torch.zeros(conv_s, dtype=dtype_of(self.cfg), device=self.device),
            torch.zeros(state_s, dtype=torch.float32, device=self.device))
            for _ in range(self.cfg.num_layers)]

    def prefill(self, tokens, caches, *, last_pos=None, cache_index=0):
        """Prompt forward continuing ``caches``; returns the (B, 1, V)
        logits at ``last_pos`` (default: the last column) and the new
        caches.  ``cache_index`` > 0 is a chunked-prefill continuation:
        the recurrence is position-free, so the offset itself is unused;
        the carried (conv, state) in ``caches`` is the continuation point
        and the scan resumes from it."""
        del cache_index
        hidden, caches = self.forward(tokens, caches=caches,
                                      last_pos=last_pos)
        last = (hidden[:, -1:] if last_pos is None
                else gather_last(hidden, last_pos))
        return self.logits(last), caches

    def decode_step(self, token, state, index, *, tables=None):
        """token: (B, 1); ``index`` is unused (position-free recurrence);
        ``tables`` must be None (the state is dense).  Under the engine's
        frozen decode model ``w_in``/``w_out`` run the LUT GEMM of their
        ``QuantizedWeight``."""
        assert tables is None, "ssm caches are dense (no block table)"
        del index
        hidden, caches = self.forward(token, caches=state)
        return self.logits(hidden), caches

    def state_snapshot(self, caches, row: int = 0) -> list[SSMCache]:
        """Prefix-cache export: the whole cache is the recurrent state, so
        a snapshot is each layer's (conv, state) at ``row``, copied
        (:func:`~repro_torch.models.ssm.snapshot_row`); O(1) in the prefix
        length."""
        return [snapshot_row(c, row) for c in caches]

    def seed_from_snapshot(self, staging, snap) -> list[SSMCache]:
        """Warm admission: copy a snapshot into a 1-row staging cache (the
        position-free recurrence has nothing else to restore).  The
        snapshot stays the cache's own: the staging row is written by the
        prefill that follows, never the snapshot."""
        for st, sn in zip(staging, snap):
            st.conv.copy_(sn.conv)
            st.state.copy_(sn.state)
        return staging

    def decode_window(self, tokens, state, index, *, tables=None,
                      n_valid=None, last_pos=None):
        """Speculative verify / commit over a (B, W) token window: the
        masked SSD scan (``ssd_scan`` on CUDA tensors) continuing from the
        carried state.  The recurrence cannot rewind, so ``last_pos`` (B,)
        bounds what ENTERS the state: positions beyond it are dt-masked
        (state frozen, contribution zero) while their causal outputs still
        score the window.  Verify passes ``last_pos = n_valid - 1``; a
        partial-accept commit re-runs from the pre-verify caches with
        ``last_pos`` = the accepted count, so exactly the accepted prefix
        enters the state.  A row with ``last_pos = -1`` is fully masked:
        its conv window and SSD state pass through unchanged.  ``index``
        is unused (position-free); ``n_valid`` gives the default
        ``last_pos``.  ``state`` is only read: the returned caches are new
        tensors.  Returns (logits (B, W, V), caches)."""
        assert tables is None, "ssm caches are dense (no block table)"
        del index
        if last_pos is None and n_valid is not None:
            last_pos = n_valid - 1
        hidden, caches = self.forward(tokens, caches=state, last_pos=last_pos)
        return self.logits(hidden), caches
