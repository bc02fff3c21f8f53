"""Speculative decoding: draft proposers and the accept/rollback contract
(mirrors ``repro.serve.spec``).

The engine's speculative tick is draft -> batched verify -> accept prefix
-> rollback:

* **draft**: a :class:`DraftProposer` guesses up to ``spec_k`` next tokens
  a slot (host-side n-gram lookup, or the model itself over pruned-LUT
  ``nf4p`` weights);
* **verify**: the decode-precision model scores the whole window
  ``[last emitted, d_1 .. d_k]`` in one ``decode_window`` call;
  ``argmax(logits[:, i])`` is the greedy token after column ``i``;
* **accept prefix**: drafts are accepted left to right while they match
  the verifier's argmax (:func:`accept_length`); the first mismatch still
  yields the verifier's own correction, so a tick emits ``accepted + 1``
  tokens and the stream equals plain greedy decode's;
* **rollback**: attention K/V beyond the rewound pointer is dead weight the
  next writes overwrite; recurrent state is re-committed from the
  pre-verify caches with the scan masked at the accept boundary
  (``Engine._spec_tick``).

The port writes caches in place, where JAX's drafter works on a functional
copy.  :class:`SelfLutProposer`'s draft steps therefore write nf4p K/V
into the live slab or pool, at each row's positions ``positions ..
positions + kmax - 1``.  That is harmless because the verify window then
rewrites every position the tick can commit (its real columns start at the
row's pointer), every draft write beyond them lands at a future position
(masked by ``kv_len`` until rewritten) or, past a row's reservation and
for staged rows, on the garbage block, and draft positions are clamped
below ``max_seq``; a shared prefix block lies wholly below the pointer and
is never a target.  The recurrent state is not written in place at all:
``decode_step`` returns new tensors, so the drafter keeps its own list and
the live state stays the pre-verify state.  Proposers return host-side
token lists; a bad draft only costs verify columns.
"""
from __future__ import annotations

import numpy as np
import torch


def accept_length(drafts, targets) -> int:
    """Length of the accepted draft prefix: draft ``i`` is accepted iff it
    equals ``targets[i]`` (the verifier's token after window column ``i``);
    the scan stops at the first mismatch."""
    m = 0
    for i, d in enumerate(drafts):
        if int(d) != int(targets[i]):
            break
        m += 1
    return m


class DraftProposer:
    """Protocol: ``propose(reqs, k_eff)`` takes the per-slot requests
    (``None`` for empty or staged slots) and per-slot draft budgets and
    returns per-slot token lists, ``len(drafts[s]) <= k_eff[s]``."""

    name = "base"

    def propose(self, reqs, k_eff) -> list[list[int]]:
        raise NotImplementedError


class NGramProposer(DraftProposer):
    """Prompt-lookup decoding: the longest n-gram suffix (``max_ngram``
    down to ``min_ngram``) of ``prompt + out`` is matched against its most
    recent earlier occurrence and the tokens that followed it are
    proposed.  Host-side only: no weights, no device work."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert 1 <= min_ngram <= max_ngram, (min_ngram, max_ngram)
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, reqs, k_eff):
        out = []
        for req, k in zip(reqs, k_eff):
            if req is None or k <= 0:
                out.append([])
                continue
            ctx = list(req.prompt) + list(req.out)
            out.append(_prompt_lookup(ctx, int(k), self.max_ngram,
                                      self.min_ngram))
        return out


def _prompt_lookup(ctx: list[int], k: int, max_n: int, min_n: int
                   ) -> list[int]:
    """Continuation of the most recent earlier match of the longest
    context-suffix n-gram; [] when nothing matches."""
    n_ctx = len(ctx)
    for n in range(min(max_n, n_ctx - 1), min_n - 1, -1):
        suffix = ctx[-n:]
        for j in range(n_ctx - n - 1, -1, -1):
            if ctx[j:j + n] == suffix:
                cont = ctx[j + n:j + n + k]
                if cont:
                    return [int(t) for t in cont]
                break        # the match is flush with the suffix: shorter n
    return []


class SelfLutProposer(DraftProposer):
    """Self-speculation over the pruned-LUT draft model: ``kmax``
    sequential greedy steps of the engine's draft step (``decode_step``
    over ``nf4p`` projections), all ``max_batch`` rows together; rows past
    their own ``k_eff`` produce ignored tokens.  The draft caches are the
    live ones (see the module docstring for why the in-place writes are
    harmless); the returned recurrent caches are discarded."""

    name = "self_lut"

    def __init__(self, engine):
        self.engine = engine

    def propose(self, reqs, k_eff):
        eng = self.engine
        kmax = max((int(k) for r, k in zip(reqs, k_eff) if r is not None),
                   default=0)
        drafts: list[list[int]] = [[] for _ in reqs]
        if kmax <= 0:
            return drafts
        toks = np.zeros((eng.max_batch, 1), np.int64)
        for s, req in enumerate(reqs):
            if req is not None:
                toks[s, 0] = req.out[-1]
        positions = np.asarray(eng.positions, np.int64).copy()
        caches = eng.caches
        tables = eng.backend.decode_tables([cp.slot for cp in eng._chunked])
        for _ in range(kmax):
            pos = np.minimum(positions, eng.max_seq - 1)
            nxt, caches = eng._draft(
                eng.draft_params, torch.as_tensor(toks, device=eng.device),
                caches, torch.as_tensor(pos, device=eng.device), tables)
            nxt = nxt.cpu().numpy()
            for s, req in enumerate(reqs):
                if req is not None and len(drafts[s]) < int(k_eff[s]):
                    drafts[s].append(int(nxt[s]))
            toks[:, 0] = nxt
            positions += 1
        return drafts


def make_proposer(mode: str, engine) -> DraftProposer:
    """EngineConfig(spec=...) -> proposer instance bound to the engine."""
    if mode == "ngram":
        return NGramProposer()
    if mode == "self_lut":
        return SelfLutProposer(engine)
    raise ValueError(f"unknown spec mode {mode!r} "
                     "(expected 'ngram' or 'self_lut')")
