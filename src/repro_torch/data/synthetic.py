"""Deterministic synthetic LM data (mirrors ``repro.data.synthetic``).

A learnable stream: tokens follow a fixed random bigram chain plus noise,
so a model can bring the loss well below uniform entropy.  Every batch is
a pure function of (seed, step), so a restart replays nothing and needs
no data-state checkpoint.  :meth:`SyntheticLM.batch_np` is bitwise JAX's
(the same numpy generator calls).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, noise: float = 0.3):
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.chain = rng.integers(0, vocab_size, vocab_size)  # bigram map

    def batch_np(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.global_batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.global_batch)
        noise_mask = rng.random((self.global_batch, self.seq)) < self.noise
        noise_tok = rng.integers(0, self.vocab, (self.global_batch, self.seq))
        for t in range(self.seq):
            nxt = self.chain[toks[:, t]]
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def batch(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """``batch_np(step)`` as int64 tensors on ``device`` (the card
        unless ``"cpu"``)."""
        device = resolve_device(device)
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
                for k, v in self.batch_np(step).items()}
