"""Token sampling: greedy / temperature / top-k (mirrors
``repro.serve.sampling``).

Greedy is ``argmax`` (first maximum, as ``jnp.argmax``), so greedy tokens
equal the JAX engine's.  The sampled modes cannot reproduce JAX's
``fold_in`` key streams; they keep the same invariants instead: row ``i``
draws from a ``torch.Generator`` seeded from ``(seed, rids[i],
steps[i])`` alone, so a request's tokens are reproducible from
``(seed, rid)`` and independent of its slot and co-tenants.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

MODES = ("greedy", "temperature", "top_k")

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SamplingConfig:
    """``mode``: one of :data:`MODES` (temperature/top_k ignored by
    greedy)."""
    mode: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.mode in ("temperature", "top_k") and self.temperature <= 0:
            raise ValueError("temperature must be > 0")
        if self.mode == "top_k" and self.top_k <= 0:
            raise ValueError("top_k mode needs top_k >= 1")


def stream_seed(seed: int, rid: int, step: int) -> int:
    """A 63-bit generator seed from (seed, rid, step): splitmix64 folds."""
    h = seed & _MASK64
    for v in (rid, step):
        h = (h + 0x9E3779B97F4A7C15 + (v & _MASK64)) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h >> 1


def sample(logits: torch.Tensor, cfg: SamplingConfig, *, seed: int,
           rids: list[int], steps: list[int]) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 next-token ids; row ``i`` samples from
    its own ``(seed, rids[i], steps[i])`` stream."""
    if cfg.mode == "greedy":
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / cfg.temperature
    if cfg.mode == "top_k":
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.empty(logits.shape[0], dtype=torch.int64,
                      device=logits.device)
    for i, (rid, step) in enumerate(zip(rids, steps)):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(stream_seed(seed, rid, step))
        out[i] = torch.multinomial(probs[i], 1, generator=gen)[0]
    return out
