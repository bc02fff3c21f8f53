"""Distributed-optimization collectives (mirrors
``repro.parallel.collectives``).

``int8 all-reduce with error feedback``: quantizing the data-parallel
gradient all-reduce's payload to int8 cuts it 4x against f32 (2x against
bf16).  Error feedback (Seide et al. 2014; Karimireddy et al. 2019) adds
the local quantization residual into the next step's gradient so the
compression bias vanishes over time.

Two entry points:
  * :func:`quantized_psum` — over a ``torch.distributed`` group: the
    largest scale by ``all_reduce(MAX)``, int8 codes summed as int32 by
    ``all_reduce(SUM)`` (JAX's ``psum(q.astype(int32))``), dequantized;
  * :func:`compress_grads_int8` — the same round trip (quantize ->
    dequantize) of every gradient leaf, with no collective: the training
    quality effect of the wire format, as JAX's train step applies it.

Codes and scales equal JAX's bitwise: every division is by a tensor (on
CUDA PyTorch divides by a Python scalar as a multiply by its reciprocal).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.act_sharding import note
from repro_torch.tree import leaves, tree_map


def _q8(x: torch.Tensor, amax: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes in [-127, 127], the f32 scale max|x| / 127).
    ``amax``: the max |x| of the whole leaf when ``x`` is a shard."""
    qmax = torch.tensor(127.0, dtype=x.dtype, device=x.device)
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp_min(amax, 1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantized_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-payload sum of ``x`` over ``group`` (default: the world).
    Every rank quantizes with the group's largest scale, so the codes
    dequantize consistently; the codes cross as int32 and are summed
    exactly.  Returns f32."""
    x32 = x.float()
    _, scale = _q8(x32)
    gscale = scale.clone()
    dist.all_reduce(gscale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x32 / gscale), -127, 127).to(torch.int8)
    acc = q.to(torch.int32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc.float() * gscale


class ErrorFeedback:
    """Residual accumulator for compressed gradients (host-side state)."""

    def __init__(self):
        self.residual = None

    def compress(self, grads):
        if self.residual is not None:
            grads = tree_map(torch.add, grads, self.residual)
        compressed = tree_map(_roundtrip_q8, grads)
        self.residual = tree_map(torch.sub, grads, compressed)
        return compressed


def _roundtrip_q8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> torch.Tensor:
    q, scale = _q8(x.float(), amax)
    return (q.float() * scale).to(x.dtype)


def compress_grads_int8(grads, mesh=None):
    """Quantize-dequantize every gradient leaf of a tree (the all-reduce
    that follows then carries int8-precision payloads).

    ``mesh``: the leaves are shards of the whole gradients (ZeRO,
    :mod:`repro_torch.parallel.fsdp`).  ``_q8``'s scale is per leaf, so
    every shard takes its whole leaf's max |g|: one ``all_reduce(MAX)``
    over the world of the shards' maxima (a replica's max is its
    shard's, so the world's max is the leaf's, exactly).  Each shard is
    then the block of the compression of the whole leaf, bitwise."""
    if mesh is None:
        return tree_map(_roundtrip_q8, grads)
    flat = leaves(grads)
    amax = torch.stack([g.float().abs().max() for g in flat])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    note("compress", amax.numel() * amax.element_size())
    it = iter(amax.unbind(0))
    return tree_map(lambda g: _roundtrip_q8(g, next(it)), grads)
