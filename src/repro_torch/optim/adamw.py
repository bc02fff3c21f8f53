"""AdamW with f32 moments, global-norm clipping and schedules (mirrors
``repro.optim.adamw``).

f32 master moments whatever the parameters' dtype, and JAX's operation
order, so a bf16 tree updates as JAX's does.  Unlike JAX's functional
update, :meth:`AdamW.update` writes the parameters, the moments and the
step counter IN PLACE (under ``torch.no_grad``): at full width the
moments alone are 4x the bf16 weights, and a second copy would not fit.
Not ``torch.optim.AdamW``: its moments take the parameters' dtype and
its operation order differs.

ZeRO-1, as JAX's: on a mesh (:mod:`repro_torch.parallel.fsdp`) the
parameters are this rank's shards, so :meth:`AdamW.init` makes moments of
the shards' shapes and the update is elementwise on them; the moments are
never replicated.  The one cross-rank quantity is the clip's global norm:
:func:`global_norm` given the mesh and the leaves' specs sums each leaf's
squares over the ranks that shard it, counting a replicated leaf once.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32, updated in place
    m: Any                # f32 tree shaped like the params
    v: Any


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A () f32 tensor on ``like``'s device: dividing by a tensor keeps
    the quotient correctly rounded on CUDA (a Python divisor becomes a
    multiply by its reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


class AdamW:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 clip_norm: float | None = 1.0, schedule=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.schedule = schedule       # callable step -> multiplier

    def init(self, params) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=leaves(params)[0].device)
        return AdamWState(step, zeros, tree_map(torch.clone, zeros))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *, mesh=None,
               specs=None) -> dict:
        """One step: ``params``, ``state.m``, ``state.v`` and
        ``state.step`` are updated in place.  Returns ``{"grad_norm",
        "lr"}`` (() f32 tensors on the device).  ``mesh``/``specs``: the
        trees hold shards (``specs``: their specs in leaf order), and the
        norm is the whole tree's (:func:`global_norm`)."""
        state.step.add_(1)
        gnorm = global_norm(grads, mesh, specs)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp_max(
                _f32(self.clip_norm, gnorm) / (gnorm + 1e-9), 1.0)
        b1, b2 = self.b1, self.b2
        stepf = state.step.float()
        bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
        bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)
        lr = (self.lr * self.schedule(state.step) if self.schedule
              else _f32(self.lr, stepf))
        for p, g, mm, vv in zip(leaves(params), leaves(grads),
                                leaves(state.m), leaves(state.v)):
            g = g.float() if scale is None else g.float() * scale
            mm.mul_(b1).add_((1 - b1) * g)
            vv.mul_(b2).add_((1 - b2) * torch.square(g))
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            p32 = p.float()
            u = u + self.weight_decay * p32
            p.copy_((p32 - lr * u).to(p.dtype))
        return {"grad_norm": gnorm, "lr": lr}


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.

    On a mesh the leaves are shards (``specs``: their specs in leaf
    order): a leaf's sum is taken on the ranks whose coordinate is 0 on
    every axis its spec does not name, which hold its blocks once each,
    and one all-reduce over the world adds them (zeros elsewhere, so a
    one-rank world gives the unsharded sum bitwise)."""
    sums = torch.stack([torch.sum(torch.square(x.float()))
                        for x in leaves(tree)])
    if mesh is not None:
        import torch.distributed as dist

        from repro_torch.parallel.act_sharding import note
        owns = torch.tensor([_owns(mesh, spec) for spec in specs],
                            device=sums.device)
        sums = torch.where(owns, sums, torch.zeros_like(sums))
        dist.all_reduce(sums)
        note("norm", sums.numel() * sums.element_size())
    return torch.sqrt(torch.sum(sums))


def _owns(mesh, spec: tuple) -> bool:
    named = {a for ax in spec if ax is not None
             for a in (ax if isinstance(ax, tuple) else (ax,))}
    return all(c == 0 for a, c in mesh.coords.items() if a not in named)


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``; ``fn(step)`` takes and returns () tensors."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp_max(step / _f32(max(warmup, 1), step), 1.0)
        prog = torch.clamp((step - warmup) / _f32(max(total - warmup, 1),
                                                  step), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos
    return fn
