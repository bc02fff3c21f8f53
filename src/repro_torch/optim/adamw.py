"""AdamW with f32 moments, global-norm clipping and schedules (mirrors
``repro.optim.adamw``).

f32 master moments whatever the parameters' dtype, and JAX's operation
order, so a bf16 tree updates as JAX's does.  Unlike JAX's functional
update, :meth:`AdamW.update` writes the parameters, the moments and the
step counter IN PLACE (under ``torch.no_grad``): at full width the
moments alone are 4x the bf16 weights, and a second copy would not fit.
Not ``torch.optim.AdamW``: its moments take the parameters' dtype and
its operation order differs.  ZeRO-1 sharding of the moments is the mesh's
concern (ROADMAP queue 1 item 9b).
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
    def update(self, grads, state: AdamWState, params) -> dict:
        """One step: ``params``, ``state.m``, ``state.v`` and
        ``state.step`` are updated in place.  Returns ``{"grad_norm",
        "lr"}`` (() f32 tensors on the device)."""
        state.step.add_(1)
        gnorm = global_norm(grads)
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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


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
