"""Pipeline parallelism over the ``pod`` axis, GPipe-style (mirrors
``repro.parallel.pipeline``).

Inter-pod links are the slow tier of a multi-pod mesh; running the layer
stack as P pipeline stages (one per pod) turns the per-layer inter-pod
traffic of pure data parallelism into one boundary activation transfer per
microbatch, hidden behind microbatch compute.

Schedule: standard GPipe fill/drain — T = n_micro + n_stages - 1 ticks; at
each tick stage s computes microbatch (t - s) if in range, then the
boundary activation moves s -> s+1 (JAX's ``collective_permute`` over the
ring; here ``isend``/``irecv`` on the axis's group).  Each rank holds only
its stage's params; the last stage's outputs reach every stage through an
all-reduce of the masked buffer (JAX's ``psum``).

The schedule is a forward (JAX's differentiates through ``shard_map``;
gradients through the point-to-point transfers are not ported, and a call
that would need them raises instead of dropping them).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import leaves


def _shift(y: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """Every stage's ``y`` to the next stage of the ring (stage 0 gets the
    last stage's, which it ignores)."""
    n = mesh.shape[axis_name]
    if n == 1:
        return y
    members = mesh.members(axis_name)
    s = mesh.coords[axis_name]
    group = mesh.group(axis_name)
    out = torch.empty_like(y)
    y = y.contiguous()
    ops = [dist.P2POp(dist.isend, y, members[(s + 1) % n], group),
           dist.P2POp(dist.irecv, out, members[(s - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, *, mesh,
                   axis_name: str = "pod") -> torch.Tensor:
    """Run microbatches through pipeline stages.

    stage_fn(params_one_stage, x) -> y   (same shape as x)
    stage_params: THIS rank's stage's params (stage ``mesh.coords[
        axis_name]``; JAX's stacked ``[n_stages]`` tree sharded over pod)
    x_micro: (n_micro, mb, ...) microbatched input (the same on every stage)
    Returns (n_micro, mb, ...) outputs (the same on every stage).
    """
    if torch.is_grad_enabled() and any(
            isinstance(p, torch.Tensor) and p.requires_grad
            for p in leaves(stage_params) + [x_micro]):
        raise NotImplementedError(
            "pipeline_apply is a forward schedule: its point-to-point "
            "transfers carry no gradients (run it under torch.no_grad)")
    n_stages = mesh.shape[axis_name]
    sidx = mesh.coords[axis_name]
    n_micro = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])            # current activation
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        mb_idx = t - sidx                         # microbatch at stage
        active = 0 <= mb_idx < n_micro
        # stage 0 ingests microbatch t from x_micro
        inp = x_micro[min(t, n_micro - 1)] if sidx == 0 else buf
        y = stage_fn(stage_params, inp) if active else buf
        if active and sidx == n_stages - 1:       # last stage emits
            outs[mb_idx] = y
        buf = _shift(y, mesh, axis_name)          # boundary s -> s+1
    # only the last stage holds real outputs; share them
    if sidx != n_stages - 1:
        outs.zero_()
    if n_stages > 1:
        dist.all_reduce(outs, group=mesh.group(axis_name))
    return outs
