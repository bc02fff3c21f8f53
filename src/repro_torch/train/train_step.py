"""The train step (mirrors ``repro.train.train_step``).

``make_train_step(cfg, optimizer, mesh=None)`` returns ``train_step(model,
opt_state, batch) -> metrics``: the loss forward, autograd's backward and
the in-place AdamW update.  JAX's version is a pure function jitted over
(params, opt_state); here the model's parameters and the optimizer state
are updated in place.  Microbatch accumulation is JAX's: gradients summed
into f32 buffers, divided by the count, the last microbatch's loss
reported, and no loss metrics.  ``grad_compression`` applies
:func:`~repro_torch.parallel.collectives.compress_grads_int8` to the
gradients before AdamW, as JAX's step does.

On a mesh (JAX's ``in_shardings``; :func:`train_specs` is
``train_shardings``' counterpart) the model must be sharded
(:func:`~repro_torch.parallel.fsdp.shard_model`) and ``opt_state`` made
from its shards.  The step is given the GLOBAL batch, as JAX's jitted step
is, and keeps this rank's rows (:func:`local_rows`: the batch axes
``("pod", "data")`` split them when they divide the rows, as JAX's
``batch_spec`` guards); it runs the forward and backward under
``activation_sharding(mesh)`` with the rows' axes named, so the leaves
are gathered at use and the gradients come back summed over those axes
and cut to this rank's shards; AdamW updates the shards (ZeRO-1) with the
whole tree's norm.  The reported loss is the global one.  At one rank
every gather and reduction is the identity, so the step is the no-mesh
step bitwise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel import fsdp
from repro_torch.parallel.act_sharding import (activation_sharding,
                                               batch_sum, rows_split_over)
from repro_torch.parallel.collectives import compress_grads_int8
from repro_torch.parallel.sharding import (batch_spec, batch_specs,
                                          param_specs, scalar_spec)
from repro_torch.tree import leaves, tree_map


def _grads(params: list) -> list:
    """The leaves' gradients, zeros where a leaf took no part (JAX's
    grad of an unused parameter); each ``.grad`` is cleared."""
    out = []
    for p in params:
        out.append(torch.zeros_like(p) if p.grad is None else p.grad)
        p.grad = None
    return out


def local_rows(batch: dict, mesh, microbatch: int = 0
               ) -> tuple[dict, tuple[str, ...]]:
    """(this rank's rows of the global ``batch``, the axes that split
    them).  The rows are split over the batch axes when they divide a
    microbatch's rows (``batch_spec``'s guard); with ``microbatch`` > 1 the
    rank takes its block of EACH of JAX's microbatches (global rows
    ``[i * B/M, (i + 1) * B/M)``), so its rows split into ``microbatch``
    pieces are its blocks of JAX's pieces.  ``()``: every rank keeps every
    row."""
    m = max(microbatch, 1)
    b = next(iter(batch.values())).shape[0]
    ax = batch_spec("rows", (b // m,), mesh)[0]
    if ax is None:
        return batch, ()
    axes = ax if isinstance(ax, tuple) else (ax,)
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return batch, axes
    k, i = b // m // n, mesh.index(axes)

    def take(v):
        per = v.reshape((m, b // m) + tuple(v.shape[1:]))
        return per[:, i * k:(i + 1) * k].reshape((m * k,) + tuple(v.shape[1:]))
    return {name: take(v) for name, v in batch.items()}, axes


def _reported(loss, metrics: dict, mesh) -> tuple:
    """(the step's loss, its metrics), detached; on a mesh the global
    ones: the rank's cross entropy (its rows over the global count)
    summed over the row ranks, plus the aux loss every rank holds."""
    metrics = {k: v.detach() for k, v in (metrics or {}).items()}
    loss = loss.detach()
    if mesh is None:
        return loss, metrics
    xent = metrics["xent"]
    rest = metrics["aux"] if "aux" in metrics else loss - xent
    metrics["xent"] = batch_sum(xent)
    return metrics["xent"] + rest, metrics


def make_train_step(cfg, optimizer: AdamW, mesh=None, *, microbatch: int = 0,
                    grad_compression: bool = False):
    """``train_step(model, opt_state, batch) -> metrics``; ``microbatch``
    > 1 splits the batch into that many accumulation chunks.  ``cfg`` is
    unused (the model carries its config); it keeps JAX's call
    ``make_train_step(cfg, optimizer, mesh)``, which the trainer and the
    parity tests make in both packages alike.  ``mesh``: the step runs on
    it (the module docstring); None: one device.  ``grad_compression``:
    every gradient leaf through the int8 round trip before the update."""
    del cfg

    def step(model, opt_state: AdamWState, batch: dict) -> dict:
        params = fsdp.local_tree(model)
        specs = fsdp.spec_leaves(model)
        if (mesh is None) != (specs is None):
            raise ValueError("a mesh step needs a sharded model "
                             "(parallel.fsdp.shard_model), and a sharded "
                             "model its mesh")
        flat = leaves(params)
        if microbatch > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in flat]
            mbs = {k: v.reshape(microbatch, -1, *v.shape[1:])
                   for k, v in batch.items()}
            for i in range(microbatch):
                loss, last = model.loss({k: v[i] for k, v in mbs.items()})
                loss.backward()
                for a, g in zip(acc, _grads(flat)):
                    a.add_(g)
            count = torch.full((), microbatch, dtype=torch.float32,
                               device=acc[0].device)
            grads = [a / count for a in acc]
            loss, _ = _reported(loss, last, mesh)
            metrics = {}
        else:
            loss, metrics = model.loss(batch)
            loss.backward()
            grads = _grads(flat)
            loss, metrics = _reported(loss, metrics, mesh)
        grads = _unflatten(params, grads)
        if grad_compression:
            grads = (compress_grads_int8(grads) if mesh is None
                     else compress_grads_int8(grads, mesh))
        opt_metrics = optimizer.update(grads, opt_state, params, mesh=mesh,
                                       specs=specs)
        return dict(metrics, loss=loss, **opt_metrics)

    def train_step(model, opt_state: AdamWState, batch: dict) -> dict:
        if mesh is None:
            return step(model, opt_state, batch)
        rows, axes = local_rows(batch, mesh, microbatch)
        with activation_sharding(mesh), rows_split_over(axes):
            return step(model, opt_state, rows)

    return train_step


def train_specs(model, mesh, batch: dict) -> tuple:
    """(params, opt_state, batch) specs of a mesh step (JAX's
    ``train_shardings``): the params' from the rules, the AdamW state's
    the params' (ZeRO-1) with a replicated step, the batch's over the
    batch axes."""
    p = getattr(model, "fsdp_specs", None)
    if p is None:
        p = param_specs(model.params_tree(), mesh)
    return p, AdamWState(scalar_spec(mesh), p, p), batch_specs(batch, mesh)


def _unflatten(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)
