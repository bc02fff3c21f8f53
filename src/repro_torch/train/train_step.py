"""The train step (mirrors ``repro.train.train_step``).

``make_train_step(cfg, optimizer)`` returns ``train_step(model,
opt_state, batch) -> metrics``: the loss forward, autograd's backward and
the in-place AdamW update.  JAX's version is a pure function jitted over
(params, opt_state); here the model's parameters and the optimizer state
are updated in place.  Microbatch accumulation is JAX's: gradients summed
into f32 buffers, divided by the count, the last microbatch's loss
reported, and no loss metrics.  ``grad_compression`` applies
:func:`~repro_torch.parallel.collectives.compress_grads_int8` to the
gradients before AdamW, as JAX's step does.  Sharding the step over a mesh
is ROADMAP queue 1 item 9b's.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel.collectives import compress_grads_int8
from repro_torch.tree import leaves, tree_map


def _grads(params: list) -> list:
    """The leaves' gradients, zeros where a leaf took no part (JAX's
    grad of an unused parameter); each ``.grad`` is cleared."""
    out = []
    for p in params:
        out.append(torch.zeros_like(p) if p.grad is None else p.grad)
        p.grad = None
    return out


def make_train_step(cfg, optimizer: AdamW, *, microbatch: int = 0,
                    grad_compression: bool = False):
    """``train_step(model, opt_state, batch) -> metrics``; ``microbatch``
    > 1 splits the batch into that many accumulation chunks.  ``cfg`` is
    unused (the model carries its config); it keeps JAX's call
    ``make_train_step(cfg, optimizer)``, which the trainer and the parity
    tests make in both packages alike.  ``grad_compression``: every
    gradient leaf through the int8 round trip before the update."""
    del cfg

    def train_step(model, opt_state: AdamWState, batch: dict) -> dict:
        params = model.params_tree()
        flat = leaves(params)
        if microbatch > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in flat]
            mbs = {k: v.reshape(microbatch, -1, *v.shape[1:])
                   for k, v in batch.items()}
            for i in range(microbatch):
                loss, _ = model.loss({k: v[i] for k, v in mbs.items()})
                loss.backward()
                for a, g in zip(acc, _grads(flat)):
                    a.add_(g)
            count = torch.full((), microbatch, dtype=torch.float32,
                               device=acc[0].device)
            grads = [a / count for a in acc]
            metrics = {}
        else:
            loss, metrics = model.loss(batch)
            loss.backward()
            grads = _grads(flat)
        grads = _unflatten(params, grads)
        if grad_compression:
            grads = compress_grads_int8(grads)
        opt_metrics = optimizer.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in (metrics or {}).items()}
        return dict(metrics, loss=loss.detach(), **opt_metrics)

    return train_step


def _unflatten(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)
