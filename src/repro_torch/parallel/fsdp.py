"""ZeRO over the whole mesh: every rank holds only its block of each
parameter, gradient and AdamW moment, and a layer gathers the leaves it
uses at the point of use.

JAX has no counterpart file: there the sharding is an annotation
(``repro.parallel.sharding.param_shardings`` as ``jit``'s
``in_shardings``), the step computes the same function on any mesh, and
XLA inserts the all-gathers and reduce-scatters.  Here they are explicit:

* :func:`shard_leaf` keeps this rank's block of a full leaf under a spec
  of :mod:`repro_torch.parallel.sharding` (a dimension split over a tuple
  of axes is laid out row-major over them, as JAX lays out ``("pod",
  "data")``);
* :func:`shard_model` registers a ``torch.nn.utils.parametrize``
  parametrization on each leaf of ``params_tree()``: the module's
  parameter becomes the shard, and reading the attribute runs
  :class:`GatherLeaf`, which all-gathers the leaf over the axes of its
  spec.  The models read their leaves inside each block's forward, so the
  gather runs inside what ``remat_of`` recomputes and the full leaves do
  not live from forward to backward; every rank issues the same gathers
  in the same order in the recompute;
* the gather's backward returns this rank's block of the gradient, summed
  over the batch axes that split the step's rows
  (:func:`~repro_torch.parallel.act_sharding.rows_axes`) and NOT over
  ``model``: a split leaf's model block is this rank's own, and a
  replicated leaf (``ln1``, ``ln2``, ``ln_f``) acts on rows that every
  rank along ``model`` holds whole;
* tensor-parallel compute (:mod:`repro_torch.parallel.tensor_parallel`):
  :func:`shard_model` asks the model's plan which leaves its blocks
  compute split.  Such a leaf (:data:`~repro_torch.parallel.
  tensor_parallel.LOCAL`) is gathered over its spec's other axes only
  and the rank computes with its ``model`` block (a 3-D expert stack:
  its ``E/m`` experts, gathered over ``data`` on dim 1 of ``w_gate``/
  ``w_up``, dim 2 of ``w_down``), its gradient summed over the row axes
  only.  A leaf a split block uses whole, each rank its own part of it
  (:data:`~repro_torch.parallel.tensor_parallel.WHOLE`: K/V where the KV
  heads do not divide the axis; MLA's ``w_dkv`` and ``w_dq``, whose
  outputs each rank's heads read), is gathered over every axis and its
  gradient summed over the row axes AND ``model``, since each rank's
  gradient is then only its part.  The MoE router keeps the replicated
  rule: every rank holds its whole gradient (``models.moe``);
* the few places where rows meet (the cross entropy's token count, the
  MoE load-balance means) sum over those ranks in the models, through
  :mod:`repro_torch.parallel.act_sharding`'s ``batch_sum``.

What the plan does not split (the SSM and hybrid mixers, whisper's
blocks) ranks along ``model`` compute redundantly on the whole leaves
(ROADMAP queue 1 item 9d).  The gathers and gradient reductions
are counted in ``act_sharding.counts`` (``"gather"``, ``"grad"`` and
their payloads' ``"gather_bytes"``, ``"grad_bytes"``; ``counts`` here is
the same object), for the card's check that a step took this path and
the dry run's check that its collective ledger is the traffic a step
issues.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.act_sharding import counts, note, rows_axes
from repro_torch.parallel.sharding import param_specs
from repro_torch.tree import leaves_with_path, path_key

_RAW = threading.local()


def _axes(ax) -> tuple[str, ...]:
    return ax if isinstance(ax, tuple) else (ax,)


def _split(spec: tuple, mesh):
    """(dim, axes, parts) of every sharded dimension of ``spec``.  A
    dimension over a tuple of axes names them in mesh order (the rules'
    only tuple is the batch's ``("pod", "data")``), so its blocks run
    row-major over the axes as the group's ranks do."""
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = _axes(ax)
        if axes != mesh.canonical(axes):
            raise ValueError(f"spec {spec} names {axes} out of the mesh's "
                             f"order {mesh.axis_names}")
        out.append((d, axes, math.prod(mesh.shape[a] for a in axes)))
    return out


def block(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` (a view; the whole tensor when no
    named axis has more than one rank)."""
    out = full
    for d, axes, n in _split(spec, mesh):
        if n > 1:
            size = full.shape[d] // n
            out = out.narrow(d, mesh.index(axes) * size, size)
    return out


def shard_leaf(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``, as its own contiguous
    tensor (the full leaf can be freed)."""
    out = block(full, spec, mesh)
    return out.clone() if out is not full else out


def gather_leaf(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block: one all-gather per sharded
    dimension, over the group of its axes (also for a one-rank axis, where
    it is a copy)."""
    out = shard
    for d, axes, n in _split(spec, mesh):
        x = out.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.group(axes))
        note("gather", n * x.numel() * x.element_size())
        out = torch.cat(parts, dim=d)
    return out


def _without_model(spec: tuple) -> tuple:
    return tuple(None if ax == "model" else ax for ax in spec)


class GatherLeaf(torch.autograd.Function):
    """Forward: the whole leaf (:func:`gather_leaf`), or under ``mode``
    :data:`~repro_torch.parallel.tensor_parallel.LOCAL` its ``model``
    block (gathered over the other axes).  Backward: the gradient summed
    over the step's row axes (and over ``model`` under
    :data:`~repro_torch.parallel.tensor_parallel.WHOLE`), then this rank's
    block."""

    @staticmethod
    def forward(ctx, shard, spec, mesh, mode=None):
        if mode == tp.LOCAL:
            spec = _without_model(spec)
        ctx.spec, ctx.mesh = spec, mesh
        axes = rows_axes()
        if mode == tp.WHOLE:
            axes = mesh.canonical(axes + ("model",))
        ctx.rows = mesh.group(axes) if axes else None
        return gather_leaf(shard, spec, mesh)

    @staticmethod
    def backward(ctx, grad):
        if ctx.rows is not None:
            buf = grad.contiguous()
            if buf is grad:
                buf = grad.clone()
            dist.all_reduce(buf, group=ctx.rows)
            note("grad", buf.numel() * buf.element_size())
            grad = buf
        out = block(grad, ctx.spec, ctx.mesh)
        return (out.clone() if out is not grad else out), None, None, None


class _Gathered(nn.Module):
    """The parametrization of one sharded leaf: ``right_inverse`` keeps
    this rank's block, ``forward`` gathers it at every read (the shard
    itself inside :func:`raw`); ``mode``: the plan's (None: gathered
    whole)."""

    def __init__(self, spec: tuple, mesh, mode: str | None = None):
        super().__init__()
        self.spec, self.mesh, self.mode = spec, mesh, mode

    def forward(self, shard):
        if getattr(_RAW, "on", False):
            return shard
        return GatherLeaf.apply(shard, self.spec, self.mesh, self.mode)

    def right_inverse(self, full):
        return shard_leaf(full, self.spec, self.mesh)


@contextmanager
def raw():
    """Reads of a sharded model's leaves return the shards (the
    parameters autograd and the optimizer update)."""
    prev = getattr(_RAW, "on", False)
    _RAW.on = True
    try:
        yield
    finally:
        _RAW.on = prev


def _owners(model) -> dict:
    """{id(leaf): (module, name)} of every parameter leaf of ``model``."""
    out = {}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            out[id(p)] = (module, name)
    return out


def shard_model(model, mesh, specs=None):
    """Replace every leaf of ``model.params_tree()`` by this rank's shard
    (its spec from :func:`~repro_torch.parallel.sharding.param_specs`, or
    from ``specs``, a tree of specs of the same structure: the serving
    layout ``param_specs(..., serve_tp=True)``), gathered at each read;
    returns ``model``.  Call it after ``init`` (or a weight load): the
    shard is cut from the full leaf, so every rank starts from the
    unsharded model's weights.  The blocks that
    :func:`~repro_torch.parallel.tensor_parallel.plan` splits compute on
    their ``model`` blocks (the module docstring)."""
    if getattr(model, "fsdp_specs", None) is not None:
        raise ValueError("the model is already sharded")
    tree = model.params_tree()
    if specs is None:
        specs = param_specs(tree, mesh)
    modes = tp.plan(model, specs, mesh)
    owners = _owners(model)
    for (path, leaf), spec in zip(leaves_with_path(tree), flat_specs(specs)):
        module, name = owners[id(leaf)]
        parametrize.register_parametrization(
            module, name, _Gathered(spec, mesh, modes.get(path_key(path))),
            unsafe=True)
    model.fsdp_specs = specs
    return model


def flat_specs(specs) -> list:
    """The specs of a spec tree in leaf order (a spec is a tuple, so the
    tree walk stops at it; an ``AdamWState`` of specs is walked by
    field)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list) or hasattr(node, "_fields"):
            for v in node:
                walk(v)
        else:
            out.append(node)
    walk(specs)
    return out


def local_tree(model):
    """``model.params_tree()`` with this rank's shards at the leaves (the
    parameters themselves; the full tree when the model is not
    sharded)."""
    with raw():
        return model.params_tree()


def spec_leaves(model) -> list | None:
    """The specs of :func:`local_tree`'s leaves in order (None when the
    model is not sharded)."""
    specs = getattr(model, "fsdp_specs", None)
    return None if specs is None else flat_specs(specs)
