"""The activation-sharding context (mirrors ``repro.parallel.act_sharding``).

Models are mesh-agnostic: a caller activates a context carrying the mesh
(:class:`~repro_torch.launch.mesh.Mesh`), and the code that acts on it
reads :func:`current_mesh`.  Outside the context it is None and every
model runs on one device.  Under ``decode_attn="sharded"`` the decode step
of GQA and MLA attention reads it and runs
:mod:`repro_torch.serve.decode_attention` over the mesh's model group.

A train step on a mesh also names the axes its batch rows are split over
(:func:`rows_split_over`, read by :func:`rows_axes`).  The few places
where rows meet (the cross entropy's token count, the MoE load-balance
means) sum over those ranks through :func:`batch_sum` /
:func:`batch_mean`, and the weight gradients of
:mod:`repro_torch.parallel.fsdp` likewise.  :data:`counts` counts the
collectives a mesh step issues.

The context is thread-local, as JAX's: ``Engine.serve()`` inside it takes
the sharded path, while ``Engine.start()``'s loop thread does not see it.
Recomputation in the backward can run on autograd's device thread, so
``models.common.remat_of`` takes a :func:`snapshot` at the forward and
re-enters it (:func:`restored`) for the recompute.

Tensor-parallel compute (:mod:`repro_torch.parallel.tensor_parallel`)
reads the mesh's model group here (:func:`model_group`,
:func:`model_rank`, :func:`model_size`): a model sharded over a mesh
splits the attention heads (GQA and MLA), the FFN hidden dimension, the
routed experts (expert parallelism: tokens stay replicated along
``model``, so the dispatch is group-local and a reduce, no all-to-all),
the shared experts and the vocabulary over ``model`` (Megatron's splits,
which JAX's GSPMD computes from the same specs).  Still replicated along
``model`` (ROADMAP queue 1 item 9d): the SSM and hybrid mixers and
whisper's blocks.  A serving step whose rows are split over the batch
axes declares them too (:func:`rows_split_over`): an MoE decode step's
expert choice runs over the global batch.  JAX's ``shard_hidden`` / ``shard_heads``
are not here either: they are XLA placement hints for sequence and head
parallelism and never change a value, so a port step equals JAX's with or
without them; ``sequence_parallel`` is kept in the context for them.
"""
from __future__ import annotations

import math
import threading
from collections import Counter
from contextlib import contextmanager

import torch
import torch.distributed as dist

_CTX = threading.local()

#: collectives a mesh step issued: "rows" (a forward all-reduce of
#: :func:`batch_sum`), :mod:`~repro_torch.parallel.fsdp`'s "gather" (a
#: leaf at use) and "grad" (a gradient's sum over the row axes), AdamW's
#: "norm" (the global norm's all-reduce), the gradient compression's
#: "compress" (its scales' all-reduce) and
#: :mod:`~repro_torch.parallel.tensor_parallel`'s "tp_reduce" (every
#: all-reduce over the model group) and "tp_gather" (its all-gathers);
#: beside each, ``"<kind>_bytes"``,
#: the payload: the whole tensor the collective acts on (an all-gather's
#: output), as :mod:`repro_torch.launch.cost`'s ledger counts it
counts: Counter = Counter()


def note(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` with ``nbytes`` of payload."""
    counts[kind] += 1
    counts[f"{kind}_bytes"] += nbytes


def _state() -> dict:
    return getattr(_CTX, "state", None) or {}


@contextmanager
def _with(**updates):
    prev = getattr(_CTX, "state", None)
    _CTX.state = dict(prev or {}, **updates)
    try:
        yield
    finally:
        _CTX.state = prev


def activation_sharding(mesh, *, sequence_parallel: bool = True):
    return _with(mesh=mesh, sequence_parallel=sequence_parallel)


def rows_split_over(axes: tuple[str, ...]):
    """The batch rows of the enclosed step are split over ``axes`` (every
    rank of a line along them holds different rows; ``()``: every rank
    holds all rows)."""
    return _with(rows=tuple(axes))


def current_mesh():
    """The mesh of the active activation-sharding context (None outside)."""
    return _state().get("mesh")


def rows_axes() -> tuple[str, ...]:
    """The axes the current step's rows are split over (``()`` outside a
    mesh step)."""
    return _state().get("rows", ()) if current_mesh() is not None else ()


def model_group():
    """The ``ProcessGroup`` of the active mesh's ``model`` axis (None
    outside a mesh context, or on a mesh without that axis)."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    return mesh.group(("model",))


def model_rank() -> int:
    """This rank's coordinate on the active mesh's ``model`` axis (0
    outside one)."""
    mesh = current_mesh()
    return mesh.coords.get("model", 0) if mesh is not None else 0


def model_size() -> int:
    """The size of the active mesh's ``model`` axis (1 outside one)."""
    mesh = current_mesh()
    return mesh.shape.get("model", 1) if mesh is not None else 1


def snapshot():
    """The context as it stands (None outside any)."""
    return getattr(_CTX, "state", None)


@contextmanager
def restored(state):
    """Re-enter a :func:`snapshot` (on any thread)."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = state
    try:
        yield
    finally:
        _CTX.state = prev


# ---------------------------------------------------------------------------
# where rows meet
# ---------------------------------------------------------------------------

def _rows_group():
    """(group, ranks) of the axes the step's rows are split over, or
    (None, 1) when they are not split."""
    axes = rows_axes()
    if not axes:
        return None, 1
    mesh = current_mesh()
    return mesh.group(axes), math.prod(mesh.shape[a] for a in axes)


class _RowSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        note("rows", out.numel() * out.element_size())
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that split the step's rows, with an
    identity backward (Megatron's *g*: each rank's loss then carries the
    global sum, and the gradients summed over those ranks count it once);
    ``x`` itself outside a mesh step or when the rows are not split."""
    group, _ = _rows_group()
    return x if group is None else _RowSum.apply(x, group)


def row_ranks() -> int:
    """How many ranks split the step's rows (1 outside a mesh step)."""
    return _rows_group()[1]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the row ranks of a per-rank mean of equally many
    rows: :func:`batch_sum` divided by the rank count (a division by 1 on
    one rank, so the value is the local one bitwise)."""
    if not rows_axes():
        return x
    n = torch.full((), row_ranks(), dtype=x.dtype, device=x.device)
    return batch_sum(x) / n
