"""Meshes of named axes over ``torch.distributed`` (mirrors
``repro.launch.mesh``).

JAX lays its devices out in an array with one named axis per dimension;
here the devices are the ranks of the initialised default process group,
laid out row-major in the same way.  Each axis carries one
``ProcessGroup``: the ranks that share this rank's coordinate on every
other axis (the ranks a ``psum`` over that axis name reaches in JAX).

A FUNCTION builds each mesh, never an import: ``torch.distributed`` must
be initialised first (``init_process_group`` with an address, a world size
and a rank; nothing here reads a cluster's environment).
"""
from __future__ import annotations

import math

import torch.distributed as dist

BATCH_AXES = ("pod", "data")     # axes that shard the global batch


class Mesh:
    """Named axes over the world's ranks.

    ``axis_names``; ``shape``: {axis: size} (JAX's ``mesh.shape``);
    ``coords``: {axis: this rank's coordinate}; ``groups``: {axis: the
    ``ProcessGroup`` of the ranks that differ from this one only on that
    axis}.  Every rank must build the same meshes in the same order:
    ``dist.new_group`` is collective over the world, and a rank that
    skips one leaves the others waiting (the process group's timeout then
    fails them)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised default process "
                               "group (torch.distributed.init_process_group)")
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(shape) != world:
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"ranks, the world has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        self.coords = {a: rank // st % n
                       for a, n, st in zip(axis_names, shape, strides)}
        self.groups = {}
        for a, n, st in zip(axis_names, shape, strides):
            # every line of ranks along axis ``a``, each created on every
            # rank in the same order; this rank keeps its own line's
            for base in range(world):
                if base // st % n:
                    continue
                ranks = [base + i * st for i in range(n)]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self.groups[a] = group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production layout: (data 16, model 16), or (pod 2, data 16,
    model 16) with ``multi_pod``; the world must hold 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """A (world // model, model) ("data", "model") mesh over the
    initialised world (tests, examples, one card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the world's "
                         f"{n} ranks")
    return Mesh((n // model, model), ("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)
