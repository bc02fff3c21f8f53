"""Meshes of named axes over ``torch.distributed`` (mirrors
``repro.launch.mesh``).

JAX lays its devices out in an array with one named axis per dimension;
here the devices are the ranks of the initialised default process group,
laid out row-major in the same way.  Each axis carries one
``ProcessGroup``: the ranks that share this rank's coordinate on every
other axis (the ranks a ``psum`` over that axis name reaches in JAX), and
the batch's tuple ``("pod", "data")`` one more (:meth:`Mesh.group`).
:class:`AbstractMesh` is the shape alone (names and sizes), which is all
the sharding rules read.

A FUNCTION builds each mesh, never an import: ``torch.distributed`` must
be initialised first (``init_process_group`` with an address, a world size
and a rank; nothing here reads a cluster's environment).
"""
from __future__ import annotations

import itertools
import math
import os

import torch
import torch.distributed as dist

BATCH_AXES = ("pod", "data")     # axes that shard the global batch


class AbstractMesh:
    """Axis names and sizes, with no ranks behind them: what the sharding
    rules (:mod:`repro_torch.parallel.sharding`) read of a mesh, so they
    run on any layout without a process group (a 512-rank production
    shape in a test)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def canonical(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple) in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)


class Mesh(AbstractMesh):
    """Named axes over the world's ranks.

    ``axis_names``; ``shape``: {axis: size} (JAX's ``mesh.shape``);
    ``coords``: {axis: this rank's coordinate}; ``groups``: {axis: the
    ``ProcessGroup`` of the ranks that differ from this one only on that
    axis}; :meth:`group` the group of an axis, of the batch axes or of
    all of them.  Every rank
    must build the same meshes in the same order:
    ``dist.new_group`` is collective over the world, and a rank that
    skips one leaves the others waiting (the process group's timeout then
    fails them)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised default process "
                               "group (torch.distributed.init_process_group)")
        super().__init__(shape, axis_names)
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(shape) != world:
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"ranks, the world has {world}")
        self.rank = rank
        self._strides = {a: math.prod(shape[i + 1:])
                         for i, a in enumerate(axis_names)}
        self.coords = {a: rank // self._strides[a] % n
                       for a, n in self.shape.items()}
        # one group per line of ranks along each tuple of axes a spec can
        # name: every single axis (the rules' params and caches), then the
        # batch's tuple ("pod", "data"); each created on every rank in the
        # same order, and this rank keeps its own line's.  The whole set
        # of axes is the world's group.
        self._groups = {self.axis_names: dist.group.WORLD}
        named = ([(a,) for a in axis_names]
                 + [self.canonical(batch_axes(self))])
        for axes in named:
            if not axes or axes in self._groups:
                continue
            for ranks in self._lines(axes):
                group = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[axes] = group
        self.groups = {a: self._groups[(a,)] for a in axis_names}

    def _lines(self, axes: tuple[str, ...]) -> list[list[int]]:
        """Every set of ranks that differ only on ``axes``, each listed in
        row-major order of ``axes`` (JAX's layout of a sharded dimension
        over a tuple of axes)."""
        others = [a for a in self.axis_names if a not in axes]
        lines = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = sum(c * self._strides[a] for a, c in zip(others, fixed))
            lines.append([base + sum(c * self._strides[a]
                                     for a, c in zip(axes, cs))
                          for cs in itertools.product(
                              *(range(self.shape[a]) for a in axes))])
        return lines

    def group(self, axes):
        """The ``ProcessGroup`` of the ranks that differ from this one only
        on ``axes`` (a name or a tuple; the group of ``()`` is None).  Its
        group ranks follow the global ranks, which is row-major over
        ``axes`` in mesh order.  There are groups for each single axis,
        the batch axes and all the axes; any other tuple raises
        ``KeyError``, since no spec names one."""
        axes = self.canonical(axes)
        if not axes:
            return None
        if axes not in self._groups:
            raise KeyError(f"the mesh has no group over {axes}: it has "
                           f"{sorted(self._groups)}")
        return self._groups[axes]

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` in the order given
        (JAX's place of this device's block along a dimension sharded
        over that tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = 0
        for a in axes:
            out = out * self.shape[a] + self.coords[a]
        return out

    def members(self, axes) -> list[int]:
        """The global ranks of :meth:`group`'s line, in group-rank order."""
        axes = self.canonical(axes)
        return next(line for line in self._lines(axes)
                    if self.rank in line)

    @property
    def device(self) -> torch.device:
        """This rank's device: ``cuda:<local rank>`` under NCCL (the
        ``LOCAL_RANK`` of a launcher's environment, else the rank modulo
        the cards), the CPU under gloo."""
        if dist.get_backend() != "nccl":
            return torch.device("cpu")
        local = int(os.environ.get("LOCAL_RANK",
                                   self.rank % torch.cuda.device_count()))
        return torch.device("cuda", local)


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


#: a collective of :func:`spawn_host_ranks` that waits longer fails its rank
HOST_GROUP_TIMEOUT_S = 120


def _host_rank(workdir: str, n: int, rank: int, timeout_s: float, fn,
               args) -> None:
    import datetime
    import pickle

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rdv", world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_host_ranks(n: int, fn, *args,
                     group_timeout_s: float = HOST_GROUP_TIMEOUT_S,
                     join_timeout_s: float | None = None) -> list:
    """Run ``fn(*args)`` on ``n`` local gloo ranks on the CPU and return
    every rank's result, in rank order.  The counterpart of JAX's ``n``
    forced host devices.  The ranks are processes of one spawn context,
    one torch thread each, joined through a file store in a fresh
    temporary directory (no port to pick); a collective that waits longer
    than ``group_timeout_s`` fails its rank, and ranks still running after
    ``join_timeout_s`` (None: no limit) are killed.  ``fn`` and ``args``
    must pickle (``fn`` a module-level function).  Raises
    ``RuntimeError`` if any rank fails."""
    import multiprocessing as mp
    import pickle
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="host_ranks_") as workdir:
        procs = [ctx.Process(target=_host_rank,
                             args=(workdir, n, r, group_timeout_s, fn, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = (None if join_timeout_s is None
                    else time.monotonic() + join_timeout_s)
        for p in procs:
            p.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"host ranks exited with codes {codes}")
        outs = []
        for r in range(n):
            with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
