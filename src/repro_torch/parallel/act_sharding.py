"""The activation-sharding context (mirrors ``repro.parallel.act_sharding``).

Models are mesh-agnostic: a caller activates a context carrying the mesh
(:class:`~repro_torch.launch.mesh.Mesh`), and the code that acts on it
reads :func:`current_mesh`.  Outside the context it is None and every
model runs on one device.  Under ``decode_attn="sharded"`` the decode step
of GQA and MLA attention reads it and runs
:mod:`repro_torch.serve.decode_attention` over the mesh's model group.

The context is thread-local, as JAX's: ``Engine.serve()`` inside it takes
the sharded path, while ``Engine.start()``'s loop thread does not see it.

JAX's ``shard_hidden`` / ``shard_heads`` are not here.  They are XLA
sharding hints with no numerical effect; what sequence and head
parallelism mean under ``torch.distributed`` is ROADMAP queue 1 item 9b's
(with the param, batch and cache sharding rules and training on a mesh).
``sequence_parallel`` is kept in the context for them.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_CTX = threading.local()


@contextmanager
def activation_sharding(mesh, *, sequence_parallel: bool = True):
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, sequence_parallel)
    try:
        yield
    finally:
        _CTX.state = prev


def current_mesh():
    """The mesh of the active activation-sharding context (None outside)."""
    state = getattr(_CTX, "state", None)
    return state[0] if state is not None else None
