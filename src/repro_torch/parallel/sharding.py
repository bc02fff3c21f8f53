"""Logical sharding rules: param/batch/cache specs per architecture
(mirrors ``repro.parallel.sharding``).

Strategy (JAX's):
  * params: FSDP over ``data`` on the contraction-side dim + Megatron TP over
    ``model`` on heads / FFN-hidden / experts / vocab;
  * batch: sharded over ``(pod, data)``;
  * KV caches: heads over ``model`` when the KV-head count divides the axis,
    otherwise the sequence dim goes over ``model`` (ring-style cache);
  * every rule is shape-guarded: an axis is applied only if it divides the
    dim, so the same rules serve 512-rank pods and 2-rank test meshes.

A spec is a tuple with one entry a dimension: an axis name, a tuple of
names (a dimension split over several axes, row-major), or None; ``()``
is a replicated leaf (JAX's ``P()``).  There is no ``NamedSharding``: a
spec tells :mod:`repro_torch.parallel.fsdp` which block of a leaf this
rank holds.  The rules read only a mesh's ``axis_names`` and ``shape``
({axis: size}), so a :class:`~repro_torch.launch.mesh.AbstractMesh`
serves as well as a live one.

The port's trees are unstacked (``blocks/0/attn/wq`` is one layer where
JAX stacks ``blocks/attn/wq`` on a leading L axis).  A rule's axes are
left-padded with None to the leaf's rank, so a layer's leaf gets exactly
JAX's spec of the stacked leaf with its leading None dropped.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.launch.mesh import batch_axes
from repro_torch.tree import leaves_with_path, path_key, tree_map

# (regex on 'a/b/c' param path) -> spec builder taking ndim
# Rules are matched in order; first hit wins.  Leading L (scan) axes are
# handled by padding the spec with None on the left.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$",                 ("model", "data")),     # (V, D) vocab-parallel
    (r"lm_head$",               ("data", "model")),     # (D, V)
    (r"router$",                ("data", None)),        # (D, E)
    # MoE experts: EP over model on the expert dim
    (r"moe/w_(gate|up)$",       ("model", "data", None)),   # (E, D, F)
    (r"moe/w_down$",            ("model", None, "data")),   # (E, F, D)
    (r"shared/w_(gate|up)$",    ("data", "model")),
    (r"shared/w_down$",         ("model", "data")),
    # MLA
    (r"w_dkv$",                 ("data", None)),
    (r"w_dq$",                  ("data", None)),
    (r"w_uq$",                  (None, "model")),
    (r"w_uk$",                  (None, "model")),
    (r"w_uv$",                  (None, "model")),
    # attention (GQA)
    (r"attn/w[qkv]$",           ("data", "model")),
    (r"attn/wo$",               ("model", "data")),
    # dense MLP
    (r"w_(gate|up)$",           ("data", "model")),
    (r"w_down$",                ("model", "data")),
    # mamba2 (inner dims stay unsharded over model)
    (r"m/w_in$",                ("data", None)),
    (r"m/w_out$",               (None, "data")),
    (r"m/conv_[wb]$",           None),                  # replicated
    (r"(A_log|D|dt_bias|norm_w|ln\w*|ln_f|ln_enc|ln_dec)$", None),
]


def _guard(spec_axes, shape, mesh) -> tuple:
    """Drop axes that don't divide the corresponding dim."""
    sizes = mesh.shape
    out = []
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            out.append(None)
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        axs = tuple(a for a in axs if a in sizes)
        prod = math.prod(sizes[a] for a in axs)
        if axs and dim % prod == 0 and dim >= prod:
            out.append(axs if len(axs) > 1 else axs[0])
        else:
            out.append(None)
    return tuple(out)


def param_spec(path: str, shape: tuple, mesh) -> tuple:
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            if axes is None:
                return ()
            axes = tuple(axes)
            # left-pad for stacked (scan) leading axes
            pad = len(shape) - len(axes)
            if pad < 0:   # unstacked smaller rank (e.g. per-layer bias)
                return ()
            full = (None,) * pad + axes
            return _guard(full, shape, mesh)
    return ()  # default: replicated


def _drop_data(spec: tuple) -> tuple:
    return tuple(None if ax == "data" else ax for ax in spec)


def param_specs(tree: Any, mesh, *, serve_tp: bool = False) -> Any:
    """A tree of specs matching a params tree (JAX's ``param_shardings``).

    ``serve_tp``: drop the ``data`` (FSDP) axis — weights replicated across
    data, sharded over model only (no per-use weight all-gathers)."""
    specs = iter(
        (_drop_data if serve_tp else tuple)(
            param_spec(path_key(p), tuple(leaf.shape), mesh))
        for p, leaf in leaves_with_path(tree))
    return tree_map(lambda _: next(specs), tree)


# ---------------------------------------------------------------------------
# batch & cache specs
# ---------------------------------------------------------------------------

def batch_spec(name: str, shape: tuple, mesh) -> tuple:
    ba = batch_axes(mesh)
    if len(shape) == 0:
        return ()
    full = (ba,) + (None,) * (len(shape) - 1)
    return _guard(full, shape, mesh)


def batch_specs(batch_shape: dict, mesh) -> dict:
    """{name: spec} of a batch (``{name: shape}`` or ``{name: tensor}``)."""
    return {k: batch_spec(k, tuple(getattr(v, "shape", v)), mesh)
            for k, v in batch_shape.items()}


def _kv_spec(shape: tuple, mesh, *, mla: bool) -> tuple:
    """KV cache: heads over model when divisible, else sequence over model.

    GQA: (.., B, S, Hkv, Dh); MLA compressed: (.., B, S, R) — MLA always
    shards S over model (the compressed dim R is the whole point of MLA).
    """
    ba = batch_axes(mesh)
    msize = mesh.shape.get("model", 1)
    nd = len(shape)
    if mla:
        full = (None,) * (nd - 3) + (ba, "model", None)
    else:
        hkv = shape[-2]
        if hkv % msize == 0:
            full = (None,) * (nd - 4) + (ba, None, "model", None)
        else:
            full = (None,) * (nd - 4) + (ba, "model", None, None)
    return _guard(full, shape, mesh)


def cache_specs(cache: Any, mesh) -> Any:
    """Walk an ``init_cache`` tree (the port's per-layer list, or any
    nesting of :class:`KVCache` / :class:`SSMCache` and bare tensors),
    dispatching on the cache node types (JAX's ``cache_shardings``)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMCache
    ba = batch_axes(mesh)

    def walk(node):
        if isinstance(node, KVCache):
            # GQA: k/v identical (.., S, Hkv, Dh); MLA: k=(..,S,R), v=(..,S,dr)
            shp_k, shp_v = tuple(node.k.shape), tuple(node.v.shape)
            is_gqa = len(shp_k) >= 4 and shp_k == shp_v
            return KVCache(_kv_spec(shp_k, mesh, mla=not is_gqa),
                           _kv_spec(shp_v, mesh, mla=not is_gqa))
        if isinstance(node, SSMCache):
            conv, state = tuple(node.conv.shape), tuple(node.state.shape)
            conv_full = (None,) * (len(conv) - 3) + (ba, None, "model")
            state_full = ((None,) * (len(state) - 4)
                          + (ba, "model", None, None))
            return SSMCache(_guard(conv_full, conv, mesh),
                            _guard(state_full, state, mesh))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node is None:
            return None
        # bare array (e.g. encoder output threaded through serve state)
        shp = tuple(node.shape)
        full = (ba,) + (None,) * (len(shp) - 1)
        return _guard(full, shp, mesh)

    return walk(cache)


def scalar_spec(mesh) -> tuple:
    """A replicated scalar (the optimizer's step counter)."""
    del mesh
    return ()
