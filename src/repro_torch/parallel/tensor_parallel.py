"""Tensor-parallel compute over the mesh's ``model`` axis: Megatron's
splits of the dense GQA decoder (attention heads, the FFN hidden
dimension, the vocabulary) and of the moe family (expert parallelism
for the routed experts, the shared experts' hidden dimension, MLA's
heads).

JAX has no counterpart file: its params carry ``parallel.sharding``'s
specs (``attn/w[qkv]``, ``w_(gate|up)``, MLA's ``w_uq``/``w_uk``/
``w_uv`` columns over ``model``, ``attn/wo`` and ``w_down`` rows, the
expert stacks on their expert dimension, ``embed`` rows and ``lm_head``
columns) and GSPMD splits the compute under them.  Here the split is
explicit:

* :func:`plan` decides, per block and from the specs (never per leaf),
  which parts of a model compute on their ``model`` shard, and marks the
  modules (``GQAAttention.split``: the K/V leaves' mode;
  ``MLAAttention.split``; ``MLP.split``; ``MoE.split``;
  ``TransformerLM.vocab_split``).  :func:`~repro_torch.parallel.fsdp.
  shard_model` then gathers a split leaf over its other axes only
  (:data:`LOCAL`: a rank's heads, hidden columns or ``E/m`` experts),
  and a leaf that a split block uses whole in a rank-specific way over
  every axis, its gradient summed over ``model`` too (:data:`WHOLE`: the
  K/V projections where the KV heads do not divide the axis, which JAX's
  spec cuts mid-head; MLA's ``w_dkv`` and ``w_dq``, whose outputs each
  rank's heads read).  A block whose specs do not split consistently
  (``_guard`` dropped ``model`` where it does not divide) keeps the
  gathered compute, as do the SSM and hybrid mixers and whisper's blocks;
* the model-group regions, ``torch.autograd.Function`` s over
  ``act_sharding.model_group()``: :func:`copy` (identity forward,
  all-reduce backward: Megatron's *f*), :func:`reduce` (all-reduce
  forward, identity backward: *g*) and :func:`gather` (all-gather
  forward, this rank's block backward);
* the vocabulary: :func:`embedding` (ids outside the rank's rows masked,
  looked up locally, reduced) and :func:`xent_parts` (the cross entropy's
  log-partition and gold logit from the ranks' shards of the logits);
* :func:`mesh_amax` / :func:`mesh_amin`: a calibration maximum over
  the dimension a row-parallel split cuts (``wo``'s and ``w_down``'s
  K, over ``model``), or over a step's rows (the batch axes: ``int8``'s
  and the ``luna_*`` modes' per-tensor activation scale is the global
  batch's, as JAX's), all-reduced so that each shard's codes are bitwise
  the matching block of the unsharded codes, the gradient going where
  the global maximum lies;
* :func:`serving_model`: the decode model of ``serve_param_sharding=
  "tp"``, each rank holding only its ``model`` shard of the (frozen)
  weights of the blocks that compute split, and every other leaf whole.

Every region runs at any model-axis size, one rank included, where each
collective is the identity on the values.  Each collective is counted in
``act_sharding.counts`` as ``"tp_reduce"`` (all-reduces) or
``"tp_gather"`` (all-gathers).  A region's group is read at the forward
from the thread-local context and kept for the backward; a remat'd
block's recompute re-enters the forward's context (``models.common.
remat_of``), and the cross entropy's chunk recompute closes over its
group (:func:`vocab_shard`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.parallel.act_sharding import (current_mesh, model_group,
                                               model_rank, model_size, note)
from repro_torch.parallel.sharding import param_specs

#: fsdp leaf modes: gathered over the spec's axes other than ``model``
#: (the rank computes with its model block)
LOCAL = "local"
#: gathered over every axis, model included, and the gradient summed over
#: the row axes and ``model`` (a leaf the ranks use whole, each its part)
WHOLE = "whole"


def _group():
    group = model_group()
    if group is None:
        raise RuntimeError("a tensor-parallel model runs inside "
                           "act_sharding.activation_sharding(mesh)")
    return group


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
               kind: str = "tp_reduce") -> torch.Tensor:
    """A new tensor: ``x`` all-reduced over ``group`` (counted as
    ``kind``)."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    note(kind, out.numel() * out.element_size())
    return out


def all_gather(x: torch.Tensor, dim: int, group, n: int,
               kind: str = "tp_gather") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (a new
    tensor; counted as ``kind``)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    note(kind, n * x.numel() * x.element_size())
    return torch.cat(parts, dim=dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], rank
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        out = g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        return out.contiguous(), None, None, None, None


def copy(x: torch.Tensor) -> torch.Tensor:
    """Enter a split region: ``x`` itself forward, the gradient summed
    over the model group backward (each rank's part of it comes from its
    own shard)."""
    return _Copy.apply(x, _group())


def reduce(x: torch.Tensor) -> torch.Tensor:
    """Leave a split region: the ranks' partial ``x`` summed, the
    gradient passed through (every rank holds the whole sum)."""
    return _Reduce.apply(x, _group())


def gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim`` concatenated in rank
    order (gather-heads); backward, this rank's block of the gradient
    (right where every rank then computes the same on the whole)."""
    dim = dim % x.ndim
    return _Gather.apply(x, dim, _group(), model_size(), model_rank())


class _MeshMax(torch.autograd.Function):
    """The maximum over a group of ranks of a per-rank maximum ``t``.
    Every rank uses the maximum in its own part of the computation, so
    backward the ranks' gradients are summed and go to the ranks whose
    ``t`` is the maximum, split evenly among them (``jax.grad`` of a max
    splits it evenly among the elements that tie; ranks tie only where
    equal floats meet): one all-reduce of the gradient and the tie
    count, stacked."""

    @staticmethod
    def forward(ctx, t, group, kind):
        out = all_reduce(t, group, dist.ReduceOp.MAX, kind)
        ctx.group, ctx.kind = group, kind
        ctx.save_for_backward(t == out)
        return out

    @staticmethod
    def backward(ctx, g):
        hit, = ctx.saved_tensors
        hit = hit.to(g.dtype)
        total, ties = all_reduce(torch.stack([g, hit]), ctx.group,
                                 kind=ctx.kind)
        return total * hit / ties, None, None


def mesh_amax(t: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """``t`` (this rank's maxima over its block of dimensions split over
    the mesh ``axes``: a row-parallel projection's K over ``model``, a
    step's rows over the batch axes) as the maxima over the whole
    dimensions; ``t`` itself when ``axes`` is empty.  Counted as
    ``"tp_reduce"`` when ``model`` is among the axes, else as
    ``"rows"``."""
    if not axes:
        return t
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a split calibration runs inside "
                           "act_sharding.activation_sharding(mesh)")
    kind = "tp_reduce" if "model" in axes else "rows"
    return _MeshMax.apply(t, mesh.group(mesh.canonical(axes)), kind)


def mesh_amin(t: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """As :func:`mesh_amax`, for minima."""
    return -mesh_amax(-t, axes) if axes else t


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------

class VocabShard(NamedTuple):
    """This rank's block of the vocabulary: ``[start, start + size)`` of
    ``ranks`` equal blocks over ``group``."""
    group: object
    start: int
    size: int
    ranks: int


def vocab_shard(size: int) -> VocabShard:
    """This rank's :class:`VocabShard` of ``size`` rows (the context's
    model group, read now: a recompute on another thread keeps it)."""
    return VocabShard(_group(), model_rank() * size, size, model_size())


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel embedding: ``weight`` is this rank's block of rows;
    the ids outside it look up zeros, and the ranks' lookups are
    summed."""
    vs = vocab_shard(weight.shape[0])
    local = ids - vs.start
    inside = (local >= 0) & (local < vs.size)
    x = F.embedding(torch.where(inside, local, 0), weight)
    return reduce(torch.where(inside[..., None], x, 0.0))


def xent_parts(logits: torch.Tensor, labels: torch.Tensor,
               vs: VocabShard) -> tuple[torch.Tensor, torch.Tensor]:
    """(logz, gold) of f32 ``logits`` (..., V / m), this rank's columns of
    the whole logits: the maximum all-reduced (a shift, no gradient), the
    sum of exponentials and the gold logit (from the rank that holds the
    label) summed over the ranks, the gradients passed through to each
    rank's own columns."""
    mx = all_reduce(torch.amax(logits.detach(), dim=-1), vs.group,
                    dist.ReduceOp.MAX)
    sumexp = _Reduce.apply(torch.exp(logits - mx[..., None]).sum(-1),
                           vs.group)
    logz = torch.log(sumexp) + mx
    local = labels.long() - vs.start
    inside = (local >= 0) & (local < vs.size)
    gold = torch.gather(logits, -1,
                        torch.where(inside, local, 0)[..., None])[..., 0]
    gold = _Reduce.apply(torch.where(inside, gold, 0.0), vs.group)
    return logz, gold


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _names(spec: tuple, dim: int) -> bool:
    return len(spec) > dim and spec[dim] == "model"


def _other_free(spec: tuple, dim: int) -> bool:
    return all(ax != "model" for i, ax in enumerate(spec) if i != dim)


def col(spec: tuple) -> bool:
    """A (K, N) leaf's spec splits its columns over ``model``."""
    return len(spec) == 2 and _names(spec, 1) and _other_free(spec, 1)


def row(spec: tuple) -> bool:
    """A (K, N) leaf's spec splits its rows over ``model``."""
    return len(spec) == 2 and _names(spec, 0) and _other_free(spec, 0)


def experts(spec: tuple) -> bool:
    """An (E, ·, ·) expert stack's spec splits its expert dimension over
    ``model`` (expert parallelism)."""
    return len(spec) == 3 and _names(spec, 0) and _other_free(spec, 0)


def attn_plan(specs: dict, heads: tuple, m: int, *, serving: bool = False
              ) -> tuple[str | None, dict]:
    """(the block's K/V mode or None, {leaf name: fsdp mode}) of a GQA
    block from its leaves' specs: split when ``wq`` is column- and ``wo``
    row-split over whole heads.  K/V are :data:`LOCAL` column shards when
    their specs split them and the KV heads divide the axis (or
    ``serving``: the serving tree keeps its mid-head shards, gathered
    before use), else :data:`WHOLE` leaves."""
    h, hkv, _ = heads
    if not (col(specs["wq"]) and row(specs["wo"])) or h % m:
        return None, {}
    kv_cols = col(specs["wk"]) and col(specs["wv"])
    kv = LOCAL if kv_cols and (hkv % m == 0 or serving) else WHOLE
    return kv, {"wq": LOCAL, "wo": LOCAL, "wk": kv, "wv": kv}


def mla_plan(specs: dict, h: int, m: int) -> tuple[bool, dict]:
    """(split, {leaf name: fsdp mode}) of an MLA block: split when its
    head projections (``wq``, or ``w_uq`` after the whole ``w_dq``;
    ``w_uk``, ``w_uv``) are column- and ``wo`` row-split over whole heads
    (their columns are head-major, so a contiguous block is whole heads).
    ``w_dkv`` and ``w_dq`` are :data:`WHOLE`: every rank computes the
    compressed KV (and q) alike, and its heads back-propagate only their
    share into it."""
    up = "w_uq" if "w_uq" in specs else "wq"
    if not (all(col(specs[n]) for n in (up, "w_uk", "w_uv"))
            and row(specs["wo"])) or h % m:
        return False, {}
    return True, {n: (WHOLE if n in ("w_dkv", "w_dq") else LOCAL)
                  for n in specs}


def mlp_plan(specs: dict) -> tuple[bool, dict]:
    """(split, {leaf name: fsdp mode}) of a dense MLP: ``w_gate``/``w_up``
    column- and ``w_down`` row-split."""
    ups = [specs[n] for n in ("w_gate", "w_up") if n in specs]
    if not (all(col(s) for s in ups) and row(specs["w_down"])):
        return False, {}
    return True, {n: LOCAL for n in specs}


def moe_plan(specs: dict, e: int, m: int) -> tuple[bool, dict]:
    """(split, {leaf path under the block's ``moe``: fsdp mode}) of an MoE
    feed-forward: split when the expert stacks split on their ``e``
    experts (``e % m == 0``: a rank runs ``e/m`` of them) and the shared
    experts split as :func:`mlp_plan`.  The router stays replicated: every
    rank routes alike, and its gradient is summed over the rows only."""
    stacks = ("w_gate", "w_up", "w_down")
    shared_ok, shared = (mlp_plan(specs["shared"]) if "shared" in specs
                         else (True, {}))
    if not (all(experts(specs[n]) for n in stacks) and shared_ok) or e % m:
        return False, {}
    modes = {n: LOCAL for n in stacks}
    modes.update({f"shared/{n}": v for n, v in shared.items()})
    return True, modes


def plan(model, specs, mesh, *, serving: bool = False) -> dict:
    """{leaf path: fsdp mode} of ``model``'s split leaves under ``specs``
    on ``mesh`` (a model class that splits implements
    ``split_over_model(specs, m, serving)``, which also marks its
    modules; the others compute gathered, and the plan is empty).
    ``serving``: the leaves are the serving tree's blocks, cut once."""
    fn = getattr(model, "split_over_model", None)
    if fn is None:
        return {}
    return fn(specs, mesh.shape.get("model", 1), serving)


def describe(model) -> dict:
    """What each part of ``model`` does along ``model``: ``"split"``,
    ``"replicated"`` or ``"mixed"`` (some blocks split), for the parts it
    has: ``attention``, ``mlp``, ``vocab``, ``experts``, ``mixer``."""
    from repro_torch.models.attention import GQAAttention, MLAAttention
    from repro_torch.models.mlp import MLP
    from repro_torch.models.moe import MoE
    from repro_torch.models.ssm import Mamba2

    parts = ((GQAAttention, "attention"), (MLAAttention, "attention"),
             (MLP, "mlp"), (MoE, "experts"), (Mamba2, "mixer"))
    seen: dict[str, set] = {}
    vocab = None
    for mod in model.modules():
        vocab = vocab or getattr(mod, "vocab_split", None)
        for cls, part in parts:
            if isinstance(mod, cls):
                seen.setdefault(part, set()).add(
                    bool(getattr(mod, "split", None)))
    seen["vocab"] = {bool(vocab) and all(vocab)}
    return {k: ("mixed" if len(v) > 1 else "split" if v == {True}
                else "replicated") for k, v in seen.items()}


def serving_model(model, mesh, quant: str | None = None):
    """The decode model of ``model`` on ``mesh`` (None: one device; run
    it under ``activation_sharding(mesh)``): ``quant`` (an engine
    mode, ``core.quant.DECODE_QUANT_KERNELS``) freezes the decode
    projections as the engine does, from the WHOLE weights.  Under
    ``cfg.serve_param_sharding="tp"`` (JAX's ``param_shardings(
    serve_tp=True)``) the leaves of the blocks that :func:`plan` splits
    are then cut to this rank's block (:func:`serving_specs`; a
    ``QuantizedWeight`` through :meth:`~repro_torch.core.quant.
    QuantizedWeight.shard`: codes, scales and zero points cut, tables
    whole) and those blocks compute split, while every other leaf stays
    whole and its block computes gathered; under ``"fsdp"`` the frozen
    tree stays whole on every rank (its FSDP layout is ROADMAP queue 1
    item 9d)."""
    from repro_torch.core.quant import (QuantizedWeight,
                                        quantize_decode_params)
    from repro_torch.parallel.fsdp import shard_leaf
    from repro_torch.tree import tree_map

    cfg = model.cfg
    whole = model.params_tree()
    tree = whole if quant is None else quantize_decode_params(whole, quant)
    if mesh is None or cfg.serve_param_sharding != "tp":
        return type(model).from_params(cfg, tree, device=model.device)
    specs = serving_specs(model, mesh)

    def cut(leaf, spec):
        if isinstance(leaf, QuantizedWeight):
            return leaf.shard(spec, mesh)
        return shard_leaf(leaf.detach(), spec, mesh)
    out = type(model).from_params(cfg, tree_map(cut, tree, specs),
                                  device=model.device)
    plan(out, param_specs(whole, mesh, serve_tp=True), mesh, serving=True)
    return out


def serving_specs(model, mesh):
    """The spec tree :func:`serving_model` cuts ``model``'s leaves by:
    ``param_specs(serve_tp=True)`` at the leaves :func:`plan` splits
    (decided per block on a view of ``model``, whose modules stay
    unmarked), ``()`` (whole) at every other."""
    from repro_torch.tree import leaves_with_path, path_key, tree_map

    whole = model.params_tree()
    specs = param_specs(whole, mesh, serve_tp=True)
    view = (type(model).from_params(model.cfg, whole, device=model.device)
            if hasattr(model, "split_over_model") else model)
    modes = plan(view, specs, mesh, serving=True)
    keep = iter([modes.get(path_key(p)) == LOCAL
                 for p, _ in leaves_with_path(whole)])
    return tree_map(lambda _, spec: spec if next(keep) else (), whole, specs)
