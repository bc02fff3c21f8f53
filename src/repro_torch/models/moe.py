"""Token-choice top-k MoE with shared experts, DeepSeek-V2 style (mirrors
``repro.models.moe``).

Dispatch is group-local expert choice over routed tokens: tokens are
grouped by batch row (prefill), by window column (a speculative verify
window) or into one group (decode, S = 1); each expert picks its top
``capacity`` tokens of a group by router probability, the picks are
gathered into a (G, E, C, D) buffer, run through three batched expert
products and added back to their tokens weighted by the router
probabilities.  Capacity overflow drops tokens (the shared experts keep
the residual path).  The routed products are plain batched GEMMs, as in
JAX (no Pallas kernel there); only the shared experts go through
``quant_matmul`` (group ``"moe"``), so a frozen decode tree runs them on
the LUT GEMMs.

Two points keep the port's choices equal to JAX's:

* ``jax.lax.top_k`` puts the lower index first on ties; ``torch.topk``
  promises no order, so both top-k's here are a stable descending sort
  (:func:`top_k`).  The expert-choice top-k sees many exact zeros (tokens
  that did not pick the expert) and identical rows give exact positive
  ties.
* JAX adds the experts' outputs back with a scatter-add over the (E, C)
  picks in expert order.  The port gathers each token's picks (at most
  ``top_k``) and adds them in ascending expert order: the same sums in
  the same order, and deterministic on the card, where an atomic
  scatter-add is not.

On a mesh (``MoE.split``, set by ``parallel.tensor_parallel.plan``) the
block computes its ``model`` shard, expert parallelism: every rank routes
alike from the un-copied hidden (the router, the choices and the aux
loss are the same everywhere), rank r dispatches only the picks of its
experts ``[r·E/m, (r+1)·E/m)``, runs them, combines its experts' part of
each token, adds its block of the shared experts (``w_gate``/``w_up``
columns, ``w_down`` rows) and one ``tensor_parallel.reduce`` sums the
ranks' partials.  Tokens stay replicated along ``model``, so the dispatch
is group-local and no all-to-all is needed.  The split region is entered
through ``tensor_parallel.copy`` twice: the tokens (the experts' and the
shared experts' input) and the gates, whose gradient each rank has only
for its experts.  A copy at the block's entry (Megatron's, as GQA and
the MLP use it) would instead all-reduce the router's path, which every
rank computes whole, and leave each rank's router gradient its experts'
part.

A decode step (S = 1) or a verify window routes over the batch (one
group, or one a window column); when the step's rows are split over the
batch axes (``act_sharding.rows_axes``) the gates are all-gathered over
them and each expert's top-``capacity`` choice runs over the global
group, as JAX's over its global batch, each rank keeping the picks of its
own tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import quant_matmul
from repro_torch.models.common import set_leaf
from repro_torch.parallel import act_sharding
from repro_torch.parallel import tensor_parallel as tp


def moe_shapes(cfg) -> dict:
    """The MoE leaves (JAX's ``init_moe``): the f32 router (D, E), the
    stacked routed experts (E, D, F) / (E, F, D) and, with shared experts,
    ``{"shared": {...}}`` of width ``num_shared * d_expert``."""
    mc, d = cfg.moe, cfg.d_model
    e, ff = mc.num_experts, mc.d_expert
    shapes = {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
              "w_down": (e, ff, d)}
    if mc.num_shared:
        sff = ff * mc.num_shared
        shapes["shared"] = {"w_gate": (d, sff), "w_up": (d, sff),
                            "w_down": (sff, d)}
    return shapes


def capacity(group_tokens: int, cfg) -> int:
    """Expert capacity of a group of ``group_tokens`` (JAX's
    ``_capacity``): the balanced share times ``capacity_factor``, rounded
    up to a multiple of 4, at least 4 and at most the group."""
    mc = cfg.moe
    cap = int(group_tokens * mc.top_k * mc.capacity_factor / mc.num_experts)
    return min(group_tokens, max(4, (cap + 3) // 4 * 4))


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    descending, ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def groups(x: torch.Tensor, window: bool = False) -> torch.Tensor:
    """(B, S, D) -> (G, N, D) routing groups: decode (S = 1) folds the
    batch into one group; ``window=True`` (a verify window) groups by
    column, so the tokens at window offset j compete for capacity as in
    the plain decode tick that would have run them; otherwise each row is
    a group."""
    b, s, d = x.shape
    if s == 1:
        return x.reshape(1, b, d)
    return x.transpose(0, 1) if window else x


def route(router: torch.Tensor, xg_in: torch.Tensor, cfg,
          across: tuple[str, ...] = ()):
    """Expert choice over (G, N, D) groups.  Returns ``(probs (G, N, E),
    top_e (G, N, K), sel_gate (G, E, C), sel_idx (G, E, C))``: each
    token's top-k experts, and each expert's top-``capacity`` tokens by
    gate (the router probability where the expert is one of the token's
    top-k, else 0; a pick of gate 0 is no pick).  ``across``: mesh axes
    whose ranks hold the group's other tokens (:func:`choose`)."""
    mc = cfg.moe
    g, n, _ = xg_in.shape
    logits = xg_in.float() @ router                             # (G, N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, mc.top_k)                       # (G, N, K)
    gates = torch.zeros((g, n, mc.num_experts), dtype=torch.float32,
                        device=xg_in.device).scatter(-1, top_e, top_p)
    sel_gate, sel_idx = choose(gates, cfg, across)
    return probs, top_e, sel_gate, sel_idx


def choose(gates: torch.Tensor, cfg, across: tuple[str, ...] = ()):
    """Each expert's top-``capacity`` tokens of (G, N, E) ``gates``:
    (sel_gate, sel_idx) (G, E, C).  ``across``: the group's tokens are
    split over these mesh axes, rank-major; the gates are all-gathered
    over them (counted as ``"rows_gather"``) and the choice runs over the
    global group at its capacity; the picks of other ranks' tokens get
    gate 0 and index N (no token of this rank)."""
    g, n, _ = gates.shape
    mesh = act_sharding.current_mesh()
    ranks = math.prod(mesh.shape[a] for a in across) if across else 1
    if ranks == 1:
        return top_k(gates.transpose(1, 2), capacity(n, cfg))
    axes = mesh.canonical(across)
    full = tp.all_gather(gates, 1, mesh.group(axes), ranks,
                         kind="rows_gather")
    sel_gate, sel_idx = top_k(full.transpose(1, 2), capacity(n * ranks, cfg))
    local = sel_idx - mesh.index(axes) * n
    own = (local >= 0) & (local < n)
    return (torch.where(own, sel_gate, torch.zeros_like(sel_gate)),
            torch.where(own, local, torch.full_like(local, n)))


def dispatch(xg_in: torch.Tensor, sel_idx: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Gather each expert's picks: (G, N, D) -> (G, E, C, D), a pick of
    gate 0 zeroed (an index N, another rank's token, reads token N - 1)."""
    rows = torch.arange(xg_in.shape[0], device=xg_in.device)[:, None, None]
    xg = xg_in[rows, sel_idx.clamp_max(xg_in.shape[1] - 1)]
    return xg * valid[..., None].to(xg.dtype)


def experts(params: dict, xg: torch.Tensor) -> torch.Tensor:
    """The routed experts' three batched products on (G, E, C, D)."""
    gate_h = torch.einsum("gecd,edf->gecf", xg, params["w_gate"])
    up_h = torch.einsum("gecd,edf->gecf", xg, params["w_up"])
    h = F.silu(gate_h) * up_h
    return torch.einsum("gecf,efd->gecd", h, params["w_down"])


def combine(yg: torch.Tensor, top_e: torch.Tensor, sel_idx: torch.Tensor,
            first: int = 0) -> torch.Tensor:
    """(G, E', C, D) weighted expert outputs of experts ``[first, first +
    E')`` back to their (G, N, D) tokens.  slot[g, e, n] = the token's
    place among expert e's picks (-1: not picked; index N is no token);
    each token's picks are summed in ascending expert order, as JAX's
    scatter-add over (E, C) adds them (its picks of other experts add
    nothing)."""
    g, e, cap, d = yg.shape
    n, k = top_e.shape[1:]
    dev = yg.device
    slot = torch.full((g, e, n + 1), -1, dtype=torch.long, device=dev)
    slot.scatter_(2, sel_idx, torch.arange(cap, device=dev)
                  .expand(g, e, cap).contiguous())
    chosen = torch.sort(top_e, dim=-1).values - first           # (G, N, K)
    mine = (chosen >= 0) & (chosen < e)
    chosen = chosen.clamp(0, e - 1)
    place = torch.gather(slot.transpose(1, 2), 2, chosen)       # (G, N, K)
    place = torch.where(mine, place, -1)
    flat = (chosen * cap + place.clamp_min(0)).reshape(g, -1)
    picked = torch.gather(yg.reshape(g, e * cap, d), 1,
                          flat[..., None].expand(-1, -1, d))
    picked = torch.where((place >= 0).reshape(g, n * k, 1), picked,
                         torch.zeros((), dtype=yg.dtype, device=dev))
    picked = picked.reshape(g, n, k, d)
    out = torch.zeros((g, n, d), dtype=yg.dtype, device=dev)
    for j in range(k):
        out = out + picked[:, :, j]
    return out


def shared_experts(sp: dict, x: torch.Tensor, cfg, split: bool = False
                   ) -> torch.Tensor:
    """The shared experts: a SwiGLU MLP through ``quant_matmul`` (a frozen
    decode tree runs it on the LUT GEMMs).  ``split``: ``sp`` holds this
    rank's hidden columns (``w_down``'s rows), and the result is its
    partial sum."""
    gate = quant_matmul(x, sp["w_gate"], cfg.quant, "moe")
    up = quant_matmul(x, sp["w_up"], cfg.quant, "moe")
    return quant_matmul(F.silu(gate) * up, sp["w_down"], cfg.quant, "moe",
                        split)


def moe_ffn(params: dict, x: torch.Tensor, cfg, *, window: bool = False,
            split: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux_loss).  ``params``: the
    :func:`moe_shapes` tree; the routing groups as :func:`groups`.
    ``split``: ``params`` holds this rank's ``E/m`` experts and its block
    of the shared experts (the module docstring)."""
    mc = cfg.moe
    b, s, d = x.shape
    e = mc.num_experts
    xg_in = groups(x, window)
    # a decode step's or a window column's group is the batch: its tokens
    # are split wherever the step's rows are
    across = act_sharding.rows_axes() if s == 1 or window else ()
    probs, top_e, sel_gate, sel_idx = route(params["router"], xg_in, cfg,
                                            across)

    # Switch-style load-balance aux loss: both means are over the whole
    # batch, so a mesh step averages them over the ranks that split its
    # rows (identity backward: the ranks' gradients sum to JAX's once)
    importance = probs.mean((0, 1))
    load = F.one_hot(top_e[..., 0], e).float().mean((0, 1))
    if act_sharding.rows_axes():
        importance, load = act_sharding.batch_mean(
            torch.stack([importance, load])).unbind(0)
    aux = e * torch.sum(importance * load) * mc.aux_loss_coef

    src, xg_src, first = x, xg_in, 0
    if split:
        # the split region's entries: the tokens and the gates
        src, sel_gate = tp.copy(x), tp.copy(sel_gate)
        xg_src = groups(src, window)
        n_local = e // act_sharding.model_size()
        first = act_sharding.model_rank() * n_local
        sel_gate = sel_gate[:, first:first + n_local]
        sel_idx = sel_idx[:, first:first + n_local]
    valid = (sel_gate > 0.0).float()
    yg = experts(params, dispatch(xg_src, sel_idx, valid))
    yg = yg * (sel_gate * valid)[..., None].to(yg.dtype)
    out = combine(yg, top_e, sel_idx, first)
    if s > 1 and window:
        out = out.transpose(0, 1)
    out = out.reshape(b, s, d)
    if mc.num_shared:
        out = out + shared_experts(params["shared"], src, cfg, split)
    if split:
        out = tp.reduce(out)
    return out.to(x.dtype), aux


class MoE(nn.Module):
    """The MoE feed-forward of one block over a :func:`moe_shapes` tree
    (the shared experts' leaves may be frozen ``QuantizedWeight`` s).
    ``split`` (set by ``tensor_parallel.plan``): the block computes its
    ``model`` shard (the module docstring)."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self.split = False
        for name in ("router", "w_gate", "w_up", "w_down"):
            set_leaf(self, name, params[name])
        if "shared" in params:
            self.shared = nn.Module()
            for name, leaf in params["shared"].items():
                set_leaf(self.shared, name, leaf)

    def params_tree(self) -> dict:
        tree = {n: getattr(self, n)
                for n in ("router", "w_gate", "w_up", "w_down")}
        if self.cfg.moe.num_shared:
            tree["shared"] = {n: getattr(self.shared, n)
                              for n in ("w_gate", "w_up", "w_down")}
        return tree

    def forward(self, x: torch.Tensor, *, window: bool = False):
        if self.split:
            return moe_ffn(self.params_tree(), x, self.cfg, window=window,
                           split=True)
        return moe_ffn(self.params_tree(), x, self.cfg, window=window)
