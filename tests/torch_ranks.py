"""Rank processes of the port's gloo tests (``test_torch_decode_attention``,
``test_torch_collectives``, ``test_torch_mesh_train``,
``test_torch_tensor_parallel``, ``test_torch_tensor_parallel_moe``):
imports torch,
numpy and the port, never jax.

    python tests/torch_ranks.py JOB DIR [RANKS]

starts ``WORLD`` (4; ``RANKS`` if given) ranks through the port's
``launch.mesh.spawn_host_ranks`` (processes of one spawn context, one
intra-op thread each, a gloo group joined through a file store, so no TCP
port collides across test workers; a rank that misses a collective fails
after ``GROUP_TIMEOUT_S`` instead of hanging); each runs ``JOBS[JOB](rank,
DIR)`` on ``DIR/in.pkl``, and the launcher writes rank r's result to
``DIR/out_<r>.pkl`` (and a job's own launcher part, ``LAUNCHER_JOBS``, to
``DIR/launcher.pkl``).  It exits nonzero if any rank fails; the caller
bounds it with a subprocess timeout.  The pickles are written and read by
these tests only.
"""
from __future__ import annotations

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.mesh import spawn_host_ranks  # noqa: E402
WORLD = 4
#: a collective that waits longer than this fails the rank
GROUP_TIMEOUT_S = 60
#: the launcher's wait for its ranks
JOIN_TIMEOUT_S = 240


def _inputs(workdir: str) -> dict:
    with open(os.path.join(workdir, "in.pkl"), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# job: sharded decode (test_torch_decode_attention)
# ---------------------------------------------------------------------------

def run_case(model, toks, case: dict, mesh) -> dict:
    """One case of the decode job on this rank: the port's prefill (whole,
    no mesh) when ``case["prefill"]``, :func:`shard_cache`, then
    ``case["steps"]`` teacher-forced decode steps under
    ``activation_sharding(mesh)``.  Returns the rank's rows, their logits
    (steps, rows, V) as f32 numpy, and the sharded calls and all-reduces
    the steps made."""
    import numpy as np
    import torch

    from repro_torch.models.common import CacheSpec
    from repro_torch.parallel.act_sharding import activation_sharding
    from repro_torch.serve import decode_attention as da

    b = toks.shape[0]
    pool = case["cache"] == "pool"
    p0 = case["prefill"]
    if pool:
        rows = list(range(b))
        state = model.init_cache(b, case["s_max"],
                                 spec=CacheSpec(*case["spec"]))
        tables = torch.tensor(case["tables"])
    else:
        data = mesh.shape["data"]
        d = mesh.coords["data"]
        rows = list(range(d * b // data, (d + 1) * b // data))
        state = model.init_cache(b, case["s_max"])
        tables = None
    with torch.no_grad():
        if p0:
            _, state = model.prefill(torch.as_tensor(toks[:, :p0]), state)
        state = da.shard_cache(state, mesh, paged=pool)
        calls0 = da.sharded_gqa_decode.calls + da.sharded_mla_decode.calls
        reduces0 = da.all_reduce.calls
        seq = []
        with activation_sharding(mesh):
            for i in range(case["steps"]):
                pos = p0 + i
                if case["index"] == "rows":
                    idx = torch.tensor([pos + o for o in case["offsets"]])
                    idx = idx[rows]
                else:
                    idx = pos
                tok = torch.as_tensor(toks[rows, pos:pos + 1])
                lg, state = model.decode_step(tok, state, idx, tables=tables)
                seq.append(lg[:, 0].float().numpy())
    return {"rows": rows, "logits": np.stack(seq),
            "calls": (da.sharded_gqa_decode.calls
                      + da.sharded_mla_decode.calls - calls0),
            "all_reduces": da.all_reduce.calls - reduces0}


def decode_job(rank: int, workdir: str) -> dict:
    """Every case of ``in.pkl`` on its meshes, and the control: the first
    (2, 2) case rerun with the model group replaced by the world's."""
    import copy
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_config

    job = _inputs(workdir)
    meshes = {tuple(s): Mesh(tuple(s), ("data", "model"))
              for s in job["meshes"]}
    out = {"mesh": {s: {"coords": m.coords, "groups": {
        a: dist.get_process_group_ranks(g) for a, g in m.groups.items()}}
        for s, m in meshes.items()}, "cases": {}}
    for case in job["cases"]:
        arch, dtype = job["archs"][case["arch"]]
        cfg = replace(get_config(arch).reduced(dtype=dtype,
                                               attn_impl="full"),
                      decode_attn="sharded",
                      decode_attn_precision=case["precision"])
        model = params_from_numpy(job["params"][case["arch"]], cfg, "cpu")
        toks = job["tokens"][case["arch"]]
        for s in case["meshes"]:
            out["cases"][(tuple(s), case["name"])] = run_case(
                model, toks, case, meshes[tuple(s)])
        if case["name"] == job["control"]:
            bad = copy.copy(meshes[(2, 2)])
            bad.groups = dict(bad.groups, model=None)   # the whole world
            out["control"] = run_case(model, toks, case, bad)
    out["attn"] = {form: attention_case(job, meshes[tuple(job["attn"][
        "mesh"])], grouped) for form, grouped in job["attn"]["forms"].items()}
    return out


def attention_case(job: dict, mesh, grouped: bool) -> dict:
    """``sharded_gqa_decode`` alone over this rank's shard of a zero bf16
    slab: ``in.pkl``'s f32 queries and bf16 new K/V, one step each at
    index 0, 1, ...  Returns the rank's rows and its (steps, rows, 1, H,
    dh) outputs."""
    import numpy as np
    import torch

    from repro_torch.models.attention import KVCache
    from repro_torch.serve import decode_attention as da

    a, x = job["attn"], job["attn_inputs"]
    kc = torch.zeros(a["b"], a["s"], a["hkv"], a["dh"], dtype=torch.bfloat16)
    cache = da.shard_cache(KVCache(kc, kc.clone()), mesh)
    rows = list(range(a["b"]))       # mesh (1, 4): one data coordinate
    seq = []
    for i in range(len(x["q"])):
        out, _, _ = da.sharded_gqa_decode(
            torch.from_numpy(x["q"][i]), cache.k, cache.v,
            torch.from_numpy(x["k"][i]).to(torch.bfloat16),
            torch.from_numpy(x["v"][i]).to(torch.bfloat16), i, mesh,
            sm_scale=x["sm_scale"], grouped_bf16=grouped)
        seq.append(out.numpy())
    return {"rows": rows, "logits": np.stack(seq)}


# ---------------------------------------------------------------------------
# job: collectives (test_torch_collectives)
# ---------------------------------------------------------------------------

def collectives_job(rank: int, workdir: str) -> dict:
    """``quantized_psum`` of this rank's row of ``in.pkl``'s x over the
    world and over a (2, 2) mesh's data group, and the production mesh's
    refusal of a 4-rank world."""
    import torch

    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.parallel.collectives import quantized_psum

    x = torch.from_numpy(_inputs(workdir)["x"][rank])
    mesh = Mesh((2, 2), ("data", "model"))
    try:
        make_production_mesh()
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"world": quantized_psum(x).numpy(),
            "data": quantized_psum(x, mesh.groups["data"]).numpy(),
            "coords": mesh.coords, "production_refused": refused}


# ---------------------------------------------------------------------------
# job: training on a mesh (test_torch_mesh_train)
# ---------------------------------------------------------------------------

def _mesh_step(model, cfg, batch, mesh, *, grad_compression=False,
               microbatch=0) -> dict:
    """One ``make_train_step`` step of ``model`` (a fresh copy each call:
    sharded in place when ``mesh`` is given) on the global ``batch``.
    Returns the reported loss, AdamW's ``grad_norm``, the gradients AdamW
    received and the updated params (whole leaves, f32 numpy, in leaf
    order), the compression's inputs when ``grad_compression``, and the
    collectives the step issued."""
    import copy

    import torch

    import repro_torch.train.train_step as ts
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import fsdp
    from repro_torch.tree import leaves

    model = copy.deepcopy(model).requires_grad_(True)
    if mesh is not None:
        fsdp.shard_model(model, mesh)
    specs = fsdp.spec_leaves(model)
    seen = {}

    class Recording(AdamW):
        def update(self, grads, state, params, **kw):
            seen["grads"] = [g.detach().clone() for g in leaves(grads)]
            return super().update(grads, state, params, **kw)

    compress = ts.compress_grads_int8

    def recorded(grads, *a):
        seen["raw"] = [g.detach().clone() for g in leaves(grads)]
        return compress(grads, *a)

    ts.compress_grads_int8 = recorded
    try:
        opt = Recording()
        state = opt.init(fsdp.local_tree(model))
        step = ts.make_train_step(cfg, opt, mesh, microbatch=microbatch,
                                  grad_compression=grad_compression)
        before = dict(fsdp.counts)
        metrics = step(model, state, batch)
        issued = {k: fsdp.counts[k] - before.get(k, 0) for k in fsdp.counts}
    finally:
        ts.compress_grads_int8 = compress

    def whole(tensors):
        if mesh is None:
            return [t.detach().float().numpy() for t in tensors]
        return [fsdp.gather_leaf(t.detach(), spec, mesh).float().numpy()
                for t, spec in zip(tensors, specs)]
    with torch.no_grad():
        out = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "grads": whole(seen["grads"]),
               "params": whole(leaves(fsdp.local_tree(model))),
               "issued": issued}
        if grad_compression:
            out["raw"] = whole(seen["raw"])
    out["local_shapes"] = [tuple(p.shape) for p in
                           leaves(fsdp.local_tree(model))]
    return out


def _torch_batch(batch: dict) -> dict:
    import torch
    return {k: (torch.from_numpy(v).long() if v.dtype.kind in "iu"
                else torch.from_numpy(v)) for k, v in batch.items()}


def mesh_train_job(rank: int, workdir: str) -> dict:
    """Every case of ``in.pkl``: the mesh step of each arch on its meshes
    (and the no-mesh step where a case holds the mesh to the port's own),
    the trainer runs, and ``pipeline_apply``."""
    from dataclasses import replace

    import torch

    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_config

    job = _inputs(workdir)
    meshes = {tuple(s): Mesh(tuple(s), ("data", "model"))
              for s in job["meshes"]}
    pod = Mesh((2, 2), ("pod", "data"))
    out = {"steps": {}}
    for case in job["cases"]:
        cfg = get_config(case["arch"]).reduced(**case["reduced"])
        if case.get("aux_loss_coef") is not None:
            cfg = replace(cfg, moe=replace(
                cfg.moe, aux_loss_coef=case["aux_loss_coef"]))
        model = params_from_numpy(case["params"], cfg, "cpu")
        batch = _torch_batch(case["batch"])
        if case["self_ref"]:
            out["steps"][(case["name"], None)] = _mesh_step(
                model, cfg, batch, None,
                grad_compression=case["compress"])
        for s in case["meshes"]:
            out["steps"][(case["name"], tuple(s))] = _mesh_step(
                model, cfg, batch, meshes[tuple(s)],
                grad_compression=case["compress"],
                microbatch=case.get("microbatch", 0))
    out["trainer"] = trainer_case(job["trainer"], meshes[(2, 2)])
    p = job["pipeline"]
    with torch.no_grad():
        from repro_torch.parallel.pipeline import pipeline_apply
        w = torch.from_numpy(p["w"][pod.coords["pod"]])
        out["pipeline"] = pipeline_apply(
            lambda w, x: torch.tanh(x @ w), w, torch.from_numpy(p["xs"]),
            mesh=pod).numpy()
    return out


def trainer_case(case: dict, mesh) -> dict:
    """The luna-mlp ``Trainer`` on ``mesh`` (JAX's ``TRAIN_SNIPPET``): 30
    steps; 12 steps, then a rerun to 20 (resumes from 12); a straight f32
    run of 10 steps, whose step-5 checkpoint the elastic restores read;
    returns each history."""
    import io
    from contextlib import redirect_stdout
    from dataclasses import replace

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("luna-mlp")
    out = {}

    def run(name, steps, ckpt, c=cfg):
        tcfg = TrainerConfig(total_steps=steps, ckpt_every=5, log_every=5,
                             ckpt_dir=ckpt, lr=3e-3, warmup=2)
        buf = io.StringIO()
        with redirect_stdout(buf):
            _, hist = Trainer(c, tcfg, mesh).run(
                SyntheticLM(c.vocab_size, 32, 8, seed=0),
                install_signals=False)
        out[name] = {"hist": hist, "stdout": buf.getvalue()}

    run("falls", 30, case["dirs"]["falls"])
    run("first", 12, case["dirs"]["resume"])
    run("resumed", 20, case["dirs"]["resume"])
    run("straight", 10, case["dirs"]["straight"],
        replace(cfg, dtype="float32"))
    return out


def elastic_job(rank: int, workdir: str) -> dict:
    """The f32 luna-mlp ``Trainer`` resumed to step 10 from ``in.pkl``'s
    checkpoint directory (its latest: step 5) on this world's ("data",
    "model") mesh (``WORLD`` ranks, model axis 1)."""
    import io
    from contextlib import redirect_stdout
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    job = _inputs(workdir)
    cfg = replace(get_config("luna-mlp"), dtype="float32")
    tcfg = TrainerConfig(total_steps=10, ckpt_every=5, log_every=5,
                         ckpt_dir=job["dir"], lr=3e-3, warmup=2)
    buf = io.StringIO()
    with redirect_stdout(buf):
        _, hist = Trainer(cfg, tcfg, make_host_mesh(model=1)).run(
            SyntheticLM(cfg.vocab_size, 32, 8, seed=0),
            install_signals=False)
    return {"hist": hist, "stdout": buf.getvalue(),
            "world": dist.get_world_size()}


# ---------------------------------------------------------------------------
# job: tensor-parallel compute (test_torch_tensor_parallel)
# ---------------------------------------------------------------------------

def _recorded_step(model, cfg, batch, mesh) -> dict:
    """:func:`_mesh_step`, recording the first forward's projections
    (``quant_matmul`` in attention and the MLP: x's width and w's shape
    in call order) and the NF4 codes it encodes (``nf4_encode``'s
    outputs, in call order)."""
    import repro_torch.core.layers as layers
    import repro_torch.models.attention as attention
    import repro_torch.models.mlp as mlp

    calls, codes = [], []
    qm, enc = layers.quant_matmul, layers.nf4_encode

    def rec_qm(x, w, *a, **kw):
        calls.append((x.shape[-1], tuple(w.shape)))
        return qm(x, w, *a, **kw)

    def rec_enc(wn, *a):
        out = enc(wn, *a)
        codes.append(out.clone().numpy())
        return out
    attention.quant_matmul = mlp.quant_matmul = rec_qm
    layers.nf4_encode = rec_enc
    try:
        out = _mesh_step(model, cfg, batch, mesh)
    finally:
        attention.quant_matmul = mlp.quant_matmul = qm
        layers.nf4_encode = enc
    per_layer = 7 * cfg.num_layers
    out["projections"] = calls[:per_layer]
    out["codes"] = codes[:per_layer]
    return out


def _greedy_decode(model, prefill_model, toks, steps, mesh,
                   split_rows=True):
    """Prefill ``toks`` (full precision, ``prefill_model``), then
    ``steps`` greedy decode steps of ``model`` (each step's token the last
    one's argmax), under ``activation_sharding(mesh)`` on this rank's
    shard of the cache (``mesh``) or on one device (None); the decode
    steps of a rank's block of the rows under ``rows_split_over("data")``
    (``split_rows=False``: not, as if each rank's rows were the batch).
    Returns the rank's rows, their logits (steps, rows, V) and tokens
    (rows, steps)."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.parallel.act_sharding import (activation_sharding,
                                                   rows_split_over)
    from repro_torch.serve import decode_attention as da

    b, p = toks.shape
    rows = list(range(b))
    split = contextlib.nullcontext
    if mesh is not None and mesh.shape["data"] > 1:
        n = b // mesh.shape["data"]
        rows = list(range(mesh.coords["data"] * n,
                          (mesh.coords["data"] + 1) * n))
        if split_rows:
            def split():
                return rows_split_over(("data",))
    ctx = (activation_sharding(mesh) if mesh is not None
           else contextlib.nullcontext())
    with torch.no_grad(), ctx:
        cache = prefill_model.init_cache(b, p + steps)
        lg, cache = prefill_model.prefill(torch.as_tensor(toks), cache)
        if mesh is not None:
            cache = da.shard_cache(cache, mesh)
        lg = lg[rows]
        seq, out = [], []
        for i in range(steps):
            tok = lg[:, -1].argmax(-1, keepdim=True)
            out.append(tok[:, 0].numpy())
            with split():
                lg, cache = model.decode_step(tok, cache, p + i)
            seq.append(lg[:, 0].float().numpy())
    return {"rows": rows, "logits": np.stack(seq),
            "tokens": np.stack(out, 1)}


def tensor_parallel_job(rank: int, workdir: str) -> dict:
    """``in.pkl``'s training cases (a mode each; ``self_modes`` also on
    no mesh) on its meshes through :func:`_recorded_step`, and its decode
    cases (an engine quant each):
    the split serving model's greedy decode on each mesh, with the shapes
    of the frozen leaves it holds; with ``self_ref`` also on no mesh and,
    on each mesh, the whole-weight layout's (``"fsdp"``)."""
    from dataclasses import replace

    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.layers import QuantConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_config
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.tree import leaves

    job = _inputs(workdir)
    meshes = {tuple(s): Mesh(tuple(s), ("data", "model"))
              for s in job["meshes"]}
    base = get_config(job["arch"]).reduced(**job["reduced"])
    out = {"steps": {}, "decode": {}, "coords": {
        s: m.coords for s, m in meshes.items()}}
    for mode in job["modes"] + job.get("self_modes", ()):
        cfg = replace(base, quant=QuantConfig(mode=mode))
        model = params_from_numpy(job["params"], cfg, "cpu")
        batch = _torch_batch(job["batch"])
        if job["self_ref"] or mode in job.get("self_modes", ()):
            out["steps"][(mode, None)] = _recorded_step(model, cfg, batch,
                                                        None)
        for s, mesh in meshes.items():
            out["steps"][(mode, s)] = _recorded_step(model, cfg, batch,
                                                     mesh)
    cfg = replace(base, decode_attn="sharded", serve_param_sharding="tp")
    model = params_from_numpy(job["params"], cfg, "cpu")
    # self_ref: also the whole-weight serving layout ("fsdp") on each mesh
    whole = params_from_numpy(job["params"], replace(
        cfg, serve_param_sharding="fsdp"), "cpu")
    runs = [((s,), m, model) for s, m in meshes.items()]
    if job["self_ref"]:
        runs += [((None,), None, model)] + [
            ((s, "whole"), m, whole) for s, m in meshes.items()]
    for quant in job["decode_quants"]:
        for key, mesh, src in runs:
            full = tp.serving_model(src, mesh)
            frozen = tp.serving_model(src, mesh, quant)
            got = _greedy_decode(frozen, full, job["prompt"],
                                 job["steps"], mesh)
            got["frozen_shapes"] = [
                {k: tuple(v.shape) for k, v in vars(q).items()
                 if hasattr(v, "shape")} if hasattr(q, "codes")
                else tuple(q.shape)
                for q in leaves(frozen.params_tree())]
            got["split"] = tp.describe(frozen)
            out["decode"][(quant, *key)] = got
    return out


# ---------------------------------------------------------------------------
# job: the moe family split over model (test_torch_tensor_parallel_moe)
# ---------------------------------------------------------------------------

def megatron_moe_ffn(params, x, cfg, *, window=False, split=False):
    """A mutation of ``models.moe.moe_ffn``'s split path: Megatron's copy
    at the block's entry, as GQA and the MLP take it (the routing reads
    the copied hidden, and the gates enter the split region uncopied)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe
    from repro_torch.parallel import act_sharding as acts
    from repro_torch.parallel import tensor_parallel as tp

    mc = cfg.moe
    b, s, d = x.shape
    e = mc.num_experts
    x = tp.copy(x)
    xg = moe.groups(x, window)
    probs, top_e, sel_gate, sel_idx = moe.route(params["router"], xg, cfg)
    importance = probs.mean((0, 1))
    load = F.one_hot(top_e[..., 0], e).float().mean((0, 1))
    if acts.rows_axes():
        importance, load = acts.batch_mean(
            torch.stack([importance, load])).unbind(0)
    aux = e * torch.sum(importance * load) * mc.aux_loss_coef
    n = e // acts.model_size()
    first = acts.model_rank() * n
    sel_gate = sel_gate[:, first:first + n]
    sel_idx = sel_idx[:, first:first + n]
    valid = (sel_gate > 0.0).float()
    yg = moe.experts(params, moe.dispatch(xg, sel_idx, valid))
    yg = yg * (sel_gate * valid)[..., None].to(yg.dtype)
    out = moe.combine(yg, top_e, sel_idx, first).reshape(b, s, d)
    out = out + moe.shared_experts(params["shared"], x, cfg, True)
    return tp.reduce(out).to(x.dtype), aux


def _moe_recorded_step(model, cfg, batch, mesh) -> dict:
    """:func:`_mesh_step`, recording the first forward's projections in
    attention and the MoE blocks (``quant_matmul``: x's width and w's
    shape, in call order) and the expert stacks the routed products run
    on (``moe.experts``: ``w_gate``'s shape)."""
    import repro_torch.models.attention as attention
    import repro_torch.models.mlp as mlp
    import repro_torch.models.moe as moe

    calls, stacks = [], []
    qm, ex = attention.quant_matmul, moe.experts

    def rec_qm(x, w, *a, **kw):
        calls.append((x.shape[-1], tuple(w.shape)))
        return qm(x, w, *a, **kw)

    def rec_ex(params, xg):
        stacks.append(tuple(params["w_gate"].shape))
        return ex(params, xg)
    attention.quant_matmul = mlp.quant_matmul = moe.quant_matmul = rec_qm
    moe.experts = rec_ex
    try:
        out = _mesh_step(model, cfg, batch, mesh)
    finally:
        attention.quant_matmul = mlp.quant_matmul = moe.quant_matmul = qm
        moe.experts = ex
    # layer 0 (MLA + dense MLP: 3 + 3), layer 1 (MLA + shared: 3 + 3)
    out["projections"] = calls[:12]
    out["stacks"] = stacks[:1]
    return out


def _counting_choice(drops: list):
    """``moe.choose`` wrapped to append, at each decode step's choice (its
    one group), how many of this rank's tokens' top-k picks no expert's
    capacity took."""
    import repro_torch.models.moe as moe
    plain = moe.choose

    def choose(gates, cfg, across=()):
        sel_gate, sel_idx = plain(gates, cfg, across)
        if gates.shape[0] == 1:
            drops.append(int((gates > 0).sum()) - int((sel_gate > 0).sum()))
        return sel_gate, sel_idx
    return plain, choose


def tensor_parallel_moe_job(rank: int, workdir: str) -> dict:
    """``in.pkl``'s moe cases: the split mesh step of each mode on each
    mesh (``self_ref``: also on no mesh), the mutation's step
    (:func:`megatron_moe_ffn`) on each of ``mutation_meshes``, the split
    serving model's greedy decode of each engine quant on each mesh (with
    ``self_ref`` also on no mesh and the whole-weight layout), the
    data-split decode of ``wide`` rows with and without the rows split
    declared, and the ``luna_*`` steps of ``luna``'s yi-9b on no mesh and
    on its meshes (on each of its ``control`` meshes also the control
    whose activation scale takes the rank's rows only)."""
    from dataclasses import replace

    import repro_torch.core.layers as layers
    import repro_torch.models.moe as moe
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.layers import QuantConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_config
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.tree import leaves, leaves_with_path, path_key

    job = _inputs(workdir)
    meshes = {tuple(s): Mesh(tuple(s), ("data", "model"))
              for s in job["meshes"]}
    base = get_config(job["arch"]).reduced(**job["reduced"])
    base = replace(base, moe=replace(base.moe,
                                     aux_loss_coef=job["aux_loss_coef"]))
    batch = _torch_batch(job["batch"])
    out = {"steps": {}, "decode": {}, "luna": {}, "coords": {
        s: m.coords for s, m in meshes.items()}}
    for mode in job["modes"]:
        cfg = replace(base, quant=QuantConfig(mode=mode))
        model = params_from_numpy(job["params"], cfg, "cpu")
        out["paths"] = [path_key(p) for p, _ in
                        leaves_with_path(model.params_tree())]
        if job["self_ref"]:
            out["steps"][(mode, None)] = _moe_recorded_step(model, cfg,
                                                            batch, None)
        for s, mesh in meshes.items():
            out["steps"][(mode, s)] = _moe_recorded_step(model, cfg, batch,
                                                         mesh)
    plain = moe.moe_ffn
    moe.moe_ffn = megatron_moe_ffn
    try:
        model = params_from_numpy(job["params"], base, "cpu")
        for s in job["mutation_meshes"]:
            out["steps"][("mutation", tuple(s))] = _mesh_step(
                model, base, batch, meshes[tuple(s)])
    finally:
        moe.moe_ffn = plain

    cfg = replace(base, decode_attn="sharded", serve_param_sharding="tp")
    model = params_from_numpy(job["params"], cfg, "cpu")
    whole = params_from_numpy(job["params"], replace(
        cfg, serve_param_sharding="fsdp"), "cpu")
    runs = [((s,), m, model) for s, m in meshes.items()]
    if job["self_ref"]:
        runs += [((None,), None, model)] + [
            ((s, "whole"), m, whole) for s, m in meshes.items()]
    for quant in job["decode_quants"]:
        for key, mesh, src in runs:
            full = tp.serving_model(src, mesh)
            frozen = tp.serving_model(src, mesh, quant)
            got = _greedy_decode(frozen, full, job["prompt"],
                                 job["steps"], mesh)
            got["frozen_shapes"] = [
                {k: tuple(v.shape) for k, v in vars(q).items()
                 if hasattr(v, "shape")} if hasattr(q, "codes")
                else tuple(q.shape)
                for q in leaves(frozen.params_tree())]
            got["split"] = tp.describe(frozen)
            out["decode"][(quant, *key)] = got
    wide = job.get("wide")
    if wide:
        mesh = meshes[tuple(wide["mesh"])]
        for split_rows in (True, False):
            drops = []
            plain_choose, moe.choose = _counting_choice(drops)
            try:
                got = _greedy_decode(
                    tp.serving_model(model, mesh, wide["quant"]),
                    tp.serving_model(model, mesh), wide["prompt"],
                    job["steps"], mesh, split_rows=split_rows)
            finally:
                moe.choose = plain_choose
            got["drops"] = drops
            out["decode"][("wide", split_rows)] = got

    luna = job.get("luna")
    if luna:
        ycfg = get_config("yi-9b").reduced(**luna["reduced"])
        lbatch = _torch_batch(luna["batch"])
        lmeshes = {tuple(s): Mesh(tuple(s), ("data", "model"))
                   for s in luna["meshes"]}
        for mode in luna["modes"]:
            cfg = replace(ycfg, quant=QuantConfig(mode=mode))
            model = params_from_numpy(luna["params"], cfg, "cpu")
            out["luna"][(mode, None)] = _mesh_step(model, cfg, lbatch, None)
            for s, mesh in lmeshes.items():
                out["luna"][(mode, s)] = _mesh_step(model, cfg, lbatch,
                                                    mesh)
                if s not in map(tuple, luna["control"]):
                    continue
                rows = layers.rows_axes
                layers.rows_axes = tuple   # each rank's rows only
                try:
                    out["luna"][(mode, s, "rank rows")] = _mesh_step(
                        model, cfg, lbatch, mesh)
                finally:
                    layers.rows_axes = rows
    return out


JOBS = {"decode": decode_job, "collectives": collectives_job,
        "mesh_train": mesh_train_job, "elastic": elastic_job,
        "tensor_parallel": tensor_parallel_job,
        "tensor_parallel_moe": tensor_parallel_moe_job}


def mesh_train_dryrun(workdir: str) -> dict:
    """The launcher's part of the mesh_train job, run after the ranks
    (this process holds no process group): the dry run's count of each
    ``in.pkl`` ``"dryrun"`` cell (a reduced step on a mesh, counted on
    meta tensors in a fake world of the mesh's size), by (name, mesh)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.models.registry import get_config

    out = {}
    for case in _inputs(workdir).get("dryrun", []):
        cfg = get_config(case["arch"]).reduced(**case["reduced"])
        shape = ShapeConfig("step", case["s"], case["b"], "train")
        out[(case["name"], tuple(case["mesh"]))] = count_cell(
            cfg, shape, tuple(case["mesh"]))
    return out


def tensor_parallel_dryrun(workdir: str) -> dict:
    """The launcher's part of the tensor_parallel job: the dry run's count
    of each training case's step on each mesh, by (mode, mesh)."""
    from dataclasses import replace

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.layers import QuantConfig
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.models.registry import get_config

    job = _inputs(workdir)
    base = get_config(job["arch"]).reduced(**job["reduced"])
    b, s = job["batch"]["tokens"].shape
    shape = ShapeConfig("step", s, b, "train")
    return {(mode, tuple(m)): count_cell(
        replace(base, quant=QuantConfig(mode=mode)), shape, tuple(m))
        for mode in job["modes"] for m in job["meshes"]}


#: a job's part run by the launcher after its ranks (``DIR/launcher.pkl``)
LAUNCHER_JOBS = {"mesh_train": mesh_train_dryrun,
                 "tensor_parallel": tensor_parallel_dryrun}


def _job(job: str, workdir: str):
    import torch.distributed as dist
    return JOBS[job](dist.get_rank(), workdir)


def main(job: str, workdir: str, world: int = WORLD) -> int:
    try:
        outs = spawn_host_ranks(world, _job, job, workdir,
                                group_timeout_s=GROUP_TIMEOUT_S,
                                join_timeout_s=JOIN_TIMEOUT_S)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    for rank, out in enumerate(outs):
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    if job in LAUNCHER_JOBS:
        out = LAUNCHER_JOBS[job](workdir)
        with open(os.path.join(workdir, "launcher.pkl"), "wb") as f:
            pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2],
                  *(int(a) for a in sys.argv[3:4])))
