"""Dry run of every (arch x input-shape x mesh) cell on ``meta`` tensors
and a fake process group (mirrors ``repro.launch.dryrun``).

For each supported cell this module:
  1. initialises a ``"fake"`` world of 256 ranks for the (16, 16) mesh, or
     512 for (2, 16, 16), and builds the port's
     :class:`~repro_torch.launch.mesh.Mesh` over it (rank 0's view);
  2. builds the model on ``meta`` (no memory, no arithmetic) and shards it
     with :func:`~repro_torch.parallel.fsdp.shard_model` under JAX's specs
     (:mod:`repro_torch.parallel.sharding`);
  3. runs rank 0's step under :class:`~repro_torch.launch.cost.CostMode`:
     training is ``make_train_step(cfg, AdamW(), mesh)``, a prefill is
     ``prefill`` on the rank's rows, a decode is ``decode_step`` under
     ``activation_sharding(mesh)`` on the rank's shard of the cache (both
     under ``rows_split_over`` the batch axes: the rows meet where JAX's
     global batch does, an MoE decode's expert choice);
  4. counts the step at the probe depths of
     :mod:`repro_torch.launch.accounting` and extrapolates to full depth;
  5. writes the record to ``results_torch/dryrun/<cell>.json``.

What is counted is what the port runs, not what XLA would compile: the
attention heads (GQA and MLA), the FFN hidden dimension, the routed and
shared experts and the vocabulary are split over ``model``
(:mod:`repro_torch.parallel.tensor_parallel`), while the SSM and hybrid
mixers and whisper's blocks compute the same rows on every rank of the
axis (ROADMAP queue 1 item 9d); the record's ``"model_axis_compute"``
says which part does which (``tensor_parallel.describe``).  Where the
port has no code path for a cell, the record is a skip naming the
reason; nothing is invented.  The argument bytes are rank 0's share of the params, the AdamW
moments, the batch and the caches under JAX's specs (exact); the saved
bytes are what autograd keeps for the backward outside the remat'd
blocks, and argument plus saved is the peak estimate.

Usage (the CPU, no card):
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all       # every cell, both meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import ALL_SHAPES, ShapeConfig
from repro_torch.core.quant import quantize_decode_params
from repro_torch.launch import cost
from repro_torch.launch.accounting import (COLLECTIVES, METRICS, extrapolate,
                                           probe_plan)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.roofline import (active_params, analytic_flops,
                                         count_params, model_flops,
                                         roofline_terms)
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import (ARCH_IDS, cell_supported,
                                         get_config, get_model, input_specs)
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.act_sharding import (activation_sharding,
                                               rows_split_over)
from repro_torch.parallel.sharding import (batch_specs, cache_specs,
                                           param_specs)
from repro_torch.serve.config import ENGINE_QUANT_MODES, model_quant
from repro_torch.train.train_step import local_rows, make_train_step
from repro_torch.tree import leaves

RESULTS = Path(__file__).resolve().parents[3] / "results_torch" / "dryrun"
CONSTANTS = "NVIDIA H100 SXM data sheet"
#: the production meshes (JAX's ``make_production_mesh``)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = {s.name: s for s in ALL_SHAPES}
#: the ROADMAP item of what the port does not run on a model axis (the
#: SSM and hybrid mixers and whisper's blocks replicated along it, a
#: decode that gathers a sequence-sharded cache)
ITEM_9D = "ROADMAP queue 1 item 9d"


@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` default process group of ``size`` ranks, this process
    rank 0, destroyed on exit.  Refuses to start inside an initialised
    group (a real one, or a fake one left behind)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:        # an internal module of PyTorch
        raise RuntimeError(
            "the dry run needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"PyTorch {torch.__version__} lacks") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the dry "
                           "run's fake world would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one cell's step
# ---------------------------------------------------------------------------

def port_gap(cfg, shape: ShapeConfig, mesh_shape: dict, quant: str
             ) -> str | None:
    """Why the port has no code path for this cell (None: it has one)."""
    engine_quant = quant in ENGINE_QUANT_MODES
    if shape.kind == "train" and engine_quant:
        return (f"SKIP: {quant} is an engine-level decode quantization "
                "(frozen weights); training takes the model-level modes")
    if shape.kind == "decode" and mesh_shape.get("model", 1) > 1:
        if cfg.family in ("ssm", "hybrid"):
            return ("SKIP: the port has no decode of an SSM state sharded "
                    f"over a model axis > 1 ({ITEM_9D})")
        if cfg.decode_attn != "sharded":
            return ("SKIP: decode over a model axis > 1 needs "
                    "decode_attn='sharded' (the port runs it, with "
                    "serve_param_sharding='tp' on split weights: hillclimb's "
                    "sharded_decode+tp): the port has no cache-gathering "
                    f"decode ({ITEM_9D})")
    return None


def _spec_bytes(shapes, specs, mesh) -> int:
    """Rank 0's bytes of every leaf (``(shape, itemsize)`` pairs) under its
    spec."""
    return sum(cost.shard_bytes(s, i, sp, mesh)
               for (s, i), sp in zip(shapes, specs))


def _leaf_shapes(tree) -> list:
    return [(tuple(t.shape), t.element_size()) for t in leaves(tree)]


def argument_bytes(cfg, shape: ShapeConfig, mesh, model, quant: str
                   ) -> dict:
    """Rank 0's share of the step's arguments under JAX's specs: params
    (``serve_param_sharding="tp"`` drops ``data`` for serving), AdamW's
    two f32 moments and step for training, the batch (``input_specs``) and
    the caches (``init_cache`` of the global batch, ``cache_specs``).
    Frozen decode weights (an engine-level ``quant``) stay whole on every
    rank under ``serve_param_sharding="fsdp"``, as the port serves them;
    under ``"tp"`` each rank holds its model shard
    (``tensor_parallel.serving_model``)."""
    tree = model.params_tree()
    out = {}
    if (quant in ENGINE_QUANT_MODES and shape.kind == "decode"
            and cfg.serve_param_sharding != "tp"):
        out["params"] = cost.tree_bytes(quantize_decode_params(tree, quant))
    elif quant in ENGINE_QUANT_MODES and shape.kind == "decode":
        out["params"] = _frozen_shard_bytes(model, tree, quant, mesh)
    else:
        serve_tp = (shape.kind != "train"
                    and cfg.serve_param_sharding == "tp")
        specs = fsdp.flat_specs(param_specs(tree, mesh,
                                                serve_tp=serve_tp))
        out["params"] = _spec_bytes(_leaf_shapes(tree), specs, mesh)
        if shape.kind == "train":
            f32 = [(s, 4) for s, _ in _leaf_shapes(tree)]
            out["opt_state"] = 2 * _spec_bytes(f32, specs, mesh) + 4
    batch = input_specs(cfg, shape)
    bspecs = batch_specs({k: s for k, (s, _) in batch.items()}, mesh)
    out["batch"] = sum(
        cost.shard_bytes(s, torch.empty((), dtype=dt).element_size(),
                         bspecs[k], mesh) for k, (s, dt) in batch.items())
    if shape.kind != "train":
        out["caches"] = sum(
            _spec_bytes(_leaf_shapes(part),
                        fsdp.flat_specs(cache_specs(part, mesh)), mesh)
            for part in _global_cache(cfg, shape, model))
    out["total"] = sum(out.values())
    return out


def _frozen_shard_bytes(model, tree, quant: str, mesh) -> int:
    """Rank 0's bytes of the frozen decode tree as
    ``tensor_parallel.serving_model`` cuts it (``serving_specs``: the
    split blocks' leaves by ``param_specs(serve_tp=True)``, the others
    whole): a ``QuantizedWeight``'s codes, scales and zero points by the
    weight's spec, its tables whole."""
    from repro_torch.core.quant import QuantizedWeight
    frozen = quantize_decode_params(tree, quant)
    specs = fsdp.flat_specs(tp.serving_specs(model, mesh))
    total = 0
    for leaf, spec in zip(leaves(frozen), specs):
        if not isinstance(leaf, QuantizedWeight):
            total += cost.shard_bytes(tuple(leaf.shape), leaf.element_size(),
                                      spec, mesh)
            continue
        for name, t in vars(leaf).items():
            if not isinstance(t, torch.Tensor):
                continue
            sp = {"codes": spec, "scale": spec[-1:],
                  "zero_point": spec[-1:]}.get(name, ())
            total += cost.shard_bytes(tuple(t.shape), t.element_size(), sp,
                                      mesh)
    return total


def _global_cache(cfg, shape, model) -> list:
    """The whole cache of the global batch (meta), and for an encdec
    decode the encoder output its state carries beside it."""
    b = shape.global_batch
    parts = [model.init_cache(b, shape.seq_len)]
    if cfg.family == "encdec" and shape.kind == "decode":
        parts.append(torch.empty((b, cfg.encdec.enc_seq, cfg.d_model),
                                 dtype=dtype_of(cfg), device="meta"))
    return parts


def make_batch(cfg, shape: ShapeConfig, device) -> dict:
    """The step's global inputs (``input_specs``, less decode's index): on
    ``meta`` empty, on a device random tokens below the vocabulary (int64,
    as ``SyntheticLM`` gives them) and unit-normal frames/patches."""
    meta = torch.device(device).type == "meta"
    out = {}
    for name, (shp, dt) in input_specs(cfg, shape).items():
        if name == "index":
            continue
        if meta:
            out[name] = torch.empty(shp, dtype=dt if dt.is_floating_point
                                    else torch.int64, device=device)
        elif dt.is_floating_point:
            out[name] = torch.randn(shp, device=device).to(dt)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shp, device=device)
    return out


def prepare_step(cfg, shape: ShapeConfig, mesh, *, quant: str = "bf16",
                 model=None, device="meta"):
    """(run, model): ``run()`` is one step of rank 0 of this cell on
    ``mesh``, and ``model`` the model it runs (built on ``meta`` when not
    given; a given one is unsharded and on ``device``).  The params are
    sharded under JAX's specs; frozen decode weights (an engine-level
    ``quant``) are cut to rank 0's model shard under
    ``serve_param_sharding="tp"`` (``tensor_parallel.serving_model``),
    and stay whole under ``"fsdp"``, as the engine serves them."""
    if model is None:
        model = get_model(cfg, device=device)
    engine_quant = quant in ENGINE_QUANT_MODES
    batch = make_batch(cfg, shape, device)
    if shape.kind == "train":
        model.requires_grad_(True)
        fsdp.shard_model(model, mesh)
        opt = AdamW()
        state = opt.init(fsdp.local_tree(model))
        step = make_train_step(cfg, opt, mesh)
        return (lambda: step(model, state, batch)), model
    rows, axes = local_rows(batch, mesh)
    b = next(iter(rows.values())).shape[0]
    if shape.kind == "decode" and engine_quant:
        model = tp.serving_model(model, mesh, quant)
    else:
        serve_tp = cfg.serve_param_sharding == "tp"
        fsdp.shard_model(model, mesh, param_specs(model.params_tree(), mesh,
                                                  serve_tp=serve_tp))
    extra = {k: v for k, v in rows.items() if k in ("frames", "patches")}
    if shape.kind == "prefill":
        caches = model.init_cache(b, shape.seq_len)

        def run():
            with torch.no_grad(), activation_sharding(mesh), \
                    rows_split_over(axes):
                return model.prefill(rows["tokens"], caches, **extra)
        return run, model
    from repro_torch.serve.decode_attention import shard_cache
    gb = shape.global_batch
    caches = shard_cache(model.init_cache(gb, shape.seq_len), mesh)
    if cfg.family == "encdec":
        enc = torch.zeros((b, cfg.encdec.enc_seq, cfg.d_model),
                          dtype=dtype_of(cfg), device=device)
        caches = (caches, enc)
    token = rows["token"]
    index = shape.seq_len - 1

    def run():
        with torch.no_grad(), activation_sharding(mesh), \
                rows_split_over(axes):
            return model.decode_step(token, caches, index)
    return run, model


def count_step(run, training: bool) -> dict:
    """One call of ``run()`` under :class:`~repro_torch.launch.cost.
    CostMode` (and, for training, :class:`~repro_torch.launch.cost.
    SavedBytes`): the cost record, flattened to :data:`accounting.METRICS`
    plus ``kernels``."""
    saved = cost.SavedBytes() if training else contextlib.nullcontext()
    with cost.CostMode() as mode, saved:
        run()
    rec = mode.record()
    for k in COLLECTIVES:
        rec[f"coll_{k}"] = rec["collectives"][k]["bytes"]
        rec[f"n_{k}"] = rec["collectives"][k]["count"]
    rec["saved_bytes"] = saved.bytes if training else 0
    return rec


def cell_config(arch: str, quant: str = "bf16",
                extra_cfg: dict | None = None):
    cfg = get_config(arch, **(extra_cfg or {}))
    mq = model_quant(quant)
    return cfg if mq is None else replace(cfg, quant=mq)


def count_cell(cfg, shape: ShapeConfig, mesh_shape: tuple,
               axes: tuple = ("data", "model"), quant: str = "bf16") -> dict:
    """Rank 0's counted step (:func:`count_step`) of ``cfg`` at its own
    depth on a ``mesh_shape`` mesh, inside a fake world of that size."""
    t0 = time.time()
    with fake_world(math.prod(mesh_shape)):
        run, model = prepare_step(cfg, shape, Mesh(mesh_shape, axes),
                                  quant=quant)
        rec = count_step(run, shape.kind == "train")
        rec["model_axis_compute"] = tp.describe(model)
    rec["count_s"] = round(time.time() - t0, 2)
    rec["num_layers"] = cfg.num_layers
    return rec


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               quant: str = "bf16", extra_cfg: dict | None = None) -> dict:
    """Rank 0's counted step of this cell at the config's own depth (a
    probe when ``extra_cfg`` cuts it) on the production mesh."""
    return count_cell(cell_config(arch, quant, extra_cfg), SHAPES[shape_name],
                      *PRODUCTION[multi_pod], quant=quant)


def account_cell(arch: str, shape_name: str, multi_pod: bool,
                 quant: str = "bf16", extra_cfg: dict | None = None) -> dict:
    """Full-depth totals from the probes of
    :func:`~repro_torch.launch.accounting.probe_plan`."""
    cfg = cell_config(arch, quant, extra_cfg)
    probes, full = probe_plan(cfg, SHAPES[shape_name].kind)
    recs = [lower_cell(arch, shape_name, multi_pod, quant,
                       {**(extra_cfg or {}), **over}) for over, _ in probes]
    out = extrapolate(recs, probes, full)
    out["probes"] = [{"num_layers": r["num_layers"], "flops": r["flops"],
                      "count_s": r["count_s"], "kernels": r["kernels"]}
                     for r in recs]
    out["model_axis_compute"] = recs[-1]["model_axis_compute"]
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quant: str = "bf16", extra_cfg: dict | None = None) -> dict:
    """The full record: rank 0's arguments at full depth, the counted step
    extrapolated from the probes, and the roofline."""
    shape = SHAPES[shape_name]
    ok, why = cell_supported(arch, shape)
    if not ok:
        return {"status": "skip", "reason": why}
    cfg = cell_config(arch, quant, extra_cfg)
    mshape, axes = PRODUCTION[multi_pod]
    from repro_torch.launch.mesh import AbstractMesh
    amesh = AbstractMesh(mshape, axes)
    gap = port_gap(cfg, shape, amesh.shape, quant)
    if gap is not None:
        return {"status": "skip", "reason": gap}
    chips = amesh.size
    model = get_model(cfg, device="meta")
    n_params = count_params(model)
    n_active = active_params(cfg, n_params)
    args = argument_bytes(cfg, shape, amesh, model, quant)
    t0 = time.time()
    acct = account_cell(arch, shape_name, multi_pod, quant, extra_cfg)
    acct = {k: (round(v) if k in METRICS else v) for k, v in acct.items()}
    flops, nbytes = acct["flops"], acct["bytes"]
    coll = acct["collective_bytes"]
    mf = model_flops(cfg, shape, n_params, n_active)
    rec = {
        "status": "ok", "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "quant": quant, "device": "meta", "constants": CONSTANTS,
        "model_axis_compute": acct["model_axis_compute"],
        "n_params": n_params, "n_active_params": n_active,
        "count_s": round(time.time() - t0, 2),
        "flops": flops, "bytes": nbytes, "collective_bytes": coll,
        "collective_breakdown": {k: acct[f"coll_{k}"] for k in COLLECTIVES},
        "collective_op_counts": {k: acct[f"n_{k}"] for k in COLLECTIVES},
        "probe_residual": acct["probe_residual"], "probes": acct["probes"],
        "model_flops": mf,
        "memory": {
            "bytes_per_device_argument": args["total"],
            "argument_breakdown": args,
            "bytes_per_device_saved": acct["saved_bytes"],
            "bytes_per_device_peak_estimate": (args["total"]
                                               + acct["saved_bytes"]),
        },
    }
    if cfg.ssm is not None:
        rec["analytic_flops"] = analytic_flops(cfg, shape)
        rec["analytic_ratio"] = (rec["analytic_flops"] / (flops * chips)
                                 if flops else None)
    # the counts are rank 0's; the terms divide global work by chips
    rec.update(roofline_terms(flops * chips, nbytes * chips, coll * chips,
                              chips))
    rec["useful_flops_ratio"] = mf / (flops * chips) if flops else 0.0
    return rec


def cell_tag(arch: str, shape: str, multi_pod: bool, quant: str) -> str:
    tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"
    return tag if quant == "bf16" else f"{tag}__{quant}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the records (default %(default)s)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = (list(SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = ([False, True] if (args.all or args.both_meshes)
              else [args.multipod])
    failures = 0
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = cell_tag(arch, shape, mp, args.quant)
                print(f"[count ] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, quant=args.quant)
                except Exception as e:  # noqa: BLE001
                    rec = {"status": "fail", "error": str(e)[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                (out_dir / f"{tag}.json").write_text(json.dumps(rec,
                                                                indent=1))
                if rec["status"] == "ok":
                    mem = rec["memory"]["bytes_per_device_peak_estimate"]
                    print(f"   ok: {rec['count_s']}s "
                          f"dominant={rec['dominant']} "
                          f"roofline={rec['roofline_fraction']:.3f} "
                          f"useful={rec['useful_flops_ratio']:.3f} "
                          f"peak/dev={mem / 2**30:.2f}GiB", flush=True)
                elif rec["status"] == "skip":
                    print(f"   skip: {rec['reason']}")
                else:
                    print(f"   FAIL: {rec['error'][:300]}")
    print(f"done in {time.time() - t_all:.1f}s; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
