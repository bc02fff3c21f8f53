"""The port's dry run (``repro_torch.launch.dryrun``) and hillclimb
(``launch.hillclimb``): steps counted on meta tensors in a fake world.

Every count runs in ONE subprocess for this module (``JOB`` below, no
jax): ``init_process_group`` is process-global, and a fake world left
initialised would reach the gloo and mesh tests that an xdist worker runs
after this file.  The job checks the world is gone after each cell.

* On reduced configs of every family (dense, moe, ssm, hybrid, encdec,
  vlm; training on a (2, 2) mesh, and yi-9b's prefill and sharded decode),
  extrapolating the probes of ``accounting.probe_plan`` equals a direct
  count at the config's full reduced depth: FLOPs, bytes, each
  collective's count and bytes, the saved bytes.
* ``remat_policy="dots"`` counts fewer FLOPs than ``"nothing"``, lower by
  exactly the products it saves (the blocks' un-batched matmuls, which
  ``"nothing"`` runs again in the recompute).
* The variants ``save_dots`` and ``causal_skip`` move the term JAX's
  comments say they move, the same way: fewer FLOPs, and fewer FLOPs and
  bytes ("halves causal work").  ``bf16_attn`` ("halves attention HBM
  bytes" in JAX) adds bytes in the port, whose attention keeps f32 copies
  of K and V under both settings.  Every variant's override names a field
  of the port's ``ModelConfig``, and the variants are JAX's.
* The CLI at full width: ``--arch yi-9b --shape train_4k`` writes an
  ``ok`` record on meta with H100 constants, attention, MLP and
  vocabulary split over the model axis and the FLOPs a rank in the
  predicted range; decode without ``decode_attn="sharded"`` and yi-9b's
  ``long_500k`` are skips whose reasons name a ROADMAP item or
  ``cell_supported``; ``hillclimb``'s ``sharded_decode+tp`` maps
  ``serve_param_sharding="tp"`` to ``param_specs(serve_tp=True)``.
* ``hillclimb``'s ``sharded_decode+tp`` lut4 decode counts for every
  arch with a decode path on a model axis (a block the plan leaves
  gathered keeps its frozen leaves whole); the moe family and llava split
  their every part at (16, 16); deepseek-v2-lite's ``train_4k`` counts
  >= 8x fewer FLOPs a rank than with no block split.
* A fake world refuses to start inside an initialised group.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from dataclasses import fields

import pytest

from repro.launch import hillclimb as jhill
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import hillclimb as thill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-9

JOB = textwrap.dedent('''
    import pickle, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as dr, hillclimb as hc
    from repro_torch.launch.accounting import extrapolate, probe_plan
    from repro_torch.models.registry import get_config

    out_dir = sys.argv[1]
    res = {"families": {}, "variants": {}, "leaked": []}
    MESH = (2, 2)
    FAMILIES = {
        "yi-9b": dict(num_layers=4),
        "deepseek-v2-lite-16b": dict(num_layers=4),
        "mamba2-1.3b": dict(num_layers=4),
        "zamba2-1.2b": dict(num_layers=5),
        "whisper-base": dict(num_layers=3),
        "llava-next-mistral-7b": dict(num_layers=4),
    }

    def cfg_of(arch, **over):
        cfg = get_config(arch).reduced(**FAMILIES[arch], **over)
        if cfg.encdec is not None:
            from dataclasses import replace
            cfg = replace(cfg, encdec=replace(cfg.encdec, enc_layers=3))
        return cfg

    def count(cfg, shape):
        rec = dr.count_cell(cfg, shape, MESH)
        if dist.is_initialized():
            res["leaked"].append(cfg.name)
        return rec

    def probed(cfg, shape):
        from dataclasses import replace
        probes, full = probe_plan(cfg, shape.kind)
        recs = [count(replace(cfg, **o), shape) for o, _ in probes]
        return extrapolate(recs, probes, full)

    train = ShapeConfig("t", 64, 8, "train")
    cells = [(a, train, {}) for a in FAMILIES]
    cells += [("yi-9b", ShapeConfig("p", 64, 8, "prefill"), {}),
              ("yi-9b", ShapeConfig("d", 64, 8, "decode"),
               {"decode_attn": "sharded"})]
    for arch, shape, over in cells:
        cfg = cfg_of(arch, **over)
        res["families"][(arch, shape.kind)] = (
            count(cfg, shape), probed(cfg, shape), cfg.num_layers)

    for pol in ("nothing", "dots"):
        res["remat", pol] = count(cfg_of("yi-9b", remat_policy=pol), train)
    for v in ("baseline", "save_dots", "causal_skip", "bf16_attn"):
        # 4 attention chunks of 16, so a causal chunk has keys to skip
        res["variants"][v] = count(
            cfg_of("yi-9b", attn_chunk=16, **hc.VARIANTS[v]), train)

    # the CLIs at full width
    res["cli_rc"] = dr.main(["--arch", "yi-9b", "--shape", "train_4k",
                             "--out", out_dir])
    for shape in ("decode_32k", "long_500k"):
        dr.main(["--arch", "yi-9b", "--shape", shape, "--out", out_dir])
    tp = hc.run_variant("yi-9b", "decode_32k", "sharded_decode+tp",
                        out_dir=out_dir)
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import get_model
    from repro_torch.parallel.fsdp import flat_specs
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.tree import leaves
    mesh = AbstractMesh((16, 16), ("data", "model"))
    tree = get_model(get_config("yi-9b"), device="meta").params_tree()
    res["tp"] = (tp["memory"]["argument_breakdown"]["params"], {
        serve_tp: sum(cost.shard_bytes(tuple(t.shape), t.element_size(),
                                       sp, mesh)
                      for t, sp in zip(leaves(tree), flat_specs(
                          param_specs(tree, mesh, serve_tp=serve_tp))))
        for serve_tp in (False, True)})
    res["tp_gathers"] = tp["collective_breakdown"]["all_gather"]
    res["fsdp_gathers"] = hc.run_variant(
        "yi-9b", "decode_32k", "sharded_decode",
        out_dir=out_dir)["collective_breakdown"]["all_gather"]

    # every arch's split lut4 decode at (16, 16), and its seconds
    import time
    from repro_torch.models.registry import ARCH_IDS
    res["tp_decode"] = {}
    for arch in ARCH_IDS:
        t0 = time.time()
        rec = hc.run_variant(arch, "decode_32k", "sharded_decode+tp",
                             quant="lut4", out_dir=out_dir)
        res["tp_decode"][arch] = (rec["status"], rec.get("reason"),
                                  rec.get("model_axis_compute"),
                                  time.time() - t0)

    # what each family splits at (16, 16), on meta
    from repro_torch.parallel import tensor_parallel as tpar
    res["describe"] = {}
    for arch in ("deepseek-v2-lite-16b", "deepseek-v2-236b",
                 "llava-next-mistral-7b"):
        model = get_model(get_config(arch), device="meta")
        tpar.plan(model, param_specs(model.params_tree(), mesh), mesh)
        res["describe"][arch] = tpar.describe(model)

    # deepseek-v2-lite's train_4k, split and with no block split
    res["moe_train"] = dr.run_cell("deepseek-v2-lite-16b", "train_4k",
                                   False)
    plan = tpar.plan
    tpar.plan = lambda *a, **k: {}
    try:
        res["moe_train_unsplit"] = dr.run_cell("deepseek-v2-lite-16b",
                                               "train_4k", False)
    finally:
        tpar.plan = plan

    # a fake world refuses to start inside an initialised group
    with dr.fake_world(4):
        try:
            with dr.fake_world(4):
                pass
            res["nested"] = "started"
        except RuntimeError as e:
            res["nested"] = str(e)
    res["after"] = dist.is_initialized()
    with open(out_dir + "/job.pkl", "wb") as f:
        pickle.dump(res, f)
''')


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", JOB, str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "job.pkl", "rb") as f:
        res = pickle.load(f)
    res["dir"], res["stdout"] = out, proc.stdout
    return res


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1)


@pytest.mark.parametrize("arch,kind", [
    ("yi-9b", "train"), ("deepseek-v2-lite-16b", "train"),
    ("mamba2-1.3b", "train"), ("zamba2-1.2b", "train"),
    ("whisper-base", "train"), ("llava-next-mistral-7b", "train"),
    ("yi-9b", "prefill"), ("yi-9b", "decode")])
def test_probes_extrapolate_to_the_direct_count(job, arch, kind):
    direct, probed, layers = job["families"][(arch, kind)]
    assert layers >= 3
    for k in ("flops", "bytes", "collective_bytes", "saved_bytes"):
        assert _close(probed[k], direct[k]), (k, probed[k], direct[k])
    for kind_, c in direct["collectives"].items():
        assert _close(probed[f"n_{kind_}"], c["count"]), kind_
        assert _close(probed[f"coll_{kind_}"], c["bytes"]), kind_
    assert direct["flops"] > 0 and direct["bytes"] > 0
    assert direct["collectives"]["all_gather"]["count"] > 0
    assert not job["leaked"]


def test_family_kernels_are_recorded(job):
    """The SSD families' steps launch the scan and its backward (on meta,
    recorded by their formulas); the others launch no hand-written
    kernel under bf16 and chunked attention."""
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        k = job["families"][(arch, "train")][0]["kernels"]
        n = job["families"][(arch, "train")][2]
        assert k["ssd_scan"]["launches"] == 2 * n      # forward + recompute
        assert k["ssd_scan_bwd"]["launches"] == n
    assert job["families"][("yi-9b", "train")][0]["kernels"] == {}


def test_dots_saves_exactly_the_blocks_products(job):
    """Under "nothing" a block's recompute runs its projections again, up
    to the last one its backward needs: non-reentrant checkpointing stops
    the recompute early, so w_down's product (whose output no gradient
    reads) is not run again.  "dots" saves those products, so its count is
    lower by exactly them (and the bmm's are recomputed under both)."""
    nothing, dots = job["remat", "nothing"], job["remat", "dots"]
    # reduced yi-9b: D 128, 4 heads and 2 KV heads of 32, d_ff 256; 4
    # layers; 4 of the 8 rows on each rank of (2, 2), 64 tokens each; the
    # heads (KV heads too: 2 divide the model axis of 2) and d_ff split
    # over model, so a rank runs 1/2 of each product
    d, h, hkv, hd, f, layers, tokens, m = 128, 4, 2, 32, 256, 4, 4 * 64, 2
    rerun = (d * h * hd + 2 * d * hkv * hd + h * hd * d + 2 * d * f) // m
    assert nothing["flops"] - dots["flops"] == 2 * tokens * rerun * layers
    assert nothing["collectives"] == dots["collectives"]


def test_variants_move_the_terms_jax_says(job):
    """save_dots and causal_skip move what JAX's comments say.  bf16_attn
    does not in the port: its attention casts K and V to f32 under both
    settings (``models.attention.sdpa``; ``torch.bmm(out_dtype=)`` has no
    derivative, so bf16 operands with f32 accumulation are not on the
    autograd path) and ``attn_f32=False`` only adds P's rounding, so the
    count shows no HBM saving where JAX's comment claims half (ROADMAP
    queue 1 item 9d)."""
    v = job["variants"]
    base = v["baseline"]
    assert v["save_dots"]["flops"] < base["flops"]        # no recompute
    assert v["causal_skip"]["flops"] < base["flops"]      # causal work
    assert v["causal_skip"]["bytes"] < base["bytes"]
    assert v["bf16_attn"]["flops"] == base["flops"]
    assert v["bf16_attn"]["bytes"] > base["bytes"]        # P's rounding


def test_variants_are_jaxs_on_the_ports_fields():
    assert thill.VARIANTS == jhill.VARIANTS
    names = {f.name for f in fields(ModelConfig)}
    for over in thill.VARIANTS.values():
        assert set(over) <= names


def test_cli_records(job):
    import json
    d = job["dir"]
    assert job["cli_rc"] == 0
    rec = json.loads((d / "yi-9b__train_4k__sp.json").read_text())
    assert rec["status"] == "ok"
    assert rec["device"] == "meta"
    assert rec["constants"] == "NVIDIA H100 SXM data sheet"
    # heads, FFN hidden and vocabulary split over model; the counted
    # FLOPs a rank fall >= 10x from the replicated compute's 5.05e15,
    # into the 3.2-3.6e14 predicted in PERF.md
    assert rec["model_axis_compute"] == {"attention": "split",
                                         "mlp": "split", "vocab": "split"}
    assert 3.2e14 <= rec["flops"] <= 3.6e14
    assert 0.60 <= rec["useful_flops_ratio"] <= 0.69
    assert rec["chips"] == 256 and rec["n_params"] == 8829407232
    mem = rec["memory"]
    assert mem["bytes_per_device_peak_estimate"] == (
        mem["bytes_per_device_argument"] + mem["bytes_per_device_saved"])
    assert 0 < rec["useful_flops_ratio"] < 1
    assert rec["step_time_lb_s"] == max(rec["compute_s"], rec["memory_s"],
                                        rec["collective_s"])
    assert rec["probe_residual"] < 1e-9
    dec = json.loads((d / "yi-9b__decode_32k__sp.json").read_text())
    assert dec["status"] == "skip" and "ROADMAP" in dec["reason"]
    long_ = json.loads((d / "yi-9b__long_500k__sp.json").read_text())
    assert long_["status"] == "skip"
    assert long_["reason"].startswith("SKIP: pure full-attention arch")


def test_tp_variant_takes_the_serve_tp_specs(job):
    got, want = job["tp"]
    assert got == want[True] > want[False]
    assert job["tp_gathers"] < job["fsdp_gathers"]


def test_tp_decode_counts_every_arch(job):
    """``hillclimb --variant sharded_decode+tp --quant lut4 --shape
    decode_32k`` on meta at (16, 16): every arch with a decode path on a
    model axis counts (the blocks the plan does not split keep their
    leaves whole: minitron-4b's 24 heads, whisper's blocks), the SSM
    families are the dry run's skips, and each count takes seconds."""
    for arch, (status, reason, split, secs) in job["tp_decode"].items():
        print(f"TP_DECODE {arch}: {status} {split} {secs:.1f}s")
        if arch in ("mamba2-1.3b", "zamba2-1.2b"):
            assert status == "skip" and "item 9d" in reason, arch
            continue
        assert status == "ok", (arch, reason)
        assert secs < 60, (arch, secs)
    got = {a: r[2] for a, r in job["tp_decode"].items()}
    assert got["minitron-4b"]["attention"] == "replicated"
    assert got["minitron-4b"]["mlp"] == "split"
    assert set(got["whisper-base"].values()) == {"replicated"}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b",
                                  "llava-next-mistral-7b"])
def test_moe_family_and_llava_split_at_production(job, arch):
    want = {"attention": "split", "mlp": "split", "vocab": "split"}
    if arch.startswith("deepseek"):
        want["experts"] = "split"
    assert job["describe"][arch] == want


def test_moe_train_flops_fall_with_the_split(job):
    """deepseek-v2-lite-16b ``train_4k`` at (16, 16): the MLA heads, the
    experts' capacity slots and the shared experts cost 1/16 a rank, so
    the counted FLOPs fall by >= 8x against the same cell with no block
    split (PERF.md predicted 1.5-2.2e14 from 2.315e15 with only the dense
    MLP and the vocabulary split)."""
    rec, unsplit = job["moe_train"], job["moe_train_unsplit"]
    print(f"MOE_TRAIN flops {rec['flops']:.4g} (unsplit "
          f"{unsplit['flops']:.4g}), useful {rec['useful_flops_ratio']:.3f}"
          f" ({unsplit['useful_flops_ratio']:.3f}), collectives "
          f"{rec['collective_breakdown']} ({unsplit['collective_breakdown']})"
          f", memory_s {rec['memory_s']:.3f} ({unsplit['memory_s']:.3f})")
    assert rec["status"] == unsplit["status"] == "ok"
    assert set(rec["model_axis_compute"].values()) == {"split"}
    assert set(unsplit["model_axis_compute"].values()) == {"replicated"}
    assert rec["flops"] * 8 <= unsplit["flops"]


def test_fake_world_refuses_an_initialised_group(job):
    assert "already initialised" in job["nested"]
    assert job["after"] is False
