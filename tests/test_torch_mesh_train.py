"""Training on a mesh over ``torch.distributed`` (``parallel.fsdp``,
``train_step.make_train_step(..., mesh)``, the mesh ``Trainer``,
``checkpoint.ckpt``'s elastic restore, ``parallel.pipeline``) against the
JAX package, on 4 gloo ranks (``tests/torch_ranks.py``'s ``mesh_train``
job, one spawn; JAX's reference runs in this process meanwhile).

(a) The mesh step of reduced f32 yi-9b, deepseek-v2-lite-16b (aux loss
    coefficient 0.1) and mamba2-1.3b (2 layers, d_model 256, 8 heads,
    d_ff 512, head_dim 32; ``SyntheticLM(vocab, 32, 8, seed=0).batch(0)``,
    AdamW's defaults) on the meshes (4, 1), (2, 2) and (1, 4), against
    JAX's unsharded jitted ``make_train_step`` on the bridged weights: the
    loss within ``LOSS_REL`` (1e-6) relative, AdamW's ``grad_norm`` (the
    clip's input: the global norm over shards) within ``NORM_REL`` (1e-6)
    relative of JAX's and of the whole gradients' norm, every gradient
    within ``GRAD_REL`` (1e-4) of its leaf's max |jax|, the updated params
    within ``PARAM_ABS`` (1e-4) absolute at lr 3e-4 (JAX's own sharded
    step is up to 2.2e-5 from its unsharded one).  Every rank holds only
    its shards (their shapes are checked) and the step issued gathers and
    gradient reductions.
(b) zamba2-1.2b, whisper-base and llava-next-mistral-7b (reduced f32) on
    (2, 2), held to the port's own no-mesh step at the same tolerances
    (earlier tests hold that step to JAX).
(c) ``grad_compression`` on (2, 2): the compressed gradients AdamW gets
    are, bitwise, JAX's ``compress_grads_int8`` of the whole gradients the
    ranks hold (the scale is the whole leaf's), and equal the no-mesh
    step's compression wherever the two gradients are equal.
(d) The luna-mlp ``Trainer`` on (2, 2) (JAX's ``TRAIN_SNIPPET``): the loss
    falls by >= 10% in 30 steps; a rerun resumes from step 12; a straight
    f32 10-step run on 4 ranks writes step 5's checkpoint, which resumes on
    2 ranks and on no mesh (the same 10-step schedule), with the losses of
    steps 5-9 within 1e-6 relative of the straight run's.
(e) ``pipeline_apply`` on a (2, 2) ("pod", "data") mesh equals the
    stages run in sequence at 1e-5 (JAX's ``test_pipeline_matches_
    sequential``).
(f) yi-9b's step in 2 microbatches on (2, 2) against JAX's
    ``make_train_step(microbatch=2)``: the last piece's loss, the mean
    gradients and the params at (a)'s tolerances.
"""
import os
import pickle
import shutil
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.optim.adamw import AdamW as JAdamW
from repro.parallel.collectives import compress_grads_int8 as jax_q8
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.registry import get_config, get_model
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_ranks.py")
LOSS_REL, GRAD_REL, PARAM_ABS = 1e-6, 1e-4, 1e-4
#: AdamW's grad_norm against JAX's (and the whole gradients'), relative
NORM_REL = 1e-6
MESHES = [(4, 1), (2, 2), (1, 4)]
WIDTHS = dict(dtype="float32", num_layers=2, d_model=256, num_heads=8,
              d_ff=512, head_dim=32)
JAX_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "mamba2-1.3b")
SELF_ARCHS = ("zamba2-1.2b", "whisper-base", "llava-next-mistral-7b")
AUX = 0.1
#: (f) yi-9b's step in 2 microbatches on (2, 2): each rank takes its
#: block of each of JAX's pieces
MICRO = 2


def _jax_cfg(arch):
    cfg = jax_config(arch).reduced(**WIDTHS)
    if cfg.moe:
        cfg = replace(cfg, moe=replace(cfg.moe, aux_loss_coef=AUX))
    return cfg


def _port_cfg(arch, reduced):
    cfg = get_config(arch).reduced(**reduced)
    if cfg.moe:
        cfg = replace(cfg, moe=replace(cfg.moe, aux_loss_coef=AUX))
    return cfg


def _modality_batch(cfg, rng, b=8, s=32) -> dict:
    """A global batch with the family's extra input (whisper's frames,
    llava's patches before s - P text tokens)."""
    if cfg.family == "vlm":
        p = cfg.vlm.num_patches
        toks = rng.integers(0, cfg.vocab_size, (b, s - p + 1))
        return {"patches": rng.standard_normal((b, p, cfg.d_model))
                .astype(np.float32), "tokens": toks[:, :-1].astype(np.int32),
                "labels": np.concatenate(
                    [np.zeros((b, p), np.int32),
                     toks[:, 1:].astype(np.int32)], 1)}
    batch = SyntheticLM(cfg.vocab_size, s, b, seed=0).batch_np(0)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _run_ranks(job, workdir, world=4, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, RANKS, job, str(workdir),
                             str(world)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), timeout


def _collect(proc_timeout, workdir, world):
    proc, timeout = proc_timeout
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    outs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _jax_reference(arch, jparams, batch, microbatch=0, grads=None):
    """JAX's unsharded jitted step: (loss, grads, new params, AdamW's
    grad_norm), the trees as the port's leaf lists (through the bridge).
    The gradients are the whole batch's (``grads``: already computed; with ``microbatch`` pieces
    of equal token counts the mean of theirs is the whole batch's)."""
    jcfg = _jax_cfg(arch)
    jmodel = jax_model(jcfg)
    opt = JAdamW()
    step, _ = jax_make_train_step(jcfg, opt, None, microbatch=microbatch)
    jb = jax.tree.map(jnp.asarray, batch)
    new, _, metrics = jax.jit(step)(jparams, opt.init(jparams), jb)
    cfg = _port_cfg(arch, WIDTHS)

    def as_port(tree):
        return [t.numpy() for t in leaves(params_from_numpy(
            jax.tree.map(np.asarray, tree), cfg, "cpu").params_tree())]
    if grads is None:
        _, jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
            jparams, jb)
        grads = as_port(jgrads)
    return (float(metrics["loss"]), grads, as_port(new),
            float(metrics["grad_norm"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results (rank 0's and every rank's), JAX's references,
    and the elastic runs on 2 ranks and on no mesh."""
    workdir = tmp_path_factory.mktemp("mesh_train")
    ck = tmp_path_factory.mktemp("mesh_ckpt")
    rng = np.random.default_rng(0)
    cases, jax_in = [], {}
    for arch in JAX_ARCHS:
        jcfg = _jax_cfg(arch)
        jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
        batch = SyntheticLM(jcfg.vocab_size, 32, 8, seed=0).batch_np(0)
        jax_in[arch] = (jparams, batch)
        cases.append({"name": arch, "arch": arch, "reduced": WIDTHS,
                      "aux_loss_coef": AUX if jcfg.moe else None,
                      "params": jax.tree.map(np.asarray, jparams),
                      "batch": batch, "meshes": MESHES, "self_ref": False,
                      "compress": False})
    for arch in SELF_ARCHS:
        cfg = get_config(arch).reduced(dtype="float32")
        model = get_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(3))
        cases.append({"name": arch, "arch": arch,
                      "reduced": {"dtype": "float32"}, "aux_loss_coef": None,
                      "params": params_to_numpy(model),
                      "batch": _modality_batch(cfg, rng), "meshes": [(2, 2)],
                      "self_ref": True, "compress": False})
    cases.append(dict(cases[0], name="compressed", meshes=[(2, 2)],
                      self_ref=True, compress=True))
    cases.append(dict(cases[0], name="microbatch", meshes=[(2, 2)],
                      microbatch=MICRO))
    dirs = {k: str(ck / k) for k in ("falls", "resume", "straight")}
    pipe = {"w": (rng.standard_normal((2, 16, 16)) * 0.3).astype(np.float32),
            "xs": rng.standard_normal((4, 3, 16)).astype(np.float32)}
    dryrun = [{"name": arch, "arch": arch, "reduced": WIDTHS, "mesh": m,
               "b": 8, "s": 32} for arch in JAX_ARCHS for m in MESHES]
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump({"meshes": MESHES, "cases": cases,
                     "trainer": {"dirs": dirs}, "pipeline": pipe,
                     "dryrun": dryrun}, f)
    proc = _run_ranks("mesh_train", workdir)
    refs = {arch: _jax_reference(arch, *jax_in[arch]) for arch in JAX_ARCHS}
    refs["microbatch"] = _jax_reference("yi-9b", *jax_in["yi-9b"],
                                        microbatch=MICRO,
                                        grads=refs["yi-9b"][1])
    outs = _collect(proc, workdir, 4)
    with open(os.path.join(workdir, "launcher.pkl"), "rb") as f:
        dryrun = pickle.load(f)

    # the elastic restores: 4 ranks wrote step 5; resume on 2 and on none
    def step5(dst):
        shutil.copytree(dirs["straight"], dst)
        shutil.rmtree(os.path.join(dst, "step_10"))
        return str(dst)
    two = tmp_path_factory.mktemp("elastic2")
    with open(two / "in.pkl", "wb") as f:
        pickle.dump({"dir": step5(two / "ck")}, f)
    proc = _run_ranks("elastic", two, world=2)
    none_dir = step5(ck / "elastic_none")
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = replace(get_config("luna-mlp"), dtype="float32")
    tcfg = TrainerConfig(total_steps=10, ckpt_every=5, log_every=5,
                         ckpt_dir=none_dir, lr=3e-3, warmup=2)
    _, hist_none = Trainer(cfg, tcfg, device="cpu").run(
        SyntheticLM(cfg.vocab_size, 32, 8, seed=0), install_signals=False)
    elastic2 = _collect(proc, two, 2)
    return {"outs": outs, "refs": refs, "cases": {c["name"]: c
                                                  for c in cases},
            "elastic2": elastic2, "elastic_none": hist_none, "pipe": pipe,
            "dryrun": dryrun}


def _norm_held(got, norm, what):
    """AdamW's grad_norm (the clip's input, the global norm over shards)
    within NORM_REL of the reference's, and of the float64 norm of the
    whole gradients the step handed AdamW: a leaf counted on more ranks
    than hold it, or a shard left out, moves it by far more."""
    assert abs(got["grad_norm"] - norm) <= NORM_REL * norm, \
        (what, got["grad_norm"], norm)
    whole = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                        for g in got["grads"]))
    assert abs(got["grad_norm"] - whole) <= NORM_REL * whole, \
        (what, got["grad_norm"], whole)


def _held(got, want, what):
    """Updated params: within PARAM_ABS of the reference's."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= PARAM_ABS, (what, i, err)


def _grads_held(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.astype(np.float64) - w).max() <= GRAD_REL * scale, \
            (what, i, np.abs(g - w).max() / scale)


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_mesh_step_matches_jax(ranks, arch, mesh):
    loss, grads, params, norm = ranks["refs"][arch]
    for out in ranks["outs"]:
        got = out["steps"][(arch, mesh)]
        assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss), \
            (got["loss"], loss)
        _norm_held(got, norm, arch)
        _grads_held(got["grads"], grads, arch)
        _held(got["params"], params, arch)
        assert got["issued"]["gather"] > 0 and got["issued"]["grad"] > 0
    # every rank holds only its shards: over the ranks each sharded
    # leaf's elements add up to the leaf's times its replicas
    shapes = [o["steps"][(arch, mesh)]["local_shapes"] for o in
              ranks["outs"]]
    full = [p.shape for p in params]
    held = sum(int(np.prod(s)) for r in shapes for s in r)
    assert held < 4 * sum(int(np.prod(s)) for s in full)
    ranks0 = ranks["outs"][0]["steps"][(arch, mesh)]
    for r in ranks["outs"][1:]:
        assert r["steps"][(arch, mesh)]["loss"] == ranks0["loss"]


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_collective_ledger_equals_the_gloo_traffic(ranks, arch, mesh):
    """The dry run's collective ledger of the same reduced step on the same
    mesh (rank 0, counted on meta tensors in a fake world,
    ``launch.dryrun.count_cell``) equals what each gloo rank's step issued
    (``act_sharding.counts``): the all-gathers are the leaves' gathers
    and the tensor-parallel gathers, the all-reduces the gradient sums,
    the row sums, AdamW's norm and the tensor-parallel reductions; in
    count and in payload bytes."""
    ledger = ranks["dryrun"][(arch, mesh)]["collectives"]
    for out in ranks["outs"]:
        got = out["steps"][(arch, mesh)]["issued"]
        gathers = ("gather", "tp_gather")
        assert ledger["all_gather"] == {
            "count": sum(got.get(k, 0) for k in gathers),
            "bytes": sum(got.get(f"{k}_bytes", 0) for k in gathers)}
        reduces = ("grad", "rows", "norm", "tp_reduce")
        assert ledger["all_reduce"] == {
            "count": sum(got.get(k, 0) for k in reduces),
            "bytes": sum(got.get(f"{k}_bytes", 0) for k in reduces)}
        assert got["norm"] == 1
        assert all(v == {"count": 0, "bytes": 0} for k, v in ledger.items()
                   if k not in ("all_gather", "all_reduce"))


def test_mesh_microbatch_step_matches_jax(ranks):
    loss, grads, params, norm = ranks["refs"]["microbatch"]
    assert loss != ranks["refs"]["yi-9b"][0]     # the last piece's loss
    for out in ranks["outs"]:
        got = out["steps"][("microbatch", (2, 2))]
        assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss)
        _norm_held(got, norm, "microbatch")
        _grads_held(got["grads"], grads, "microbatch")
        _held(got["params"], params, "microbatch")


@pytest.mark.parametrize("arch", SELF_ARCHS)
def test_mesh_step_matches_the_ports_own(ranks, arch):
    for out in ranks["outs"]:
        ref = out["steps"][(arch, None)]
        got = out["steps"][(arch, (2, 2))]
        assert abs(got["loss"] - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
        _norm_held(got, ref["grad_norm"], arch)
        _grads_held(got["grads"], ref["grads"], arch)
        _held(got["params"], ref["params"], arch)
        assert got["issued"]["gather"] > 0


def test_mesh_aux_loss_counts_once(ranks):
    """deepseek's load-balance means are the whole batch's: the (4, 1)
    step's loss carries JAX's aux term (a per-rank aux would move the
    loss by ~coef · E · (sum of products of rank means - global))."""
    loss = ranks["refs"]["deepseek-v2-lite-16b"][0]
    got = ranks["outs"][0]["steps"][("deepseek-v2-lite-16b", (4, 1))]
    assert got["issued"]["rows"] > 0
    assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss)


def test_grad_compression_uses_the_whole_leafs_scale(ranks):
    for out in ranks["outs"]:
        got = out["steps"][("compressed", (2, 2))]
        ref = out["steps"][("compressed", None)]
        want = [np.asarray(jax_q8(jnp.asarray(g))) for g in got["raw"]]
        for g, w in zip(got["grads"], want):
            np.testing.assert_array_equal(g, w)
        for g, r, graw, rraw in zip(got["grads"], ref["grads"], got["raw"],
                                    ref["raw"]):
            if np.abs(graw).max() == np.abs(rraw).max():
                same = graw == rraw
                np.testing.assert_array_equal(g[same], r[same])


def test_trainer_loss_decreases_on_a_mesh(ranks):
    hist = ranks["outs"][0]["trainer"]["falls"]["hist"]
    assert len(hist) == 30 and hist[-1] < hist[0] * 0.9, hist
    assert all(o["trainer"]["falls"]["hist"] == hist for o in ranks["outs"])
    assert "[trainer] step 0" in ranks["outs"][0]["trainer"]["falls"][
        "stdout"]
    assert ranks["outs"][1]["trainer"]["falls"]["stdout"] == ""


def test_trainer_restart_resumes_on_a_mesh(ranks):
    t = ranks["outs"][0]["trainer"]
    assert len(t["first"]["hist"]) == 12
    assert "resumed from step 12" in t["resumed"]["stdout"]
    assert len(t["resumed"]["hist"]) == 8


def test_elastic_restore_onto_two_ranks(ranks):
    straight = ranks["outs"][0]["trainer"]["straight"]["hist"]
    assert len(straight) == 10
    for out in ranks["elastic2"]:
        assert out["world"] == 2
        assert len(out["hist"]) == 5
        np.testing.assert_allclose(out["hist"], straight[5:], rtol=1e-6)
    assert "resumed from step 5" in ranks["elastic2"][0]["stdout"]
    assert ranks["elastic2"][1]["stdout"] == ""


def test_elastic_restore_onto_no_mesh(ranks):
    straight = ranks["outs"][0]["trainer"]["straight"]["hist"]
    hist = ranks["elastic_none"]
    assert len(hist) == 5
    np.testing.assert_allclose(hist, straight[5:], rtol=1e-6)


def test_pipeline_matches_sequential(ranks):
    w, xs = ranks["pipe"]["w"], ranks["pipe"]["xs"]
    want = np.stack([np.tanh(np.tanh(x @ w[0]) @ w[1]) for x in xs])
    for out in ranks["outs"]:
        np.testing.assert_allclose(out["pipeline"], want, rtol=1e-5,
                                   atol=1e-5)


def test_mesh_step_error_maxima(ranks):
    """The worst errors of (a) over meshes and ranks, printed (``pytest
    -s -k maxima``) and held to the stated tolerances."""
    for arch in JAX_ARCHS:
        loss, grads, params, norm = ranks["refs"][arch]
        lr = ge = pe = ne = 0.0
        for out in ranks["outs"]:
            for mesh in MESHES:
                got = out["steps"][(arch, mesh)]
                lr = max(lr, abs(got["loss"] - loss) / abs(loss))
                ne = max(ne, abs(got["grad_norm"] - norm) / norm)
                ge = max(ge, max(
                    np.abs(g.astype(np.float64) - w).max()
                    / max(np.abs(w).max(), 1e-30)
                    for g, w in zip(got["grads"], grads)))
                pe = max(pe, max(np.abs(p.astype(np.float64) - w).max()
                                 for p, w in zip(got["params"], params)))
        print(f"MAXIMA {arch}: loss {lr:.3g} relative, grad_norm {ne:.3g} "
              f"relative, gradients {ge:.3g} of the leaf's scale, params "
              f"{pe:.3g} absolute")
        assert lr <= LOSS_REL and ne <= NORM_REL
        assert ge <= GRAD_REL and pe <= PARAM_ABS
    straight = ranks["outs"][0]["trainer"]["straight"]["hist"][5:]
    for where, hist in (("2 ranks", ranks["elastic2"][0]["hist"]),
                        ("no mesh", ranks["elastic_none"])):
        err = max(abs(a - b) / abs(b) for a, b in zip(hist, straight))
        print(f"MAXIMA elastic onto {where}: losses {err:.3g} relative")
        assert err <= 1e-6
