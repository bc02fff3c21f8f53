"""The moe family split over ``model`` (expert parallelism for the routed
experts, the shared experts' and MLA's Megatron splits: ``parallel.
tensor_parallel.mla_plan``/``moe_plan``, ``models.moe``'s and
``MLAAttention``'s split forwards, ``fsdp``'s ``WHOLE`` ``w_dkv``), and
the ``luna_*`` modes' calibration over a mesh step's rows, against the
JAX package on 4 gloo ranks (``tests/torch_ranks.py``'s
``tensor_parallel_moe`` job, one spawn) and one (the same job on a
one-rank world); JAX's references run in this process meanwhile.

Reduced f32 deepseek-v2-lite-16b (2 layers: ``first_dense`` 1, then one
MoE block; d_model 128, 4 heads, MLA rank 32; 8 experts, top-2, 2 shared
of 64; aux loss coefficient 0.1) on (1, 4) and (2, 2): a rank runs 1 or
2 heads and 2 or 4 experts.

(a) The mesh step under ``bf16`` (f32 math) and ``lut_nf4`` against JAX's
    unsharded jitted step on the bridged weights, at
    ``test_torch_tensor_parallel``'s tolerances: the loss and AdamW's
    ``grad_norm`` within 1e-6 relative, every gradient within 1e-4 of its
    leaf's max |jax| (the router's and ``w_dkv``'s held on their own:
    every rank routes alike and must hold the router's whole gradient; a
    rank's heads back-propagate only their share into ``w_dkv``), the
    updated params within 1e-4.
(b) The mutation that takes Megatron's copy at the MoE block's entry
    (``torch_ranks.megatron_moe_ffn``: the routing reads the copied
    hidden, the gates enter uncopied) fails the router-gradient check:
    each rank then holds only its experts' part of the router's gradient.
    ``test_mutation_fails_the_router_check`` prints by how much.
(c) Each rank holds only its shards and computes on them: its ``E/m``
    experts' stacks, its heads' columns of ``wq``/``w_uk``/``w_uv`` and
    rows of ``wo``, its block of the shared experts; ``w_dkv`` whole.
(d) The lut4 and nf4 ``decode_step`` of the split serving model
    (``serve_param_sharding="tp"``, ``decode_attn="sharded"``; a
    full-precision split prefill first) against JAX's unsharded decode:
    logits within 1e-5 of the max |logit|, greedy tokens equal over 8
    steps; the frozen leaves are the plan's blocks.
(e) The data-split decode at 16 rows on (2, 2) (lut4; 4 prompts served
    4 times each, whose copies route alike): JAX's one routing group is
    the global batch (capacity 8 of 16 tokens), and capacity binds
    (dropped picks counted); with the rows split declared the port
    gathers the gates over ``data`` and meets JAX's decode as (d); the
    control without it (each rank's 8 rows its own group, capacity 4)
    does not.
(f) ``luna_dc`` and ``luna_approx`` mesh steps of reduced f32 yi-9b
    (``test_torch_tensor_parallel``'s widths) on (2, 2) and (4, 1): the
    activation scale spans the step's rows (and the K a row-parallel
    split cuts), so the step meets the port's no-mesh step at (a)'s
    tolerances, and JAX's unsharded step no further than that no-mesh
    step does (within (a)'s tolerances; the no-mesh step itself is off
    JAX's where a last-place activation difference moves a code).  The
    control calibrating over each rank's rows only (on (4, 1): the step
    before the repair) fails both; the test prints by how much.
(g) On a one-rank mesh the split step is the no-mesh step bitwise (bf16,
    lut_nf4, luna_dc), and the split decode emits the whole-weight
    layout's logits bitwise and the no-mesh decode's tokens.
"""
import os
import pickle
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.layers import QuantConfig as JQuantConfig
from repro.core.quant import quantize_decode_params
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.optim.adamw import AdamW as JAdamW
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.registry import get_config
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_ranks.py")
LOSS_REL, NORM_REL, GRAD_REL, PARAM_ABS = 1e-6, 1e-6, 1e-4, 1e-4
DECODE_REL = 1e-5
ARCH = "deepseek-v2-lite-16b"
REDUCED = dict(dtype="float32")
AUX = 0.1
MESHES = [(1, 4), (2, 2)]
MODES = ("bf16", "lut_nf4")
QUANTS = ("lut4", "nf4")
STEPS = 8
#: (e): the data-split decode's rows and mesh
WIDE, WIDE_MESH = 16, (2, 2)
#: (f): yi-9b at test_torch_tensor_parallel's widths
LUNA_WIDTHS = dict(dtype="float32", num_layers=2, d_model=256, num_heads=8,
                   d_ff=512, head_dim=32)
LUNA_MODES = ("luna_dc", "luna_approx")
LUNA_MESHES = [(2, 2), (4, 1)]
#: (f)'s control runs where the model axis is one rank: there the step
#: before the repair computed exactly the control's
LUNA_CONTROL = (4, 1)

#: reduced deepseek: D, heads, MLA rank, nope/rope/v dims, experts,
#: d_expert, shared width, dense d_ff, vocabulary
D, H, R, NOPE, ROPE, VD, E, FE, SF, DFF, V = (128, 4, 32, 16, 16, 16, 8,
                                             64, 128, 256, 512)


def _jcfg(mode="bf16"):
    cfg = jax_config(ARCH).reduced(**REDUCED, quant=JQuantConfig(mode=mode))
    return replace(cfg, moe=replace(cfg.moe, aux_loss_coef=AUX))


def _ycfg(mode):
    return jax_config("yi-9b").reduced(**LUNA_WIDTHS,
                                       quant=JQuantConfig(mode=mode))


def _as_port(tree, arch, reduced):
    cfg = get_config(arch).reduced(**reduced)
    return [t.numpy() for t in leaves(params_from_numpy(
        jax.tree.map(np.asarray, tree), cfg, "cpu").params_tree())]


def _jax_step(jcfg, jparams, batch, arch, reduced):
    """(loss, gradients, new params, grad_norm) of JAX's unsharded jitted
    step, the trees as the port's leaf lists."""
    jmodel = jax_model(jcfg)
    opt = JAdamW()
    step, _ = jax_make_train_step(jcfg, opt, None)
    jb = jax.tree.map(jnp.asarray, batch)
    new, _, metrics = jax.jit(step)(jparams, opt.init(jparams), jb)
    _, grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jb)
    return (float(metrics["loss"]), _as_port(grads, arch, reduced),
            _as_port(new, arch, reduced), float(metrics["grad_norm"]))


def _jax_decode(jparams, quant, prompt):
    """JAX's unsharded greedy decode: the prompt's full-precision prefill,
    then ``STEPS`` decode steps on the frozen ``quant`` tree."""
    jmodel = jax_model(_jcfg())
    jdec = quantize_decode_params(jparams, quant)
    b, p = prompt.shape
    cache = jmodel.init_cache(b, p + STEPS)
    lg, cache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt), cache)
    dec = jax.jit(jmodel.decode_step)
    seq, toks = [], []
    for i in range(STEPS):
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
        lg, cache = dec(jdec, tok, cache, jnp.int32(p + i))
        seq.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(seq), np.stack(toks, 1)


def _spawn(workdir, job, world):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(os.path.join(workdir, "in.pkl"), "wb") as f:
        pickle.dump(job, f)
    return subprocess.Popen([sys.executable, RANKS, "tensor_parallel_moe",
                             str(workdir), str(world)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _collect(proc, workdir, world):
    _, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-4000:]
    outs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jparams = jax_model(_jcfg()).init(jax.random.PRNGKey(0))
    batch = SyntheticLM(V, 32, 8, seed=0).batch_np(0)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, V, (4, 8))
    # 4 prompts, each served 4 times: the copies route alike, so picks
    # come 4 to an expert, and data rank 0 holds 2 prompts, rank 1 the
    # other 2
    wide = np.repeat(rng.integers(0, V, (4, 8)), WIDE // 4, axis=0)
    yparams = jax_model(_ycfg("bf16")).init(jax.random.PRNGKey(0))
    ybatch = SyntheticLM(512, 32, 8, seed=0).batch_np(0)
    luna = {"reduced": LUNA_WIDTHS, "modes": LUNA_MODES,
            "meshes": LUNA_MESHES, "params": jax.tree.map(np.asarray,
                                                           yparams),
            "batch": ybatch, "control": [LUNA_CONTROL]}
    job = {"arch": ARCH, "reduced": REDUCED, "aux_loss_coef": AUX,
           "params": jax.tree.map(np.asarray, jparams), "batch": batch,
           "modes": MODES, "meshes": MESHES, "mutation_meshes": MESHES,
           "decode_quants": QUANTS, "prompt": prompt, "steps": STEPS,
           "wide": {"prompt": wide, "mesh": WIDE_MESH, "quant": "lut4"},
           "luna": luna, "self_ref": False}
    four, one = (tmp_path_factory.mktemp(n) for n in ("moe4", "moe1"))
    procs = [_spawn(four, job, 4),
             _spawn(one, dict(job, meshes=[(1, 1)], mutation_meshes=[],
                              wide=None, self_ref=True,
                              luna=dict(luna, modes=LUNA_MODES[:1],
                                        meshes=[(1, 1)], control=[])),
                    1)]
    refs = {mode: _jax_step(_jcfg(mode), jparams, batch, ARCH, REDUCED)
            for mode in MODES}
    decode = {q: _jax_decode(jparams, q, prompt) for q in QUANTS}
    decode["wide"] = _jax_decode(jparams, "lut4", wide)
    luna_refs = {mode: _jax_step(_ycfg(mode), yparams, ybatch, "yi-9b",
                                 LUNA_WIDTHS) for mode in LUNA_MODES}
    outs = _collect(procs[0], four, 4)
    one = _collect(procs[1], one, 1)[0]
    return {"outs": outs, "one": one, "refs": refs, "decode": decode,
            "luna": luna_refs}


def _rel(got, want):
    return abs(got - want) / abs(want)


def _grad_err(g, w):
    return np.abs(g.astype(np.float64) - w).max() / max(np.abs(w).max(),
                                                        1e-30)


def _held(got, ref, paths, what):
    """(a)'s tolerances; the router's and w_dkv's gradients named."""
    loss, grads, params, norm = ref
    assert _rel(got["loss"], loss) <= LOSS_REL, (what, got["loss"], loss)
    assert _rel(got["grad_norm"], norm) <= NORM_REL, \
        (what, got["grad_norm"], norm)
    whole = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                        for g in got["grads"]))
    assert _rel(got["grad_norm"], whole) <= NORM_REL, what
    for path, g, w in zip(paths, got["grads"], grads):
        assert _grad_err(g, w) <= GRAD_REL, (what, path, _grad_err(g, w))
    for path, p, w in zip(paths, got["params"], params):
        assert np.abs(p.astype(np.float64) - w).max() <= PARAM_ABS, \
            (what, path)


def _named(paths, suffix):
    return [i for i, p in enumerate(paths) if p.endswith(suffix)]


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
@pytest.mark.parametrize("mode", MODES)
def test_split_step_matches_jax(ranks, mode, mesh):
    for out in ranks["outs"]:
        got = out["steps"][(mode, mesh)]
        _held(got, ranks["refs"][mode], out["paths"], (mode, mesh))
        assert got["issued"]["tp_reduce"] > 0


@pytest.mark.parametrize("leaf", ["moe/router", "attn/w_dkv"])
@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
def test_router_and_w_dkv_gradients(ranks, mesh, leaf):
    """The router's gradient is whole on every rank (its routing path is
    never all-reduced over ``model``; the gates' copy gives each rank the
    other experts' part), and ``w_dkv``'s is the sum of every rank's
    heads' share (``fsdp``'s ``WHOLE``)."""
    for mode in MODES:
        ref = ranks["refs"][mode][1]
        for out in ranks["outs"]:
            idx = _named(out["paths"], leaf)
            assert idx, leaf
            for i in idx:
                got = out["steps"][(mode, mesh)]["grads"][i]
                assert _grad_err(got, ref[i]) <= GRAD_REL, \
                    (mode, leaf, _grad_err(got, ref[i]))
                assert np.abs(ref[i]).max() > 0


def test_mutation_fails_the_router_check(ranks):
    """Megatron's copy at the MoE block's entry: each rank's router
    gradient is then only its experts' part (and the aux loss's path
    counted once a rank), off JAX's by far more than ``GRAD_REL``."""
    _, grads, _, _ = ranks["refs"]["bf16"]
    worst = {}
    for mesh in MESHES:
        for out in ranks["outs"]:
            i = _named(out["paths"], "moe/router")[0]
            got = out["steps"][("mutation", mesh)]["grads"][i]
            worst[mesh] = max(worst.get(mesh, 0.0), _grad_err(got, grads[i]))
    print(f"MUTATION router gradient off JAX's by {worst} of its scale "
          f"(tolerance {GRAD_REL})")
    assert all(err > 100 * GRAD_REL for err in worst.values()), worst


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
def test_ranks_hold_and_compute_their_shards(ranks, mesh):
    """A rank's projections: layer 0's MLA (wq H/m heads' columns, w_dkv
    whole, wo's rows) and dense MLP (d_ff/m), layer 1's MLA and shared
    experts (their width/m); the routed products on E/m experts; the
    local leaves of the MoE block are the specs' blocks."""
    data, m = mesh
    hq = H // m
    mla = [(D, (D, hq * (NOPE + ROPE))), (D, (D, R + ROPE)),
           (hq * VD, (hq * VD, D))]
    want = (mla + [(D, (D, DFF // m)), (D, (D, DFF // m)),
                   (DFF // m, (DFF // m, D))]
            + mla + [(D, (D, SF // m)), (D, (D, SF // m)),
                     (SF // m, (SF // m, D))])
    for out in ranks["outs"]:
        got = out["steps"][("bf16", mesh)]
        assert [(x, tuple(w)) for x, w in got["projections"]] == want
        assert got["stacks"] == [(E // m, D, FE)]
        shapes = dict(zip(out["paths"], got["local_shapes"]))
        assert shapes["blocks/0/moe/w_gate"] == (E // m, D // data, FE)
        assert shapes["blocks/0/moe/w_down"] == (E // m, FE, D // data)
        assert shapes["blocks/0/moe/router"] == (D // data, E)
        assert shapes["blocks/0/attn/w_uk"] == (R, H * NOPE // m)
        assert shapes["blocks/0/attn/w_uv"] == (R, H * VD // m)
        assert shapes["blocks/0/attn/w_dkv"] == (D // data, R + ROPE)
        assert shapes["blocks/0/moe/shared/w_down"] == (SF // m, D // data)


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
@pytest.mark.parametrize("quant", QUANTS)
def test_split_decode_matches_jax(ranks, quant, mesh):
    logits, toks = ranks["decode"][quant]
    scale = np.abs(logits).max()
    m = mesh[1]
    for out in ranks["outs"]:
        got = out["decode"][(quant, mesh)]
        rows = got["rows"]
        err = np.abs(got["logits"] - logits[:, rows]).max()
        assert err <= DECODE_REL * scale, (err, scale)
        np.testing.assert_array_equal(got["tokens"], toks[rows])
        assert got["split"] == {"attention": "split", "mlp": "split",
                                "experts": "split", "vocab": "split"}
        frozen = [s for s in got["frozen_shapes"] if isinstance(s, dict)]
        # layer 0: w_dkv (whole), wo, wq, the MLP's w_up, w_down, w_gate;
        # layer 1: w_dkv, wo, wq, the shared w_gate, w_up, w_down (the
        # codes' shapes, in the tree's order)
        mla = [(D, R + ROPE), (H * VD // m, D), (D, H * (NOPE + ROPE) // m)]
        assert [f["codes"] for f in frozen] == mla + [
            (D, DFF // m), (DFF // m, D), (D, DFF // m)] + mla + [
            (D, SF // m), (D, SF // m), (SF // m, D)]
        for f in frozen:
            assert f["scale"] == f["zero_point"] == f["codes"][-1:]
            assert f["hi_tab"] == f["lo_tab"] == (4,)


def test_data_split_decode_where_capacity_binds(ranks):
    """16 rows on (2, 2): capacity binds (picks dropped in JAX's global
    group, as in the port's gathered choice), the split decode meets
    JAX's; the control that routes each rank's rows as their own group
    does not."""
    logits, toks = ranks["decode"]["wide"]
    scale = np.abs(logits).max()
    ctl = 0.0
    for out in ranks["outs"]:
        got = out["decode"][("wide", True)]
        rows = got["rows"]
        assert len(rows) == WIDE // 2
        err = np.abs(got["logits"] - logits[:, rows]).max()
        assert err <= DECODE_REL * scale, (err, scale)
        np.testing.assert_array_equal(got["tokens"], toks[rows])
        control = out["decode"][("wide", False)]
        ctl = max(ctl, np.abs(control["logits"] - logits[:, rows]).max())
    drops = [sum(ranks["outs"][r]["decode"][("wide", True)]["drops"][i]
                 for r in (0, 2)) for i in range(STEPS)]
    print(f"WIDE dropped picks a step {drops}; the control's logits off "
          f"JAX's by {ctl / scale:.3g} of their scale")
    assert sum(drops) > 0 and ctl > 100 * DECODE_REL * scale


def _maxima(got, ref) -> tuple:
    """(loss relative, worst gradient of its leaf's scale, worst param
    absolute) of a step against a reference (loss, grads, params,
    grad_norm)."""
    loss, grads, params, _ = ref
    return (_rel(got["loss"], loss),
            max(_grad_err(g, w) for g, w in zip(got["grads"], grads)),
            max(np.abs(p.astype(np.float64) - w).max()
                for p, w in zip(got["params"], params)))


def _own(out, mode):
    ref = out["luna"][(mode, None)]
    return ref["loss"], ref["grads"], ref["params"], ref["grad_norm"]


@pytest.mark.parametrize("mesh", LUNA_MESHES, ids=["x".join(map(str, m))
                                                    for m in LUNA_MESHES])
@pytest.mark.parametrize("mode", LUNA_MODES)
def test_luna_step_matches_the_ports_own(ranks, mode, mesh):
    """The luna mesh step against the port's no-mesh step on the same
    rank, at (a)'s tolerances: every projection's codes are the
    unsharded step's."""
    paths = [str(i) for i in range(len(ranks["luna"][mode][1]))]
    for out in ranks["outs"]:
        got = out["luna"][(mode, mesh)]
        _held(got, _own(out, mode), paths, (mode, mesh))
        assert got["issued"]["rows"] > 0


@pytest.mark.parametrize("mesh", LUNA_MESHES, ids=["x".join(map(str, m))
                                                    for m in LUNA_MESHES])
@pytest.mark.parametrize("mode", LUNA_MODES)
def test_luna_step_matches_jax(ranks, mode, mesh):
    """The luna mesh step against JAX's unsharded step: no further from it
    than the port's no-mesh step is, within (a)'s tolerances (a luna
    projection re-quantizes its input, so a last-place difference in an
    activation between the packages can move a code: the no-mesh step
    here is 1.8e-5 (loss) and 1.9e-2 (luna_dc's worst gradient, of its
    leaf's scale) from JAX's, and the mesh adds nothing to that)."""
    ref = ranks["luna"][mode]
    for out in ranks["outs"]:
        lo, ge, pe = _maxima(out["luna"][(mode, mesh)], ref)
        own = _maxima(out["luna"][(mode, None)], ref)
        print(f"LUNA {mode} {mesh}: against JAX loss {lo:.3g}, gradients "
              f"{ge:.3g}, params {pe:.3g}; the no-mesh step's "
              f"{own[0]:.3g}, {own[1]:.3g}, {own[2]:.3g}")
        assert lo <= own[0] + LOSS_REL and ge <= own[1] + GRAD_REL \
            and pe <= own[2] + PARAM_ABS, (lo, ge, pe, own)


@pytest.mark.parametrize("mode", LUNA_MODES)
def test_luna_rank_rows_control_fails(ranks, mode):
    """The activation scale over each rank's rows only (the calibration
    the port had before it spanned the step's rows; on (4, 1), whose
    model axis is one rank, exactly its step): off the port's no-mesh
    step past (a)'s tolerances, and off JAX's by more than the no-mesh
    step is."""
    own = jax_ = (0.0, 0.0, 0.0)
    for out in ranks["outs"]:
        got = out["luna"][(mode, LUNA_CONTROL, "rank rows")]
        own = np.maximum(own, _maxima(got, _own(out, mode)))
        jax_ = np.maximum(jax_, _maxima(got, ranks["luna"][mode]))
    print(f"CONTROL {mode} {LUNA_CONTROL}: (loss, gradients, params) off "
          f"the no-mesh step {tuple(own)}, off JAX's {tuple(jax_)}")
    base = _maxima(ranks["outs"][0]["luna"][(mode, None)], ranks["luna"][mode])
    assert own[0] > LOSS_REL or own[1] > GRAD_REL
    assert jax_[0] > base[0] + LOSS_REL or jax_[1] > base[1] + GRAD_REL


@pytest.mark.parametrize("mode", MODES)
def test_one_rank_split_step_is_the_no_mesh_step(ranks, mode):
    ref = ranks["one"]["steps"][(mode, None)]
    got = ranks["one"]["steps"][(mode, (1, 1))]
    assert got["loss"] == ref["loss"]
    assert got["grad_norm"] == ref["grad_norm"]
    for a, b in zip(got["grads"] + got["params"],
                    ref["grads"] + ref["params"]):
        np.testing.assert_array_equal(a, b)
    assert got["issued"]["tp_reduce"] > 0


def test_one_rank_luna_step_is_the_no_mesh_step(ranks):
    ref = ranks["one"]["luna"][(LUNA_MODES[0], None)]
    got = ranks["one"]["luna"][(LUNA_MODES[0], (1, 1))]
    assert got["loss"] == ref["loss"]
    for a, b in zip(got["grads"] + got["params"],
                    ref["grads"] + ref["params"]):
        np.testing.assert_array_equal(a, b)
    assert got["issued"]["tp_reduce"] > 0


@pytest.mark.parametrize("quant", QUANTS)
def test_one_rank_split_decode_is_the_whole_weight_decode(ranks, quant):
    one = ranks["one"]["decode"]
    got, ref = one[(quant, (1, 1))], one[(quant, (1, 1), "whole")]
    np.testing.assert_array_equal(got["logits"], ref["logits"])
    np.testing.assert_array_equal(got["tokens"], one[(quant, None)]["tokens"])
    assert set(got["split"].values()) == {"split"}
    assert set(ref["split"].values()) == {"replicated"}
