"""Tensor-parallel compute over ``model`` (``parallel.tensor_parallel``,
the split paths of ``models.attention``/``mlp``/``transformer``,
``fsdp``'s leaf modes, the split calibrations of ``core.layers``,
``QuantizedWeight.shard``) against the JAX package, on 4 gloo ranks
(``tests/torch_ranks.py``'s ``tensor_parallel`` job, one spawn) and one
(the same job on a one-rank world); JAX's references run in this process
meanwhile.

Reduced f32 yi-9b at ``test_torch_mesh_train``'s widths (2 layers, d_model
256, 8 heads on 2 KV heads of 32, d_ff 512, vocabulary 512): on (1, 4)
the KV heads do not divide the axis (JAX's spec cuts ``wk``/``wv``
mid-head, so the ranks project them from the whole leaves), on (2, 2) they
do.

(a) The mesh step under ``bf16`` (f32 math) and ``lut_nf4`` against JAX's
    unsharded jitted step on the bridged weights: the loss and AdamW's
    ``grad_norm`` within ``LOSS_REL`` / ``NORM_REL`` (1e-6) relative,
    every gradient within ``GRAD_REL`` (1e-4) of its leaf's max |jax|,
    the updated params within ``PARAM_ABS`` (1e-4).
(b) Each rank holds only its shards (the local leaves' shapes) and
    computes only them: the projections' input widths and weight shapes
    at the attention and MLP boundaries (heads H/m, hidden d_ff/m).
(c) ``lut_nf4``: the codes each rank encodes are, bitwise, the matching
    block of the codes JAX's ``_nf4_matmul`` computes from the whole
    weight (the row-parallel ``wo``/``w_down`` through the all-reduced
    absmax).
(d) The lut4 and nf4 ``decode_step`` of the split serving model
    (``serve_param_sharding="tp"``, ``decode_attn="sharded"``; a
    full-precision split prefill first): logits within ``DECODE_REL``
    (1e-5) of the max |logit| of JAX's unsharded decode step, greedy
    tokens equal over ``STEPS`` (8) steps; each rank holds only its
    shard of the frozen codes, scales and zero points, and the whole
    tables.
(e) The dry run's collective ledger of the same steps equals what each
    rank issued, TP collectives included.  ``int8`` on both meshes against
    the port's own no-mesh step at (a)'s tolerances: its per-tensor
    activation scale is the global batch's, over the rows split over
    ``data`` and the K split over ``model``.
(f) On a one-rank mesh the split step is the no-mesh step bitwise (loss,
    gradients, params) under bf16, lut_nf4 and int8, and the split decode
    emits the whole-weight decode's logits on the same mesh bitwise.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.layers import QuantConfig as JQuantConfig
from repro.core.lut import NF4_CODEBOOK
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
WIDTHS = dict(dtype="float32", num_layers=2, d_model=256, num_heads=8,
              d_ff=512, head_dim=32)
MESHES = [(1, 4), (2, 2)]
MODES = ("bf16", "lut_nf4")
QUANTS = ("lut4", "nf4")
STEPS = 8
#: the one-rank job's modes (int8 besides: its per-tensor activation
#: scale runs through the same helper over the rows and the model axis)
ONE_MODES = ("bf16", "lut_nf4", "int8")
#: held on 4 ranks to the port's own no-mesh step: int8's activation
#: scale spans the rows split over data and the K split over model
SELF_MODES = ("int8",)


def _jcfg(mode="bf16"):
    return jax_config("yi-9b").reduced(**WIDTHS,
                                       quant=JQuantConfig(mode=mode))


def _as_port(tree):
    cfg = get_config("yi-9b").reduced(**WIDTHS)
    return [t.numpy() for t in leaves(params_from_numpy(
        jax.tree.map(np.asarray, tree), cfg, "cpu").params_tree())]


def _jax_step(mode, jparams, batch):
    """(loss, gradients, new params, grad_norm) of JAX's unsharded jitted
    step, the trees as the port's leaf lists."""
    jcfg = _jcfg(mode)
    jmodel = jax_model(jcfg)
    opt = JAdamW()
    step, _ = jax_make_train_step(jcfg, opt, None)
    jb = jax.tree.map(jnp.asarray, batch)
    new, _, metrics = jax.jit(step)(jparams, opt.init(jparams), jb)
    _, grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jb)
    return (float(metrics["loss"]), _as_port(grads), _as_port(new),
            float(metrics["grad_norm"]))


def _jax_codes(jparams):
    """{(layer, name): (K, N) int codes} of JAX's ``_nf4_matmul`` on each
    whole projection weight (its absmax, normalise, first-nearest
    codebook entry)."""
    cb = jnp.asarray(NF4_CODEBOOK)
    out = {}
    for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                        ("mlp", ("w_gate", "w_up", "w_down"))):
        for name in names:
            stack = jparams["blocks"][part][name]
            for i in range(stack.shape[0]):
                w = stack[i]
                absmax = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-8)
                out[i, name] = np.asarray(jnp.argmin(
                    jnp.abs((w / absmax)[..., None] - cb), axis=-1))
    return out


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
    return subprocess.Popen([sys.executable, RANKS, "tensor_parallel",
                             str(workdir), str(world)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _collect(proc, workdir, world):
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    outs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    with open(os.path.join(workdir, "launcher.pkl"), "rb") as f:
        return outs, pickle.load(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jparams = jax_model(_jcfg()).init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jparams)
    batch = SyntheticLM(512, 32, 8, seed=0).batch_np(0)
    prompt = np.random.default_rng(3).integers(0, 512, (4, 8))
    job = {"arch": "yi-9b", "reduced": WIDTHS, "params": params,
           "batch": batch, "modes": MODES, "meshes": MESHES,
           "decode_quants": QUANTS, "prompt": prompt, "steps": STEPS,
           "self_ref": False, "self_modes": SELF_MODES}
    four, one = (tmp_path_factory.mktemp(n) for n in ("tp4", "tp1"))
    procs = [_spawn(four, job, 4),
             _spawn(one, dict(job, modes=ONE_MODES, meshes=[(1, 1)],
                              self_ref=True, self_modes=()), 1)]
    refs = {mode: _jax_step(mode, jparams, batch) for mode in MODES}
    decode = {q: _jax_decode(jparams, q, prompt) for q in QUANTS}
    codes = _jax_codes(jparams)
    outs, ledger = _collect(procs[0], four, 4)
    one_out, _ = _collect(procs[1], one, 1)
    return {"outs": outs, "ledger": ledger, "one": one_out[0],
            "refs": refs, "decode": decode, "codes": codes,
            "whole": [p.shape for p in _as_port(jparams)]}


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
@pytest.mark.parametrize("mode", MODES)
def test_split_step_matches_jax(ranks, mode, mesh):
    loss, grads, params, norm = ranks["refs"][mode]
    for out in ranks["outs"]:
        got = out["steps"][(mode, mesh)]
        assert _rel(got["loss"], loss) <= LOSS_REL, (got["loss"], loss)
        assert _rel(got["grad_norm"], norm) <= NORM_REL, \
            (got["grad_norm"], norm)
        whole = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                            for g in got["grads"]))
        assert _rel(got["grad_norm"], whole) <= NORM_REL
        for i, (g, w) in enumerate(zip(got["grads"], grads)):
            err = np.abs(g.astype(np.float64) - w).max()
            assert err <= GRAD_REL * max(np.abs(w).max(), 1e-30), (i, err)
        for i, (p, w) in enumerate(zip(got["params"], params)):
            assert np.abs(p.astype(np.float64) - w).max() <= PARAM_ABS, i
        assert got["issued"]["tp_reduce"] > 0


#: reduced widths: D, H, Hkv, dh, d_ff, V
D, H, HKV, DH, FF, V = 256, 8, 2, 32, 512, 512


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
def test_ranks_hold_and_compute_their_shards(ranks, mesh):
    """The local leaves are the specs' blocks, and each projection runs
    on the rank's heads and hidden columns: wq (D, H/m·dh), wo's input
    H/m·dh wide, w_gate/w_up (D, d_ff/m), w_down's input d_ff/m wide; K/V
    from their column shards on (2, 2), from the whole leaves'
    columns of the one KV head a rank's query heads read on (1, 4)."""
    data, m = mesh
    hq = H // m
    kv_cols = (HKV // m if HKV % m == 0 else 1) * DH
    want = [(D, (D, hq * DH)), (D, (D, kv_cols)), (D, (D, kv_cols)),
            (hq * DH, (hq * DH, D)), (D, (D, FF // m)), (D, (D, FF // m)),
            (FF // m, (FF // m, D))] * 2
    for out in ranks["outs"]:
        got = out["steps"][("bf16", mesh)]
        assert [(x, tuple(w)) for x, w in got["projections"]] == want
        shapes = dict(zip(("embed", "ln_f", "lm_head"),
                          got["local_shapes"][:3]))
        assert shapes["embed"] == (V // m, D // data)
        assert shapes["lm_head"] == (D // data, V // m)
    held = sum(int(np.prod(s)) for o in ranks["outs"]
               for s in o["steps"][("bf16", mesh)]["local_shapes"])
    whole = sum(int(np.prod(s)) for s in ranks["whole"])
    # every leaf is split 4 ways but the norms (replicated)
    norms = (2 * 2 + 1) * D
    assert held == whole - norms + 4 * norms


def _block(codes, name, mesh, coords):
    """The rank's block of a whole weight's codes, by its split."""
    m, r = mesh[1], coords["model"]
    k, n = codes.shape
    if name in ("wo", "w_down"):
        return codes[r * k // m:(r + 1) * k // m]
    if name in ("wk", "wv") and HKV % m:
        g, hq = H // HKV, H // m
        lo, hi = r * hq // g, ((r + 1) * hq - 1) // g + 1
        return codes[:, lo * DH:hi * DH]
    return codes[:, r * n // m:(r + 1) * n // m]


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
def test_nf4_codes_are_blocks_of_the_whole(ranks, mesh):
    order = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
    for out in ranks["outs"]:
        got = out["steps"][("lut_nf4", mesh)]["codes"]
        assert len(got) == 2 * len(order)
        for j, codes in enumerate(got):
            layer, name = divmod(j, len(order))
            want = _block(ranks["codes"][layer, order[name]], order[name],
                          mesh, out["coords"][mesh])
            np.testing.assert_array_equal(codes, want,
                                          err_msg=f"{layer} {order[name]}")


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
                                "vocab": "split"}
        shapes = got["frozen_shapes"]
        embed = shapes[0]
        wq = next(s for s in shapes if isinstance(s, dict))["codes"]
        assert embed == (V // m, D) and wq == (D, H * DH // m)
        for leaf in shapes:
            if isinstance(leaf, dict):
                k, n = leaf["codes"]
                assert leaf["scale"] == leaf["zero_point"] == (n,)
                assert leaf["hi_tab"] == leaf["lo_tab"] == (4,)
                assert n * k in (D * H * DH // m, D * HKV * DH // m,
                                 D * FF // m)


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
@pytest.mark.parametrize("mode", MODES)
def test_ledger_equals_the_ranks_traffic(ranks, mode, mesh):
    ledger = ranks["ledger"][(mode, mesh)]["collectives"]
    for out in ranks["outs"]:
        got = out["steps"][(mode, mesh)]["issued"]

        def total(kinds):
            return {"count": sum(got.get(k, 0) for k in kinds),
                    "bytes": sum(got.get(f"{k}_bytes", 0) for k in kinds)}
        assert ledger["all_gather"] == total(("gather", "tp_gather"))
        assert ledger["all_reduce"] == total(("grad", "rows", "norm",
                                              "tp_reduce"))
        assert got["tp_reduce"] > 0
    assert ranks["ledger"][(mode, mesh)]["model_axis_compute"] == {
        "attention": "split", "mlp": "split", "vocab": "split"}


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m))
                                               for m in MESHES])
@pytest.mark.parametrize("mode", SELF_MODES)
def test_split_step_matches_the_ports_own(ranks, mode, mesh):
    for out in ranks["outs"]:
        ref = out["steps"][(mode, None)]
        got = out["steps"][(mode, mesh)]
        assert _rel(got["loss"], ref["loss"]) <= LOSS_REL
        assert _rel(got["grad_norm"], ref["grad_norm"]) <= NORM_REL
        for g, w in zip(got["grads"], ref["grads"]):
            assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max()
        for p, w in zip(got["params"], ref["params"]):
            assert np.abs(p - w).max() <= PARAM_ABS
        assert got["issued"]["rows"] > 2     # the activation scales


@pytest.mark.parametrize("mode", ONE_MODES)
def test_one_rank_split_step_is_the_no_mesh_step(ranks, mode):
    ref = ranks["one"]["steps"][(mode, None)]
    got = ranks["one"]["steps"][(mode, (1, 1))]
    assert got["loss"] == ref["loss"]
    assert got["grad_norm"] == ref["grad_norm"]
    for a, b in zip(got["grads"] + got["params"],
                    ref["grads"] + ref["params"]):
        np.testing.assert_array_equal(a, b)
    assert got["issued"]["tp_reduce"] > 0


@pytest.mark.parametrize("quant", QUANTS)
def test_one_rank_split_decode_is_the_whole_weight_decode(ranks, quant):
    """On the one-rank mesh the split decode emits the logits of the
    whole-weight layout on the same mesh (both through the sharded
    decode attention) bitwise, and the no-mesh decode's tokens."""
    one = ranks["one"]["decode"]
    got, ref = one[(quant, (1, 1))], one[(quant, (1, 1), "whole")]
    np.testing.assert_array_equal(got["logits"], ref["logits"])
    np.testing.assert_array_equal(got["tokens"], one[(quant, None)]["tokens"])
    assert got["split"]["attention"] == "split"
    assert ref["split"]["attention"] == "replicated"
