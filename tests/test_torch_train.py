"""The port's training slice against the JAX package.

* ``SyntheticLM.batch_np`` is bitwise JAX's; the ports of
  ``test_substrate``'s data, AdamW, schedule and checkpoint tests.
* ``AdamW.update`` against JAX's on f32 and bf16 trees over several
  steps (params, moments and grad norm at rtol 1e-6 for f32; bf16 params
  within one bf16 ulp, 2**-7 relative).
* ``ste_luna_matmul``: forward bitwise, backward (the straight-through
  plain product) at 1e-5, against JAX's ``custom_vjp``.
* Reduced f32 yi-9b on bridged weights: the loss (1e-5) and every
  gradient (max |port - jax| <= 1e-4 of the leaf's max |jax|) against
  ``jax.value_and_grad`` of JAX's loss under ``full`` and ``chunked``
  attention at S = 64 and 512 (512 runs JAX's chunked cross entropy, two
  256-token chunks, and chunked attention in 128-row chunks), and under
  ``luna_approx`` and ``luna_dc`` (the STE), ``int8``, ``int4_dequant``
  and ``lut_nf4`` at S = 64.
* Three ``train_step``s, and ``microbatch=2``, against JAX's
  ``make_train_step`` on the same batches: params at rtol = atol = 1e-4.
* The ``Trainer`` on ``luna-mlp`` (f32): the loss falls below 0.9x its
  first value within 30 steps; 12 steps then a rerun to 20 resumes from
  step 12; a run preempted by SIGTERM at step 12 and resumed ends
  bitwise where 20 straight steps do.
* ``grad_compression`` (the step and the CLI's ``--grad-compression``):
  AdamW gets JAX's ``compress_grads_int8`` of the step's gradients,
  bitwise.
* The train CLI on the CPU; what the slice leaves out raises naming its
  ROADMAP item.
"""
import os
import signal
import tempfile
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layers import QuantConfig as JQuantConfig
from repro.core.quant import ste_luna_matmul as jax_ste
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.core.layers import QuantConfig, quant_matmul
from repro_torch.core.quant import ste_luna_matmul
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.registry import get_config, get_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, tree_map

GRAD_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_scaled_close(got, want, rel, what=""):
    """Every leaf: max |got - want| <= rel * max(1e-30, max |want|)."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        scale = max(np.abs(b).max(), 1e-30)
        err = np.abs(a - b).max()
        assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,noise", [
    (128, 32, 4, 7, 0.3), (512, 64, 8, 0, 0.2), (64000, 16, 2, 3, 0.3)])
def test_synthetic_batch_np_bitwise_jax(vocab, seq, batch, seed, noise):
    port = SyntheticLM(vocab, seq, batch, seed=seed, noise=noise)
    ref = JSyntheticLM(vocab, seq, batch, seed=seed, noise=noise)
    np.testing.assert_array_equal(port.chain, ref.chain)
    for step in (0, 5):
        a, b = port.batch_np(step), ref.batch_np(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    t = port.batch(5, "cpu")
    assert t["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(t["labels"].numpy(), b["labels"])


def test_synthetic_deterministic():
    d = SyntheticLM(128, 32, 4, seed=7)
    b1, b2 = d.batch_np(3), d.batch_np(3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], d.batch_np(4)["tokens"])
    assert b1["labels"].shape == (4, 32)


def test_synthetic_learnable():
    d = SyntheticLM(64, 64, 8, seed=0, noise=0.2)
    b = d.batch_np(0)
    assert (d.chain[b["tokens"]] == b["labels"]).mean() > 0.6


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.ones(4) * 5.0}
    state = opt.init(params)
    for _ in range(200):
        m = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.5
    assert np.isfinite(float(m["grad_norm"]))
    assert int(state.step) == 200


def test_grad_clipping():
    opt = AdamW(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    opt.update({"w": torch.ones(3) * 1e6}, state, params)
    # post-clip m is bounded: m = (1 - b1) * clipped_grad
    assert float(state.m["w"].abs().max()) <= 0.1 * (1.0 + 1e-5)


def test_cosine_schedule_shape():
    sch = cosine_schedule(10, 100)
    assert float(sch(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(sch(torch.tensor(10))) == pytest.approx(1.0)
    assert float(sch(torch.tensor(100))) == pytest.approx(0.1, abs=1e-5)
    jsch = jax_cosine(10, 100)
    for s in (0, 3, 10, 37, 99, 100, 150):
        assert float(sch(torch.tensor(s, dtype=torch.int32))) == \
            float(jsch(jnp.int32(s)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(dtype):
    """Five updates of a tree with a clipped step, a schedule and weight
    decay: params, moments and the grad norm against JAX's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 16), "b": {"c": (16,), "d": (4, 4)}}
    p0 = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                      shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: (rng.normal(size=s) * (3 if i == 1
                                                           else 0.1))
                          .astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
             for i in range(5)]
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(**kw, schedule=jax_cosine(2, 5))
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    js = jopt.init(jp)
    opt = AdamW(**kw, schedule=cosine_schedule(2, 5))
    tdt = getattr(torch, dtype)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), p0)
    ts = opt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(
            lambda a: jnp.asarray(a, jdt), g), js, jp)
        tm = opt.update(jax.tree.map(lambda a: torch.from_numpy(a).to(tdt),
                                     g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for got, want in ((ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4), "h": torch.randn(3).bfloat16()},
            "s": torch.tensor(7, dtype=torch.int32)}
    ck.save(5, tree, blocking=True)
    assert ck.latest_step() == 5
    target = tree_map(torch.zeros_like, tree)
    out = ck.restore(5, target)
    assert out is target
    for a, b in zip(leaves(out), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_snapshot_survives_in_place_updates(tmp_path):
    """The host copy is taken at save(): an in-place update right after
    (the trainer's next step) does not reach the file."""
    ck = Checkpointer(tmp_path)
    w = torch.ones(1000)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    out = ck.restore(1, {"w": torch.zeros(1000)})
    assert torch.equal(out["w"], torch.ones(1000))


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.ones(2) * s}, blocking=True)
    assert ck.steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_ignores_partial(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": torch.ones(2)}, blocking=True)
    (tmp_path / "step_9.tmp").mkdir()      # a crash mid-write
    (tmp_path / "step_7").mkdir()          # no meta.json -> incomplete
    assert ck.latest_step() == 1


# ---------------------------------------------------------------------------
# STE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["approx_dc", "opt_dc", "approx_dc2"])
def test_ste_luna_matmul_matches_jax(mode):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 12)) / 5).astype(np.float32)
    g = rng.normal(size=(2, 5, 12)).astype(np.float32)

    def jf(x, w):
        return jnp.sum(jax_ste(x, w, mode, 4) * g)

    jy = jax_ste(jnp.asarray(x), jnp.asarray(w), mode, 4)
    jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = ste_luna_matmul(tx, tw, mode, 4)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)


def test_quant_matmul_under_grad():
    """luna_* modes carry gradients (the STE); int8, int4_dequant and
    lut_nf4 carry JAX's (``tests/test_torch_train_options.py`` holds them
    to ``jax.grad``): none through their rounded codes, so w's reach it
    only through the per-channel scales, at its extremes; the forward
    under autograd is the no-grad forward bitwise."""
    x = torch.randn(3, 16)
    w = (torch.randn(16, 8) / 4).requires_grad_()
    quant_matmul(x, w, QuantConfig(mode="luna_approx2")).sum().backward()
    torch.testing.assert_close(w.grad, x.T @ torch.ones(3, 8))
    for mode in ("int8", "int4_dequant", "lut_nf4"):
        w.grad = None
        xg = x.clone().requires_grad_()
        y = quant_matmul(xg, w, QuantConfig(mode=mode))
        with torch.no_grad():
            assert torch.equal(y, quant_matmul(x, w, QuantConfig(mode=mode)))
        y.sum().backward()
        assert xg.grad.abs().sum() > 0
        extremes = ((w == w.amax(0)) | (w == w.amin(0))
                    | (w.abs() == w.abs().amax(0)))
        assert (w.grad != 0).any() and not w.grad[~extremes].any(), mode


# ---------------------------------------------------------------------------
# loss and gradients of the model against jax.grad
# ---------------------------------------------------------------------------

def _grads_numpy(model) -> dict:
    """The model's .grad tree in JAX's (stacked) layout."""
    grads = tree_map(lambda p: p.grad, model.params_tree())
    return params_to_numpy(type(model).from_params(model.cfg, grads,
                                                   device="cpu"))


def _lm_batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


#: under int8 and int4_dequant JAX's reference is compiled without XLA's
#: algebraic simplifier: that pass turns the calibration's x / (range /
#: qmax) into a multiply by a reciprocal, an ulp off the quotient JAX
#: takes op by op (and the port takes), which moves the codes near a
#: rounding edge (under int8 one quant_matmul's outputs by ~1e-2 of 8, the
#: model's loss by 3e-4).  Without it the compiled values are the op-by-op
#: ones
OP_BY_OP_OPTIONS = {"xla_disable_hlo_passes": "algsimp"}
OP_BY_OP_MODES = ("int8", "int4_dequant")


def _jax_compiled(fn, quant):
    """``jax.jit(fn)``; under ``OP_BY_OP_MODES`` compiled with
    ``OP_BY_OP_OPTIONS`` on its first call."""
    if quant not in OP_BY_OP_MODES:
        return jax.jit(fn)
    compiled = {}

    def call(*args):
        if "fn" not in compiled:
            compiled["fn"] = jax.jit(fn).lower(*args).compile(
                compiler_options=OP_BY_OP_OPTIONS)
        return compiled["fn"](*args)
    return call


@pytest.mark.parametrize("impl,quant,s", [
    ("full", "bf16", 64), ("chunked", "bf16", 64), ("full", "bf16", 512),
    ("chunked", "bf16", 512), ("full", "luna_approx", 64),
    ("full", "luna_dc", 64), ("full", "int8", 64),
    ("full", "int4_dequant", 64), ("full", "lut_nf4", 64)])
def test_loss_and_grads_match_jax(impl, quant, s):
    over = dict(dtype="float32", attn_impl=impl, attn_chunk=128)
    jcfg = jax_config("yi-9b").reduced(**over,
                                       quant=JQuantConfig(mode=quant))
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = _lm_batch(jcfg.vocab_size, 2, s, 7)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jloss, jparts), jgrads = _jax_compiled(
        jax.value_and_grad(jmodel.loss, has_aux=True), quant)(jparams,
                                                              jbatch)
    cfg = get_config("yi-9b").reduced(**over, quant=QuantConfig(mode=quant))
    model = params_from_numpy(_np_tree(jparams), cfg,
                              "cpu").requires_grad_(True)
    loss, parts = model.loss({k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(parts["xent"]), float(jparts["xent"]),
                               rtol=1e-5)
    _assert_scaled_close(_grads_numpy(model), _np_tree(jgrads), GRAD_REL,
                         f"{impl} {quant} S={s}")


def test_int8_train_step_matches_jax_op_by_op():
    """One ``make_train_step`` step under int8 against JAX's, compiled as
    op by op (``OP_BY_OP_OPTIONS``): loss 1e-5, grad norm 1e-4, params
    per element at 1e-4."""
    over = dict(dtype="float32", attn_impl="full")
    jcfg = jax_config("yi-9b").reduced(**over,
                                       quant=JQuantConfig(mode="int8"))
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(1))
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(**kw, schedule=jax_cosine(1, 3))
    jstep, _ = jax_make_train_step(jcfg, jopt, None)
    data = SyntheticLM(jcfg.vocab_size, 64, 2, seed=7)
    new, _, jm = _jax_compiled(jstep, "int8")(
        jparams, jopt.init(jparams), jax.tree.map(jnp.asarray,
                                                  data.batch_np(0)))
    cfg = get_config("yi-9b").reduced(**over, quant=QuantConfig(mode="int8"))
    model = params_from_numpy(_np_tree(jparams), cfg,
                              "cpu").requires_grad_(True)
    opt = AdamW(**kw, schedule=cosine_schedule(1, 3))
    m = make_train_step(cfg, opt)(model, opt.init(model.params_tree()),
                                  data.batch(0, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(model)),
                    jax.tree.leaves(_np_tree(new))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_remat_changes_no_gradient():
    cfg = get_config("yi-9b").reduced(dtype="float32")
    base = params_to_numpy(get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v).long()
             for k, v in _lm_batch(cfg.vocab_size, 2, 32, 1).items()}
    got = []
    for remat in (True, False):
        model = params_from_numpy(base, replace(cfg, remat=remat),
                                  "cpu").requires_grad_(True)
        model.loss(batch)[0].backward()
        got.append(_grads_numpy(model))
    for a, b in zip(jax.tree.leaves(got[0]), jax.tree.leaves(got[1])):
        np.testing.assert_array_equal(a, b)
    model = params_from_numpy(base, replace(cfg, remat_policy="dots"),
                              "cpu").requires_grad_(True)
    model.loss(batch)[0].backward()
    for a, b in zip(jax.tree.leaves(got[0]),
                    jax.tree.leaves(_grads_numpy(model))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown remat policy"):
        params_from_numpy(base, replace(cfg, remat_policy="everything"),
                          "cpu").loss(batch)


# ---------------------------------------------------------------------------
# train_step against JAX's make_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_steps_match_jax(microbatch):
    over = dict(dtype="float32", attn_impl="full")
    jcfg = jax_config("yi-9b").reduced(**over)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(1))
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(**kw, schedule=jax_cosine(1, 3))
    jstep, _ = jax_make_train_step(jcfg, jopt, None, microbatch=microbatch)
    jstep = jax.jit(jstep)
    jstate = jopt.init(jparams)
    cfg = get_config("yi-9b").reduced(**over)
    model = params_from_numpy(_np_tree(jparams), cfg,
                              "cpu").requires_grad_(True)
    opt = AdamW(**kw, schedule=cosine_schedule(1, 3))
    state = opt.init(model.params_tree())
    step = make_train_step(cfg, opt, microbatch=microbatch)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    for i in range(3):
        b = data.batch_np(i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, b))
        m = step(model, state, data.batch(i, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert set(m) == set(jm)
    assert all(p.grad is None for p in model.parameters())
    # Adam divides by sqrt(v): an f32-order difference in a gradient near
    # zero moves its update by more than its share, so the params are held
    # per element, at 1e-4 absolute and relative
    for a, b in zip(jax.tree.leaves(params_to_numpy(model)),
                    jax.tree.leaves(_np_tree(jparams))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_bridge_round_trips_luna_mlp_after_training():
    """luna-mlp (GELU, MHA 4/4) crosses from JAX bit-exactly, trains, and
    its grad-requiring leaves cross back into JAX's stacked layout."""
    jcfg = replace(jax_config("luna-mlp"), dtype="float32")
    jparams = _np_tree(jax_model(jcfg).init(jax.random.PRNGKey(3)))
    cfg = get_config("luna-mlp", dtype="float32")
    model = params_from_numpy(jparams, cfg, "cpu")
    assert "w_gate" not in jparams["blocks"]["mlp"]
    back = params_to_numpy(model.requires_grad_(True))
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    opt = AdamW(lr=1e-2)
    make_train_step(cfg, opt)(model, opt.init(model.params_tree()),
                              SyntheticLM(256, 16, 2).batch(0, "cpu"))
    moved = params_to_numpy(model)
    assert not np.array_equal(moved["blocks"]["mlp"]["w_up"],
                              jparams["blocks"]["mlp"]["w_up"])


def record_compression(monkeypatch) -> tuple[list, list]:
    """Record each call of the train step's ``compress_grads_int8`` (its
    input and output trees) and the gradient tree each ``AdamW.update``
    receives."""
    import repro_torch.train.train_step as ts
    calls, updates = [], []
    compress, update = ts.compress_grads_int8, AdamW.update

    def recorded(grads):
        calls.append((grads, compress(grads)))
        return calls[-1][1]

    def recorded_update(self, grads, *a, **kw):
        updates.append(grads)
        return update(self, grads, *a, **kw)
    monkeypatch.setattr(ts, "compress_grads_int8", recorded)
    monkeypatch.setattr(AdamW, "update", recorded_update)
    return calls, updates


def assert_compressed_as_jax(calls, updates):
    """Every update got the output of one compression, and that output
    is JAX's ``compress_grads_int8`` of its input, bitwise."""
    from repro.parallel.collectives import compress_grads_int8 as jax_q8
    assert calls and len(calls) == len(updates)

    def arr(t):
        return t.detach().float().numpy()
    for (raw, out), got in zip(calls, updates):
        assert got is out
        want = jax_q8(jax.tree.map(lambda t: jnp.asarray(
            arr(t), jnp.bfloat16 if t.dtype == torch.bfloat16
            else jnp.float32), raw))
        got_np = jax.tree.leaves(jax.tree.map(arr, out))
        assert len(got_np) == len(jax.tree.leaves(want))
        for a, b in zip(got_np, jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("microbatch", [0, 2])
def test_grad_compression_matches_jax_bitwise(monkeypatch, microbatch):
    """``grad_compression=True`` hands AdamW JAX's ``compress_grads_int8``
    of the step's gradients, bitwise; those gradients and the loss are
    the uncompressed step's, bitwise (luna-mlp, f32)."""
    jcfg = replace(jax_config("luna-mlp"), dtype="float32")
    jparams = _np_tree(jax_model(jcfg).init(jax.random.PRNGKey(3)))
    cfg = get_config("luna-mlp", dtype="float32")
    batch = SyntheticLM(256, 16, 4).batch(0, "cpu")
    calls, updates = record_compression(monkeypatch)
    loss = {}
    for compress in (False, True):
        model = params_from_numpy(jparams, cfg, "cpu").requires_grad_(True)
        opt = AdamW(lr=1e-2)
        step = make_train_step(cfg, opt, microbatch=microbatch,
                               grad_compression=compress)
        loss[compress] = step(model, opt.init(model.params_tree()),
                              batch)["loss"]
    assert len(updates) == 2 and len(calls) == 1
    assert torch.equal(loss[True], loss[False])
    for a, b in zip(leaves(calls[0][0]), leaves(updates[0])):
        assert torch.equal(a, b)
    assert_compressed_as_jax(calls, updates[1:])
    assert any(not torch.equal(a, b) for a, b in
               zip(leaves(calls[0][0]), leaves(calls[0][1])))


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _mlp_trainer(tmp_path, steps, name="ck"):
    cfg = get_config("luna-mlp", dtype="float32")
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=5, log_every=5,
                         ckpt_dir=str(tmp_path / name), lr=3e-3, warmup=2)
    return Trainer(cfg, tcfg, device="cpu"), SyntheticLM(cfg.vocab_size, 32,
                                                         8, seed=0)


def test_trainer_loss_decreases(tmp_path):
    trainer, data = _mlp_trainer(tmp_path, 30)
    _, hist = trainer.run(data)
    assert len(hist) == 30 and hist[-1] < hist[0] * 0.9, hist


def test_trainer_restart_resumes(tmp_path, capsys):
    """12 steps (checkpoints at 5, 10, 12), then a rerun to 20 resumes
    from step 12 and trains only the remaining 8."""
    trainer, data = _mlp_trainer(tmp_path, 12)
    trainer.run(data)
    assert trainer.ckpt.steps() == [5, 10, 12]
    trainer, data = _mlp_trainer(tmp_path, 20)
    _, hist = trainer.run(data)
    assert "resumed from step 12" in capsys.readouterr().out
    assert len(hist) == 8


class _PreemptAt:
    """The data stream, sending SIGTERM to this process while batch
    ``step`` is fetched."""

    def __init__(self, data, step):
        self.data, self.step = data, step

    def batch(self, step, device):
        if step == self.step:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.data.batch(step, device)


def test_trainer_preempted_and_resumed_is_bitwise_straight(tmp_path,
                                                           capsys):
    trainer, data = _mlp_trainer(tmp_path, 20, "straight")
    straight, hist = trainer.run(data)
    previous = signal.getsignal(signal.SIGTERM)
    trainer, data = _mlp_trainer(tmp_path, 20, "preempted")
    _, hist_a = trainer.run(_PreemptAt(data, 11))
    assert signal.getsignal(signal.SIGTERM) is previous
    assert "preemption: checkpointed at 12" in capsys.readouterr().out
    assert trainer.ckpt.latest_step() == 12 and len(hist_a) == 12
    trainer, data = _mlp_trainer(tmp_path, 20, "preempted")
    resumed, hist_b = trainer.run(data)
    assert hist_a + hist_b == hist
    for a, b in zip(leaves(resumed.params_tree()),
                    leaves(straight.params_tree())):
        assert torch.equal(a, b)


def test_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    hist = main(["--reduced", "--device", "cpu", "--steps", "2", "--seq",
                 "16", "--batch", "2", "--ckpt-dir", str(tmp_path / "a")])
    assert len(hist) == 2 and all(np.isfinite(hist))
    hist = main(["--device", "cpu", "--steps", "2", "--seq", "16", "--batch",
                 "2", "--quant", "luna_approx", "--ckpt-dir",
                 str(tmp_path / "b"), "--arch", "luna-mlp"])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert "luna_approx" in capsys.readouterr().out
    # on a mesh: 4 local gloo ranks, (data 2, model 2)
    hist = main(["--device", "cpu", "--host-devices", "4", "--model-parallel",
                 "2", "--steps", "2", "--seq", "16", "--batch", "4",
                 "--ckpt-dir", str(tmp_path / "mesh")])
    assert len(hist) == 2 and all(np.isfinite(hist))
    with pytest.raises(RuntimeError, match="init_process_group"):
        main(["--device", "cpu", "--model-parallel", "2"])


def test_train_cli_grad_compression_matches_jax(tmp_path, monkeypatch):
    """``--grad-compression``: each step's AdamW update gets JAX's
    ``compress_grads_int8`` of that step's gradients, bitwise."""
    from repro_torch.launch.train import main
    calls, updates = record_compression(monkeypatch)
    hist = main(["--reduced", "--device", "cpu", "--steps", "2", "--seq",
                 "16", "--batch", "2", "--grad-compression", "--ckpt-dir",
                 str(tmp_path)])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert len(calls) == 2
    assert_compressed_as_jax(calls, updates)


def test_checkpoint_dir_default_is_the_ports_own(tmp_path, monkeypatch):
    """The Trainer and the CLI share one default, ``$TMPDIR/
    repro_torch_ckpt``, never JAX's directory (a port run must not resume
    from a JAX run's checkpoints)."""
    from repro.train.trainer import TrainerConfig as JaxTrainerConfig
    from repro_torch.launch.train import main
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert TrainerConfig().ckpt_dir == str(tmp_path / "repro_torch_ckpt")
    assert (os.path.basename(JaxTrainerConfig().ckpt_dir)
            != os.path.basename(TrainerConfig().ckpt_dir))
    main(["--device", "cpu", "--steps", "1", "--seq", "16", "--batch", "2"])
    assert os.listdir(tmp_path / "repro_torch_ckpt") == ["step_1"]
