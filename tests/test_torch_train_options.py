"""The last training options of the port against the JAX package.

* ``remat_policy="dots"`` (``models.common.remat_of``: selective
  checkpointing that saves ``mm``/``addmm``/``_int_mm`` outputs, JAX's
  ``dots_with_no_batch_dims_saveable``): on reduced f32 yi-9b,
  mamba2-1.3b, zamba2-1.2b and whisper-base (the four remat users) every
  gradient equals ``"nothing"``'s bitwise and ``jax.grad``'s under JAX's
  ``"dots"`` within ``GRAD_REL`` of its leaf's scale (the loss at 1e-5);
  on a real block of each the policy saves every ``mm``/``addmm`` output
  and no ``bmm`` output (attention's scores and P·V), and the saved
  products are not run again in the backward.
* ``int8``, ``int4_dequant`` and ``lut_nf4`` under autograd:
  ``quant_matmul``'s x and w gradients against ``jax.grad`` of JAX's
  ``quant_matmul`` in f32 (1e-5 of each gradient's scale) and bf16
  (``BF16_REL``), on weights with tied per-channel maxima; the one place
  the two libraries differ (``clamp_min`` against ``jnp.maximum`` at
  exactly 1e-8) pinned; ``kernels.lut_gemm.ops.NF4MatmulFn`` (the card's
  route, here with ``lut_gemm_ref`` over the transposed codes) against
  autograd of ``core.layers._nf4_matmul``.
* One ``make_train_step`` step of reduced yi-9b under ``int4_dequant``
  and ``lut_nf4`` against JAX's (loss 1e-5, grad norm 1e-4, params at
  1e-4 where the gradient is settled, 2 lr elsewhere:
  ``test_torch_train_families``' bounds).  int8's is in
  ``test_torch_train.py``.  Under int8 and int4_dequant JAX's reference
  is compiled without XLA's algebraic simplifier
  (``OP_BY_OP_OPTIONS``): that pass divides by the constant ``qmax`` as
  a multiply by its reciprocal, which moves a scale by an ulp and the
  codes near a rounding edge with it; without it the compiled values are
  JAX's op-by-op ones, which the port takes.

JAX's models start from the port's initial weights (seed 1), carried
across as numpy through the bridge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.layers import QuantConfig as JQuantConfig
from repro.core.layers import quant_matmul as jax_quant_matmul
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core.layers import QuantConfig, _nf4_matmul, quant_matmul
from repro_torch.core.lut import NF4_CODEBOOK
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels.lut_gemm.ops import NF4MatmulFn, codebook_quantize
from repro_torch.models import common
from repro_torch.models.registry import get_config, get_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_map

GRAD_REL = 1e-4
#: bf16 gradients against JAX's, as a share of each tensor's max |jax|:
#: four bf16 ulps (2**-8 each); the libraries round the bf16 products and
#: the scales' chains in other orders
BF16_REL = 2.0 ** -6
REMAT_ARCHS = ("yi-9b", "mamba2-1.3b", "zamba2-1.2b", "whisper-base")
QUANT_MODES = ("int8", "int4_dequant", "lut_nf4")
B, S = 2, 48
#: JAX's reference of the modes that calibrate against a constant qmax,
#: compiled as it runs op by op (module docstring)
OP_BY_OP_OPTIONS = {"xla_disable_hlo_passes": "algsimp"}
OP_BY_OP_MODES = ("int8", "int4_dequant")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Each module pins torch to one intra-op thread (the suite runs the
    files in several worker processes at once), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_compiled(fn, mode, *args):
    """``fn(*args)`` through ``jax.jit``; under ``OP_BY_OP_MODES``
    compiled with ``OP_BY_OP_OPTIONS``."""
    if mode not in OP_BY_OP_MODES:
        return jax.jit(fn)(*args)
    return jax.jit(fn).lower(*args).compile(
        compiler_options=OP_BY_OP_OPTIONS)(*args)


def _init_numpy(cfg) -> dict:
    """The port's initial weights for ``cfg`` (seed 1) in JAX's layout."""
    return params_to_numpy(get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1)))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def _grads_numpy(model) -> dict:
    """The model's .grad tree in JAX's layout (stacked layers)."""
    return params_to_numpy(type(model).from_params(
        model.cfg, tree_map(lambda p: p.grad, model.params_tree()),
        device="cpu"))


class _OpCounter(TorchDispatchMode):
    """Counts each aten overload dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def remat_runs():
    """arch -> (JAX cfg under "dots", params (numpy, JAX's layout), batch,
    {policy: (loss, the port's grads, the ``dots_policy`` decisions of
    the forward as (op, policy), the backward's ``aten.mm`` count)}) for
    "nothing", "dots" and "off" (remat off); reduced f32, one loss and
    backward each, built once."""
    out = {}
    policy_of = common.dots_policy
    for arch in REMAT_ARCHS:
        jcfg = jax_config(arch).reduced(dtype="float32", remat_policy="dots")
        params = _init_numpy(get_config(arch).reduced(dtype="float32"))
        batch = _batch(jcfg, 7)
        runs = {}
        for policy in ("nothing", "dots", "off"):
            cfg = (get_config(arch).reduced(dtype="float32", remat=False)
                   if policy == "off" else
                   get_config(arch).reduced(dtype="float32",
                                            remat_policy=policy))
            model = params_from_numpy(params, cfg,
                                      "cpu").requires_grad_(True)
            decided = []

            def logged(ctx, op, *args, **kwargs):
                choice = policy_of(ctx, op, *args, **kwargs)
                if not ctx.is_recompute:
                    decided.append((op, choice))
                return choice

            with pytest.MonkeyPatch.context() as m:
                m.setattr(common, "dots_policy", logged)
                loss, _ = model.loss(_torch_batch(batch))
                with _OpCounter() as counter:
                    loss.backward()
            runs[policy] = (loss.item(), _grads_numpy(model), decided,
                            counter.counts.get(torch.ops.aten.mm.default, 0))
        out[arch] = (jcfg, params, batch, runs)
    return out


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_dots_equals_nothing_bitwise(remat_runs, arch):
    _, _, _, runs = remat_runs[arch]
    assert runs["dots"][0] == runs["nothing"][0]
    assert not runs["nothing"][2] and runs["dots"][2]
    a, b = (jax.tree.leaves(runs[p][1]) for p in ("nothing", "dots"))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_dots_matches_jax_dots(remat_runs, arch):
    jcfg, params, batch, runs = remat_runs[arch]
    assert jcfg.remat and jcfg.remat_policy == "dots"
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_model(jcfg).loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    loss, grads = runs["dots"][:2]
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_leaves_with_path(_np_tree(jgrads))
    gflat = jax.tree.leaves(grads)
    assert len(gflat) == len(jflat)
    for got, (path, want) in zip(gflat, jflat):
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got.astype(np.float64) - want).max()
        assert err <= GRAD_REL * scale, (
            f"{arch} {jax.tree_util.keystr(path)}: {err} > {GRAD_REL} * "
            f"{scale}")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_dots_saves_mm_not_bmm(remat_runs, arch):
    """The policy's decisions on the arch's real blocks (the fixture's
    loss and backward): every ``mm``/``addmm`` output of the forward
    saved, no ``bmm`` output; and the backward under ``"dots"`` runs as
    many ``mm``s as with remat off, fewer than under ``"nothing"``."""
    _, _, _, runs = remat_runs[arch]
    decided = runs["dots"][2]
    backward_mm = {p: r[3] for p, r in runs.items()}
    saved = [op for op, p in decided
             if p == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    ops = {op for op, _ in decided}
    assert set(saved) <= common.DOTS_SAVED
    assert saved.count(torch.ops.aten.mm.default) == sum(
        op == torch.ops.aten.mm.default for op, _ in decided) > 0
    bmm = torch.ops.aten.bmm.default
    assert bmm in ops and bmm not in saved, arch        # attention / scan
    # the recompute runs none of the saved products again: the backward's
    # mm count is that of no remat at all ("nothing" recomputes them)
    assert backward_mm["dots"] == backward_mm["off"] < backward_mm["nothing"]


def _tied(rng, k, n, dtype=np.float32):
    """(k, n) weights with ties in every kind the gradient splits: column
    0 two equal maxima, column 1 two equal minima, column 2 equal max |w|
    of opposite signs."""
    w = (rng.normal(size=(k, n)) / 4).astype(dtype)
    w[3, 0] = w[5, 0] = np.abs(w[:, 0]).max() + 0.5
    w[2, 1] = w[7, 1] = -np.abs(w[:, 1]).max() - 0.5
    w[1, 2], w[4, 2] = np.abs(w[:, 2]).max() + 0.5, -np.abs(w[:, 2]).max() - 0.5
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quant_matmul_grads_match_jax(mode, dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    w = _tied(rng, 16, 8)
    g = rng.normal(size=(2, 6, 8)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    grad = jax.grad(lambda a, b: jnp.sum(jax_quant_matmul(
        a, b, JQuantConfig(mode=mode)).astype(jnp.float32) * g),
        argnums=(0, 1))
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    # bf16 op by op: compiled, XLA also keeps some bf16 intermediates in
    # f32, which no compiler option here undoes
    jgx, jgw = (_jax_compiled(grad, mode, jx, jw) if dtype == "float32"
                else grad(jx, jw))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    (quant_matmul(tx, tw, QuantConfig(mode=mode)).float()
     * torch.from_numpy(g)).sum().backward()
    rel = 1e-5 if dtype == "float32" else BF16_REL
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rel * np.abs(want).max())
    gw = tw.grad.float().numpy()
    if mode != "int4_dequant":            # one extreme per column ...
        assert (gw[:, 3:] != 0).sum(axis=0).max() == 1
    # ... and the tied ones split evenly, as JAX's reductions split them
    for col, rows in ((0, (3, 5)), (1, (2, 7)), (2, (1, 4))):
        if mode == "int4_dequant" or col != 1:
            a, b = gw[rows[0], col], gw[rows[1], col]
            assert abs(abs(a) - abs(b)) <= rel * np.abs(gw).max(), (col, a, b)


def test_clamp_floor_is_where_the_libraries_differ():
    """At max|w| == 1e-8 exactly (an all-but-zero column), torch's
    ``clamp_min`` passes the gradient (1) where ``jnp.maximum`` splits it
    with the constant (0.5): the port's w gradient there is twice JAX's.
    Everywhere else the two agree."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    g = rng.normal(size=(4, 8)).astype(np.float32)
    w = (rng.normal(size=(16, 8)) / 4).astype(np.float32)
    w[:, 6] = 0
    w[9, 6] = np.float32(1e-8)
    jgw = np.asarray(jax.grad(lambda b: jnp.sum(jax_quant_matmul(
        jnp.asarray(x), b, JQuantConfig(mode="lut_nf4")) * g))(
        jnp.asarray(w)))
    tw = torch.from_numpy(w).requires_grad_()
    (quant_matmul(torch.from_numpy(x), tw, QuantConfig(mode="lut_nf4"))
     * torch.from_numpy(g)).sum().backward()
    got = tw.grad.numpy()
    assert jgw[9, 6] != 0
    np.testing.assert_allclose(got[9, 6], 2 * jgw[9, 6], rtol=1e-6)
    rest = np.ones_like(got, bool)
    rest[:, 6] = False
    np.testing.assert_allclose(got[rest], jgw[rest], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(6, 16, 8), (40, 48, 24)])
def test_nf4_function_matches_autograd(m, k, n):
    """``NF4MatmulFn`` with ``lut_gemm_ref``: dx from the LUT GEMM over
    the transposed codes, d absmax as Σ_m g·y0, the rest autograd; the
    forward within f32 rounding of the library order and the gradients
    of autograd through ``_nf4_matmul``; ties split."""
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = _tied(rng, k, n)
    g = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    grads = []
    for path in ("library", "function"):
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        if path == "library":
            out = _nf4_matmul(tx, tw)
        else:
            codes, absmax = codebook_quantize(tw, NF4_CODEBOOK)
            out = NF4MatmulFn.apply(tx, codes, absmax)
        (out * g).sum().backward()
        grads.append((out.detach(), tx.grad, tw.grad))
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())
    assert NF4MatmulFn.backward_launches == 0        # no card here


@pytest.mark.parametrize("mode", ("int4_dequant", "lut_nf4"))
def test_train_step_matches_jax(mode):
    """int8's step is ``test_torch_train.py::
    test_int8_train_step_matches_jax_op_by_op``, beside the op-by-op
    loss test whose compiled primitives it reuses."""
    over = dict(dtype="float32", attn_impl="full")
    jcfg = jax_config("yi-9b").reduced(**over,
                                       quant=JQuantConfig(mode=mode))
    jparams = jax.tree.map(jnp.asarray, _init_numpy(
        get_config("yi-9b").reduced(**over)))
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(**kw, schedule=jax_cosine(1, 3))
    jstep, _ = jax_make_train_step(jcfg, jopt, None)
    data = SyntheticLM(jcfg.vocab_size, 32, B, seed=0)
    new, _, jm = _jax_compiled(jstep, mode, jparams, jopt.init(jparams),
                               jax.tree.map(jnp.asarray, data.batch_np(0)))
    cfg = get_config("yi-9b").reduced(**over,
                                      quant=QuantConfig(mode=mode))
    model = params_from_numpy(_np_tree(jparams), cfg,
                              "cpu").requires_grad_(True)
    model.loss(data.batch(0, "cpu"))[0].backward()
    grads = _grads_numpy(model)
    model.zero_grad(set_to_none=True)
    opt = AdamW(**kw, schedule=cosine_schedule(1, 3))
    m = make_train_step(cfg, opt)(model, opt.init(model.params_tree()),
                                  data.batch(0, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    for a, b, g in zip(jax.tree.leaves(params_to_numpy(model)),
                       jax.tree.leaves(_np_tree(new)),
                       jax.tree.leaves(grads)):
        settled = np.abs(g) > GRAD_REL * np.abs(g).max()
        np.testing.assert_allclose(a[settled], b[settled], rtol=1e-4,
                                   atol=1e-4)
        assert np.abs(a - b).max() <= 2 * kw["lr"]
