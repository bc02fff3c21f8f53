"""Training the ssm, hybrid and moe families through the port against the
JAX package.

Reduced f32 mamba2-1.3b (2 layers, 16 heads of 16, state 16, chunk 32),
zamba2-1.2b (4 Mamba2 layers, the shared block twice) and
deepseek-v2-lite-16b (8 experts top-2, MLA rank 32; the first layer
dense), JAX params from ``PRNGKey(1)`` crossing through numpy:

* the loss and every leaf's gradient against ``jax.value_and_grad`` of
  JAX's ``model.loss`` (remat on, as JAX's defaults; S = 80 spans 2.5 of
  mamba2's 32-position chunks): the loss at rtol 1e-5, each gradient
  within ``GRAD_REL`` = 1e-4 of its leaf's max |jax| (the yi-9b tests'
  bound).  On the CPU the SSD scan differentiates through
  ``SSDScanFn`` (forward ``_ssd_chunked``, backward ``ssd_scan_bwd_ref``);
* one ``make_train_step`` step's params against JAX's ``make_train_step``
  on the same batch, per element at rtol = atol = 1e-4 (Adam divides by
  sqrt(v), as in ``test_torch_train.py``).  Adam's first step moves an
  element by ~lr · sign(g): where the gradient is within the gradient
  bound (``GRAD_REL`` of its leaf's scale) of 0, the two f32 gradients
  need not agree on that sign (mamba2's ``w_out`` has one at 7.6e-8 of the
  scale, ~eps), so those elements are held to the one-step bound 2 lr;
* the ``Trainer`` on reduced mamba2: 3 steps, then a rerun to 5 resumes
  from step 3;
* the train CLI on the CPU for each family.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_map

GRAD_REL = 1e-4
ARCHS = ("mamba2-1.3b", "zamba2-1.2b", "deepseek-v2-lite-16b")
B, S = 2, 80


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


@pytest.fixture(scope="module")
def family():
    """arch -> (JAX cfg, JAX model, JAX params), reduced f32, built once."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_config(arch).reduced(dtype="float32")
        jmodel = jax_model(jcfg)
        out[arch] = (jcfg, jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(1)))
    return out


def _port(arch, jparams):
    cfg = get_config(arch).reduced(dtype="float32")
    return params_from_numpy(_np_tree(jparams), cfg,
                             "cpu").requires_grad_(True)


def _grads_numpy(model) -> dict:
    """The model's .grad tree in JAX's layout (stacked layers)."""
    return params_to_numpy(type(model).from_params(
        model.cfg, tree_map(lambda p: p.grad, model.params_tree()),
        device="cpu"))


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_jax(family, arch):
    jcfg, jmodel, jparams = family[arch]
    assert jcfg.remat
    batch = _batch(jcfg.vocab_size, 7)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, jax.tree.map(jnp.asarray, batch))
    model = _port(arch, jparams)
    loss, parts = model.loss({k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(parts) == set(jparts)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                   rtol=1e-5, atol=1e-6)
    grads = _grads_numpy(model)
    jflat = jax.tree_util.tree_leaves_with_path(_np_tree(jgrads))
    gflat = jax.tree.leaves(grads)
    assert len(gflat) == len(jflat)
    for got, (path, want) in zip(gflat, jflat):
        name = jax.tree_util.keystr(path)
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got.astype(np.float64) - want).max()
        assert err <= GRAD_REL * scale, f"{arch} {name}: {err} > " \
                                        f"{GRAD_REL} * {scale}"
        if "A_log" in name or "dt_bias" in name or "router" in name:
            assert np.abs(want).max() > 0, name      # the scan / router


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(family, arch):
    jcfg, _, jparams = family[arch]
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(**kw, schedule=jax_cosine(1, 3))
    jstep, _ = jax_make_train_step(jcfg, jopt, None)
    data = SyntheticLM(jcfg.vocab_size, 48, B, seed=0)
    b0 = data.batch_np(0)
    new, _, jm = jax.jit(jstep)(jparams, jopt.init(jparams),
                                jax.tree.map(jnp.asarray, b0))
    model = _port(arch, jparams)
    model.loss(data.batch(0, "cpu"))[0].backward()
    grads = _grads_numpy(model)          # held to JAX's by the test above
    model.zero_grad(set_to_none=True)
    opt = AdamW(**kw, schedule=cosine_schedule(1, 3))
    m = make_train_step(model.cfg, opt)(model, opt.init(model.params_tree()),
                                        data.batch(0, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert set(m) == set(jm)
    moved = 0
    for a, b, old, g in zip(jax.tree.leaves(params_to_numpy(model)),
                            jax.tree.leaves(_np_tree(new)),
                            jax.tree.leaves(_np_tree(jparams)),
                            jax.tree.leaves(grads)):
        settled = np.abs(g) > GRAD_REL * np.abs(g).max()
        np.testing.assert_allclose(a[settled], b[settled], rtol=1e-4,
                                   atol=1e-4)
        assert np.abs(a - b).max() <= 2 * kw["lr"]
        moved += not np.array_equal(a, old)
    assert moved == len(jax.tree.leaves(jparams))


def test_trainer_runs_and_resumes_mamba2(tmp_path, capsys):
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    data = SyntheticLM(cfg.vocab_size, 32, 2, seed=0)
    hist = {}
    for total in (3, 5):
        tcfg = TrainerConfig(total_steps=total, ckpt_every=2, log_every=1,
                             ckpt_dir=str(tmp_path / "ck"), lr=3e-3, warmup=1)
        trainer = Trainer(cfg, tcfg, device="cpu")
        _, hist[total] = trainer.run(data, install_signals=False)
    assert len(hist[3]) == 3 and len(hist[5]) == 2
    assert all(np.isfinite(hist[3] + hist[5]))
    assert "resumed from step 3" in capsys.readouterr().out
    assert trainer.ckpt.steps() == [3, 4, 5]       # the latest 3 kept


@pytest.mark.parametrize("arch,quant", [("mamba2-1.3b", "bf16"),
                                        ("zamba2-1.2b", "bf16"),
                                        ("deepseek-v2-lite-16b",
                                         "luna_approx")])
def test_train_cli_on_cpu(tmp_path, capsys, arch, quant):
    from repro_torch.launch.train import main
    hist = main(["--arch", arch, "--device", "cpu", "--steps", "2", "--seq",
                 "32", "--batch", "2", "--quant", quant, "--ckpt-dir",
                 str(tmp_path / "ck")])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert f"{arch} x" in capsys.readouterr().out


def test_remat_changes_no_ssm_gradient(family):
    """SSMLM's remat (each block under ``remat_of``) recomputes the scan in
    the backward; the gradients equal those without it bitwise."""
    _, _, jparams = family["mamba2-1.3b"]
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(512, 3).items()}
    got = []
    for remat in (True, False):
        model = _port("mamba2-1.3b", jparams)
        model = type(model).from_params(replace(model.cfg, remat=remat),
                                        model.params_tree(),
                                        device="cpu").requires_grad_(True)
        model.loss(batch)[0].backward()
        got.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*got):
        assert torch.equal(a, b)
