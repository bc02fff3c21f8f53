"""The encdec and vlm families (whisper-base, llava-next-mistral-7b)
through the port against the JAX package.

Reduced f32 configs (whisper: 2 encoder + 2 decoder layers over 64
stubbed frames; llava: 2 layers after 16 stubbed patches), JAX params
from ``PRNGKey(1)`` crossing through numpy, inputs from numpy with a
seed, in the shapes of ``input_specs``:

* the configs, their ``reduced()`` and ``input_specs`` equal JAX's;
* the bridge round-trips both trees bitwise;
* logits within 1e-4 (whisper's decoder at S = 48 over 64 frames, so
  the cross-attention's lengths differ; llava's [patches; text]);
* the loss (1e-5) and every leaf's gradient (``GRAD_REL`` of its leaf's
  scale) against ``jax.value_and_grad`` of JAX's loss, remat on; one
  ``make_train_step`` step, whole and in two microbatches, against
  JAX's (``tests/test_torch_train_families.py``'s bounds);
* ``prefill`` then teacher-forced ``decode_step`` logits within 1e-4, and
  greedy tokens equal JAX's (llava's decode index counts the patches);
* whisper under ``attn_impl="flash"``: the loss equals JAX's at S =
  ``enc_seq`` (the one length at which JAX's cross-attention reaches its
  kernel), and both raise at S = 32 (``TypeError``: k/v reshaped to the
  query's length) and at ``enc_seq`` = 300 (JAX's ``s % bq`` assertion,
  the port's ``check_tiling``);
* whisper under ``lut_nf4`` (prefill and decode logits at 1e-4, as
  ``test_torch_luna.py``) and under ``luna_approx`` (the STE: the loss at
  1e-5, every gradient at the STE's ``LUNA_GRAD_REL`` of
  ``card_vs_cpu``: JAX's own gradients move past ``GRAD_REL`` when its
  weights move by 1e-7, asserted there);
* both engines refuse both families; ``loss`` on a ``SyntheticLM`` batch
  raises ``KeyError`` in both packages, and so does the port's train
  CLI (JAX's feeds the same batches); the ``Trainer`` trains both on a
  stream that carries ``frames`` / ``patches`` and resumes.
"""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ALL_SHAPES as JAX_SHAPES
from repro.core.layers import QuantConfig as JQuantConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.models.registry import input_specs as jax_input_specs
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro.serve.config import EngineConfig as JEngineConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.core.layers import QuantConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.common import CacheSpec, dtype_of
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import get_config, input_specs
from repro_torch.models.vlm import VLM
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.serve.config import EngineConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_map

GRAD_REL = 1e-4
#: whisper's gradients under luna_approx (the STE): within LUNA_GRAD_REL
#: (``card_vs_cpu``'s STE bound) of max(the leaf's scale, LUNA_FLOOR x
#: the tree's largest gradient)
LUNA_GRAD_REL = 1e-3
LUNA_FLOOR = 1e-3
ARCHS = ("whisper-base", "llava-next-mistral-7b")
B, S = 2, 48            # whisper's decoder length; llava's total (P + text)


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
    """arch -> (JAX cfg, JAX model, JAX params, numpy params), reduced
    f32, built once."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_config(arch).reduced(dtype="float32")
        jmodel = jax_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
        out[arch] = (jcfg, jmodel, jparams, _np_tree(jparams))
    return out


def _cfg(arch, **over):
    return get_config(arch).reduced(dtype="float32", **over)


def _port(family, arch, **over):
    return params_from_numpy(family[arch][3], _cfg(arch, **over),
                             "cpu").requires_grad_(True)


def _batch(cfg, seed, s=S):
    """A train batch in ``input_specs``' shapes (whisper: S tokens over
    ``enc_seq`` frames; llava: ``num_patches`` patches, S - P tokens),
    frames / patches N(0, 1), ids in [0, vocab)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["tokens"] = toks[:, :-1]
        batch["frames"] = rng.normal(
            size=(B, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    else:
        p = cfg.vlm.num_patches
        batch["tokens"] = toks[:, p:-1]
        batch["patches"] = rng.normal(
            size=(B, p, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def _grads_numpy(model) -> dict:
    return params_to_numpy(type(model).from_params(
        model.cfg, tree_map(lambda p: p.grad, model.params_tree()),
        device="cpu"))


# ---------------------------------------------------------------------------
# configs, specs, bridge
# ---------------------------------------------------------------------------

def _fields(cfg) -> dict:
    d = asdict(cfg)
    d.pop("quant")
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_equal_jax(arch):
    for reduced in (False, True):
        got = _cfg(arch) if reduced else get_config(arch)
        want = (jax_config(arch).reduced(dtype="float32") if reduced
                else jax_config(arch))
        # JAX's scan knob is the one field without a counterpart: the port
        # unrolls its layers in Python (serve_param_sharding came with the
        # launch tools, which read it)
        jf = {k: v for k, v in _fields(want).items() if k in _fields(got)}
        assert _fields(got) == jf
        assert set(_fields(want)) - set(_fields(got)) == {"scan_layers"}


@pytest.mark.parametrize("arch", ARCHS + ("yi-9b",))
def test_input_specs_equal_jax(arch):
    for reduced in (False, True):
        cfg, jcfg = get_config(arch), jax_config(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for shape, jshape in zip(ALL_SHAPES, JAX_SHAPES):
            assert asdict(shape) == {k: getattr(jshape, k) for k in
                                     ("name", "seq_len", "global_batch",
                                      "kind")}
            got = input_specs(cfg, shape, batch=3)
            want = jax_input_specs(jcfg, jshape, batch=3)
            assert list(got) == list(want)
            for k, (shp, dt) in got.items():
                assert shp == want[k].shape, (arch, shape.name, k)
                assert str(dt).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_bitwise(family, arch):
    tree = family[arch][3]
    model = params_from_numpy(tree, _cfg(arch), "cpu")
    assert isinstance(model, EncDecLM if arch == "whisper-base" else VLM)
    back = params_to_numpy(model)
    wl, gl = (jax.tree_util.tree_leaves_with_path(t) for t in (tree, back))
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, want), (_, got) in zip(wl, gl):
        np.testing.assert_array_equal(got, want, err_msg=str(path))


# ---------------------------------------------------------------------------
# forward, loss, gradients, train step
# ---------------------------------------------------------------------------

def _jax_logits(jmodel, jparams, batch):
    if hasattr(jmodel, "encode"):
        enc = jmodel.encode(jparams, batch["frames"])
        hidden, _ = jmodel.decode(jparams, batch["tokens"], enc)
    else:
        embeds = jmodel._merge(jparams, batch["patches"], batch["tokens"])
        hidden, _, _ = jmodel.backbone.forward(jparams, embeds=embeds)
    return hidden @ jparams["lm_head"]


def _port_logits(model, batch):
    if isinstance(model, EncDecLM):
        hidden, _ = model.decode(batch["tokens"],
                                 model.encode(batch["frames"]))
        return model.logits(hidden)
    embeds = model._merge(batch["patches"], batch["tokens"])
    hidden, _ = model.backbone.forward(embeds=embeds)
    return model.backbone.logits(hidden)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(family, arch):
    jcfg, jmodel, jparams, _ = family[arch]
    batch = _batch(jcfg, 3)
    want = np.asarray(jax.jit(lambda p, b: _jax_logits(jmodel, p, b))(
        jparams, _jax(batch)))
    with torch.no_grad():
        got = _port_logits(_port(family, arch), _torch(batch))
    assert got.shape == want.shape == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _loss_and_grads(family, arch, quant="bf16", rel=GRAD_REL, floor=0.0):
    """The loss (1e-5) and every leaf's gradient against JAX's: within
    ``rel`` of max(the leaf's max |jax|, ``floor`` x the tree's largest).
    With a ``floor``, returns JAX's gradients on the batch and on the
    same weights under 1e-7 relative noise, and the tree's largest, for
    the caller's reading of JAX's own spread."""
    jcfg, _, jparams, _ = family[arch]
    jcfg = replace(jcfg, quant=JQuantConfig(mode=quant))
    jmodel = jax_model(jcfg)
    assert jcfg.remat
    batch = _batch(jcfg, 7)
    value_and_grad = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    (jloss, jparts), jgrads = value_and_grad(jparams, _jax(batch))
    model = _port(family, arch, quant=QuantConfig(mode=quant))
    loss, parts = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(parts) == set(jparts) == {"xent"}
    np.testing.assert_allclose(parts["xent"].item(), float(jparts["xent"]),
                               rtol=1e-5)
    jflat = jax.tree_util.tree_leaves_with_path(_np_tree(jgrads))
    gflat = jax.tree.leaves(_grads_numpy(model))
    assert len(gflat) == len(jflat)
    tree_max = max(np.abs(w).max() for _, w in jflat)
    for got, (path, want) in zip(gflat, jflat):
        name = jax.tree_util.keystr(path)
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), floor * tree_max, 1e-30)
        err = np.abs(got.astype(np.float64) - want).max()
        assert err <= rel * scale, f"{arch} {quant} {name}: {err} > " \
                                   f"{rel} * {scale}"
        if "cross_attn" in name or "enc_blocks" in name:
            assert np.abs(want).max() > 0, name       # the encoder's path
    if not floor:
        return None
    noise = np.random.default_rng(0)
    noisy = jax.tree.map(lambda a: a * (1 + 1e-7 * noise.standard_normal(
        a.shape).astype(np.float32)), jparams)
    _, jgrads_noisy = value_and_grad(noisy, _jax(batch))
    return jflat, jax.tree.leaves(_np_tree(jgrads_noisy)), tree_max


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_jax(family, arch):
    _loss_and_grads(family, arch)


def test_whisper_luna_approx_loss_and_grads_match_jax(family):
    """The STE on every projection (``ste_luna_matmul``): the loss at
    1e-5, the gradients at ``LUNA_GRAD_REL``.  The STE's forward is
    piecewise constant, and f32 sums in another order move an activation
    across a code boundary here and there (``card_vs_cpu.LUNA_GRAD_REL``'s
    reason, between devices).  In whisper that shows more than in yi-9b:
    the 4-bit approximate encoder's output is nearly constant over
    positions, so many leaves reach the loss through near-cancelling sums
    (the cross-attention's wq and wk gradients are ~1e-7 of the tree's
    largest), and JAX's own gradients move past ``GRAD_REL`` of their
    scale when its weights move by 1e-7: asserted below.  So each leaf is
    held within ``LUNA_GRAD_REL`` of max(its scale, ``LUNA_FLOOR`` x the
    tree's largest)."""
    jflat, noisy, tree_max = _loss_and_grads(
        family, "whisper-base", "luna_approx", LUNA_GRAD_REL, LUNA_FLOOR)
    spread = max(np.abs(b - a).max() / np.abs(a).max()
                 for (_, a), b in zip(jflat, noisy)
                 if np.abs(a).max() >= LUNA_FLOOR * tree_max)
    assert spread > GRAD_REL
class FrameStream:
    """A data stream of the family's batches (``SyntheticLM``'s tokens and
    labels plus frames / patches from a numpy seed per step), as JAX's
    Trainer is fed for these families."""

    def __init__(self, cfg, s, seed=0):
        self.cfg, self.s, self.seed = cfg, s, seed

    def batch_np(self, step):
        return _batch(self.cfg, self.seed * 1000 + step, self.s)

    def batch(self, step, device=None):
        return {k: v.to(device) for k, v in
                _torch(self.batch_np(step)).items()}


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(family, arch, microbatch):
    jcfg, _, jparams, _ = family[arch]
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(**kw, schedule=jax_cosine(1, 3))
    jstep, _ = jax_make_train_step(jcfg, jopt, None, microbatch=microbatch)
    b0 = FrameStream(jcfg, 32).batch_np(0)
    new, _, jm = jax.jit(jstep)(jparams, jopt.init(jparams), _jax(b0))
    model = _port(family, arch)
    # the whole batch's gradient: two equal microbatches of equal masked
    # counts average to it; held to JAX's by the test above
    model.loss(_torch(b0))[0].backward()
    grads = _grads_numpy(model)
    model.zero_grad(set_to_none=True)
    opt = AdamW(**kw, schedule=cosine_schedule(1, 3))
    m = make_train_step(model.cfg, opt, microbatch=microbatch)(
        model, opt.init(model.params_tree()), _torch(b0))
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
        # Adam's first step is ~lr * sign(g): elements whose gradient lies
        # within the gradient bound of 0 are held to the one-step bound
        settled = np.abs(g) > GRAD_REL * np.abs(g).max()
        np.testing.assert_allclose(a[settled], b[settled], rtol=1e-4,
                                   atol=1e-4)
        assert np.abs(a - b).max() <= 2 * kw["lr"]
        moved += not np.array_equal(a, old)
    assert moved == len(jax.tree.leaves(jparams))


# ---------------------------------------------------------------------------
# serving: prefill, decode_step, greedy
# ---------------------------------------------------------------------------

def _modality(cfg, batch):
    key = "frames" if cfg.family == "encdec" else "patches"
    return key, batch[key]


#: (arch, quant) -> JAX's model and its jitted prefill and decode_step,
#: compiled once for the module's tests
_JAX_SERVING = {}


def _decode_run(family, arch, quant="bf16", steps=4, greedy=False):
    """Prefill of a 12-token prompt (B = 2), then ``steps`` decode steps
    teacher-forced (or greedy) in both packages; returns the logits of
    each call (port, JAX) and the tokens fed."""
    jcfg, _, jparams, _ = family[arch]
    jcfg = replace(jcfg, quant=JQuantConfig(mode=quant))
    batch = _batch(jcfg, 5, s=jcfg.vlm.num_patches + 16 if jcfg.vlm else 16)
    key, extra = _modality(jcfg, batch)
    if (arch, quant) not in _JAX_SERVING:
        jm = jax_model(jcfg)
        _JAX_SERVING[arch, quant] = (jm, jax.jit(
            lambda p, t, c, x: jm.prefill(p, t, c, **{key: x})),
            jax.jit(jm.decode_step))
    jm, prefill, step = _JAX_SERVING[arch, quant]
    tm = _port(family, arch, quant=QuantConfig(mode=quant))
    prompt, nxt = batch["tokens"][:, :12], batch["tokens"][:, 12:]
    off = jcfg.vlm.num_patches if jcfg.vlm else 0   # the patches count
    s_max = off + 12 + 12                           # room for 12 steps
    jlog, jstate = prefill(jparams, jnp.asarray(prompt),
                           jm.init_cache(B, s_max), jnp.asarray(extra))
    out, fed = [], []
    with torch.inference_mode():
        tlog, tstate = tm.prefill(torch.from_numpy(prompt).long(),
                                  tm.init_cache(B, s_max),
                                  **{key: torch.from_numpy(extra)})
        for i in range(steps + 1):
            out.append((tlog.numpy(), np.asarray(jlog)))
            if i == steps:
                break
            tok = (np.asarray(jlog).argmax(-1).astype(np.int32) if greedy
                   else nxt[:, i:i + 1])
            if greedy:
                np.testing.assert_array_equal(tlog.argmax(-1).numpy(), tok)
            fed.append(tok)
            index = off + 12 + i
            jlog, jstate = step(jparams, jnp.asarray(tok), jstate, index)
            tlog, tstate = tm.decode_step(torch.from_numpy(tok).long(),
                                          tstate, index)
    return out, fed


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(family, arch):
    out, _ = _decode_run(family, arch)
    for got, want in out:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(family, arch):
    out, fed = _decode_run(family, arch, steps=8, greedy=True)
    assert len(fed) == 8
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_whisper_lut_nf4_logits_match_jax(family):
    """lut_nf4 on every projection (the NF4 codebook through the LUT):
    prefill and decode logits at ``test_torch_luna.py``'s 1e-4."""
    out, _ = _decode_run(family, "whisper-base", "lut_nf4", steps=3)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_per_row_decode_equals_scalar_decode(family):
    """A (B,) index tensor of equal positions decodes as the scalar index
    (whisper's and llava's self-attention caches written per row)."""
    for arch in ARCHS:
        cfg = _cfg(arch)
        tm = _port(family, arch)
        batch = _torch(_batch(cfg, 4, s=cfg.vlm.num_patches + 8
                              if cfg.vlm else 8))
        key, extra = _modality(cfg, batch)
        off = cfg.vlm.num_patches if cfg.vlm else 0
        got = []
        with torch.inference_mode():
            for index in (off + 8, torch.full((B,), off + 8)):
                _, state = tm.prefill(batch["tokens"], tm.init_cache(B, 40),
                                      **{key: extra})
                logits, _ = tm.decode_step(batch["tokens"][:, -1:], state,
                                           index)
                got.append(logits)
        torch.testing.assert_close(got[1], got[0], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# whisper under flash
# ---------------------------------------------------------------------------

def test_whisper_flash_runs_where_jax_runs(family):
    """S = enc_seq (64): the cross-attention's q and k/v share one length,
    so JAX's flash route (its Pallas kernel in interpret mode) and the
    port's (the kernel's plain version on the CPU) both run; the losses
    agree, and with the chunked loss."""
    jcfg, _, jparams, _ = family["whisper-base"]
    batch = _batch(jcfg, 9, s=jcfg.encdec.enc_seq)
    jloss, _ = jax.jit(jax_model(replace(jcfg, attn_impl="flash")).loss)(
        jparams, _jax(batch))
    with torch.no_grad():
        loss, _ = _port(family, "whisper-base", attn_impl="flash").loss(
            _torch(batch))
        chunked, _ = _port(family, "whisper-base").loss(_torch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), chunked.item(), rtol=1e-5)


def test_whisper_flash_raises_where_jax_raises(family):
    """S = 32 over 64 frames: JAX's mha reshapes k/v to the query's length
    and fails (``TypeError``), and so does the port's.  enc_seq = 300:
    the encoder's S fails JAX's tiling assertion (``s % bq``, bq = 256),
    and the port's ``check_tiling`` (``ValueError``), as at whisper's
    full 1,500 frames."""
    jcfg, _, jparams, _ = family["whisper-base"]
    jflash = jax_model(replace(jcfg, attn_impl="flash"))
    batch = _batch(jcfg, 9, s=32)
    port = _port(family, "whisper-base", attn_impl="flash")
    with pytest.raises(TypeError, match="reshape"):
        jflash.loss(jparams, _jax(batch))
    with torch.no_grad(), pytest.raises(TypeError, match="reshape"):
        port.loss(_torch(batch))
    frames = np.zeros((B, 300, jcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jflash.encode(jparams, jnp.asarray(frames))
    with torch.no_grad(), pytest.raises(ValueError, match="divisible"):
        port.encode(torch.from_numpy(frames))


# ---------------------------------------------------------------------------
# what the families refuse, the trainer and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engines_and_paged_specs_refuse_both_families(family, arch):
    fam = get_config(arch).family
    with pytest.raises(ValueError, match="modality"):
        JEngineConfig().validate(fam)
    with pytest.raises(ValueError, match="modality"):
        EngineConfig().validate(fam)
    model = _port(family, arch)
    jm = family[arch][1]
    from repro.models.common import CacheSpec as JCacheSpec
    with pytest.raises(ValueError, match="paged"):
        jm.init_cache(1, 16, spec=JCacheSpec(block_size=8, num_blocks=4))
    with pytest.raises(ValueError, match="paged"):
        model.init_cache(1, 16, spec=CacheSpec(block_size=8, num_blocks=4))


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_raises_key_error_in_both(family, arch):
    """``SyntheticLM``'s batches carry no frames / patches: ``loss`` raises
    ``KeyError`` in both packages (so does JAX's CLI, which feeds them)."""
    jcfg, jmodel, jparams, _ = family[arch]
    key = "frames" if jcfg.family == "encdec" else "patches"
    jb = JSyntheticLM(jcfg.vocab_size, 16, B, seed=0).batch(0)
    with pytest.raises(KeyError, match=key):
        jmodel.loss(jparams, jb)
    tb = SyntheticLM(jcfg.vocab_size, 16, B, seed=0).batch(0, "cpu")
    with pytest.raises(KeyError, match=key):
        _port(family, arch).loss(tb)


def test_train_cli_fails_on_synthetic_batches_as_jax(tmp_path):
    from repro_torch.launch.train import main
    with pytest.raises(KeyError, match="frames"):
        main(["--arch", "whisper-base", "--device", "cpu", "--steps", "1",
              "--seq", "16", "--batch", "2", "--ckpt-dir",
              str(tmp_path / "ck")])


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_trains_and_resumes(tmp_path, capsys, arch):
    cfg = _cfg(arch)
    data = FrameStream(cfg, 32)
    assert data.batch(0, "cpu")[
        "frames" if arch == "whisper-base" else "patches"].dtype == \
        dtype_of(cfg)
    hist = {}
    for total in (2, 3):
        tcfg = TrainerConfig(total_steps=total, ckpt_every=2, log_every=1,
                             ckpt_dir=str(tmp_path / "ck"), lr=3e-3,
                             warmup=1)
        model, hist[total] = Trainer(cfg, tcfg, device="cpu").run(
            data, install_signals=False)
    assert len(hist[2]) == 2 and len(hist[3]) == 1
    assert all(np.isfinite(hist[2] + hist[3]))
    assert "resumed from step 2" in capsys.readouterr().out
    assert isinstance(model, EncDecLM if arch == "whisper-base" else VLM)


@pytest.mark.parametrize("arch", ARCHS)
def test_card_vs_cpu_check_runs_on_the_cpu(arch):
    """``card_vs_cpu.modality_card_vs_cpu`` (the card tests' and
    ``chip_smoke.py`` phase 4's check) with the CPU as its "card": the
    same model twice, every error 0."""
    from repro_torch.train.card_vs_cpu import modality_card_vs_cpu
    out = modality_card_vs_cpu("cpu", arch)
    assert set(out) == {"loss", "grads (scaled)", "train_step params",
                        "prefill + decode logits"}
    assert all(v == 0.0 for v in out.values())
