"""The port's mamba2 (``models/ssm.py``, ``models/ssm_lm.py``) against the
JAX package on bridged weights.

Reduced mamba2-1.3b in f32 (2 layers, d_model 128, 16 heads of 16, state
16, chunk 32), JAX params from ``PRNGKey(1)`` crossing through numpy.

* The bridge round-trips the mamba2 tree (and its frozen nf4p decode
  tree) bit-exactly.
* ``_causal_conv`` equals JAX's with and without a carried state and a
  per-row ``last_pos`` gather: the output at 1e-6 (``silu`` is evaluated
  by two libraries), the carried window bitwise (it is a gather).
* Prefill logits of right-padded rows at ``last_pos`` and teacher-forced
  ``decode_step`` logits equal JAX's at rtol = atol = 1e-4, in full
  precision and under the frozen lut4 / nf4 / nf4p decode trees, and so
  do the carried conv and SSD states.
* The port of ``test_models_smoke.test_decode_matches_prefill_ssm``: the
  O(1) decode recurrence equals the chunked scan over the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantizedWeight as JQW
from repro.core.quant import quantize_decode_params
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.models.ssm import _causal_conv as jax_causal_conv
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_config
from repro_torch.models.ssm import _causal_conv
from repro_torch.models.ssm_lm import SSMLM

TOL = dict(rtol=1e-4, atol=1e-4)


def _to_numpy(tree):
    """A JAX param tree as numpy; QuantizedWeights as dicts + kernel."""
    if isinstance(tree, JQW):
        d = {f: (None if getattr(tree, f) is None
                 else np.asarray(getattr(tree, f)))
             for f in ("codes", "scale", "zero_point", "hi_tab", "lo_tab",
                       "residual")}
        d["kernel"] = tree.kernel
        return d
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


class _Jitted:
    """The JAX model with prefill/decode_step under ``jax.jit``."""

    def __init__(self, model):
        self.init_cache = model.init_cache
        self.forward = model.forward
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("mamba2-1.3b").reduced(dtype="float32")
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    model = params_from_numpy(_to_numpy(jparams), cfg, "cpu")
    return _Jitted(jmodel), jparams, cfg, model


def _decode_trees(setup, quant):
    _, jparams, cfg, model = setup
    if quant is None:
        return jparams, model
    jq = quantize_decode_params(jparams, quant)
    return jq, params_from_numpy(_to_numpy(jq), cfg, "cpu")


def test_bridge_round_trips_bit_exactly(setup):
    _, jparams, _, model = setup
    assert isinstance(model, SSMLM) and len(model.blocks) == 2
    want = _to_numpy(jparams)
    got = params_to_numpy(model)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bridge_round_trips_quantized_tree(setup):
    jq, model = _decode_trees(setup, "nf4p")
    got = params_to_numpy(model)
    assert got["blocks"]["m"]["w_in"]["kernel"] == "nf4_dc"
    assert got["blocks"]["m"]["conv_w"].dtype == np.float32   # not frozen
    for a, b in zip(jax.tree.leaves(_to_numpy(jq)), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_last_pos", [False, True])
def test_causal_conv_matches_jax(with_state, with_last_pos):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 9, 24)).astype(np.float32)
    w = (rng.normal(size=(4, 24)) * 0.2).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    state = rng.normal(size=(3, 3, 24)).astype(np.float32)
    last_pos = np.array([8, 0, 4])
    jy, js = jax_causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(state) if with_state else None,
        last_pos=jnp.asarray(last_pos) if with_last_pos else None)
    ty, ts = _causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(state) if with_state else None,
        last_pos=torch.from_numpy(last_pos) if with_last_pos else None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant", [None, "lut4", "nf4", "nf4p"])
def test_bucketed_prefill_and_decode_match_jax(setup, quant):
    """Right-padded prompts of lengths 3 and 7 in one 8-wide bucket, logits
    at each row's ``last_pos`` (masked SSD scan + per-row conv gather),
    then 6 teacher-forced decode steps through the (frozen) decode tree."""
    jmodel, jparams, cfg, model = setup
    jdec, tdec = _decode_trees(setup, quant)
    rng = np.random.default_rng(1)
    lens = np.array([3, 7])
    toks = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_cache(2, 16),
                            last_pos=jnp.asarray(lens - 1))
    with torch.inference_mode():
        tl, tc = model.prefill(torch.from_numpy(toks), model.init_cache(2, 16),
                               last_pos=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    follow = rng.integers(1, cfg.vocab_size, (2, 6))
    for t in range(6):
        tok = follow[:, t:t + 1]
        jl, jc = jmodel.decode_step(jdec, jnp.asarray(tok), jc,
                                    jnp.asarray(lens + t, jnp.int32))
        with torch.inference_mode():
            tl, tc = tdec.decode_step(torch.from_numpy(tok), tc,
                                      torch.from_numpy(lens + t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")
    for i, layer in enumerate(tc):
        np.testing.assert_allclose(layer.conv.numpy(), np.asarray(jc.conv[i]),
                                   **TOL)
        np.testing.assert_allclose(layer.state.numpy(),
                                   np.asarray(jc.state[i]), **TOL)


def test_padded_row_carries_its_exact_prefix_state(setup):
    """A row prefilled right-padded in a wider bucket carries the same
    (conv, state) as the same prompt prefilled at its exact length."""
    _, _, cfg, model = setup
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (1, 11))
    padded = np.zeros((1, 16), np.int64)
    padded[:, :11] = toks
    with torch.inference_mode():
        lp, cp = model.prefill(torch.from_numpy(padded),
                               model.init_cache(1, 16),
                               last_pos=torch.tensor([10]))
        le, ce = model.prefill(torch.from_numpy(toks), model.init_cache(1, 16))
    np.testing.assert_allclose(lp.numpy(), le.numpy(), **TOL)
    for a, b in zip(cp, ce):
        np.testing.assert_array_equal(a.conv.numpy(), b.conv.numpy())
        np.testing.assert_allclose(a.state.numpy(), b.state.numpy(), **TOL)


def test_decode_matches_prefill(setup):
    """Step decode recurrence == chunked SSD outputs (the port of
    ``test_models_smoke.test_decode_matches_prefill_ssm``, its tolerance)."""
    _, _, cfg, model = setup
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 32)))
    with torch.inference_mode():
        hidden, _ = model(toks)
        full = model.logits(hidden)[0]
        state = model.init_cache(1, 32)
        outs = []
        for i in range(32):
            lg, state = model.decode_step(toks[:, i:i + 1], state, i)
            outs.append(lg[0, 0])
    np.testing.assert_allclose(torch.stack(outs).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_bf16_model_tracks_its_f32_copy():
    """The served dtype: a bf16 mamba2 (bf16 activations, f32 SSD state and
    scan) prefills right-padded rows and decodes, and its logits stay
    within bf16 rounding (5e-2 absolute at logits of magnitude ~3) of the
    same weights run in f32."""
    from repro_torch.models.registry import get_model
    cfg = get_config("mamba2-1.3b").reduced()
    model = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    f32 = SSMLM.from_params(
        get_config("mamba2-1.3b").reduced(dtype="float32"),
        jax.tree.map(lambda t: t.float(), model.params_tree()), device="cpu")
    toks = torch.randint(1, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    last = torch.tensor([39, 20])
    with torch.inference_mode():
        lb, cb = model.prefill(toks, model.init_cache(2, 8), last_pos=last)
        lf, cf = f32.prefill(toks, f32.init_cache(2, 8), last_pos=last)
        assert lb.dtype == torch.bfloat16 and cb[0].state.dtype == torch.float32
        np.testing.assert_allclose(lb.float().numpy(), lf.numpy(), atol=5e-2)
        lb, _ = model.decode_step(toks[:, :1], cb, last + 1)
        lf, _ = f32.decode_step(toks[:, :1], cf, last + 1)
        np.testing.assert_allclose(lb.float().numpy(), lf.numpy(), atol=5e-2)
