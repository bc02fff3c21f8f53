"""The port's dense GQA model against the JAX package on bridged weights.

Reduced yi-9b in f32 (``attn_impl="full"``), JAX params from
``PRNGKey(1)`` crossing through numpy.  Logits of ``prefill`` and
``decode_step`` (scalar index and per-row (B,) index) match JAX's at
rtol = atol = 1e-4 over a teacher-forced sequence, in full precision and
under the frozen lut4 / nf4 / nf4p decode trees bridged from JAX's
``quantize_decode_params``.  (The gap is f32 matmul summation order,
~1e-6 here.)
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
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_config

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


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    model = params_from_numpy(_to_numpy(jparams), cfg, "cpu")
    return _Jitted(jmodel), jparams, cfg, model


class _Jitted:
    """The JAX model with prefill/decode_step under ``jax.jit`` (one
    compile per tree structure instead of op-by-op dispatch)."""

    def __init__(self, model):
        self.init_cache = model.init_cache
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)


def _decode_trees(setup, quant):
    jmodel, jparams, cfg, model = setup
    if quant is None:
        return jparams, model
    jq = quantize_decode_params(jparams, quant)
    return jq, params_from_numpy(_to_numpy(jq), cfg, "cpu")


def test_bridge_round_trips_bit_exactly(setup):
    _, jparams, _, model = setup
    want = _to_numpy(jparams)
    got = params_to_numpy(model)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bridge_round_trips_quantized_tree(setup):
    jq, model = _decode_trees(setup, "nf4p")
    want = _to_numpy(jq)
    got = params_to_numpy(model)
    assert got["blocks"]["attn"]["wq"]["kernel"] == "nf4_dc"
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_bridge_bf16_crosses_through_f32():
    """bf16 leaves arrive as bf16 numpy (ml_dtypes) and stay bf16."""
    jcfg = jax_config("yi-9b").reduced(num_layers=1)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("yi-9b").reduced(num_layers=1)
    model = params_from_numpy(_to_numpy(jparams), cfg, "cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks[0].ln1.dtype == torch.float32
    np.testing.assert_array_equal(
        model.blocks[0].attn.wq.float().numpy(),
        np.asarray(jparams["blocks"]["attn"]["wq"][0].astype(jnp.float32)))


@pytest.mark.parametrize("quant", [None, "lut4", "nf4", "nf4p"])
def test_prefill_and_scalar_decode_match_jax(setup, quant):
    """Prefill 6 tokens (full precision), then teacher-force 6 more through
    ``decode_step`` at a shared scalar index."""
    jmodel, jparams, cfg, model = setup
    jdec, tdec = _decode_trees(setup, quant)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 12))
    jc = jmodel.init_cache(2, 16)
    tc = model.init_cache(2, 16)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks[:, :6]), jc)
    with torch.inference_mode():
        tl, tc = model.prefill(torch.from_numpy(toks[:, :6]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for t in range(6, 12):
        jl, jc = jmodel.decode_step(jdec, jnp.asarray(toks[:, t:t + 1]), jc,
                                    jnp.int32(t))
        with torch.inference_mode():
            tl, tc = tdec.decode_step(torch.from_numpy(toks[:, t:t + 1]), tc,
                                      t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"position {t}")


@pytest.mark.parametrize("quant", [None, "lut4", "nf4", "nf4p"])
def test_bucketed_prefill_and_per_row_decode_match_jax(setup, quant):
    """Right-padded prompts of lengths 3 and 7 in one 8-wide bucket, logits
    at each row's ``last_pos``, then per-row (B,) decode positions."""
    jmodel, jparams, cfg, model = setup
    jdec, tdec = _decode_trees(setup, quant)
    rng = np.random.default_rng(1)
    lens = np.array([3, 7])
    toks = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    jc = jmodel.init_cache(2, 20)
    tc = model.init_cache(2, 20)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks), jc,
                            last_pos=jnp.asarray(lens - 1))
    with torch.inference_mode():
        tl, tc = model.prefill(torch.from_numpy(toks), tc,
                               last_pos=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = lens.copy()
    follow = rng.integers(1, cfg.vocab_size, (2, 6))
    for t in range(6):
        tok = follow[:, t:t + 1]
        jl, jc = jmodel.decode_step(jdec, jnp.asarray(tok), jc,
                                    jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            tl, tc = tdec.decode_step(torch.from_numpy(tok), tc,
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")
        pos += 1
    # the slab itself: the port's in-place writes equal JAX's functional ones
    np.testing.assert_allclose(tc[1].k.numpy(), np.asarray(jc[1].k[1]),
                               **TOL)
