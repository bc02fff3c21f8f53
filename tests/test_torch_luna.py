"""The port's LUNA core, quantizers and model-level ``quant_matmul`` against
the JAX package.

* ``core/luna.py``: ``luna_product`` over all 16x16 (w, y) code pairs and
  ``luna_matmul`` in every mode, bitwise; the digit helpers and the table
  analyses (error tables, MAE, Fig 3 storage, Figs 5/6 statistics) equal.
* ``core/quant.py``: ``luna_matmul_f32`` and ``quant_error`` at
  rtol = atol = 1e-5 (in practice bitwise: the same f32 operations in the
  same order).
* ``core/layers.py``: ``quant_matmul`` for every ``QUANT_MODES`` entry at
  1e-5, ``QuantConfig`` validation, and a reduced f32 yi-9b's prefill and
  decode logits under each ``luna_*`` mode and ``lut_nf4`` at 1e-4 (f32
  matmul summation order).

``quant_matmul`` on the card against the CPU: ``tests/test_torch_cuda.py``.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import luna as jl
from repro.core import quant as jq
from repro.core.layers import QUANT_MODES as JAX_QUANT_MODES
from repro.core.layers import QuantConfig as JaxQuantConfig
from repro.core.layers import quant_matmul as jax_quant_matmul
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch.bridge import params_from_numpy
from repro_torch.core import luna as tl
from repro_torch.core import quant as tq
from repro_torch.core.layers import LUNA_MODE_OF, QUANT_MODES, QuantConfig
from repro_torch.core.layers import quant_matmul
from repro_torch.models.registry import get_config

MODES = [m.value for m in tl.LunaMode]
MODEL_MODES = ["luna_conventional", "luna_dc", "luna_approx", "luna_approx2",
               "lut_nf4"]


def _codes(shape, bits=4, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape)


@pytest.mark.parametrize("mode", MODES)
def test_luna_product_all_pairs_bitwise(mode):
    w, y = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    want = np.asarray(jl.luna_product(jnp.asarray(w), jnp.asarray(y), 4,
                                      mode))
    got = tl.luna_product(torch.from_numpy(w), torch.from_numpy(y), 4, mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_luna_matmul_bitwise(mode, bits):
    y = _codes((2, 3, 40), bits, seed=1)
    w = _codes((40, 24), bits, seed=2)
    want = np.asarray(jl.luna_matmul(jnp.asarray(y, jnp.int32),
                                     jnp.asarray(w, jnp.int32), bits, mode))
    got = tl.luna_matmul(torch.from_numpy(y).int(), torch.from_numpy(w).int(),
                         bits, mode)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_digit_split_and_combine_match():
    codes = _codes((5, 7), 8, seed=3)
    jd = jl.split_digits(jnp.asarray(codes, jnp.int32), 8)
    td = tl.split_digits(torch.from_numpy(codes).int(), 8)
    assert len(jd) == len(td) == tl.num_digits(8) == 4
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tl.combine_partials(td).numpy(), codes)
    with pytest.raises(ValueError, match="not divisible"):
        tl.num_digits(5)


@pytest.mark.parametrize("mode", MODES)
def test_error_table_and_mae_equal(mode):
    np.testing.assert_array_equal(tl.error_table(tl.LunaMode(mode)),
                                  jl.error_table(jl.LunaMode(mode)))
    assert tl.mean_abs_error(mode) == jl.mean_abs_error(mode)
    assert tl.LunaMode(mode).is_exact == jl.LunaMode(mode).is_exact


def test_table_analyses_equal():
    for w in range(16):
        st = tl.optimized_table_storage(w)
        assert st == jl.optimized_table_storage(w)
        assert tl.optimized_table_reconstruct(st) == [0, w, 2 * w, 3 * w]
    for a, b in zip(tl.lsb_product_distribution(),
                    jl.lsb_product_distribution()):
        np.testing.assert_array_equal(a, b)
    assert tl.impossible_lsb_products() == jl.impossible_lsb_products()
    for a, b in zip(tl.hamming_distance_profile(),
                    jl.hamming_distance_profile()):
        np.testing.assert_array_equal(a, b)


def _xw(seed=0, shape=(2, 5, 64), n=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(shape[-1], n)) / 8).astype(np.float32)
    return x, w


@pytest.mark.parametrize("mode", MODES)
def test_luna_matmul_f32_matches_jax(mode):
    x, w = _xw(1)
    want = np.asarray(jq.luna_matmul_f32(jnp.asarray(x), jnp.asarray(w),
                                         mode))
    got = tq.luna_matmul_f32(torch.from_numpy(x), torch.from_numpy(w), mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_quant_error_matches_jax():
    x, _ = _xw(2)
    jqp = jq.calibrate(jnp.asarray(x), 4)
    tqp = tq.calibrate(torch.from_numpy(x), 4)
    np.testing.assert_allclose(tq.quant_error(torch.from_numpy(x), tqp),
                               np.asarray(jq.quant_error(jnp.asarray(x),
                                                         jqp)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quant_matmul_matches_jax(mode):
    x, w = _xw(3)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(w),
                                       JaxQuantConfig(mode=mode)))
    got = quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       QuantConfig(mode=mode))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_quant_config_validation_and_targets():
    with pytest.raises(ValueError, match="unknown quant mode 'fp3'"):
        QuantConfig(mode="fp3")
    assert QUANT_MODES == JAX_QUANT_MODES
    assert {k: v.value for k, v in LUNA_MODE_OF.items()} == {
        "luna_conventional": "conventional", "luna_dc": "opt_dc",
        "luna_approx": "approx_dc", "luna_approx2": "approx_dc2"}
    qc = QuantConfig(mode="luna_dc", targets=("mlp",))
    assert qc.applies("mlp") and not qc.applies("attn")
    assert not QuantConfig().applies("mlp")
    # a group outside the targets stays a plain matmul
    x, w = _xw(4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(quant_matmul(xt, wt, qc, "attn"), xt @ wt)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(1))
    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("mode", MODEL_MODES)
def test_reduced_model_logits_match_jax(reduced, mode):
    """Prefill (B=2, S=12) then three decode steps, teacher-forced."""
    jcfg, jparams, cfg, model = reduced
    jcfg = replace(jcfg, quant=JaxQuantConfig(mode=mode))
    jm = jax_model(jcfg)
    tm = type(model).from_params(replace(cfg, quant=QuantConfig(mode=mode)),
                                 model.params_tree(), device="cpu")
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, 16))
    jc = jm.init_cache(2, 32)
    jlog, jc = jax.jit(jm.prefill)(jparams, jnp.asarray(toks[:, :12]), jc)
    with torch.inference_mode():
        tc = tm.init_cache(2, 32)
        tlog, tc = tm.prefill(torch.from_numpy(toks[:, :12]), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4)
        step = jax.jit(jm.decode_step)
        for i in range(12, 15):
            jlog, jc = step(jparams, jnp.asarray(toks[:, i:i + 1]), jc, i)
            tlog, tc = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                      tc, i)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=1e-4, atol=1e-4)
