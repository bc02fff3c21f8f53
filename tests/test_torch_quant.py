"""The port's quantizers against the JAX package, bitwise.

Codes, scales and zero points of ``calibrate``/``quantize``/
``quantize_weight`` equal JAX's bit for bit (both round half to even, both
encoders keep the first nearest codebook entry); the NF4 D&C tables match
at 0 ulp; ``quantize_decode_params`` freezes exactly the same leaf paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import quant as jq
from repro.core.quant import QuantizedWeight as JQW
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch.bridge import params_from_numpy
from repro_torch.core import lut as tlut
from repro_torch.core import quant as tq
from repro_torch.models.registry import get_config

QW_FIELDS = ("codes", "scale", "zero_point", "hi_tab", "lo_tab", "residual")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_qw_equal(a, b):
    """JAX QuantizedWeight ``a`` == port QuantizedWeight ``b``, bitwise."""
    assert a.kernel == b.kernel
    for f in QW_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
            continue
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=f)
        assert _np(x).dtype == _np(y).dtype, f


@pytest.mark.parametrize("kernel,prune", [
    ("lut_dc", None), ("dequant", None), ("nf4_dc", None),
    ("nf4_dc", tq.NF4P_PRUNE_THRESHOLD), ("nf4_dequant", None)])
def test_quantize_weight_bitwise_equals_jax(kernel, prune):
    """Stacked (L, K, N) leaves, ragged widths: every child bitwise."""
    w = np.random.default_rng(0).normal(size=(3, 72, 40)).astype(np.float32)
    _assert_qw_equal(jq.quantize_weight(jnp.asarray(w), kernel, prune),
                     tq.quantize_weight(torch.from_numpy(w), kernel, prune))


@pytest.mark.parametrize("axis,symmetric", [(None, False), (-1, False),
                                            (-1, True)])
def test_calibrate_quantize_bitwise_equals_jax(axis, symmetric):
    x = np.random.default_rng(1).normal(size=(33, 17)).astype(np.float32)
    a = jq.calibrate(jnp.asarray(x), 4, axis=axis, symmetric=symmetric)
    b = tq.calibrate(torch.from_numpy(x), 4, axis=axis, symmetric=symmetric)
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    np.testing.assert_array_equal(np.asarray(a.zero_point),
                                  b.zero_point.numpy())
    np.testing.assert_array_equal(np.asarray(jq.quantize(jnp.asarray(x), a)),
                                  tq.quantize(torch.from_numpy(x), b).numpy())
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize(jq.quantize(jnp.asarray(x), a), a)),
        tq.dequantize(tq.quantize(torch.from_numpy(x), b), b).numpy())


def test_rounding_is_half_to_even_in_both():
    """Codes exactly at .5 (scale 1, zero point 0) round to even."""
    x = np.array([0.0, 0.5, 1.5, 2.5, 3.5, 14.5, 15.0], np.float32)
    a = jq.calibrate(jnp.asarray(x), 4)
    b = tq.calibrate(torch.from_numpy(x), 4)
    assert float(a.scale) == float(b.scale) == 1.0
    want = [0, 0, 2, 2, 4, 14, 15]
    assert np.asarray(jq.quantize(jnp.asarray(x), a)).tolist() == want
    assert tq.quantize(torch.from_numpy(x), b).tolist() == want


def test_nf4_encoder_takes_first_minimum_on_ties():
    """A weight exactly halfway between NF4 entries 7 (0.0) and 8 is
    equidistant in f32; both encoders pick entry 7."""
    cb = jlut.NF4_CODEBOOK
    mid = np.float32(cb[8] / 2)
    assert mid - cb[7] == cb[8] - mid            # a true tie in f32
    w = np.array([[1.0], [mid], [-mid]], np.float32)   # absmax 1 -> wn = w
    a = jq.quantize_weight(jnp.asarray(w), "nf4_dc")
    b = tq.quantize_weight(torch.from_numpy(w), "nf4_dc")
    np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
    assert b.codes[1, 0].item() == 7
    assert int(np.asarray(jnp.argmin(jnp.abs(jnp.asarray(mid) - cb)))) == 7


def test_dc_decompose_nf4_zero_ulp():
    """The NF4 split the engine decodes with: 0 ulp (the port sums the
    grand mean in XLA's order)."""
    a = jlut.dc_decompose_codebook(jnp.asarray(jlut.NF4_CODEBOOK))
    b = tlut.dc_decompose_codebook(tlut.NF4_CODEBOOK)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("seed", range(5))
def test_dc_decompose_random_codebooks(seed):
    """Arbitrary codebooks: XLA's reduction order for the 16-entry grand
    mean is not fixed, so the stated tolerance is one f32 ulp
    (rtol 1.2e-7, atol 1e-7)."""
    cb = np.random.default_rng(seed).uniform(-2, 2, 16).astype(np.float32)
    a = jlut.dc_decompose_codebook(jnp.asarray(cb))
    b = tlut.dc_decompose_codebook(cb)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1.2e-7,
                                   atol=1e-7)


def test_prune_scatter_and_table_bytes_match():
    _, _, jres = jlut.dc_decompose_codebook(jnp.asarray(jlut.NF4_CODEBOOK))
    _, _, tres = tlut.dc_decompose_codebook(tlut.NF4_CODEBOOK)
    ji, jv = jlut.prune_residual(jres, tq.NF4P_PRUNE_THRESHOLD)
    ti, tv = tlut.prune_residual(tres, tq.NF4P_PRUNE_THRESHOLD)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert ti.dtype == torch.int32 and len(ti) == 8
    np.testing.assert_array_equal(np.asarray(jlut.scatter_residual(ji, jv)),
                                  tlut.scatter_residual(ti, tv).numpy())
    assert (jlut.residual_table_bytes(len(ti))
            == tlut.residual_table_bytes(len(ti)) == (64, 40))


def test_codebook_dequant_matches_jax():
    codes = np.random.default_rng(2).integers(0, 16, (9, 7)).astype(np.int32)
    cb = np.random.default_rng(3).normal(size=16).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jlut.codebook_dequant(jnp.asarray(codes),
                                         jnp.asarray(cb))),
        tlut.codebook_dequant(torch.from_numpy(codes),
                              torch.from_numpy(cb)).numpy())


def _quantized_paths(node, path=()):
    """(path, per-layer index) of every QuantizedWeight in a tree."""
    if isinstance(node, (JQW, tq.QuantizedWeight)):
        return {path}
    if isinstance(node, dict):
        return set().union(*(_quantized_paths(v, path + (k,))
                             for k, v in node.items()))
    if isinstance(node, list):
        return set().union(*(_quantized_paths(v, path + (i,))
                             for i, v in enumerate(node)))
    return set()


@pytest.fixture(scope="module")
def reduced_yi():
    """Reduced f32 yi-9b: JAX params from PRNGKey(1), bridged to the port."""
    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    jparams = jax_model(jax_config("yi-9b").reduced(
        dtype="float32", attn_impl="full")).init(jax.random.PRNGKey(1))
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jparams, model


@pytest.mark.parametrize("quant", ["lut4", "int4", "nf4", "nf4p"])
def test_quantize_decode_params_same_leaves_as_jax(reduced_yi, quant):
    """Reduced yi-9b: the port freezes exactly JAX's leaf paths (the port
    lists layers where JAX stacks them) and every frozen leaf equals the
    matching slice of JAX's stacked one, bitwise."""
    cfg, jparams, model = reduced_yi
    jtree = jq.quantize_decode_params(jparams, quant)
    ttree = tq.quantize_decode_params(model.params_tree(), quant)
    jpaths = _quantized_paths(jtree)
    tpaths = _quantized_paths(ttree)
    assert jpaths == {("blocks", g, n) for g, ns in
                      (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w_up", "w_gate", "w_down"))) for n in ns}
    assert tpaths == {("blocks", i) + p[1:] for p in jpaths
                      for i in range(cfg.num_layers)}
    for _, i, g, n in tpaths:
        j = jax.tree.map(lambda a: a[i], jtree["blocks"][g][n])
        _assert_qw_equal(j, ttree["blocks"][i][g][n])
    # everything else passes through as the very same tensor object
    assert ttree["embed"] is model.embed
    assert ttree["blocks"][0]["ln1"] is model.blocks[0].ln1
