"""The port's LUNA GEMM (plain version, CPU dispatch, split plan) against
the JAX package.

* ``luna_mm_ref`` and ``ops.luna_mm_codes`` equal JAX's ``luna_mm_ref`` and
  its Pallas ``luna_mm_codes`` run in interpret mode, every mode, ragged
  shapes included: bitwise (the result is integer);
* ``ops.luna_matmul_f32_kernel`` equals JAX's (interpret mode) and the
  port's library ``luna_matmul_f32`` at rtol = atol = 1e-5;
* the wrapper takes the plain version for CPU tensors and counts no launch,
  rejects bad operands, and the kernel route refuses bits != 4.

The kernel against its plain version on the card:
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.luna_mm import ops as jops
from repro.kernels.luna_mm.ref import luna_mm_ref as jax_luna_mm_ref
from repro_torch.core.quant import luna_matmul_f32
from repro_torch.kernels.luna_mm import luna_mm as tkern
from repro_torch.kernels.luna_mm import ops as tops
from repro_torch.kernels.luna_mm.ref import luna_mm_ref

MODES = ["conventional", "dc", "opt_dc", "approx_dc", "approx_dc2"]
SHAPES = [(8, 8, 8), (3, 72, 40), (33, 17, 9), (1, 300, 5), (16, 256, 96)]


def _codes(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (m, k)).astype(np.int8),
            rng.integers(0, 16, (k, n)).astype(np.int8))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_luna_mm_ref_matches_jax_ref(mode, shape):
    y, w = _codes(*shape)
    got = luna_mm_ref(torch.from_numpy(y), torch.from_numpy(w), mode)
    assert got.dtype == torch.int32 and got.shape == (shape[0], shape[2])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_luna_mm_ref(jnp.asarray(y),
                                                jnp.asarray(w), mode)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_luna_mm_codes_matches_pallas(mode, shape):
    y, w = _codes(*shape, seed=1)
    want = jops.luna_mm_codes(jnp.asarray(y), jnp.asarray(w), mode=mode,
                              interpret=True)
    # int32 carriers, as the f32 pipeline hands them over
    got = tops.luna_mm_codes(torch.from_numpy(y).int(),
                             torch.from_numpy(w).int(), mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["opt_dc", "approx_dc", "approx_dc2",
                                  "conventional"])
def test_luna_matmul_f32_kernel_matches_jax(mode):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(24, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 40)) / 7).astype(np.float32)
    want = jops.luna_matmul_f32_kernel(jnp.asarray(x), jnp.asarray(w),
                                       mode=mode, interpret=True)
    got = tops.luna_matmul_f32_kernel(torch.from_numpy(x),
                                      torch.from_numpy(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    lib = luna_matmul_f32(torch.from_numpy(x), torch.from_numpy(w), mode)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    y, w = _codes(3, 72, 40)
    yt, wt = torch.from_numpy(y), torch.from_numpy(w)
    before = tkern.luna_mm.launches
    for mode in MODES:
        assert torch.equal(tkern.luna_mm(yt, wt, mode),
                           luna_mm_ref(yt, wt, mode))
    assert tkern.luna_mm.launches == before


def test_wrapper_rejects_bad_operands():
    y, w = map(torch.from_numpy, _codes(3, 72, 40))
    with pytest.raises(ValueError, match="shapes"):
        tkern.luna_mm(y[:, :70], w)
    with pytest.raises(TypeError, match="int8"):
        tkern.luna_mm(y.int(), w)
    with pytest.raises(ValueError, match="'fast'"):
        tkern.luna_mm(y, w, "fast")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tkern.luna_mm(y.to("meta"), w.to("meta"))
    with pytest.raises(NotImplementedError, match="queue 2 kernel 6"):
        tops.luna_matmul_f32_kernel(torch.ones(2, 8), torch.ones(8, 4),
                                    bits=8)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 11008), (512, 11008, 4096),
                                   (3, 72, 40), (1, 100, 7)])
def test_split_plan_tiles_k_exactly(m, k, n):
    m_tile, splits, k_split = tkern.split_plan(m, k, n)
    assert m_tile in (1, 2, 4, 8, 16) and m_tile >= min(m, 16)
    assert k_split % 32 == 0 and k_split <= tkern.KSPLIT_MAX
    assert (splits - 1) * k_split < k <= splits * k_split
