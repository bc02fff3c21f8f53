"""The port's LUT GEMM plain versions and CPU dispatch against the JAX
package.

* ``lut_gemm_dc_ref`` / ``lut_gemm_dc_res_ref`` equal JAX's Pallas
  ``lut_gemm_dc`` / ``lut_gemm_dc_res`` run in interpret mode, at
  rtol = atol = 1e-5 (f32 sums in another order), ragged shapes included;
* the wrappers take the plain version for CPU tensors and count no launch;
* ``ops.quantized_matmul`` on the CPU equals JAX's ``quantized_matmul``
  for every weight kernel;
* on a card, each kernel against its plain version (marked ``cuda``:
  skips without one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.lut_gemm import lut_gemm as jkern
from repro.kernels.lut_gemm import ops as jops
from repro_torch.core import quant as tq
from repro_torch.kernels.lut_gemm import lut_gemm as tkern
from repro_torch.kernels.lut_gemm import ops as tops
from repro_torch.kernels.lut_gemm import ref as tref

# (M, K, N, bk): ragged single-block, and multi-K-step tilings
SHAPES = [(3, 72, 40, 72), (8, 64, 48, 32), (16, 128, 96, 64)]


def _frozen(k, n, kernel, prune=None, seed=0):
    """The same frozen weight on both sides: quantized by JAX, handed to
    the port through numpy."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jqw = jq.quantize_weight(jnp.asarray(w), kernel, prune)
    tqw = tq.QuantizedWeight(
        **{f: torch.from_numpy(np.array(getattr(jqw, f)))
           for f in ("codes", "scale", "zero_point", "hi_tab", "lo_tab")},
        residual=(None if jqw.residual is None
                  else torch.from_numpy(np.array(jqw.residual))),
        kernel=kernel)
    return jqw, tqw


def _x(m, k, seed=1):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


@pytest.mark.parametrize("m,k,n,bk", SHAPES)
def test_lut_gemm_dc_ref_matches_pallas(m, k, n, bk):
    jqw, tqw = _frozen(k, n, "lut_dc")
    x = _x(m, k)
    pallas = jkern.lut_gemm_dc(jnp.asarray(x), jqw.codes, jqw.hi_tab,
                               jqw.lo_tab, jqw.zero_point, jqw.scale,
                               bm=m, bn=n, bk=bk, interpret=True)
    port = tref.lut_gemm_dc_ref(torch.from_numpy(x), tqw.codes, tqw.hi_tab,
                                tqw.lo_tab, tqw.zero_point, tqw.scale)
    assert port.dtype == torch.float32 and port.shape == (m, n)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("prune", [None, tq.NF4P_PRUNE_THRESHOLD])
@pytest.mark.parametrize("m,k,n,bk", SHAPES)
def test_lut_gemm_dc_res_ref_matches_pallas(m, k, n, bk, prune):
    jqw, tqw = _frozen(k, n, "nf4_dc", prune)
    x = _x(m, k)
    pallas = jkern.lut_gemm_dc_res(
        jnp.asarray(x), jqw.codes, jqw.hi_tab, jqw.lo_tab, jqw.residual,
        jqw.zero_point, jqw.scale, bm=m, bn=n, bk=bk, interpret=True)
    port = tref.lut_gemm_dc_res_ref(
        torch.from_numpy(x), tqw.codes, tqw.hi_tab, tqw.lo_tab, tqw.residual,
        tqw.zero_point, tqw.scale)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_take_plain_version_on_cpu():
    _, qa = _frozen(72, 40, "lut_dc")
    _, qn = _frozen(72, 40, "nf4_dc", tq.NF4P_PRUNE_THRESHOLD)
    x = torch.from_numpy(_x(3, 72))
    before = (tkern.lut_gemm_dc.launches, tkern.lut_gemm_dc_res.launches)
    assert torch.equal(
        tkern.lut_gemm_dc(x, qa.codes, qa.hi_tab, qa.lo_tab, qa.zero_point,
                          qa.scale),
        tref.lut_gemm_dc_ref(x, qa.codes, qa.hi_tab, qa.lo_tab,
                             qa.zero_point, qa.scale))
    assert torch.equal(
        tkern.lut_gemm_dc_res(x, qn.codes, qn.hi_tab, qn.lo_tab, qn.residual,
                              qn.zero_point, qn.scale),
        tref.lut_gemm_dc_res_ref(x, qn.codes, qn.hi_tab, qn.lo_tab,
                                 qn.residual, qn.zero_point, qn.scale))
    assert (tkern.lut_gemm_dc.launches,
            tkern.lut_gemm_dc_res.launches) == before


def test_wrappers_reject_bad_operands():
    _, q = _frozen(72, 40, "lut_dc")
    x = torch.from_numpy(_x(3, 72))
    with pytest.raises(ValueError, match="shapes"):
        tkern.lut_gemm_dc(x[:, :70], q.codes, q.hi_tab, q.lo_tab,
                          q.zero_point, q.scale)
    with pytest.raises(TypeError, match="int8"):
        tkern.lut_gemm_dc(x, q.codes.int(), q.hi_tab, q.lo_tab,
                          q.zero_point, q.scale)
    with pytest.raises(ValueError, match="zero_point"):
        tkern.lut_gemm_dc(x, q.codes, q.hi_tab, q.lo_tab,
                          q.zero_point[:-1], q.scale)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tkern.lut_gemm_dc(x.to("meta"), q.codes.to("meta"),
                          q.hi_tab.to("meta"), q.lo_tab.to("meta"),
                          q.zero_point.to("meta"), q.scale.to("meta"))


@pytest.mark.parametrize("kernel,prune", [
    ("lut_dc", None), ("dequant", None), ("nf4_dc", None),
    ("nf4_dc", tq.NF4P_PRUNE_THRESHOLD), ("nf4_dequant", None)])
def test_cpu_dispatch_matches_jax_quantized_matmul(kernel, prune):
    """The engine's decode matmul on the CPU: JAX's jnp order (scale folded
    in before the matmul) on the same frozen weight, (B, 1, K) input."""
    jqw, tqw = _frozen(72, 40, kernel, prune)
    x = _x(3, 72).reshape(3, 1, 72)
    want = np.asarray(jops.quantized_matmul(jnp.asarray(x), jqw))
    got = tops.quantized_matmul(torch.from_numpy(x), tqw)
    assert got.shape == (3, 1, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_output_follows_x_dtype():
    _, tqw = _frozen(72, 40, "nf4_dc")
    x = torch.from_numpy(_x(2, 72)).bfloat16()
    assert tops.quantized_matmul(x, tqw).dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4096, 512), (8, 4096, 4096),
                                   (3, 72, 40)])
def test_kernels_match_plain_on_card(m, k, n):
    """Each kernel against its plain version on the card, at the tolerance
    stated in ``lut_gemm.py``; the dequantized weight (x = I) bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    w = torch.randn((k, n), device=dev) / k ** 0.5
    for kernel, fn, ref in (
            ("lut_dc", tkern.lut_gemm_dc, tref.lut_gemm_dc_ref),
            ("nf4_dc", tkern.lut_gemm_dc_res, tref.lut_gemm_dc_res_ref)):
        q = tq.quantize_weight(w, kernel, tq.NF4P_PRUNE_THRESHOLD
                               if kernel == "nf4_dc" else None)
        tables = ((q.hi_tab, q.lo_tab) if kernel == "lut_dc"
                  else (q.hi_tab, q.lo_tab, q.residual))
        x = torch.randn((m, k), device=dev, dtype=torch.bfloat16)
        torch.testing.assert_close(
            fn(x, q.codes, *tables, q.zero_point, q.scale),
            ref(x, q.codes, *tables, q.zero_point, q.scale),
            rtol=tkern.KERNEL_RTOL, atol=tkern.KERNEL_ATOL)
        eye = torch.eye(k, device=dev, dtype=torch.bfloat16)[:min(k, 256)]
        want = (tref.dc_dequant(q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                                q.residual) * q.scale[None, :])[:eye.shape[0]]
        assert torch.equal(fn(eye, q.codes, *tables, q.zero_point, q.scale),
                           want)
