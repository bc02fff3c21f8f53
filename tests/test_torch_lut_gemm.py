"""The port's LUT GEMM plain versions and CPU dispatch against the JAX
package.

* ``lut_gemm_dc_ref`` / ``lut_gemm_dc_res_ref`` / ``lut_gemm_ref`` equal
  JAX's Pallas ``lut_gemm_dc`` / ``lut_gemm_dc_res`` / ``lut_gemm`` run in
  interpret mode, at rtol = atol = 1e-5 (f32 sums in another order), ragged
  shapes and an arbitrary codebook included;
* ``codebook_quantize`` codes equal JAX's bitwise, and the wrappers
  ``nf4_matmul_kernel`` / ``lut4_matmul_kernel`` / ``nf4dc_matmul_kernel``
  equal JAX's at 1e-5;
* the wrappers take the plain version for CPU tensors and count no launch;
* ``ops.quantized_matmul`` on the CPU equals JAX's ``quantized_matmul``
  for every weight kernel.

The kernels against their plain versions on the card:
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.lut_gemm import lut_gemm as jkern
from repro.kernels.lut_gemm import ops as jops
from repro.kernels.lut_gemm import ref as jref
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


def _codebook(seed=3):
    return np.sort(np.random.default_rng(seed).normal(size=16)).astype(
        np.float32)


@pytest.mark.parametrize("m,k,n,bk", SHAPES)
def test_lut_gemm_ref_matches_pallas_arbitrary_codebook(m, k, n, bk):
    """Programmability: any 16-entry table (mirrors JAX's
    ``test_lut_gemm_arbitrary_codebook``)."""
    rng = np.random.default_rng(4)
    cb = _codebook()
    codes = rng.integers(0, 16, (k, n)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    x = _x(m, k)
    pallas = jkern.lut_gemm(jnp.asarray(x), jnp.asarray(codes),
                            jnp.asarray(cb), jnp.asarray(scale), bm=m, bn=n,
                            bk=bk, interpret=True)
    args = [torch.from_numpy(a) for a in (x, codes, cb, scale)]
    port = tref.lut_gemm_ref(*args)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        port.numpy(), np.asarray(jref.lut_gemm_ref(*map(jnp.asarray, (
            x, codes, cb, scale)))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("codebook", ["nf4", "arbitrary"])
def test_codebook_quantize_bitwise_equals_jax(codebook):
    cb = (np.asarray(jops.NF4_CODEBOOK) if codebook == "nf4"
          else _codebook(5))
    w = np.random.default_rng(6).normal(size=(96, 40)).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero channel
    jc, js = jops.codebook_quantize(jnp.asarray(w), jnp.asarray(cb))
    tc, ts = tops.codebook_quantize(torch.from_numpy(w), torch.from_numpy(cb))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("wrapper", ["nf4_matmul_kernel",
                                     "lut4_matmul_kernel",
                                     "nf4dc_matmul_kernel", "nf4dc_pruned"])
def test_padded_wrappers_match_jax(wrapper):
    """JAX pads to its Pallas blocks and runs them in interpret mode; the
    port runs the kernels' plain versions on the CPU: 1e-5."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 72)).astype(np.float32)
    w = (rng.normal(size=(72, 40)) / 8).astype(np.float32)
    kw, jfn = {}, getattr(jops, wrapper.replace("_pruned", "_matmul_kernel"))
    if wrapper == "nf4dc_pruned":
        # JAX's own jit cannot trace the pruning (``prune_residual`` takes
        # numpy of a traced array): hold the port to the unjitted body
        wrapper, kw = "nf4dc_matmul_kernel", dict(
            prune_threshold=tq.NF4P_PRUNE_THRESHOLD)
        jfn = jfn.__wrapped__
    want = jfn(jnp.asarray(x), jnp.asarray(w), **kw)
    got = getattr(tops, wrapper)(torch.from_numpy(x), torch.from_numpy(w),
                                 **kw)
    assert got.shape == (5, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_take_plain_version_on_cpu():
    _, qa = _frozen(72, 40, "lut_dc")
    _, qn = _frozen(72, 40, "nf4_dc", tq.NF4P_PRUNE_THRESHOLD)
    x = torch.from_numpy(_x(3, 72))
    cb = torch.from_numpy(_codebook())
    assert torch.equal(tkern.lut_gemm(x, qa.codes, cb, qa.scale),
                       tref.lut_gemm_ref(x, qa.codes, cb, qa.scale))
    before = (tkern.lut_gemm_dc.launches, tkern.lut_gemm_dc_res.launches,
              tkern.lut_gemm.launches)
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
    assert torch.equal(tkern.lut_gemm(x, qa.codes, cb, qa.scale),
                       tref.lut_gemm_ref(x, qa.codes, cb, qa.scale))
    assert (tkern.lut_gemm_dc.launches, tkern.lut_gemm_dc_res.launches,
            tkern.lut_gemm.launches) == before


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
    with pytest.raises(ValueError, match="codebook"):
        tkern.lut_gemm(x, q.codes, q.hi_tab, q.scale)
    # meta operands (the dry run) take the kernel's shapes, computing nothing
    out = tkern.lut_gemm_dc(x.to("meta"), q.codes.to("meta"),
                            q.hi_tab.to("meta"), q.lo_tab.to("meta"),
                            q.zero_point.to("meta"), q.scale.to("meta"))
    assert (out.device.type, out.shape, out.dtype) == (
        "meta", (x.shape[0], q.codes.shape[1]), torch.float32)


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
