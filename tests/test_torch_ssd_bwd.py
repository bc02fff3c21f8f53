"""The SSD scan's backward on the CPU against the JAX package.

* ``ref.ssd_scan_bwd_ref`` (the plain version of ``csrc/ssd_scan_bwd.cu``)
  against ``jax.vjp`` of JAX's ``repro.models.ssm._ssd_chunked`` on the
  same numpy inputs and cotangents, f32, each gradient within
  ``ssd_scan.KERNEL_TOL / 10`` = 1e-5 of its scale (``max|d - jax| <= 1e-5
  max(1, max|jax|)``, as ``ssd_scan.scaled_err`` measures the kernel):
  groups fewer than heads, a carried initial state, a ragged mask, S off
  the chunk grid, no final-state cotangent.
* ``ops.SSDScanFn`` on CPU tensors (forward ``_ssd_chunked``, backward
  ``ssd_scan_bwd_ref``) against torch autograd of the port's
  ``_ssd_chunked``; ``ssd_chunked_kernel`` takes the Function only under
  grad with an operand that requires grad.
* ``ssd_scan_bwd``'s argument checks; on CPU tensors it is the plain
  version.
The kernel itself runs only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 3f hold it to autograd of the plain scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _ssd_chunked as jax_chunked
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (KERNEL_TOL, scaled_err,
                                                   ssd_scan_bwd)
from repro_torch.models.ssm import _ssd_chunked

REL = KERNEL_TOL / 10
NAMES = ("dx", "ddt", "da", "db", "dc", "d_initial_state")

# (B, S, H, P, G, N, chunk, initial state, mask, final-state cotangent)
CASES = [
    (1, 128, 2, 8, 1, 8, 64, False, False, True),     # JAX's kernel shape
    (2, 256, 4, 16, 2, 8, 64, True, False, True),     # G < H, carried state
    (2, 77, 4, 8, 2, 6, 32, True, True, True),        # ragged S, mask
    (1, 100, 6, 5, 3, 7, 16, False, True, False),     # no dfinal, G = H / 2
    (2, 40, 2, 16, 1, 16, 40, True, True, True),      # one chunk
]


def _inputs(b, s, h, p, g, n, init, masked, seed):
    """``tests/test_ssd_kernel.py``'s distributions, dt up to 0.6."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.6, (b, s, h)).astype(np.float32)
    a = (-rng.uniform(0.5, 2.0, h)).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    s0 = (rng.normal(size=(b, h, p, n)).astype(np.float32) if init
          else None)
    mask = rng.uniform(size=(b, s)) > 0.25 if masked else None
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    df = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return (x, dt, a, bm, cm), s0, mask, dy, df


def _err(got, want) -> float:
    return scaled_err(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init,masked,dfin", CASES)
def test_bwd_ref_matches_jax_vjp(b, s, h, p, g, n, chunk, init, masked,
                                 dfin):
    ops, s0, mask, dy, df = _inputs(b, s, h, p, g, n, init, masked, 7)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(x, dt, a, bm, cm, *state):
        return jax_chunked(x, dt, a, bm, cm, chunk,
                           initial_state=state[0] if state else None,
                           mask=jmask)
    primals = [jnp.asarray(t) for t in ops] + ([jnp.asarray(s0)] if init
                                               else [])
    _, vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(dy), jnp.asarray(df) if dfin
                else jnp.zeros((b, h, p, n), jnp.float32)))
    pt = [torch.from_numpy(t) for t in ops]
    got = ssd_scan_bwd_ref(
        *pt, torch.from_numpy(dy), torch.from_numpy(df) if dfin else None,
        chunk=chunk, initial_state=None if s0 is None
        else torch.from_numpy(s0),
        mask=None if mask is None else torch.from_numpy(mask))
    assert (got[5] is None) == (not init)
    for name, gg, ww in zip(NAMES, got, want):
        assert gg.dtype == torch.float32 and tuple(gg.shape) == ww.shape
        err = _err(gg, ww)
        assert err <= REL, f"{name}: {err} of its scale > {REL}"


@pytest.mark.parametrize("init,masked", [(False, False), (True, True)])
def test_ssd_scan_fn_on_cpu_matches_autograd(init, masked):
    ops, s0, mask, dy, df = _inputs(2, 70, 4, 8, 2, 6, init, masked, 3)
    leaves = [torch.from_numpy(t).requires_grad_() for t in ops]
    if init:
        leaves.append(torch.from_numpy(s0).requires_grad_())
    kw = dict(initial_state=leaves[5] if init else None,
              mask=None if mask is None else torch.from_numpy(mask))
    y, fs = ssd_chunked_kernel(*leaves[:5], chunk=16, **kw)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    y0, fs0 = _ssd_chunked(*leaves[:5], 16, **kw)
    assert torch.equal(y, y0) and torch.equal(fs, fs0)
    cot = (torch.from_numpy(dy), torch.from_numpy(df))
    got = torch.autograd.grad((y, fs), leaves, cot)
    want = torch.autograd.grad((y0, fs0), leaves, cot)
    for name, gg, ww in zip(NAMES, got, want):
        err = scaled_err(gg, ww)
        assert err <= REL, f"{name}: {err} of its scale > {REL}"


def test_function_only_under_grad():
    ops, _, _, _, _ = _inputs(1, 40, 2, 4, 1, 3, False, False, 0)
    pt = [torch.from_numpy(t) for t in ops]
    y, _ = ssd_chunked_kernel(*pt, chunk=16)          # nothing requires grad
    assert y.grad_fn is None
    leaves = [t.clone().requires_grad_() for t in pt]
    with torch.no_grad():
        y, fs = ssd_chunked_kernel(*leaves, chunk=16)
    assert y.grad_fn is None and fs.grad_fn is None
    with torch.inference_mode():
        y2, _ = ssd_chunked_kernel(*leaves, chunk=16)
    assert torch.equal(y, y2)
    y3, _ = ssd_chunked_kernel(*leaves, chunk=16)
    assert type(y3.grad_fn).__name__ == "SSDScanFnBackward"
    assert torch.equal(y, y3.detach())


def test_bwd_wrapper_checks_and_cpu_route():
    ops, s0, mask, dy, df = _inputs(2, 50, 4, 8, 2, 6, True, True, 5)
    pt = [torch.from_numpy(t) for t in ops]
    kw = dict(chunk=16, initial_state=torch.from_numpy(s0),
              mask=torch.from_numpy(mask))
    got = ssd_scan_bwd(*pt, torch.from_numpy(dy), torch.from_numpy(df), **kw)
    want = ssd_scan_bwd_ref(*pt, torch.from_numpy(dy), torch.from_numpy(df),
                            **kw)
    for gg, ww in zip(got, want):
        assert torch.equal(gg, ww)
    with pytest.raises(ValueError, match="dy must be float32"):
        ssd_scan_bwd(*pt, torch.from_numpy(dy)[:, :-1], **kw)
    with pytest.raises(ValueError, match="dfinal must be float32"):
        ssd_scan_bwd(*pt, torch.from_numpy(dy), torch.from_numpy(df).double(),
                     **kw)
    with pytest.raises(ValueError, match="groups do not divide"):
        ssd_scan_bwd(pt[0], pt[1], pt[2], pt[3][:, :, :1].repeat(1, 1, 3, 1),
                     pt[4][:, :, :1].repeat(1, 1, 3, 1), torch.from_numpy(dy),
                     chunk=16)
