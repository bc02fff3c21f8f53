"""The SSD scan backward's tensor-core kernels (``csrc/ssd_scan_bwd.cu``),
their arithmetic emulated on the CPU, against the JAX package.

* ``ref.ssd_scan_bwd_tc_emulate`` (the kernels' passes, every product
  3xTF32, D summed over runs of ``RUN_HEADS`` heads, dB and dC per group,
  the scans in the kernels' orders) against ``jax.vjp`` of JAX's
  ``repro.models.ssm._ssd_chunked`` on the same numpy inputs and
  cotangents, each gradient within ``KERNEL_TOL`` of its scale: groups
  fewer than heads with a carried state, a ragged mask off the chunk grid,
  no final-state cotangent, and 20 heads of one group (two runs) with Q =
  100;
* the kernel-order scans (``_kernel_cumsum``, ``_kernel_rev_cumsum``,
  ``_kernel_block_sum``) against torch's sums;
* three faults fail that check by more than twice ``KERNEL_TOL``: one TF32
  product (lo terms dropped), the diagonal dropped from the causal mask,
  and a reverse state pass that skips one chunk's decay.

The kernels themselves against this emulation and autograd of the plain
scan on the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase
3f.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _ssd_chunked as jax_chunked
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.kernels.ssd_scan.ssd_scan import KERNEL_TOL, scaled_err

NAMES = ("dx", "ddt", "da", "db", "dc", "d_initial_state")

# (B, S, H, P, G, N, chunk, initial state, mask, final-state cotangent)
CASES = {
    "G < H, carried state": (2, 256, 4, 16, 2, 8, 64, True, False, True),
    "ragged S, mask": (2, 77, 4, 8, 2, 6, 32, True, True, True),
    "no dfinal, G = H / 2": (1, 100, 6, 5, 3, 7, 16, False, True, False),
    "two runs, Q = 100": (1, 300, 20, 16, 1, 16, 100, True, True, True),
}
FAULTS = {"one TF32 product": dict(lo_terms=False),
          "diagonal dropped": dict(diagonal=False),
          "a chunk's decay skipped": dict(skip_decay_chunk=1)}


@functools.cache
def _case(name):
    """Numpy inputs and cotangents of a case, and ``jax.vjp``'s gradients."""
    b, s, h, p, g, n, chunk, init, masked, dfin = CASES[name]
    rng = np.random.default_rng(11)
    ops = (rng.normal(size=(b, s, h, p)).astype(np.float32),
           rng.uniform(0.01, 0.6, (b, s, h)).astype(np.float32),
           (-rng.uniform(0.5, 2.0, h)).astype(np.float32),
           rng.normal(size=(b, s, g, n)).astype(np.float32),
           rng.normal(size=(b, s, g, n)).astype(np.float32))
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    mask = rng.uniform(size=(b, s)) > 0.25 if masked else None
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    df = rng.normal(size=(b, h, p, n)).astype(np.float32) if dfin else None
    jmask = None if mask is None else jnp.asarray(mask)

    def f(x, dt, a, bm, cm, *state):
        return jax_chunked(x, dt, a, bm, cm, chunk,
                           initial_state=state[0] if state else None,
                           mask=jmask)
    primals = [jnp.asarray(t) for t in ops] + ([jnp.asarray(s0)] if init
                                               else [])
    _, vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(dy), jnp.zeros((b, h, p, n), jnp.float32)
                if df is None else jnp.asarray(df)))
    want = [torch.from_numpy(np.array(w)) for w in want]
    return ops, s0, mask, dy, df, chunk, want


def _emulate(name, **fault):
    ops, s0, mask, dy, df, chunk, _ = _case(name)

    def pt(t):
        return None if t is None else torch.from_numpy(t)
    return sref.ssd_scan_bwd_tc_emulate(
        *map(pt, ops), pt(dy), pt(df), chunk=chunk, initial_state=pt(s0),
        mask=pt(mask), **fault)


def _errs(got, want) -> dict:
    return {nm: scaled_err(gg, ww) for nm, gg, ww in zip(NAMES, got, want)}


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_jax_vjp(name):
    got = _emulate(name)
    want = _case(name)[-1]
    assert (got[5] is None) == (len(want) == 5)
    for gg, ww in zip(got, want):
        assert gg.dtype == torch.float32 and gg.shape == ww.shape
    errs = _errs(got, want)
    assert max(errs.values()) <= KERNEL_TOL, errs


def test_kernel_order_scans():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(3, 200)).astype(np.float32))
    torch.testing.assert_close(sref._kernel_cumsum(v), torch.cumsum(v, -1),
                               rtol=0, atol=1e-5)
    rev = torch.flip(torch.cumsum(torch.flip(v, (-1,)), -1), (-1,))
    torch.testing.assert_close(sref._kernel_rev_cumsum(v), rev, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(sref._kernel_block_sum(v), v.sum(-1), rtol=0,
                               atol=1e-5)
    # the scan's first entries are plain sums: v0, v0 + v1, (v0 + v1) + v2
    got = sref._kernel_cumsum(v[:, :3])
    assert torch.equal(got[:, 0], v[:, 0])
    assert torch.equal(got[:, 1], v[:, 0] + v[:, 1])
    assert torch.equal(got[:, 2], (v[:, 0] + v[:, 1]) + v[:, 2])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_fail_the_check(fault):
    """Each fault breaks the check the sound emulation passes (the case
    has four chunks, a carried state and a final-state cotangent, so that
    chunk 1's decay reaches chunk 0's gradients)."""
    name = "G < H, carried state"
    want = _case(name)[-1]
    assert max(_errs(_emulate(name), want).values()) <= KERNEL_TOL
    err = max(_errs(_emulate(name, **FAULTS[fault]), want).values())
    assert err > 2 * KERNEL_TOL, (fault, err)
