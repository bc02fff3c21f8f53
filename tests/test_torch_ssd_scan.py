"""The port's SSD chunk scan (plain versions on the CPU) against the JAX
package's, on the same numpy inputs (``tests/test_ssd_kernel.py``'s
distributions).

* ``repro_torch.models.ssm._ssd_chunked`` and the kernel's wrapper
  ``ssd_chunked_kernel`` (which takes it for CPU tensors) against JAX's
  ``_ssd_chunked`` and its Pallas kernel in interpret mode, and the
  sequential oracle ``ssd_ref`` against JAX's, at the four shapes JAX
  pins, 1e-4;
* ``ssd_ref`` with a carried state and a ragged mask against JAX's, and
  the chunked scan against it (5e-4, as JAX holds its kernel);
* resume in two halves and a masked right-padded scan against the exact
  prefix (2e-4, as JAX holds them);
* the wrapper's argument checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_chunked_kernel as jax_kernel
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import _ssd_chunked as jax_chunked
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.models.ssm import _ssd_chunked

TOL = dict(rtol=1e-4, atol=1e-4)
TOL2 = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(1, 128, 2, 8, 1, 8, 64), (2, 256, 4, 16, 2, 8, 64),
          (1, 256, 4, 32, 1, 16, 128), (2, 512, 2, 16, 2, 32, 128)]


def _inputs(B, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, H)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32))


def _pt(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jx(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _streams(arrays):
    """(B,S,H,P) inputs -> the oracle's (BH, S, ·) head streams."""
    x, dt, a, b, c = arrays
    B, S, H, P = x.shape
    hg = H // b.shape[2]
    return (x.transpose(0, 2, 1, 3).reshape(B * H, S, P),
            dt.transpose(0, 2, 1).reshape(B * H, S), np.tile(a, B),
            np.repeat(b, hg, axis=2).transpose(0, 2, 1, 3).reshape(
                B * H, S, -1),
            np.repeat(c, hg, axis=2).transpose(0, 2, 1, 3).reshape(
                B * H, S, -1))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SHAPES)
def test_chunked_scan_matches_jax(B, S, H, P, G, N, chunk):
    arrays = _inputs(B, S, H, P, G, N, seed=B + S)
    y_j, fs_j = jax_chunked(*_jx(*arrays), chunk)
    y_k, fs_k = jax_kernel(*_jx(*arrays), chunk=chunk, interpret=True)
    for fn in (lambda *a: _ssd_chunked(*a, chunk),
               lambda *a: ssd_chunked_kernel(*a, chunk=chunk)):
        y, fs = fn(*_pt(*arrays))
        for want_y, want_fs in ((y_j, fs_j), (y_k, fs_k)):
            _close(y, want_y, TOL)
            _close(fs, want_fs, TOL)
    # the sequential oracles, on the (BH, S, ·) head streams
    streams = _streams(arrays)
    y_r, fs_r = ssd_ref(*_pt(*streams))
    y_rj, fs_rj = jax_ssd_ref(*_jx(*streams))
    _close(y_r, y_rj, TOL)
    _close(fs_r, fs_rj, TOL)


def test_sequential_oracle_matches_jax_and_chunked():
    B, S, H, P, G, N = 2, 256, 4, 16, 2, 8
    arrays = _inputs(B, S, H, P, G, N)
    streams = _streams(arrays)
    rng = np.random.default_rng(3)
    s0 = rng.normal(size=(B * H, N, P)).astype(np.float32)
    mask = rng.uniform(size=(B * H, S)) < 0.8
    y, fs = ssd_ref(*_pt(*streams), initial_state=torch.from_numpy(s0),
                    mask=torch.from_numpy(mask))
    y_j, fs_j = jax_ssd_ref(*_jx(*streams), initial_state=jnp.asarray(s0),
                            mask=jnp.asarray(mask))
    _close(y, y_j, TOL)
    _close(fs, fs_j, TOL)
    # the chunked scan == the token-by-token recurrence
    y_c, fs_c = _ssd_chunked(*_pt(*arrays), 64)
    y_r, fs_r = ssd_ref(*_pt(*streams))
    _close(y_c, y_r.reshape(B, H, S, P).permute(0, 2, 1, 3),
           dict(rtol=5e-4, atol=5e-4))
    _close(fs_c, fs_r.reshape(B, H, N, P).permute(0, 1, 3, 2),
           dict(rtol=5e-4, atol=5e-4))


def test_resume_in_two_halves_matches_whole_sequence():
    B, S, H, P, G, N, chunk = 2, 256, 4, 16, 2, 8, 64
    x, dt, a, b, c = _pt(*_inputs(B, S, H, P, G, N, seed=7))
    y_w, fs_w = _ssd_chunked(x, dt, a, b, c, chunk)
    h = S // 2
    y1, fs1 = _ssd_chunked(x[:, :h], dt[:, :h], a, b[:, :h], c[:, :h], chunk)
    y2, fs2 = ssd_chunked_kernel(x[:, h:], dt[:, h:], a, b[:, h:], c[:, h:],
                                 chunk=chunk, initial_state=fs1)
    _close(torch.cat([y1, y2], 1), y_w, TOL2)
    _close(fs2, fs_w, TOL2)
    # and the second half equals JAX's resumed scan
    xj, dtj, aj, bj, cj = _jx(*(t.numpy() for t in (x, dt, a, b, c)))
    y2j, fs2j = jax_chunked(xj[:, h:], dtj[:, h:], aj, bj[:, h:], cj[:, h:],
                            chunk, initial_state=jnp.asarray(fs1.numpy()))
    _close(y2, y2j, TOL)
    _close(fs2, fs2j, TOL)


@pytest.mark.parametrize("L", [77, 128, 1])
def test_mask_matches_exact_prefix(L):
    B, S, H, P, G, N, chunk = 2, 128, 4, 16, 2, 8, 32
    arrays = _inputs(B, S, H, P, G, N, seed=11)
    x, dt, a, b, c = _pt(*arrays)
    mask = torch.arange(S)[None, :].expand(B, S) < L
    y_m, fs_m = ssd_chunked_kernel(x, dt, a, b, c, chunk=chunk, mask=mask)
    y_e, fs_e = _ssd_chunked(x[:, :L], dt[:, :L], a, b[:, :L], c[:, :L],
                             chunk)
    _close(y_m[:, :L], y_e, TOL2)
    _close(fs_m, fs_e, TOL2)
    y_j, fs_j = jax_chunked(*_jx(*arrays), chunk,
                            mask=jnp.asarray(mask.numpy()))
    _close(y_m, y_j, TOL)
    _close(fs_m, fs_j, TOL)


def test_ragged_length_and_any_chunk_width():
    """S off the chunk grid and a chunk that is not a power of two (the
    engine's 16-token buckets give both): equal to JAX's internally padded
    scan."""
    arrays = _inputs(1, 77, 4, 8, 2, 8, seed=5)
    for chunk in (48, 77, 32):
        y, fs = ssd_chunked_kernel(*_pt(*arrays), chunk=chunk)
        y_j, fs_j = jax_chunked(*_jx(*arrays), chunk)
        _close(y, y_j, TOL)
        _close(fs, fs_j, TOL)


def test_wrapper_checks_its_arguments():
    x, dt, a, b, c = _pt(*_inputs(1, 8, 2, 4, 1, 4))
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, a, b, c, chunk=257)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x.double(), dt, a, b, c, chunk=8)
    with pytest.raises(ValueError, match="mask"):
        ssd_scan(x, dt, a, b, c, chunk=8, mask=torch.ones(1, 8))
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, dt, a, b, c, chunk=8, initial_state=torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="groups"):
        ssd_scan(x[:, :, :1].expand(1, 8, 3, 4).contiguous(),
                 dt[:, :, :1].expand(1, 8, 3).contiguous(),
                 torch.ones(3), torch.cat([b, b], 2), torch.cat([c, c], 2),
                 chunk=8)
