"""The SSD scan's tensor-core kernels (``csrc/ssd_scan_tc.cu``), their
arithmetic emulated on the CPU, against the JAX package.

* ``ref.tf32_split``: hi has at most 10 explicit mantissa bits and is the
  nearest TF32 value, ties away from zero (``cvt.rna``); |a - (hi + lo)|
  <= 2^-22 |a|;
* ``ref.ssd_scan_tc_emulate`` (the four passes, every product 3xTF32)
  within ``KERNEL_TOL`` of the output's scale of JAX's Pallas ``ssd_scan``
  in interpret mode and of JAX's ``_ssd_chunked``: JAX's four test shapes,
  a resume in two halves, a ragged mask off the chunk grid, and mamba2's
  widths (P = 64, N = 128, chunk 256, S = 448 masked at 438, the zero
  state the engine carries in) on f32 and on bf16-rounded x, B, C;
* three faults fail that check at mamba2's widths: one TF32 product (lo
  terms dropped), a state pass that skips one chunk's decay, the diagonal
  dropped from the causal mask.

The kernels themselves against their plain version and this emulation on
the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_chunked_kernel as jax_kernel
from repro.models.ssm import _ssd_chunked as jax_chunked
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_tc_emulate, tf32_round,
                                              tf32_split)
from repro_torch.kernels.ssd_scan.ssd_scan import KERNEL_TOL, scaled_err

#: tests/test_ssd_kernel.py's shapes (B, S, H, P, G, N, chunk)
SHAPES = [(1, 128, 2, 8, 1, 8, 64), (2, 256, 4, 16, 2, 8, 64),
          (1, 256, 4, 32, 1, 16, 128), (2, 512, 2, 16, 2, 32, 128)]
#: mamba2-1.3b's widths at the main path's largest prefill call
MAMBA2 = dict(B=1, S=448, P=64, G=1, N=128, chunk=256, valid=438)
FAULTS = {"one TF32 product": dict(lo_terms=False),
          "a chunk's decay skipped": dict(skip_decay_chunk=0),
          "diagonal dropped": dict(diagonal=False)}


def _inputs(B, S, H, P, G, N, seed=0, bf16=False):
    """``tests/test_ssd_kernel.py``'s distributions (x, B, C rounded to
    bf16 where ``bf16``: the main path upcasts bf16 activations)."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, S, H, P)).astype(np.float32),
           rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
           (-rng.uniform(0.5, 2.0, H)).astype(np.float32),
           rng.normal(size=(B, S, G, N)).astype(np.float32),
           rng.normal(size=(B, S, G, N)).astype(np.float32)]
    if bf16:
        for i in (0, 3, 4):
            out[i] = torch.from_numpy(out[i]).bfloat16().float().numpy()
    return out


def _pt(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _pallas(arrays, chunk, initial_state=None, mask=None):
    """JAX's Pallas kernel in interpret mode; S padded to the chunk grid
    with masked positions (the kernel takes whole chunks only)."""
    x, dt, a, b, c = arrays
    s = x.shape[1]
    pad = -s % chunk
    if mask is None:
        mask = np.ones((x.shape[0], s), dtype=bool)
    if pad:
        def padded(t):
            width = [(0, 0)] * t.ndim
            width[1] = (0, pad)
            return np.pad(t, width)
        x, dt, b, c, mask = map(padded, (x, dt, b, c, mask))
    y, fs = jax_kernel(*map(jnp.asarray, (x, dt, a, b, c)), chunk=chunk,
                       interpret=True, mask=jnp.asarray(mask),
                       initial_state=None if initial_state is None
                       else jnp.asarray(initial_state))
    return (torch.from_numpy(np.asarray(y)[:, :s].copy()),
            torch.from_numpy(np.array(fs)))


def _jnp(arrays, chunk, initial_state=None, mask=None):
    y, fs = jax_chunked(*map(jnp.asarray, arrays), chunk,
                        initial_state=None if initial_state is None
                        else jnp.asarray(initial_state),
                        mask=None if mask is None else jnp.asarray(mask))
    return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(fs))


def _err(got, want) -> float:
    return max(scaled_err(got[0], want[0]), scaled_err(got[1], want[1]))


def _emulate(arrays, chunk, initial_state=None, mask=None, **fault):
    s0, m = _pt(initial_state, mask)
    return ssd_scan_tc_emulate(*_pt(*arrays), chunk=chunk, initial_state=s0,
                               mask=m, **fault)


def _mamba2(heads, bf16=False):
    """mamba2's widths as the engine calls the scan: masked at the prompt
    length, the zero state carried in."""
    w = MAMBA2
    arrays = _inputs(w["B"], w["S"], heads, w["P"], w["G"], w["N"],
                     seed=heads, bf16=bf16)
    state = np.zeros((w["B"], heads, w["P"], w["N"]), dtype=np.float32)
    mask = np.arange(w["S"])[None] < w["valid"]
    return arrays, state, mask


def test_tf32_split_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    a = np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.integers(-20, 20, 4000),
        rng.uniform(-1, 1, 1000)]).astype(np.float32)
    bits = a.view(np.uint32)
    # exact ties: the 13 dropped bits are 1 followed by zeros
    ties = ((bits[:500] & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
            ).view(np.float32)
    a = np.concatenate([a, ties, -ties])
    hi, lo = (t.numpy() for t in tf32_split(torch.from_numpy(a)))
    assert not np.any(hi.view(np.uint32) & 0x1FFF)       # <= 10 mantissa bits
    assert not np.any(lo.view(np.uint32) & 0x1FFF)
    # nearest of the two TF32 neighbours, ties away from zero
    down = (a.view(np.uint32) & ~np.uint32(0x1FFF)).view(np.float32)
    up = (down.view(np.uint32) + np.uint32(0x2000)).view(np.float32)
    d_down = np.abs(a.astype(np.float64) - down)
    d_up = np.abs(up.astype(np.float64) - a)
    want = np.where(d_up <= d_down, up, down)            # |up| > |down|
    np.testing.assert_array_equal(hi, want)
    tie = d_up == d_down
    assert tie.sum() >= 1000 and np.all(np.abs(hi[tie]) > np.abs(a[tie]))
    err = np.abs(a.astype(np.float64) - (hi.astype(np.float64) + lo))
    assert np.all(err <= 2.0 ** -22 * np.abs(a.astype(np.float64)))
    np.testing.assert_array_equal(tf32_round(torch.from_numpy(hi)).numpy(),
                                  hi)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SHAPES)
def test_emulation_matches_jax_kernel(B, S, H, P, G, N, chunk):
    arrays = _inputs(B, S, H, P, G, N, seed=B + S)
    got = _emulate(arrays, chunk)
    assert _err(got, _pallas(arrays, chunk)) <= KERNEL_TOL
    assert _err(got, _jnp(arrays, chunk)) <= KERNEL_TOL


def test_emulation_resumes_in_two_halves():
    B, S, H, P, G, N, chunk = 2, 256, 4, 16, 2, 8, 64
    arrays = _inputs(B, S, H, P, G, N, seed=7)
    half = S // 2
    first = [t[:, :half] if t.ndim > 1 else t for t in arrays]
    second = [t[:, half:] if t.ndim > 1 else t for t in arrays]
    y1, fs1 = _emulate(first, chunk)
    y2, fs2 = _emulate(second, chunk, initial_state=fs1.numpy())
    want = _pallas(arrays, chunk)
    assert _err((torch.cat([y1, y2], 1), fs2), want) <= KERNEL_TOL
    assert _err((y2, fs2), _pallas(second, chunk,
                                   initial_state=fs1.numpy())) <= KERNEL_TOL


@pytest.mark.parametrize("S,P,chunk,valid", [(77, 40, 48, 70),
                                             (130, 8, 64, 1),
                                             (300, 16, 256, 211)])
def test_emulation_ragged_mask(S, P, chunk, valid):
    """S off the chunk grid, a chunk that is not a power of two, P off the
    8-column tiles, a mask off the chunk grid, a carried state."""
    B, H, G, N = 2, 4, 2, 16
    arrays = _inputs(B, S, H, P, G, N, seed=S)
    rng = np.random.default_rng(S + 1)
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    mask = np.arange(S)[None].repeat(B, 0) < np.array([[valid], [S - 3]])
    got = _emulate(arrays, chunk, state, mask)
    assert _err(got, _pallas(arrays, chunk, state, mask)) <= KERNEL_TOL
    assert _err(got, _jnp(arrays, chunk, state, mask)) <= KERNEL_TOL


@pytest.mark.parametrize("heads,bf16", [(2, False), (4, True), (8, False)])
def test_emulation_matches_jax_at_mamba2_widths(heads, bf16):
    arrays, state, mask = _mamba2(heads, bf16)
    chunk = MAMBA2["chunk"]
    got = _emulate(arrays, chunk, state, mask)
    assert _err(got, _pallas(arrays, chunk, state, mask)) <= KERNEL_TOL
    assert _err(got, _jnp(arrays, chunk, state, mask)) <= KERNEL_TOL


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_fail_the_check(fault):
    """Each fault breaks the check the sound emulation passes; the state
    carried in is random so that chunk 0's decay matters."""
    arrays, _, mask = _mamba2(2)
    rng = np.random.default_rng(5)
    state = rng.normal(size=(1, 2, MAMBA2["P"], MAMBA2["N"])).astype(
        np.float32)
    chunk = MAMBA2["chunk"]
    want = _pallas(arrays, chunk, state, mask)
    assert _err(_emulate(arrays, chunk, state, mask), want) <= KERNEL_TOL
    err = _err(_emulate(arrays, chunk, state, mask, **FAULTS[fault]), want)
    assert err > 2 * KERNEL_TOL, (fault, err)
