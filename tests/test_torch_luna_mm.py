"""The port's LUNA GEMM (plain version, CPU dispatch, split plans,
routing, the tensor-core kernel's arithmetic) against the JAX package.

* ``luna_mm_ref`` and ``ops.luna_mm_codes`` equal JAX's ``luna_mm_ref`` and
  its Pallas ``luna_mm_codes`` run in interpret mode, every mode, ragged
  shapes included: bitwise (the result is integer);
* ``ref.luna_mm_tc_emulate``, the tensor-core kernel's arithmetic (128 x
  128 x 128 tiles, zero-filled edges, the pre-scaled hi plane, the lo
  plane and the all-ones colsum operand in one accumulator per K tile,
  split-K by the wrapper's ``tc_split_plan``), equals both bitwise at
  shapes across its tile edges; it fails with a plane dropped, the colsum
  left out or the last K tile dropped;
* ``ops.luna_matmul_f32_kernel`` equals JAX's (interpret mode) and the
  port's library ``luna_matmul_f32`` at rtol = atol = 1e-5;
* ``takes_tc`` routes by shape, layout and alignment; a K-major
  ``w_codes`` gives the row-major result; the wrapper takes the plain
  version for CPU tensors and counts no launch, rejects bad operands, and
  the kernel route refuses bits != 4.

The kernels against their plain version on the card:
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
from repro_torch.kernels.luna_mm import ref as tref
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
    before = tkern.luna_mm.launches, tkern.luna_mm.launches_tc
    for shape in ((3, 72, 40), (512, 256, 128)):    # a dp4a, a tc shape
        y, w = _codes(*shape)
        yt, wt = torch.from_numpy(y), torch.from_numpy(w)
        for mode in MODES:
            assert torch.equal(tkern.luna_mm(yt, wt, mode),
                               luna_mm_ref(yt, wt, mode))
    assert (tkern.luna_mm.launches, tkern.luna_mm.launches_tc) == before


def test_wrapper_rejects_bad_operands():
    y, w = map(torch.from_numpy, _codes(3, 72, 40))
    with pytest.raises(ValueError, match="shapes"):
        tkern.luna_mm(y[:, :70], w)
    with pytest.raises(TypeError, match="int8"):
        tkern.luna_mm(y.int(), w)
    with pytest.raises(ValueError, match="'fast'"):
        tkern.luna_mm(y, w, "fast")
    # meta operands (the dry run) take the kernel's shapes, computing nothing
    out = tkern.luna_mm(y.to("meta"), w.to("meta"))
    assert (out.device.type, out.shape, out.dtype) == (
        "meta", (3, 40), torch.int32)
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


#: shapes across the tensor-core kernel's 128-row (64 a warpgroup),
#: 128-column and 128-byte K tiles; K = 4100 also splits K
TC_M = [17, 63, 64, 65, 129]
TC_KN = [(72, 40), (72, 520), (4100, 40), (4100, 520)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,n", TC_KN)
@pytest.mark.parametrize("m", TC_M)
def test_tc_emulation_matches_ref_and_pallas(m, k, n, mode):
    y, w = _codes(m, k, n, seed=m + k + n)
    yt, wt = torch.from_numpy(y), torch.from_numpy(w)
    splits, per = tkern.tc_split_plan(m, k, n)
    got = tref.luna_mm_tc_emulate(yt, wt, mode, splits=splits, per=per)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, luna_mm_ref(yt, wt, mode))
    want = jops.luna_mm_codes(jnp.asarray(y), jnp.asarray(w), mode=mode,
                              interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _drop_operand(index):
    base = tref.tc_operands

    def operands(y_tile, mode):
        ops = base(y_tile, mode)
        del ops[index]
        return ops
    return operands


def _drop_last_k_tile(split, per, k_tiles):
    return range(split * per, min((split + 1) * per, k_tiles - 1))


#: (mode, what is broken, the replaced function, its faulty stand-in)
TC_CONTROLS = [
    ("dc", "lo plane dropped", "tc_operands", _drop_operand(1)),
    ("opt_dc", "hi plane dropped", "tc_operands", _drop_operand(0)),
    ("approx_dc", "hi plane dropped", "tc_operands", _drop_operand(0)),
    ("conventional", "code plane dropped", "tc_operands", _drop_operand(0)),
    ("approx_dc2", "colsum left out", "tc_operands", _drop_operand(1)),
    ("opt_dc", "last K tile dropped", "tc_k_tiles", _drop_last_k_tile),
    ("approx_dc2", "last K tile dropped", "tc_k_tiles", _drop_last_k_tile),
]


@pytest.mark.parametrize("mode,what,name,fault", TC_CONTROLS,
                         ids=[f"{c[0]}-{c[1]}" for c in TC_CONTROLS])
def test_tc_emulation_controls_fail(monkeypatch, mode, what, name, fault):
    """The bitwise check above tells each fault apart."""
    m, k, n = 65, 4100, 520
    y, w = map(torch.from_numpy, _codes(m, k, n, seed=3))
    splits, per = tkern.tc_split_plan(m, k, n)
    sound = tref.luna_mm_tc_emulate(y, w, mode, splits=splits, per=per)
    assert torch.equal(sound, luna_mm_ref(y, w, mode))
    monkeypatch.setattr(tref, name, fault)
    broken = tref.luna_mm_tc_emulate(y, w, mode, splits=splits, per=per)
    assert not torch.equal(broken, luna_mm_ref(y, w, mode)), what


@pytest.mark.parametrize("m,k,n,layout,aligned,want", [
    (512, 4096, 11008, "row", True, True),
    (2048, 11008, 4096, "k", True, True),
    (512, 4096, 512, "k", True, True),
    (8, 4096, 4096, "row", True, False),          # decode: the dp4a kernel
    (8, 4096, 4096, "k", True, True),             # no transpose to pay
    (tkern.TC_MIN_M["row"], 256, 128, "row", True, True),
    (tkern.TC_MIN_M["row"] - 1, 256, 128, "row", True, False),
    (tkern.TC_MIN_M["k"], 256, 128, "k", True, True),
    (tkern.TC_MIN_M["k"] - 1, 256, 128, "k", True, False),
    (512, 4100, 4096, "row", True, False),        # ragged K
    (512, 72, 40, "k", True, False),
    (512, 4096, 4104, "row", True, False),        # N % 16 != 0
    (512, 4096, 4096, "row", False, False),       # misaligned base
    (512, 4096, 4096, None, True, False),         # neither layout
])
def test_takes_tc_routes_by_shape_layout_alignment(m, k, n, layout, aligned,
                                                   want):
    assert tkern.takes_tc(m, k, n, layout, aligned) is want


def test_w_layout_reads_strides():
    w = torch.zeros((64, 48), dtype=torch.int8)
    assert tkern.w_layout(w) == "row"
    assert tkern.w_layout(w.t().contiguous().t()) == "k"
    assert tkern.w_layout(w[:, ::2]) is None
    assert tkern.w_layout(torch.zeros((64, 96), dtype=torch.int8)[:, :48]) \
        is None


@pytest.mark.parametrize("mode", MODES)
def test_kmajor_w_matches_row_major_on_cpu(mode):
    y, w = map(torch.from_numpy, _codes(65, 144, 128, seed=4))
    wk = w.t().contiguous().t()
    assert wk.stride() == (1, 144)
    assert torch.equal(tkern.luna_mm(y, wk, mode), tkern.luna_mm(y, w, mode))


@pytest.mark.parametrize("m,k,n", [(512, 4096, 11008), (512, 4096, 512),
                                   (8, 4096, 4096), (2048, 11008, 4096),
                                   (17, 4100, 40), (129, 4100, 520)])
def test_tc_split_plan_tiles_k_exactly(m, k, n):
    splits, per = tkern.tc_split_plan(m, k, n)
    k_tiles = -(-k // tkern.TC_BLOCK_K)
    assert (splits - 1) * per < k_tiles <= splits * per
    tiles = -(-m // tkern.TC_BLOCK_M) * -(-n // tkern.TC_BLOCK_N)
    if 2 * tiles > tkern.TC_TARGET_BLOCKS:
        assert splits == 1
    else:
        assert tiles * splits <= tkern.TC_TARGET_BLOCKS
        assert splits == k_tiles or 2 * tiles * splits > \
            tkern.TC_TARGET_BLOCKS
