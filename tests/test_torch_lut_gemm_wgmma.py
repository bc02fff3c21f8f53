"""The full-table ``lut_gemm``'s tensor-core kernels, their arithmetic
emulated on the CPU, against the JAX package.

* ``ref.tc_pieces`` of a codebook (NF4's and random ones): three bf16
  pieces that sum back to it bitwise, truncated toward zero, every partial
  sum in the entry's binade (what keeps x = I bitwise on the tensor cores);
* ``ref.lut_gemm_tc_full_emulate`` (``lut_gemm_tc.cu``'s full-table mode:
  16-row steps, warps and cluster ranks summed in a fixed order, no zero
  point) and ``ref.lut_gemm_wgmma_emulate`` (``lut_gemm_wgmma.cu``: 64-row
  stages split across cluster ranks, 16-row steps, pieces in order into one
  accumulator, ranks in rank order, the scale after the sum) each equal
  JAX's Pallas ``lut_gemm`` run in interpret mode at 1e-4, and read
  ``CB[q] * scale`` back bitwise at x = rows of I;
* three faults fail those checks: the third piece dropped, p1 rounded
  instead of truncated, a split that counts its last step twice;
* ``route`` sends bf16 x at M <= 32 to the decode kernel, at M >=
  ``WGMMA_MIN_M`` with K and N multiples of 16 to the prefill kernel, and
  f32 x, misaligned bases and ragged shapes to ``lut_gemm.cu``; the split
  plan keeps every rank some stages; CPU calls count no launch.

The kernels themselves against their plain version on the card:
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lut import NF4_CODEBOOK
from repro.kernels.lut_gemm import lut_gemm as jkern
from repro_torch.kernels.lut_gemm import lut_gemm as tkern
from repro_torch.kernels.lut_gemm import ref as tref

#: (M, K, N, bk of the Pallas grid): test_torch_lut_gemm.py's shapes (a
#: ragged single block, multi-K-step tilings), then K off the 64-row
#: stages with several ranks, M across the tensor-core decode kernel's
#: 32 and the prefill kernel's 64-row tile
SHAPES = [(3, 72, 40, 72), (8, 64, 48, 32), (16, 128, 96, 64),
          (32, 336, 64, 112), (40, 400, 144, 80), (72, 208, 32, 208)]


def _codebooks():
    rng = np.random.default_rng(13)
    out = {"nf4": np.asarray(NF4_CODEBOOK, dtype=np.float32)}
    for i in range(3):
        out[f"random{i}"] = np.sort(rng.normal(size=16) * 10.0 ** (2 * i - 2)
                                    ).astype(np.float32)
    return out


CODEBOOKS = _codebooks()


def _problem(m, k, n, codebook="nf4", seed=0):
    """x in bf16 (as the kernels take it), codes, codebook and scale, as
    torch tensors and as the f32 numpy arrays JAX takes."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         ).bfloat16()
    codes = rng.integers(0, 16, (k, n)).astype(np.int8)
    cb = CODEBOOKS[codebook]
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    torch_args = (x, torch.from_numpy(codes), torch.from_numpy(cb),
                  torch.from_numpy(scale))
    jax_args = (x.float().numpy(), codes, cb, scale)
    return torch_args, jax_args


def _pallas(jax_args, bk):
    m, k = jax_args[0].shape
    n = jax_args[1].shape[1]
    return np.asarray(jkern.lut_gemm(*map(jnp.asarray, jax_args), bm=m, bn=n,
                                     bk=bk, interpret=True))


def _tc(x, codes, cb, scale, splits=None):
    m, k = x.shape
    return tref.lut_gemm_tc_full_emulate(
        x, codes, cb, scale,
        splits=splits or tkern.tc_split_plan(m, k, codes.shape[1]))


def _wgmma(x, codes, cb, scale, splits=None):
    m, k = x.shape
    return tref.lut_gemm_wgmma_emulate(
        x, codes, cb, scale,
        splits=splits or tkern.wgmma_split_plan(m, k, codes.shape[1]))


EMULATIONS = {"tc": _tc, "wgmma": _wgmma}


@pytest.mark.parametrize("name", sorted(CODEBOOKS))
def test_full_table_pieces_sum_to_codebook_bitwise(name):
    cb = torch.from_numpy(CODEBOOKS[name])
    pieces = tref.tc_pieces(cb)
    total = pieces[0]
    for p in pieces[1:]:
        total = total + p
    assert torch.equal(total, cb)
    for p in pieces:
        assert torch.equal(p.bfloat16().float(), p)
    assert len(pieces) == 3


def _partial_sums_in_binade(cb):
    """Every partial sum of the pieces (p1, p1 + p2, p1 + p2 + p3) has the
    entry's sign, at most its magnitude and its binade."""
    pieces = tref.tc_pieces(cb)
    nz = cb != 0
    _, e_cb = torch.frexp(cb[nz])
    s = torch.zeros_like(cb)
    for p in pieces:
        s = s + p
        _, e = torch.frexp(s[nz])
        if not (torch.equal(e, e_cb) and bool((s.abs() <= cb.abs()).all())
                and bool((s * cb >= 0).all())):
            return False
    return True


@pytest.mark.parametrize("name", sorted(CODEBOOKS))
def test_full_table_partial_sums_stay_in_binade(name):
    assert _partial_sums_in_binade(torch.from_numpy(CODEBOOKS[name]))


@pytest.mark.parametrize("route,m,k,n,bk", [
    (route, *shape) for route in sorted(EMULATIONS) for shape in SHAPES
    if route == "wgmma" or shape[0] <= tkern.TC_MAX_M])
def test_emulation_matches_pallas(route, m, k, n, bk):
    torch_args, jax_args = _problem(m, k, n)
    got = EMULATIONS[route](*torch_args)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), _pallas(jax_args, bk),
                               rtol=tkern.KERNEL_RTOL, atol=tkern.KERNEL_ATOL)


@pytest.mark.parametrize("codebook", ["random0", "random2"])
@pytest.mark.parametrize("route", sorted(EMULATIONS))
def test_emulation_matches_pallas_arbitrary_codebook(route, codebook):
    m, k, n, bk = 16, 400, 80, 80
    torch_args, jax_args = _problem(m, k, n, codebook, seed=4)
    np.testing.assert_allclose(
        EMULATIONS[route](*torch_args).numpy(), _pallas(jax_args, bk),
        rtol=tkern.KERNEL_RTOL, atol=tkern.KERNEL_ATOL)


def _eye_bitwise(route, k, n, rows, splits=None, seed=0):
    """x = I, ``rows`` a call: every row of ``CB[q] * scale`` read back
    bitwise."""
    (_, codes, cb, scale), _ = _problem(1, k, n, seed=seed)
    want = cb[codes.long()] * scale[None, :]
    eye = torch.eye(k, dtype=torch.bfloat16)
    for r in range(0, k, rows):
        got = EMULATIONS[route](eye[r:r + rows], codes, cb, scale, splits)
        if not torch.equal(got, want[r:r + rows]):
            return False
    return True


@pytest.mark.parametrize("route,rows,splits", [
    ("tc", 8, None), ("tc", 32, 3), ("wgmma", 64, None), ("wgmma", 200, 1),
    ("wgmma", 200, 3)])
def test_emulation_reads_codebook_back_bitwise(route, rows, splits):
    assert _eye_bitwise(route, 200, 96, rows, splits)


SOUND_PIECES = tref.tc_pieces
SOUND_WARP_STEPS = tref.tc_warp_steps
SOUND_STAGES = tref.wgmma_split_stages


def _drop_piece_3(table):
    return SOUND_PIECES(table)[:2]


def _round_p1(table):
    p1 = table.bfloat16().float()           # to nearest, not truncated
    r1 = table - p1
    p2 = (r1.view(torch.int32) & -65536).view(torch.float32)
    return [p1, p2, r1 - p2]


def _last_step_twice(split, warp):
    steps = list(SOUND_WARP_STEPS(split, warp))
    return steps + steps[-1:]


def _last_stage_twice(rank, k, splits):
    stages = list(SOUND_STAGES(rank, k, splits))
    return stages + stages[-1:]


#: (what is broken, the route, the replaced function, its faulty stand-in,
#: the check that must fail: "eye" bitwise at x = I, "binade" the pieces'
#: partial sums, "pallas" 1e-4 against JAX)
CONTROLS = [
    ("third piece dropped", "tc", "tc_pieces", _drop_piece_3, "eye"),
    ("third piece dropped", "wgmma", "tc_pieces", _drop_piece_3, "eye"),
    ("p1 rounded", "tc", "tc_pieces", _round_p1, "binade"),
    ("p1 rounded", "wgmma", "tc_pieces", _round_p1, "binade"),
    ("last step counted twice", "tc", "tc_warp_steps", _last_step_twice,
     "pallas"),
    ("last stage of a split counted twice", "wgmma", "wgmma_split_stages",
     _last_stage_twice, "pallas"),
]


@pytest.mark.parametrize("what,route,name,fault,check", CONTROLS,
                         ids=[f"{c[1]}: {c[0]}" for c in CONTROLS])
def test_emulation_controls_fail(monkeypatch, what, route, name, fault,
                                 check):
    m, k, n, bk = (8, 400, 80, 80) if route == "tc" else (40, 400, 80, 80)
    torch_args, jax_args = _problem(m, k, n, seed=5)
    want = _pallas(jax_args, bk) if check == "pallas" else None

    def passes():
        if check == "eye":
            return _eye_bitwise(route, 136, 48, 8 if route == "tc" else 64)
        if check == "binade":
            return _partial_sums_in_binade(torch.from_numpy(CODEBOOKS["nf4"]))
        return np.allclose(EMULATIONS[route](*torch_args, 3).numpy(), want,
                           rtol=tkern.KERNEL_RTOL, atol=tkern.KERNEL_ATOL)

    assert passes()
    monkeypatch.setattr(tref, name, fault)
    assert not passes(), what


@pytest.mark.parametrize("m,k,n,dtype,aligned,want", [
    (8, 4096, 4096, torch.bfloat16, True, "tc"),        # yi-9b decode
    (1, 4096, 512, torch.bfloat16, True, "tc"),
    (32, 11008, 4096, torch.bfloat16, True, "tc"),      # prefill bucket 32
    (33, 4096, 4096, torch.bfloat16, True, "wgmma"),
    (48, 4096, 512, torch.bfloat16, True, "wgmma"),
    (448, 4096, 11008, torch.bfloat16, True, "wgmma"),
    (512, 11008, 4096, torch.bfloat16, True, "wgmma"),
    (100, 528, 4112, torch.bfloat16, True, "wgmma"),    # ragged tiles
    (8, 4096, 4096, torch.float32, True, "fma"),        # f32 x
    (512, 4096, 4096, torch.float32, True, "fma"),
    (8, 4096, 4096, torch.bfloat16, False, "fma"),      # misaligned base
    (512, 4096, 4096, torch.bfloat16, False, "fma"),
    (8, 4096, 4104, torch.bfloat16, True, "fma"),       # N % 16 != 0
    (512, 4096, 4104, torch.bfloat16, True, "fma"),
    (8, 4098, 4096, torch.bfloat16, True, "fma"),       # K % 4 != 0
    (8, 4104, 4096, torch.bfloat16, True, "tc"),        # K % 16 != 0
    (512, 4104, 4096, torch.bfloat16, True, "fma"),
])
def test_route_by_dtype_shape_alignment(m, k, n, dtype, aligned, want):
    assert tkern.route(m, k, n, dtype, aligned) == want


@pytest.mark.parametrize("m,k,n", [(33, 4096, 512), (48, 11008, 4096),
                                   (512, 4096, 11008), (176, 4096, 4096),
                                   (64, 64, 128), (100, 528, 4112)])
def test_wgmma_split_plan_gives_every_rank_stages(m, k, n):
    """Within the cluster and the stages; the ranks' stages cover K once,
    each rank some; the row tile is one of the kernel's, in as few tiles
    as it allows."""
    bm, (lo, hi) = tkern.wgmma_tile_m(m), tkern.WG_TILE_M
    assert lo <= bm <= hi and bm % 16 == 0
    assert -(-m // bm) == -(-m // hi)
    for clusters in (None, lambda s: 120 // s):
        splits = tkern.wgmma_split_plan(m, k, n, clusters)
        assert 1 <= splits <= tkern.WG_MAX_CLUSTER
        seen = []
        for rank in range(splits):
            stages = tref.wgmma_split_stages(rank, k, splits)
            assert len(stages) > 0
            seen += list(stages)
        assert seen == list(range(-(-k // tref.WG_BK)))


def test_cpu_calls_count_no_tensor_core_launch():
    (x, codes, cb, scale), _ = _problem(40, 72, 48)
    f = tkern.lut_gemm
    before = (f.launches, f.launches_tc, f.launches_wgmma)
    assert torch.equal(f(x, codes, cb, scale),
                       tref.lut_gemm_ref(x, codes, cb, scale))
    f(x[:8], codes, cb, scale)
    assert (f.launches, f.launches_tc, f.launches_wgmma) == before
