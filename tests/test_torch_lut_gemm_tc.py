"""The D&C LUT GEMMs' tensor-core kernel (``csrc/lut_gemm_tc.cu``), its
arithmetic emulated on the CPU, against the JAX package.

* ``ref.tc_pieces``: the three bf16 pieces of the 16-entry table sum back
  to it bitwise (lut4, nf4, nf4p and random tables), each is a bf16 value,
  and lut4's code-space table needs one;
* ``ref.lut_gemm_tc_emulate`` (pieces, 16-row steps, each warp's split
  with its zero point ``fmaf(-rowsum, zp, acc)``, warps and cluster ranks
  summed in a fixed order, then the scale) equals JAX's Pallas ``lut_gemm_dc`` / ``lut_gemm_dc_res`` run
  in interpret mode at 1e-4, and reads the dequantized weight back bitwise
  at x = rows of I taken 8 at a time;
* three faults fail those checks: piece 3 dropped (x = I no longer
  bitwise), the zero-point term left out, the last K step of a split
  dropped;
* ``takes_tc`` sends bf16 x at M <= 32 with N % 16 == 0, K % 4 == 0 and
  aligned bases to the tensor-core kernel and everything else to
  ``lut_gemm.cu``; ``tc_split_plan`` stays within the cluster and the K
  steps; CPU tensors count no launch of either kernel.

The kernel itself against its plain version on the card:
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.lut_gemm import lut_gemm as jkern
from repro_torch.core import quant as tq
from repro_torch.kernels.lut_gemm import lut_gemm as tkern
from repro_torch.kernels.lut_gemm import ref as tref

#: (kernel, prune threshold): lut4, nf4, nf4p
QUANTS = [("lut_dc", None), ("nf4_dc", None),
          ("nf4_dc", tq.NF4P_PRUNE_THRESHOLD)]
QUANT_IDS = ["lut4", "nf4", "nf4p"]
#: (M, K, N, bk of the Pallas grid): decode M, K off the 16-row steps,
#: splits that leave warps without steps, M up to the kernel's 32
SHAPES = [(1, 64, 48, 64), (8, 256, 128, 128), (3, 72, 48, 72),
          (16, 520, 80, 104), (32, 512, 144, 256)]


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


def _x_bf16(m, k, seed=1):
    """x in bf16 (the kernel's input) and the same values in f32."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(m, k)).astype(np.float32)).bfloat16()
    return x, x.float().numpy()


def _emulate(x, q, splits):
    return tref.lut_gemm_tc_emulate(x, q.codes, q.hi_tab, q.lo_tab,
                                    q.zero_point, q.scale, q.residual,
                                    splits=splits)


def _tables():
    rng = np.random.default_rng(11)
    out = {}
    for (kernel, prune), name in zip(QUANTS, QUANT_IDS):
        _, q = _frozen(32, 16, kernel, prune)
        out[name] = tref.tc_table(q.hi_tab, q.lo_tab, q.residual)
    for i in range(3):
        hi, lo, res = (torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                        * 10.0 ** (2 * i - 2))
                       for s in (4, 4, 16))
        out[f"random{i}"] = tref.tc_table(hi, lo, res)
    return out


TABLES = _tables()


@pytest.mark.parametrize("name", sorted(TABLES))
def test_pieces_sum_to_table_bitwise(name):
    table = TABLES[name]
    pieces = tref.tc_pieces(table)
    total = pieces[0]
    for p in pieces[1:]:
        total = total + p
    assert torch.equal(total, table)
    for p in pieces:
        assert torch.equal(p.bfloat16().float(), p)
    assert len(pieces) == (1 if name == "lut4" else 3)


@pytest.mark.parametrize("m,k,n,bk", SHAPES)
@pytest.mark.parametrize("quant", range(3), ids=QUANT_IDS)
def test_emulation_matches_pallas(quant, m, k, n, bk):
    kernel, prune = QUANTS[quant]
    jqw, tqw = _frozen(k, n, kernel, prune)
    x, xf = _x_bf16(m, k)
    if kernel == "lut_dc":
        want = jkern.lut_gemm_dc(jnp.asarray(xf), jqw.codes, jqw.hi_tab,
                                 jqw.lo_tab, jqw.zero_point, jqw.scale,
                                 bm=m, bn=n, bk=bk, interpret=True)
    else:
        want = jkern.lut_gemm_dc_res(
            jnp.asarray(xf), jqw.codes, jqw.hi_tab, jqw.lo_tab, jqw.residual,
            jqw.zero_point, jqw.scale, bm=m, bn=n, bk=bk, interpret=True)
    got = _emulate(x, tqw, tkern.tc_split_plan(m, k, n))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=tkern.KERNEL_RTOL,
                               atol=tkern.KERNEL_ATOL)


def _eye_bitwise(q, k, n, splits=None):
    """x = I, 8 rows a call: every row of the weight read back bitwise."""
    want = tref.dc_dequant(q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                           q.residual) * q.scale[None, :]
    eye = torch.eye(k, dtype=torch.bfloat16)
    for r in range(0, k, 8):
        got = _emulate(eye[r:r + 8], q,
                       splits or tkern.tc_split_plan(8, k, n))
        if not torch.equal(got, want[r:r + 8]):
            return False
    return True


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("quant", range(3), ids=QUANT_IDS)
def test_emulation_reads_weight_back_bitwise(quant, splits):
    kernel, prune = QUANTS[quant]
    _, q = _frozen(136, 96, kernel, prune, seed=quant)
    assert _eye_bitwise(q, 136, 96, splits)


SOUND_PIECES, SOUND_SPLIT_STEPS = tref.tc_pieces, tref.tc_split_steps


def _drop_piece_3(table):
    return SOUND_PIECES(table)[:2]


def _no_zero_point(acc, rowsum, zero_point):
    return acc


def _drop_last_step(rank, k, splits):
    s = SOUND_SPLIT_STEPS(rank, k, splits)
    return range(s.start, max(s.start, s.stop - 1))


#: (what is broken, the replaced function, its faulty stand-in, the check
#: that must fail: "eye" bitwise at x = I, "pallas" 1e-4 against JAX)
TC_CONTROLS = [
    ("piece 3 dropped", "tc_pieces", _drop_piece_3, "eye"),
    ("zero point left out", "tc_zero_point", _no_zero_point, "pallas"),
    ("last K step of a split dropped", "tc_split_steps", _drop_last_step,
     "pallas"),
]


@pytest.mark.parametrize("what,name,fault,check", TC_CONTROLS,
                         ids=[c[0] for c in TC_CONTROLS])
def test_emulation_controls_fail(monkeypatch, what, name, fault, check):
    """The checks above tell each fault apart (nf4p's table has three
    pieces; lut4's zero points are nonzero)."""
    kernel, prune = QUANTS[2] if check == "eye" else QUANTS[0]
    m, k, n = 8, 520, 80
    jqw, tqw = _frozen(k, n, kernel, prune, seed=5)
    x, xf = _x_bf16(m, k, seed=6)
    want = np.asarray(jkern.lut_gemm_dc(
        jnp.asarray(xf), jqw.codes, jqw.hi_tab, jqw.lo_tab, jqw.zero_point,
        jqw.scale, bm=m, bn=n, bk=104, interpret=True)) \
        if kernel == "lut_dc" else None

    def passes():
        if check == "eye":
            return _eye_bitwise(tqw, k, n)
        return np.allclose(_emulate(x, tqw, tkern.tc_split_plan(m, k, n))
                           .numpy(), want, rtol=tkern.KERNEL_RTOL,
                           atol=tkern.KERNEL_ATOL)

    assert passes()
    monkeypatch.setattr(tref, name, fault)
    assert not passes(), what


@pytest.mark.parametrize("m,k,n,dtype,aligned,want", [
    (8, 4096, 4096, torch.bfloat16, True, True),     # yi-9b decode
    (8, 2048, 8512, torch.bfloat16, True, True),     # mamba2 w_in
    (1, 4096, 512, torch.bfloat16, True, True),
    (tkern.TC_MAX_M, 11008, 4096, torch.bfloat16, True, True),
    (tkern.TC_MAX_M + 1, 4096, 4096, torch.bfloat16, True, False),
    (256, 256, 4096, torch.bfloat16, True, False),   # x = I at once
    (8, 4096, 4096, torch.float32, True, False),     # f32 x
    (8, 4096, 4104, torch.bfloat16, True, False),    # N % 16 != 0
    (3, 72, 40, torch.bfloat16, True, False),
    (8, 4098, 4096, torch.bfloat16, True, False),    # K % 4 != 0
    (8, 4096, 4096, torch.bfloat16, False, False),   # misaligned base
])
def test_takes_tc_routes_by_dtype_shape_alignment(m, k, n, dtype, aligned,
                                                  want):
    assert tkern.takes_tc(m, k, n, dtype, aligned) is want


@pytest.mark.parametrize("m,k,n", [(8, 4096, 512), (8, 4096, 11008),
                                   (32, 11008, 4096), (8, 2048, 8512),
                                   (1, 64, 48), (8, 8, 16), (16, 520, 80)])
def test_tc_split_plan_within_cluster_and_steps(m, k, n):
    splits = tkern.tc_split_plan(m, k, n)
    assert 1 <= splits <= tkern.TC_MAX_CLUSTER
    assert splits <= -(-k // tkern.TC_KSTEP)
    tiles = -(-n // tkern.TC_BLOCK_N)
    assert splits == 1 or tiles * splits <= 2 * tkern.SMS
    # every rank has steps, and the warps' runs cover the K steps once
    seen = []
    for rank in range(splits):
        split = tref.tc_split_steps(rank, k, splits)
        assert len(split) > 0
        for warp in range(tref.TC_WARPS):
            seen += list(tref.tc_warp_steps(split, warp))
    assert seen == list(range(-(-k // tref.TC_KSTEP)))


def test_cpu_calls_count_no_tensor_core_launch():
    _, qa = _frozen(72, 48, "lut_dc")
    _, qn = _frozen(72, 48, "nf4_dc", tq.NF4P_PRUNE_THRESHOLD)
    x = _x_bf16(8, 72)[0]
    before = (tkern.lut_gemm_dc.launches_tc,
              tkern.lut_gemm_dc_res.launches_tc)
    assert torch.equal(
        tkern.lut_gemm_dc(x, qa.codes, qa.hi_tab, qa.lo_tab, qa.zero_point,
                          qa.scale),
        tref.lut_gemm_dc_ref(x, qa.codes, qa.hi_tab, qa.lo_tab,
                             qa.zero_point, qa.scale))
    tkern.lut_gemm_dc_res(x, qn.codes, qn.hi_tab, qn.lo_tab, qn.residual,
                          qn.zero_point, qn.scale)
    assert (tkern.lut_gemm_dc.launches_tc,
            tkern.lut_gemm_dc_res.launches_tc) == before
