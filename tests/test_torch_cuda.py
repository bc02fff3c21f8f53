"""The port's hand-written kernels on the card (every test marked ``cuda``;
each skips without a GPU).  This file imports no jax, so it also runs on a
machine with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

* ``lut_gemm_dc`` / ``lut_gemm_dc_res`` / ``lut_gemm`` against their plain
  versions at the tolerance stated in ``kernels/lut_gemm/lut_gemm.py``;
  the dequantized weight (x = I) bitwise; the D&C wrappers' tensor-core
  kernel (bf16 x, M <= 32: ``lut_gemm_tc.cu``) the same way, x = I taken
  8 rows a call, the kernel each call ran read from ``launches_tc``; the
  full-table ``lut_gemm`` on each of its kernels (``route``: the decode
  kernel's full-table mode at M <= 32, ``lut_gemm_wgmma.cu`` above,
  ``lut_gemm.cu`` for f32 and shapes TMA cannot take) the same way, at
  decode and prefill M, ragged shapes and yi-9b's projections, each call
  on the kernel ``route`` names (``launches_tc`` / ``launches_wgmma``);
* ``luna_mm`` against its plain version, bitwise, every mode, on a
  row-major and a K-major W, across the tensor-core kernel's tile edges,
  each call's kernel (``launches_tc``) the one ``takes_tc`` names;
* ``quant_matmul`` on CUDA tensors against the CPU's on identical f32
  inputs, every model-level mode (1e-5), the LUNA int32 accumulators
  bitwise;
* ``ssd_scan`` against its plain version (``models.ssm._ssd_chunked`` on
  the card) at the tolerance stated in ``kernels/ssd_scan/ssd_scan.py``:
  ragged S, chunks that are not powers of two, a mask off the chunk grid,
  a carried initial state, G = 2, P not a multiple of 32; and a reduced
  f32 mamba2 prefill (through the kernel) against the CPU's (1e-4);
* ``flash_attention`` against its plain version on the same input values
  (``flash_attention.reference``: the SIMT kernel, f32 and bf16 at D < 64,
  against ``attention_ref``; the tensor-core kernel, bf16 at D in {64,
  128}, against ``attention_ref_tiled``; and JAX's 2e-2 against the
  unrounded inputs) at JAX's test shapes, S off the 64- and 128-row tiles
  and yi-9b's heads, causal and not, with the launch counters; and
  reduced f32 yi-9b training on the card against the CPU: the flash
  forward, the loss and gradients (chunked, and luna_approx through the
  STE on luna_mm) and one train step.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import luna as tl
from repro_torch.core import quant as tq
from repro_torch.core.layers import QUANT_MODES, QuantConfig, quant_matmul
from repro_torch.core.lut import NF4_CODEBOOK
from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.luna_mm import luna_mm as lkern
from repro_torch.kernels.luna_mm.ops import luna_mm_codes
from repro_torch.kernels.luna_mm.ref import luna_mm_ref
from repro_torch.kernels.lut_gemm import lut_gemm as tkern
from repro_torch.kernels.lut_gemm import ops as tops
from repro_torch.kernels.lut_gemm import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan as skern
from repro_torch.models.registry import get_config, get_model
from repro_torch.models.ssm import _ssd_chunked

pytestmark = pytest.mark.cuda
MODES = [m.value for m in tl.LunaMode]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 4096, 512), (8, 4096, 4096),
                                   (3, 72, 40)])
def test_kernels_match_plain_on_card(dev, m, k, n):
    """Each LUT GEMM kernel against its plain version; x = I bitwise (for
    the full-table kernel: ``CB[q] * scale``)."""
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
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    codes, scale = tops.codebook_quantize(w, cb)
    x = torch.randn((m, k), device=dev, dtype=torch.bfloat16)
    torch.testing.assert_close(tkern.lut_gemm(x, codes, cb, scale),
                               tref.lut_gemm_ref(x, codes, cb, scale),
                               rtol=tkern.KERNEL_RTOL, atol=tkern.KERNEL_ATOL)
    eye = torch.eye(k, device=dev, dtype=torch.bfloat16)[:min(k, 256)]
    assert torch.equal(tkern.lut_gemm(eye, codes, cb, scale),
                       (cb[codes.long()] * scale[None, :])[:eye.shape[0]])


def _dc_weights(dev, k, n):
    """lut4's and nf4p's frozen weights of one (K, N) matrix, with the
    D&C wrapper, its plain version and the tables each takes."""
    gen = torch.Generator(device=dev).manual_seed(k + n)
    w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
    out = []
    for kernel, fn, ref in (
            ("lut_dc", tkern.lut_gemm_dc, tref.lut_gemm_dc_ref),
            ("nf4_dc", tkern.lut_gemm_dc_res, tref.lut_gemm_dc_res_ref)):
        q = tq.quantize_weight(w, kernel, tq.NF4P_PRUNE_THRESHOLD
                               if kernel == "nf4_dc" else None)
        tables = ((q.hi_tab, q.lo_tab) if kernel == "lut_dc"
                  else (q.hi_tab, q.lo_tab, q.residual))
        out.append((fn, ref, q, (q.codes, *tables, q.zero_point, q.scale)))
    return out


@pytest.mark.parametrize("m,k,n", [(1, 4096, 512), (8, 4096, 4096),
                                   (16, 4096, 11008), (32, 11008, 4096),
                                   (8, 2048, 8512), (29, 1000, 208),
                                   (3, 72, 48)])
def test_lut_gemm_tc_matches_plain_on_card(dev, m, k, n):
    """The tensor-core route of both D&C wrappers against its plain
    version at the kernel tolerance; ``launches_tc`` counts the call."""
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=dev, dtype=torch.bfloat16)
    assert tkern.takes_tc(m, k, n, x.dtype, True)
    for fn, ref, _, args in _dc_weights(dev, k, n):
        tc0 = fn.launches_tc
        got = fn(x, *args)
        torch.cuda.synchronize()
        assert fn.launches_tc - tc0 == 1
        torch.testing.assert_close(got, ref(x, *args),
                                   rtol=tkern.KERNEL_RTOL,
                                   atol=tkern.KERNEL_ATOL)


def test_lut_gemm_tc_reads_weight_back_bitwise_on_card(dev):
    """x = rows of I, 8 a call (the tensor-core route), reads every row of
    a (256, 4096) weight back bitwise: ``(T[q] - zp) * scale``."""
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    for fn, _, q, args in _dc_weights(dev, 256, 4096):
        want = tref.dc_dequant(q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                               q.residual) * q.scale[None, :]
        tc0 = fn.launches_tc
        for r in range(0, 256, 8):
            assert torch.equal(fn(eye[r:r + 8], *args), want[r:r + 8]), r
        assert fn.launches_tc - tc0 == 32


#: M of the full-table routes: decode sizes, the decode kernel's edge and
#: the prefill kernel's row tiles (33 .. 64: one of 64 rows; 100: 112; 176:
#: 176; 272: two of 144; 448: three of 160; 512: three of 176)
FULL_M = [1, 8, 32, 33, 48, 64, 100, 176, 272, 448, 512]
#: (K, N): yi-9b's projections, ragged ones the prefill kernel takes
#: (K off its 64-row stages, N off its 128-column tiles) and ones it does
#: not (K or N not a multiple of 16: lut_gemm.cu)
FULL_SHAPES = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
               (528, 4112), (4104, 520), (4104, 528)]


def _full_call(dev, x, codes, scale):
    """One public lut_gemm call; returns it and the kernel it ran."""
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    f = tkern.lut_gemm
    before = (f.launches, f.launches_tc, f.launches_wgmma)
    out = f(x, codes, cb, scale)
    torch.cuda.synchronize()
    ran = (f.launches - before[0], f.launches_tc - before[1],
           f.launches_wgmma - before[2])
    assert ran[0] == 1 and ran[1] + ran[2] <= 1
    return out, "tc" if ran[1] else "wgmma" if ran[2] else "fma"


@pytest.mark.parametrize("k,n", FULL_SHAPES)
@pytest.mark.parametrize("m", FULL_M)
def test_lut_gemm_routes_match_plain_on_card(dev, m, k, n):
    """The full-table lut_gemm on the kernel ``route`` names, at 1e-4 of
    its plain version, for bf16 x; f32 x on lut_gemm.cu."""
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
    codes, scale = tops.codebook_quantize(w.bfloat16(), cb)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((m, k), generator=gen, device=dev, dtype=dtype)
        got, ran = _full_call(dev, x, codes, scale)
        assert ran == tkern.route(m, k, n, dtype, True)
        torch.testing.assert_close(got, tref.lut_gemm_ref(x, codes, cb, scale),
                                   rtol=tkern.KERNEL_RTOL,
                                   atol=tkern.KERNEL_ATOL)
        if dtype == torch.bfloat16 and k % 16 == 0 and n % 16 == 0:
            assert ran == ("tc" if m <= tkern.TC_MAX_M else "wgmma")


@pytest.mark.parametrize("rows", [8, 32, 64, 176, 256])
def test_lut_gemm_routes_read_weight_back_bitwise_on_card(dev, rows):
    """x = rows of I, ``rows`` a call (the decode kernel up to 32, the
    prefill kernel above), reads every row of ``CB[q] * scale`` of a (256,
    4096) weight back bitwise."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    w = torch.randn((256, 4096), generator=gen, device=dev) / 16
    codes, scale = tops.codebook_quantize(w.bfloat16(), cb)
    want = cb[codes.long()] * scale[None, :]
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    for r in range(0, 256, rows):
        got, ran = _full_call(dev, eye[r:r + rows], codes, scale)
        assert ran == tkern.route(min(rows, 256 - r), 256, 4096,
                                  torch.bfloat16, True)
        assert torch.equal(got, want[r:r + rows]), r


@pytest.mark.parametrize("m,k,n", [(8, 4096, 512), (8, 11008, 4096),
                                   (512, 4096, 11008), (3, 72, 40),
                                   (17, 70, 9), (2048, 4096, 512),
                                   (32, 11008, 4096), (64, 128, 16),
                                   (65, 144, 128), (129, 4112, 520),
                                   (200, 4096, 48)])
def test_luna_mm_matches_plain_on_card(dev, m, k, n):
    """Bitwise in every mode (the result is integer), on a row-major and a
    K-major W; the kernel each call ran, read from ``launches_tc``, is the
    one ``takes_tc`` names."""
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.randint(0, 16, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    wk = w.t().contiguous().t()
    for mode in MODES:
        want = luna_mm_ref(y, w, mode)
        for layout, ww in (("row", w), ("k", wk)):
            tc0 = lkern.luna_mm.launches_tc
            got = lkern.luna_mm(y, ww, mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (mode, layout)
            assert (lkern.luna_mm.launches_tc - tc0
                    == lkern.takes_tc(m, k, n, layout, True)), (mode, layout)


def test_quant_matmul_card_matches_cpu(dev):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(4, 8, 512)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(512, 384)) / 8).astype(np.float32))
    for mode in QUANT_MODES:
        cfg = QuantConfig(mode=mode)
        torch.testing.assert_close(quant_matmul(x.to(dev), w.to(dev),
                                                cfg).cpu(),
                                   quant_matmul(x, w, cfg), rtol=1e-5,
                                   atol=1e-5)
    qx = tq.quantize(x, tq.calibrate(x, 4)).reshape(-1, 512)
    qw = tq.quantize(w, tq.calibrate(w, 4, axis=-1))
    for mode in MODES:
        assert torch.equal(luna_mm_codes(qx.to(dev), qw.to(dev), mode=mode)
                           .cpu(), tl.luna_matmul(qx, qw, mode=mode))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,valid,init", [
    (1, 77, 4, 16, 2, 8, 32, None, False),     # ragged S, G = 2
    (2, 48, 4, 64, 1, 128, 48, None, False),   # Q = 48, mamba2's P and N
    (2, 130, 2, 40, 2, 16, 64, 70, True),      # mask, initial state, P = 40
    (1, 300, 2, 64, 1, 128, 256, 211, True),   # two chunks of 256, masked
    (1, 1, 2, 8, 1, 8, 1, None, True),         # one position
])
def test_ssd_scan_matches_plain_on_card(dev, B, S, H, P, G, N, chunk, valid,
                                        init):
    gen = torch.Generator(device=dev).manual_seed(S)
    x = torch.randn((B, S, H, P), generator=gen, device=dev)
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
    b = torch.randn((B, S, G, N), generator=gen, device=dev)
    c = torch.randn((B, S, G, N), generator=gen, device=dev)
    s0 = (torch.randn((B, H, P, N), generator=gen, device=dev) if init
          else None)
    mask = (None if valid is None
            else (torch.arange(S, device=dev) < valid)[None].expand(B, S)
            .contiguous())
    before = skern.ssd_scan.launches
    y, fs = skern.ssd_scan(x, dt, a, b, c, chunk=chunk, initial_state=s0,
                           mask=mask)
    assert skern.ssd_scan.launches == before + 1
    y0, fs0 = _ssd_chunked(x, dt, a, b, c, chunk, initial_state=s0,
                           mask=mask)
    torch.cuda.synchronize()
    assert skern.scaled_err(y, y0) <= skern.KERNEL_TOL
    assert skern.scaled_err(fs, fs0) <= skern.KERNEL_TOL


def test_mamba2_prefill_card_matches_cpu(dev):
    """Right-padded rows with ``last_pos``: the card's prefill (masked SSD
    scan on the kernel) against the CPU's plain path, logits and states."""
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    gpu = type(cpu).from_params(cfg, _tree_to(cpu.params_tree(), dev),
                                device=dev)
    toks = torch.randint(1, cfg.vocab_size, (3, 48),
                         generator=torch.Generator().manual_seed(2))
    last = torch.tensor([47, 20, 3])
    with torch.inference_mode():
        lc, cc = cpu.prefill(toks, cpu.init_cache(3, 48), last_pos=last)
        lg, cg = gpu.prefill(toks.to(dev), gpu.init_cache(3, 48),
                             last_pos=last.to(dev))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for a, b in zip(cg, cc):
        torch.testing.assert_close(a.state.cpu(), b.state, rtol=1e-4,
                                   atol=1e-4)


def _tree_to(node, device):
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, device) for v in node]
    return node.to(device)


#: JAX's test_flash_vs_ref shapes, two off the 64-row tile, yi-9b's heads
FLASH_CASES = [(1, 128, 2, 2, 16), (2, 256, 4, 2, 32), (1, 512, 8, 1, 64),
               (1, 100, 2, 1, 32), (2, 200, 4, 4, 128), (1, 512, 32, 4, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hkv,d", FLASH_CASES)
def test_flash_attention_matches_plain_on_card(dev, b, s, h, hkv, d,
                                               causal):
    """Each kernel against its plain version on the same input values in
    f32 (``flash_attention.reference``), at the tolerance stated in
    ``kernels/flash_attention/flash_attention.py``: f32 and bf16 at D in
    {16, 32} on the SIMT kernel against ``attention_ref`` (2e-5; bf16 half
    an output ulp past that), bf16 at D in {64, 128} on the tensor-core
    kernel against ``attention_ref_tiled`` (that, plus its p flips); bf16
    also within JAX's 2e-2 of the reference on the unrounded f32 inputs.
    One launch per call, on the tensor-core kernel iff bf16 at D >= 64."""
    gen = torch.Generator(device=dev).manual_seed(s + d)
    q = torch.randn((b * h, s, d), generator=gen, device=dev)
    k = torch.randn((b * hkv, s, d), generator=gen, device=dev)
    v = torch.randn((b * hkv, s, d), generator=gen, device=dev)
    kw = dict(sm_scale=d ** -0.5, causal=causal, num_q_heads=h,
              num_kv_heads=hkv)
    want = attention_ref(q, k, v, **kw)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        before = fkern.flash_attention.launches
        before_tc = fkern.flash_attention.launches_tc
        got = fkern.flash_attention(qd, kd, vd, **kw)
        torch.cuda.synchronize()
        assert fkern.flash_attention.launches == before + 1
        tc = dtype == torch.bfloat16 and d in fkern.TC_HEAD_DIMS
        assert fkern.flash_attention.launches_tc == before_tc + tc
        assert got.dtype == dtype
        plain, bound = fkern.reference(qd, kd, vd, **kw)
        assert fkern.tolerance_share(got, plain, bound) <= 1.0
        torch.testing.assert_close(got.float(), want,
                                   rtol=fkern.BF16_TOL, atol=fkern.BF16_TOL)


def test_flash_attention_ragged_s_on_card(dev):
    """S = 1000, off the 128-row tile: the tensor-core kernel's tile past S
    reads zeros through its 3-D tensor maps and masks the columns past S
    (never the next head's rows): causal and not, against its plain
    version at the stated tolerance; rows past S are not stored."""
    b, s, h, hkv, d = 2, 1000, 8, 2, 128
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((b * n, s, d), generator=gen, device=dev)
               .bfloat16() for n in (h, hkv, hkv))
    for causal in (True, False):
        kw = dict(sm_scale=d ** -0.5, causal=causal, num_q_heads=h,
                  num_kv_heads=hkv)
        before_tc = fkern.flash_attention.launches_tc
        got = fkern.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fkern.flash_attention.launches_tc == before_tc + 1
        plain, bound = fkern.reference(q, k, v, **kw)
        assert fkern.tolerance_share(got, plain, bound) <= 1.0


def test_flash_attention_refuses_on_card(dev):
    q = torch.zeros((2, 128, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        fkern.flash_attention(q, q, q, sm_scale=0.1, num_q_heads=2,
                              num_kv_heads=2)
    q = torch.zeros((2, 128, 32), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fkern.flash_attention(q, q.transpose(0, 1).contiguous()
                              .transpose(0, 1), q, sm_scale=0.1,
                              num_q_heads=2, num_kv_heads=2)


def test_ste_card_matches_cpu(dev):
    """ste_luna_matmul on identical f32 inputs: forward (the luna_mm
    kernel's route) and the straight-through gradients within
    ``card_vs_cpu.STE_REL`` of each tensor's max |cpu value|."""
    from repro_torch.train.card_vs_cpu import ste_card_vs_cpu
    ste_card_vs_cpu(dev)


def test_training_card_matches_cpu(dev):
    """Reduced f32 yi-9b (``repro_torch.train.card_vs_cpu``): the
    cacheless forward under flash, the loss and every gradient under
    chunked attention and under luna_approx through the STE on luna_mm,
    and one train step's params, each at the tolerance stated there."""
    from repro_torch.train.card_vs_cpu import training_card_vs_cpu
    training_card_vs_cpu(dev)
