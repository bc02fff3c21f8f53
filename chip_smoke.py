#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py             # the whole check, 48 layers
    python3 chip_smoke.py --layers 8  # the same with yi-9b's depth cut
    python3 chip_smoke.py --ssd-against DIR   # only ssd_scan: DIR's kernel
                                              # and this checkout's in turns

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA -> fail;
2. build every CUDA source of the port with nvcc for sm_90a, one nvcc per
   source, all started together (seconds); the SASS instructions a code of
   the LUT kernels' streaming loops (``cuobjdump -sass``), ptxas' registers
   and spills of the LUT and SSD tensor-core libraries;
3. each kernel against its plain PyTorch version on the card, times by
   CUDA events, each beside its bound:
   a. the D&C LUT GEMMs (``lut_gemm_dc``, ``lut_gemm_dc_res``) on both
      their kernels at every yi-9b and mamba2-1.3b decode projection shape
      (mamba2's w_in 2048 x 8512 leaves a ragged 64-column tile), codes
      cold in L2, at the tolerance stated in ``kernels/lut_gemm/lut_gemm.py``:
      the tensor-core kernel (``lut_gemm_tc.cu``, bf16 x at M <= 32) at M
      in {1, 8, 16, 32}, the f32-FMA kernel (``lut_gemm.cu``) at M in {1,
      8} on bf16 x and on f32 x; the kernel each public call ran read from
      ``launches_tc``; x = I bitwise, at once on the f32 kernel and 8 rows
      a call on the tensor-core one; ragged shapes; each checked call
      synchronised and named on a fault; both kernels timed at M = 8 by
      events and device-only (``graph_ms``: CUDA-graph replays), at the
      other M device-only (the route's edge); and at speculation's verify
      M = 40 (8 rows x 5 columns, past the tensor-core route: the public
      call on ``lut_gemm.cu``, checked and timed device-only beside its
      bound);
   b. the LUNA GEMM (``luna_mm``) in all five modes, int32 bitwise, both
      its kernels (the int8 tensor-core ``luna_mm_tc.cu`` and the __dp4a
      ``luna_mm.cu``) and the public call on a row-major and a K-major W,
      the kernel each call ran read from ``launches_tc``: a ragged shape,
      the tensor-core kernel's tile edges, M in {8, 16, 32, 64, 128}
      (device-only times of both kernels: the route's threshold) and
      {8, 512, 2048} at yi-9b's four projection shapes (times by events
      and device-only; ``torch._int_mm`` on a row-major and on a K-major
      W as the library yardstick for the exact modes, M > 16);
   c. the full-table LUT GEMM (``lut_gemm``), NF4 codes, on each of its
      kernels (the tensor-core decode kernel ``lut_gemm_tc.cu``'s
      full-table mode, bf16 x at M <= 32; the tensor-core prefill kernel
      ``lut_gemm_wgmma.cu``, bf16 x at larger M; ``lut_gemm.cu``), 1e-4,
      the kernel each public call ran held to ``route``; x = I bitwise on
      each; ragged shapes on each route and shapes TMA cannot take; at
      yi-9b's projection shapes and M in {8, 16, 32, 48, 64, 160, 176,
      272, 336, 448, 512} (decode, the prefill calls' M and 512) every
      kernel that takes that M, device-only and by events, beside the
      bound at the bf16 peak and the three-piece floor;
   d. the SSD chunk scan (``ssd_scan``, the four kernels of
      ``ssd_scan_tc.cu``) at mamba2's widths (H = 64, P = 64, N = 128, G
      = 1, chunk min(256, S)) for (B, S) in {(1, 48), (1, 272) with a
      carried initial state, (8, 512)}, the engine's eight prefill
      calls (B = 1, S the 16-token buckets 448 ... 32, masked at the
      prompt lengths 438 ... 24, the zero state read), phase 9b's resumed
      and warm-seeded pieces (S in {16, 32, 48, 64, 128} from a random,
      non-zero initial state, four of them masked), speculation's windows
      (B = 8, S = 5 from a random state, each row masked at its own valid
      length in {0, 1, 2, 3, 5}: a fully masked row's final state must
      equal its initial state bitwise) and a small G = 2 case, within the
      tolerance stated in ``kernels/ssd_scan/ssd_scan.py``; the S = 448
      call, every resumed piece and the windows also within
      ``ref.EMULATE_TOL`` of the CPU emulation (run on the card); each
      timed device-only (``graph_ms``) and by events beside its bound
      (bytes, or three TF32
      products at 494.7 TFLOP/s) and the f32 SIMT bound, and the sum over
      a layer's eight calls;
   e. flash attention (``flash_attention``): bf16 at D in {64, 128} on
      the tensor-core kernel (``flash_attention_wgmma.cu``), f32 and bf16
      at D in {16, 32} on the SIMT kernel (``flash_attention.cu``), each
      against its plain version (``flash_attention.reference``) at JAX's
      test shapes (causal and not, f32 and bf16), S = 1000 off both
      tiles (bf16, causal and not) and yi-9b's heads (H 32, Hkv 4, D 128)
      at (B, S) in {(1, 512), (2, 4096)}, causal, f32 and bf16; bf16 also
      within JAX's 2e-2 of the f32 reference on the unrounded inputs;
      which kernel ran, from the launch counters; times at (2, 4096) of
      both kernels (the SIMT one also on the bf16 inputs) beside the
      bounds, the plain versions and ``F.scaled_dot_product_attention``
      (timed only);
4. reduced f32 models, card against CPU: yi-9b (quantization on the card
   equals the CPU's bitwise; decode logits through the kernels under
   lut4, nf4p; lut_nf4 prefill) and mamba2 (right-padded prefill with
   ``last_pos`` through ``ssd_scan``; w_in/w_out codes bitwise; one
   decode step under lut4 and nf4p), logits at 1e-4; the cache
   substrate (yi-9b paged, paged + chunked, paged + prefix cache with
   and without chunks; mamba2 chunked and prefix + chunked, on a
   shared-head mix on 3 slots): greedy tokens on the card equal the
   CPU's and the dense, whole-prompt, cold engine's; speculation (yi-9b
   dense and paged, mamba2; ngram and self_lut; quant None, lut4, nf4p):
   tokens on the card == the CPU's == plain greedy's; yi-9b training:
   the cacheless forward under attn_impl="flash", the loss and every
   gradient under chunked attention and under luna_approx (the STE on
   luna_mm), one train step;
5. ``quant_matmul`` on the card against the CPU's on identical f32 inputs
   under every model-level mode: codes and LUNA int32 accumulators
   bitwise, outputs 1e-5;
6. the main path at yi-9b's full width in bf16 (random weights, seed 0):
   the engine serves 8 requests (prompts 16-512, 32 new tokens)
   a. under the engine-level quant="lut4", then "nf4p" (frozen 4-bit
      decode projections on the D&C kernels, every launch on the
      tensor-core kernel);
   b. on the first 24 of those layers, under the model-level modes
      luna_approx2, luna_dc (every projection
      of prefill and decode on luna_mm: prefill calls at M >= 32 on its
      tensor-core kernel, decode's M = 8 on the __dp4a kernel, each count
      checked) and lut_nf4 (on lut_gemm: decode and the M = 32 prefill
      call on the tensor-core decode kernel, the larger prefill calls on
      the prefill kernel, each count checked against ``route``);
7. the main path at mamba2-1.3b's full width (always all 48 layers, bf16,
   random weights from seed 0): the same 8 request lengths under
   full precision, lut4 and nf4p; every prefill runs the SSD scan on
   ``ssd_scan`` (once per layer per call), decode the O(1) recurrence
   with w_in/w_out on the D&C kernels (every launch on the tensor-core
   kernel); the first (prefill) tokens agree across the three runs;
8. training at yi-9b's full width, depth cut 48 -> 8 (bf16, random
   weights from seed 0, SyntheticLM seed 0): the trainer's step
   (``make_train_step``, AdamW + cosine, remat) for 6 steps of B = 2, S =
   4096 under chunked attention (per-step wall, tokens/s, loss,
   grad_norm, peak memory, a torch.profiler window over the last step),
   2 QAT steps under luna_approx at S = 1024 (luna_mm: 7 x 8 x 2 launches
   a step, all on its tensor-core kernel; the last step profiled, with
   luna_mm's device time), then the eval loss and final hidden states of
   a held-out batch under attn_impl="flash" (one launch per layer per
   call, each on the tensor-core kernel) against the chunked ones, every
   attention call held to its plain version, and a check that two wrong
   attentions put in the kernel's place (output zeroed; the last 64 keys
   dropped for the last 64 queries) must fail;
   8b. the Trainer on luna-mlp: 12 steps with checkpoints every 5, then
   a rerun to 20 resumes from step 12;
9. the cache substrate at full width (bf16, random weights from seed 0),
   run after phase 6 on its model (9a) and after phase 7 on its (9b):
   a. yi-9b under lut4 on the paged pool (block 16) serves phase 6's 8
      requests: tokens bitwise equal to phase 6a's dense lut4 run; then
      with ``prefix_cache`` and ``prefill_chunk=128`` the shared-prefix
      mix (a 384-token prefix alone, then 7 requests of it plus 8-64
      token tails together): 7 hits reusing 2,688 tokens, every pool
      block free or held by the cache alone after the run;
   b. mamba2-1.3b under nf4p with ``prefill_chunk=64`` and
      ``prefix_cache`` on the same mix in the same order: 7 hits, every
      prefill piece on ``ssd_scan`` (resumed from a carried state, warm
      ones from a seeded snapshot);
   each warm request's first-token logits bitwise equal to a replay of its
   prefill pieces on a fresh cache, and from the same prompt prefilled
   whole at most ``WARM_FACTOR`` times the bf16 model's own distance from
   an f32 copy of its weights;
10. the rest of the serving stack at full width (bf16, random weights
   from seed 0), on phase 6's and phase 7's models:
   a. yi-9b on the first ``MODEL_LEVEL_LAYERS`` (24) of its layers, as
      6b, under lut4: a plain run of phase 6's 8 requests (32 new
      tokens), then the same under ``spec="self_lut", spec_k=4`` (drafts
      on ``lut_gemm_dc_res``'s tensor-core kernel at M = 8, verify
      windows at M = 40 on ``lut_gemm.cu``) and ``spec="ngram"``;
   b. mamba2-1.3b under nf4p with self_lut (verify and commit windows on
      ``ssd_scan``, masked per row);
   c. yi-9b lut4 on the paged pool with ``prefill_chunk=128`` and
      ``trace=True``, served through ``start()``: 8 client threads submit
      and consume ``tokens()``, one request cancelled during its chunked
      admission and one preempted while decoding (both from a callback
      inside the tick), then ``stop(drain=True)``; against a synchronous
      run of the same mix: streams == outs, untouched tokens bitwise, pool
      free, the Perfetto trace complete, registry == EngineMetrics;
   each spec run's tokens equal the plain run's (10a's, 7's nf4p) or
   pass the ``WINDOW_FACTOR`` rule at their first divergence;
each run of 6, 7, 9 and 10 asserting every request finished, every logit is
finite and each kernel's launch counter (all set to 0 just before the
run, read just after) equals the launches the run made through it; then
(after the counts are read) a torch.profiler window over 4 decode ticks
(and for mamba2 one prefill call): device time by kernel and the idle
share (for the prefill call, device time as the union of the kernels'
intervals: ``ssd_scan``'s side stream overlaps its other kernels).
``--layers N`` cuts yi-9b's depth in phases 6, 9a and 10c (and 10a's
to at most ``MODEL_LEVEL_LAYERS``).

Every line is one JSON object (``t_s``: seconds since the start); the
``{"kernels": [...]}`` line comes just before the last, which is
``{"ok": true, "device": ...}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
from collections import Counter
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
INT8_OP_S = 1979e12
F32_FLOP_S = 67e12           # outside the tensor cores
TF32_FLOP_S = 494.7e12
#: (K, N) of yi-9b's decode projections, in layer order wq wk wv wo
#: w_gate w_up w_down
LAYER_SHAPES = [(4096, 4096), (4096, 512), (4096, 512), (4096, 4096),
                (4096, 11008), (4096, 11008), (11008, 4096)]
#: (K, N) of mamba2-1.3b's decode projections: w_in, w_out
MAMBA2_SHAPES = [(2048, 8512), (4096, 2048)]
#: frozen decode projections per layer, by family
PROJECTIONS = {"dense": 7, "ssm": 2}
COLD_BYTES = 256 << 20       # rotate code copies past the 50 MB L2
#: the wrappers that count their tensor-core route's launches
#: (``launches_tc``; lut_gemm's prefill kernel's in ``launches_wgmma``)
TC_ROUTED = ("luna_mm", "lut_gemm_dc", "lut_gemm_dc_res", "lut_gemm")


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn(i)`` by CUDA events, after warm-up."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Device-only ms per call of ``fn(i)``: ``calls`` calls (i = 0 ..
    calls - 1) captured in one CUDA graph, their workspaces from the
    graph's pool, the graph replayed ``replays`` times between CUDA
    events.  No host time is between the launches, unlike
    :func:`cuda_ms`, which at decode sizes times the host wrapper."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def synced(what: str, fn):
    """``fn()``, then ``torch.cuda.synchronize()``: a fault during the
    launch surfaces here, named by ``what``."""
    import torch
    try:
        out = fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        raise RuntimeError(f"chip_smoke: {what} failed: {e}") from e
    return out


def bound_ms(m: int, k: int, n: int, x_bytes: int, table_bytes: int,
             vec_bytes: int = 8, ops: float | None = None,
             peak: float = BF16_FLOP_S) -> tuple[float, str]:
    """Least time for one call: each input read once (x, codes, tables,
    ``vec_bytes`` per output channel), the 4-byte output written once,
    against ``ops`` (default 2MKN) at ``peak``; the larger of the two."""
    nbytes = m * k * x_bytes + k * n + table_bytes + vec_bytes * n + m * n * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = (2 * m * k * n if ops is None else ops) / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layer_summary(name: str, rows: list, m: int, shapes=LAYER_SHAPES,
                  **kw) -> dict:
    """The kernels-line entry: one layer's projections (default yi-9b's
    7) at ``m`` rows, summed from the per-shape ``rows`` of one kernel
    (and mode): every time (``ms`` and each ``*_ms`` key), None where a
    shape has none."""
    at = {(s["k"], s["n"]): s for s in rows if s["m"] == m}
    layer = [at[kn] for kn in shapes]
    times = {"library_ms": None}
    for key in layer[0]:
        if key == "ms" or key.endswith("_ms"):
            vals = [s.get(key) for s in layer]
            times[key] = None if None in vals else sum(vals)
    return {
        "name": name, "route": "cuda", "launches": None, **times,
        "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                   for s in layer) else "operations", **kw}


def cold_copies(t, nbytes: int) -> list:
    """``t`` and enough clones of it to exceed the 50 MB L2 together."""
    return [t] + [t.clone() for _ in range(max(1, COLD_BYTES // nbytes) - 1)]


def sass_loops(lib, match, stream: str = "LDG") -> list:
    """The loops of every kernel in ``lib`` whose (mangled) name holds all
    of ``match``, from ``cuobjdump -sass``: per loop (a branch back to an
    earlier address) that holds a ``stream`` instruction, its SASS
    instructions and, by opcode, the code loads (``LDG``: 4 codes a 32-bit
    load in lut_gemm.cu, 16 a 128-bit load in lut_gemm_tc.cu), the
    tensor-core products (``HMMA``; ``HGMMA``, wgmma), the shared loads
    and the byte permutes, so that instructions per code are read off the
    loop that streams the codes (lut_gemm_wgmma.cu's codes arrive by TMA:
    ``stream="HGMMA"`` finds its loops)."""
    import re
    import shutil
    cuobjdump = os.path.join(os.path.dirname(
        shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return ["not measured: no cuobjdump"]
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    found = []
    for func in out.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        if not all(m in name for m in match):
            continue
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        for end, (addr, text) in enumerate(ins):
            tgt = re.search(r"BRA\s+(0x[0-9a-f]+)", text)
            if not tgt or int(tgt.group(1), 16) >= addr:
                continue
            loop = [t.split()[1 if t.startswith("@") else 0]
                    for _, t in ins[at[int(tgt.group(1), 16)]:end + 1]]

            def ops(name):
                return sum(1 for op in loop if op.split(".")[0] == name)
            ldg_128 = sum(1 for op in loop if op.split(".")[0] == "LDG"
                          and ".128" in op)
            ldg_32 = ops("LDG") - ldg_128 - sum(
                1 for op in loop if op.split(".")[0] == "LDG" and ".64" in op)
            if (ldg_32 + ldg_128 if stream == "LDG" else ops(stream)) == 0:
                continue            # not a loop over the codes
            found.append({"kernel": name[-60:], "instructions": len(loop),
                          "ldg_32": ldg_32, "ldg_128": ldg_128,
                          "hmma": ops("HMMA"), "hgmma": ops("HGMMA"),
                          "lds": ops("LDS"),
                          "prmt": ops("PRMT"), "ffma": ops("FFMA")})
    return found


#: M of phase 3a's tensor-core checks (decode sizes up to the kernel's 32)
DC_TC_M = (1, 8, 16, 32)
#: the verify window's M: max_batch 8 x (spec_k 4 + 1), past TC_MAX_M
VERIFY_M = 40


def kernel_phase(dev, device_times: bool = True):
    """Phase 3a: both D&C wrappers on both their kernels against the plain
    versions, each checked call synchronised and named (spec, shape, call)
    on a fault, the kernel each public call ran read from ``launches_tc``
    and held to ``takes_tc``.  At every yi-9b and mamba2 shape: the
    tensor-core kernel (``lut_gemm_tc.cu``, the route of bf16 x at M <=
    32) at ``DC_TC_M``, the f32-FMA kernel (``lut_gemm.cu``) at M in {1, 8}
    on bf16 x and at M = 8 on f32 x; x = I bitwise, the whole (256, 4096)
    at once on the f32 kernel and 8 rows a call on the tensor-core one;
    ragged shapes on each.  Times, codes cold in L2: at M = 8 both kernels
    by CUDA events and device-only (``graph_ms``), at the other M
    device-only (the route's edge).  ``device_times=False`` leaves out the
    CUDA-graph timings (for a run under ``CUDA_LAUNCH_BLOCKING=1``, which
    graph capture does not take)."""
    from dataclasses import replace

    import torch

    from repro_torch.core.quant import NF4P_PRUNE_THRESHOLD, quantize_weight
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def simt(x, q):
        return lg._launch(x, q.codes, q.scale, q.hi_tab, q.lo_tab,
                          q.residual, q.zero_point)

    def tc(x, q):
        return lg._launch_tc(x, q.codes, q.scale, q.hi_tab, q.lo_tab,
                             q.residual, q.zero_point)

    specs = {
        "lut_gemm_dc": dict(
            fn=lg.lut_gemm_dc,
            args=lambda q: (q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                            q.scale),
            plain=lambda x, q: ref.lut_gemm_dc_ref(
                x, q.codes, q.hi_tab, q.lo_tab, q.zero_point, q.scale),
            quant=("lut_dc", None), table_bytes=32,
            replaces="src/repro/kernels/lut_gemm/lut_gemm.py:214"),
        "lut_gemm_dc_res": dict(
            fn=lg.lut_gemm_dc_res,
            args=lambda q: (q.codes, q.hi_tab, q.lo_tab, q.residual,
                            q.zero_point, q.scale),
            plain=lambda x, q: ref.lut_gemm_dc_res_ref(
                x, q.codes, q.hi_tab, q.lo_tab, q.residual, q.zero_point,
                q.scale),
            quant=("nf4_dc", NF4P_PRUNE_THRESHOLD), table_bytes=96,
            replaces="src/repro/kernels/lut_gemm/lut_gemm.py:168"),
    }
    results = {}
    for name, sp in specs.items():
        wrap = sp["fn"]

        def qweight(k, n):
            w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
            return synced(f"phase 3a {name}: quantize_weight ({k}, {n})",
                          lambda: quantize_weight(w, *sp["quant"]))

        def public(x, q, what):
            """The public call, its kernel held to ``takes_tc``."""
            m, k = x.shape
            n = q.codes.shape[1]
            tc0 = wrap.launches_tc
            out = synced(f"phase 3a {name} ({m}, {k}, {n}): {what}",
                         lambda: wrap(x, *sp["args"](q)))
            want_tc = lg.takes_tc(m, k, n, x.dtype, True)
            check(wrap.launches_tc - tc0 == want_tc,
                  f"{name} ({m}, {k}, {n}) {x.dtype}: "
                  f"{wrap.launches_tc - tc0} tensor-core launches, "
                  f"takes_tc says {want_tc}")
            return out

        def hold(x, q, what, out=None):
            m, k = x.shape
            n = q.codes.shape[1]
            out = public(x, q, what) if out is None else out
            plain = synced(f"phase 3a {name} ({m}, {k}, {n}): plain "
                           "version", lambda: sp["plain"](x, q))
            torch.testing.assert_close(out, plain, rtol=lg.KERNEL_RTOL,
                                       atol=lg.KERNEL_ATOL)
            return (out - plain).abs().max().item()

        # exact: x = I reads the dequantized weight back, bitwise: the
        # f32-FMA kernel at M = 256, the tensor-core kernel 8 rows a call
        q = qweight(256, 4096)
        eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
        want = synced(f"phase 3a {name}: dc_dequant (256, 4096), the plain "
                      "x = I reference", lambda: ref.dc_dequant(
                          q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                          q.residual) * q.scale[None, :])
        got = public(eye, q, "f32 kernel, x = I")
        check(torch.equal(got, want), f"{name}: x = I output of the f32 "
              "kernel is not bitwise the dequantized weight")
        for r in range(0, 256, 8):
            got = public(eye[r:r + 8], q, f"tensor-core kernel, x = I rows "
                         f"{r}..{r + 7}")
            check(torch.equal(got, want[r:r + 8]),
                  f"{name}: x = I rows {r}..{r + 7} on the tensor-core "
                  "kernel are not bitwise the dequantized weight")
        # ragged M, K, N: the f32 kernel's unvectorised path; the tensor-
        # core kernel's zero-filled steps, columns and n-tiles
        max_err = 0.0
        for m, k, n, dt in ((3, 72, 40, torch.float32),
                            (3, 72, 48, torch.bfloat16),
                            (29, 1000, 208, torch.bfloat16)):
            q = qweight(k, n)
            x = torch.randn((m, k), generator=gen, device=dev, dtype=dt)
            max_err = max(max_err, hold(x, q, "ragged"))

        per_shape = []
        for k, n in sorted(set(LAYER_SHAPES) | set(MAMBA2_SHAPES)):
            q = qweight(k, n)
            copies = [q] + [replace(q, codes=q.codes.clone()) for _ in
                            range(max(1, COLD_BYTES // (k * n)) - 1)]
            calls = max(20, len(copies))
            for m in DC_TC_M:
                x = torch.randn((m, k), generator=gen, device=dev,
                                dtype=torch.bfloat16)
                max_err = max(max_err, hold(x, q, "public call"))
                row = {"m": m, "k": k, "n": n}
                if m in (1, 8):
                    max_err = max(max_err, hold(x, q, "f32-FMA kernel", synced(
                        f"phase 3a {name} ({m}, {k}, {n}): f32-FMA kernel",
                        lambda: simt(x, q))))
                if m == 8:
                    xf = x.float()
                    max_err = max(max_err, hold(xf, q, "public call, f32 x"))
                    row["ms"] = cuda_ms(lambda i: wrap(
                        x, *sp["args"](copies[i % len(copies)])), 100)
                    row["simt_ms"] = cuda_ms(
                        lambda i: simt(x, copies[i % len(copies)]), 100)
                    row["plain_ms"] = cuda_ms(
                        lambda i: sp["plain"](x, copies[i % len(copies)]),
                        10)
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        m, k, n, 2, sp["table_bytes"])
                if device_times:
                    row["device_ms"] = graph_ms(
                        lambda i: tc(x, copies[i % len(copies)]), calls)
                    row["simt_device_ms"] = graph_ms(
                        lambda i: simt(x, copies[i % len(copies)]), calls)
                per_shape.append(row)
            # speculation's verify window: the public call at M = 40 runs
            # the f32-FMA kernel (takes_tc is false past TC_MAX_M)
            x = torch.randn((VERIFY_M, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            max_err = max(max_err, hold(x, q, "public call, verify M"))
            row = {"m": VERIFY_M, "k": k, "n": n}
            row["bound_ms"], row["bound_by"] = bound_ms(
                VERIFY_M, k, n, 2, sp["table_bytes"])
            if device_times:
                row["simt_device_ms"] = graph_ms(
                    lambda i: simt(x, copies[i % len(copies)]), calls)
            per_shape.append(row)
            del copies
        emit({"kernel_check": name, "passed": True, "max_abs_err": max_err,
              "rtol": lg.KERNEL_RTOL, "atol": lg.KERNEL_ATOL,
              "x_identity_tc_calls": 32, "per_shape": per_shape})

        # the route's edge: one yi-9b layer's 7 projections, device-only
        route = []
        for m in DC_TC_M:
            at = {(r["k"], r["n"]): r for r in per_shape if r["m"] == m}
            if device_times:
                route.append({"m": m, **{
                    key: sum(at[kn][key] for kn in LAYER_SHAPES)
                    for key in ("device_ms", "simt_device_ms")}})
        emit({"dc_route": name, "tc_max_m": lg.TC_MAX_M,
              "layer_device_ms": route})

        # one decoder layer's 7 projections at the main path's M = 8
        results[name] = layer_summary(
            name, [r for r in per_shape if r["m"] == 8], 8,
            source="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm_tc.cu",
            source_simt="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm.cu",
            replaces=sp["replaces"], max_abs_err=max_err, launches_tc=None,
            timed_as="one yi-9b layer's 7 decode projections, M=8, bf16 x, "
                     "codes cold in L2; ms the public call (the tensor-core "
                     "kernel) and simt_ms the f32-FMA kernel by CUDA events "
                     "around eager calls (the host wrapper included), "
                     "device_ms and simt_device_ms the same kernels by "
                     "CUDA-graph replays (graph_ms)",
            mamba2_layer={
                k: v for k, v in layer_summary(
                    name, [r for r in per_shape if r["m"] == 8], 8,
                    MAMBA2_SHAPES).items()
                if k in ("ms", "simt_ms", "device_ms", "simt_device_ms",
                         "plain_ms", "bound_ms", "bound_by")} | {
                "timed_as": "one mamba2-1.3b layer's w_in (2048 x 8512) "
                            "and w_out (4096 x 2048), M=8"},
            verify_m40={
                f"{model}_{k}": v for model, shapes in (
                    ("yi9b", LAYER_SHAPES), ("mamba2", MAMBA2_SHAPES))
                for k, v in layer_summary(
                    name, [r for r in per_shape if r["m"] == VERIFY_M],
                    VERIFY_M, shapes).items()
                if k in ("simt_device_ms", "bound_ms")} | {
                "timed_as": "one layer's decode projections at verify's "
                            "M=40 (8 rows x 5 window columns), bf16 x, on "
                            "the f32-FMA kernel the route takes there, "
                            "device-only (graph_ms), codes cold in L2"})
        gc.collect()
        torch.cuda.empty_cache()
    return results


LUNA_MODES = ("conventional", "opt_dc", "dc", "approx_dc", "approx_dc2")
#: digit-plane contractions each mode runs (approx_dc2 adds colsum(W))
LUNA_PLANES = {"conventional": 1, "dc": 2, "opt_dc": 2, "approx_dc": 1,
               "approx_dc2": 1}


#: phase 3b's tile edges of the tensor-core kernel (M, K, N): M at and
#: past its 64-row warpgroups and 128-row blocks, K inside one 128-byte K
#: tile, at it and past it (K % 16 == 0, TMA's rule), N at 16, at the
#: 128-column tile and past it; one-tile outputs split K the most
LUNA_EDGE_SHAPES = [(64, 128, 16), (65, 144, 128), (127, 4112, 144),
                    (128, 256, 256), (129, 4096, 520), (200, 11008, 48)]
#: M of phase 3b's device-only route timings (the threshold's readings)
LUNA_ROUTE_M = (8, 16, 32, 64, 128)
#: M of phase 3b's timed shapes: decode, prefill, phase 8's QAT (B * S)
LUNA_M = (8, 512, 2048)


def luna_bound_ms(m: int, k: int, n: int, mode: str) -> tuple[float, str]:
    """Least time of one luna_mm call: y and w read once and the int32
    output written once, against 2MKN int8 operations per digit plane the
    mode runs (plus K N adds of approx_dc2's colsum) at 1,979 TOP/s."""
    ops = (2 * m * k * n * LUNA_PLANES[mode]
           + (k * n if mode == "approx_dc2" else 0))
    return bound_ms(m, k, n, 1, 0, 0, ops, INT8_OP_S)


def luna_kernel_phase(dev):
    """Phase 3b: both luna_mm kernels against the plain version, every
    mode, bitwise, each checked call synchronised: the public call on a
    row-major and on a K-major W (which kernel ran read from
    ``launches_tc`` and held to ``takes_tc``), the __dp4a kernel and,
    where it takes the shape, the tensor-core kernel on both layouts, at
    the ragged 3 x 72 x 40, the tensor-core kernel's tile edges, the route
    timings' shapes and yi-9b's four projection shapes at M in
    ``LUNA_M``.  Times, codes cold in L2: device-only (CUDA graphs) of
    both kernels at ``LUNA_ROUTE_M``; at ``LUNA_M`` by CUDA events the
    public call on each layout, each kernel alone, the plain version and
    ``torch._int_mm`` on a row-major and on a K-major W (the exact modes,
    M > 16), and device-only the public call and the __dp4a kernel; and
    the main path's cast of int32 weight codes to int8."""
    import torch

    from repro_torch.core.luna import LunaMode
    from repro_torch.kernels.luna_mm import luna_mm as lm
    from repro_torch.kernels.luna_mm.ref import luna_mm_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    wrap = lm.luna_mm

    def codes(*shape):
        return torch.randint(0, 16, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def kmajor(w):
        return w.t().contiguous().t()

    def hold(y, w, wk, mode):
        """Every route of one call against the plain version, bitwise."""
        (m, k), n = y.shape, w.shape[1]
        what = f"phase 3b luna_mm {mode} ({m}, {k}, {n})"
        want = synced(f"{what}: plain version",
                      lambda: luna_mm_ref(y, w, mode))
        runs = {}
        for layout, ww in (("row", w), ("k", wk)):
            tc0 = wrap.launches_tc
            runs[f"luna_mm on a {layout}-major W"] = synced(
                f"{what}: luna_mm on a {layout}-major W",
                lambda: wrap(y, ww, mode))
            tc = wrap.launches_tc - tc0
            check(tc == lm.takes_tc(m, k, n, layout, True),
                  f"{what}, {layout}-major W: {tc} tensor-core launches, "
                  f"takes_tc says {lm.takes_tc(m, k, n, layout, True)}")
        runs["the dp4a kernel"] = synced(
            f"{what}: the dp4a kernel",
            lambda: lm._launch(y, w, LunaMode(mode)))
        if k % lm.TC_ALIGN == 0 and n % lm.TC_ALIGN == 0:
            for layout, ww in (("row", w), ("k", wk)):
                runs[f"the tensor-core kernel, {layout}-major W"] = synced(
                    f"{what}: the tensor-core kernel, {layout}-major W",
                    lambda: lm._launch_tc(y, ww, layout, LunaMode(mode)))
        for name, got in runs.items():
            check(torch.equal(got, want),
                  f"{what}: {name} is not bitwise equal to the plain "
                  "version")
        return len(runs)

    checked = 0
    for m, k, n in [(3, 72, 40)] + LUNA_EDGE_SHAPES:
        y, w = codes(m, k), codes(k, n)
        wk = kmajor(w)
        for mode in LUNA_MODES:
            checked += hold(y, w, wk, mode)

    # device-only times of both kernels around the route's threshold
    route = []
    for k, n in sorted(set(LAYER_SHAPES)):
        rows = cold_copies(codes(k, n), k * n)
        ks = [kmajor(w) for w in rows]
        calls = max(20, len(rows))
        for m in LUNA_ROUTE_M:
            y = codes(m, k)
            for mode in ("approx_dc2", "dc"):
                checked += hold(y, rows[0], ks[0], mode)
                lmode = LunaMode(mode)
                route.append({
                    "mode": mode, "m": m, "k": k, "n": n,
                    "dp4a_ms": graph_ms(lambda i: lm._launch(
                        y, rows[i % len(rows)], lmode), calls),
                    "tc_row_ms": graph_ms(lambda i: lm._launch_tc(
                        y, rows[i % len(rows)], "row", lmode), calls),
                    "tc_k_ms": graph_ms(lambda i: lm._launch_tc(
                        y, ks[i % len(ks)], "k", lmode), calls)})
        del rows, ks
    layer = {}
    for r in route:
        key = (r["mode"], r["m"])
        acc = layer.setdefault(key, {"mode": r["mode"], "m": r["m"],
                                     "dp4a_ms": 0.0, "tc_row_ms": 0.0,
                                     "tc_k_ms": 0.0})
        for t in ("dp4a_ms", "tc_row_ms", "tc_k_ms"):
            acc[t] += r[t] * LAYER_SHAPES.count((r["k"], r["n"]))
    faster_from = {}
    for layout in ("row", "k"):
        wins = [m for m in LUNA_ROUTE_M
                if all(layer[(mode, mm)][f"tc_{layout}_ms"]
                       < layer[(mode, mm)]["dp4a_ms"]
                       for mode in ("approx_dc2", "dc")
                       for mm in LUNA_ROUTE_M if mm >= m)]
        faster_from[layout] = min(wins) if wins else None
    emit({"luna_route": "device-only ms (CUDA-graph replays), codes cold "
                        "in L2; layer = yi-9b's 7 projections",
          "tc_min_m": lm.TC_MIN_M, "tc_faster_from_m": faster_from,
          "layer": list(layer.values()), "per_shape": route})

    per_shape = []
    iters = {8: 50, 512: 30, 2048: 10}
    for k, n in sorted(set(LAYER_SHAPES)):
        rows = cold_copies(codes(k, n), k * n)
        ks = [kmajor(w) for w in rows]
        for m in LUNA_M:
            y = codes(m, k)
            it = iters[m]
            lib = {}
            if m > 16:
                lib = {"library_ms": cuda_ms(lambda i: torch._int_mm(
                           y, rows[i % len(rows)]), it),
                       "library_kmajor_ms": cuda_ms(lambda i: torch._int_mm(
                           y, ks[i % len(ks)]), it)}
            for mode in LUNA_MODES:
                checked += hold(y, rows[0], ks[0], mode)
                lmode = LunaMode(mode)
                row = {"mode": mode, "m": m, "k": k, "n": n,
                       "tc": lm.takes_tc(m, k, n, "row", True),
                       "ms": cuda_ms(lambda i: wrap(
                           y, rows[i % len(rows)], mode), it),
                       "kmajor_ms": cuda_ms(lambda i: wrap(
                           y, ks[i % len(ks)], mode), it),
                       "dp4a_ms": cuda_ms(lambda i: lm._launch(
                           y, rows[i % len(rows)], lmode), it),
                       "tc_ms": cuda_ms(lambda i: lm._launch_tc(
                           y, ks[i % len(ks)], "k", lmode), it),
                       "plain_ms": cuda_ms(lambda i: luna_mm_ref(
                           y, rows[i % len(rows)], mode), 3)}
                row["device_ms"] = graph_ms(
                    lambda i: wrap(y, rows[i % len(rows)], mode),
                    max(5 if m > 8 else 20, len(rows)), 3)
                row["dp4a_device_ms"] = (row["device_ms"] if m == 8 else
                                         graph_ms(lambda i: lm._launch(
                                             y, rows[i % len(rows)], lmode),
                                             max(5, len(rows)), 3))
                row["bound_ms"], row["bound_by"] = luna_bound_ms(m, k, n,
                                                                 mode)
                exact = mode in ("conventional", "dc", "opt_dc")
                row["library_ms"] = lib.get("library_ms") if exact else None
                row["library_kmajor_ms"] = (lib.get("library_kmajor_ms")
                                            if exact else None)
                row["top_s"] = (2 * m * k * n * LUNA_PLANES[mode]
                                / row["ms"] / 1e9)
                per_shape.append(row)
        del rows, ks
    emit({"kernel_check": "luna_mm", "passed": True, "max_abs_err": 0,
          "bitwise": True, "modes": list(LUNA_MODES),
          "calls_held": checked, "edge_shapes": LUNA_EDGE_SHAPES,
          "per_shape": per_shape})

    # the main path's cast of the weight codes (int32 from quantize) to
    # int8, row-major (for the wrapper's transpose) or K-major directly
    k, n = 4096, 11008
    qw = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                       dtype=torch.int32)
    w8 = qw.to(torch.int8)
    casts = {
        "row_major_cast_ms": cuda_ms(lambda i: qw.to(torch.int8), 20),
        "kmajor_cast_ms": cuda_ms(lambda i: torch.empty(
            (n, k), dtype=torch.int8, device=dev).copy_(qw.t()), 20),
        "transpose_ms": cuda_ms(lambda i: lm._tc_lib().luna_mm_tc_transpose(
            w8.data_ptr(), torch.empty((n, k), dtype=torch.int8,
                                       device=dev).data_ptr(), k, n,
            torch.cuda.current_stream().cuda_stream), 20)}
    check(torch.equal(torch.empty((n, k), dtype=torch.int8, device=dev)
                      .copy_(qw.t()), w8.t().contiguous()),
          "the K-major cast differs from the row-major one transposed")
    emit({"luna_ops_cast": f"int32 codes ({k}, {n}) -> int8", **casts})
    del qw, w8

    def summary(m, mode, timed_as):
        return {k: v for k, v in layer_summary(
            "luna_mm", [r for r in per_shape if r["mode"] == mode], m
        ).items() if k not in ("name", "route", "launches")} | {
            "timed_as": timed_as}

    entry = layer_summary(
        "luna_mm", [r for r in per_shape if r["mode"] == "opt_dc"], 512,
        source="src/repro_torch/kernels/luna_mm/csrc/luna_mm_tc.cu",
        source_dp4a="src/repro_torch/kernels/luna_mm/csrc/luna_mm.cu",
        replaces="src/repro/kernels/luna_mm/luna_mm.py:77", max_abs_err=0,
        launches_tc=None,
        timed_as="one yi-9b layer's 7 projections at M=512 (prefill), "
                 "mode opt_dc, codes cold in L2, by CUDA events around "
                 "eager calls: ms the public call on a row-major W (the "
                 "tensor-core kernel, its transpose included), kmajor_ms "
                 "on a K-major W, dp4a_ms the __dp4a kernel, tc_ms the "
                 "tensor-core kernel alone on a K-major W; device_ms and "
                 "dp4a_device_ms the public call and the __dp4a kernel "
                 "by CUDA-graph replays; library: torch._int_mm on a "
                 "row-major W, library_kmajor_ms on a K-major W",
        decode=summary(8, "approx_dc2",
                       "one layer, M=8 (decode), approx_dc2: the __dp4a "
                       "kernel"),
        qat=summary(2048, "approx_dc",
                    "one layer, M=2048 (phase 8's QAT), approx_dc"))
    gc.collect()
    torch.cuda.empty_cache()
    return {"luna_mm": entry}


#: M of phase 3c: decode's 8, the tensor-core decode kernel's edge (16,
#: 32), the engine's prefill calls (rows x bucket length: 448, 336, 272,
#: 176, 160, 64, 48 and 32) and 512
LUT_FULL_M = (8, 16, 32, 48, 64, 160, 176, 272, 336, 448, 512)
#: lut_gemm's kernels by route, as timed in phase 3c
LUT_FULL_KERNELS = {"tc": "lut_gemm_tc.cu", "wgmma": "lut_gemm_wgmma.cu",
                    "fma": "lut_gemm.cu"}


def lut_full_kernel_phase(dev):
    """Phase 3c: the full-table lut_gemm on each of its kernels against its
    plain version (1e-4), each checked call synchronised and named, the
    kernel each public call ran read from ``launches_tc`` /
    ``launches_wgmma`` and held to ``route``.  x = I bitwise on every
    kernel (``lut_gemm.cu`` and the prefill kernel at once, the tensor-core
    decode kernel 32 rows a call); ragged shapes on each route and on the
    shapes TMA cannot take; then at yi-9b's projection shapes and every M
    of ``LUT_FULL_M`` (codes cold in L2) the public call and every kernel
    that can take that M (the decode kernel up to its 32, the prefill
    kernel and ``lut_gemm.cu`` at all), each held to the plain version and
    timed device-only (``graph_ms``) and by CUDA events; the bound at the
    bf16 peak and the three-piece floor (three bf16 products) beside."""
    import torch

    from repro_torch.core.lut import NF4_CODEBOOK
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref
    from repro_torch.kernels.lut_gemm.ops import codebook_quantize

    gen = torch.Generator(device=dev).manual_seed(2)
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    wrap = lg.lut_gemm

    def qweight(k, n):
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        return codebook_quantize(w.bfloat16(), cb)

    def kernel(x, codes, scale, name):
        if name == "fma":
            return lg._launch(x, codes, scale, codebook=cb)
        return lg._launch_full(x, codes, cb, scale, name)

    def public(x, codes, scale, what):
        """The public call, its kernel held to ``route``."""
        m, k = x.shape
        n = codes.shape[1]
        before = (wrap.launches_tc, wrap.launches_wgmma)
        out = synced(f"phase 3c lut_gemm ({m}, {k}, {n}) {x.dtype}: {what}",
                     lambda: wrap(x, codes, cb, scale))
        ran = {(1, 0): "tc", (0, 1): "wgmma", (0, 0): "fma"}[
            (wrap.launches_tc - before[0], wrap.launches_wgmma - before[1])]
        want = lg.route(m, k, n, x.dtype, True)
        check(ran == want, f"lut_gemm ({m}, {k}, {n}) {x.dtype}: ran on "
              f"{ran}, route says {want}")
        return out

    def hold(x, codes, scale, out):
        plain = ref.lut_gemm_ref(x, codes, cb, scale)
        torch.testing.assert_close(out, plain, rtol=lg.KERNEL_RTOL,
                                   atol=lg.KERNEL_ATOL)
        return (out - plain).abs().max().item()

    # exact: x = I reads CB[q] * scale back bitwise on every kernel
    codes, scale = qweight(256, 4096)
    want = cb[codes.long()] * scale[None, :]
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    got = synced("phase 3c lut_gemm: lut_gemm.cu, x = I",
                 lambda: kernel(eye, codes, scale, "fma"))
    check(torch.equal(got, want), "lut_gemm: x = I output of lut_gemm.cu is "
          "not bitwise CB[q] * scale")
    check(torch.equal(public(eye, codes, scale, "x = I (prefill kernel)"),
                      want), "lut_gemm: x = I output of the prefill kernel "
          "is not bitwise CB[q] * scale")
    for r in range(0, 256, lg.TC_MAX_M):
        rows = slice(r, r + lg.TC_MAX_M)
        check(torch.equal(public(eye[rows], codes, scale,
                                 f"x = I rows {r}.. (decode kernel)"),
                          want[rows]),
              f"lut_gemm: x = I rows {r}.. on the decode kernel are not "
              "bitwise CB[q] * scale")
    # ragged M, K, N on each route; f32 x and shapes TMA cannot take on
    # lut_gemm.cu
    max_err = 0.0
    for m, k, n, dt in ((3, 72, 40, torch.float32),
                        (29, 1000, 208, torch.bfloat16),
                        (100, 528, 4112, torch.bfloat16),
                        (300, 4112, 528, torch.bfloat16),
                        (40, 520, 4104, torch.bfloat16),
                        (64, 4104, 520, torch.bfloat16)):
        codes, scale = qweight(k, n)
        x = torch.randn((m, k), generator=gen, device=dev, dtype=dt)
        max_err = max(max_err, hold(x, codes, scale,
                                    public(x, codes, scale, "ragged")))

    per_shape = []
    for k, n in sorted(set(LAYER_SHAPES)):
        codes, scale = qweight(k, n)
        copies = cold_copies(codes, k * n)
        calls = max(10, len(copies))
        for m in LUT_FULL_M:
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            route = lg.route(m, k, n, x.dtype, True)
            max_err = max(max_err, hold(x, codes, scale, public(
                x, codes, scale, "public call")))
            row = {"m": m, "k": k, "n": n, "route": route}
            for name in ("tc", "wgmma", "fma"):
                if name == "tc" and m > lg.TC_MAX_M:
                    continue
                out = synced(f"phase 3c lut_gemm ({m}, {k}, {n}): "
                             f"{LUT_FULL_KERNELS[name]}",
                             lambda: kernel(x, codes, scale, name))
                max_err = max(max_err, hold(x, codes, scale, out))
                row[f"{name}_device_ms"] = graph_ms(
                    lambda i: kernel(x, copies[i % len(copies)], scale, name),
                    calls, 3)
                row[f"{name}_ms"] = cuda_ms(
                    lambda i: kernel(x, copies[i % len(copies)], scale, name),
                    calls)
            row["ms"] = cuda_ms(lambda i: wrap(x, copies[i % len(copies)],
                                               cb, scale), calls)
            row["device_ms"] = row[f"{route}_device_ms"]
            row["plain_ms"] = cuda_ms(lambda i: ref.lut_gemm_ref(
                x, copies[i % len(copies)], cb, scale), 5)
            row["bound_ms"], row["bound_by"] = bound_ms(m, k, n, 2, 64, 4)
            row["floor_ms"] = bound_ms(m, k, n, 2, 64, 4,
                                       ops=3 * 2 * m * k * n)[0]
            row["library_ms"] = None
            per_shape.append(row)
        del copies
    emit({"kernel_check": "lut_gemm", "passed": True, "max_abs_err": max_err,
          "rtol": lg.KERNEL_RTOL, "atol": lg.KERNEL_ATOL,
          "x_identity_tc_calls": 256 // lg.TC_MAX_M, "per_shape": per_shape})

    # the routes' edges: one yi-9b layer's 7 projections at each M,
    # device-only and by events, on every kernel that takes that M
    by_m = []
    for m in LUT_FULL_M:
        at = {(r["k"], r["n"]): r for r in per_shape if r["m"] == m}
        layer = [at[kn] for kn in LAYER_SHAPES]
        entry = {"m": m, "route": sorted({r["route"] for r in layer})}
        for key in layer[0]:
            if key.endswith("_ms") and layer[0][key] is not None:
                entry[key] = sum(r[key] for r in layer)
        entry["route_faster_than_fma"] = (entry["device_ms"]
                                          <= entry["fma_device_ms"])
        by_m.append(entry)
    emit({"lut_route": "lut_gemm", "tc_max_m": lg.TC_MAX_M,
          "wgmma_min_m": lg.WGMMA_MIN_M, "layer": by_m})

    def summary(m, timed_as):
        return {k: v for k, v in layer_summary("lut_gemm", per_shape,
                                               m).items()
                if k.endswith("_ms") or k in ("ms", "bound_by")} | {
                    "timed_as": timed_as}

    entry = layer_summary(
        "lut_gemm", per_shape, 8,
        source="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm_tc.cu",
        source_wgmma="src/repro_torch/kernels/lut_gemm/csrc/"
                     "lut_gemm_wgmma.cu",
        source_simt="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm.cu",
        replaces="src/repro/kernels/lut_gemm/lut_gemm.py:78",
        max_abs_err=max_err, launches_tc=None, launches_wgmma=None,
        timed_as="one yi-9b layer's 7 projections, M=8 (decode: the "
                 "tensor-core decode kernel, lut_gemm_tc.cu's full-table "
                 "mode), bf16 x, NF4 codes cold in L2; ms the public call "
                 "by CUDA events around eager calls (the host wrapper "
                 "included), device_ms by CUDA-graph replays (graph_ms); "
                 "tc_*, wgmma_* and fma_* each kernel; bound at the bf16 "
                 "peak (989 TFLOP/s) or bytes, floor_ms the three-piece "
                 "floor (three bf16 products); no single PyTorch call "
                 "computes it",
        prefill=summary(512, "one layer at M=512 (the prefill kernel)"),
        by_m=by_m)
    gc.collect()
    torch.cuda.empty_cache()
    return {"lut_gemm": entry}


#: the engine's prefill calls of phase 7's request mix at mamba2-1.3b's
#: widths: (B, S the 16-token bucket, the prompt length it is masked at,
#: the zero state the engine carries in)
SSD_BUCKETS = [(1, 448, 438, "zero"), (1, 336, 332, "zero"),
               (1, 272, 270, "zero"), (1, 176, 168, "zero"),
               (1, 160, 150, "zero"), (1, 64, 53, "zero"),
               (1, 48, 36, "zero"), (1, 32, 24, "zero")]
#: the scans of phase 9b's resumed and warm-seeded prefill pieces
#: (prefill_chunk 64, capture grid 16, the shared-prefix mix): a 64-token
#: piece continuing a carried state, the 384-token prefix's last piece
#: (masked), a warm tail's pieces up to its capture boundary (32, 48) and
#: its masked last pieces (16 padded, 2, 9 and 16 real); and a 128-token
#: piece (yi-9b's chunk).  Every one starts from a non-zero state.
SSD_PIECES = [(1, 64, None, "random"), (1, 64, 64, "random"),
              (1, 32, None, "random"), (1, 48, None, "random"),
              (1, 16, 2, "random"), (1, 16, 9, "random"),
              (1, 16, 16, "random"), (1, 128, None, "random")]
#: phase 3d at mamba2-1.3b's widths: (B, S, valid length or None for no
#: mask, initial state: None, "zero" as the main path carries it into a
#: prefill, or "random"): the engine's buckets (B = 1), its resumed
#: pieces and three more
SSD_CASES = [(1, 48, None, None), (1, 272, None, "random"),
             (8, 512, None, None)] + SSD_BUCKETS + SSD_PIECES
SSD_WIDTHS = dict(h=64, p=64, g=1, n=128)
#: phase 3d's speculation windows (phase 10b's verify and commit scans):
#: B = 8 rows of S = spec_k + 1 = 5 from a random non-zero state, each
#: row masked at its own valid length (0: a fully masked row, whose state
#: must pass through bitwise)
SSD_WINDOW_VALID = (0, 1, 2, 3, 5, 0, 5, 3)


def ssd_flops(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
              carried: bool) -> int:
    """Operations the chunk scan needs over the real positions: per chunk
    of q positions, C·Bᵀ once per group on the causal triangle, and per
    head the decay mask, the intra-chunk (C·Bᵀ ⊙ L)(x·dt), the
    inter-chunk C·S with its decay, and the state update
    (seg_end·B)ᵀ(x·dt) with its decay; a multiply-add counts 2.  Chunk 0
    meets the initial state, so its inter-chunk C·S and state decay count
    only when that state is ``carried`` non-zero; a zero state needs none
    of them."""
    total = 0
    for c in range(-(-s // chunk)):
        q = min(chunk, s - c * chunk)
        tri = q * (q + 1) // 2
        total += g * 2 * tri * n
        total += h * (tri + 2 * tri * p + 2 * q * n * p + q * n)
        if c > 0 or carried:
            total += h * (2 * q * n * p + q * p + n * p)
    return b * total


def ssd_bound_ms(b, s, h, p, g, n, chunk, masked, init) -> dict:
    """Least time of one scan: x, dt, a, B, C, the mask and the initial
    state (where one is passed, zero or not) read once, y and the final
    state written once, against :func:`ssd_flops` at three TF32 products
    each (the 3xTF32 split, 494.7 TFLOP/s); the larger of the two, and
    beside it the f32 SIMT bound (the same bytes, one product each at
    f32's 67 TFLOP/s)."""
    nbytes = (4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                   + (1 + (init is not None)) * b * h * p * n)
              + masked * b * s)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    flops = ssd_flops(b, s, h, p, g, n, chunk, init == "random")
    t_ops = 3 * flops / TF32_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_simt_bound_ms": max(t_bytes, flops / F32_FLOP_S * 1e3)}


def ssd_inputs(dev, gen, b, s, h, p, g, n, valid, init):
    """One scan's f32 inputs at phase 3d's distributions: ``(args, kw)``
    for ``ssd_scan(*args, chunk=..., **kw)``."""
    import torch
    args = (torch.randn((b, s, h, p), generator=gen, device=dev),
            0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev),
            -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev)),
            torch.randn((b, s, g, n), generator=gen, device=dev),
            torch.randn((b, s, g, n), generator=gen, device=dev))
    state = None
    if init == "random":
        state = torch.randn((b, h, p, n), generator=gen, device=dev)
    elif init == "zero":
        state = torch.zeros((b, h, p, n), device=dev)
    kw = {"initial_state": state,
          "mask": (None if valid is None else
                   (torch.arange(s, device=dev) < valid)[None]
                   .expand(b, s).contiguous())}
    return args, kw


def ssd_kernel_phase(dev):
    """Phase 3d: ssd_scan against its plain version (``_ssd_chunked`` on
    the card, true f32) at mamba2's widths, each case's error within
    ``KERNEL_TOL`` of the output's scale; each case timed device-only
    (``graph_ms``, 20 calls a graph) and by events (20 eager calls, the
    host wrapper included), inputs hot in L2, beside its bound."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(4)
    emulate_err = None

    def compare(args, kw, chunk):
        y, fs = synced("phase 3d ssd_scan",
                       lambda: sk.ssd_scan(*args, chunk=chunk, **kw))
        y0, fs0 = _ssd_chunked(*args, chunk, **kw)
        err = max(sk.scaled_err(y, y0), sk.scaled_err(fs, fs0))
        abs_err = max((y - y0).abs().max().item(),
                      (fs - fs0).abs().max().item())
        return err, abs_err

    # small: G = 2, ragged S, Q = 48, P off the 32-column tiles, masked
    args, kw = ssd_inputs(dev, gen, 2, 77, 4, 40, 2, 16, 70, "random")
    err, _ = compare(args, kw, 48)
    check(err <= sk.KERNEL_TOL, f"ssd_scan G=2 small case: error {err}")
    per_shape, max_err, max_abs = [], err, 0.0
    w = SSD_WIDTHS
    for b, s, valid, init in SSD_CASES:
        chunk = min(256, s)
        args, kw = ssd_inputs(dev, gen, b, s, w["h"], w["p"], w["g"],
                              w["n"], valid, init)
        err, abs_err = compare(args, kw, chunk)
        check(err <= sk.KERNEL_TOL,
              f"ssd_scan ({b}, {s}) valid={valid} init={init}: scaled "
              f"error {err} > {sk.KERNEL_TOL}")
        max_err, max_abs = max(max_err, err), max(max_abs, abs_err)
        emulated = None
        if (b, s, valid, init) == SSD_BUCKETS[0] or \
                (b, s, valid, init) in SSD_PIECES:
            # the kernels against their arithmetic emulated (on the card)
            y, fs = sk.ssd_scan(*args, chunk=chunk, **kw)
            ye, fse = sref.ssd_scan_tc_emulate(*args, chunk=chunk, **kw)
            emulated = max(sk.scaled_err(y, ye), sk.scaled_err(fs, fse))
            check(emulated <= sref.EMULATE_TOL,
                  f"ssd_scan ({b}, {s}) valid={valid} init={init} against "
                  f"ssd_scan_tc_emulate: {emulated} > {sref.EMULATE_TOL}")
            emulate_err = max(emulate_err or 0.0, emulated)
            del y, fs, ye, fse

        def call(i):
            return sk.ssd_scan(*args, chunk=chunk, **kw)
        device_ms = graph_ms(call, 20)
        ms = cuda_ms(call, 20)
        plain_ms = cuda_ms(lambda i: _ssd_chunked(*args, chunk, **kw), 5)
        bound = ssd_bound_ms(b, s, w["h"], w["p"], w["g"], w["n"], chunk,
                             valid is not None, init)
        per_shape.append({"b": b, "s": s, "chunk": chunk, "valid": valid,
                          "initial_state": init, "scaled_err": err,
                          "emulate_scaled_err": emulated,
                          "max_abs_err": abs_err, "device_ms": device_ms,
                          "ms": ms, "plain_ms": plain_ms, **bound,
                          "gflop": ssd_flops(b, s, w["h"], w["p"], w["g"],
                                             w["n"], chunk,
                                             init == "random") / 1e9})
        del args, kw
    # speculation's windows: per-row valid lengths, fully masked rows
    b, s = len(SSD_WINDOW_VALID), 5
    args, kw = ssd_inputs(dev, gen, b, s, w["h"], w["p"], w["g"], w["n"],
                          None, "random")
    kw["mask"] = (torch.arange(s, device=dev)[None] < torch.as_tensor(
        SSD_WINDOW_VALID, device=dev)[:, None]).contiguous()
    err, abs_err = compare(args, kw, s)
    check(err <= sk.KERNEL_TOL,
          f"ssd_scan window (8, 5) valid={SSD_WINDOW_VALID}: scaled error "
          f"{err} > {sk.KERNEL_TOL}")
    y, fs = sk.ssd_scan(*args, chunk=s, **kw)
    ye, fse = sref.ssd_scan_tc_emulate(*args, chunk=s, **kw)
    emulated = max(sk.scaled_err(y, ye), sk.scaled_err(fs, fse))
    check(emulated <= sref.EMULATE_TOL,
          f"ssd_scan window against ssd_scan_tc_emulate: {emulated}")
    masked_rows = [i for i, v in enumerate(SSD_WINDOW_VALID) if v == 0]
    check(all(torch.equal(fs[i], kw["initial_state"][i])
              for i in masked_rows),
          "ssd_scan window: a fully masked row's final state is not its "
          "initial state bitwise")
    max_err, max_abs = max(max_err, err), max(max_abs, abs_err)
    emulate_err = max(emulate_err or 0.0, emulated)

    def call(i):
        return sk.ssd_scan(*args, chunk=s, **kw)
    window = {"b": b, "s": s, "chunk": s, "valid": list(SSD_WINDOW_VALID),
              "initial_state": "random", "scaled_err": err,
              "emulate_scaled_err": emulated, "max_abs_err": abs_err,
              "masked_rows_bitwise": True, "device_ms": graph_ms(call, 20),
              "ms": cuda_ms(call, 20),
              "plain_ms": cuda_ms(lambda i: _ssd_chunked(*args, s, **kw), 5),
              **ssd_bound_ms(b, s, w["h"], w["p"], w["g"], w["n"], s, True,
                             "random")}
    del args, kw, y, fs, ye, fse
    buckets = [r for r in per_shape
               if (r["b"], r["s"], r["valid"], r["initial_state"])
               in SSD_BUCKETS]
    keys = ("device_ms", "ms", "plain_ms", "bound_ms", "f32_simt_bound_ms",
            "gflop")
    layer = {k: sum(r[k] for r in buckets) for k in keys}
    pieces = [r for r in per_shape
              if (r["b"], r["s"], r["valid"], r["initial_state"])
              in SSD_PIECES]
    piece_sums = {k: sum(r[k] for r in pieces) for k in keys}
    emit({"kernel_check": "ssd_scan", "passed": True,
          "max_scaled_err": max_err, "max_abs_err": max_abs,
          "tol": sk.KERNEL_TOL, "emulate_scaled_err": emulate_err,
          "emulate_tol": sref.EMULATE_TOL,
          "tol_rule": "max|kernel - plain| <= tol * max(1, max|plain|)",
          "per_shape": per_shape,
          "layer_prefill_calls": {"calls": len(buckets), **layer},
          "resumed_pieces": {"calls": len(pieces), **piece_sums},
          "spec_window": window})
    head = next(r for r in per_shape if r["s"] == 448)
    gc.collect()
    torch.cuda.empty_cache()
    return {"ssd_scan": {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:81",
        "launches": None, "max_abs_err": max_abs, "max_scaled_err": max_err,
        "emulate_scaled_err": emulate_err,
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "f32_simt_bound_ms": head["f32_simt_bound_ms"],
        "library_ms": None,
        "timed_as": "one mamba2-1.3b layer's scan of the main path's "
                    "largest prefill call: B=1, S=448 (valid 438, masked), "
                    "the carried zero initial state read, H=64, P=64, "
                    "N=128, G=1, chunk 256, f32; ms by CUDA events around "
                    "20 eager calls, device_ms by CUDA-graph replays "
                    "(graph_ms), inputs hot in L2; bound: bytes or three "
                    "TF32 products each at 494.7 TFLOP/s; no single "
                    "PyTorch call computes it",
        "layer_prefill_calls": {"calls": len(buckets), **layer},
        "spec_window": window, "per_shape": per_shape}}


def ssd_kernel_us(call, calls: int = 10) -> dict:
    """Device microseconds a call of each ``ssd_*`` kernel of ``call``
    (torch.profiler over ``calls`` eager calls; kernels on the side stream
    overlap the others), or "not measured" where the trace shows none."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            call(i)
        torch.cuda.synchronize()
    out = {}
    for name, ms, _ in kernel_rows(prof):
        m = re.search(r"ssd_\w+", name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + ms * 1e3 / calls
    return out or {"ssd_": "not measured"}


def ssd_bench(root: str) -> dict:
    """``--ssd-bench ROOT``: ROOT's ``ssd_scan`` (the checkout's
    ``src/repro_torch``) at the engine's 8 prefill calls and (8, 512),
    mamba2's widths: checked against that tree's ``_ssd_chunked`` at
    ``KERNEL_TOL``, timed device-only (``graph_ms``, 20 calls) and by events
    (20 eager calls), each kernel by torch.profiler; inputs from
    :func:`ssd_inputs`, seed 4, hot in L2."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4)
    w = SSD_WIDTHS
    rows = []
    for b, s, valid, init in SSD_BUCKETS + [(8, 512, None, None)]:
        chunk = min(256, s)
        args, kw = ssd_inputs(dev, gen, b, s, w["h"], w["p"], w["g"],
                              w["n"], valid, init)

        def call(i):
            return sk.ssd_scan(*args, chunk=chunk, **kw)
        y, fs = call(0)
        y0, fs0 = _ssd_chunked(*args, chunk, **kw)
        err = max(sk.scaled_err(y, y0), sk.scaled_err(fs, fs0))
        check(err <= sk.KERNEL_TOL,
              f"{root}: ssd_scan ({b}, {s}) scaled error {err}")
        rows.append({"b": b, "s": s, "valid": valid, "scaled_err": err,
                     "device_ms": graph_ms(call, 20), "ms": cuda_ms(call, 20),
                     "kernels_us": ssd_kernel_us(call)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"root": root, "kernel": sk.__file__, "nvidia_smi": smi,
            "shapes": rows}


def ssd_against(other: str) -> dict:
    """``--ssd-against DIR``: DIR's ``ssd_scan`` and this checkout's in
    turns (DIR, this, this, DIR; a process each, the two packages share a
    name), each run printed; per shape the faster of each tree's two
    times, their ratio, and the sums over a layer's 8 prefill calls."""
    runs = []
    for root in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ssd-bench", root], capture_output=True,
                             text=True)
        check(out.returncode == 0,
              f"--ssd-bench {root} failed:\n{out.stderr[-4000:]}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    per_shape = []
    for i, row in enumerate(runs[1]["shapes"]):
        best = {side: {k: min(r["shapes"][i][k] for r in pair)
                       for k in ("device_ms", "ms")}
                for side, pair in (("other", (runs[0], runs[3])),
                                   ("this", (runs[1], runs[2])))}
        per_shape.append({"b": row["b"], "s": row["s"],
                          "other_device_ms": best["other"]["device_ms"],
                          "this_device_ms": best["this"]["device_ms"],
                          "other_ms": best["other"]["ms"],
                          "this_ms": best["this"]["ms"],
                          "speedup_device": best["other"]["device_ms"]
                          / best["this"]["device_ms"]})
    layer = [r for r in per_shape if r["b"] == 1]
    return {"against": other, "nvidia_smi": runs[1]["nvidia_smi"],
            "per_shape": per_shape,
            "layer_prefill_calls": {
                k: sum(r[k] for r in layer)
                for k in ("other_device_ms", "this_device_ms", "other_ms",
                          "this_ms")},
            "faster_everywhere": all(r["this_device_ms"]
                                     < r["other_device_ms"]
                                     for r in per_shape)}


#: phase 3e: JAX's test_flash_vs_ref shapes (B, S, H, Hkv, D), causal and
#: not, f32 and bf16 (bf16 at D = 64 on the tensor-core kernel, at 16 and
#: 32 on the SIMT one); S = 1000, off both kernels' tiles (called on
#: flash_attention directly: ops.mha keeps JAX's tiling), bf16, causal and
#: not; then yi-9b's heads at the main path's (B, S), causal, f32 and bf16
FLASH_JAX_CASES = [(1, 128, 2, 2, 16), (2, 256, 4, 2, 32),
                   (1, 512, 8, 1, 64)]
FLASH_RAGGED_CASES = [(1, 1000, 8, 2, 128)]
FLASH_YI_CASES = [(1, 512, 32, 4, 128), (2, 4096, 32, 4, 128)]


def flash_bound_ms(b, s, h, hkv, d, itemsize, causal,
                   peak) -> tuple[float, str]:
    """Least time of one call: q, k, v read once and o written once, against
    the operations the mask leaves (4 B H S^2 D, halved when causal) at the
    input type's peak; the larger of the two."""
    nbytes = itemsize * (2 * b * s * h * d + 2 * b * s * hkv * d)
    flops = 4 * b * h * s * s * d * (0.5 if causal else 1.0)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of want (2^(e - 7) for 2^e <= |want|
    < 2^(e + 1)) over the elements with |want| >= 1/64, where f32's own
    error (~1e-6 absolute) is far below half an ulp; rounding to nearest
    stays within 0.5, a truncating store reaches 1."""
    import torch
    big = want.abs() >= 2.0 ** -6
    e = torch.floor(torch.log2(want[big].abs()))
    return ((got.float()[big] - want[big]).abs()
            / torch.exp2(e - 7)).max().item()


def simt_bf16(q, k, v, *, sm_scale, causal, num_q_heads, num_kv_heads):
    """The SIMT kernel on bf16 operands at any D, the wrapper bypassed (no
    launch is counted): the pre-redesign kernel of bf16 at D = 128, timed
    beside the tensor-core kernel on the same inputs."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fk
    o = torch.empty_like(q)
    bh, s, d = q.shape
    err = fk._lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d,
        num_q_heads, num_kv_heads, float(sm_scale), int(causal), 1,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"SIMT flash kernel launch: cudaError_t {err}")
    return o


def flash_kernel_phase(dev):
    """Phase 3e: each flash kernel against its plain version on the same
    input values in f32 (``flash_attention.reference``), at the tolerance
    stated in ``kernels/flash_attention/flash_attention.py`` (SIMT: 2e-5
    f32, bf16 half an output ulp past that; tensor-core: that plus its p
    flips, against ``attention_ref_tiled``), bf16 also within JAX's 2e-2 of
    the f32 reference on the unrounded inputs; each call's kernel read from
    the launch counters.  Times at (2, 4096): bf16 on the tensor-core
    kernel, f32 on the SIMT kernel, the SIMT kernel on the same bf16 inputs
    (the pre-redesign path), the plain versions and SDPA (timed only: the
    port never calls it), beside the bounds."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    both = (torch.float32, torch.bfloat16)
    cases = ([(c, causal, dt) for c in FLASH_JAX_CASES
              for causal in (True, False) for dt in both]
             + [(c, causal, torch.bfloat16) for c in FLASH_RAGGED_CASES
                for causal in (True, False)]
             + [(c, True, dt) for c in FLASH_YI_CASES for dt in both])
    per_shape, max_err, max_share = [], {}, {}
    for (b, s, h, hkv, d), causal, dt in cases:
        q = torch.randn((b * h, s, d), generator=gen, device=dev)
        k = torch.randn((b * hkv, s, d), generator=gen, device=dev)
        v = torch.randn((b * hkv, s, d), generator=gen, device=dev)
        kw = dict(sm_scale=d ** -0.5, causal=causal, num_q_heads=h,
                  num_kv_heads=hkv)
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        tc0 = fk.flash_attention.launches_tc
        got = fk.flash_attention(qd, kd, vd, **kw)
        torch.cuda.synchronize()
        tc = fk.flash_attention.launches_tc - tc0
        check(tc == fk.takes_wgmma(dt, d),
              f"flash ({b}, {s}, {h}, {hkv}, {d}) {dt}: tensor-core "
              f"launches {tc}")
        kernel = "wgmma" if tc else "simt"
        plain, bound = fk.reference(qd, kd, vd, **kw)
        share = fk.tolerance_share(got, plain, bound)
        err = (got.float() - plain).abs().max().item()
        name = str(dt).split(".")[1]
        row = {"b": b, "s": s, "h": h, "hkv": hkv, "d": d,
               "causal": causal, "dtype": name, "kernel": kernel,
               "max_abs_err": err, "tol_share": share}
        check(share <= 1.0, f"flash {row}: past its tolerance")
        key = f"{name}_{kernel}"
        max_err[key] = max(max_err.get(key, 0.0), err)
        max_share[key] = max(max_share.get(key, 0.0), share)
        if dt == torch.bfloat16:
            row["max_err_bf16_ulps"] = bf16_ulps(got, plain)
            del plain, bound
            want = attention_ref(q, k, v, **kw)
            torch.testing.assert_close(got.float(), want, rtol=fk.BF16_TOL,
                                       atol=fk.BF16_TOL)
            row["max_abs_err_vs_f32_inputs"] = (
                got.float() - want).abs().max().item()
            del want
        else:
            del plain, bound
        if s == 4096:
            itemsize = 2 if dt == torch.bfloat16 else 4
            peak = BF16_FLOP_S if dt == torch.bfloat16 else F32_FLOP_S
            rounded = (dict(p_dtype=torch.bfloat16, block_k=fk.BLOCK_K)
                       if tc else {})
            row["ms"] = cuda_ms(lambda i: fk.flash_attention(qd, kd, vd,
                                                             **kw), 20)
            row["plain_ms"] = cuda_ms(lambda i: attention_ref(
                qd, kd, vd, **kw, **rounded), 3)
            if tc:
                row["simt_ms"] = cuda_ms(lambda i: simt_bf16(qd, kd, vd,
                                                             **kw), 5)
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, s, h, hkv, d, itemsize, causal, peak)
            q4 = qd.reshape(b, h, s, d)
            k4, v4 = kd.reshape(b, hkv, s, d), vd.reshape(b, hkv, s, d)
            row["library_ms"] = cuda_ms(
                lambda i: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True), 20)
            row["gflop"] = 4 * b * h * s * s * d * 0.5 / 1e9
            row["tflop_s"] = row["gflop"] / row["ms"]
        per_shape.append(row)
        del q, k, v, got, qd, kd, vd
    tols = {"float32": fk.tolerance(torch.float32),
            "bfloat16_simt": fk.tolerance(torch.bfloat16),
            "bfloat16_wgmma": "atol + rtol |plain| + p flips, against "
                              "attention_ref_tiled (block_k "
                              f"{fk.BLOCK_K}, flip_eta {fk.FLIP_ETA})",
            "bfloat16_vs_f32_inputs": fk.BF16_TOL}
    emit({"kernel_check": "flash_attention", "passed": True,
          "max_abs_err": max_err, "max_tol_share": max_share, "tol": tols,
          "per_shape": per_shape})
    at = {(r["dtype"], r["kernel"]): r for r in per_shape if r["s"] == 4096}
    head, f32 = at[("bfloat16", "wgmma")], at[("float32", "simt")]
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_wgmma.cu",
        "source_f32": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:70",
        "launches": None, "launches_tc": None,
        "max_abs_err": max_err["bfloat16_wgmma"],
        "max_abs_err_f32": max_err["float32_simt"],
        "max_tol_share": max_share, "tolerance": tols,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "ms_simt_bf16": head["simt_ms"], "ms_f32": f32["ms"],
        "plain_ms_f32": f32["plain_ms"], "bound_ms_f32": f32["bound_ms"],
        "library_ms_f32": f32["library_ms"],
        "timed_as": "one yi-9b layer's causal attention of the training "
                    "phase's eval loss: B=2, S=4096, H=32, Hkv=4, D=128; ms: "
                    "bf16 on the tensor-core kernel; ms_simt_bf16: the "
                    "SIMT kernel on the same bf16 inputs (the pre-redesign "
                    "path); ms_f32: f32 on the SIMT kernel; library: "
                    "F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True) on the same inputs",
        "per_shape": per_shape}}


def quant_matmul_phase(dev):
    """Phase 5: the card's quant_matmul against the CPU's, every mode."""
    import torch

    from repro_torch.core import luna, quant
    from repro_torch.core.layers import QUANT_MODES, QuantConfig, quant_matmul
    from repro_torch.kernels.luna_mm.ops import luna_mm_codes

    gen = torch.Generator().manual_seed(3)
    errs = {}
    for m in (8, 40):          # int8: the f64 (M <= 16) and _int_mm routes
        x = torch.randn((m, 4096), generator=gen)
        w = torch.randn((4096, 1024), generator=gen) / 64
        xq, wq = quant.calibrate(x, 4), quant.calibrate(w, 4, axis=-1)
        qx, qw = quant.quantize(x, xq), quant.quantize(w, wq)
        xg, wg = x.to(dev), w.to(dev)
        qxg = quant.quantize(xg, quant.calibrate(xg, 4))
        qwg = quant.quantize(wg, quant.calibrate(wg, 4, axis=-1))
        check(torch.equal(qxg.cpu(), qx) and torch.equal(qwg.cpu(), qw),
              f"M={m}: 4-bit codes on the card differ from the CPU's")
        for mode in LUNA_MODES:
            check(torch.equal(luna_mm_codes(qxg, qwg, mode=mode).cpu(),
                              luna.luna_matmul(qx, qw, mode=mode)),
                  f"M={m} {mode}: int32 accumulators differ from the CPU's")
        for mode in QUANT_MODES:
            cfg = QuantConfig(mode=mode)
            got = quant_matmul(xg, wg, cfg).cpu()
            want = quant_matmul(x, w, cfg)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs[f"{mode} M={m}"] = (got - want).abs().max().item()
    emit({"quant_matmul_card_vs_cpu": "f32 x (M, 4096) @ w (4096, 1024)",
          "codes_bitwise": True, "int32_accumulators_bitwise": True,
          "max_abs_err": errs, "rtol": 1e-5, "atol": 1e-5})


def tree_to(node, device):
    """A parameter tree (dicts, lists, tensors) copied to ``device``."""
    if isinstance(node, dict):
        return {k: tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_to(v, device) for v in node]
    return node.to(device)


def small_reference_phase(dev):
    """Phase 4: reduced f32 yi-9b, card against CPU."""
    import torch

    from repro_torch.core.quant import quantize_decode_params
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.transformer import TransformerLM

    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    cpu = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    gpu = TransformerLM.from_params(cfg, tree_to(cpu.params_tree(), dev),
                                    device=dev)
    toks = torch.randint(1, cfg.vocab_size, (4, 12),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    with torch.inference_mode():
        for quant in ("lut4", "nf4p"):
            qc = quantize_decode_params(cpu.params_tree(), quant)
            qg = quantize_decode_params(gpu.params_tree(), quant)
            for a, b in zip(qc["blocks"], qg["blocks"]):
                for grp in ("attn", "mlp"):
                    for name, qa in a[grp].items():
                        qb = b[grp][name]
                        check(all(torch.equal(getattr(qa, f).cpu(),
                                              getattr(qb, f).cpu())
                                  for f in ("codes", "scale", "zero_point")),
                              f"{quant} {name}: card quantization differs "
                              "from the CPU's")
            logits = []
            for model, tree, device in ((cpu, qc, "cpu"), (gpu, qg, dev)):
                m = TransformerLM.from_params(cfg, tree, device=device)
                caches = model.init_cache(4, 32)
                _, caches = model.prefill(toks.to(device), caches)
                lg_, _ = m.decode_step(toks[:, -1:].to(device), caches,
                                       torch.full((4,), 12, device=device))
                logits.append(lg_.float().cpu())
            torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                       atol=1e-4)
            out[quant] = (logits[1] - logits[0]).abs().max().item()
        # model-level lut_nf4: codes depend on the weights only, so the
        # card (full-table kernel) and the CPU (JAX's library order) agree
        # up to f32 summation order
        from dataclasses import replace

        from repro_torch.core.layers import QuantConfig
        qcfg = replace(cfg, quant=QuantConfig(mode="lut_nf4"))
        logits = []
        for model, device in ((cpu, "cpu"), (gpu, dev)):
            m = TransformerLM.from_params(qcfg, model.params_tree(),
                                          device=device)
            lg_, _ = m.prefill(toks.to(device), m.init_cache(4, 32))
            logits.append(lg_.float().cpu())
        torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                   atol=1e-4)
        out["lut_nf4 prefill"] = (logits[1] - logits[0]).abs().max().item()
    emit({"small_reference": "reduced yi-9b f32, logits card vs cpu",
          "max_abs_err": out, "rtol": 1e-4, "atol": 1e-4})


def small_ssm_reference_phase(dev):
    """Phase 4, mamba2: a reduced f32 mamba2, card against CPU.  Prefill
    of right-padded rows with ``last_pos`` (the card's SSD scan on the
    kernel), then one decode step under lut4 and nf4p (w_in/w_out on the
    D&C kernels); the frozen codes of w_in/w_out bitwise equal."""
    import torch

    from repro_torch.core.quant import quantize_decode_params
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.ssm_lm import SSMLM

    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    gpu = SSMLM.from_params(cfg, tree_to(cpu.params_tree(), dev), device=dev)
    lens = torch.tensor([48, 30, 17, 5])
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (4, 48), generator=gen)
    toks[torch.arange(48)[None, :] >= lens[:, None]] = 0
    nxt = torch.randint(1, cfg.vocab_size, (4, 1), generator=gen)
    out = {}
    with torch.inference_mode():
        runs = []
        for model, device in ((cpu, "cpu"), (gpu, dev)):
            lg, caches = model.prefill(toks.to(device),
                                       model.init_cache(4, 48),
                                       last_pos=(lens - 1).to(device))
            runs.append((lg.float().cpu(), caches))
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4,
                                   atol=1e-4)
        out["prefill"] = (runs[1][0] - runs[0][0]).abs().max().item()
        for quant in ("lut4", "nf4p"):
            qc = quantize_decode_params(cpu.params_tree(), quant)
            qg = quantize_decode_params(gpu.params_tree(), quant)
            for a, b in zip(qc["blocks"], qg["blocks"]):
                for name in ("w_in", "w_out"):
                    qa, qb = a["m"][name], b["m"][name]
                    check(all(torch.equal(getattr(qa, f).cpu(),
                                          getattr(qb, f).cpu())
                              for f in ("codes", "scale", "zero_point")),
                          f"mamba2 {quant} {name}: card quantization "
                          "differs from the CPU's")
            logits = []
            for (_, caches), tree, device in ((runs[0], qc, "cpu"),
                                              (runs[1], qg, dev)):
                m = SSMLM.from_params(cfg, tree, device=device)
                lg, _ = m.decode_step(nxt.to(device), caches,
                                      lens.to(device))
                logits.append(lg.float().cpu())
            torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                       atol=1e-4)
            out[f"{quant} decode"] = (logits[1] - logits[0]).abs().max().item()
    emit({"small_reference": "reduced mamba2 f32, logits card vs cpu "
                             "(right-padded prefill through ssd_scan, one "
                             "decode step)", "codes_bitwise": True,
          "max_abs_err": out, "rtol": 1e-4, "atol": 1e-4})


#: phase 4's engines on the cache substrate, each against the dense,
#: whole-prompt, cold engine: (family, label, EngineConfig knobs)
SMALL_SUBSTRATES = [
    ("dense", "paged", dict(paged=True, block_size=8)),
    ("dense", "paged chunked", dict(paged=True, block_size=8,
                                    prefill_chunk=8)),
    ("dense", "paged prefix chunked", dict(paged=True, block_size=8,
                                           prefill_chunk=8,
                                           prefix_cache=True)),
    ("dense", "paged prefix", dict(paged=True, block_size=8,
                                   prefix_cache=True)),
    ("ssm", "chunked", dict(prefill_chunk=8)),
    ("ssm", "prefix chunked", dict(prefill_chunk=8, prefix_cache=True)),
]


def small_substrate_phase(dev):
    """Phase 4, the cache substrate: reduced f32 yi-9b and mamba2 (seed 1
    weights, the same on both devices) serve a shared-head mix on 3 slots
    (warm, cold, strict-extension and chunked admissions; 5 new tokens
    each) on the paged, chunked and warm-prefix engines: greedy tokens on
    the card equal the CPU's, and both equal the dense, whole-prompt, cold
    engine's on the CPU; the prefix engines hit."""
    import numpy as np
    import torch

    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    out = {}
    for arch in ("yi-9b", "mamba2-1.3b"):
        cfg = get_config(arch).reduced(dtype="float32", attn_impl="full")
        cpu = get_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1))
        gpu = type(cpu).from_params(cfg, tree_to(cpu.params_tree(), dev),
                                    device=dev)
        rng = np.random.default_rng(2)
        head = rng.integers(1, cfg.vocab_size, 24).tolist()
        mix = [head + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (6, 13, 2, 9, 20)]
        mix.insert(3, rng.integers(1, cfg.vocab_size, 11).tolist())

        def serve(model, device, **knobs):
            eng = Engine(cfg, model, EngineConfig(max_batch=3, max_seq=64,
                                                  **knobs), device=device)
            reqs = [Request(rid=i, prompt=p, max_new=5)
                    for i, p in enumerate(mix)]
            stats = eng.serve(reqs)
            check(stats["done"], f"phase 4 {arch} {knobs}: not done")
            return [r.out for r in reqs], stats

        cold, _ = serve(cpu, "cpu")
        for family, label, knobs in SMALL_SUBSTRATES:
            if family != cfg.family:
                continue
            on_cpu, _ = serve(cpu, "cpu", **knobs)
            on_card, stats = serve(gpu, dev, **knobs)
            check(on_cpu == cold,
                  f"phase 4 {arch} {label}: CPU tokens differ from the "
                  "dense, whole-prompt, cold engine's")
            check(on_card == on_cpu,
                  f"phase 4 {arch} {label}: card tokens differ from the "
                  "CPU's")
            if knobs.get("prefix_cache"):
                check(stats["prefix_hits"] >= 2,
                      f"phase 4 {arch} {label}: {stats['prefix_hits']} hits")
            out[f"{arch} {label}"] = {
                k: stats[k] for k in ("prefix_hits", "prefix_tokens_reused",
                                      "prefill_chunks", "prefill_calls")}
    emit({"small_substrate": "reduced f32 yi-9b and mamba2, greedy tokens "
                             "card == cpu == dense whole-prompt cold",
          "runs": out})


def small_training_phase(dev):
    """Phase 4, training: reduced f32 yi-9b, card against CPU, through
    ``repro_torch.train.card_vs_cpu`` (the checks and tolerances the card
    tests use): the cacheless forward under attn_impl="flash", the STE on
    identical inputs, the loss and every gradient under chunked attention
    and under luna_approx through the STE on luna_mm, one train step's
    params.  Beside them, the reason luna_approx's gradients have a
    tolerance of their own: the same effect on the CPU alone under 1e-7
    relative weight noise."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.train import card_vs_cpu as cc
    from repro_torch.tree import tree_map

    out = cc.training_card_vs_cpu(dev)
    out["ste on identical inputs (scaled)"] = cc.ste_card_vs_cpu(dev)
    cfg, cpu, batch = cc.reduced_setup()
    noise = torch.Generator().manual_seed(9)
    for name, c in (("chunked", cfg), ("luna_approx", replace(
            cfg, quant=QuantConfig(mode="luna_approx")))):
        a = type(cpu).from_params(c, cpu.params_tree(), device="cpu")
        b = type(cpu).from_params(c, tree_map(
            lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=noise)),
            cpu.params_tree()), device="cpu")
        for m in (a.requires_grad_(True), b.requires_grad_(True)):
            m.loss(batch)[0].backward()
        out[f"{name} grads, cpu vs cpu with 1e-7 weight noise (scaled)"] = \
            cc.scaled_grad_err(a, b)
    emit({"small_reference": "reduced yi-9b f32 training, card vs cpu "
                             "(B=2, S=256)", "max_err": out,
          "rtol": cc.TOL, "atol": cc.TOL, "ste_rel": cc.STE_REL,
          "grad_tol": {"chunked": cc.GRAD_REL,
                       "luna_approx": cc.LUNA_GRAD_REL,
                       "of": "each leaf's max |cpu grad|"}})


def kernel_rows(prof) -> list:
    """(name, device ms, calls) of every CUDA kernel in a profile, by
    device time (an ATen op's row would repeat its kernels' time)."""
    import torch
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]
    return sorted(rows, key=lambda r: -r[1])


def busy_ms(prof, match: str = "") -> float | None:
    """Device ms in the CUDA kernels whose name holds ``match``, the union
    of their intervals (kernels on two streams that overlap count once);
    None where the trace holds no device interval."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA and match in e.name)
    if not spans:
        return None
    total, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def profile_decode(eng, prompts, ticks: int = 4) -> dict:
    """Device time by kernel over ``ticks`` steady decode ticks of a fresh
    batch (torch.profiler; admission and drain run outside the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    # a chunked engine admits one piece a tick: the window opens once
    # every admission has landed, and each request outlives it
    staged = 2 * len(prompts) if eng.prefill_chunk is not None else 0
    reqs = [Request(rid=100 + i, prompt=p, max_new=ticks + 4 + staged)
            for i, p in enumerate(prompts)]
    eng.serve(reqs, max_ticks=1)           # admit + first decode tick
    while eng._chunked or eng.scheduler.pending:
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.serve([])                          # drain
    rows = kernel_rows(prof)
    device_ms = sum(r[1] for r in rows)
    ours_ms = sum(r[1] for r in rows
                  if any(t in r[0] for t in ("lut_gemm", "luna_mm",
                                             "splitk_reduce", "ssd_")))
    return {"profile": "decode ticks", "ticks": ticks, "wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "port_kernels_ms": ours_ms if rows else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if rows
            else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:12]]}


def watch_logits(eng) -> tuple[list, list]:
    """Wrap ``logits`` of the engine's prefill and decode models (on the
    instances; the caller deletes the attribute after the run) so every
    call records whether all its logits are finite.  Returns (the
    records, the models watched)."""
    import torch
    finite = []

    def watch(m):
        base = m.logits

        def logits(hidden):
            out = base(hidden)
            finite.append(torch.isfinite(out).all())
            return out
        m.logits = logits

    watched = list({id(eng.params): eng.params,
                    id(eng.decode_params): eng.decode_params}.values())
    for m in watched:
        watch(m)
    return finite, watched


def reset_counters(wrappers: dict) -> None:
    """Every kernel wrapper's launch counters to 0."""
    for f in wrappers.values():
        f.launches = 0
    for name in TC_ROUTED:
        wrappers[name].launches_tc = 0
    wrappers["lut_gemm"].launches_wgmma = 0


def read_counters(wrappers: dict) -> tuple[dict, dict]:
    """(launches by kernel, launches by tensor-core route: ``launches_tc``
    of each ``TC_ROUTED`` wrapper, lut_gemm's prefill kernel under
    ``"lut_gemm_wgmma"``)."""
    counts = {name: f.launches for name, f in wrappers.items()}
    tc = {name: wrappers[name].launches_tc for name in TC_ROUTED}
    tc["lut_gemm_wgmma"] = wrappers["lut_gemm"].launches_wgmma
    return counts, tc


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention)
    from repro_torch.kernels.luna_mm.luna_mm import luna_mm
    from repro_torch.kernels.lut_gemm.lut_gemm import (lut_gemm, lut_gemm_dc,
                                                       lut_gemm_dc_res)
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    return {f.__name__: f for f in (lut_gemm_dc, lut_gemm_dc_res, luna_mm,
                                    lut_gemm, ssd_scan, flash_attention)}


def request_mix(vocab: int) -> list:
    """8 prompts of 16-512 tokens from seed 0 (lengths 438, 332, 270, 150,
    168, 36, 53, 24), ids in [1, vocab)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 513, size=8)
    return [rng.integers(1, vocab, int(n)).tolist() for n in lens]


def build_model(dev, layers: int):
    """yi-9b at its published widths, ``layers`` deep, bf16, random weights
    from seed 0; and the request mix (8 prompts of 16-512 tokens)."""
    from dataclasses import replace

    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = replace(get_config("yi-9b"), num_layers=layers)
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": layers, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "init_s": time.perf_counter() - t0})
    return cfg, model, request_mix(cfg.vocab_size)


def build_ssm_model(dev):
    """mamba2-1.3b at its published widths, all 48 layers, bf16, random
    weights from seed 0; the same request-length mix as yi-9b's."""
    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "ssm": vars(cfg.ssm),
          "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
          "init_s": time.perf_counter() - t0})
    return cfg, model, request_mix(cfg.vocab_size)


def profile_prefill(eng, prompt) -> dict:
    """Device time by kernel over one prefill call of ``prompt`` alone
    (torch.profiler; the request is admitted, then drained outside the
    window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    req = Request(rid=200, prompt=prompt, max_new=1)   # done at admission
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve([req])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    # ssd_scan runs ssd_cb and chunk 0's ssd_chunk_out on a side stream
    # beside its other kernels: device time is the union of the kernels'
    # intervals; the summed durations are kept beside it
    busy, ssd_busy = busy_ms(prof), busy_ms(prof, "ssd_")
    return {"profile": f"one prefill call, {len(prompt)} tokens",
            "wall_ms": wall_ms,
            "device_ms": busy if busy is not None else "not measured",
            "kernel_ms_summed": sum(r[1] for r in rows) if rows
            else "not measured",
            "ssd_scan_ms": ssd_busy if ssd_busy is not None
            else "not measured",
            "ssd_scan_kernel_ms_summed": (
                sum(r[1] for r in rows if "ssd_" in r[0]) if rows
                else "not measured"),
            "device_idle_share": (1 - busy / wall_ms) if busy is not None
            else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def serve_once(dev, cfg, model, prompts, quant: str | None,
               kern: str | None, record: bool = False, profile: bool = True
               ) -> tuple[dict, list, dict, dict]:
    """One main-path run: the engine serves the request mix; every kernel
    counter is set to 0 just before and read just after.  Returns the
    launches by kernel, each request's tokens and the launches of each
    kernel's tensor-core route (``launches_tc``; lut_gemm's prefill kernel
    under ``"lut_gemm_wgmma"``): luna_mm's checked against its ``takes_tc``
    and lut_gemm's against its ``route`` at each call's M (max_batch rows a
    decode tick, rows x bucket length a prefill call), every
    ``lut_gemm_dc`` / ``_res`` launch (decode's M = max_batch, bf16)
    required on it.  ``quant``: None
    (full precision), an engine-level mode (EngineConfig.quant: frozen
    decode projections, prefill full precision) or a model-level one
    (cfg.quant, every projection of prefill and decode; the model shares
    ``model``'s tensors).  ``kern`` must have launched once per projection
    (7 a layer for yi-9b, 2 for mamba2) of each decode tick, and of each
    prefill call under a model-level mode; for mamba2 ``ssd_scan`` once
    per layer of each prefill call; no other kernel at all.  Profiles 4
    decode ticks after (and, for mamba2, one prefill call).  The fourth
    value: the run's decode tok/s and, with ``record``, each decode step's
    logits by (rid, step) (:func:`record_logits`; phase 10's reference).
    ``profile=False`` leaves the profiles out."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.serve.config import ENGINE_QUANT_MODES, EngineConfig
    from repro_torch.serve.engine import Engine, Request

    t0 = time.perf_counter()
    model_level = quant is not None and quant not in ENGINE_QUANT_MODES
    if model_level:
        qcfg = replace(cfg, quant=QuantConfig(mode=quant))
        eng = Engine(qcfg, type(model).from_params(
            qcfg, model.params_tree(), device=dev),
            EngineConfig(max_batch=8, max_seq=1024), device=dev)
    else:
        eng = Engine(cfg, model, EngineConfig(quant=quant, max_batch=8,
                                              max_seq=1024), device=dev)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    finite, watched = watch_logits(eng)
    rec, unhook = record_logits(eng) if record else (None, None)
    reqs = [Request(rid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    luna_tc = tc["luna_mm"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in watched:
        del m.logits
    if unhook is not None:
        unhook()
    layers = cfg.num_layers
    ticks = eng.metrics.ticks
    want = dict.fromkeys(wrappers, 0)
    if kern is not None:
        want[kern] = ((ticks + model_level * stats["prefill_calls"])
                      * layers * PROJECTIONS[cfg.family])
    if cfg.family == "ssm":
        want["ssd_scan"] = stats["prefill_calls"] * layers
    check(stats["done"] and all(len(r.out) == 32 for r in reqs),
          f"{cfg.name} {quant}: not every request finished")
    check(finite and bool(torch.stack(finite).all()),
          f"{cfg.name} {quant}: non-finite logits")
    check(counts == want,
          f"{cfg.name} {quant}: launches {counts}, want {want}")
    # luna_mm's route: M = max_batch rows at each decode tick, M = rows x
    # bucket length at each prefill call (one call per length bucket)
    buckets = Counter(eng._bucket_len(len(p)) for p in prompts)
    prefill_m = sorted(c * blen for blen, c in buckets.items())
    per_layer = [(ticks, eng.max_batch)] + [(1, mm) for mm in prefill_m]
    want_tc = 0
    if kern in ("luna_mm", "lut_gemm"):
        check(len(prefill_m) == stats["prefill_calls"],
              f"{cfg.name} {quant}: {stats['prefill_calls']} prefill calls, "
              f"{len(prefill_m)} length buckets")
    if kern == "luna_mm":
        from repro_torch.kernels.luna_mm.luna_mm import takes_tc
        want_tc = layers * sum(c * takes_tc(mm, k, n, "row", True)
                               for c, mm in per_layer
                               for k, n in LAYER_SHAPES)
    check(luna_tc == want_tc,
          f"{cfg.name} {quant}: {luna_tc} luna_mm launches on the "
          f"tensor-core kernel, want {want_tc}")
    # lut_gemm: every bf16 launch on the kernel its route names (x and the
    # fresh codes are 16-byte aligned)
    routes = Counter()
    if kern == "lut_gemm":
        from repro_torch.kernels.lut_gemm.lut_gemm import route
        for c, mm in per_layer:
            for k, n in LAYER_SHAPES:
                routes[route(mm, k, n, torch.bfloat16, True)] += c * layers
    got = {"tc": tc["lut_gemm"], "wgmma": tc["lut_gemm_wgmma"],
           "fma": counts["lut_gemm"] - tc["lut_gemm"] - tc["lut_gemm_wgmma"]}
    check(got == {r: routes[r] for r in got},
          f"{cfg.name} {quant}: lut_gemm launches by kernel {got}, its "
          f"route says {dict(routes)}")
    for n in ("lut_gemm_dc", "lut_gemm_dc_res"):
        check(tc[n] == counts[n],
              f"{cfg.name} {quant}: {tc[n]} of {counts[n]} {n} launches on "
              "the tensor-core kernel")
    prof = {}
    if profile:                            # after the counts are read
        prof = profile_decode(eng, prompts)
        if cfg.family == "ssm":
            prof["prefill"] = profile_prefill(eng, max(prompts, key=len))
    emit({"main_path": quant or "bf16", "model": cfg.name,
          "requests": len(reqs),
          "prompt_lens": [len(p) for p in prompts], "max_new": 32,
          "layers": layers, "decode_ticks": ticks,
          "prefill_calls": stats["prefill_calls"], "launches": counts,
          "launches_tc": tc, "prefill_m": prefill_m,
          "prefill_tok_s": stats["prefill_tok_s"],
          "decode_tok_s": stats["decode_tok_s"],
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          "wall_s": wall, "quantize_s": quant_s, "peak_mem_gb": peak_gb,
          "first_tokens": [r.out[0] for r in reqs], **{
              f"profile_{k}": v for k, v in prof.items()}})
    out = [r.out for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out, tc, {"decode_tok_s": stats["decode_tok_s"],
                             "logits": rec}


def add_launches(total: dict, counts: dict) -> None:
    """Sum a run's counts into ``total``, for the kernels it launched."""
    for name, n in counts.items():
        if n:
            total[name] = total.get(name, 0) + n


#: phase 6b's model-level runs repeat phase 6a's serving path, host-bound
#: (re-quantizing every weight each call): on the first 24 of the model's
#: layers (the same weights), which keeps the whole script near half its
#: time limit now that phase 9 runs too
MODEL_LEVEL_LAYERS = 24


def main_path_phase(dev, cfg, model, prompts) -> tuple[dict, dict, dict]:
    """Phase 6: the engine at yi-9b's full width; returns launches by
    kernel and by tensor-core route (``launches_tc``), and each run's
    tokens by quant mode.  6a:
    engine-level lut4 / nf4p (decode projections on the D&C kernels,
    prefill full precision).  6b: model-level luna_approx2 / luna_dc
    (every projection on luna_mm) and lut_nf4 (on lut_gemm), on the
    first ``MODEL_LEVEL_LAYERS`` layers."""
    from dataclasses import replace

    cut = replace(cfg, num_layers=min(MODEL_LEVEL_LAYERS, cfg.num_layers))
    tree = model.params_tree()
    cut_model = type(model).from_params(
        cut, {**tree, "blocks": tree["blocks"][:cut.num_layers]}, device=dev)
    launches, outs, tc_total = {}, {}, {}
    for quant, kern in (("lut4", "lut_gemm_dc"), ("nf4p", "lut_gemm_dc_res"),
                        ("luna_approx2", "luna_mm"), ("luna_dc", "luna_mm"),
                        ("lut_nf4", "lut_gemm")):
        full = quant in ("lut4", "nf4p")
        counts, outs[quant], tc, _ = serve_once(
            dev, cfg if full else cut, model if full else cut_model, prompts,
            quant, kern)
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    # prefill runs the same full-precision model under lut4 and nf4p
    check([o[0] for o in outs["lut4"]] == [o[0] for o in outs["nf4p"]],
          "first (prefill) tokens differ between the lut4 and nf4p runs")
    return launches, tc_total, outs


def ssm_main_path_phase(dev, cfg, model, prompts
                        ) -> tuple[dict, dict, list, dict]:
    """Phase 7: the engine at mamba2-1.3b's full width (48 layers, bf16);
    returns launches by kernel and by tensor-core route, and the nf4p
    run's tokens, decode tok/s and logits (phase 10b's reference).
    Prefill (full precision in every run) on ssd_scan, decode full
    precision, then w_in/w_out frozen to lut4 (on lut_gemm_dc) and nf4p
    (on lut_gemm_dc_res)."""
    launches, outs, tc_total = {}, {}, {}
    for quant, kern in ((None, None), ("lut4", "lut_gemm_dc"),
                        ("nf4p", "lut_gemm_dc_res")):
        counts, outs[quant], tc, extra = serve_once(
            dev, cfg, model, prompts, quant, kern, record=quant == "nf4p")
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    firsts = {q: [o[0] for o in out] for q, out in outs.items()}
    check(firsts[None] == firsts["lut4"] == firsts["nf4p"],
          f"mamba2 first (prefill) tokens differ between runs: {firsts}")
    return launches, tc_total, outs["nf4p"], extra


#: phase 9's shared-prefix mix: a 384-token prefix (24 blocks of 16, a
#: multiple of mamba2's 16-token capture grid) and 7 tails of 8-64 tokens
SHARED_PREFIX = 384
#: phase 9's warm-vs-cold bound on the first-token logits (bf16 models):
#: max |warm - cold| <= WARM_FACTOR * max |cold - exact|, ``exact`` the
#: same prompt prefilled whole on an f32 copy of the weights.  The warm
#: prefix was computed in chunked pieces, the cold prompt in one call:
#: two bf16 roundings of one function, each about as far from exact
#: arithmetic as the other, so by the triangle inequality about twice
#: that distance apart at most.  Beside it the warm logits must equal,
#: bitwise, a replay of the same pieces from a fresh cache
#: (:func:`replay_staged`): any error of the shared blocks or the
#: snapshot shows there exactly.
WARM_FACTOR = 2.0


def shared_prefix_mix(vocab: int) -> list:
    """Phase 9's prompts from seed 1: the 384-token prefix alone, then the
    prefix with 7 distinct tails (lengths 34, 37, 51, 62, 9, 16, 54), ids
    in [1, vocab)."""
    import numpy as np
    rng = np.random.default_rng(1)
    tails = rng.integers(8, 65, size=7)
    prefix = rng.integers(1, vocab, SHARED_PREFIX).tolist()
    return [prefix] + [prefix + rng.integers(1, vocab, int(n)).tolist()
                       for n in tails]


def substrate_run(dev, cfg, model, quant: str, kern: str, knobs: dict,
                  batches: list, label: str, warm_check: bool = False
                  ) -> tuple[dict, list, dict, dict]:
    """One phase-9 run: the engine under ``EngineConfig(quant, max_batch=8,
    max_seq=1024, **knobs)`` serves ``batches`` (lists of prompts, one
    ``serve()`` each, in order; 32 new tokens a request), every kernel
    counter set to 0 just before the first and read just after the last.
    Checks: every request finished, every logit finite, ``kern`` launched
    once per decode projection of each tick (``ssd_scan`` once per layer
    of each prefill call for mamba2) and no other kernel, every ``kern``
    launch on the tensor-core kernel; on a pool, every block free or held
    by the prefix cache alone.  ``warm_check``: each warm request's
    first-token logits (the engine's own, from its final prefill piece)
    bitwise equal to :func:`replay_staged`'s and within ``WARM_FACTOR``
    times the bf16 model's own distance from f32 of the same prompt
    prefilled whole on a fresh cache.  Emits wall, prefill/decode tok/s, the engine's chunk and
    prefix counts and a 4-tick decode profile; returns (launches, tokens,
    launches by tensor-core route, the emitted line)."""
    import torch

    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    eng = Engine(cfg, model, EngineConfig(quant=quant, max_batch=8,
                                          max_seq=1024, **knobs),
                 device=dev)
    finite, watched = watch_logits(eng)
    firsts = []
    if warm_check:
        # the first-token logits of each staged admission's final piece
        # (the only prefill calls given last_pos in these runs), in
        # admission order
        base_prefill = model.prefill

        def prefill(tokens, caches, *, last_pos=None, cache_index=0):
            logits, caches = base_prefill(tokens, caches, last_pos=last_pos,
                                          cache_index=cache_index)
            if last_pos is not None:
                firsts.append(logits[:, 0].float().clone())
            return logits, caches
        model.prefill = prefill
    reqs, rid = [], 0
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    start = eng.metrics.snapshot()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    for batch in batches:
        served = [Request(rid=rid + i, prompt=p, max_new=32)
                  for i, p in enumerate(batch)]
        rid += len(batch)
        reqs += served
        eng.serve(served)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    for m in watched:
        del m.logits
    if warm_check:
        del model.prefill
    stats = eng.metrics.since(start).summary(eng.max_batch)
    layers = cfg.num_layers
    want = dict.fromkeys(wrappers, 0)
    want[kern] = stats["ticks"] * layers * PROJECTIONS[cfg.family]
    if cfg.family == "ssm":
        want["ssd_scan"] = stats["prefill_calls"] * layers
    check(all(r.done and len(r.out) == 32 for r in reqs),
          f"phase 9 {label}: not every request finished")
    check(finite and bool(torch.stack(finite).all()),
          f"phase 9 {label}: non-finite logits")
    check(counts == want,
          f"phase 9 {label}: launches {counts}, want {want}")
    check(tc[kern] == counts[kern],
          f"phase 9 {label}: {tc[kern]} of {counts[kern]} {kern} launches "
          "on the tensor-core kernel")
    out = {"substrate": label, "model": cfg.name, "quant": quant,
           "knobs": knobs, "layers": layers,
           "batches": [[len(p) for p in b] for b in batches],
           "max_new": 32, "launches": counts, "launches_tc": tc,
           "wall_s": wall, **{k: stats[k] for k in (
               "prefill_tok_s", "decode_tok_s", "prefill_s", "decode_s",
               "prefill_calls", "prefill_chunks", "ticks", "prefix_hits",
               "prefix_tokens_reused", "cache_evictions")}}
    if eng.paged:
        pool = eng.backend.num_blocks - 1
        owners = {} if eng.prefix_cache is None else \
            eng.prefix_cache._block_owners
        check(eng.allocator.free_blocks + len(owners) == pool
              and all(eng.allocator.refcount(b) == n
                      for b, n in owners.items()),
              f"phase 9 {label}: {eng.allocator.free_blocks} free + "
              f"{len(owners)} cached blocks of {pool}")
        out["pool"] = {"blocks": pool, "free": eng.allocator.free_blocks,
                       "cached": len(owners)}
    if warm_check:
        check(len(firsts) == len(reqs),
              f"phase 9 {label}: {len(firsts)} final prefill pieces for "
              f"{len(reqs)} requests")
        rows = []
        exact = f32_copy(model)
        with torch.inference_mode():
            for req, warm in zip(reqs[1:], firsts[1:]):
                check(int(warm.argmax()) == req.out[0],
                      f"phase 9 {label}: rid {req.rid}'s recorded logits "
                      "are not the ones it sampled from")
                warm = warm[0]
                replay = replay_staged(eng, model, reqs[0].prompt,
                                       req.prompt)
                toks = torch.as_tensor([req.prompt], device=dev)
                cold, _ = model.prefill(toks, model.init_cache(1, 1024))
                ref, _ = exact.prefill(toks, exact.init_cache(1, 1024))
                cold, ref = cold[0, 0].float(), ref[0, 0]
                scale = cold.abs().max()
                rows.append({
                    "replay_bitwise": bool(torch.equal(warm, replay)),
                    "warm_vs_cold": ((warm - cold).abs().max()
                                     / scale).item(),
                    "cold_vs_f32": ((cold - ref).abs().max()
                                    / scale).item(),
                    "argmax_equal": int(cold.argmax()) == req.out[0]})
        del exact
        out["warm"] = {"factor": WARM_FACTOR, "per_request": rows,
                       "max_warm_vs_cold": max(r["warm_vs_cold"]
                                               for r in rows)}
        for r, req in zip(rows, reqs[1:]):
            check(r["replay_bitwise"],
                  f"phase 9 {label}: rid {req.rid}'s warm logits differ "
                  "from a replay of its pieces on a fresh cache")
            check(r["warm_vs_cold"] <= WARM_FACTOR * r["cold_vs_f32"],
                  f"phase 9 {label}: rid {req.rid}'s warm logits "
                  f"{r['warm_vs_cold']} of the scale from cold, above "
                  f"{WARM_FACTOR} x the cold ones' {r['cold_vs_f32']} "
                  "from f32")
    prof = profile_decode(eng, batches[-1])   # after the counts are read
    out.update({f"profile_{k}": v for k, v in prof.items()})
    emit(out)
    tokens = [r.out for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, tokens, tc, out


def f32_copy(model):
    """``model`` over f32 copies of its weights (norm weights, already
    f32, shared)."""
    from dataclasses import replace

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        return node.float()
    cfg = replace(model.cfg, dtype="float32")
    return type(model).from_params(cfg, cast(model.params_tree()),
                                   device=model.device)


def replay_staged(eng, model, prefix: list, prompt: list):
    """The first-token logits (V,) of ``prompt`` computed as the engine's
    warm admission computed them, but from a fresh cache with no prefix
    cache between: ``prefix`` fed in the pieces its own cold staged
    admission ran (``eng.prefill_chunk`` tokens each, the last padded to
    its bucket with ``last_pos``), then ``prompt``'s tail in the warm
    admission's pieces (cut at the state-capture boundary where the
    substrate carries state).  Same calls and shapes, so the engine's
    logits equal these bitwise unless its shared blocks or snapshot
    differ from what that prefix computed."""
    import torch
    dev = eng.device
    chunk = eng.prefill_chunk
    caches = model.init_cache(1, eng.backend.stage_len)

    def pieces(tokens, consumed, cap):
        nonlocal caches
        while True:
            remaining = len(tokens) - consumed
            c = chunk
            if cap is not None and consumed < cap:
                c = min(c, cap - consumed)
            if remaining > c:
                _, caches = model.prefill(
                    torch.as_tensor([tokens[consumed:consumed + c]],
                                    device=dev), caches,
                    cache_index=consumed)
                consumed += c
                continue
            pl = min(eng._bucket_len(remaining),
                     eng.backend.stage_len - consumed)
            toks = torch.zeros((1, pl), dtype=torch.long, device=dev)
            toks[0, :remaining] = torch.as_tensor(tokens[consumed:])
            logits, caches = model.prefill(
                toks, caches, cache_index=consumed,
                last_pos=torch.as_tensor([remaining - 1], device=dev))
            return logits[0, 0].float()

    pieces(prefix, 0, None)
    cap = None
    if eng.backend.needs_state:
        c = eng._capture_boundary(len(prompt))
        cap = c if len(prefix) < c < len(prompt) else None
    return pieces(prompt, len(prefix), cap)


def substrate_phase(dev, cfg, model, prompts, dense_lut4
                    ) -> tuple[dict, dict]:
    """Phase 9a (after phase 6, on its model): yi-9b under lut4 on the
    paged pool (block 16) serves phase 6's requests, tokens bitwise equal
    to phase 6a's dense lut4 run; then with ``prefix_cache`` and
    ``prefill_chunk=128`` the shared-prefix mix (the prefix alone, then 7
    warm requests together): 7 hits reusing 7 x 384 tokens."""
    launches, tc = {}, {}
    counts, outs, route, _ = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc",
        dict(paged=True, block_size=16), [prompts], "yi-9b paged")
    check(outs == dense_lut4,
          "phase 9a: paged lut4 tokens differ from phase 6a's dense run")
    add_launches(launches, counts)
    add_launches(tc, route)
    mix = shared_prefix_mix(cfg.vocab_size)
    counts, _, route, out = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc",
        dict(paged=True, block_size=16, prefix_cache=True,
             prefill_chunk=128), [mix[:1], mix[1:]],
        "yi-9b paged prefix chunked", warm_check=True)
    check(out["prefix_hits"] == 7
          and out["prefix_tokens_reused"] == 7 * SHARED_PREFIX,
          f"phase 9a: {out['prefix_hits']} hits reusing "
          f"{out['prefix_tokens_reused']} tokens, want 7 and "
          f"{7 * SHARED_PREFIX}")
    add_launches(launches, counts)
    add_launches(tc, route)
    return launches, tc


def ssm_substrate_phase(dev, cfg, model) -> tuple[dict, dict]:
    """Phase 9b (after phase 7, on its model): mamba2-1.3b under nf4p with
    ``prefill_chunk=64`` and ``prefix_cache`` serves the shared-prefix mix
    in phase 9a's order: 7 hits on the 384-token snapshot; every prefill
    piece (a carried, non-zero initial state for all but the first, a
    masked last piece) on ``ssd_scan``."""
    mix = shared_prefix_mix(cfg.vocab_size)
    counts, _, route, out = substrate_run(
        dev, cfg, model, "nf4p", "lut_gemm_dc_res",
        dict(prefill_chunk=64, prefix_cache=True), [mix[:1], mix[1:]],
        "mamba2 prefix chunked", warm_check=True)
    check(out["prefix_hits"] == 7
          and out["prefix_tokens_reused"] == 7 * SHARED_PREFIX,
          f"phase 9b: {out['prefix_hits']} hits reusing "
          f"{out['prefix_tokens_reused']} tokens, want 7 and "
          f"{7 * SHARED_PREFIX}")
    return counts, route


#: phase 10's token rule (bf16 models at full width).  A speculative run
#: computes the same greedy function as the plain run in another order:
#: the verify window scores 5 columns in one (40-row) GEMM where the plain
#: tick scores one, and its cache was written by earlier windows.  Two
#: such orders move argmax at near-ties (phase 9's warm-vs-cold runs show
#: it for chunked against whole prefill).  So a request's
#: tokens must equal the plain run's, or, at their FIRST divergence (token
#: t) only, the plain run's top-two logit margin at t must be at most
#: WINDOW_FACTOR times the distance between the two orders' logits on the
#: same token state: the spec run's logits at the window's column 0 (step
#: t0 <= t, the latest step either run scored one token at a time or as
#: column 0) against the plain run's decode logits at t0.  Two roundings
#: of one function, each about as far from exact as the other: by the
#: triangle inequality about twice that distance apart at most (as
#: WARM_FACTOR).  Anything else fails.
WINDOW_FACTOR = 2.0


def record_logits(eng) -> tuple[dict, object]:
    """Record, under (rid, step), the logits row each active request is
    scored by when a token is chosen one at a time (``decode_step``) or as
    a verify window's column 0 (``decode_window``), on the instance of
    ``eng.decode_params``; the first record of a step stays.  Draft steps
    (self_lut's, which may run on the same model) are not recorded.
    Returns (the records, a function that removes the hooks)."""
    rec = {}
    m = eng.decode_params
    drafting = [False]

    def keep(logits):
        if drafting[0]:
            return
        for s, req in enumerate(eng.slots):
            if req is not None and req.rid in eng.active:
                rec.setdefault((req.rid, len(req.out)),
                               logits[s, 0].float().clone())

    step, window = m.decode_step, m.decode_window

    def decode_step(*a, **kw):
        logits, caches = step(*a, **kw)
        keep(logits)
        return logits, caches

    def decode_window(*a, **kw):
        logits, caches = window(*a, **kw)
        keep(logits)
        return logits, caches

    m.decode_step, m.decode_window = decode_step, decode_window
    spec = eng._spec
    if spec is not None:
        propose = spec.propose

        def drafted(*a, **kw):
            drafting[0] = True
            try:
                return propose(*a, **kw)
            finally:
                drafting[0] = False
        spec.propose = drafted

    def unhook():
        del m.decode_step, m.decode_window
        if spec is not None:
            del spec.propose
    return rec, unhook


def margin(logits) -> float:
    top = logits.topk(2).values
    return (top[0] - top[1]).item()


def window_rule(rid: int, got: list, plain: list, rec: dict,
                plain_rec: dict, dist_at=None) -> dict:
    """The WINDOW_FACTOR rule for one request: equal tokens, or at the
    first divergence t the plain run's top-two margin at t within
    WINDOW_FACTOR times the distance of the two runs' logits at t0 (the
    latest step <= t that ``rec`` holds; ``dist_at``: (t0, the logits row)
    to use instead, for a re-prefill).  Returns the verdict's numbers."""
    n = min(len(got), len(plain))
    t = next((i for i in range(n) if got[i] != plain[i]), None)
    if t is None:
        return {"rid": rid, "equal": len(got) == len(plain)}
    if dist_at is None:
        t0 = max((k for r, k in rec if r == rid and k <= t), default=None)
        if t0 is None or (rid, t0) not in plain_rec:
            return {"rid": rid, "equal": False, "first_divergence": t,
                    "passed": False, "why": "no logits recorded at or "
                                            "before the divergence"}
        row = rec[(rid, t0)]
    else:
        t0, row = dist_at
    dist = (row - plain_rec[(rid, t0)]).abs().max().item()
    m = margin(plain_rec[(rid, t)]) if (rid, t) in plain_rec else math.inf
    return {"rid": rid, "equal": False, "first_divergence": t, "t0": t0,
            "plain_margin": m, "logit_distance": dist,
            "passed": m <= WINDOW_FACTOR * dist}


#: the verify kernel of each engine-level quant mode (the plain tick's too)
DC_KERNEL = {"lut4": "lut_gemm_dc", "nf4p": "lut_gemm_dc_res"}


def spec_run(dev, cfg, model, prompts, quant: str, mode: str, plain: list,
             plain_extra: dict, label: str) -> tuple[dict, dict]:
    """One phase-10 run: the engine under ``EngineConfig(quant, spec=mode,
    spec_k=4, max_batch=8, max_seq=1024)`` serves the request mix (32 new
    tokens each), every kernel counter set to 0 just before and read just
    after.  Checks: every request finished, every logit finite,
    ``spec_accepted + spec_rejected == spec_drafted``; each kernel's
    launches equal the run's: the verify windows (M = 40, past
    ``TC_MAX_M``: the f32-FMA kernel), mamba2's commit passes (the same)
    and the plain ticks (M = 8, the tensor-core kernel) on
    ``DC_KERNEL[quant]``, self_lut's draft steps
    (M = 8) on ``lut_gemm_dc_res``'s tensor-core kernel, mamba2's
    ``ssd_scan`` once per layer of each verify, commit and prefill call;
    tokens against ``plain`` by the WINDOW_FACTOR rule.  Reports
    acceptance per window, tokens per tick, decode tok/s against the plain
    run's and a profile of 4 ticks.  Returns (launches, by route)."""
    import torch

    from repro_torch.kernels.lut_gemm.lut_gemm import takes_tc
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    t_build = time.perf_counter()
    eng = Engine(cfg, model, EngineConfig(quant=quant, spec=mode, spec_k=4,
                                          max_batch=8, max_seq=1024),
                 device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    finite, watched = watch_logits(eng)
    rec, unhook = record_logits(eng)
    calls = Counter()
    for name in ("_draft", "_spec_commit"):
        base = getattr(eng, name)

        def counted(*a, _base=base, _name=name, **kw):
            calls[_name] += 1
            return _base(*a, **kw)
        setattr(eng, name, counted)
    reqs = [Request(rid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    for m in watched:
        del m.logits
    unhook()
    for name in ("_draft", "_spec_commit"):
        delattr(eng, name)
    layers, proj = cfg.num_layers, PROJECTIONS[cfg.family]
    m = eng.metrics.snapshot()             # before the profile's ticks
    verify_ticks, plain_ticks = m.spec_ticks, m.ticks - m.spec_ticks
    kern = DC_KERNEL[quant]
    want = dict.fromkeys(wrappers, 0)
    want_tc = dict.fromkeys(("lut_gemm_dc", "lut_gemm_dc_res"), 0)
    k, n = (LAYER_SHAPES if cfg.family == "dense" else MAMBA2_SHAPES)[0]
    verify_tc = takes_tc(eng.max_batch * 5, k, n, torch.bfloat16, True)
    want[kern] += (verify_ticks + calls["_spec_commit"]
                   + plain_ticks) * layers * proj
    want_tc[kern] += (plain_ticks + verify_tc * verify_ticks) * layers * proj
    want["lut_gemm_dc_res"] += calls["_draft"] * layers * proj
    want_tc["lut_gemm_dc_res"] += calls["_draft"] * layers * proj
    if cfg.family == "ssm":
        want["ssd_scan"] = (verify_ticks + calls["_spec_commit"]
                            + stats["prefill_calls"]) * layers
    check(stats["done"] and all(len(r.out) == 32 for r in reqs),
          f"phase 10 {label}: not every request finished")
    check(finite and bool(torch.stack(finite).all()),
          f"phase 10 {label}: non-finite logits")
    check(m.spec_accepted + m.spec_rejected == m.spec_drafted,
          f"phase 10 {label}: accepted {m.spec_accepted} + rejected "
          f"{m.spec_rejected} != drafted {m.spec_drafted}")
    check(counts == want, f"phase 10 {label}: launches {counts}, want {want}")
    got_tc = {name: tc[name] for name in want_tc}
    check(got_tc == want_tc, f"phase 10 {label}: tensor-core launches "
          f"{got_tc}, want {want_tc}")
    rules = [window_rule(r.rid, r.out, plain[r.rid], rec,
                         plain_extra["logits"]) for r in reqs]
    check(all(v.get("equal") or v.get("passed") for v in rules),
          f"phase 10 {label}: tokens fail the WINDOW_FACTOR rule: {rules}")
    window = eng.registry.dump()["engine_spec_accepted_per_window"]
    t_prof = time.perf_counter()
    prof = profile_decode(eng, prompts)    # after the counts are read
    prof["s"] = time.perf_counter() - t_prof
    out = {"phase10": label, "model": cfg.name, "quant": quant,
           "spec": mode, "spec_k": 4, "layers": layers, "wall_s": wall,
           "engine_build_s": build_s,
           "ticks": m.ticks, "spec_ticks": verify_ticks,
           "plain_ticks": plain_ticks, "draft_steps": calls["_draft"],
           "commit_passes": calls["_spec_commit"],
           "spec_drafted": m.spec_drafted, "spec_accepted": m.spec_accepted,
           "spec_rejected": m.spec_rejected,
           "acceptance": stats["spec_acceptance"],
           "accepted_per_window": window["series"],
           "tokens_per_tick": (m.decode_tokens / m.ticks if m.ticks
                               else 0.0),
           "decode_tok_s": stats["decode_tok_s"],
           "plain_decode_tok_s": plain_extra["decode_tok_s"],
           "launches": counts, "launches_tc": tc, "verify_m": 40,
           "verify_route": "tc" if verify_tc else "fma",
           "window_factor": WINDOW_FACTOR, "tokens": rules,
           "tokens_equal_plain": sum(bool(v.get("equal")) for v in rules),
           **{f"profile_{k}": v for k, v in prof.items()}}
    emit(out)
    del eng, reqs, rec
    gc.collect()
    torch.cuda.empty_cache()
    return counts, tc


def spec_phase(dev, cfg, model, prompts) -> tuple[dict, dict]:
    """Phase 10a (after phase 9a, on phase 6's model cut to its first
    ``MODEL_LEVEL_LAYERS`` layers, as phase 6b is, to keep the script near
    half its time limit): the plain lut4 run on that depth (logits
    recorded, no profile), then self_lut and ngram held to it."""
    from dataclasses import replace

    cut = replace(cfg, num_layers=min(MODEL_LEVEL_LAYERS, cfg.num_layers))
    tree = model.params_tree()
    cut_model = type(model).from_params(
        cut, {**tree, "blocks": tree["blocks"][:cut.num_layers]}, device=dev)
    launches, plain, tc, extra = serve_once(
        dev, cut, cut_model, prompts, "lut4", "lut_gemm_dc", record=True,
        profile=False)
    for mode in ("self_lut", "ngram"):
        counts, route = spec_run(dev, cut, cut_model, prompts, "lut4", mode,
                                 plain, extra, f"10a yi-9b {mode}")
        add_launches(launches, counts)
        add_launches(tc, route)
    return launches, tc


def ssm_spec_phase(dev, cfg, model, prompts, plain, plain_extra
                   ) -> tuple[dict, dict]:
    """Phase 10b (after phase 9b, on phase 7's model): mamba2-1.3b nf4p
    under self_lut (drafts and verify on the same nf4p model), held to
    phase 7's nf4p run."""
    return spec_run(dev, cfg, model, prompts, "nf4p", "self_lut", plain,
                    plain_extra, "10b mamba2 self_lut")


#: phase 10c, by index in the request mix: the request cancelled during
#: its chunked admission (438 tokens: 4 pieces of 128), the one preempted
#: once it has LOOP_PREEMPT_AT tokens (53 tokens: re-admitted unchunked),
#: and the one whose ``on_token`` callback does both (24 tokens: decoding
#: while the others admit).  The callback runs inside the tick, under the
#: engine lock, so neither act races the loop.
LOOP_CANCEL, LOOP_PREEMPT, LOOP_ACTOR, LOOP_PREEMPT_AT = 0, 6, 7, 4


def loop_phase(dev, cfg, model, prompts, plain) -> tuple[dict, dict]:
    """Phase 10c (after 10a, on phase 6's model): yi-9b lut4 on the paged
    pool with ``prefill_chunk=128`` and ``trace=True``, served through
    ``start()``: 8 client threads each ``submit`` one request and consume
    its ``tokens()``; LOOP_ACTOR's callback cancels LOOP_CANCEL during its
    chunked admission and preempts LOOP_PREEMPT after LOOP_PREEMPT_AT
    tokens (requeued, re-admitted by a re-prefill); then
    ``stop(drain=True)``.
    The reference is a synchronous ``serve()`` of the same mix on the same
    config (its prefill pieces and buckets are the loop's: each request's
    tokens depend on its own admission only).  Checks: the consumers
    joined (within 600 s) while the loop ran; every stream equals its
    request's ``out``; the untouched requests' tokens equal the
    reference's bitwise, and those admitted unchunked equal phase 6a's
    (== 9a's paged) run too; the preempted request's first tokens equal
    the reference's and the rest obey the WINDOW_FACTOR rule (the
    distance: its re-prefill's logits against the reference's decode
    logits at the preemption step); ``lut_gemm_dc`` launched 7 x 48 a
    tick, all on the tensor-core kernel, and nothing else; every pool
    block free after the run; the Perfetto JSON parses and every rid has
    its submit, first-token (where it emitted one) and finish events; the
    registry's counters equal ``EngineMetrics``; the TTFT histogram's
    count equals the requests that emitted a token."""
    import threading

    import torch

    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import _ENGINE_COUNTERS, Engine, Request

    conf = EngineConfig(quant="lut4", max_batch=8, max_seq=1024, paged=True,
                        block_size=16, prefill_chunk=128, trace=True)
    ref = Engine(cfg, model, conf, device=dev)
    ref_rec, unhook = record_logits(ref)
    ref_reqs = [Request(rid=i, prompt=list(p), max_new=32)
                for i, p in enumerate(prompts)]
    check(ref.serve(ref_reqs)["done"], "phase 10c: reference not done")
    unhook()
    del ref
    gc.collect()

    eng = Engine(cfg, model, conf, device=dev)
    finite, watched = watch_logits(eng)
    reqs = [Request(rid=i, prompt=list(p), max_new=32)
            for i, p in enumerate(prompts)]
    victim, kicked = reqs[LOOP_CANCEL], reqs[LOOP_PREEMPT]
    preempted = {}
    base_prefill = model.prefill

    def prefill(tokens, caches, **kw):
        logits, caches = base_prefill(tokens, caches, **kw)
        ext = preempted.get("prompt")
        if ext is not None and "logits" not in preempted \
                and tokens.shape[0] == 1 and tokens.shape[1] >= len(ext) \
                and tokens[0, :len(ext)].tolist() == ext:
            preempted["logits"] = logits[0, 0].float().clone()
        return logits, caches
    model.prefill = prefill
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    streams = [None] * len(reqs)

    def act(tok):
        """``reqs[LOOP_ACTOR]``'s callback: cancel the victim while it is
        staged mid-prompt, preempt ``kicked`` once it has decoded."""
        if not victim.done and any(cp.req is victim and cp.consumed > 0
                                   for cp in eng._chunked):
            check(eng.cancel(victim), "phase 10c: cancel refused")
        if "at" not in preempted and kicked.rid in eng.active \
                and len(kicked.out) >= LOOP_PREEMPT_AT:
            preempted["at"] = len(kicked.out)
            check(eng.preempt(kicked), "phase 10c: preempt refused")
            preempted["prompt"] = list(kicked.prompt)
    eng.start()

    def client(i):
        handle = eng.submit(reqs[i],
                            on_token=act if i == LOOP_ACTOR else None)
        streams[i] = list(handle.tokens())

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(all(not t.is_alive() for t in threads),
          "phase 10c: a tokens() consumer hung")
    check(eng.running, "phase 10c: the serve loop died before stop()")
    check(eng.stop(drain=True, timeout=300), "phase 10c: stop() timed out")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    del model.prefill
    for m in watched:
        del m.logits
    m = eng.metrics
    layers = cfg.num_layers
    want = dict.fromkeys(wrappers, 0)
    want["lut_gemm_dc"] = m.ticks * layers * PROJECTIONS["dense"]
    check(counts == want, f"phase 10c: launches {counts}, want {want}")
    check(tc["lut_gemm_dc"] == counts["lut_gemm_dc"],
          f"phase 10c: {tc['lut_gemm_dc']} of {counts['lut_gemm_dc']} "
          "lut_gemm_dc launches on the tensor-core kernel")
    check(finite and bool(torch.stack(finite).all()),
          "phase 10c: non-finite logits")
    check(all(s == r.out for s, r in zip(streams, reqs)),
          "phase 10c: a stream differs from its request's out")
    check(victim.cancelled and victim.out == [] and m.cancelled == 1,
          "phase 10c: the cancel missed the victim's chunked admission")
    check("prompt" in preempted, "phase 10c: the preempt never fired")
    check(m.preemptions == 1 and kicked.done and len(kicked.out) == 32,
          "phase 10c: the preempted request did not finish")
    untouched = [i for i in range(len(reqs))
                 if i not in (LOOP_CANCEL, LOOP_PREEMPT)]
    check(all(reqs[i].out == ref_reqs[i].out for i in untouched),
          "phase 10c: untouched tokens differ from the synchronous run")
    unchunked = [i for i in untouched
                 if len(prompts[i]) <= conf.prefill_chunk]
    check(all(reqs[i].out == plain[i] for i in unchunked),
          "phase 10c: unchunked requests' tokens differ from phase 6a's")
    at = preempted["at"]
    check(kicked.out[:at] == ref_reqs[LOOP_PREEMPT].out[:at],
          "phase 10c: the preempted request's first tokens differ")
    rule = window_rule(kicked.rid, kicked.out, ref_reqs[LOOP_PREEMPT].out,
                       {}, ref_rec, dist_at=(at, preempted["logits"]))
    check(rule.get("equal") or rule.get("passed"),
          f"phase 10c: the preempted request fails the rule: {rule}")
    pool = eng.backend.num_blocks - 1
    check(eng.allocator.free_blocks == pool,
          f"phase 10c: {eng.allocator.free_blocks} of {pool} blocks free")
    doc = json.loads(eng.tracer.perfetto())
    from repro_torch.obs.trace import request_events
    per_req = request_events(eng.tracer.events())
    for r in reqs:
        names = [e.name for e in per_req.get(r.rid, [])]
        need = {"submit", "finish"} | ({"first_token"} if r.out else set())
        check(need <= set(names) and names.count("submit") == 1
              and names.count("finish") == 1,
              f"phase 10c: rid {r.rid}'s trace events {names}")
    dump = eng.registry.dump()
    snap = m.snapshot()
    check(all(dump[name]["series"].get("", 0) == getattr(snap, f)
              for f, (name, _) in _ENGINE_COUNTERS.items()),
          "phase 10c: registry counters differ from EngineMetrics")
    ttft = sum(v["count"] for v in dump["engine_ttft_seconds"]["series"]
               .values())
    check(ttft == sum(1 for r in reqs if r.out),
          f"phase 10c: TTFT count {ttft}")
    emit({"phase10": "10c yi-9b loop", "model": cfg.name, "quant": "lut4",
          "knobs": {"paged": True, "block_size": 16, "prefill_chunk": 128,
                    "trace": True}, "layers": layers, "wall_s": wall,
          "ticks": m.ticks, "prefill_chunks": m.prefill_chunks,
          "cancelled_rid": victim.rid, "preempted_rid": kicked.rid,
          "preempted_at": at, "preempted_rule": rule,
          "untouched_equal_sync": len(untouched),
          "unchunked_equal_6a": len(unchunked),
          "trace_events": len(eng.tracer.events()),
          "trace_dropped": eng.tracer.dropped,
          "perfetto_bytes": len(json.dumps(doc)), "ttft_count": ttft,
          "decode_tok_s": snap.summary(8)["decode_tok_s"],
          "launches": counts, "launches_tc": tc})
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, tc


#: phase 4's speculative engines: (family, label, EngineConfig knobs)
SMALL_SPEC = [("dense", "dense", {}),
              ("dense", "paged", dict(paged=True, block_size=8)),
              ("ssm", "state", {})]


def small_spec_phase(dev):
    """Phase 4, speculation: reduced f32 yi-9b (dense slab and paged pool)
    and mamba2 (seed 1 weights, the same on both devices) serve 3 prompts
    (8 new tokens each) under ``spec`` ngram and self_lut with quant None,
    lut4 and nf4p: greedy tokens on the card equal the CPU's, and both
    equal the plain greedy engine's on the CPU."""
    import numpy as np
    import torch

    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    out = {}
    for arch in ("yi-9b", "mamba2-1.3b"):
        cfg = get_config(arch).reduced(dtype="float32", attn_impl="full")
        cpu = get_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1))
        gpu = type(cpu).from_params(cfg, tree_to(cpu.params_tree(), dev),
                                    device=dev)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (5, 11, 3)]

        def serve(model, device, **knobs):
            eng = Engine(cfg, model, EngineConfig(max_batch=3, max_seq=48,
                                                  **knobs), device=device)
            reqs = [Request(rid=i, prompt=list(p), max_new=8)
                    for i, p in enumerate(prompts)]
            check(eng.serve(reqs)["done"],
                  f"phase 4 spec {arch} {knobs}: not done")
            return [r.out for r in reqs], eng.metrics.snapshot()

        for family, label, knobs in SMALL_SPEC:
            if family != cfg.family:
                continue
            for quant in (None, "lut4", "nf4p"):
                plain, _ = serve(cpu, "cpu", quant=quant, **knobs)
                for mode in ("ngram", "self_lut"):
                    kw = dict(quant=quant, spec=mode, **knobs)
                    on_cpu, _ = serve(cpu, "cpu", **kw)
                    on_card, m = serve(gpu, dev, **kw)
                    what = f"phase 4 spec {arch} {label} {quant} {mode}"
                    check(on_cpu == plain,
                          f"{what}: CPU tokens differ from plain greedy")
                    check(on_card == on_cpu,
                          f"{what}: card tokens differ from the CPU's")
                    out[f"{arch} {label} {quant or 'f32'} {mode}"] = {
                        k: getattr(m, k) for k in (
                            "spec_ticks", "spec_drafted", "spec_accepted")}
    emit({"small_spec": "reduced f32 yi-9b (dense, paged) and mamba2, "
                        "spec ngram/self_lut x quant None/lut4/nf4p: "
                        "greedy tokens card == cpu == plain greedy",
          "runs": out})


def profile_train_step(step_fn, model, opt_state, batch) -> tuple:
    """One train step under torch.profiler: (its metrics, device time by
    kernel and the idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    device_ms = sum(r[1] for r in rows)

    def share(*keys):
        return sum(r[1] for r in rows if any(k in r[0].lower() for k in keys))

    return metrics, {
        "wall_ms": wall_ms,
        "device_ms": device_ms if rows else "not measured",
        "device_idle_share": (1 - device_ms / wall_ms) if rows
        else "not measured",
        "gemm_ms": share("gemm", "cutlass", "sm90_xmma", "nvjet")
        if rows else "not measured",
        "luna_mm_ms": share("luna_mm") if rows else "not measured",
        "kernels": len(rows),
        "launches": sum(r[2] for r in rows),
        "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                for k, ms, n in rows[:14]]}


#: phase 8: yi-9b at its published widths, depth cut 48 -> 8 (the f32
#: moments of 48 layers alone are ~33 GB beside ~16 GB of bf16 weights
#: and grads, ~105 GB in all); TRAIN_4K's sequence length with its
#: 256-sequence batch cut to 2
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2, 4096, 6
QAT_S, QAT_STEPS = 1024, 2
#: |flash eval loss - chunked eval loss| on the same params, set from
#: readings: 1.25e-4 sound, 7.7e-2 with the output zeroed
FLASH_LOSS_TOL = 1e-3


def train_phase(dev) -> tuple[dict, int, int]:
    """Phase 8: the trainer's step (``make_train_step``) at yi-9b's full
    width, returns launches by kernel, the flash eval's launches of the
    tensor-core flash kernel and luna_mm's of its tensor-core kernel.  6 steps under chunked attention
    (no kernel of the port runs: the counts must stay 0), bf16, remat on,
    AdamW + cosine; 2 QAT steps under luna_approx (every projection
    through the STE on luna_mm: 7 x layers x 2 launches a step, forward
    and remat recompute); then ``flash_eval`` on the trained params."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step

    cfg = replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS,
                  attn_impl="chunked")
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0)).requires_grad_(True)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(2, TRAIN_STEPS + QAT_STEPS))
    state = opt.init(model.params_tree())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit({"train_model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params_b": n_params / 1e9, "remat": cfg.remat,
          "init_s": time.perf_counter() - t0})
    watch = {"embed": model.embed, "wq0": model.blocks[0].attn.wq,
             "w_down_last": model.blocks[-1].mlp.w_down}
    before = {k: v.detach()[:8, :8].float().clone() for k, v in watch.items()}
    wrappers = kernel_wrappers()
    launches = {}
    luna = wrappers["luna_mm"]
    luna_tc = []

    def run(what, n, step_fn, m, data, want, want_tc=0, profile_last=False):
        """n steps with every count set to 0 just before, read after;
        ``want_tc`` of luna_mm's launches on its tensor-core kernel."""
        batches = [data.batch(i, dev) for i in range(n)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in wrappers.values():
            f.launches = 0
        luna.launches_tc = 0
        steps, prof = [], None
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            if profile_last and i == n - 1:
                metrics, prof = profile_train_step(step_fn, m, state, batch)
            else:
                metrics = step_fn(m, state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
            check(math.isfinite(loss) and math.isfinite(gn),
                  f"{what} step {i}: loss {loss}, grad_norm {gn}")
            tokens = batch["tokens"].numel()
            steps.append({"step": int(state.step), "wall_s": wall,
                          "tok_s": tokens / wall, "loss": loss,
                          "grad_norm": gn, "profiled": prof is not None
                          and i == n - 1})
        counts = {name: f.launches for name, f in wrappers.items()}
        luna_tc.append(luna.launches_tc)
        check(counts == want, f"{what}: launches {counts}, want {want}")
        check(luna_tc[-1] == want_tc, f"{what}: {luna_tc[-1]} luna_mm "
              f"launches on the tensor-core kernel, want {want_tc}")
        add_launches(launches, counts)
        steady = [r["wall_s"] for r in steps[1:] if not r["profiled"]]
        emit({"train": what, "batch": list(batches[0]["tokens"].shape),
              "steps": steps, "launches": counts,
              "luna_mm_launches_tc": luna_tc[-1],
              "steady_step_s": min(steady) if steady else None,
              "steady_tok_s": (batches[0]["tokens"].numel() / min(steady)
                               if steady else None),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              **({"profile": prof} if prof else {})})

    zero = dict.fromkeys(wrappers, 0)
    run("bf16, chunked attention", TRAIN_STEPS, make_train_step(cfg, opt),
        model, SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0), zero,
        profile_last=True)
    qcfg = replace(cfg, quant=QuantConfig(mode="luna_approx"))
    qmodel = type(model).from_params(qcfg, model.params_tree(),
                                     device=dev).requires_grad_(True)
    qat = QAT_STEPS * PROJECTIONS["dense"] * cfg.num_layers * 2
    run("QAT luna_approx (STE on luna_mm)", QAT_STEPS,
        make_train_step(qcfg, opt), qmodel,
        SyntheticLM(cfg.vocab_size, QAT_S, TRAIN_B, seed=0),
        zero | {"luna_mm": qat}, want_tc=qat, profile_last=True)
    del qmodel
    changed = {k: not torch.equal(before[k], v.detach()[:8, :8].float())
               for k, v in watch.items()}
    check(all(changed.values()), f"params did not change: {changed}")

    launches_eval, launches_tc = flash_eval(dev, cfg, model, wrappers)
    add_launches(launches, launches_eval)
    emit({"train_params_changed": changed})
    del model, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, launches_tc, sum(luna_tc)


def flash_controls(kernel) -> dict:
    """Wrong attention put in the flash kernel's place, to show what
    ``flash_eval``'s check can tell: the output zeroed, and the kernel's
    output with its last 64 query rows recomputed without the last 64 keys
    (a fault only late rows see)."""
    import torch

    def zeros(q, k, v, **kw):
        return torch.zeros_like(q)

    def drop_last_kv_tile(q, k, v, *, sm_scale, causal, num_q_heads,
                          num_kv_heads):
        out = kernel(q, k, v, sm_scale=sm_scale, causal=causal,
                     num_q_heads=num_q_heads, num_kv_heads=num_kv_heads)
        t = q.shape[1] - 64
        g = num_q_heads // num_kv_heads
        kk = k[:, :t].repeat_interleave(g, 0).float()
        vv = v[:, :t].repeat_interleave(g, 0).float()
        p = torch.softmax(q[:, t:].float() @ kk.transpose(1, 2) * sm_scale,
                          dim=-1)
        out[:, t:] = (p @ vv).to(out.dtype)
        return out

    return {"zeros": zeros, "last KV tile dropped": drop_last_kv_tile}


def flash_eval(dev, cfg, model, wrappers) -> dict:
    """The eval loss of a held-out batch under attn_impl="flash" (one
    flash launch per layer per call, counted) against the chunked loss of
    the same params (FLASH_LOSS_TOL); then every attention call of the
    same eval (loss and forward, each layer) on its own inputs against the
    kernel's plain version on them (``flash_attention.reference``: bf16 at
    D = 128 takes the tensor-core kernel, held to ``attention_ref_tiled``),
    at its stated tolerance.  Each of ``flash_controls`` in the kernel's
    place must fail one of the two.  Returns the flash run's launches and
    its tensor-core launches."""
    from dataclasses import replace

    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops

    held = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=1).batch(0, dev)
    fmodel = type(model).from_params(replace(cfg, attn_impl="flash"),
                                     model.params_tree(), device=dev)

    def evaluate(m):
        with torch.no_grad():
            loss, _ = m.loss(held)
            hidden, _ = m.forward(held["tokens"])
        return float(loss), hidden.float()

    runs, evals = {}, {}
    for name, m in (("chunked", model), ("flash", fmodel)):
        evaluate(m)                                    # warm-up
        torch.cuda.synchronize()
        for f in wrappers.values():
            f.launches = 0
        fk.flash_attention.launches_tc = 0
        t0 = time.perf_counter()
        runs[name] = evaluate(m)
        torch.cuda.synchronize()
        evals[name] = {"loss": runs[name][0],
                       "wall_s": time.perf_counter() - t0,
                       "launches": {k: f.launches
                                    for k, f in wrappers.items()},
                       "launches_tc": fk.flash_attention.launches_tc}
    zero = dict.fromkeys(wrappers, 0)
    want = zero | {"flash_attention": 2 * cfg.num_layers}
    check(evals["flash"]["launches"] == want,
          f"flash eval launches {evals['flash']['launches']}, want {want}")
    check(evals["chunked"]["launches"] == zero,
          f"chunked eval launched {evals['chunked']['launches']}")
    check(evals["flash"]["launches_tc"] == 2 * cfg.num_layers,
          f"flash eval: {evals['flash']['launches_tc']} launches of the "
          f"tensor-core kernel, want every one")

    def held_to_plain(fn, shares):
        """``fn`` in the kernel's place; each call's worst |out - plain| as
        a share of the kernel's stated tolerance into ``shares`` (above 1
        fails it)."""
        def call(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            plain, bound = fk.reference(q, k, v, **kw)
            shares.append(fk.tolerance_share(out, plain, bound))
            return out
        return call

    kernel = fops.flash_attention
    controls = flash_controls(kernel)
    loss_c, h_c = runs.pop("chunked")
    readings = {}
    for name, fn in {"flash": kernel, **controls}.items():
        shares = []
        fops.flash_attention = held_to_plain(fn, shares)
        try:
            loss, h = evaluate(fmodel)
        finally:
            fops.flash_attention = kernel
        readings[name] = {
            "loss": loss, "loss_vs_chunked": abs(loss - loss_c),
            "calls": len(shares), "worst_call_tol_share": max(shares),
            "hidden_vs_chunked": ((h - h_c).abs().max()
                                  / h_c.abs().max()).item()}
    check(readings["flash"]["loss"] == evals["flash"]["loss"],
          "the flash eval's loss differs between two runs")
    emit({"train_eval": "held-out batch (seed 1), no grad; each attention "
                        "call against its plain version on its inputs, as a "
                        "share of the kernel's tolerance; hidden errors as "
                        "a share of max |chunked hidden|", "evals": evals,
          "readings": readings, "loss_tol": FLASH_LOSS_TOL})

    def passes(r):
        return (math.isfinite(r["loss"])
                and r["loss_vs_chunked"] <= FLASH_LOSS_TOL
                and r["worst_call_tol_share"] <= 1.0)
    check(passes(readings["flash"]), f"flash eval: {readings['flash']}")
    for name in controls:
        check(not passes(readings[name]),
              f"control {name!r} in the kernel's place passes the eval "
              f"check: {readings[name]}")
    del fmodel
    return evals["flash"]["launches"], evals["flash"]["launches_tc"]


def trainer_phase(dev) -> None:
    """Phase 8b: the Trainer on luna-mlp (bf16, its config as is) on the
    card: 12 steps with checkpoints every 5 into a temporary directory,
    then a rerun to 20 resumes from step 12 and trains 8 more."""
    import contextlib
    import io
    import tempfile

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("luna-mlp")
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as ckpt:
        for total in (12, 20):
            tcfg = TrainerConfig(total_steps=total, ckpt_every=5,
                                 log_every=5, ckpt_dir=ckpt, lr=3e-3,
                                 warmup=2)
            trainer = Trainer(cfg, tcfg, device=dev)
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                _, hist = trainer.run(SyntheticLM(cfg.vocab_size, 32, 8,
                                                  seed=0))
            out[total] = {"steps": len(hist), "loss": hist,
                          "wall_s": time.perf_counter() - t0,
                          "checkpoints": trainer.ckpt.steps(),
                          "resumed": "resumed from step 12" in log.getvalue()}
    check(out[12]["steps"] == 12 and not out[12]["resumed"]
          and out[12]["checkpoints"] == [5, 10, 12],
          f"first trainer run: {out[12]}")
    check(out[20]["steps"] == 8 and out[20]["resumed"]
          and out[20]["checkpoints"] == [12, 15, 20],
          f"resumed trainer run: {out[20]}")
    check(all(math.isfinite(x) for r in out.values() for x in r["loss"]),
          "non-finite trainer loss")
    emit({"trainer": cfg.name, "dtype": cfg.dtype, "runs": out})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="depth of the full-width yi-9b in phases 6, 9a, "
                         "10a and 10c (it has 48); mamba2-1.3b always runs "
                         "all 48 of its layers")
    bench = ap.add_mutually_exclusive_group()
    bench.add_argument("--ssd-bench", metavar="ROOT",
                       help="only time ROOT's ssd_scan (ssd_bench)")
    bench.add_argument("--ssd-against", metavar="DIR",
                       help="only time DIR's ssd_scan and this checkout's "
                            "in turns (ssd_against)")
    args = ap.parse_args()
    if args.ssd_bench or args.ssd_against:
        print(json.dumps(ssd_bench(args.ssd_bench) if args.ssd_bench
                         else ssd_against(args.ssd_against)))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    emit({"nvidia_smi": smi.stdout.strip().splitlines()[0]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas, by_lib = [], {}
    for name, lib in libs.items():
        log = lib.with_suffix(".so.log")
        if log.exists():
            lines = [ln.strip() for ln in log.read_text().splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Performance Loss" in ln]
            ptxas += lines
            by_lib[name] = lines
    # SASS instructions a code of the D&C kernels' streaming loops (M <= 8
    # instantiations, bf16 x: the main path's)
    loops = {"lut_gemm.cu": sass_loops(libs["lut_gemm"], (
                 "lut_gemm_dc_split_kernel", "ILi8E", "Lb1E", "bfloat16")),
             "lut_gemm_tc.cu": sass_loops(libs["lut_gemm_tc"],
                                          ("lut_gemm_tc_kernelILi1ELb0E",)),
             "lut_gemm_tc.cu full": sass_loops(
                 libs["lut_gemm_tc"], ("lut_gemm_tc_kernelILi1ELb1E",))}
    for lps in loops.values():
        for lp in lps:
            if isinstance(lp, str):
                continue
            codes = 4 * lp["ldg_32"] + 16 * lp["ldg_128"]
            lp["per_code"] = lp["instructions"] / codes if codes else None
    # the prefill kernel's loops over a stage (its 128-row tile): a consumer
    # looks up 32 codes a stage (2 columns x 16 k rows); its wgmma per stage
    # say the piece count (8 a piece: 4 steps x 2 chains)
    loops["lut_gemm_wgmma.cu"] = sass_loops(
        libs["lut_gemm_wgmma"], ("lut_gemm_wgmma_kernelILi128E",),
        stream="HGMMA")
    for lp in loops["lut_gemm_wgmma.cu"]:
        if not isinstance(lp, str):
            lp["per_code"] = lp["instructions"] / 32
    emit({"sass_loops": loops})
    emit({"build_s": build_s, "libs": [p.name for p in libs.values()],
          "ptxas_max_registers": max(
              (int(ln.split("Used ")[1].split()[0]) for ln in ptxas
               if "Used " in ln), default=None),
          "ptxas_spills": sorted({
              ln for ln in ptxas if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln}),
          "ptxas_lut_gemm": {n: by_lib.get(n) for n in (
              "lut_gemm_tc", "lut_gemm_wgmma")},
          "ptxas_ssd_scan_tc": by_lib.get("ssd_scan_tc")})

    kernels = kernel_phase(dev)
    kernels.update(luna_kernel_phase(dev))
    kernels.update(lut_full_kernel_phase(dev))
    kernels.update(ssd_kernel_phase(dev))
    kernels.update(flash_kernel_phase(dev))
    small_reference_phase(dev)
    small_ssm_reference_phase(dev)
    small_substrate_phase(dev)
    small_spec_phase(dev)
    small_training_phase(dev)
    quant_matmul_phase(dev)
    cfg, model, prompts = build_model(dev, args.layers)
    launches, tc, outs = main_path_phase(dev, cfg, model, prompts)
    for total, part in zip((launches, tc), substrate_phase(
            dev, cfg, model, prompts, outs["lut4"])):
        add_launches(total, part)
    phase10_s = {}
    t10 = time.perf_counter()
    for run in (spec_phase(dev, cfg, model, prompts),
                loop_phase(dev, cfg, model, prompts, outs["lut4"])):
        for total, part in zip((launches, tc), run):
            add_launches(total, part)
    phase10_s["10a+10c"] = time.perf_counter() - t10
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, prompts = build_ssm_model(dev)
    *ssm_run, ssm_plain, ssm_extra = ssm_main_path_phase(dev, cfg, model,
                                                         prompts)
    for run in (ssm_run, ssm_substrate_phase(dev, cfg, model)):
        for total, part in zip((launches, tc), run):
            add_launches(total, part)
    t10 = time.perf_counter()
    for total, part in zip((launches, tc), ssm_spec_phase(
            dev, cfg, model, prompts, ssm_plain, ssm_extra)):
        add_launches(total, part)
    phase10_s["10b"] = time.perf_counter() - t10
    emit({"phase10_s": sum(phase10_s.values()), "parts": phase10_s})
    del model, ssm_extra
    gc.collect()
    torch.cuda.empty_cache()
    launches_train, flash_tc, luna_tc_train = train_phase(dev)
    add_launches(launches, launches_train)
    trainer_phase(dev)
    emit({"script_s": time.perf_counter() - T0})
    check(set(launches) == set(kernels),
          f"kernels launched on the main path {sorted(launches)} are not "
          f"the kernels checked {sorted(kernels)}")
    for name, n in launches.items():
        kernels[name]["launches"] = n
    kernels["flash_attention"]["launches_tc"] = flash_tc
    kernels["luna_mm"]["launches_tc"] = tc.get("luna_mm", 0) + luna_tc_train
    for name in ("lut_gemm_dc", "lut_gemm_dc_res", "lut_gemm"):
        kernels[name]["launches_tc"] = tc.get(name, 0)
    kernels["lut_gemm"]["launches_wgmma"] = tc.get("lut_gemm_wgmma", 0)
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
