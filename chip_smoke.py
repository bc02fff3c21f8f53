#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py             # the whole check, 48 layers
    python3 chip_smoke.py --layers 8  # the same with yi-9b's depth cut

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA -> fail;
2. build every CUDA source of the port with nvcc for sm_90a, one nvcc per
   source, all started together (seconds); the SASS instructions a code of
   the LUT kernels' streaming loops (``cuobjdump -sass``), ptxas' registers
   and spills of the LUT tensor-core libraries;
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
      other M device-only (the route's edge);
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
   d. the SSD chunk scan (``ssd_scan``) at mamba2's widths (H = 64, P =
      64, N = 128, G = 1, chunk min(256, S)) for (B, S) in {(1, 48),
      (1, 272) with a carried initial state, (1, 448) masked at 438 (off
      the chunk grid), (8, 512)}, and a small G = 2 case, within the
      tolerance stated in ``kernels/ssd_scan/ssd_scan.py``;
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
   decode step under lut4 and nf4p), logits at 1e-4; yi-9b training:
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
   b. under the model-level modes luna_approx2, luna_dc (every projection
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
each run of 6 and 7 asserting every request finished, every logit is
finite and each kernel's launch counter (all set to 0 just before the
run, read just after) equals the launches the run made through it; then
(after the counts are read) a torch.profiler window over 4 decode ticks
(and for mamba2 one prefill call): device time by kernel and the idle
share.

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
                            "and w_out (4096 x 2048), M=8"})
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


#: phase 3d at mamba2-1.3b's widths: (B, S, valid length or None for no
#: mask, initial state: None, "zero" as the main path carries it into a
#: prefill, or "random"); the engine's buckets are B = 1
SSD_CASES = [(1, 48, None, None), (1, 272, None, "random"),
             (1, 448, 438, "zero"), (8, 512, None, None)]
SSD_WIDTHS = dict(h=64, p=64, g=1, n=128)


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


def ssd_bound_ms(b, s, h, p, g, n, chunk, masked, init) -> tuple[float, str]:
    """Least time of one scan: x, dt, a, B, C, the mask and the initial
    state (where one is passed, zero or not) read once, y and the final
    state written once, against :func:`ssd_flops` at f32's 67 TFLOP/s;
    the larger of the two."""
    nbytes = (4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                   + (1 + (init is not None)) * b * h * p * n)
              + masked * b * s)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ssd_flops(b, s, h, p, g, n, chunk, init == "random") \
        / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_kernel_phase(dev):
    """Phase 3d: ssd_scan against its plain version (``_ssd_chunked`` on
    the card, true f32) at mamba2's widths, each case's error within
    ``KERNEL_TOL`` of the output's scale."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(b, s, h, p, g, n, valid, init):
        args = (torch.randn((b, s, h, p), generator=gen, device=dev),
                0.01 + 0.19 * torch.rand((b, s, h), generator=gen,
                                         device=dev),
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

    def compare(args, kw, chunk):
        y, fs = sk.ssd_scan(*args, chunk=chunk, **kw)
        y0, fs0 = _ssd_chunked(*args, chunk, **kw)
        err = max(sk.scaled_err(y, y0), sk.scaled_err(fs, fs0))
        abs_err = max((y - y0).abs().max().item(),
                      (fs - fs0).abs().max().item())
        return err, abs_err

    # small: G = 2, ragged S, Q = 48, P off the 32-column tiles, masked
    args, kw = inputs(2, 77, 4, 40, 2, 16, 70, "random")
    err, _ = compare(args, kw, 48)
    check(err <= sk.KERNEL_TOL, f"ssd_scan G=2 small case: error {err}")
    per_shape, max_err, max_abs = [], err, 0.0
    w = SSD_WIDTHS
    for b, s, valid, init in SSD_CASES:
        chunk = min(256, s)
        args, kw = inputs(b, s, w["h"], w["p"], w["g"], w["n"], valid, init)
        err, abs_err = compare(args, kw, chunk)
        check(err <= sk.KERNEL_TOL,
              f"ssd_scan ({b}, {s}) valid={valid} init={init}: scaled "
              f"error {err} > {sk.KERNEL_TOL}")
        max_err, max_abs = max(max_err, err), max(max_abs, abs_err)
        ms = cuda_ms(lambda i: sk.ssd_scan(*args, chunk=chunk, **kw), 20)
        plain_ms = cuda_ms(lambda i: _ssd_chunked(*args, chunk, **kw), 5)
        b_ms, b_by = ssd_bound_ms(b, s, w["h"], w["p"], w["g"], w["n"],
                                  chunk, valid is not None, init)
        per_shape.append({"b": b, "s": s, "chunk": chunk, "valid": valid,
                          "initial_state": init, "scaled_err": err,
                          "max_abs_err": abs_err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by,
                          "gflop": ssd_flops(b, s, w["h"], w["p"], w["g"],
                                             w["n"], chunk,
                                             init == "random") / 1e9})
        del args, kw
    emit({"kernel_check": "ssd_scan", "passed": True,
          "max_scaled_err": max_err, "max_abs_err": max_abs,
          "tol": sk.KERNEL_TOL,
          "tol_rule": "max|kernel - plain| <= tol * max(1, max|plain|)",
          "per_shape": per_shape})
    head = next(r for r in per_shape if r["s"] == 448)
    gc.collect()
    torch.cuda.empty_cache()
    return {"ssd_scan": {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:81",
        "launches": None, "max_abs_err": max_abs, "max_scaled_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "timed_as": "one mamba2-1.3b layer's scan of the main path's "
                    "largest prefill call: B=1, S=448 (valid 438, masked), "
                    "the carried zero initial state read, H=64, P=64, "
                    "N=128, G=1, chunk 256, f32; no single PyTorch call "
                    "computes it",
        "per_shape": per_shape}}


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


def profile_decode(eng, prompts, ticks: int = 4) -> dict:
    """Device time by kernel over ``ticks`` steady decode ticks of a fresh
    batch (torch.profiler; admission and drain run outside the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    reqs = [Request(rid=100 + i, prompt=p, max_new=ticks + 4)
            for i, p in enumerate(prompts)]
    eng.serve(reqs, max_ticks=1)           # admit + first decode tick
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
    device_ms = sum(r[1] for r in rows)
    return {"profile": f"one prefill call, {len(prompt)} tokens",
            "wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "ssd_scan_ms": (sum(r[1] for r in rows if "ssd_" in r[0])
                            if rows else "not measured"),
            "device_idle_share": (1 - device_ms / wall_ms) if rows
            else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def serve_once(dev, cfg, model, prompts, quant: str | None,
               kern: str | None) -> tuple[dict, list, dict]:
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
    decode ticks after (and, for mamba2, one prefill call)."""
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
    finite = []

    def watch(m):
        base = m.logits

        def logits(hidden):
            out = base(hidden)
            finite.append(torch.isfinite(out).all())
            return out
        m.logits = logits

    watched = {id(eng.params): eng.params,
               id(eng.decode_params): eng.decode_params}.values()
    for m in watched:
        watch(m)
    reqs = [Request(rid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    wrappers = kernel_wrappers()
    with_tc = [wrappers[n] for n in TC_ROUTED]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in wrappers.values():
        f.launches = 0
    for f in with_tc:
        f.launches_tc = 0
    wrappers["lut_gemm"].launches_wgmma = 0
    t0 = time.perf_counter()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: f.launches for name, f in wrappers.items()}
    tc = {f.__name__: f.launches_tc for f in with_tc}
    tc["lut_gemm_wgmma"] = wrappers["lut_gemm"].launches_wgmma
    luna_tc = tc["luna_mm"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in watched:
        del m.logits
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
    prof = profile_decode(eng, prompts)    # after the counts are read
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
    return counts, out, tc


def add_launches(total: dict, counts: dict) -> None:
    """Sum a run's counts into ``total``, for the kernels it launched."""
    for name, n in counts.items():
        if n:
            total[name] = total.get(name, 0) + n


def main_path_phase(dev, cfg, model, prompts) -> tuple[dict, dict]:
    """Phase 6: the engine at yi-9b's full width; returns launches by
    kernel and by tensor-core route (``launches_tc``).  6a:
    engine-level lut4 / nf4p (decode projections on the D&C kernels,
    prefill full precision).  6b: model-level luna_approx2 / luna_dc
    (every projection on luna_mm) and lut_nf4 (on lut_gemm)."""
    launches, outs, tc_total = {}, {}, {}
    for quant, kern in (("lut4", "lut_gemm_dc"), ("nf4p", "lut_gemm_dc_res"),
                        ("luna_approx2", "luna_mm"), ("luna_dc", "luna_mm"),
                        ("lut_nf4", "lut_gemm")):
        counts, outs[quant], tc = serve_once(dev, cfg, model, prompts, quant,
                                             kern)
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    # prefill runs the same full-precision model under lut4 and nf4p
    check([o[0] for o in outs["lut4"]] == [o[0] for o in outs["nf4p"]],
          "first (prefill) tokens differ between the lut4 and nf4p runs")
    return launches, tc_total


def ssm_main_path_phase(dev, cfg, model, prompts) -> tuple[dict, dict]:
    """Phase 7: the engine at mamba2-1.3b's full width (48 layers, bf16);
    returns launches by kernel and by tensor-core route.  Prefill (full precision in every run) on
    ssd_scan, decode full precision, then w_in/w_out frozen to lut4 (on
    lut_gemm_dc) and nf4p (on lut_gemm_dc_res)."""
    launches, outs, tc_total = {}, {}, {}
    for quant, kern in ((None, None), ("lut4", "lut_gemm_dc"),
                        ("nf4p", "lut_gemm_dc_res")):
        counts, outs[quant], tc = serve_once(dev, cfg, model, prompts, quant,
                                             kern)
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    firsts = {q: [o[0] for o in out] for q, out in outs.items()}
    check(firsts[None] == firsts["lut4"] == firsts["nf4p"],
          f"mamba2 first (prefill) tokens differ between runs: {firsts}")
    return launches, tc_total


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
                    help="depth of the full-width yi-9b (it has 48); "
                         "mamba2-1.3b always runs all 48 of its layers")
    args = ap.parse_args()

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
              "lut_gemm_tc", "lut_gemm_wgmma")}})

    kernels = kernel_phase(dev)
    kernels.update(luna_kernel_phase(dev))
    kernels.update(lut_full_kernel_phase(dev))
    kernels.update(ssd_kernel_phase(dev))
    kernels.update(flash_kernel_phase(dev))
    small_reference_phase(dev)
    small_ssm_reference_phase(dev)
    small_training_phase(dev)
    quant_matmul_phase(dev)
    launches, tc = main_path_phase(dev, *build_model(dev, args.layers))
    ssm_launches, ssm_tc = ssm_main_path_phase(dev, *build_ssm_model(dev))
    add_launches(launches, ssm_launches)
    add_launches(tc, ssm_tc)
    gc.collect()
    torch.cuda.empty_cache()
    launches_train, flash_tc, luna_tc_train = train_phase(dev)
    add_launches(launches, launches_train)
    trainer_phase(dev)
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
