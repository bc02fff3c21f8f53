#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py             # the whole check, 48 layers
    python3 chip_smoke.py --layers 8  # the same with the depth cut

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA -> fail;
2. build every CUDA source of the port with nvcc for sm_90a (seconds);
3. each LUT GEMM kernel against its plain PyTorch version on the card at
   every yi-9b decode projection shape, M in {1, 8}, bf16 x, at the
   tolerance stated in ``kernels/lut_gemm/lut_gemm.py``; the dequantized
   weight (x = I) bitwise; a ragged shape; times by CUDA events;
4. a reduced f32 yi-9b: quantization on the card equals the CPU's
   bitwise, and decode logits through the kernels agree with the CPU's
   plain path;
5. the main path: the engine serves 8 requests (prompts 16-512, 32 new
   tokens) at yi-9b's full width in bf16 under quant="lut4", then
   "nf4p", asserting every request finished, every logit is finite and
   the kernel launch counters grew by exactly ticks x layers x 7; then
   (after the counts are read) a torch.profiler window over 4 decode
   ticks of the lut4 engine: device time by kernel and the idle share.

Every line but the last is one JSON object; the ``{"kernels": [...]}``
line comes just before the last, which is ``{"ok": true, "device": ...}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
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
#: (K, N) of yi-9b's decode projections, in layer order wq wk wv wo
#: w_gate w_up w_down
LAYER_SHAPES = [(4096, 4096), (4096, 512), (4096, 512), (4096, 4096),
                (4096, 11008), (4096, 11008), (11008, 4096)]
COLD_BYTES = 256 << 20       # rotate code copies past the 50 MB L2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def bound_ms(m: int, k: int, n: int, x_bytes: int, table_bytes: int
             ) -> tuple[float, str]:
    """Least time for one call: each input read once (x, codes, tables,
    zp, scale), the f32 output written once, vs 2MKN flops at the bf16
    tensor-core peak."""
    nbytes = m * k * x_bytes + k * n + table_bytes + 2 * n * 4 + m * n * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2 * m * k * n / BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev):
    """Phase 3: both kernels against their plain versions on the card."""
    from dataclasses import replace

    import torch

    from repro_torch.core.quant import NF4P_PRUNE_THRESHOLD, quantize_weight
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref

    gen = torch.Generator(device=dev).manual_seed(0)
    specs = {
        "lut_gemm_dc": dict(
            fn=lambda x, q: lg.lut_gemm_dc(x, q.codes, q.hi_tab, q.lo_tab,
                                           q.zero_point, q.scale),
            plain=lambda x, q: ref.lut_gemm_dc_ref(
                x, q.codes, q.hi_tab, q.lo_tab, q.zero_point, q.scale),
            quant=("lut_dc", None), table_bytes=32,
            replaces="src/repro/kernels/lut_gemm/lut_gemm.py:214"),
        "lut_gemm_dc_res": dict(
            fn=lambda x, q: lg.lut_gemm_dc_res(
                x, q.codes, q.hi_tab, q.lo_tab, q.residual, q.zero_point,
                q.scale),
            plain=lambda x, q: ref.lut_gemm_dc_res_ref(
                x, q.codes, q.hi_tab, q.lo_tab, q.residual, q.zero_point,
                q.scale),
            quant=("nf4_dc", NF4P_PRUNE_THRESHOLD), table_bytes=96,
            replaces="src/repro/kernels/lut_gemm/lut_gemm.py:168"),
    }
    results = {}
    for name, sp in specs.items():
        def qweight(k, n):
            w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
            return quantize_weight(w, *sp["quant"])

        # exact: x = I reads the dequantized weight back, bitwise
        q = qweight(256, 4096)
        eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
        want = ref.dc_dequant(q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                              q.residual) * q.scale[None, :]
        check(torch.equal(sp["fn"](eye, q), want),
              f"{name}: x = I output is not bitwise the dequantized weight")
        # ragged M, K, N (the unvectorised, masked path)
        q = qweight(72, 40)
        x = torch.randn((3, 72), generator=gen, device=dev)
        torch.testing.assert_close(sp["fn"](x, q), sp["plain"](x, q),
                                   rtol=lg.KERNEL_RTOL, atol=lg.KERNEL_ATOL)

        per_shape, max_err = [], 0.0
        for k, n in sorted(set(LAYER_SHAPES)):
            q = qweight(k, n)
            copies = [q] + [replace(q, codes=q.codes.clone()) for _ in
                            range(max(1, COLD_BYTES // (k * n)) - 1)]
            for m in (1, 8):
                x = torch.randn((m, k), generator=gen, device=dev,
                                dtype=torch.bfloat16)
                out, plain = sp["fn"](x, q), sp["plain"](x, q)
                torch.testing.assert_close(out, plain, rtol=lg.KERNEL_RTOL,
                                           atol=lg.KERNEL_ATOL)
                max_err = max(max_err, (out - plain).abs().max().item())
                ms = cuda_ms(lambda i: sp["fn"](x, copies[i % len(copies)]),
                             100)
                plain_ms = cuda_ms(
                    lambda i: sp["plain"](x, copies[i % len(copies)]), 10)
                b_ms, b_by = bound_ms(m, k, n, 2, sp["table_bytes"])
                per_shape.append({"m": m, "k": k, "n": n, "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": b_ms,
                                  "bound_by": b_by})
            del copies
        emit({"kernel_check": name, "passed": True, "max_abs_err": max_err,
              "rtol": lg.KERNEL_RTOL, "atol": lg.KERNEL_ATOL,
              "per_shape": per_shape})

        # one decoder layer's 7 projections at the main path's M = 8
        at = {(s["k"], s["n"]): s for s in per_shape if s["m"] == 8}
        layer = [at[kn] for kn in LAYER_SHAPES]
        results[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/lut_gemm/csrc/lut_gemm.cu",
            "replaces": sp["replaces"], "launches": None,
            "max_abs_err": max_err,
            "ms": sum(s["ms"] for s in layer),
            "plain_ms": sum(s["plain_ms"] for s in layer),
            "bound_ms": sum(s["bound_ms"] for s in layer),
            "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                       for s in layer) else "operations",
            "library_ms": None,
            "timed_as": "one yi-9b layer's 7 decode projections, M=8, "
                        "bf16 x, codes cold in L2",
            "per_shape": per_shape}
        gc.collect()
        torch.cuda.empty_cache()
    return results


def small_reference_phase(dev):
    """Phase 4: reduced f32 yi-9b, card against CPU."""
    import torch

    from repro_torch.core.quant import quantize_decode_params
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.transformer import TransformerLM

    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    cpu = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))

    def tree_to(node, device):
        if isinstance(node, dict):
            return {k: tree_to(v, device) for k, v in node.items()}
        if isinstance(node, list):
            return [tree_to(v, device) for v in node]
        return node.to(device)

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
    emit({"small_reference": "reduced yi-9b f32, decode logits card vs cpu",
          "max_abs_err": out, "rtol": 1e-4, "atol": 1e-4})


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
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an ATen op's row repeats its kernels' time
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    lut_ms = sum(r[1] for r in rows
                 if "lut_gemm" in r[0] or "splitk_reduce" in r[0])
    return {"profile": "decode ticks", "ticks": ticks, "wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "lut_kernels_ms": lut_ms if rows else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if rows
            else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:12]]}


def main_path_phase(dev, layers: int):
    """Phase 5: the engine at yi-9b's full width, lut4 then nf4p."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.kernels.lut_gemm.lut_gemm import (lut_gemm_dc,
                                                       lut_gemm_dc_res)
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    cfg = replace(get_config("yi-9b"), num_layers=layers)
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": layers, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "init_s": time.perf_counter() - t0})
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 513, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in lens]

    launches, first_tokens = {}, {}
    for quant, kern, other in (("lut4", lut_gemm_dc, lut_gemm_dc_res),
                               ("nf4p", lut_gemm_dc_res, lut_gemm_dc)):
        t0 = time.perf_counter()
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

        for m in {id(eng.params): eng.params,
                  id(eng.decode_params): eng.decode_params}.values():
            watch(m)
        reqs = [Request(rid=i, prompt=p, max_new=32)
                for i, p in enumerate(prompts)]
        lut_gemm_dc.launches = 0
        lut_gemm_dc_res.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_kern, n_other = kern.launches, other.launches
        del model.logits
        ticks = eng.metrics.ticks
        check(stats["done"] and all(len(r.out) == 32 for r in reqs),
              f"{quant}: not every request finished")
        check(finite and bool(torch.stack(finite).all()),
              f"{quant}: non-finite logits")
        check(n_kern == ticks * layers * 7 and n_other == 0,
              f"{quant}: {kern.__name__} launched {n_kern} times, want "
              f"{ticks} ticks x {layers} layers x 7 (other kernel "
              f"{n_other})")
        launches[kern.__name__] = n_kern
        first_tokens[quant] = [r.out[0] for r in reqs]
        if quant == "lut4":   # after the counts are read: not the main run
            emit(profile_decode(eng, prompts))
        emit({"main_path": quant, "requests": len(reqs),
              "prompt_lens": [int(n) for n in lens], "max_new": 32,
              "layers": layers, "decode_ticks": ticks,
              "launches": {kern.__name__: n_kern},
              "prefill_tok_s": stats["prefill_tok_s"],
              "decode_tok_s": stats["decode_tok_s"],
              "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
              "wall_s": wall, "quantize_s": quant_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
    # prefill runs the same full-precision model in both runs
    check(first_tokens["lut4"] == first_tokens["nf4p"],
          "first (prefill) tokens differ between the lut4 and nf4p runs")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="depth of the full-width model (yi-9b has 48)")
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
    ptxas = []
    for lib in libs.values():
        log = lib.with_suffix(".so.log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"build_s": build_s, "libs": [p.name for p in libs.values()],
          "ptxas_max_registers": max(
              (int(ln.split("Used ")[1].split()[0]) for ln in ptxas
               if "Used " in ln), default=None),
          "ptxas_spills": sorted({
              ln for ln in ptxas if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln})})

    kernels = kernel_phase(dev)
    small_reference_phase(dev)
    launches = main_path_phase(dev, args.layers)
    for name, n in launches.items():
        kernels[name]["launches"] = n
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
