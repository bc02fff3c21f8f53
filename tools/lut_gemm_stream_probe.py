#!/usr/bin/env python3
"""How fast one access pattern of ``lut_gemm_tc.cu`` streams on the card.

    python3 tools/lut_gemm_stream_probe.py

The tensor-core D&C kernel reads, per warp and 16-row K step, 16 bytes of
codes from each of four rows per thread (a 128-column strip of the (K, N)
codes).  This probe streams the same chunks of yi-9b's decode shapes two
ways and prints the rate of each (device-only: a CUDA graph of calls,
codes cold in L2):

* ``cp.async``: into a per-warp ring of private shared-memory slots
  (``cp.async.cg`` 16 bytes, zero-fill form and plain), 2, 4 or 8 stages;
* ``registers``: 16-byte non-caching loads into a two- or three-step
  register ring.

Nothing is computed on the bytes but an xor, so the rate is the access
pattern's alone.  The CUDA source is inline, built with nvcc for sm_90a
into ``build/``; a card is needed.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void cpa(uint32_t dst, const void* src, int bytes,
                                    bool zf) {
  if (zf)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(dst), "l"(src) : "memory");
}
template <int N> __device__ __forceinline__ void cpw() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint4 ldg(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
// lane (g, t) of a warp takes rows 4t .. 4t+3 of each 16-row step, 16 bytes
// at column 16 g of the warp's 128-column strip
template <int S, bool ZF, bool REGS>
__global__ void __launch_bounds__(256) ring(const uint8_t* p, int K, int N,
                                            int spw, uint32_t* out) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = blockIdx.x * 8 + warp;
  const int strips = N / 128, strip = wg % strips, kc = wg / strips;
  const int ksteps = (K + 15) / 16;
  const int s0 = min(ksteps, kc * spw), ns = min(ksteps, s0 + spw) - s0;
  const int col = strip * 128 + 16 * g;
  uint32_t acc = 0;
  if (!REGS) {
    uint8_t* ringp = sm + warp * S * 2048;
    auto issue = [&](int s, int st) {
      const uint32_t base =
          (uint32_t)__cvta_generic_to_shared(ringp + st * 2048);
#pragma unroll
      for (int kr = 0; kr < 4; ++kr) {
        const int row = s * 16 + 4 * t + kr;
        const bool ok = row < K;
        cpa(base + kr * 512 + lane * 16, ok ? p + (size_t)row * N + col : p,
            ok ? 16 : 0, ZF);
      }
    };
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < ns) issue(s0 + i, i);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int i = 0; i < ns; ++i) {
      if (i + S - 1 < ns) issue(s0 + i + S - 1, (i + S - 1) % S);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      cpw<S - 1>();
      const uint8_t* st = ringp + (i % S) * 2048;
#pragma unroll
      for (int kr = 0; kr < 4; ++kr) {
        const uint4 v = *(const uint4*)(st + kr * 512 + lane * 16);
        acc ^= v.x ^ v.y ^ v.z ^ v.w;
      }
    }
    cpw<0>();
  } else {
    uint4 buf[S][4];
    auto load = [&](int s, uint4 (&b)[4]) {
#pragma unroll
      for (int kr = 0; kr < 4; ++kr) {
        const int row = (s0 + s) * 16 + 4 * t + kr;
        b[kr] = (s < ns && row < K) ? ldg(p + (size_t)row * N + col)
                                    : make_uint4(0, 0, 0, 0);
      }
    };
#pragma unroll
    for (int i = 0; i < S; ++i) load(i, buf[i]);
    for (int i = 0; i < ns; i += S) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
#pragma unroll
        for (int kr = 0; kr < 4; ++kr)
          acc ^= buf[j][kr].x ^ buf[j][kr].y ^ buf[j][kr].z ^ buf[j][kr].w;
        load(i + j + S, buf[j]);
      }
    }
  }
  if (acc == 0x12345678u) out[0] = acc;
}
template <int S, bool ZF, bool REGS>
int go(const void* p, int K, int N, int spw, void* out, void* st) {
  const int warps = (N / 128) * (((K + 15) / 16 + spw - 1) / spw);
  const int smem = REGS ? 0 : 8 * S * 2048;
  cudaFuncSetAttribute(ring<S, ZF, REGS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ring<S, ZF, REGS><<<(warps + 7) / 8, 256, smem, (cudaStream_t)st>>>(
      (const uint8_t*)p, K, N, spw, (uint32_t*)out);
  return (int)cudaGetLastError();
}
extern "C" int probe(int v, const void* p, int K, int N, int spw, void* out,
                     void* st) {
  switch (v) {
    case 0: return go<2, true, false>(p, K, N, spw, out, st);
    case 1: return go<4, true, false>(p, K, N, spw, out, st);
    case 2: return go<4, false, false>(p, K, N, spw, out, st);
    case 3: return go<8, true, false>(p, K, N, spw, out, st);
    case 4: return go<2, true, true>(p, K, N, spw, out, st);
    case 5: return go<3, true, true>(p, K, N, spw, out, st);
  }
  return -1;
}
"""
VARIANTS = ["cp.async, 2 stages", "cp.async, 4 stages",
            "cp.async, 4 stages, no zero-fill", "cp.async, 8 stages",
            "registers, 2 steps", "registers, 3 steps"]
#: (K, N): yi-9b's decode projections but wk/wv
SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lut_gemm_stream_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import graph_ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}))
    out_dir = os.path.join(ROOT, "build", "lut_gemm_stream_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, f) for f in ("probe.cu",
                                                        "probe.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o",
                    lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe.argtypes = [i, p, i, i, i, p, p]
    dev = torch.device("cuda", 0)
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    for k, n in SHAPES:
        copies = [torch.randint(0, 16, (k, n), dtype=torch.int8, device=dev)
                  for _ in range(max(1, (256 << 20) // (k * n)))]
        # ~16 warps an SM of an H100's 132, as the kernel runs at M = 8
        spw = max(1, -(-(k // 16) // max(1, 2112 // (n // 128))))
        for v, name in enumerate(VARIANTS):
            def call(j, v=v):
                err = lib.probe(v, copies[j % len(copies)].data_ptr(), k, n,
                                spw, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"probe launch failed: {err}")
            us = graph_ms(call, max(20, len(copies))) * 1e3
            print(json.dumps({"k": k, "n": n, "variant": name, "us": us,
                              "tb_s": k * n / us / 1e6}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
