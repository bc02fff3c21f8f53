// Flash attention forward for Hopper's tensor cores (sm_90a), bf16: the
// online-softmax attention of the cacheless full-sequence forward, with
// both products on wgmma and K/V fed by TMA.
//
// Replaces, for bf16 operands at D in {64, 128}, the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:70 flash_attention
// (body _flash_kernel, :24), which the SIMT kernel of flash_attention.cu
// ported first; that kernel keeps f32 operands and bf16 at D in {16, 32}.
// q (B*H, S, D), k/v (B*Hkv, S, D), contiguous bf16; o (B*H, S, D) bf16.
// Head h of batch b reads kv row b*Hkv + h / (H/Hkv): GQA never repeats
// K/V.  As in the TPU kernel: s = q . k in f32 (the exact bf16 products,
// summed by the tensor core), the causal mask at JAX's -1e30 (scaled), a
// running max m, denominator l and accumulator in f32, corrected by
// exp(m_prev - m_new) once per KV tile; o = acc / max(l, 1e-30), stored
// to nearest bf16.  Unlike it, the softmax numerator p is rounded to bf16
// (to nearest) to be the A operand of the P V product, as SDPA's and
// FlashAttention's kernels do; l is summed from the f32 p.  The plain
// version of that arithmetic is ref.attention_ref_tiled (block_k = BK).
//
// What bounds it: operations.  Causal attention at yi-9b's heads (B = 2,
// S = 4096, H = 32, D = 128) needs 4 B H S^2 D / 2 = 275 GFLOP, 0.278 ms
// at the bf16 tensor cores' 989 TFLOP/s, against 45 MB of q, k, v and o
// (0.013 ms at 3.35 TB/s).  The SIMT kernel ran it at 25 TFLOP/s of f32
// FMAs.  The design:
//   * one block of three warpgroups per (128-query tile, b*h), heaviest
//     causal tiles first (blockIdx.y walks the query tiles from the last);
//     warpgroup 0 is the producer, warpgroups 1 and 2 each own 64 query
//     rows (setmaxnreg moves registers to them at run time, 24 / 240;
//     ptxas fits the whole kernel in the launch bound's 168 a thread
//     without spills, which this one-tile-at-a-time loop needs);
//   * one producer thread loads the Q tile once and K and V tiles of 128
//     rows into a ring of STAGES shared-memory stages with TMA (3-D tensor
//     maps (D, S, heads), so a tile past S reads zeros, never the next
//     head's rows; 128-byte swizzle, 64-column panels), each stage's
//     arrival on a "full" mbarrier, its release by the 256 consumer
//     threads on an "empty" one: the next tiles load while this one is
//     computed;
//   * S = Q K^T: wgmma m64n128k16, Q and K from shared memory (K-major),
//     f32 accumulators, 64 registers a thread;
//   * softmax on the accumulator fragment: row max over the thread's
//     columns, then the quad's four lanes by shuffles; p = exp2(s * c -
//     m * c) with c = sm_scale * log2(e) folded into one FMA (ex2.approx);
//     masks only on the diagonal tile (causal) and the tile past S
//     (columns >= S at -inf: they add exactly 0); tiles above the
//     diagonal are never loaded;
//   * O += P V: the score fragment is the A operand's register layout, so
//     p goes to bf16 pairs in registers; V from shared memory as the
//     MN-major B operand (the transpose bit), wgmma m64nDk16, 64 f32
//     accumulator registers a thread at D = 128;
//   * the tensor map encoder is taken from the driver through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
// Rows past S are computed from zeros and not stored.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;               // query rows per block
constexpr int BK = 128;               // key rows per KV tile
constexpr int STAGES = 2;             // K/V ring depth
constexpr int THREADS = 384;          // producer + two consumer warpgroups
constexpr int PANEL = 64;             // bf16 columns per 128-byte row
constexpr int ROW_BYTES = 128;        // one swizzled row of a panel
constexpr float MASK = -1e30f;        // JAX's causal mask (scaled score)
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == BK, "causal tile count assumes square tiles");

template <int D>
struct Smem {                         // byte offsets from a 1024-aligned base
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // the Q barrier, then full[STAGES], then empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase `parity` has completed.  A lost arrival
// traps (the launch fails) after ~2^26 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (c0 innermost) into shared memory at dst,
// completing on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B.  K-major (Q, K): 8-row groups 1024 bytes apart (stride),
// the leading offset unused.  MN-major (V): 8-row groups of K 1024 bytes
// apart (stride), 64-column panels `lead` bytes apart (leading).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) {=, +=} A (64 x 16, smem) * B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n64(d, a, b);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                float sm_scale, int causal) {
  using L = Smem<D>;
  constexpr int PANELS = D / PANEL;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the base to it
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + L::K_OFF, sv = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + STAGES);

  const int nq = (S + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.y);   // heaviest first
  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = iq * BQ;
  // causal: KV tile j is needed iff j * BK <= q0 + BQ - 1, i.e. j <= iq
  const int nk = causal ? iq + 1 : (S + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load(sq + p * BQ * ROW_BYTES, &tq, bar_q, p * PANEL, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::KV_BYTES);
        for (int p = 0; p < PANELS; ++p) {
          const uint32_t off = s * L::KV_BYTES + p * BK * ROW_BYTES;
          tma_load(sk + off, &tk, full, p * PANEL, j * BK, kvh);
          tma_load(sv + off, &tv, full, p * PANEL, j * BK, kvh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    const int rw = (wg - 1) * 64;            // this warpgroup's rows in Q
    const int row0 = q0 + rw + warp * 16 + lane / 4;   // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const float c = sm_scale * LOG2E;
    const float mask_raw = MASK / sm_scale;  // scales to JAX's -1e30

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      const int k0 = j * BK;
      mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
      __syncwarp();                          // wgmma wants converged warps

      // S = Q K^T over D in steps of 16 (32 bytes within a panel row)
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_panel = 32 * (kk % 4);
        const uint64_t a = sw128_desc(
            sq + (kk / 4) * BQ * ROW_BYTES + rw * ROW_BYTES + in_panel, 16);
        const uint64_t b = sw128_desc(
            sk + s * L::KV_BYTES + (kk / 4) * BK * ROW_BYTES + in_panel, 16);
        wgmma_ss_n128(sc, a, b, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // masks: the diagonal tile (causal) and the tile past S
      if ((causal && j == nk - 1) || k0 + BK > S) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + col0 + (i & 1);
          const int row = row0 + 8 * ((i / 2) & 1);
          if (causal && col > row) sc[i] = mask_raw;
          if (col >= S) sc[i] = -INFINITY;
        }
      }

      // running max over the thread's columns, then the quad's
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) & 1;
        mx[r] = fmaxf(mx[r], sc[i]);
      }
      float mc[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mc[r] = mx[r] * c;
        corr[r] = ex2(m[r] * c - mc[r]);     // 0 on the first tile
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];

      // p = exp2(s c - m c) in f32 into l; bf16 pairs as the A fragment
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * (2 * kk + h);
          const float p0 = ex2(fmaf(sc[i], c, -mc[0]));
          const float p1 = ex2(fmaf(sc[i + 1], c, -mc[0]));
          const float p2 = ex2(fmaf(sc[i + 2], c, -mc[1]));
          const float p3 = ex2(fmaf(sc[i + 3], c, -mc[1]));
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          pa[kk][2 * h] = pack_bf16(p0, p1);       // row0
          pa[kk][2 * h + 1] = pack_bf16(p2, p3);   // row0 + 8
        }
      }

      // O += P V over the tile's keys in steps of 16 (2048 bytes of V)
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<D>(acc, pa[kk],
                    sw128_desc(sv + s * L::KV_BYTES + kk * 16 * ROW_BYTES,
                               BK * ROW_BYTES));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* op = o + static_cast<size_t>(bh) * S * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          op + static_cast<size_t>(row) * D + col0);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        dst[4 * n] = pack_bf16(acc[4 * n + 2 * r] / l[r],
                               acc[4 * n + 2 * r + 1] / l[r]);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver at run time
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, S, D) bf16 as a 3-D map, boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzle; out-of-bounds rows read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int heads, int S, int D,
            int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) != 0)
    return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {PANEL, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int H, int Hkv, float sm_scale, int causal,
                   cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const int BHkv = BH / H * Hkv;
  if (!encode(&tq, q, BH, S, D, BQ) || !encode(&tk, k, BHkv, S, D, BK) ||
      !encode(&tv, v, BHkv, S, D, BK))
    return cudaErrorInvalidValue;
  constexpr int smem = Smem<D>::BYTES;
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, st>>>(tq, tk, tv,
                                    static_cast<__nv_bfloat16*>(o), S, H,
                                    Hkv, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_wgmma_block_k() { return BK; }

// q (BH, S, D), k/v (BH / H * Hkv, S, D), o (BH, S, D), contiguous bf16,
// D in {64, 128}.  Returns a cudaError_t (0 = launched).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, int BH, int S, int D, int H,
                                 int Hkv, float sm_scale, int causal,
                                 void* stream) {
  if (BH < 1 || S < 1 || H < 1 || Hkv < 1 || BH % H != 0 || H % Hkv != 0 ||
      (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, o, BH, S, H, Hkv, sm_scale, causal, st));
    case 128:
      return static_cast<int>(
          launch<128>(q, k, v, o, BH, S, H, Hkv, sm_scale, causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
