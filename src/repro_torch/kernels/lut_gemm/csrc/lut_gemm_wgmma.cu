// Prefill-size full-table LUT GEMM on Hopper's bf16 tensor cores (sm_90a):
// TMA-fed wgmma with the weight looked up into registers.
//
// Replaces, for the calls kernels/lut_gemm/lut_gemm.py:route() sends here
// (bf16 x, M >= WGMMA_MIN_M, K % 16 == 0, N % 16 == 0, 16-byte aligned
// bases), the Pallas TPU kernel
//   src/repro/kernels/lut_gemm/lut_gemm.py:78 lut_gemm
//   (body _lut_gemm_kernel, :59)      out = (x @ CB[q]) * scale
// which lut_gemm.cu ported first on f32 FMAs; decode sizes (M <= 32) run
// lut_gemm_tc.cu's full-table mode, and lut_gemm.cu keeps f32 x and the
// shapes TMA cannot take.
// x (M, K) bf16; codes (K, N) int8 in [0, 16), one per byte, row-major; cb
// (16,) f32; scale (N,) f32; out (M, N) f32.
//
// What bounds it: operations.  At prefill sizes a code feeds 2M flops: a
// yi-9b layer's 7 projections at M = 512 are 177 GFLOP of one bf16 product
// (0.179 ms at 989 TFLOP/s) against 173 MB of codes (0.052 ms at 3.35
// TB/s).  lut_gemm.cu ran them on f32 FMAs, re-reading every code once per
// 8 rows.  The design:
//   * the roles swapped: out^T = W^T x^T, with the weight (output columns)
//     as wgmma's 64-row A operand taken from registers and x as the
//     K-major B operand from shared memory (N = the batch rows of the
//     block's M tile, BM a multiple of 16 from 64 to 176: as few tiles
//     as cover M, since a tile's lookups and stream cost about the same
//     whatever its rows), so one lookup of a code feeds every row of the
//     tile;
//   * exact bf16 pieces of the codebook, as lut_gemm_tc.cu cuts them: p1 =
//     CB[q] truncated to bf16, p2 the same of CB[q] - p1, p3 = CB[q] - p1 -
//     p2.  They sum back to CB[q] exactly, every partial sum lies in
//     CB[q]'s binade and x is bf16, so every product is exact in f32; one
//     wgmma a non-zero piece (NF4: three) into one f32 accumulator, the
//     scale applied after the sum, as the Pallas kernel does (:74).  At x
//     = a row of I the accumulator holds CB[q] exactly and out reads
//     CB[q] * scale back bitwise;
//   * the lookup: lut_gemm_tc.cu's per-piece pair tables (256 bf16x2
//     entries {p[q_even], p[q_odd]}, 32 copies against bank conflicts, 32
//     KB a piece) built by the consumers at the start.  An A register
//     holds two k of one row, so its entry is indexed by q(k) + 16 q(k+1):
//     a thread's A rows g and g + 8 are taken as two neighbouring columns
//     (2g, 2g + 1 of its warp's 16), so the four k rows of its fragment
//     (2t, 2t+1, 2t+8, 2t+9) are four 2-byte shared loads a k-step, and
//     one shift-or makes two indices of each pair of rows;
//   * one block of three warpgroups per (BM-row, 128-column) output tile
//     and K slice: warpgroup 0 is the producer, whose one thread keeps a
//     ring of 4 stages full with TMA (2-D tensor maps, 128-byte
//     swizzle: x as BM rows x 64 k, the codes as 64 k x 128 columns; rows
//     past M, columns past N and K past K read as zeros, and a zero x adds
//     zero whatever the code), each stage's arrival on a "full" mbarrier
//     and its release by the 256 consumer threads on an "empty" one;
//     warpgroups 1 and 2 each own 64 of the columns.  Per two 16-row
//     k-steps a consumer looks its A fragments up, then issues its pieces'
//     wgmma (A from registers, B the stage's x at the step's 32-byte
//     offset) as two chains of BM / 2 rows of x (m64n32k16 .. m64n88k16),
//     interleaved, so that no product waits on the one just before it,
//     all as one wgmma group, and looks the next two steps up while they
//     run (two A buffers, wgmma.wait_group 1).  The piece count is a
//     template argument: a group's products are one straight run of
//     wgmma, which the compiler chains (one scoreboard; behind runtime
//     branches each product was fenced on its own).  The 128-byte swizzle
//     of the codes' tile puts the four k rows a warp reads at once in four
//     different bank groups;
//   * split-K without a workspace or a second launch, to fill the card at
//     small M (4096 x 512 has 4 column tiles): up to 8 blocks of a cluster
//     split K in whole stages and are summed through distributed shared
//     memory in rank order, each rank finishing its share of the rows of
//     the accumulator fragment.  The caller's plan (lut_gemm.py
//     wgmma_split_plan) weighs the waves of clusters the card holds
//     (lut_gemm_wgmma_max_clusters) against the stages a block runs.  The
//     order is fixed: results are deterministic;
//   * the epilogue stores straight from the accumulator fragment: a
//     thread's columns 2g and 2g + 1 make one 8-byte store a row, 64
//     contiguous bytes a warp, masked to M and N.
// The tensor map encoder is taken from the driver through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cooperative_groups.h>
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 128;               // output columns a block (64 a warpgroup)
constexpr int BK = 64;                // K rows a stage: one 128-byte x row
constexpr int KSTEP = 16;             // K rows a wgmma
constexpr int KSTEPS = BK / KSTEP;
constexpr int STAGES = 4;             // ring depth
constexpr int THREADS = 384;          // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int MAX_CLUSTER = 8;        // K slices summed through DSMEM
// row tiles (the wgmma's N, BM): multiples of 16 (two chains of whole
// 8-row groups) from 64 (48 ran a yi-9b layer no faster on an H100) to
// 176, whose 88 accumulators a consumer still holds in the 168 registers
// of 384 threads (166 used, no spills)
constexpr int MIN_BM = 64;
constexpr int MAX_BM = 176;
// a step's products as CHAINS interleaved chains of BM / CHAINS rows of x,
// GROUP steps a wgmma group: on an H100 two of each ran a yi-9b layer
// faster than one (chains: also than four) at every M, device-only
constexpr int CHAINS = 2;
constexpr int GROUP = 2;
constexpr int TAB1_BYTES = 256 * 32 * 4;    // one piece's pairs, 32 copies
constexpr int TAB_BYTES = 3 * TAB1_BYTES;
constexpr int C_TILE = BK * BN;       // one stage's codes
static_assert(CONSUMERS == 256, "one consumer thread a pair-table entry");

// Byte offsets from a 1024-aligned base: the pair tables, then the ring
// (each stage x, then codes), then the full[] and empty[] mbarriers.  After
// the main loop the split-K partials reuse the tables' and ring's space.
template <int BM>
struct Smem {
  static constexpr int X_TILE = BM * BK * 2;
  static constexpr int STAGE = X_TILE + C_TILE;
  static constexpr int RING_OFF = TAB_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  // a consumer's BM / 2 accumulators as float4s: [BM / 8][CONSUMERS]
  static constexpr int RED_BYTES = BM / 8 * CONSUMERS * 16;
  static_assert(RED_BYTES <= BAR_OFF, "partials fit in the freed space");
  static_assert(X_TILE % 1024 == 0 && C_TILE % 1024 == 0 &&
                    TAB_BYTES % 1024 == 0,
                "swizzled tiles on 1024-byte boundaries");
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

// One box of a 2-D tensor map (c0 innermost) into shared memory at dst,
// completing on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand:
// start address, 8-row groups 1024 bytes apart (stride byte offset), the
// leading offset unused, layout 1 = SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product (and an A buffer live until its product is done).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, smem,
// K-major), N = 32, 40, ..., 88: half a row tile of 64 .. 176
__device__ __forceinline__ void wgmma(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[20],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19},"
      " {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[24],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23},"
      " {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[28],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27},"
      " {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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

__device__ __forceinline__ void wgmma(float (&d)[36],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35},"
      " {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[40],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
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
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[44],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43},"
      " {%44, %45, %46, %47}, %48, p, 1, 1, 0;\n}\n"
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
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x NB) += A (64 x 16) * B (16 x NB): NB of the tile's rows of x
template <int NB>
__device__ __forceinline__ void wgmma_rows(float* d, const uint32_t (&a)[4],
                                           uint64_t b) {
  wgmma(*reinterpret_cast<float(*)[NB / 2]>(d), a, b);
}

// The pair tables, one a piece, as lut_gemm_tc.cu lays them out: entry
// (q_even + 16 q_odd) = bf16x2 {p[q_even], p[q_odd]} at piece * TAB1_BYTES
// + idx * 128 + copy * 4, 32 copies, so a warp's 32-bit loads hit every
// bank once whatever the indices.  Consumer idx writes entry idx from the
// pieces lane q of its warp holds, its 16-byte stores rotated by idx.
__device__ __forceinline__ void build_tables(uint8_t* tab,
                                             const uint32_t (&piece)[3],
                                             int pieces, int idx) {
  const int qa = idx & 15, qb = idx >> 4;
  for (int p = 0; p < 3; ++p) {
    const uint32_t e = __shfl_sync(0xFFFFFFFFu, piece[p], qa) |
                       (__shfl_sync(0xFFFFFFFFu, piece[p], qb) << 16);
    if (p >= pieces) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint4*>(tab + p * TAB1_BYTES + idx * 128 +
                                ((c + idx) & 7) * 16) = make_uint4(e, e, e, e);
  }
}

// One k-step's A fragments of every piece.  The thread's A rows g and g + 8
// are its warp's columns 2g and 2g + 1; its registers hold k rows (2t, 2t+1)
// (0: row g, 1: row g + 8) and (2t+8, 2t+9) (2, 3).  cs: the step's 16
// swizzled code rows; coff: the thread's byte offsets of rows 2t, 2t+1,
// 2t+8, 2t+9 (two columns each); tab: the tables plus the lane's copy.
template <int NP>
__device__ __forceinline__ void lookup(uint32_t (&a)[3][4],
                                       const uint8_t* cs,
                                       const uint32_t (&coff)[4],
                                       const uint8_t* tab) {
  const uint32_t h0 = *reinterpret_cast<const uint16_t*>(cs + coff[0]);
  const uint32_t h1 = *reinterpret_cast<const uint16_t*>(cs + coff[1]);
  const uint32_t h8 = *reinterpret_cast<const uint16_t*>(cs + coff[2]);
  const uint32_t h9 = *reinterpret_cast<const uint16_t*>(cs + coff[3]);
  // byte c of i01 / i89: q(k even) + 16 q(k odd) of column 2g + c
  const uint32_t i01 = h0 | (h1 << 4), i89 = h8 | (h9 << 4);
  const uint32_t off[4] = {(i01 & 0xFFu) << 7, (i01 >> 8) << 7,
                           (i89 & 0xFFu) << 7, (i89 >> 8) << 7};
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[p][r] = *reinterpret_cast<const uint32_t*>(tab + p * TAB1_BYTES +
                                                   off[r]);
}

// A consumer's K slice: nst stages from the ring into acc, NP pieces (a
// template argument, so that a step's products are straight-line code the
// compiler issues back to back).  Per group of GROUP 16-row steps: the
// lookups, then the pieces' products as CHAINS interleaved chains of BM /
// CHAINS rows of x, each output summing its pieces in piece order, step by
// step, as one wgmma group; the lookups of the next group overlap them
// (two A buffers, wgmma.wait_group 1).  A stage is released once the first
// group of the next has waited out its products.
template <int BM, int NP>
__device__ __forceinline__ void main_loop(float (&acc)[BM / 2], int nst,
                                          uint32_t ring, const uint8_t* gring,
                                          uint32_t bar_full,
                                          uint32_t bar_empty,
                                          const uint32_t (&coff)[4],
                                          const uint8_t* tab) {
  using L = Smem<BM>;
  constexpr int G = GROUP, NC = CHAINS;
  static_assert(KSTEPS % (2 * G) == 0, "two A buffers alternate in a stage");
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  uint32_t a[2][G][3][4] = {};
  for (int j = 0; j < nst; ++j) {
    const int s = j % STAGES;
    mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
    const uint32_t xs = ring + s * L::STAGE;
    const uint8_t* cs = gring + s * L::STAGE + L::X_TILE;
#pragma unroll
    for (int gg = 0; gg < KSTEPS / G; ++gg) {
      uint32_t(&ab)[G][3][4] = a[gg & 1];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        lookup<NP>(ab[h], cs + (gg * G + h) * KSTEP * BN, coff, tab);
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs(ab[h][p]);
      }
      __syncwarp();                          // wgmma wants converged warps
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rows<BM / NC>(
                acc + c * (BM / NC / 2), ab[h][p],
                sw128_desc(xs + c * (BM / NC) * 128 + 32 * (gg * G + h)));
      wgmma_commit();
      wgmma_wait<1>();
      // the last group's products are done: its A buffer is free again
      // and, at a stage's first group, the last stage is read
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs(a[(gg + 1) & 1][h][p]);
      if (gg == 0 && j > 0) mbar_arrive(bar_empty + 8 * ((j - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// One block: BN columns x BM rows of out over one K slice (cluster rank
// along x; gridDim.y the M tiles, gridDim.z the column tiles, so the blocks
// that share a strip of codes run together and read it from L2).
template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
lut_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tcodes,
                      const float* __restrict__ cb,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int M, int N, int k_stages,
                      int per) {
  using L = Smem<BM>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the base to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * BN;
  const int st0 = rank * per;
  const int nst = min(per, k_stages - st0);      // >= 1 by the host's plan
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int j = 0; j < nst; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t xs = base + L::RING_OFF + s * L::STAGE;
        mbar_expect_tx(full, L::STAGE);
        const int k0 = (st0 + j) * BK;
        tma_load(xs, &tx, full, k0, m0);
        tma_load(xs + L::X_TILE, &tcodes, full, n0, k0);
      }
    }
    __syncwarp();
    if (csize > 1) {       // the consumers' two cluster barriers
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  const int t = threadIdx.x - 128;               // consumer 0 .. 255
  const int v = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;

  // the codebook's pieces (lane q holds CB[q & 15]'s) and how many are not
  // zero for all 16 codes: the same in every warp
  uint32_t piece[3];
  int pieces;
  {
    const float cq = cb[lane & 15];
    const uint32_t p1 = __float_as_uint(cq) & 0xFFFF0000u;
    const float r1 = cq - __uint_as_float(p1);
    const uint32_t p2 = __float_as_uint(r1) & 0xFFFF0000u;
    const float r2 = r1 - __uint_as_float(p2);
    piece[0] = p1 >> 16;
    piece[1] = p2 >> 16;
    piece[2] = __float_as_uint(r2) >> 16;
    const bool has2 = __any_sync(0xFFFFFFFFu, (piece[1] & 0x7FFFu) != 0);
    const bool has3 = __any_sync(0xFFFFFFFFu, (piece[2] & 0x7FFFu) != 0);
    pieces = has3 ? 3 : has2 ? 2 : 1;
  }
  build_tables(gbase, piece, pieces, t);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");   // the consumers'

  // this thread's code bytes in a stage: rows 2t, 2t+1, 2t+8, 2t+9 of a
  // k-step (the swizzle's row % 8 is the same in every step), its warp's
  // 16-byte chunk of the 128 columns, columns 2g and 2g + 1
  const int chunk = 4 * v + warp;
  uint32_t coff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
    coff[i] = r * BN + ((chunk ^ (r & 7)) << 4) + 2 * g;
  }
  const uint8_t* tab = gbase + lane * 4;

  float acc[BM / 2];
  const uint32_t ring = base + L::RING_OFF;
  const uint8_t* gring = gbase + L::RING_OFF;
  switch (pieces) {
    case 1:
      main_loop<BM, 1>(acc, nst, ring, gring, bar_full, bar_empty, coff,
                        tab);
      break;
    case 2:
      main_loop<BM, 2>(acc, nst, ring, gring, bar_full, bar_empty, coff,
                        tab);
      break;
    default:
      main_loop<BM, 3>(acc, nst, ring, gring, bar_full, bar_empty, coff,
                        tab);
  }

  // acc[4c + e]: column nA (row g), row m0 + 8c + 2t + e; acc[4c + 2 + e]:
  // column nA + 1 (row g + 8), the same row
  const int nA = n0 + 64 * v + 16 * warp + 2 * g;
  const bool n_ok = nA < N;                      // N even: nA + 1 < N too
  const float s0 = n_ok ? scale[nA] : 0.f, s1 = n_ok ? scale[nA + 1] : 0.f;
  if (csize == 1) {
    if (n_ok) {
#pragma unroll
      for (int c = 0; c < BM / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * c + 2 * tq + e;
          if (m < M)
            *reinterpret_cast<float2*>(out + (size_t)m * N + nA) =
                make_float2(acc[4 * c + e] * s0, acc[4 * c + 2 + e] * s1);
        }
    }
    return;
  }

  // split K: the partials in this block's freed shared memory, [c][t] as
  // float4s; each rank sums its share (c = rank, rank + csize, ...) over
  // the ranks in rank order through distributed shared memory
  asm volatile("bar.sync 1, 256;\n" ::: "memory");   // tables, ring read
  float4* red = reinterpret_cast<float4*>(gbase);
#pragma unroll
  for (int c = 0; c < BM / 8; ++c)
    red[c * CONSUMERS + t] = make_float4(acc[4 * c], acc[4 * c + 1],
                                         acc[4 * c + 2], acc[4 * c + 3]);
  cluster.sync();
  for (int c = rank; c < BM / 8; c += csize) {
    float4 part[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < csize)
        part[q] = *cluster.map_shared_rank(red + c * CONSUMERS + t, q);
    float4 sum = part[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < csize) {
        sum.x += part[q].x;
        sum.y += part[q].y;
        sum.z += part[q].z;
        sum.w += part[q].w;
      }
    const int m = m0 + 8 * c + 2 * tq;
    if (n_ok && m < M)
      *reinterpret_cast<float2*>(out + (size_t)m * N + nA) =
          make_float2(sum.x * s0, sum.z * s1);
    if (n_ok && m + 1 < M)
      *reinterpret_cast<float2*>(out + (size_t)(m + 1) * N + nA) =
          make_float2(sum.y * s0, sum.w * s1);
  }
  cluster.sync();           // keep this block's partials until all have read
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

// A row-major (outer, inner) matrix as a 2-D map, row stride `stride`
// bytes: boxes of box_inner x box_outer elements, 128-byte swizzle;
// out-of-bounds elements read as zeros.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            int inner, int outer, int stride, int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shared-memory limit of kernel<BM>, set once per device (one bit
// each): a call inside a graph capture then only launches.
template <int BM>
cudaError_t prepare() {
  static unsigned long long sized = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((sized >> dev) & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(lut_gemm_wgmma_kernel<BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<BM>::BYTES);
  if (err == cudaSuccess && dev < 64) sized |= 1ull << dev;
  return err;
}

template <int BM>
cudaError_t max_clusters(int splits, int* n) {
  cudaError_t err = prepare<BM>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t q = {};
  q.gridDim = dim3(splits, 1, 1);
  q.blockDim = dim3(THREADS, 1, 1);
  q.dynamicSmemBytes = Smem<BM>::BYTES;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = splits;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  q.attrs = a;
  q.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, lut_gemm_wgmma_kernel<BM>,
                                        &q);
}

template <int BM>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tcodes,
                   const void* cb, const void* scale, void* out, int M, int N,
                   int k_stages, int splits, cudaStream_t st) {
  cudaError_t err = prepare<BM>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (M + BM - 1) / BM, (N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Smem<BM>::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lut_gemm_wgmma_kernel<BM>, tx, tcodes,
                           static_cast<const float*>(cb),
                           static_cast<const float*>(scale),
                           static_cast<float*>(out), M, N, k_stages,
                           (k_stages + splits - 1) / splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


// f(std::integral_constant<int, BM>) for the row tile bm
template <int BM = MIN_BM, typename F>
cudaError_t on_tile(int bm, F&& f) {
  if constexpr (BM > MAX_BM) {
    return cudaErrorInvalidValue;
  } else {
    if (bm == BM) return f(std::integral_constant<int, BM>{});
    return on_tile<BM + 16>(bm, f);
  }
}

bool valid_tile(int bm) {
  return bm >= MIN_BM && bm <= MAX_BM && bm % 16 == 0;
}

}  // namespace

extern "C" {

// Geometry the host must respect; the Python wrapper reads these.
int lut_gemm_wgmma_block_n() { return BN; }
int lut_gemm_wgmma_block_k() { return BK; }
int lut_gemm_wgmma_max_cluster() { return MAX_CLUSTER; }
int lut_gemm_wgmma_min_tile_m() { return MIN_BM; }
int lut_gemm_wgmma_max_tile_m() { return MAX_BM; }

// Clusters of `splits` blocks of the bm-row kernel the card holds at once
// (the caller's split plan reads it); a negative cudaError_t on failure.
int lut_gemm_wgmma_max_clusters(int bm, int splits) {
  if (!valid_tile(bm) || splits <= 0 || splits > MAX_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = on_tile(bm, [&](auto t) {
    return max_clusters<decltype(t)::value>(splits, &n);
  });
  return err == cudaSuccess ? n : -(int)err;
}

// One launch on `stream`: x (M, K) bf16 and codes (K, N) int8, contiguous,
// 16-byte aligned, K % 16 == 0, N % 16 == 0; bm (a multiple of 16 from 64
// to 176) rows of x a block; K's stages of BK rows in `splits` (<= 8, the cluster size) slices
// of ceil(stages / splits) stages, every slice some.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
int lut_gemm_wgmma_launch(const void* x, const void* codes, const void* cb,
                          const void* scale, void* out, int M, int K, int N,
                          int bm, int splits, void* stream) {
  const int k_stages = (K + BK - 1) / BK;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 ||
      !valid_tile(bm) || splits <= 0 || splits > MAX_CLUSTER ||
      splits > k_stages ||
      (k_stages + splits - 1) / splits * (splits - 1) >= k_stages ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(codes) & 15) != 0 ||
      (M + bm - 1) / bm > 65535 || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tcodes;
  if (!encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2 * K, BK,
              bm) ||
      !encode(&tcodes, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, K, N, BN,
              BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)on_tile(bm, [&](auto t) {
    return launch<decltype(t)::value>(tx, tcodes, cb, scale, out, M, N,
                                      k_stages, splits, st);
  });
}

}  // extern "C"
