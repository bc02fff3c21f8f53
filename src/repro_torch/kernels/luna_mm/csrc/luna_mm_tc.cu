// Code-space LUNA GEMM on Hopper's int8 tensor cores (sm_90a): the
// model-level luna_* quant modes at prefill and training sizes.
//
// Replaces, for the shapes kernels/luna_mm/luna_mm.py:takes_tc routes here,
// the Pallas TPU kernel src/repro/kernels/luna_mm/luna_mm.py:77 luna_mm
// (body _luna_mm_kernel, :38), which the __dp4a kernel of luna_mm.cu ported
// first; that kernel keeps small M, ragged K or N and misaligned bases.
//   Z[m, n] = sum_k L(W[k, n], Y[m, k])          (int32)
// y (M, K) int8 codes in [0, 16), row-major (K-major); w_nk (N, K) int8
// codes, row-major: the weight K-major, i.e. the (K, N) operand with
// strides (1, K).  out (M, N) int32.  The modes keep the TPU kernel's
// digit planes, one tensor-core product per plane and weight tile, all
// summed into one int32 accumulator:
//   conventional   y @ w                          = y @ w
//   dc / opt_dc    (y & 12) @ w  +  (y & 3) @ w   = (hi@w << 2) + lo@w
//   approx_dc      (y & 12) @ w                   = hi@w << 2
//   approx_dc2     (y & 12) @ w  +  ones @ w      = (hi@w << 2) + colsum
// with hi = y >> 2, lo = y & 3: the hi plane is taken pre-scaled (y & 12 =
// 4 hi), so the shift is in the operand and the planes share one
// accumulator.  approx_dc2's colsum(W) is one more product per K tile,
// an all-ones A operand against the same weight tile (every row of ones @ w
// is the tile's column sum), as the TPU kernel adds colsum per K tile.
//
// What bounds it: at yi-9b's (512, 4096, 11008) integer operations (2MKN
// per plane: 46 G, 23 us at the int8 tensor cores' 1,979 TOP/s) against
// 47 MB of codes and 23 MB of int32 output (21 us at 3.35 TB/s).  The
// __dp4a kernel ran it at ~60 TOP/s.  The design:
//   * one block of three warpgroups per (128-row, 128-column) output tile
//     and K slice (split-K over gridDim.z when the tiles alone would leave
//     SMs idle, partials summed by a second kernel in a fixed order);
//     blockIdx.x walks the row tiles, so the blocks that share a weight
//     strip run together and read it from L2;
//   * warpgroup 0 is the producer: one thread loads 128 x 128-byte tiles of
//     Y and of W (both K-major) into a ring of STAGES shared-memory stages
//     with TMA (2-D tensor maps, 128-byte swizzle; rows past M or N and K
//     past K read as zeros, and a zero code adds zero in every mode), each
//     stage's arrival on a "full" mbarrier, its release by the 256
//     consumer threads on an "empty" one;
//   * warpgroups 1 and 2 each own 64 rows of Y.  Per 32-byte k-step a
//     thread reads its A fragment of Y from the swizzled tile with
//     ldmatrix (4 registers of 4 codes), masks the planes out of it in
//     registers (& 0x0C0C0C0C, & 0x03030303; ones are 0x01010101), and
//     issues wgmma m64n128k32.s32.u8.u8 with A from registers and the W
//     tile as the K-major B operand from shared memory: 64 int32
//     accumulator registers a thread;
//   * the epilogue stores the accumulator fragment as int32 pairs, masked
//     to M and N.
// PTX's wgmma takes 8-bit operands K-major only (no transpose bit), so a
// row-major (K, N) weight is first transposed to (N, K) by
// luna_mm_tc_transpose (64 x 64 byte tiles through shared memory) into a
// scratch the caller owns.  TMA needs 16-byte aligned bases and K % 16 ==
// 0 (the row stride); the wrapper routes other shapes to luna_mm.cu.
// Int32 cannot overflow: 15 * 15 * K < 2^31 for K < 9.5M.
// The tensor map encoder is taken from the driver through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;               // rows of Y per block
constexpr int BN = 128;               // columns of Z (rows of w_nk) per block
constexpr int BK = 128;               // K bytes per stage: one swizzled row
constexpr int STAGES = 4;             // ring depth
constexpr int THREADS = 384;          // producer + two consumer warpgroups
constexpr int TILE_BYTES = BM * BK;   // one Y tile; a W tile is BN * BK
constexpr int KSTEPS = BK / 32;       // wgmma k-steps (32 codes) per stage
static_assert(BM * BK == BN * BK, "Y and W tiles share one size");

constexpr int SY_OFF = 0;
constexpr int SW_OFF = STAGES * TILE_BYTES;
constexpr int BAR_OFF = 2 * STAGES * TILE_BYTES;   // full[], then empty[]
constexpr int SMEM_BYTES = BAR_OFF + 16 * STAGES + 1024;   // + alignment slack

enum Mode : int { CONVENTIONAL = 0, DC = 1, APPROX_DC = 2, APPROX_DC2 = 3 };

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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Four 8 x 16-byte matrices of shared memory into registers: lane l gives
// the address of row l % 8 of matrix l / 8; register q gets matrix q's
// row lane / 4, bytes 4 (lane % 4) .. + 3.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (64 x 128, s32) += A (64 x 32, u8 registers) * B (32 x 128, u8 smem,
// K-major)
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mask4(uint32_t (&out)[4],
                                      const uint32_t (&a)[4], uint32_t m) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = a[i] & m;
}

// One (BM x BN) tile of Z over K tiles [kt0, kt1) into dst (M, N) int32:
// the output itself, or split blockIdx.z's slice of the workspace.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
luna_mm_tc_kernel(const __grid_constant__ CUtensorMap ty,
                  const __grid_constant__ CUtensorMap tw,
                  int32_t* __restrict__ dst, int M, int N, int k_tiles,
                  int k_tiles_per_split) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the base to it
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sy = base + SY_OFF, sw = base + SW_OFF;
  const uint32_t bar_full = base + BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int nt = min(k_tiles_per_split, k_tiles - kt0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int j = 0; j < nt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * TILE_BYTES);
        const int k0 = (kt0 + j) * BK;
        tma_load(sy + s * TILE_BYTES, &ty, full, k0, m0);
        tma_load(sw + s * TILE_BYTES, &tw, full, k0, n0);
      }
    }
    return;
  }

  const int t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32;
  const int rw = (wg - 1) * 64;        // this warpgroup's rows in the tile
  const bool live = m0 + rw < M;             // else its rows are all past M
  // ldmatrix: lane l reads row (l / 8 % 2) * 8 + l % 8 of this warp's 16,
  // 16-byte chunk 2 kk + l / 16 of the k-step (swizzled by the row % 8)
  const int a_row = rw + 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_chunk = lane >> 4;

  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0u;
  fence_regs(acc);
  uint32_t ones[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};

  for (int j = 0; j < nt; ++j) {
    const int s = j % STAGES;
    mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
    if (live) {
      // every A operand of the stage in registers before the fence: wgmma
      // may not read a register written after it
      const uint32_t ytile = sy + s * TILE_BYTES + a_row * BK;
      uint32_t a[KSTEPS][4], hi[KSTEPS][4], lo[KSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        ldmatrix_x4(a[kk],
                    ytile + (((2 * kk + a_chunk) ^ (a_row & 7)) << 4));
        if (MODE != CONVENTIONAL) {
          mask4(hi[kk], a[kk], 0x0C0C0C0Cu);   // the hi plane, pre-scaled
          fence_regs(hi[kk]);
        }
        if (MODE == DC) {
          mask4(lo[kk], a[kk], 0x03030303u);   // the lo plane
          fence_regs(lo[kk]);
        }
        fence_regs(a[kk]);
      }
      fence_regs(ones);
      __syncwarp();                          // wgmma wants converged warps
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t b = sw128_desc(sw + s * TILE_BYTES + 32 * kk);
        if (MODE == CONVENTIONAL) {
          wgmma_u8(acc, a[kk], b);
        } else {
          wgmma_u8(acc, hi[kk], b);
          if (MODE == DC) wgmma_u8(acc, lo[kk], b);
          if (MODE == APPROX_DC2) wgmma_u8(acc, ones, b);   // tile colsum
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty + 8 * s);
  }
  if (!live) return;

  // d[i]: row 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
  // 2 (lane % 4) + i % 2
  int32_t* op = dst + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + rw + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= M) continue;
    int32_t* rp = op + static_cast<size_t>(row) * N;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = n0 + 8 * c + 2 * (lane & 3);
      if (col < N)                           // N is even: col + 1 < N too
        *reinterpret_cast<int2*>(rp + col) =
            make_int2(static_cast<int32_t>(acc[4 * c + 2 * h]),
                      static_cast<int32_t>(acc[4 * c + 2 * h + 1]));
    }
  }
}

// out[m, n] = ws[0, m, n] + ws[1, m, n] + ..., splits summed in index order.
__global__ void luna_mm_tc_reduce_kernel(const int32_t* __restrict__ ws,
                                     int32_t* __restrict__ out, int splits,
                                     size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  int32_t s = ws[i];
  for (int j = 1; j < splits; ++j) s += ws[(size_t)j * mn + i];
  out[i] = s;
}

// dst (C, R) = src (R, C)^T, int8, R % 4 == 0 and C % 4 == 0: 64 x 64-byte
// tiles through shared memory, 4-byte loads and stores.
constexpr int TT = 64;
__global__ void __launch_bounds__(256)
luna_mm_tc_transpose_kernel(const uint8_t* __restrict__ src,
                            uint8_t* __restrict__ dst, int R, int C) {
  __shared__ uint8_t tile[TT][TT + 4];
  const int r0 = blockIdx.y * TT, c0 = blockIdx.x * TT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TT / 16; ++i) {
    const int r = ty + 16 * i;
    uint32_t v = 0u;
    if (r0 + r < R && c0 + 4 * tx < C)
      v = *reinterpret_cast<const uint32_t*>(src + (size_t)(r0 + r) * C + c0 +
                                             4 * tx);
    *reinterpret_cast<uint32_t*>(&tile[r][4 * tx]) = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TT / 16; ++i) {
    const int c = ty + 16 * i;
    if (c0 + c >= C || r0 + 4 * tx >= R) continue;
    const uint32_t v = (uint32_t)tile[4 * tx][c] |
                       ((uint32_t)tile[4 * tx + 1][c] << 8) |
                       ((uint32_t)tile[4 * tx + 2][c] << 16) |
                       ((uint32_t)tile[4 * tx + 3][c] << 24);
    *reinterpret_cast<uint32_t*>(dst + (size_t)(c0 + c) * R + r0 + 4 * tx) = v;
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

// (rows, K) int8, K-major, as a 2-D map: boxes of 128 bytes of K x 128
// rows, 128-byte swizzle; out-of-bounds rows and K read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int rows, int K) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) != 0 ||
      K % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
cudaError_t launch(const CUtensorMap& ty, const CUtensorMap& tw, void* dst,
                   int M, int N, int k_tiles, int splits, int per,
                   cudaStream_t st) {
  // the shared-memory limit is set once per device (one bit each), on
  // the device's first launch: a call inside a graph capture then only
  // launches
  static unsigned long long sized = 0;
  auto kern = luna_mm_tc_kernel<MODE>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((sized >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (dev < 64) sized |= 1ull << dev;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kern<<<grid, THREADS, SMEM_BYTES, st>>>(ty, tw, static_cast<int32_t*>(dst),
                                          M, N, k_tiles, per);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the host must respect; the Python wrapper reads these.
int luna_mm_tc_block_m() { return BM; }
int luna_mm_tc_block_n() { return BN; }
int luna_mm_tc_block_k() { return BK; }

// y (M, K) and w_nk (N, K) int8, contiguous, 16-byte aligned, K % 16 == 0,
// N % 2 == 0.  mode: 0 conventional, 1 dc/opt_dc, 2 approx_dc, 3
// approx_dc2.  K's tiles of BK go in `splits` slices of `per` tiles
// (ceil(ceil(K / BK) / per) == splits).  With splits == 1 the kernel writes
// `out` and `ws` is not read; otherwise ws holds splits*M*N int32.  Returns
// the cudaError_t of the launches (0 = cudaSuccess).
int luna_mm_tc_launch(const void* y, const void* w_nk, void* ws, void* out,
                      int M, int K, int N, int mode, int splits, int per,
                      void* stream) {
  const int k_tiles = (K + BK - 1) / BK;
  if (M <= 0 || K <= 0 || N <= 0 || N % 2 != 0 || splits <= 0 ||
      per <= 0 || (long long)splits * per < k_tiles ||
      (long long)(splits - 1) * per >= k_tiles || mode < 0 || mode > 3 ||
      (N + BN - 1) / BN > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ty, tw;
  if (!encode(&ty, y, M, K) || !encode(&tw, w_nk, N, K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* dst = splits == 1 ? out : ws;
  cudaError_t err;
  switch (mode) {
    case CONVENTIONAL:
      err = launch<CONVENTIONAL>(ty, tw, dst, M, N, k_tiles, splits, per, st);
      break;
    case DC:
      err = launch<DC>(ty, tw, dst, M, N, k_tiles, splits, per, st);
      break;
    case APPROX_DC:
      err = launch<APPROX_DC>(ty, tw, dst, M, N, k_tiles, splits, per, st);
      break;
    default:
      err = launch<APPROX_DC2>(ty, tw, dst, M, N, k_tiles, splits, per, st);
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  const int threads = 256;
  luna_mm_tc_reduce_kernel<<<(unsigned)((mn + threads - 1) / threads),
                             threads, 0, st>>>(
      static_cast<const int32_t*>(ws), static_cast<int32_t*>(out), splits,
      mn);
  return (int)cudaGetLastError();
}

// dst (C, R) = src (R, C)^T for int8, both contiguous and 4-byte aligned,
// R % 4 == 0, C % 4 == 0: the row-major weight (K, N) to w_nk (N, K).
int luna_mm_tc_transpose(const void* src, void* dst, int R, int C,
                         void* stream) {
  if (R <= 0 || C <= 0 || R % 4 != 0 || C % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(src) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(dst) & 3) != 0 ||
      (R + TT - 1) / TT > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + TT - 1) / TT, (R + TT - 1) / TT);
  luna_mm_tc_transpose_kernel<<<grid, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), R, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
