// Code-space LUNA GEMM for Hopper (sm_90a): the model-level luna_* quant
// modes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/luna_mm/luna_mm.py
// (luna_mm, body _luna_mm_kernel):
//   Z[m, n] = sum_k L(W[k, n], Y[m, k])          (int32)
// y (M, K) and w (K, N) int8 unsigned 4-bit codes in [0, 16), one per byte;
// out (M, N) int32.  L is the paper's multiplier in one of its modes, kept
// as digit planes of Y so each mode's work stays visible:
//   conventional        one full-code contraction            y @ w
//   dc / opt_dc (exact) hi plane and lo plane                (hi@w << 2) + lo@w
//   approx_dc           hi plane only (Z_LSB := 0)           hi@w << 2
//   approx_dc2          hi plane + colsum(W) (Z_LSB := W)    (hi@w << 2) + colsum
// with hi = y >> 2 and lo = y & 3.  The Pallas kernel adds colsum per K
// tile; here each K slice adds its own, and the slices' sum is the same
// integer (zero padding contributes zero).
//
// What bounds it: at decode (M = the engine's max_batch, 8) memory bytes:
// each weight code byte read from device memory feeds 2M int8 ops per
// plane.  At prefill (M in the hundreds) integer operations.  Design:
//   * each block owns a strip of 512 columns and one slice of K (split-K
//     over gridDim.y so a narrow N still fills the card) and M_TILE rows
//     of Y (gridDim.z);
//   * the block's Y rows for its slice are staged once in shared memory as
//     packed digit-plane words: 4 K-consecutive codes per 32-bit word, the
//     hi plane (w >> 2) & 0x03030303 and lo plane w & 0x03030303 computed
//     on the packed word;
//   * each thread owns 4 neighbouring columns.  Per group of 4 K rows it
//     reads the 4 rows' 4 code bytes as four 32-bit loads (a warp reads
//     128 contiguous bytes of a row), transposes the 4x4 byte block in
//     registers with __byte_perm into one word per column holding 4
//     K-consecutive codes, and contracts it with each staged Y word by
//     __dp4a (4 int8 products + int32 add in one instruction);
//   * approx_dc2's colsum(W) is __dp4a of the column word with 0x01010101;
//   * split-K partials go to an int32 workspace (splits, M, N), summed by a
//     second kernel in a fixed order (deterministic; integer sums are exact
//     in any order anyway).  With one split the kernel writes the output;
//   * ragged M, N and K are masked in the kernel: no padding.
// Int32 cannot overflow: 15 * 15 * K < 2^31 for K < 9.5M.
// Tensor-core int8 mma (mma.sync s32.s8.s8.s32) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4;                   // code bytes (columns) per thread
constexpr int BN = THREADS * COLS;        // columns per block
constexpr int KSPLIT_MAX = 1024;          // K rows per block, at most
constexpr int KW_MAX = KSPLIT_MAX / 4;    // packed Y words per row
constexpr int M_TILE_MAX = 16;            // Y rows per block, at most

enum Mode : int { CONVENTIONAL = 0, DC = 1, APPROX_DC = 2, APPROX_DC2 = 3 };

// Transpose a 4x4 block of bytes: r[b] holds row b's bytes for columns
// 0..3; out[c] gets column c's bytes for rows 0..3 (row 0 in the low byte).
__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

template <int M_TILE, int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
luna_mm_split_kernel(const int8_t* __restrict__ y,
                     const int8_t* __restrict__ w,
                     int32_t* __restrict__ ws, int M, int K, int N,
                     int k_split) {
  constexpr int PLANES = (MODE == DC) ? 2 : 1;
  __shared__ uint32_t ys[PLANES][M_TILE][KW_MAX];

  const int n0 = (blockIdx.x * THREADS + threadIdx.x) * COLS;
  const int k0 = blockIdx.y * k_split;
  const int kn = min(k_split, K - k0);
  const int kw = (kn + 3) / 4;
  const int m0 = blockIdx.z * M_TILE;

  for (int i = threadIdx.x; i < M_TILE * kw; i += THREADS) {
    const int m = i / kw;
    const int g = i - m * kw;
    uint32_t word = 0;
    if (m0 + m < M) {
      const int8_t* yp = y + (size_t)(m0 + m) * K + k0 + 4 * g;
      if (VEC) {
        // K % 4 == 0 and 4-byte aligned rows: the whole word is in range
        word = *reinterpret_cast<const uint32_t*>(yp);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * g + b < kn) word |= (uint32_t)(uint8_t)yp[b] << (8 * b);
      }
    }
    if (MODE == CONVENTIONAL) {
      ys[0][m][g] = word;
    } else {
      ys[0][m][g] = (word >> 2) & 0x03030303u;            // hi plane
      if (MODE == DC) ys[PLANES - 1][m][g] = word & 0x03030303u;  // lo
    }
  }
  __syncthreads();
  if (n0 >= N) return;

  uint32_t acc[PLANES][M_TILE][COLS];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int m = 0; m < M_TILE; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[p][m][c] = 0u;
  uint32_t cs[COLS] = {0u, 0u, 0u, 0u};

  const int8_t* wp = w + (size_t)k0 * N + n0;
#pragma unroll 2
  for (int g = 0; g < kw; ++g) {
    uint32_t r[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      r[b] = 0u;
      if (4 * g + b < kn) {
        const int8_t* rp = wp + (size_t)(4 * g + b) * N;
        if (VEC) {
          // N % 4 == 0 and a 4-byte aligned base: n0..n0+3 are in range
          r[b] = __ldg(reinterpret_cast<const unsigned int*>(rp));
        } else {
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            if (n0 + c < N) r[b] |= (uint32_t)(uint8_t)rp[c] << (8 * c);
        }
      }
    }
    uint32_t col[COLS];
    transpose4x4(r, col);
    if (MODE == APPROX_DC2) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) cs[c] = __dp4a(col[c], 0x01010101u, cs[c]);
    }
#pragma unroll
    for (int m = 0; m < M_TILE; ++m) {
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const uint32_t a = ys[p][m][g];
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[p][m][c] = __dp4a(a, col[c], acc[p][m][c]);
      }
    }
  }

  int32_t* op = ws + ((size_t)blockIdx.y * M + m0) * N + n0;
#pragma unroll
  for (int m = 0; m < M_TILE; ++m) {
    if (m0 + m >= M) break;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      if (n0 + c >= N) continue;
      uint32_t v;
      if (MODE == CONVENTIONAL) v = acc[0][m][c];
      else if (MODE == DC) v = (acc[0][m][c] << 2) + acc[PLANES - 1][m][c];
      else if (MODE == APPROX_DC) v = acc[0][m][c] << 2;
      else v = (acc[0][m][c] << 2) + cs[c];
      op[(size_t)m * N + c] = (int32_t)v;
    }
  }
}

// out[m, n] = ws[0, m, n] + ws[1, m, n] + ..., splits summed in index order.
__global__ void splitk_reduce_i32_kernel(const int32_t* __restrict__ ws,
                                         int32_t* __restrict__ out,
                                         int splits, int M, int N) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  int32_t s = ws[i];
  for (int j = 1; j < splits; ++j) s += ws[(size_t)j * mn + i];
  out[i] = s;
}

template <int M_TILE, int MODE>
void launch_split(const void* y, const void* w, void* ws, int M, int K,
                  int N, int splits, int k_split, bool vec,
                  cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, splits, (M + M_TILE - 1) / M_TILE);
  auto go = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const int8_t*>(y), static_cast<const int8_t*>(w),
        static_cast<int32_t*>(ws), M, K, N, k_split);
  };
  if (vec)
    go(luna_mm_split_kernel<M_TILE, MODE, true>);
  else
    go(luna_mm_split_kernel<M_TILE, MODE, false>);
}

template <int MODE>
void launch_m_tile(int m_tile, const void* y, const void* w, void* ws, int M,
                   int K, int N, int splits, int k_split, bool vec,
                   cudaStream_t s) {
  switch (m_tile) {
    case 1: launch_split<1, MODE>(y, w, ws, M, K, N, splits, k_split, vec, s);
            break;
    case 2: launch_split<2, MODE>(y, w, ws, M, K, N, splits, k_split, vec, s);
            break;
    case 4: launch_split<4, MODE>(y, w, ws, M, K, N, splits, k_split, vec, s);
            break;
    case 8: launch_split<8, MODE>(y, w, ws, M, K, N, splits, k_split, vec, s);
            break;
    default: launch_split<M_TILE_MAX, MODE>(y, w, ws, M, K, N, splits,
                                            k_split, vec, s);
  }
}

}  // namespace

extern "C" {

// Geometry the host must respect; the Python wrapper reads these.
int luna_mm_block_n() { return BN; }
int luna_mm_ksplit_max() { return KSPLIT_MAX; }
int luna_mm_m_tile_max() { return M_TILE_MAX; }

// Launch on `stream`.  mode: 0 conventional, 1 dc/opt_dc, 2 approx_dc,
// 3 approx_dc2.  m_tile in {1, 2, 4, 8, 16}; k_split a multiple of 4,
// <= KSPLIT_MAX.  With splits == 1 the kernel writes `out` and `ws` is not
// read; otherwise ws holds splits*M*N int32.  vec: K % 4 == 0, N % 4 == 0
// and both operands 4-byte aligned.  Returns the cudaError_t of the
// launches (0 = cudaSuccess).
int luna_mm_launch(const void* y, const void* w, void* ws, void* out, int M,
                   int K, int N, int mode, int m_tile, int splits,
                   int k_split, int vec, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || k_split <= 0 ||
      k_split % 4 != 0 || k_split > KSPLIT_MAX ||
      (long long)splits * k_split < K ||
      (long long)(splits - 1) * k_split >= K || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* dst = splits == 1 ? out : ws;
  const bool v = vec != 0;
  switch (mode) {
    case CONVENTIONAL:
      launch_m_tile<CONVENTIONAL>(m_tile, y, w, dst, M, K, N, splits,
                                  k_split, v, s);
      break;
    case DC:
      launch_m_tile<DC>(m_tile, y, w, dst, M, K, N, splits, k_split, v, s);
      break;
    case APPROX_DC:
      launch_m_tile<APPROX_DC>(m_tile, y, w, dst, M, K, N, splits, k_split,
                               v, s);
      break;
    default:
      launch_m_tile<APPROX_DC2>(m_tile, y, w, dst, M, K, N, splits, k_split,
                                v, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  const int threads = 256;
  splitk_reduce_i32_kernel<<<(unsigned)((mn + threads - 1) / threads),
                             threads, 0, s>>>(
      static_cast<const int32_t*>(ws), static_cast<int32_t*>(out), splits, M,
      N);
  return (int)cudaGetLastError();
}

}  // extern "C"
