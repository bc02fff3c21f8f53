// LUT GEMMs for Hopper (sm_90a): the frozen 4-bit decode projections of
// the serving engine (D&C) and the model-level lut_nf4 mode (full table).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/lut_gemm/lut_gemm.py:
//   * lut_gemm_dc      (_lut_gemm_dc_kernel, _dc_mux_dequant):
//       out = (x @ (HI[q>>2] + LO[q&3] - zp)) * scale
//   * lut_gemm_dc_res  (_lut_gemm_dc_res_kernel):
//       out = (x @ (HI[q>>2] + LO[q&3] + RES[q] - zp)) * scale
//   * lut_gemm         (_lut_gemm_kernel, _mux_tree_dequant):
//       out = (x @ CB[q]) * scale, the full 16-entry codebook (paper Fig 1)
// x (M, K) bf16 or f32; codes (K, N) int8 in [0, 16), one per byte;
// hi/lo (4,) f32; res and cb (16,) f32; zp, scale (N,) f32; out (M, N) f32.
//
// What bounds it: memory bytes.  In decode M is the engine's max_batch
// (1-32), so each code byte read from device memory feeds only 2*M flops;
// the (K, N) codes are the traffic (a full yi-9b decode step reads ~8.3 GB
// of them).  The design therefore spends nothing on the tensor cores and
// everything on streaming the codes once:
//   * each block owns a strip of BN = 512 columns and one slice of K
//     (split-K over gridDim.y, so even N = 512 fills the card); each thread
//     owns 4 neighbouring columns and reads their 4 code bytes of a K row as
//     one 32-bit load, so a warp reads 128 contiguous bytes per row;
//   * the block's x rows for its K-slice are staged once in shared memory
//     (converted to f32); each thread keeps acc[M_TILE][4] in f32 registers;
//   * dequant is the paper's 6-select D&C mux: two 4-way selects on the
//     2-bit digits from HI/LO held in registers, plus (dc_res) the per-code
//     residual gathered from a 16-entry shared table, then w = w_q - zp[n].
//     The residual is read for every code, pruned (zero) or not: no branch.
//     The full-table variant reads w = CB[q] from a 16-entry shared table
//     (the Pallas kernel's 15-select mux tree evaluates the same gather)
//     and has no zero point;
//   * split-K partial sums go to an f32 workspace (splits, M, N); a second
//     small kernel sums the splits in a FIXED order and multiplies by
//     scale[n], so results are deterministic and need no atomics;
//   * ragged M, N and K are masked in the kernel: no padding.
// Making it fast (two codes per byte, TMA, wgmma for larger M) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4;                   // code bytes (columns) per thread
constexpr int BN = THREADS * COLS;        // columns per block
constexpr int KSPLIT_MAX = 1024;          // K rows per block, at most
constexpr int M_TILE_MAX = 8;             // x rows per block, at most

// how a code becomes a weight: D&C sub-tables, D&C + residual, full table
enum Table : int { TAB_DC = 0, TAB_DC_RES = 1, TAB_FULL = 2 };

__device__ __forceinline__ float sel4(int i, float t0, float t1, float t2,
                                      float t3) {
  // 3 two-way selects on the 2-bit digit (the paper's sub-table mux)
  const float a = (i & 1) ? t1 : t0;
  const float b = (i & 1) ? t3 : t2;
  return (i & 2) ? b : a;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int M_TILE, int TAB, bool VEC, typename XT>
__global__ void __launch_bounds__(THREADS)
lut_gemm_dc_split_kernel(const XT* __restrict__ x,
                         const int8_t* __restrict__ codes,
                         const float* __restrict__ hi,
                         const float* __restrict__ lo,
                         const float* __restrict__ res,
                         const float* __restrict__ zp,
                         float* __restrict__ ws, int M, int K, int N,
                         int k_split) {
  __shared__ float xs[M_TILE * KSPLIT_MAX];
  __shared__ float res_s[16];              // residual, or the codebook

  const int n0 = (blockIdx.x * THREADS + threadIdx.x) * COLS;
  const int k0 = blockIdx.y * k_split;
  const int kn = min(k_split, K - k0);
  const int m0 = blockIdx.z * M_TILE;

  for (int i = threadIdx.x; i < M_TILE * kn; i += THREADS) {
    const int m = i / kn;
    const int kk = i - m * kn;
    xs[m * KSPLIT_MAX + kk] =
        (m0 + m < M) ? to_f32(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
  }
  if (TAB != TAB_DC && threadIdx.x < 16) res_s[threadIdx.x] = res[threadIdx.x];
  __syncthreads();
  if (n0 >= N) return;

  float h0 = 0.f, h1 = 0.f, h2 = 0.f, h3 = 0.f;
  float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
  float z[COLS] = {0.f, 0.f, 0.f, 0.f};
  if (TAB != TAB_FULL) {
    h0 = hi[0]; h1 = hi[1]; h2 = hi[2]; h3 = hi[3];
    l0 = lo[0]; l1 = lo[1]; l2 = lo[2]; l3 = lo[3];
#pragma unroll
    for (int c = 0; c < COLS; ++c) z[c] = (n0 + c < N) ? zp[n0 + c] : 0.f;
  }

  float acc[M_TILE][COLS];
#pragma unroll
  for (int m = 0; m < M_TILE; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  const int8_t* cp = codes + (size_t)k0 * N + n0;
#pragma unroll 4
  for (int kk = 0; kk < kn; ++kk, cp += N) {
    uint32_t word;
    if (VEC) {
      // N % 4 == 0 and a 4-byte aligned base: n0..n0+3 are in range
      word = __ldg(reinterpret_cast<const uint32_t*>(cp));
    } else {
      word = 0;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (n0 + c < N) word |= (uint32_t)(uint8_t)cp[c] << (8 * c);
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int q = (word >> (8 * c)) & 0xF;
      float w;
      if (TAB == TAB_FULL) {
        w = res_s[q];
      } else {
        float w_q = sel4(q >> 2, h0, h1, h2, h3) + sel4(q & 3, l0, l1, l2, l3);
        if (TAB == TAB_DC_RES) w_q = w_q + res_s[q];
        w = w_q - z[c];
      }
#pragma unroll
      for (int m = 0; m < M_TILE; ++m)
        acc[m][c] = fmaf(xs[m * KSPLIT_MAX + kk], w, acc[m][c]);
    }
  }

  float* wp = ws + ((size_t)blockIdx.y * M + m0) * N + n0;
#pragma unroll
  for (int m = 0; m < M_TILE; ++m) {
    if (m0 + m >= M) break;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (n0 + c < N) wp[(size_t)m * N + c] = acc[m][c];
  }
}

// out[m, n] = (ws[0, m, n] + ws[1, m, n] + ... ) * scale[n], splits summed
// in index order (deterministic).
__global__ void splitk_reduce_scale_kernel(const float* __restrict__ ws,
                                           const float* __restrict__ scale,
                                           float* __restrict__ out,
                                           int splits, int M, int N) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = ws[i];
  for (int j = 1; j < splits; ++j) s += ws[(size_t)j * mn + i];
  out[i] = s * scale[i % N];
}

template <int M_TILE, int TAB, typename XT>
void launch_split(const void* x, const void* codes, const void* hi,
                  const void* lo, const void* res, const void* zp, void* ws,
                  int M, int K, int N, int splits, int k_split, bool vec,
                  cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, splits, (M + M_TILE - 1) / M_TILE);
  auto go = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const XT*>(x), static_cast<const int8_t*>(codes),
        static_cast<const float*>(hi), static_cast<const float*>(lo),
        static_cast<const float*>(res), static_cast<const float*>(zp),
        static_cast<float*>(ws), M, K, N, k_split);
  };
  if (vec)
    go(lut_gemm_dc_split_kernel<M_TILE, TAB, true, XT>);
  else
    go(lut_gemm_dc_split_kernel<M_TILE, TAB, false, XT>);
}

template <int TAB, typename XT>
void launch_m_tile(int m_tile, const void* x, const void* codes,
                   const void* hi, const void* lo, const void* res,
                   const void* zp, void* ws, int M, int K, int N, int splits,
                   int k_split, bool vec, cudaStream_t stream) {
  switch (m_tile) {
    case 1: launch_split<1, TAB, XT>(x, codes, hi, lo, res, zp, ws, M, K, N,
                                     splits, k_split, vec, stream);
            break;
    case 2: launch_split<2, TAB, XT>(x, codes, hi, lo, res, zp, ws, M, K, N,
                                     splits, k_split, vec, stream);
            break;
    case 4: launch_split<4, TAB, XT>(x, codes, hi, lo, res, zp, ws, M, K, N,
                                     splits, k_split, vec, stream);
            break;
    default: launch_split<M_TILE_MAX, TAB, XT>(x, codes, hi, lo, res, zp,
                                               ws, M, K, N, splits, k_split,
                                               vec, stream);
  }
}

template <int TAB>
int launch_all(const void* x, int x_is_bf16, const void* codes,
               const void* hi, const void* lo, const void* res,
               const void* zp, const void* scale, void* ws, void* out, int M,
               int K, int N, int m_tile, int splits, int k_split, int vec,
               cudaStream_t s) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || k_split <= 0 ||
      k_split > KSPLIT_MAX || (long long)splits * k_split < K ||
      (long long)(splits - 1) * k_split >= K)
    return (int)cudaErrorInvalidValue;
  const bool v = vec != 0;
  if (x_is_bf16)
    launch_m_tile<TAB, __nv_bfloat16>(m_tile, x, codes, hi, lo, res, zp, ws,
                                      M, K, N, splits, k_split, v, s);
  else
    launch_m_tile<TAB, float>(m_tile, x, codes, hi, lo, res, zp, ws, M, K, N,
                              splits, k_split, v, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t mn = (size_t)M * N;
  const int threads = 256;
  splitk_reduce_scale_kernel<<<(unsigned)((mn + threads - 1) / threads),
                               threads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<float*>(out), splits, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the host must respect; the Python wrapper reads these.
int lut_gemm_block_n() { return BN; }
int lut_gemm_ksplit_max() { return KSPLIT_MAX; }
int lut_gemm_m_tile_max() { return M_TILE_MAX; }

// Launch both kernels on `stream`.  `res` may be NULL (lut_gemm_dc).
// m_tile in {1, 2, 4, 8}; k_split <= KSPLIT_MAX; ws holds splits*M*N f32.
// Returns the cudaError_t of the launches (0 = cudaSuccess).
int lut_gemm_dc_launch(const void* x, int x_is_bf16, const void* codes,
                       const void* hi, const void* lo, const void* res,
                       const void* zp, const void* scale, void* ws, void* out,
                       int M, int K, int N, int m_tile, int splits,
                       int k_split, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr)
    return launch_all<TAB_DC_RES>(x, x_is_bf16, codes, hi, lo, res, zp,
                                  scale, ws, out, M, K, N, m_tile, splits,
                                  k_split, vec, s);
  return launch_all<TAB_DC>(x, x_is_bf16, codes, hi, lo, res, zp, scale, ws,
                            out, M, K, N, m_tile, splits, k_split, vec, s);
}

// The full-table variant: cb (16,) f32 codebook, no sub-tables or zero
// point; otherwise as lut_gemm_dc_launch.
int lut_gemm_full_launch(const void* x, int x_is_bf16, const void* codes,
                         const void* cb, const void* scale, void* ws,
                         void* out, int M, int K, int N, int m_tile,
                         int splits, int k_split, int vec, void* stream) {
  return launch_all<TAB_FULL>(x, x_is_bf16, codes, nullptr, nullptr, cb,
                              nullptr, scale, ws, out, M, K, N, m_tile,
                              splits, k_split, vec,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
