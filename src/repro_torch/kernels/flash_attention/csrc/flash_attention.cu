// Flash attention forward for Hopper (sm_90a): the online-softmax
// attention of the cacheless full-sequence forward.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:70 flash_attention
// (body _flash_kernel, :24).  q (B*H, S, D), k/v (B*Hkv, S, D), contiguous,
// f32 or bf16; o (B*H, S, D) in q's type.  Head h of batch b reads kv row
// b*Hkv + h / (H/Hkv): GQA never repeats K/V.  As in the TPU kernel:
//   s = (q . k) * sm_scale in f32, the causal mask at -1e30 (not -inf);
//   a running max m, denominator l and accumulator in f32, corrected by
//   exp(m_prev - m_new) per KV tile;  o = acc / max(l, 1e-30).
//
// What bounds it: operations.  Causal attention at yi-9b's heads (B = 2,
// S = 4096, H = 32, D = 128) needs 4 B H S^2 D / 2 = 275 GFLOP against
// 45 MB of q, k, v and o.  The design, simple and right first (f32 FMAs,
// no tensor cores, no TMA):
//   * one block of 256 threads per (64-query tile, b*h); the TPU grid's
//     sequential KV axis becomes a loop inside the block;
//   * the q tile and each 64-row K and V tile are staged in shared memory
//     as f32 (bf16 converted on load; rows past S read as 0); K rows are
//     padded to D + 1 floats so the 16 threads of a row group read 16
//     banks;
//   * thread (ty, tx) of a 16 x 16 grid owns query rows 4 ty .. 4 ty + 3
//     and key columns tx + 16 j (j < 4) of the 64 x 64 score tile, and
//     output columns tx + 16 c (c < D / 16) of its four rows; row maxima
//     and sums reduce over the 16 lanes of the row group by shuffles, and
//     P goes through shared memory to the P V product;
//   * causal KV tiles wholly above the diagonal are skipped, never
//     computed; the heaviest causal query tiles are scheduled first;
//   * expf, not __expf: the kernel holds 2e-5 against the f32 reference.
// Columns past S score -inf (they add exactly 0); rows past S are computed
// and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // key rows per KV tile
constexpr int THREADS = 256;           // a 16 x 16 grid of threads
constexpr int LP = BK + 1;             // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);            // round to nearest even, as torch
}

// Rows [row0, row0 + 64) of a contiguous (S, D) slab into dst (row stride
// ld floats), as f32; rows past S are 0.
template <int D, typename T>
__device__ inline void load_tile(float* dst, int ld, const T* src, int row0,
                                 int S) {
#pragma unroll 4
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    dst[r * ld + d] = row < S ? to_f32(src[(size_t)row * D + d]) : 0.f;
  }
}

// Half-warp (16-lane) reductions: a row group is 16 consecutive lanes.
__device__ inline float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ inline float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // q and k tiles padded to D + 1, the v tile, the P tile
  return sizeof(float) * (2 * BQ * (D + 1) + BK * D + BQ * LP);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, float sm_scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * D;

  const int nq = (S + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const T* qp = q + (size_t)bh * S * D;
  const T* kp = k + (size_t)kvh * S * D;
  const T* vp = v + (size_t)kvh * S * D;
  T* op = o + (size_t)bh * S * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = iq * BQ;

  load_tile<D>(Qs, LD, qp, q0, S);

  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: KV tile j is needed iff j * BK <= q0 + BQ - 1, i.e. j <= iq
  const int nk = causal ? iq + 1 : (S + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();                   // the last tile's K, V, P are read
    load_tile<D>(Ks, LD, kp, k0, S);
    load_tile<D>(Vs, D, vp, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kb[jj] = Ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[i][jj] = fmaf(qa[i], kb[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx + 16 * jj;
        float x = s[i][jj] * sm_scale;
        if (causal && col > row) x = NEG_INF;
        if (col >= S) x = -INFINITY;   // past the sequence: adds exactly 0
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        Ps[(ty * 4 + i) * LP + tx + 16 * jj] = p;
        ps += p;
      }
      l[i] = l[i] * corr + group_sum(ps);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();                   // the P tile is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vb = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(op + (size_t)row * D + tx + 16 * c, acc[i][c] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int H, int Hkv, float sm_scale, int causal,
                   cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, sm_scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int BH, int S, int H, int Hkv, float sm_scale,
                     int causal, cudaStream_t st) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, BH, S, H, Hkv, sm_scale, causal, st);
    case 32: return launch<32, T>(q, k, v, o, BH, S, H, Hkv, sm_scale, causal, st);
    case 64: return launch<64, T>(q, k, v, o, BH, S, H, Hkv, sm_scale, causal, st);
    case 128: return launch<128, T>(q, k, v, o, BH, S, H, Hkv, sm_scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_attention_block_q() { return BQ; }

// q (BH, S, D), k/v (BH / H * Hkv, S, D), o (BH, S, D), contiguous; bf16
// != 0 selects __nv_bfloat16 operands, else float.  Returns a cudaError_t
// (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int BH, int S, int D, int H, int Hkv,
                           float sm_scale, int causal, int bf16,
                           void* stream) {
  if (BH < 1 || S < 1 || H < 1 || Hkv < 1 || BH % H != 0 || H % Hkv != 0 ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, o, BH, S, H, Hkv, sm_scale,
                                     causal, st)
           : launch_d<float>(D, q, k, v, o, BH, S, H, Hkv, sm_scale, causal,
                             st);
  return (int)err;
}

}  // extern "C"
