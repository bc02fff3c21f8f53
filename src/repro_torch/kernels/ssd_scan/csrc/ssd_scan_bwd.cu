// The SSD chunk scan's backward for Hopper (sm_90a): the vector-Jacobian
// product of ssd_scan_tc.cu's forward, f32 FMAs.
//
// Replaces no TPU kernel: JAX differentiates its jnp scan
// (src/repro/models/ssm.py:90 _ssd_chunked) with jax.grad and never its
// Pallas kernel.  The port's forward runs on ssd_scan_tc.cu, so its gradient
// needs a backward of its own; its plain version is
// kernels/ssd_scan/ref.py ssd_scan_bwd_ref, pass for pass.
//
// Per (batch row b, head h) stream and chunk c of Q positions, with dt
// zeroed at masked positions, cum = cumsum(dt a) restarted at each chunk,
// xdt = x dt, L[q][k] = exp(cum_q - cum_k) (q >= k), CB = C B^T,
// seg_end = exp(cum_last - cum), S = the state entering the chunk and Gx =
// dLoss/d(the state leaving it):
//   1. ssd_bwd_adj_kernel: Ploc = sum_q exp(cum_q) dy_q (x) C_q, every chunk
//      in parallel (the mirror of the forward's chunk-local state), and the
//      chunk decay exp(cum_last);
//   2. ssd_bwd_pass_kernel: Gx of the last chunk = dfinal (or 0); in
//      reverse, Gx_{c-1} = decay_c Gx_c + Ploc_c, each chunk's Gx written
//      over its Ploc; d initial_state = decay_0 Gx_0 + Ploc_0.  Elementwise,
//      the only sequential part;
//   3. ssd_bwd_rows_kernel: per 64-row tile of q, D = (dy xdt^T) o L one
//      64 x 64 block of k at a time (never stored in device memory), dC_h =
//      D B + exp(cum) o (dy S) and the row part of d cum: sum_k D CB plus
//      C_q . dC_inter,q;
//   4. ssd_bwd_cols_kernel: per 64-row tile of k, the same D blocks for
//      q >= k, dB_h = D^T C + seg_end o (xdt Gx), dxdt = (CB o L)^T dy +
//      seg_end o (B Gx^T), dx = dt dxdt, <x, dxdt>, and the column part of
//      d cum: -sum_q D CB - T_k, T_k = xdt_k . dxdt_inter,k; the block of
//      tile 0 also takes exp(cum_last) <Gx, S>;
//   5. ssd_bwd_reduce_kernel: per chunk, d cum = the two parts, the last
//      position also taking exp(cum_last) <Gx, S> + sum_k T_k; d(dt a) = its
//      reverse cumsum; ddt = a d(dt a) + <x, dxdt> (0 where masked) and the
//      chunk's share of da = sum dt d(dt a);
//   6. ssd_bwd_group_kernel: dB and dC summed over the heads of each group;
//   7. ssd_bwd_da_kernel: da summed over rows and chunks.
// C B^T and the states entering each chunk are the forward's, read from its
// workspace (ssd_scan_tc_layout): the backward recomputes neither.
//
// What bounds it: the products.  At mamba2-1.3b's widths (H 64, P 64, N 128,
// Q 256) a (2, 4096) call takes ~100 GFLOP as these kernels compute it (the
// 64 x 64 blocks on the diagonal in full) against ~0.6 GB of bytes: far
// above the card's f32 ridge.  This first design runs every product on f32
// FMAs (no tensor cores): each block stages KS-deep slices of its two
// operands in shared memory (k-major, rows padded to an odd stride: no bank
// conflicts on either side) and each thread accumulates a 4 x 4 or 8 x 4
// tile in registers, 256 threads a block.  Tensor cores (3xTF32 mma.sync as
// in the forward) are the obvious next step.
//
// Sums run in a fixed order with no atomics (the per-head dB and dC, the
// chunk sums and da are reduced by kernels 5-7 in index order): two calls on
// the same inputs are bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads over a block tile
constexpr int QMAX = 256;      // largest chunk (one position a thread)
constexpr int PMAX = 64;       // largest head dim
constexpr int NMAX = 128;      // largest state dim
constexpr int TB = 64;         // positions of a row or column tile
constexpr int KS = 32;         // depth of a staged slice
constexpr unsigned FULL = 0xffffffffu;
static_assert(QMAX == THREADS, "one chunk position a thread");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Stages a ROWS x KS operand slice k-major into dst[kk * (ROWS + 1) + r] =
// f(r, kk).  RFAST: neighbouring threads take neighbouring r (the operand is
// contiguous along r in memory), else neighbouring kk.  The odd stride keeps
// both orders free of bank conflicts.
template <int ROWS, bool RFAST, class F>
__device__ __forceinline__ void stage(float* dst, F f) {
  for (int idx = threadIdx.x; idx < ROWS * KS; idx += THREADS) {
    const int r = RFAST ? idx % ROWS : idx / KS;
    const int kk = RFAST ? idx / ROWS : idx % KS;
    dst[kk * (ROWS + 1) + r] = f(r, kk);
  }
}

// acc[i][j] += sum_{k < K} A(m_i, k) B(k, n_j) for the thread's rows m_i =
// tm + 16 i and columns n_j = tn + 16 j (tm = tid % 16, tn = tid / 16): a
// 16 RM x 16 RN block tile.  fa(m, k) and fb(k, n) read the operands (0
// outside the data); AF / BF: the operand is contiguous along m / n.  sa and
// sb hold KS (16 RM + 1) and KS (16 RN + 1) floats.
template <int RM, int RN, bool AF, bool BF, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[RM][RN], int K, float* sa,
                                     float* sb, FA fa, FB fb) {
  constexpr int SA = 16 * RM + 1, SB = 16 * RN + 1;
  const int tm = threadIdx.x & 15, tn = threadIdx.x >> 4;
  for (int k0 = 0; k0 < K; k0 += KS) {
    const int kn = min(KS, K - k0);
    stage<16 * RM, AF>(sa, [&](int m, int kk) {
      return kk < kn ? fa(m, k0 + kk) : 0.f;
    });
    stage<16 * RN, BF>(sb, [&](int n, int kk) {
      return kk < kn ? fb(k0 + kk, n) : 0.f;
    });
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = sa[kk * SA + tm + 16 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = sb[kk * SB + tn + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// The sum over the 16 threads of a half warp (the same tn, every tm), in a
// fixed order; every one of them gets it.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The block's sum of v, in a fixed order; thread 0 gets it.  `red` holds 8
// floats.  Ends with a barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The chunk's masked dt (dtv, 0 at or past its qc real positions) and cum =
// the inclusive cumsum of dt a over QMAX entries (warp scans, then the warp
// totals in order).  Ends with a barrier.
__device__ __forceinline__ void chunk_cum(float* dtv, float* cum, float* wsum,
                                          const float* dt,
                                          const uint8_t* mask, float ah,
                                          long long pos0, int H, int h,
                                          int qc) {
  const int j = threadIdx.x, lane = j & 31, w = j >> 5;
  float v = 0.f;
  if (j < qc) {
    v = dt[(pos0 + j) * H + h];
    if (mask != nullptr && !mask[pos0 + j]) v = 0.f;
  }
  dtv[j] = v;
  float incl = v * ah;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  float base = 0.f;
  for (int k = 0; k < w; ++k) base += wsum[k];
  cum[j] = base + incl;
  __syncthreads();
}

// The chunk and row tile of a block of kernels 3 and 4: tiles of 64
// positions, chunk by chunk (the last chunk has only its real positions').
__device__ __forceinline__ void tile_of(int t, int S, int Q, int nc, int& c,
                                        int& it) {
  const int qt = cdiv(Q, TB);
  if (t < (nc - 1) * qt) {
    c = t / qt;
    it = t % qt;
  } else {
    c = nc - 1;
    it = t - (nc - 1) * qt;
  }
}

// Kernel 1: per (b, chunk, head, 64 x 64 of (N, P)), Ploc[p][n] = sum_q
// dy[q][p] exp(cum_q) C[q][n] over the chunk's real positions, into gx; the
// first tile's block writes the chunk decay exp(cum_last).  Grid (nc, H *
// cdiv(N, 64) * cdiv(P, 64), B).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_adj_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                   const float* __restrict__ Cm,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ dy, float* __restrict__ gx,
                   float* __restrict__ decay, int S, int H, int P, int G,
                   int N, int Q, int nc) {
  __shared__ float dtv[QMAX], cum[QMAX], ec[QMAX], wsum[8];
  __shared__ float sa[KS * 65], sb[KS * 65];
  const int c = blockIdx.x, b = blockIdx.z;
  const int ntiles = cdiv(N, 64), ptiles = cdiv(P, 64);
  const int h = blockIdx.y / (ntiles * ptiles);
  const int n0 = blockIdx.y / ptiles % ntiles * 64;
  const int p0 = blockIdx.y % ptiles * 64;
  const int g = h / (H / G), qc = min(Q, S - c * Q);
  const long long pos0 = (long long)b * S + (long long)c * Q;
  chunk_cum(dtv, cum, wsum, dt, mask, a[h], pos0, H, h, qc);
  ec[threadIdx.x] = threadIdx.x < qc ? expf(cum[threadIdx.x]) : 0.f;
  if (n0 == 0 && p0 == 0 && threadIdx.x == 0)
    decay[((long long)b * nc + c) * H + h] = expf(cum[qc - 1]);
  __syncthreads();

  float acc[4][4];
  zero(acc);
  gemm<4, 4, true, true>(acc, qc, sa, sb,
      [&](int m, int q) {            // A(n, q) = exp(cum_q) C[q][n]
        const int n = n0 + m;
        return n < N ? ec[q] * Cm[((pos0 + q) * G + g) * N + n] : 0.f;
      },
      [&](int q, int j) {            // B(q, p) = dy[q][p]
        const int p = p0 + j;
        return p < P ? dy[((pos0 + q) * H + h) * P + p] : 0.f;
      });
  float* dst = gx + (((long long)b * nc + c) * H + h) * P * N;
  const int tm = threadIdx.x & 15, tn = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tm + 16 * i, p = p0 + tn + 16 * j;
      if (n < N && p < P) dst[(long long)p * N + n] = acc[i][j];
    }
}

// Kernel 2: per element (p, n) of a (b, h) state, in reverse over the
// chunks: Gx = dfinal (or 0); gx[c] <- Gx (was Ploc_c), Gx = decay_c Gx +
// Ploc_c; d initial_state = Gx at the end (where dinit).  Grid (cdiv(P N,
// 256), H, B).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ dfinal, float* __restrict__ gx,
                    const float* __restrict__ decay, float* __restrict__ dinit,
                    int H, int P, int N, int nc) {
  const int pn = P * N, b = blockIdx.z, h = blockIdx.y;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= pn) return;
  const long long e = ((long long)b * H + h) * pn + r;
  float s = dfinal != nullptr ? dfinal[e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long bc = ((long long)b * nc + c) * H + h;
    float* ptr = gx + bc * pn + r;
    const float v = *ptr;
    *ptr = s;
    s = fmaf(decay[bc], s, v);
  }
  if (dinit != nullptr) dinit[e] = s;
}

// Kernel 3: per (b, chunk, head, 64-row tile of q): dC_h[q][n] = exp(cum_q)
// sum_p dy[q][p] S[p][n] + sum_{k <= q} D[q][k] B[k][n] with D = (dy xdt^T)
// o L, one 64 x 64 block of k at a time (staged in shared memory as
// ds[k][q]); and rowpart[q] = sum_k D[q][k] CB[q][k] + C_q . dC_inter,q.  S
// is the state entering the chunk: the initial state (none: 0) for chunk
// 0, the forward's for the rest.  Grid (the chunks' tiles, H, B); NR = 4
// for N <= 64, else 8.
template <int NR>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ init,
                    const float* __restrict__ cb,
                    const float* __restrict__ states,
                    const float* __restrict__ dy, float* __restrict__ dch,
                    float* __restrict__ rowpart, int S, int H, int P, int G,
                    int N, int Q, int nc) {
  __shared__ float dtv[QMAX], cum[QMAX], wsum[8];
  __shared__ float sa[KS * (16 * NR + 1)], sb[KS * 65], ds[TB * 65];
  int c, it;
  tile_of(blockIdx.x, S, Q, nc, c, it);
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int qc = min(Q, S - c * Q), i0 = it * TB;
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const int tm = threadIdx.x & 15, tn = threadIdx.x >> 4;
  chunk_cum(dtv, cum, wsum, dt, mask, a[h], pos0, H, h, qc);
  const float* st =
      c > 0 ? states + (((long long)b * nc + c) * H + h) * P * N
      : init != nullptr ? init + ((long long)b * H + h) * P * N : nullptr;
  auto dyq = [&](int q, int p) {     // dy[q][p], 0 outside the chunk
    return q < qc && p < P ? dy[((pos0 + q) * H + h) * P + p] : 0.f;
  };

  // dC_inter[n][q] = exp(cum_q) sum_p S[p][n] dy[q][p]
  float acc[NR][4];
  zero(acc);
  if (st != nullptr)
    gemm<NR, 4, true, false>(acc, P, sa, sb,
        [&](int n, int p) { return n < N ? st[(long long)p * N + n] : 0.f; },
        [&](int p, int j) { return dyq(i0 + j, p); });
  float inter[4], roww[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = i0 + tn + 16 * j;
    const float e = q < qc ? expf(cum[q]) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int n = tm + 16 * i;
      acc[i][j] *= e;
      if (q < qc && n < N) v += Cm[((pos0 + q) * G + g) * N + n] * acc[i][j];
    }
    inter[j] = half_warp_sum(v);
  }

  const float* cbc = cb + (((long long)b * G + g) * nc + c) * Q * Q;
  for (int kb = 0; kb <= it; ++kb) {
    const int k0 = kb * TB;
    // DX[k][q] = sum_p xdt[k][p] dy[q][p]; D = DX L, masked to k <= q
    float dx[4][4];
    zero(dx);
    gemm<4, 4, false, false>(dx, P, sa, sb,
        [&](int m, int p) {
          const int k = k0 + m;
          return k < qc && p < P ? x[((pos0 + k) * H + h) * P + p] * dtv[k]
                                 : 0.f;
        },
        [&](int p, int j) { return dyq(i0 + j, p); });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tm + 16 * i, ql = tn + 16 * j;
        const int k = k0 + kl, q = i0 + ql;
        float d = 0.f;
        if (k <= q && q < qc) {
          d = dx[i][j] * expf(cum[q] - cum[k]);
          roww[j] = fmaf(d, cbc[(long long)q * Q + k], roww[j]);
        }
        ds[kl * 65 + ql] = d;
      }
    __syncthreads();
    // dC[n][q] += sum_k B[k][n] D[q][k]
    gemm<NR, 4, true, true>(acc, min(TB, qc - k0), sa, sb,
        [&](int n, int kl) {
          return n < N ? Bm[((pos0 + k0 + kl) * G + g) * N + n] : 0.f;
        },
        [&](int kl, int ql) { return ds[kl * 65 + ql]; });
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = i0 + tn + 16 * j;
    const float rw = half_warp_sum(roww[j]);
    if (q >= qc) continue;
    if (tm == 0) rowpart[(pos0 + q) * H + h] = rw + inter[j];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int n = tm + 16 * i;
      if (n < N) dch[((pos0 + q) * H + h) * N + n] = acc[i][j];
    }
  }
}

// Kernel 4: per (b, chunk, head, 64-row tile of k): with se = seg_end,
//   dxdt[k][p] = se_k sum_n Gx[p][n] B[k][n] + sum_{q >= k} CB[q][k]
//                L[q][k] dy[q][p],
//   dB_h[k][n] = se_k sum_p Gx[p][n] xdt[k][p] + sum_{q >= k} D[q][k] C[q][n]
// (D one 64 x 64 block of q at a time, staged as ds[q][k]); dx = dt dxdt,
// xdot = <x_k, dxdt_k>, T_k = xdt_k . dxdt_inter,k and colpart = -sum_q
// D[q][k] CB[q][k] - T_k.  The block of tile 0 writes gsdot = exp(cum_last)
// <Gx, S>.  Grid (the chunks' tiles, H, B).
template <int NR>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_cols_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ init,
                    const float* __restrict__ cb,
                    const float* __restrict__ states,
                    const float* __restrict__ dy, const float* __restrict__ gx,
                    float* __restrict__ dxo, float* __restrict__ dbh,
                    float* __restrict__ colpart, float* __restrict__ tk,
                    float* __restrict__ xdot, float* __restrict__ gsdot,
                    int S, int H, int P, int G, int N, int Q, int nc) {
  __shared__ float dtv[QMAX], cum[QMAX], se[QMAX], wsum[8];
  __shared__ float sa[KS * (16 * NR + 1)], sb[KS * 65], ds[TB * 65];
  int c, it;
  tile_of(blockIdx.x, S, Q, nc, c, it);
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int qc = min(Q, S - c * Q), k0 = it * TB;
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const int tm = threadIdx.x & 15, tn = threadIdx.x >> 4;
  chunk_cum(dtv, cum, wsum, dt, mask, a[h], pos0, H, h, qc);
  const float clast = cum[qc - 1];
  se[threadIdx.x] = threadIdx.x < qc ? expf(clast - cum[threadIdx.x]) : 0.f;
  __syncthreads();
  const float* gs = gx + (((long long)b * nc + c) * H + h) * P * N;
  auto xdt = [&](int k, int p) {     // x[k][p] dt[k], 0 outside the chunk
    return k < qc && p < P ? x[((pos0 + k) * H + h) * P + p] * dtv[k] : 0.f;
  };
  auto dyq = [&](int q, int p) {
    return q < qc && p < P ? dy[((pos0 + q) * H + h) * P + p] : 0.f;
  };

  // the state's terms: dxdt_inter[p][k], then T_k; dB_inter[n][k]
  float ax[4][4], ab[NR][4];
  zero(ax);
  zero(ab);
  gemm<4, 4, false, false>(ax, N, sa, sb,
      [&](int p, int n) { return p < P ? gs[(long long)p * N + n] : 0.f; },
      [&](int n, int j) {
        const int k = k0 + j;
        return k < qc ? Bm[((pos0 + k) * G + g) * N + n] : 0.f;
      });
  float t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + tn + 16 * j;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ax[i][j] *= k < qc ? se[k] : 0.f;
      v = fmaf(xdt(k, tm + 16 * i), ax[i][j], v);
    }
    t[j] = half_warp_sum(v);
  }
  gemm<NR, 4, true, false>(ab, P, sa, sb,
      [&](int n, int p) { return n < N ? gs[(long long)p * N + n] : 0.f; },
      [&](int p, int j) { return xdt(k0 + j, p); });
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + tn + 16 * j;
#pragma unroll
    for (int i = 0; i < NR; ++i) ab[i][j] *= k < qc ? se[k] : 0.f;
  }

  const float* cbc = cb + (((long long)b * G + g) * nc + c) * Q * Q;
  float colw[4] = {0.f, 0.f, 0.f, 0.f};
  for (int qb = it; qb < cdiv(qc, TB); ++qb) {
    const int q0 = qb * TB;
    // DX[q][k] = sum_p dy[q][p] xdt[k][p]; D = DX L, masked to k <= q
    float dd[4][4];
    zero(dd);
    gemm<4, 4, false, false>(dd, P, sa, sb,
        [&](int m, int p) { return dyq(q0 + m, p); },
        [&](int p, int j) { return xdt(k0 + j, p); });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tm + 16 * i, kl = tn + 16 * j;
        const int q = q0 + ql, k = k0 + kl;
        float d = 0.f;
        if (k <= q && q < qc) {
          d = dd[i][j] * expf(cum[q] - cum[k]);
          colw[j] = fmaf(d, cbc[(long long)q * Q + k], colw[j]);
        }
        ds[ql * 65 + kl] = d;
      }
    __syncthreads();
    const int kq = min(TB, qc - q0);
    // dB[n][k] += sum_q C[q][n] D[q][k]
    gemm<NR, 4, true, true>(ab, kq, sa, sb,
        [&](int n, int ql) {
          return n < N ? Cm[((pos0 + q0 + ql) * G + g) * N + n] : 0.f;
        },
        [&](int ql, int kl) { return ds[ql * 65 + kl]; });
    // dxdt[p][k] += sum_q dy[q][p] CB[q][k] L[q][k]
    gemm<4, 4, true, true>(ax, kq, sa, sb,
        [&](int p, int ql) { return dyq(q0 + ql, p); },
        [&](int ql, int kl) {
          const int q = q0 + ql, k = k0 + kl;
          return k <= q && k < qc
                     ? cbc[(long long)q * Q + k] * expf(cum[q] - cum[k])
                     : 0.f;
        });
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + tn + 16 * j;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = tm + 16 * i;
      if (k < qc && p < P) {
        const long long at = ((pos0 + k) * H + h) * P + p;
        v = fmaf(x[at], ax[i][j], v);
        dxo[at] = dtv[k] * ax[i][j];
      }
    }
    const float xd = half_warp_sum(v), cw = half_warp_sum(colw[j]);
    if (k >= qc) continue;
    if (tm == 0) {
      const long long at = (pos0 + k) * H + h;
      xdot[at] = xd;
      tk[at] = t[j];
      colpart[at] = -cw - t[j];
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int n = tm + 16 * i;
      if (n < N) dbh[((pos0 + k) * H + h) * N + n] = ab[i][j];
    }
  }

  if (it != 0) return;
  // gsdot = exp(cum_last) <Gx, S>, S the state entering the chunk
  const float* st =
      c > 0 ? states + (((long long)b * nc + c) * H + h) * P * N
      : init != nullptr ? init + ((long long)b * H + h) * P * N : nullptr;
  float v = 0.f;
  if (st != nullptr)
    for (int e = threadIdx.x; e < P * N; e += THREADS) v = fmaf(gs[e], st[e], v);
  const float dot = block_sum(v, wsum);
  if (threadIdx.x == 0)
    gsdot[((long long)b * nc + c) * H + h] = expf(clast) * dot;
}

// Kernel 5: per (b, chunk, head), one position a thread: d cum = rowpart +
// colpart (the last real position also gsdot + sum_k T_k), d(dt a) = its
// reverse inclusive cumsum, ddt = a d(dt a) + xdot (0 where masked or past
// S), and the chunk's share of da, sum dt d(dt a).  Grid (nc, H, B).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ rowpart,
                      const float* __restrict__ colpart,
                      const float* __restrict__ tk,
                      const float* __restrict__ xdot,
                      const float* __restrict__ gsdot,
                      float* __restrict__ ddt, float* __restrict__ dapart,
                      int S, int H, int Q, int nc) {
  __shared__ float red[8], wsum[8], tsum;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int j = threadIdx.x, lane = j & 31, w = j >> 5;
  const int qc = min(Q, S - c * Q);
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const long long at = (pos0 + j) * H + h;
  const bool real = j < qc;
  const bool live = real && (mask == nullptr || mask[pos0 + j]);
  const float t = block_sum(real ? tk[at] : 0.f, red);
  if (j == 0) tsum = t;
  __syncthreads();
  const long long bc = ((long long)b * nc + c) * H + h;
  float v = real ? rowpart[at] + colpart[at] : 0.f;
  if (j == qc - 1) v += gsdot[bc] + tsum;
  // reverse inclusive scan: thread j sums positions j .. QMAX-1
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += o;
  }
  if (lane == 0) wsum[w] = incl;
  __syncthreads();
  float base = 0.f;
  for (int k = THREADS / 32 - 1; k > w; --k) base += wsum[k];
  const float dda = base + incl;
  const float ah = a[h];
  if (real) ddt[at] = live ? fmaf(ah, dda, xdot[at]) : 0.f;
  const float dtj = live ? dt[at] : 0.f;
  const float share = block_sum(dtj * dda, red);
  if (j == 0) dapart[bc] = share;
}

// Kernel 6: out[b][s][g][n] = sum over the group's heads of part[b][s][h][n],
// in head order, for dB (blockIdx.y = 0) and dC (1).  Grid (cdiv(B S G N,
// 256), 2).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_group_kernel(const float* __restrict__ dbh,
                     const float* __restrict__ dch, float* __restrict__ dB,
                     float* __restrict__ dC, long long total, int H, int G,
                     int N) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const float* part = blockIdx.y == 0 ? dbh : dch;
  float* out = blockIdx.y == 0 ? dB : dC;
  const int n = e % N, g = e / N % G, hg = H / G;
  const long long bs = e / ((long long)N * G);
  const float* src = part + (bs * H + (long long)g * hg) * N + n;
  float s = 0.f;
  for (int k = 0; k < hg; ++k) s += src[(long long)k * N];
  out[e] = s;
}

// Kernel 7: da[h] = sum over (b, chunk) of dapart, in index order.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ dapart,
                                  float* __restrict__ da, int H, int rows) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += dapart[(long long)r * H + h];
  da[h] = s;
}

// Where each piece of the workspace sits (16-byte aligned floats).
struct Plan {
  int nc, tiles;
  size_t gx, dbh, dch, rowpart, colpart, tk, xdot, decay, gsdot, dapart,
      bytes;
};

Plan plan(int batch, int S, int H, int P, int G, int N, int Q) {
  Plan p;
  p.nc = cdiv(S, Q);
  p.tiles = (p.nc - 1) * cdiv(Q, TB) + cdiv(S - (p.nc - 1) * Q, TB);
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += (floats * sizeof(float) + 15) / 16 * 16;
    return at;
  };
  const size_t bsh = (size_t)batch * S * H, bch = (size_t)batch * p.nc * H;
  p.gx = take(bch * P * N);
  p.dbh = take(bsh * N);
  p.dch = take(bsh * N);
  p.rowpart = take(bsh);
  p.colpart = take(bsh);
  p.tk = take(bsh);
  p.xdot = take(bsh);
  p.decay = take(bch);
  p.gsdot = take(bch);
  p.dapart = take(bch);
  p.bytes = off;
  return p;
}

bool valid(int batch, int S, int H, int P, int G, int N, int Q) {
  return batch >= 1 && S >= 1 && H >= 1 && P >= 1 && P <= PMAX && G >= 1 &&
         H % G == 0 && N >= 1 && N <= NMAX && Q >= 1 && Q <= QMAX &&
         batch <= 65535 && H * cdiv(N, 64) * cdiv(P, 64) <= 65535 &&
         cdiv(S, Q) <= 65535;
}

}  // namespace

extern "C" {

int ssd_scan_bwd_qmax() { return QMAX; }
int ssd_scan_bwd_pmax() { return PMAX; }
int ssd_scan_bwd_nmax() { return NMAX; }

// Bytes of the workspace a call of these sizes takes; a cudaError_t.
int ssd_scan_bwd_workspace(int batch, int S, int H, int P, int G, int N,
                           int Q, long long* bytes) {
  if (!valid(batch, S, H, P, G, N, Q)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)plan(batch, S, H, P, G, N, Q).bytes;
  return 0;
}

// The backward of one ssd_scan_tc_launch call on the same x, dt, a, B, C,
// mask and init: cb and states are that call's C B^T and chunk states, at
// ssd_scan_tc_layout's offsets in its workspace (states slot 0 unread: chunk
// 0 enters from init, or 0 where init is null).  dy (B,S,H,P) and dfinal
// (B,H,P,N; null: 0) are the output gradients.  Writes dx (B,S,H,P), ddt
// (B,S,H), da (H), dB and dC (B,S,G,N) and, where dinit is not null, the
// initial state's gradient (B,H,P,N).  ws: a 16-byte aligned buffer of
// ssd_scan_bwd_workspace's bytes.  Launches seven kernels in order on
// `stream`; returns a cudaError_t (0 = launched).
int ssd_scan_bwd_launch(const float* x, const float* dt, const float* a,
                        const float* Bm, const float* Cm, const uint8_t* mask,
                        const float* init, const float* cb,
                        const float* states, const float* dy,
                        const float* dfinal, void* ws, float* dx, float* ddt,
                        float* da, float* dB, float* dC, float* dinit,
                        int batch, int S, int H, int P, int G, int N, int Q,
                        void* stream) {
  if (!valid(batch, S, H, P, G, N, Q)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Plan pl = plan(batch, S, H, P, G, N, Q);
  char* base = static_cast<char*>(ws);
  auto at = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  float *gx = at(pl.gx), *dbh = at(pl.dbh), *dch = at(pl.dch);
  float *rowpart = at(pl.rowpart), *colpart = at(pl.colpart);
  float *tk = at(pl.tk), *xdot = at(pl.xdot), *decay = at(pl.decay);
  float *gsdot = at(pl.gsdot), *dapart = at(pl.dapart);
  const int nc = pl.nc;
  cudaError_t err;

  ssd_bwd_adj_kernel<<<dim3(nc, H * cdiv(N, 64) * cdiv(P, 64), batch),
                       THREADS, 0, st>>>(dt, a, Cm, mask, dy, gx, decay, S, H,
                                         P, G, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_pass_kernel<<<dim3(cdiv(P * N, THREADS), H, batch), THREADS, 0,
                        st>>>(dfinal, gx, decay, dinit, H, P, N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 tiles(pl.tiles, H, batch);
  if (N <= 64) {
    ssd_bwd_rows_kernel<4><<<tiles, THREADS, 0, st>>>(
        x, dt, a, Bm, Cm, mask, init, cb, states, dy, dch, rowpart, S, H, P,
        G, N, Q, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_cols_kernel<4><<<tiles, THREADS, 0, st>>>(
        x, dt, a, Bm, Cm, mask, init, cb, states, dy, gx, dx, dbh, colpart,
        tk, xdot, gsdot, S, H, P, G, N, Q, nc);
  } else {
    ssd_bwd_rows_kernel<8><<<tiles, THREADS, 0, st>>>(
        x, dt, a, Bm, Cm, mask, init, cb, states, dy, dch, rowpart, S, H, P,
        G, N, Q, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_cols_kernel<8><<<tiles, THREADS, 0, st>>>(
        x, dt, a, Bm, Cm, mask, init, cb, states, dy, gx, dx, dbh, colpart,
        tk, xdot, gsdot, S, H, P, G, N, Q, nc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_reduce_kernel<<<dim3(nc, H, batch), THREADS, 0, st>>>(
      dt, a, mask, rowpart, colpart, tk, xdot, gsdot, ddt, dapart, S, H, Q,
      nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)batch * S * G * N;
  ssd_bwd_group_kernel<<<dim3((unsigned)((total + THREADS - 1) / THREADS), 2),
                         THREADS, 0, st>>>(dbh, dch, dB, dC, total, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_da_kernel<<<cdiv(H, THREADS), THREADS, 0, st>>>(dapart, da, H,
                                                          batch * nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
