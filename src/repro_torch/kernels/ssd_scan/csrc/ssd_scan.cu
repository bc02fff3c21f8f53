// SSD chunk scan for Hopper (sm_90a): the prefill state-space scan of the
// mamba2 mixer.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py:81
// ssd_scan (body _ssd_kernel, :32).  Per (batch row b, head h) stream and
// chunk of Q positions, with da = cumsum(dt * a) restarted at each chunk:
//   intra:  Y  = (C B^T ⊙ L) (x dt),  L[i,j] = exp(da[i] - da[j]), i >= j
//   inter:  Y += exp(da) ⊙ (C S)
//   state:  S  = exp(da[Q-1]) S + (exp(da[Q-1] - da) ⊙ B)^T (x dt)
// x (B,S,H,P), dt (B,S,H), a (H,), B/C (B,S,G,N), optional mask (B,S) as
// bytes and initial state (B,H,P,N), all f32 and contiguous; y (B,S,H,P)
// and the final state (B,H,P,N) f32.  Head h reads group h / (H/G) of B
// and C in place (the JAX wrapper repeats them per head: 64x the bytes for
// mamba2's G = 1, H = 64).
//
// What bounds it: f32 operations.  A chunk of Q = 256 does ~Q^2 N / head
// products of chained dependent FMAs, with state N x P = 128 x 64 carried
// from chunk to chunk, so chunks of one stream run in order.  The design,
// simple and right first (no tensor cores, no TMA):
//   * kernel 1 (ssd_cb_kernel) computes C B^T once per (b, group, chunk),
//     causal 32 x 32 tiles only, into a (B, G, nc, Q, Q) f32 workspace
//     that kernel 2's heads all read (L2-resident);
//   * kernel 2 (ssd_scan_kernel): one block per (P-tile of 32 columns,
//     head, batch row) walks the chunks in order, keeping its 32 columns
//     of the state (N x 32 f32) in shared memory.  Per chunk it stages dt,
//     the chunk-local cumsum (a warp scan) and x*dt (Q x 32) in shared
//     memory, then tiles Q in 32-row tiles: C tiles for C S, masked-decay
//     tiles (the upper triangle is skipped, never exponentiated) for the
//     intra product, B tiles scaled by exp(da_last - da) for the state
//     update; every product is f32 FMAs with one operand broadcast from
//     shared memory;
//   * ragged S and any Q <= 256 (not only powers of two): positions past
//     S, and past Q in a chunk's last tile, are read as dt = 0, x = B =
//     C = 0 in registers; nothing is padded in device memory.  The mask
//     zeroes dt, so masked positions freeze the state, as in JAX.
// The cumsum's parallel order differs from jnp.cumsum's sequential one by
// f32 rounding; chunk_decay and seg_end use the chunk's own last value
// (pad included, which equals the last real one since pad dt = 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int T = 32;          // positions per tile
constexpr int PT = 32;         // head-dim columns per block
constexpr int SP = PT + 1;     // padded row stride of smem [.][PT+1] tiles
constexpr int QMAX = 256;      // largest chunk
constexpr int NMAX = 128;      // largest state dim
constexpr int NSLAB = 64;      // state dims per smem slab in kernel 1
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// cb[(b*G + g)*nc + c][i][j] = sum_n C[b, c*Q+i, g, n] * B[b, c*Q+j, g, n]
// for the causal 32 x 32 tiles (tile j <= tile i); rows/columns past S are 0.
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int G, int N, int Q, int nc) {
  const int it = blockIdx.y, jt = blockIdx.z;
  if (jt > it) return;
  const int z = blockIdx.x;                  // (b*G + g)*nc + c
  const int c = z % nc;
  const int g = (z / nc) % G;
  const int b = z / nc / G;
  __shared__ float cs[T][NSLAB + 1];
  __shared__ float bs[T][NSLAB + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ci = c * Q + it * T, cj = c * Q + jt * T;
  const int ilim = min(T, Q - it * T), jlim = min(T, Q - jt * T);
  float acc[T / WARPS];
#pragma unroll
  for (int q = 0; q < T / WARPS; ++q) acc[q] = 0.f;
  for (int n0 = 0; n0 < N; n0 += NSLAB) {
    const int nn = min(NSLAB, N - n0);
    for (int idx = tid; idx < T * NSLAB; idx += THREADS) {
      const int r = idx / NSLAB, k = idx % NSLAB;
      float cv = 0.f, bv = 0.f;
      if (k < nn) {
        if (r < ilim && ci + r < S)
          cv = Cm[((size_t)(b * S + ci + r) * G + g) * N + n0 + k];
        if (r < jlim && cj + r < S)
          bv = Bm[((size_t)(b * S + cj + r) * G + g) * N + n0 + k];
      }
      cs[r][k] = cv;
      bs[r][k] = bv;
    }
    __syncthreads();
    for (int k = 0; k < nn; ++k) {
      const float bv = bs[lane][k];
#pragma unroll
      for (int q = 0; q < T / WARPS; ++q)
        acc[q] = fmaf(cs[warp + WARPS * q][k], bv, acc[q]);
    }
    __syncthreads();
  }
  float* out = cb + (size_t)z * Q * Q;
#pragma unroll
  for (int q = 0; q < T / WARPS; ++q) {
    const int r = warp + WARPS * q;
    if (r < ilim && lane < jlim)
      out[(size_t)(it * T + r) * Q + jt * T + lane] = acc[q];
  }
}

// NPW: state rows (n) per warp in the state update, >= ceil(N / WARPS).
template <int NPW>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ Bm,
                const float* __restrict__ Cm,
                const uint8_t* __restrict__ mask,
                const float* __restrict__ init, const float* __restrict__ cb,
                float* __restrict__ y, float* __restrict__ fstate, int S,
                int H, int P, int G, int N, int Q, int nc) {
  extern __shared__ float smem[];
  const int qp = round_up(Q, T);
  float* st = smem;                 // [N][SP]  state S[n][p]
  float* xdt = st + N * SP;         // [qp][PT] x * dt of the chunk
  float* tile = xdt + qp * PT;      // [T][N]   C or scaled B tile
  float* lm = tile + T * N;         // [T][SP]  masked decay ⊙ C B^T tile
  float* da = lm + T * SP;          // [qp]     chunk-local cumsum(dt * a)
  float* dtv = da + qp;             // [qp]     dt (masked, 0 past S and Q)
  float* se = dtv + qp;             // [qp]     exp(da_last - da)

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int pw = min(PT, P - p0);
  const float ah = a[h];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntile = qp / T;

  for (int idx = tid; idx < N * PT; idx += THREADS) {
    const int n = idx % N, p = idx / N;
    st[n * SP + p] = (init != nullptr && p < pw)
        ? init[(((size_t)b * H + h) * P + p0 + p) * N + n] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const float* cbp = cb + ((size_t)(b * G + g) * nc + c) * Q * Q;
    for (int j = tid; j < qp; j += THREADS) {
      float v = 0.f;
      const int pos = c0 + j;
      if (j < Q && pos < S) {
        v = dt[((size_t)b * S + pos) * H + h];
        if (mask != nullptr && !mask[(size_t)b * S + pos]) v = 0.f;
      }
      dtv[j] = v;
    }
    __syncthreads();
    if (warp == 0) {                 // inclusive scan of dt * a over qp
      const int per = qp / 32;       // 1..8 consecutive entries a lane
      float loc[QMAX / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k)
        if (k < per) {
          run += dtv[lane * per + k] * ah;
          loc[k] = run;
        }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k)
        if (k < per) da[lane * per + k] = excl + loc[k];
    }
    __syncthreads();
    const float da_last = da[qp - 1];
    for (int j = tid; j < qp; j += THREADS) se[j] = expf(da_last - da[j]);
    for (int idx = tid; idx < qp * PT; idx += THREADS) {
      const int j = idx / PT, p = idx % PT;
      const int pos = c0 + j;
      float v = 0.f;
      if (j < Q && pos < S && p < pw)
        v = x[(((size_t)b * S + pos) * H + h) * P + p0 + p] * dtv[j];
      xdt[j * PT + p] = v;
    }
    __syncthreads();

    // outputs, one 32-row tile at a time; thread (warp, lane) owns rows
    // warp + 8q (q < 4) of column lane
    for (int it = 0; it < ntile; ++it) {
      for (int idx = tid; idx < T * N; idx += THREADS) {
        const int r = idx / N, n = idx % N;
        const int i = it * T + r, pos = c0 + i;
        tile[idx] = (i < Q && pos < S)
            ? Cm[((size_t)(b * S + pos) * G + g) * N + n] : 0.f;
      }
      __syncthreads();
      float acc[T / WARPS];
#pragma unroll
      for (int q = 0; q < T / WARPS; ++q) acc[q] = 0.f;
      for (int n = 0; n < N; ++n) {            // inter: C S_prev
        const float sv = st[n * SP + lane];
#pragma unroll
        for (int q = 0; q < T / WARPS; ++q)
          acc[q] = fmaf(tile[(warp + WARPS * q) * N + n], sv, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < T / WARPS; ++q)
        acc[q] *= expf(da[it * T + warp + WARPS * q]);
      for (int jt = 0; jt <= it; ++jt) {       // intra: causal tiles only
        __syncthreads();
        for (int idx = tid; idx < T * T; idx += THREADS) {
          const int r = idx / T, jj = idx % T;
          const int i = it * T + r, j = jt * T + jj;
          float v = 0.f;
          if (i < Q && j <= i)
            v = cbp[(size_t)i * Q + j] * expf(da[i] - da[j]);
          lm[r * SP + jj] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < T; ++jj) {
          const float xv = xdt[(jt * T + jj) * PT + lane];
#pragma unroll
          for (int q = 0; q < T / WARPS; ++q)
            acc[q] = fmaf(lm[(warp + WARPS * q) * SP + jj], xv, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < T / WARPS; ++q) {
        const int i = it * T + warp + WARPS * q, pos = c0 + i;
        if (i < Q && pos < S && lane < pw)
          y[(((size_t)b * S + pos) * H + h) * P + p0 + lane] = acc[q];
      }
      __syncthreads();
    }

    // state update; thread (warp, lane) owns rows n = warp + 8k of column
    // lane
    float sacc[NPW];
#pragma unroll
    for (int k = 0; k < NPW; ++k) sacc[k] = 0.f;
    for (int jt = 0; jt < ntile; ++jt) {
      for (int idx = tid; idx < T * N; idx += THREADS) {
        const int r = idx / N, n = idx % N;
        const int j = jt * T + r, pos = c0 + j;
        tile[idx] = (j < Q && pos < S)
            ? Bm[((size_t)(b * S + pos) * G + g) * N + n] * se[j] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < T; ++jj) {
        const float xv = xdt[(jt * T + jj) * PT + lane];
#pragma unroll
        for (int k = 0; k < NPW; ++k) {
          const int n = warp + WARPS * k;
          if (n < N) sacc[k] = fmaf(tile[jj * N + n], xv, sacc[k]);
        }
      }
      __syncthreads();
    }
    const float decay = expf(da_last);
#pragma unroll
    for (int k = 0; k < NPW; ++k) {
      const int n = warp + WARPS * k;
      if (n < N) st[n * SP + lane] = st[n * SP + lane] * decay + sacc[k];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < N * PT; idx += THREADS) {
    const int n = idx % N, p = idx / N;
    if (p < pw)
      fstate[(((size_t)b * H + h) * P + p0 + p) * N + n] = st[n * SP + p];
  }
}

size_t scan_smem_bytes(int N, int Q) {
  const int qp = round_up(Q, T);
  return sizeof(float) * ((size_t)N * SP + (size_t)qp * PT + (size_t)T * N
                          + (size_t)T * SP + 3 * (size_t)qp);
}

template <int NPW>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t stream,
                        const float* x, const float* dt, const float* a,
                        const float* Bm, const float* Cm,
                        const uint8_t* mask, const float* init,
                        const float* cb, float* y, float* fstate, int S,
                        int H, int P, int G, int N, int Q, int nc) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<NPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<NPW><<<grid, THREADS, smem, stream>>>(
      x, dt, a, Bm, Cm, mask, init, cb, y, fstate, S, H, P, G, N, Q, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ssd_scan_qmax() { return QMAX; }
int ssd_scan_nmax() { return NMAX; }

// cb: (batch, G, nc, Q, Q) f32 workspace, nc = ceil(S / Q).  Returns a
// cudaError_t (0 = launched).
int ssd_scan_launch(const float* x, const float* dt, const float* a,
                    const float* Bm, const float* Cm, const uint8_t* mask,
                    const float* init, float* cb, float* y, float* fstate,
                    int batch, int S, int H, int P, int G, int N, int Q,
                    void* stream) {
  if (batch < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 ||
      N < 1 || N > NMAX || Q < 1 || Q > QMAX || H > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nc = (S + Q - 1) / Q;
  const int qt = round_up(Q, T) / T;
  ssd_cb_kernel<<<dim3(batch * G * nc, qt, qt), THREADS, 0, st>>>(
      Bm, Cm, cb, S, G, N, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + PT - 1) / PT, H, batch);
  const size_t smem = scan_smem_bytes(N, Q);
  const int npw = (N + WARPS - 1) / WARPS;
  if (npw <= 4)
    err = launch_scan<4>(grid, smem, st, x, dt, a, Bm, Cm, mask, init, cb, y,
                         fstate, S, H, P, G, N, Q, nc);
  else
    err = launch_scan<16>(grid, smem, st, x, dt, a, Bm, Cm, mask, init, cb,
                          y, fstate, S, H, P, G, N, Q, nc);
  return (int)err;
}

}  // extern "C"
