// SSD chunk scan for Hopper (sm_90a) on the TF32 tensor cores: the prefill
// state-space scan of the mamba2 mixer.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py:81
// ssd_scan (body _ssd_kernel, :32).  Per (batch row b, head h) stream and
// chunk c of Q positions, with da = cumsum(dt * a) restarted at each chunk:
//   intra:  Y  = (C B^T ⊙ L) (x dt),  L[i,j] = exp(da[i] - da[j]), i >= j
//   inter:  Y += exp(da) ⊙ (C S_enter[c])
//   state:  S_enter[c+1] = exp(da[Q-1]) S_enter[c] + Sloc[c],
//           Sloc[c] = (exp(da[Q-1] - da) ⊙ B)^T (x dt)
// x (B,S,H,P), dt (B,S,H), a (H,), B/C (B,S,G,N), optional mask (B,S) as
// bytes and initial state (B,H,P,N), all f32 and contiguous; y (B,S,H,P)
// and the final state (B,H,P,N) f32.  Head h reads group h / (H/G) of B
// and C in place.
//
// What bounds it: the four products (C B^T, the chunk-local state, the
// inter and intra products) are nearly all of the work, 1.1 GFLOP for
// mamba2's 448-token prefill call against 19 MB of bytes.  The TPU kernel
// walks a stream's chunks in order with the state in VMEM; here only the
// state recurrence is sequential, and it is elementwise.  One call is four
// kernels:
//   1. ssd_cb_kernel: C B^T once per (b, group, chunk), causal 64 x 64
//      tiles only (the grid enumerates them; no block exits at once), into
//      a (B, G, nc, Q, Q) workspace that every head of the group reads
//      from L2.  It runs on a side stream forked from the caller's, beside
//      kernels 2 and 3;
//   2. ssd_chunk_state_kernel: one block per (b, chunk, head, 64 x 64 of
//      (P, N), or 64 x 128 where that still gives two blocks an SM): the
//      chunk's masked dt, its cumsum da (a block scan), seg_end =
//      exp(da[Q-1] - da), the chunk-local state Sloc^T = (x dt)^T (seg_end
//      ⊙ B) (P x N over K = the chunk's positions) into a (B, nc, H, P, N)
//      workspace and the chunk decay exp(da[Q-1]) into (B, nc, H);
//   3. ssd_state_pass_kernel: one thread per 4 elements of (b, h, p, n)
//      walks the chunks in order, overwriting Sloc[c] (c > 0) with S
//      entering chunk c and writing the final state; chunk 0's entering
//      state is the initial state itself (or zero), read in place.  The
//      only sequential part, bound by bytes;
//   4. ssd_chunk_out_kernel: one block per (b, chunk, head, 64-row tile,
//      P-tile of 64 columns, or 32 where a call has fewer than two blocks
//      an SM): y = (C S_enter) ⊙ exp(da) + (CB ⊙ L)(x dt) in one
//      accumulator: K runs over N state dims, the accumulator's rows are
//      scaled by exp(da), then K runs over the causal positions of the
//      tile's columns; L is built from da (the block's own cumsum) as the
//      tile is staged, masked before exp, never stored in device memory;
//      tiles above the diagonal are never computed.  A block of chunk 0
//      whose slice of the initial state is all zero skips C S_enter (C 0 =
//      +0 exactly: the same bits).  Chunk 0 needs nothing of kernels 2 and
//      3, so its tiles run on the side stream after kernel 1, beside them;
//      the other chunks' tiles follow kernel 3 on the caller's stream, and
//      the side stream is joined back at the end.
// Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (4 warps, 2
// x 2 over a 64-row tile, 32 rows a warp) with the 3xTF32 split: hi =
// tf32(a), lo = tf32(a - hi), both rounded as cvt.rna.tf32.f32 rounds, so a
// = hi + lo within 2^-22 |a|; three MMAs into one f32 accumulator, small
// terms first (lo·hi, hi·lo, hi·hi; lo·lo dropped): f32 accuracy (a single
// TF32 product misses KERNEL_TOL by 5x at mamba2's widths).  mma.sync and
// not wgmma: TF32 wgmma needs both operands K-major in shared memory,
// where x dt and B are position-major and the lo parts double the tiles.
// Staging: a block's K loop runs in 32-deep stages over two stage buffers;
// each thread loads its share of the next stage's operand tiles into
// registers (16-byte loads where every row is 16-byte aligned, else 4)
// while the warps run the current stage's MMAs, then applies the operand's
// scale (dt, seg_end, the masked decay L), splits each element once and
// stores hi and lo tiles into the other buffer in the layout the data
// arrives in ([row][k] or [k][row]), row strides padded so that fragment
// loads are free of bank conflicts (4 mod 32 where a fragment reads along a
// row, 8 mod 32 down a column); one barrier a stage.  Each element is
// transformed and split once a block; the MMA loop only loads fragments.
// Results leave through shared memory as whole rows (16-byte stores).
// Ragged edges: positions past S, past Q in a chunk's last tile, and past
// P or N read as zero in registers; nothing is padded in device memory.  A
// masked position has dt = 0, so the state freezes through it, as in JAX.
// Sums run in a fixed order with no atomics: two calls on the same inputs
// are bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // 4 warps, 2 x 2 over a 64-row tile
constexpr int PASS_THREADS = 256;   // kernel 3
constexpr int QMAX = 256;           // largest chunk
constexpr int NMAX = 128;           // largest state dim
constexpr int TM = 64;              // rows of an output tile
constexpr int TN = 64;              // columns of a cb tile
constexpr int KS = 32;              // depth of a stage
constexpr int S4 = KS + 4;          // stride of [64][KS] tiles (4 mod 16)
constexpr int S8 = TM + 8;          // stride of [KS][64] tiles (8 mod 32)
constexpr int TILE = TM * S4;       // floats of one split tile (>= KS * S8)
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE >= KS * S8, "both layouts of a tile fit one slot");
static_assert(QMAX == 2 * THREADS, "the cumsum takes two entries a thread");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The 3xTF32 split: hi = tf32(a), lo = tf32(a - hi), each rounded to
// nearest with ties away from zero as cvt.rna.tf32.f32 rounds (half a TF32
// ulp added to the bits, the 13 low bits cleared): a = hi + lo within
// 2^-22 |a|.  Integer ops run at full rate; the cvt instruction was slower.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(a - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A ROWS x COLS f32 tile (COLS contiguous) staged in registers, one float4
// a thread per 512 elements: slot q holds row (tid + 128 q) / (COLS / 4),
// columns 4 ((tid + 128 q) % (COLS / 4)) + 0..3.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int R = ROWS * COLS / (4 * THREADS);
  static_assert(R >= 1, "a tile is at least a float4 a thread");
  __device__ __forceinline__ static int row(int q) {
    return (threadIdx.x + THREADS * q) / (COLS / 4);
  }
  __device__ __forceinline__ static int col(int q) {
    return (threadIdx.x + THREADS * q) % (COLS / 4) * 4;
  }

  // Row r at g + r * ld; rows at or past rv and columns at or past cv read
  // as 0 (nothing is read there).  16-byte loads where `vec`.
  template <int RV>
  __device__ __forceinline__ static void load(float4 (&v)[RV], const float* g,
                                              long long ld, int rv, int cv,
                                              bool vec) {
    static_assert(R <= RV, "too few registers for the tile");
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = row(q), c = col(q), left = cv - c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rv && left > 0) {
        const float* p = g + r * ld + c;
        if (vec && left >= 4) {
          x = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          x.x = __ldg(p);
          if (left > 1) x.y = __ldg(p + 1);
          if (left > 2) x.z = __ldg(p + 2);
          if (left > 3) x.w = __ldg(p + 3);
        }
      }
      v[q] = x;
    }
  }

  // f(r, c, v) transforms each float4; its split parts go to hi and lo at
  // [r][c] (row stride ss).
  template <int RV, class F>
  __device__ __forceinline__ static void store(const float4 (&v)[RV],
                                               float* hi, float* lo, int ss,
                                               F f) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = row(q), c = col(q);
      const float4 x = f(r, c, v[q]);
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + r * ss + c) = h;
      *reinterpret_cast<uint4*>(lo + r * ss + c) = l;
    }
  }
};

struct Identity {
  __device__ __forceinline__ float4 operator()(int, int, float4 v) const {
    return v;
  }
};

// Scales row r of a [KS][.] tile by d[r] (x dt, B seg_end).
struct ScaleRows {
  const float* d;
  __device__ __forceinline__ float4 operator()(int r, int, float4 v) const {
    const float s = d[r];
    return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
  }
};

// Floats of a split B tile of 16 WN columns ([KS][16 WN + 8] or
// [16 WN][S4]), at least one TILE.
template <int WN>
__host__ __device__ constexpr int btile() {
  return KS * (16 * WN + 8) > TILE ? KS * (16 * WN + 8) : TILE;
}

// Floats of a stage buffer: A hi, A lo, B hi, B lo.
template <int WN>
__host__ __device__ constexpr int bufsz() {
  return 2 * TILE + 2 * btile<WN>();
}

// The MMAs of one stage for warp (wm, wn) = (w >> 1, w & 1): its 32 x 8 WN
// slab of a 64 x 16 WN tile, over the stage's first `ksteps` 8-deep steps.
// The split tiles in `buf`: A hi, A lo (stored [row][k], stride S4, or
// where AK [k][row], stride S8; TILE floats each), B hi, B lo (stored
// [k][col], stride 16 WN + 8, where BK, else [col][k], stride S4;
// btile<WN>() floats each).  Three MMAs a product, the
// small terms first, each pass across the slab's 2 x WN accumulators.
template <bool AK, bool BK, int WN>
__device__ __forceinline__ void mma_stage(float (&acc)[2][WN][4],
                                          const float* buf, int ksteps) {
  constexpr int SA = AK ? S8 : S4;
  constexpr int SB = BK ? 16 * WN + 8 : S4;
  const float* ahi = buf;
  const float* alo = buf + TILE;
  const float* bhi = buf + 2 * TILE;
  const float* blo = bhi + btile<WN>();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gq = lane >> 2, tg = lane & 3, wm = w >> 1, wn = w & 1;
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    if (kk >= ksteps) break;
    uint32_t ah[2][4], al[2][4], bh[WN][2], bl[WN][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // a0..a3: (g, t) (g+8, t) (g, t+4) ...
        const int r = 32 * wm + 16 * m + gq + 8 * (e & 1);
        const int k = 8 * kk + tg + 4 * (e >> 1);
        const int idx = AK ? k * SA + r : r * SA + k;
        ah[m][e] = __float_as_uint(ahi[idx]);
        al[m][e] = __float_as_uint(alo[idx]);
      }
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // b0, b1: (k = t, n = g) (t+4, g)
        const int cc = 8 * (WN * wn + n) + gq, k = 8 * kk + tg + 4 * e;
        const int idx = BK ? k * SB + cc : cc * SB + k;
        bh[n][e] = __float_as_uint(bhi[idx]);
        bl[n][e] = __float_as_uint(blo[idx]);
      }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n) mma_tf32(acc[m][n], al[m], bh[n]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n) mma_tf32(acc[m][n], ah[m], bl[n]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n) mma_tf32(acc[m][n], ah[m], bh[n]);
  }
}

// Stages s = 0 .. ns-1 of a block's K loop over two stage buffers:
// load(s) issues stage s's global loads into registers, store(s, i) splits
// them into buffer i, compute(s, i) runs the MMAs on buffer i.  Stage s +
// 1's loads are in flight during stage s's MMAs, and a thread stores them
// into the other buffer while other warps still multiply: one barrier a
// stage.
template <class Load, class Store, class Compute>
__device__ __forceinline__ void stages(int ns, Load load, Store store,
                                       Compute compute) {
  load(0);
  store(0, 0);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) load(s + 1);
    compute(s, s & 1);
    if (s + 1 < ns) store(s + 1, (s + 1) & 1);
    __syncthreads();
  }
}

// Stores the accumulators of a 64 x 16 WN tile through shared memory (`sm`,
// free once the K loop is done): each warp writes its fragments as float2s
// (row stride 16 WN + 8: no bank conflicts), then out(r, c, v) takes the
// tile's rows 4 columns a call, neighbouring threads on neighbouring
// columns, so that device memory sees whole rows.
template <int WN, class Out>
__device__ __forceinline__ void epilogue(const float (&acc)[2][WN][4],
                                         float* sm, Out out) {
  constexpr int W = 16 * WN, SS = W + 8;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gq = lane >> 2, tg = lane & 3, wm = w >> 1, wn = w & 1;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n) {
      float* at = sm + (32 * wm + 16 * m + gq) * SS + 8 * (WN * wn + n) +
                  2 * tg;
      *reinterpret_cast<float2*>(at) = make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(at + 8 * SS) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * W / 4; idx += THREADS) {
    const int r = idx / (W / 4), c = idx % (W / 4) * 4;
    out(r, c, *reinterpret_cast<const float4*>(sm + r * SS + c));
  }
}

// Writes 4 floats at p, those at or past `left` dropped: one 16-byte store
// where `vec` and all 4 are in.
__device__ __forceinline__ void put4(float* p, float4 v, int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (left > 0) p[0] = v.x;
  if (left > 1) p[1] = v.y;
  if (left > 2) p[2] = v.z;
  if (left > 3) p[3] = v.w;
}

// The chunk's masked dt (dtv, 0 past its qc real positions) and da =
// cumsum(dt a) (inclusive: two entries a thread, warp scans, then the warp
// totals), over QMAX entries; both kernels that need them compute them so,
// with the same bits.  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(float* dtv, float* da,
                                             float* wsum, const float* dt,
                                             const uint8_t* mask, float ah,
                                             long long pos0, int H, int h,
                                             int qc) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int j = tid; j < QMAX; j += THREADS) {
    float v = 0.f;
    if (j < qc) {
      v = dt[(pos0 + j) * H + h];
      if (mask != nullptr && !mask[pos0 + j]) v = 0.f;
    }
    dtv[j] = v;
  }
  __syncthreads();
  const float v0 = dtv[2 * tid] * ah, v1 = dtv[2 * tid + 1] * ah;
  const float tot = v0 + v1;
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  float base = 0.f;
  for (int k = 0; k < w; ++k) base += wsum[k];
  base += excl;
  da[2 * tid] = base + v0;
  da[2 * tid + 1] = base + tot;
  __syncthreads();
}

// Kernel 1: cb[b, g, c][i][j] = sum_n C[b, cQ+i, g, n] B[b, cQ+j, g, n] on
// the causal 64 x 64 tiles of every chunk (tile j <= tile i; the last
// chunk has only its real positions' tiles).  Grid (causal tiles of all
// chunks, G, B).  Entries past the chunk's real positions are computed on
// zeros and stored up to the chunk's real length only.
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int G, int N, int Q, int nc,
              int vec) {
  extern __shared__ __align__(16) float smem[];
  const int qt = cdiv(Q, TM), tri = qt * (qt + 1) / 2;
  int t = blockIdx.x, c;
  if (t < (nc - 1) * tri) {
    c = t / tri;
    t -= c * tri;
  } else {
    c = nc - 1;
    t -= (nc - 1) * tri;
  }
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int g = blockIdx.y, b = blockIdx.z;
  const int qc = min(Q, S - c * Q);
  const int i0 = ti * TM, j0 = tj * TN;
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const long long ld = (long long)G * N;
  const float* crow = Cm + ((pos0 + i0) * G + g) * N;
  const float* brow = Bm + ((pos0 + j0) * G + g) * N;

  float4 ra[4], rb[4];
  float acc[2][4][4] = {};
  stages(cdiv(N, KS), [&](int s) {
    Tile<TM, KS>::load(ra, crow + s * KS, ld, qc - i0, N - s * KS, vec);
    Tile<TN, KS>::load(rb, brow + s * KS, ld, qc - j0, N - s * KS, vec);
  }, [&](int, int i) {
    float* buf = smem + i * bufsz<4>();
    Tile<TM, KS>::store(ra, buf, buf + TILE, S4, Identity{});
    Tile<TN, KS>::store(rb, buf + 2 * TILE, buf + 2 * TILE + btile<4>(), S4,
                        Identity{});
  }, [&](int s, int i) {
    mma_stage<false, false, 4>(acc, smem + i * bufsz<4>(),
                               cdiv(min(KS, N - s * KS), 8));
  });

  float* out = cb + (((long long)b * G + g) * nc + c) * Q * Q;
  epilogue<4>(acc, smem, [&](int r, int cc, float4 v) {
    const int i = i0 + r, j = j0 + cc;
    if (i < qc) put4(out + (long long)i * Q + j, v, qc - j, vec);
  });
}

// Kernel 2: per (b, chunk, head, 64 rows of P, NB = 16 WN state dims) the
// chunk's masked dt, da = cumsum(dt a), seg_end = exp(da[Q-1] - da) and the
// chunk-local state Sloc^T[p][n] = sum_j x[j][p] dt[j] seg_end[j] B[j][n]
// over the chunk's real positions (A = x dt and B seg_end both stored
// [j][.]).  Grid (nc, H * cdiv(P, 64) * cdiv(N, NB), B).  The first tile's
// block also writes the chunk decay exp(da[Q-1]).
template <int WN>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const float* __restrict__ Bm,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ sloc, float* __restrict__ decay,
                       int S, int H, int P, int G, int N, int Q, int nc,
                       int vec) {
  constexpr int NB = 16 * WN;
  extern __shared__ __align__(16) float smem[];
  float* dtv = smem;                           // [QMAX] masked dt
  float* da = dtv + QMAX;                      // [QMAX] cumsum(dt a)
  float* se = da + QMAX;                       // [QMAX] exp(da[Q-1] - da)
  float* wsum = se + QMAX;                     // [4] warp totals
  float* buf = wsum + 4;

  const int c = blockIdx.x, b = blockIdx.z;
  const int ptiles = cdiv(P, TM), ntiles = cdiv(N, NB);
  const int h = blockIdx.y / (ptiles * ntiles);
  const int p0 = blockIdx.y / ntiles % ptiles * TM;
  const int n0 = blockIdx.y % ntiles * NB;
  const int g = h / (H / G);
  const int qc = min(Q, S - c * Q);
  const long long pos0 = (long long)b * S + (long long)c * Q;
  chunk_cumsum(dtv, da, wsum, dt, mask, a[h], pos0, H, h, qc);
  const float da_last = da[Q - 1];
  for (int j = threadIdx.x; j < QMAX; j += THREADS)
    se[j] = expf(da_last - da[j]);
  if (p0 == 0 && n0 == 0 && threadIdx.x == 0)
    decay[((long long)b * nc + c) * H + h] = expf(da_last);
  __syncthreads();

  const long long ldx = (long long)H * P, ldb = (long long)G * N;
  const float* xrow = x + (pos0 * H + h) * P + p0;
  const float* brow = Bm + (pos0 * G + g) * N + n0;
  float4 ra[4], rb[WN];
  float acc[2][WN][4] = {};
  stages(cdiv(qc, KS), [&](int s) {
    const int j0 = s * KS;
    Tile<KS, TM>::load(ra, xrow + j0 * ldx, ldx, qc - j0, P - p0, vec);
    Tile<KS, NB>::load(rb, brow + j0 * ldb, ldb, qc - j0, N - n0, vec);
  }, [&](int s, int i) {
    float* at = buf + i * bufsz<WN>();
    Tile<KS, TM>::store(ra, at, at + TILE, S8, ScaleRows{dtv + s * KS});
    Tile<KS, NB>::store(rb, at + 2 * TILE, at + 2 * TILE + btile<WN>(),
                        NB + 8, ScaleRows{se + s * KS});
  }, [&](int s, int i) {
    mma_stage<true, true, WN>(acc, buf + i * bufsz<WN>(),
                              cdiv(min(KS, qc - s * KS), 8));
  });

  float* dst = sloc + (((long long)b * nc + c) * H + h) * P * N;
  epilogue<WN>(acc, buf, [&](int r, int cc, float4 v) {
    const int p = p0 + r, n = n0 + cc;
    if (p < P) put4(dst + (long long)p * N + n, v, N - n, vec);
  });
}

// Kernel 3: S = initial state (or 0); per chunk c in order: Sloc[c] <- S
// (c > 0: the state entering chunk c), S = decay_c S + Sloc[c]; the final
// state.  Grid (P N / (VW 256), H, B); VW elements a thread (4 where P N %
// 4 == 0 and the bases are 16-byte aligned); the loads of up to 4 chunks
// are issued together.
template <int VW>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(const float* __restrict__ init, float* __restrict__ sloc,
                      const float* __restrict__ decay,
                      float* __restrict__ fstate, int H, int P, int N,
                      int nc) {
  const int pn = P * N, b = blockIdx.z, h = blockIdx.y;
  const int r = (blockIdx.x * PASS_THREADS + threadIdx.x) * VW;
  if (r >= pn) return;
  const long long e = ((long long)b * H + h) * pn + r;
  float s[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) s[k] = init != nullptr ? init[e + k] : 0.f;
  constexpr int CB = 4;
  for (int c0 = 0; c0 < nc; c0 += CB) {
    float v[CB][VW], d[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (c0 + j >= nc) break;
      const long long bc = ((long long)b * nc + c0 + j) * H + h;
      const float* ptr = sloc + bc * pn + r;
      if constexpr (VW == 4) {
        const float4 q = *reinterpret_cast<const float4*>(ptr);
        v[j][0] = q.x;
        v[j][1] = q.y;
        v[j][2] = q.z;
        v[j][3] = q.w;
      } else {
        v[j][0] = ptr[0];
      }
      d[j] = decay[bc];
    }
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const int c = c0 + j;
      if (c >= nc) break;
      if (c > 0) {
        float* ptr = sloc + (((long long)b * nc + c) * H + h) * pn + r;
        if constexpr (VW == 4)
          *reinterpret_cast<float4*>(ptr) =
              make_float4(s[0], s[1], s[2], s[3]);
        else
          ptr[0] = s[0];
      }
#pragma unroll
      for (int k = 0; k < VW; ++k) s[k] = fmaf(d[j], s[k], v[j][k]);
    }
  }
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(fstate + e) = make_float4(s[0], s[1], s[2],
                                                         s[3]);
  else
    fstate[e] = s[0];
}

// Kernel 4: y for one 64-row tile of a chunk and PB = 16 WN columns of P,
// for the chunks from c0 on: K first over the N state dims (C S_enter,
// S_enter stored [p][n]: the initial state for chunk 0, kernel 3's for the
// rest; none for chunk 0 without an initial state or where the block's
// slice of it is zero: C 0 = +0 exactly, the same bits), the accumulator's
// rows then scaled by exp(da), then K over the tile's causal positions j <
// min(tile end, the chunk's real length): A[i][j] = CB[i][j] exp(da[i] -
// da[j]) for j <= i, else 0 (masked before exp), B[j][p] = x[j][p] dt[j]
// (dt and da from chunk_cumsum, as kernel 2 has them); a warp skips the
// steps above its rows.  Chunk 0 needs neither kernel 2 nor kernel 3, so
// its tiles run beside them.  Grid (the chunks' tiles, H * cdiv(P, PB),
// B): a chunk's row tiles heaviest first, chunk by chunk.
template <int WN>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_out_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ a,
                     const float* __restrict__ Cm,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ init,
                     const float* __restrict__ cb,
                     const float* __restrict__ sloc, float* __restrict__ y,
                     int S, int H, int P, int G, int N, int Q, int nc,
                     int c0, int vec) {
  constexpr int PB = 16 * WN;
  extern __shared__ __align__(16) float smem[];
  float* dts = smem;                           // [QMAX] masked dt
  float* das = dts + QMAX;                     // [QMAX] cumsum(dt a)
  float* wsum = das + QMAX;                    // [4] warp totals
  float* buf = wsum + 4;

  const int qt = cdiv(Q, TM), t = blockIdx.x + c0 * qt;
  int c, it;
  if (t < (nc - 1) * qt) {
    c = t / qt;
    it = qt - 1 - t % qt;
  } else {
    c = nc - 1;
    it = cdiv(S - c * Q, TM) - 1 - (t - (nc - 1) * qt);
  }
  const int ptiles = cdiv(P, PB);
  const int h = blockIdx.y / ptiles, p0 = (blockIdx.y % ptiles) * PB;
  const int b = blockIdx.z, g = h / (H / G);
  const int qc = min(Q, S - c * Q);
  const int i0 = it * TM;
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const int wlast = i0 + 32 * (threadIdx.x >> 6) + 31;   // the warp's rows

  chunk_cumsum(dts, das, wsum, dt, mask, a[h], pos0, H, h, qc);
  const float* state =
      c > 0 ? sloc + (((long long)b * nc + c) * H + h) * P * N
      : init != nullptr ? init + ((long long)b * H + h) * P * N
                        : nullptr;
  if (c == 0 && state != nullptr) {            // the block's slice all zero?
    bool any = false;
    const float* slice = state + (long long)p0 * N;
    for (int idx = threadIdx.x; idx < min(PB, P - p0) * N; idx += THREADS)
      any |= __ldg(slice + idx) != 0.f;
    if (!__syncthreads_or(any)) state = nullptr;
  }
  const int n_inter = state != nullptr ? cdiv(N, KS) : 0;
  const int ns = n_inter + cdiv(min(i0 + TM, qc), KS);
  const long long ldc = (long long)G * N, ldx = (long long)H * P;
  const float* crow = Cm + ((pos0 + i0) * G + g) * N;
  const float* cbt = cb + ((((long long)b * G + g) * nc + c) * Q + i0) * Q;
  const float* xrow = x + (pos0 * H + h) * P + p0;
  const int rv = qc - i0;

  float4 ra[4], rb[4];
  float acc[2][WN][4] = {};
  stages(ns, [&](int s) {
    if (s < n_inter) {
      const int n0 = s * KS;
      Tile<TM, KS>::load(ra, crow + n0, ldc, rv, N - n0, vec);
      Tile<PB, KS>::load(rb, state + (long long)p0 * N + n0, N, P - p0,
                         N - n0, vec);
    } else {
      const int j0 = (s - n_inter) * KS;
      Tile<TM, KS>::load(ra, cbt + j0, Q, rv, qc - j0, vec);
      Tile<KS, PB>::load(rb, xrow + j0 * ldx, ldx, qc - j0, P - p0, vec);
    }
  }, [&](int s, int i) {
    float* at = buf + i * bufsz<WN>();
    if (s < n_inter) {
      Tile<TM, KS>::store(ra, at, at + TILE, S4, Identity{});
      Tile<PB, KS>::store(rb, at + 2 * TILE, at + 2 * TILE + btile<WN>(), S4,
                          Identity{});
      return;
    }
    const int j0 = (s - n_inter) * KS;
    Tile<TM, KS>::store(ra, at, at + TILE, S4,
                        [&](int r, int cc, float4 v) {
      const int i = i0 + r, j = j0 + cc;
      if (j > i) return make_float4(0.f, 0.f, 0.f, 0.f);
      const float di = das[i];
      const float4 dj = *reinterpret_cast<const float4*>(das + j);
      return make_float4(v.x * __expf(di - dj.x),
                         j + 1 <= i ? v.y * __expf(di - dj.y) : 0.f,
                         j + 2 <= i ? v.z * __expf(di - dj.z) : 0.f,
                         j + 3 <= i ? v.w * __expf(di - dj.w) : 0.f);
    });
    Tile<KS, PB>::store(rb, at + 2 * TILE, at + 2 * TILE + btile<WN>(),
                        PB + 8, ScaleRows{dts + j0});
  }, [&](int s, int i) {
    const float* at = buf + i * bufsz<WN>();
    if (s < n_inter) {                         // C S_enter
      mma_stage<false, false, WN>(acc, at, cdiv(min(KS, N - s * KS), 8));
      if (s == n_inter - 1) {                  // seg_start = exp(da)
        const int r = i0 + 32 * (threadIdx.x >> 6) + ((threadIdx.x & 31) >> 2);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float e0 = expf(das[r + 16 * m]);
          const float e1 = expf(das[r + 16 * m + 8]);
#pragma unroll
          for (int n = 0; n < WN; ++n) {
            acc[m][n][0] *= e0;
            acc[m][n][1] *= e0;
            acc[m][n][2] *= e1;
            acc[m][n][3] *= e1;
          }
        }
      }
      return;
    }
    const int j0 = (s - n_inter) * KS;         // (CB ⊙ L)(x dt)
    const int steps = wlast < j0 ? 0 : min(cdiv(min(KS, qc - j0), 8),
                                           (wlast - j0) / 8 + 1);
    mma_stage<false, true, WN>(acc, at, steps);
  });

  float* yrow = y + (pos0 * H + h) * P;        // position i at yrow + i ldx
  epilogue<WN>(acc, buf, [&](int r, int cc, float4 v) {
    const int i = i0 + r, p = p0 + cc;
    if (i < qc) put4(yrow + i * ldx + p, v, P - p, vec);
  });
}

template <int WN>
constexpr size_t buf_bytes() {
  return sizeof(float) * 2 * bufsz<WN>();
}
constexpr size_t CB_SMEM = buf_bytes<4>();
template <int WN>
constexpr size_t state_smem() {
  return sizeof(float) * (3 * QMAX + 4) + buf_bytes<WN>();
}
template <int WN>
constexpr size_t out_smem() {
  return sizeof(float) * (2 * QMAX + 4) + buf_bytes<WN>();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Per device, on its first call: the SM count, the kernels' shared-memory
// limits, and the side stream and events that fork ssd_cb and chunk 0's
// ssd_chunk_out off the caller's stream (one bit each a device): a call
// inside a graph capture then only launches and records.
struct Device {
  int sms;
  cudaStream_t side;
  cudaEvent_t fork, cb_done, join;
};

cudaError_t prepare(Device** out) {
  static unsigned long long ready = 0;
  static Device devs[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Device& d = devs[dev];
  *out = &d;
  if ((ready >> dev) & 1ull) return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_cb_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)CB_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_state_kernel<4>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)state_smem<4>())) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_state_kernel<8>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)state_smem<8>())) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_out_kernel<4>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)out_smem<4>())) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_out_kernel<2>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)out_smem<2>())) != cudaSuccess ||
      (err = cudaStreamCreateWithFlags(&d.side, cudaStreamNonBlocking)) !=
          cudaSuccess ||
      (err = cudaEventCreateWithFlags(&d.fork, cudaEventDisableTiming)) !=
          cudaSuccess ||
      (err = cudaEventCreateWithFlags(&d.cb_done, cudaEventDisableTiming)) !=
          cudaSuccess ||
      (err = cudaEventCreateWithFlags(&d.join, cudaEventDisableTiming)) !=
          cudaSuccess)
    return err;
  ready |= 1ull << dev;
  return cudaSuccess;
}

// What a call launches: grid shapes, and where each workspace sits in the
// one buffer the wrapper allocates (16-byte aligned pieces).
struct Plan {
  int nc, qt, qtl, tiles, tiles0;
  bool wide_state, wide_out;
  size_t cb, sloc, decay, bytes;
};

Plan plan(int sms, int batch, int S, int H, int P, int G, int N, int Q) {
  Plan p;
  p.nc = cdiv(S, Q);
  p.qt = cdiv(Q, TM);
  p.qtl = cdiv(S - (p.nc - 1) * Q, TM);
  p.tiles = (p.nc - 1) * p.qt + p.qtl;
  p.tiles0 = p.nc > 1 ? p.qt : p.qtl;          // chunk 0's row tiles
  // chunk_state: 128 state dims a block where that gives two blocks an SM,
  // else 64
  p.wide_state = (long long)p.nc * H * cdiv(P, TM) * cdiv(N, 128) * batch >=
                 2LL * sms;
  // chunk_out: 64 columns a block, or 32 where that leaves fewer than two
  // blocks an SM
  p.wide_out = (long long)p.tiles * H * cdiv(P, 64) * batch >= 2LL * sms;
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += (floats * sizeof(float) + 15) / 16 * 16;
    return at;
  };
  p.cb = take((size_t)batch * G * p.nc * Q * Q);
  p.sloc = take((size_t)batch * p.nc * H * P * N);
  p.decay = take((size_t)batch * p.nc * H);
  p.bytes = off;
  return p;
}

bool valid(int batch, int S, int H, int P, int G, int N, int Q) {
  return batch >= 1 && S >= 1 && H >= 1 && P >= 1 && G >= 1 && H % G == 0 &&
         N >= 1 && N <= NMAX && Q >= 1 && Q <= QMAX && batch <= 65535 &&
         (long long)H * cdiv(P, 32) <= 65535 &&
         (long long)H * cdiv(P, 64) * cdiv(N, 64) <= 65535;
}

}  // namespace

extern "C" {

int ssd_scan_tc_qmax() { return QMAX; }
int ssd_scan_tc_nmax() { return NMAX; }

// Bytes of the workspace a call of these sizes takes (its C B^T, chunk
// states and chunk decays); a cudaError_t.
int ssd_scan_tc_workspace(int batch, int S, int H, int P, int G, int N,
                          int Q, long long* bytes) {
  if (!valid(batch, S, H, P, G, N, Q)) return (int)cudaErrorInvalidValue;
  Device* d = nullptr;
  const cudaError_t err = prepare(&d);
  if (err != cudaSuccess) return (int)err;
  *bytes = (long long)plan(d->sms, batch, S, H, P, G, N, Q).bytes;
  return 0;
}

// Byte offsets in a call's workspace of what its backward (ssd_scan_bwd.cu)
// reads: C B^T (B, G, nc, Q, Q), written on the causal 64 x 64 tiles of each
// chunk's real rows, and the chunk states (B, nc, H, P, N), slot c > 0 the
// state entering chunk c once the call has run (slot 0 holds chunk 0's
// local state).  A cudaError_t.
int ssd_scan_tc_layout(int batch, int S, int H, int P, int G, int N, int Q,
                       long long* cb, long long* states) {
  if (!valid(batch, S, H, P, G, N, Q)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(1, batch, S, H, P, G, N, Q);   // sms moves no offset
  *cb = (long long)pl.cb;
  *states = (long long)pl.sloc;
  return 0;
}

// ws: a 16-byte aligned buffer of ssd_scan_tc_workspace's bytes.  Launches
// the four kernels, ordered on `stream`: ssd_cb, then chunk 0's
// ssd_chunk_out, on a side stream forked from it, beside ssd_chunk_state
// and ssd_state_pass; the other chunks' ssd_chunk_out after both; the side
// stream joined back at the end.  Returns a cudaError_t (0 = launched).
int ssd_scan_tc_launch(const float* x, const float* dt, const float* a,
                       const float* Bm, const float* Cm, const uint8_t* mask,
                       const float* init, void* ws, float* y, float* fstate,
                       int batch, int S, int H, int P, int G, int N, int Q,
                       void* stream) {
  if (!valid(batch, S, H, P, G, N, Q)) return (int)cudaErrorInvalidValue;
  Device* d = nullptr;
  cudaError_t err = prepare(&d);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Plan pl = plan(d->sms, batch, S, H, P, G, N, Q);
  char* base = static_cast<char*>(ws);
  float* cb = reinterpret_cast<float*>(base + pl.cb);
  float* sloc = reinterpret_cast<float*>(base + pl.sloc);
  float* decay = reinterpret_cast<float*>(base + pl.decay);
  const int nc = pl.nc, qt = pl.qt, qtl = pl.qtl;
  const int vec = P % 4 == 0 && N % 4 == 0 && Q % 4 == 0 && aligned16(x) &&
                  aligned16(Bm) && aligned16(Cm) && aligned16(ws) &&
                  aligned16(y) && (init == nullptr || aligned16(init));
  // chunk_out for chunks c0 .. nc-1 (their tiles) on stream s
  auto chunk_out = [&](int c0, int tiles, cudaStream_t s) {
    if (pl.wide_out)
      ssd_chunk_out_kernel<4><<<dim3(tiles, H * cdiv(P, 64), batch), THREADS,
                                out_smem<4>(), s>>>(
          x, dt, a, Cm, mask, init, cb, sloc, y, S, H, P, G, N, Q, nc, c0,
          vec);
    else
      ssd_chunk_out_kernel<2><<<dim3(tiles, H * cdiv(P, 32), batch), THREADS,
                                out_smem<2>(), s>>>(
          x, dt, a, Cm, mask, init, cb, sloc, y, S, H, P, G, N, Q, nc, c0,
          vec);
    return cudaGetLastError();
  };

  if ((err = cudaEventRecord(d->fork, st)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(d->side, d->fork, 0)) != cudaSuccess)
    return (int)err;
  ssd_cb_kernel<<<dim3((nc - 1) * (qt * (qt + 1) / 2) + qtl * (qtl + 1) / 2,
                       G, batch),
                  THREADS, CB_SMEM, d->side>>>(Bm, Cm, cb, S, G, N, Q, nc,
                                               vec);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaEventRecord(d->cb_done, d->side)) != cudaSuccess ||
      (err = chunk_out(0, pl.tiles0, d->side)) != cudaSuccess ||
      (err = cudaEventRecord(d->join, d->side)) != cudaSuccess)
    return (int)err;

  if (pl.wide_state)
    ssd_chunk_state_kernel<8><<<dim3(nc, H * cdiv(P, TM) * cdiv(N, 128),
                                     batch),
                                THREADS, state_smem<8>(), st>>>(
        x, dt, a, Bm, mask, sloc, decay, S, H, P, G, N, Q, nc, vec);
  else
    ssd_chunk_state_kernel<4><<<dim3(nc, H * cdiv(P, TM) * cdiv(N, 64),
                                     batch),
                                THREADS, state_smem<4>(), st>>>(
        x, dt, a, Bm, mask, sloc, decay, S, H, P, G, N, Q, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (P * N % 4 == 0 && aligned16(ws) && aligned16(fstate) &&
      (init == nullptr || aligned16(init)))
    ssd_state_pass_kernel<4><<<dim3(cdiv(P * N / 4, PASS_THREADS), H, batch),
                               PASS_THREADS, 0, st>>>(init, sloc, decay,
                                                      fstate, H, P, N, nc);
  else
    ssd_state_pass_kernel<1><<<dim3(cdiv(P * N, PASS_THREADS), H, batch),
                               PASS_THREADS, 0, st>>>(init, sloc, decay,
                                                      fstate, H, P, N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nc > 1 &&
      ((err = cudaStreamWaitEvent(st, d->cb_done, 0)) != cudaSuccess ||
       (err = chunk_out(1, pl.tiles - pl.tiles0, st)) != cudaSuccess))
    return (int)err;
  return (int)cudaStreamWaitEvent(st, d->join, 0);
}

}  // extern "C"
