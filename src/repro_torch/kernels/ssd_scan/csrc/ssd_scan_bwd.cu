// The SSD chunk scan's backward for Hopper (sm_90a) on the TF32 tensor
// cores: the vector-Jacobian product of ssd_scan_tc.cu's forward.
//
// Replaces no TPU kernel: JAX differentiates its jnp scan
// (src/repro/models/ssm.py:90 _ssd_chunked) with jax.grad and never its
// Pallas kernel.  The port's forward runs on ssd_scan_tc.cu, so its gradient
// needs a backward of its own; its plain version is kernels/ssd_scan/ref.py
// ssd_scan_bwd_ref, and ref.ssd_scan_bwd_tc_emulate repeats these kernels'
// arithmetic pass by pass (the scans and block sums in their exact order).
//
// Per (batch row b, head h) stream and chunk c of Q positions, with dt
// zeroed at masked positions, cum = cumsum(dt a) restarted at each chunk,
// xdt = x dt, L[q][k] = exp(cum_q - cum_k) (q >= k), CB = C B^T, seg_end =
// exp(cum_last - cum), S = the state entering the chunk, Gx = dLoss/d(the
// state leaving it) and D = (dy xdt^T) o L:
//   1. ssd_bwd_adj_kernel: cum (kept for the other kernels), the chunk
//      decay exp(cum_last) and Ploc = (exp(cum) o dy)^T C, every chunk in
//      parallel (the mirror of the forward's chunk-local state);
//   2. ssd_bwd_pass_kernel: Gx of the last chunk = dfinal (or 0); in
//      reverse, Gx_{c-1} = decay_c Gx_c + Ploc_c, each chunk's Gx written
//      over its Ploc; d initial_state = decay_0 Gx_0 + Ploc_0.  Elementwise,
//      the only sequential part;
//   3. ssd_bwd_dxdt_kernel, per head and 64-row tile of k: dxdt = (seg_end
//      o B) Gx^T + (CB o L)^T dy over the causal q, dx = dt dxdt, xdot =
//      <x, dxdt>;
//   4. ssd_bwd_dd_kernel, per causal (q tile, k tile) pair and run of up to
//      RUN heads of a group: D of each head, once; W = D o CB's row sums
//      rintra and column sums cintra (partials per tile); D summed over
//      the run's heads into a (B, G, runs, nc, Q, Q) workspace;
//   5. ssd_bwd_db_kernel / ssd_bwd_dc_kernel, per 64-row tile, group and 64
//      state dims: the group's dB = sum_runs (sum D)^T C + sum_heads
//      (seg_end o xdt) Gx and dC = sum_runs (sum D) B + sum_heads (exp(cum)
//      o dy) S, the heads' products taken one after another into one
//      accumulator and written as the result; of each head's product the
//      row terms T = <B, .> (= <xdt, dxdt_inter>) and rinter = <C, .> (=
//      C . dC_inter).  Where these blocks are fewer than two an SM they
//      split K by whole runs and heads, and ssd_bwd_dbc_sum_kernel adds the
//      partials in order (the routing rule; phase 3f of chip_smoke.py runs
//      both: mamba2's (2, 4096) in one split, zamba2's and the ragged call
//      in several);
//   6. ssd_bwd_reduce_kernel: d cum = rintra + rinter - cintra - T, the
//      last position also exp(cum_last) <Gx, S> + sum_k T_k; d(dt a) = its
//      reverse cumsum; ddt = a d(dt a) + xdot (0 where masked) and the
//      chunk's share of da;
//   7. ssd_bwd_da_kernel: da summed over rows and chunks.
// Kernel 4 and the dC kernel need cum but not Gx: they run on a side
// stream forked after kernel 1, beside kernels 2-3 and the dB kernel, and
// join back before the split sums and kernel 6.  C B^T and the states
// entering each chunk are the forward's, read from its workspace
// (ssd_scan_tc_layout): the backward recomputes neither.
//
// What bounds it: the products.  At mamba2-1.3b's widths (H 64, P 64, N
// 128, G 1, Q 256) a (2, 4096) call needs ~52 GFLOP with dB's and dC's
// intra-chunk products per group (86 with them per head) against ~0.3 GB
// of bytes: far above the ridge, 0.31 ms at three TF32 products each.  The
// first design ran every product on f32 FMAs: 12.07 ms on an H100 80GB
// HBM3 at 700 W, D built twice (a row and a column kernel, the diagonal
// blocks in full), dB and dC through a (B, S, H, N) per-head workspace
// each, 268 MB apiece at that shape.  This design (~2.4 ms at that shape,
// zamba2's N = 64 ~1.8, on the same card; PERF.md has the runs):
//   - every product on mma.sync.m16n8k8 TF32 with the forward's 3xTF32
//     split (hi = tf32(a), lo = tf32(a - hi), rounded as cvt.rna rounds;
//     lo.hi, hi.lo and hi.hi, lo.lo dropped): f32 accuracy, as a single
//     TF32 product is not (it missed KERNEL_TOL by 5x in the forward).
//     Operands scaled before the product (exp(cum) o dy, seg_end o B,
//     seg_end o xdt, CB o L, x dt) are split after the scale, as staged.
//     The staging is the forward's: 32-deep stages over two buffers, each
//     element split once a block, padded strides (4 mod 32 along a row, 8
//     mod 32 down a column), fragments stored with k contiguous read by
//     ldmatrix, 4 warps over 64 x 64 output tiles;
//   - the tensor cores' f32 accumulation truncates, and over long K its
//     drift showed: one accumulator over mamba2's K = 4,096 head sums left
//     dB ~1e-4 of its scale from the f32 sum.  So the small terms (lo.hi,
//     hi.lo) go to an accumulator of their own where registers allow
//     (kernels 1, 3, 4), and each 64 of K (each run or head in kernel 5) is
//     added into the result in f32 (flush);
//   - D is built once per causal pair and head (kernel 4), CB o L once per
//     causal pair and head (kernel 3); dxdt needs no D.  d cum's row and
//     column terms are both W's sums from kernel 4's one W.  Where dt |a|
//     is large (L near diagonal, as the reduced models train) the two
//     nearly cancel: the column term taken as -<xdt, dxdt> (equal in exact
//     arithmetic) left A_log's gradient 1.1e-4 of its scale off the CPU's.
//     For the same reason W's sums, the row terms T and rinter, d cum, its
//     reverse cumsum and da are taken in f64 (a few dozen f64 adds a head
//     and position);
//   - blocks above the diagonal are never computed, L is masked before exp,
//     and on a diagonal a warp whose outputs are all masked skips its MMAs;
//   - dB and dC are per group: D summed over a run of heads in registers,
//     then one product per run, not per head; the heads' state terms
//     follow in the same accumulator.  The (B, S, H, N) workspaces are
//     gone (the workspace at mamba2's (2, 4096) 612 MB -> 206 MB, most of
//     it Gx and the f64 partials);
//   - kernels 1 and 3 trim their shared memory to 75 KB and their
//     registers to 170, three blocks an SM (kernel 3's time fell 18%);
//     kernel 4 and the dC kernel overlap the rest on a side stream.
// Ragged edges (positions past S or past a chunk's real length, P or N off
// the tiles, Q off the 64-row tiles) read as zero in registers; nothing is
// padded in device memory.  Sums run in a fixed order with no atomics (the
// runs, heads and splits in order, quad and warp sums by fixed shuffles):
// two calls on the same inputs are bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;        // 4 warps, 2 x 2 over a 64 x 64 tile
constexpr int RED_THREADS = 256;    // kernel 6: one chunk position a thread
constexpr int PASS_THREADS = 256;   // kernel 2
constexpr int QMAX = 256;           // largest chunk
constexpr int PMAX = 64;            // largest head dim (one column tile)
constexpr int NMAX = 128;           // largest state dim
constexpr int TM = 64;              // rows and columns of an output tile
constexpr int WN = 4;               // 8-column MMA tiles of a warp's 32
constexpr int KS = 32;              // depth of a stage
constexpr int S4 = KS + 4;          // stride of [64][KS] tiles (4 mod 32)
constexpr int S8 = TM + 8;          // stride of [KS][64] tiles (8 mod 32)
constexpr int TILE = TM * S4;       // floats of one split tile
constexpr int BUF = 4 * TILE;       // a stage buffer: A hi, A lo, B hi, B lo
constexpr int RUN = 16;             // heads of a group one kernel-4 block sums
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE >= KS * S8, "both layouts of a tile fit one slot");
static_assert(QMAX == 2 * THREADS, "the cumsum takes two entries a thread");
static_assert(QMAX == RED_THREADS, "kernel 6 takes one position a thread");
static_assert(PMAX == TM, "a head's P dims are one column tile");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The 3xTF32 split (as ssd_scan_tc.cu's): hi = tf32(a), lo = tf32(a - hi),
// each rounded to nearest with ties away from zero as cvt.rna.tf32.f32
// rounds: a = hi + lo within 2^-22 |a|.
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

// Four 8 x 4 tiles of 32-bit words from shared memory: thread i gives the
// address of row i % 8 of tile i / 8 (16 bytes, 16-byte aligned) and gets
// word (i / 4, i % 4) of each tile: a TF32 fragment of m16n8k8 where the
// tile is stored with its 4 words contiguous ([row][k] for A, [col][k]
// for B).
__device__ __forceinline__ void ldsm4(uint32_t (&d)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(a));
}

// A ROWS x COLS f32 tile (COLS contiguous) staged in registers, one float4
// a thread per 512 elements: slot q holds row (tid + 128 q) / (COLS / 4),
// columns 4 ((tid + 128 q) % (COLS / 4)) + 0..3.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int R = ROWS * COLS / (4 * THREADS);
  static_assert(R == 4, "every staged tile is 2048 floats");
  __device__ __forceinline__ static int row(int q) {
    return (threadIdx.x + THREADS * q) / (COLS / 4);
  }
  __device__ __forceinline__ static int col(int q) {
    return (threadIdx.x + THREADS * q) % (COLS / 4) * 4;
  }

  // Row r at g + r * ld; rows at or past rv and columns at or past cv read
  // as 0 (nothing is read there).  16-byte loads where `vec`.
  __device__ __forceinline__ static void load(float4 (&v)[R], const float* g,
                                              long long ld, int rv, int cv,
                                              bool vec) {
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
  template <class F>
  __device__ __forceinline__ static void store(const float4 (&v)[R],
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

// Scales row r of a staged tile by d[r].
struct ScaleRows {
  const float* d;
  __device__ __forceinline__ float4 operator()(int r, int, float4 v) const {
    const float s = d[r];
    return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
  }
};

// The MMAs of one stage for warp (wm, wn) = (w >> 1, w & 1): its 32 x 32
// slab of a 64 x 64 tile, over the stage's first `ksteps` 8-deep steps.
// The split tiles in `buf`: A hi, A lo (stored [row][k], stride S4, or
// where AK [k][row], stride S8), B hi, B lo (stored [k][col], stride S8,
// where BK, else [col][k], stride S4); TILE floats each.  Three MMAs a
// product, the small terms (lo.hi, hi.lo) first into `lo`, hi.hi into
// `acc` (lo may be acc itself).  The MMAs' f32 accumulation truncates:
// where the small terms have an accumulator of their own, the large one
// is truncated once a step instead of three times.  Operands stored with
// k contiguous come in by ldmatrix, four fragment words an instruction.
template <bool AK, bool BK>
__device__ __forceinline__ void mma_stage(float (&acc)[2][WN][4],
                                          float (&lo)[2][WN][4],
                                          const float* buf, int ksteps) {
  constexpr int SA = AK ? S8 : S4;
  constexpr int SB = BK ? S8 : S4;
  const float* ahi = buf;
  const float* alo = buf + TILE;
  const float* bhi = buf + 2 * TILE;
  const float* blo = buf + 3 * TILE;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gq = lane >> 2, tg = lane & 3, wm = w >> 1, wn = w & 1;
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    if (kk >= ksteps) break;
    uint32_t ah[2][4], al[2][4], bh[WN][2], bl[WN][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if constexpr (!AK) {            // tile j: rows + 8 (j & 1), k + 4 (j >> 1)
        const int j = lane >> 3;
        const int idx = (32 * wm + 16 * m + (lane & 7) + 8 * (j & 1)) * SA +
                        8 * kk + 4 * (j >> 1);
        ldsm4(ah[m], ahi + idx);
        ldsm4(al[m], alo + idx);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // a0..a3: (g, t) (g+8, t) (g, t+4) ...
        const int r = 32 * wm + 16 * m + gq + 8 * (e & 1);
        const int k = 8 * kk + tg + 4 * (e >> 1);
        const int idx = k * SA + r;
        ah[m][e] = __float_as_uint(ahi[idx]);
        al[m][e] = __float_as_uint(alo[idx]);
      }
    }
#pragma unroll
    for (int n = 0; n < WN; n += 2) {
      if constexpr (!BK) {            // tile j: n + (j >> 1), k + 4 (j & 1)
        const int j = lane >> 3;
        const int idx = (8 * (WN * wn + n + (j >> 1)) + (lane & 7)) * SB +
                        8 * kk + 4 * (j & 1);
        uint32_t h[4], l[4];
        ldsm4(h, bhi + idx);
        ldsm4(l, blo + idx);
        bh[n][0] = h[0];
        bh[n][1] = h[1];
        bh[n + 1][0] = h[2];
        bh[n + 1][1] = h[3];
        bl[n][0] = l[0];
        bl[n][1] = l[1];
        bl[n + 1][0] = l[2];
        bl[n + 1][1] = l[3];
        continue;
      }
#pragma unroll
      for (int n2 = n; n2 < n + 2; ++n2)
#pragma unroll
        for (int e = 0; e < 2; ++e) { // b0, b1: (k = t, n = g) (t+4, g)
          const int cc = 8 * (WN * wn + n2) + gq, k = 8 * kk + tg + 4 * e;
          const int idx = k * SB + cc;
          bh[n2][e] = __float_as_uint(bhi[idx]);
          bl[n2][e] = __float_as_uint(blo[idx]);
        }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n) mma_tf32(lo[m][n], al[m], bh[n]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n) mma_tf32(lo[m][n], ah[m], bl[n]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n) mma_tf32(acc[m][n], ah[m], bh[n]);
  }
}

// Stages s = 0 .. ns-1 of a block's K loop over two stage buffers:
// load(s) issues stage s's global loads into registers, store(s, i) splits
// them into buffer i, compute(s, i) runs the MMAs on buffer i; one barrier
// a stage, stage s + 1's loads in flight during stage s's MMAs.
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

// tot += acc, acc = 0: the MMAs' sums, which do not round to nearest, are
// added into tot in f32 every 64 of K (every run's K, at most 256, in
// kernel 5's first phase): over K in the thousands, one MMA accumulator
// drifted ~1e-4 from the f32 sum.
__device__ __forceinline__ void flush(float (&tot)[2][WN][4],
                                      float (&acc)[2][WN][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[m][n][e] += acc[m][n][e];
        acc[m][n][e] = 0.f;
      }
}

// tot += lo, then tot += acc (mma_stage's two accumulators).
__device__ __forceinline__ void flush(float (&tot)[2][WN][4],
                                      float (&acc)[2][WN][4],
                                      float (&lo)[2][WN][4]) {
  flush(tot, lo);
  flush(tot, acc);
}

// The row and column of accumulator element acc[m][n][e] of this thread in
// its block's 64 x 64 tile.
__device__ __forceinline__ int frag_row(int m, int e) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  return 32 * (w >> 1) + 16 * m + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int n, int e) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  return 8 * (WN * (w & 1) + n) + 2 * (lane & 3) + (e & 1);
}

// part[wn * TM + r] = sum over warp column wn's 32 columns of acc(r, col)
// f(r, col), for every row r of the 64 x 64 tile: each thread sums its
// fragments of the row, then the four threads of a quad (one row) add
// theirs by fixed shuffles.  Every thread of the block takes part.
template <class F>
__device__ __forceinline__ void row_dot(const float (&acc)[2][WN][4],
                                        float* part, F f) {
  const int wn = (threadIdx.x >> 5) & 1, tg = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = frag_row(m, 2 * hf);
      float v = 0.f;
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v = fmaf(acc[m][n][2 * hf + e], f(r, frag_col(n, e)), v);
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      if (tg == 0) part[wn * TM + r] = v;
    }
}

// Sums over a quad (the 4 lanes of one fragment row group, lane & 3) of 4
// values each, one sum a lane: lane t gets the sum of value t (v[t >> 1]
// [t & 1] as (v00, v01, v10, v11)), by exchanging halves (3 shuffles).
// In f64: d cum's terms nearly cancel (see kernel 6).
__device__ __forceinline__ double quad_scatter(double v00, double v01,
                                               double v10, double v11) {
  const int lane = threadIdx.x & 31;
  const bool b1 = (lane >> 1) & 1, b0 = lane & 1;
  // keep values (b1, .), send the others to lane ^ 2
  const double k0 =
      (b1 ? v10 : v00) + __shfl_xor_sync(FULL, b1 ? v00 : v10, 2);
  const double k1 =
      (b1 ? v11 : v01) + __shfl_xor_sync(FULL, b1 ? v01 : v11, 2);
  return (b0 ? k1 : k0) + __shfl_xor_sync(FULL, b0 ? k0 : k1, 1);
}

// Sums over the 8 lanes of a column group (lane >> 2 = 0..7, the same lane
// & 3) of 8 values each (v[n][e], value 2 n + e), one sum a lane: lane
// group gq gets value gq's (7 shuffles).
__device__ __forceinline__ double column_scatter(const double (&v)[WN][2]) {
  const int lane = threadIdx.x & 31;
  const bool b2 = (lane >> 4) & 1, b1 = (lane >> 3) & 1, b0 = (lane >> 2) & 1;
  double k4[4], k2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {                // values i + 4 b2 stay
    const double lo = v[i >> 1][i & 1], hi = v[2 + (i >> 1)][i & 1];
    k4[i] = (b2 ? hi : lo) + __shfl_xor_sync(FULL, b2 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)                  // values i + 2 b1 + 4 b2 stay
    k2[i] = (b1 ? k4[i + 2] : k4[i]) +
            __shfl_xor_sync(FULL, b1 ? k4[i] : k4[i + 2], 8);
  return (b0 ? k2[1] : k2[0]) + __shfl_xor_sync(FULL, b0 ? k2[0] : k2[1], 4);
}

// Stores the accumulators of a 64 x 64 tile through shared memory (`sm`,
// free once the K loop is done): each warp writes its fragments as float2s
// (row stride S8), then out(r, c, v) takes the tile's rows 4 columns a
// call, neighbouring threads on neighbouring columns.
template <class Out>
__device__ __forceinline__ void epilogue(const float (&acc)[2][WN][4],
                                         float* sm, Out out) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n) {
      float* at = sm + frag_row(m, 0) * S8 + frag_col(n, 0);
      *reinterpret_cast<float2*>(at) = make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(at + 8 * S8) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * TM / 4; idx += THREADS) {
    const int r = idx / (TM / 4), c = idx % (TM / 4) * 4;
    out(r, c, *reinterpret_cast<const float4*>(sm + r * S8 + c));
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

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// The block's sum of v in a fixed order; thread 0 gets it.  `red` holds
// NT / 32 values.  Ends with a barrier.
template <int NT, class T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The chunk's masked dt (dtv, 0 past its qc real positions) and cum =
// cumsum(dt a) (inclusive: two entries a thread, warp scans, then the warp
// totals), over QMAX entries.  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(float* dtv, float* cum,
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
  cum[2 * tid] = base + v0;
  cum[2 * tid + 1] = base + tot;
  __syncthreads();
}

// The chunk and 64-row tile of block t of kernels 3 and 5: tiles chunk by
// chunk (the last chunk has only its real positions').
__device__ __forceinline__ void tile_of(int t, int Q, int nc, int& c,
                                        int& it) {
  const int qt = cdiv(Q, TM);
  if (t < (nc - 1) * qt) {
    c = t / qt;
    it = t % qt;
  } else {
    c = nc - 1;
    it = t - (nc - 1) * qt;
  }
}

// Kernel 1: per (b, chunk, head, 64 state dims): the chunk's masked dt and
// cum (the n0 = 0 block writes cum over the real positions and the decay
// exp(cum_last)), and Ploc[p][n] = sum_q (exp(cum_q) dy[q][p]) C[q][n] into
// gx (A = exp(cum) dy and B = C both stored [q][.]).  Three blocks an
// SM.  Grid (nc, H * cdiv(N, 64), B).
__global__ void __launch_bounds__(THREADS, 3)
ssd_bwd_adj_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                   const float* __restrict__ Cm,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ dy, float* __restrict__ gx,
                   float* __restrict__ cumw, float* __restrict__ decay, int S,
                   int H, int P, int G, int N, int Q, int nc, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* dtv = smem;                           // [QMAX] masked dt
  float* cum = dtv + QMAX;                     // [QMAX] cumsum(dt a), then
                                               // exp(cum) (0 past qc)
  float* wsum = cum + QMAX;                    // [4] warp totals
  float* buf = wsum + 4;

  const int c = blockIdx.x, b = blockIdx.z;
  const int ntiles = cdiv(N, TM);
  const int h = blockIdx.y / ntiles, n0 = blockIdx.y % ntiles * TM;
  const int g = h / (H / G), qc = min(Q, S - c * Q);
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const long long bch = ((long long)b * nc + c) * H + h;
  chunk_cumsum(dtv, cum, wsum, dt, mask, a[h], pos0, H, h, qc);
  if (n0 == 0) {
    for (int j = threadIdx.x; j < qc; j += THREADS) cumw[bch * Q + j] = cum[j];
    if (threadIdx.x == 0) decay[bch] = expf(cum[qc - 1]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < QMAX; j += THREADS)
    cum[j] = j < qc ? expf(cum[j]) : 0.f;
  __syncthreads();
  const float* ec = cum;

  const long long ldy = (long long)H * P, ldc = (long long)G * N;
  const float* dyrow = dy + (pos0 * H + h) * P;
  const float* crow = Cm + (pos0 * G + g) * N + n0;
  float4 ra[4], rb[4];
  float acc[2][WN][4] = {}, lo[2][WN][4] = {}, tot[2][WN][4] = {};
  const int ns = cdiv(qc, KS);
  stages(ns, [&](int s) {
    const int j0 = s * KS;
    Tile<KS, TM>::load(ra, dyrow + j0 * ldy, ldy, qc - j0, P, vec);
    Tile<KS, TM>::load(rb, crow + j0 * ldc, ldc, qc - j0, N - n0, vec);
  }, [&](int s, int i) {
    float* at = buf + i * BUF;
    Tile<KS, TM>::store(ra, at, at + TILE, S8, ScaleRows{ec + s * KS});
    Tile<KS, TM>::store(rb, at + 2 * TILE, at + 3 * TILE, S8, Identity{});
  }, [&](int s, int i) {
    mma_stage<true, true>(acc, lo, buf + i * BUF,
                          cdiv(min(KS, qc - s * KS), 8));
    if (s % 2 == 1 || s == ns - 1) flush(tot, acc, lo);
  });

  float* dst = gx + bch * P * N;
  epilogue(tot, buf, [&](int r, int cc, float4 v) {
    const int n = n0 + cc;
    if (r < P) put4(dst + (long long)r * N + n, v, N - n, vec);
  });
}

// Kernel 2: per VW elements (p, n) of a (b, h) state, in reverse over the
// chunks: Gx = dfinal (or 0); gx[c] <- Gx (was Ploc_c), Gx = decay_c Gx +
// Ploc_c; d initial_state = Gx at the end (where dinit).  The loads of up
// to 4 chunks are issued together.  Grid (cdiv(P N / VW, 256), H, B).
template <int VW>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ dfinal, float* __restrict__ gx,
                    const float* __restrict__ decay, float* __restrict__ dinit,
                    int H, int P, int N, int nc) {
  const int pn = P * N, b = blockIdx.z, h = blockIdx.y;
  const int r = (blockIdx.x * PASS_THREADS + threadIdx.x) * VW;
  if (r >= pn) return;
  const long long e = ((long long)b * H + h) * pn + r;
  float s[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) s[k] = dfinal != nullptr ? dfinal[e + k] : 0.f;
  constexpr int CB = 4;
  for (int c1 = nc - 1; c1 >= 0; c1 -= CB) {
    float v[CB][VW], d[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (c1 - j < 0) break;
      const long long bc = ((long long)b * nc + c1 - j) * H + h;
      const float* ptr = gx + bc * pn + r;
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
      if (c1 - j < 0) break;
      float* ptr = gx + (((long long)b * nc + c1 - j) * H + h) * pn + r;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(ptr) = make_float4(s[0], s[1], s[2], s[3]);
      else
        ptr[0] = s[0];
#pragma unroll
      for (int k = 0; k < VW; ++k) s[k] = fmaf(d[j], s[k], v[j][k]);
    }
  }
  if (dinit == nullptr) return;
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dinit + e) = make_float4(s[0], s[1], s[2],
                                                        s[3]);
  else
    dinit[e] = s[0];
}

// Kernel 3: per (b, chunk, head, 64-row tile of k), with se = seg_end:
//   dxdt[k][p] = se_k sum_n B[k][n] Gx[p][n]   (K over the N dims), then
//     += sum_{q >= k} CB[q][k] L[q][k] dy[q][p] (A = CB o L stored [q][k],
//     built as staged, masked before exp; K over the causal q);
// dx = dt dxdt and xdot = <x, dxdt>.  Three blocks an SM.  Grid (the
// chunks' tiles, H, B).
__global__ void __launch_bounds__(THREADS, 3)
ssd_bwd_dxdt_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ cb,
                    const float* __restrict__ dy, const float* __restrict__ gx,
                    const float* __restrict__ cumw, float* __restrict__ dxo,
                    float* __restrict__ xdot, int S, int H, int P, int G,
                    int N, int Q, int nc, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                           // [QMAX] cumsum(dt a), 0 past qc
  float* dtv = cum + QMAX;                     // [TM] masked dt, the k rows
  float* se = dtv + TM;                        // [TM] seg_end, the k rows
  float* xpart = se + TM;                      // [2][TM] xdot halves
  float* buf = xpart + 2 * TM;

  int c, it;
  tile_of(blockIdx.x, Q, nc, c, it);
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int qc = min(Q, S - c * Q), k0 = it * TM, rv = qc - k0;
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const long long bch = ((long long)b * nc + c) * H + h;
  for (int j = threadIdx.x; j < QMAX; j += THREADS)
    cum[j] = j < qc ? cumw[bch * Q + j] : 0.f;
  for (int r = threadIdx.x; r < TM; r += THREADS) {
    const int k = k0 + r;
    float d = 0.f, e = 0.f;
    if (k < qc) {
      d = dt[(pos0 + k) * H + h];
      if (mask != nullptr && !mask[pos0 + k]) d = 0.f;
      e = expf(cumw[bch * Q + qc - 1] - cumw[bch * Q + k]);
    }
    dtv[r] = d;
    se[r] = e;
  }
  __syncthreads();

  const long long ldx = (long long)H * P, ldc = (long long)G * N;
  const float* gs = gx + bch * P * N;
  const float* xk = x + ((pos0 + k0) * H + h) * P;    // row r at xk + r ldx
  const float* dyc = dy + (pos0 * H + h) * P;         // position q at + q ldx
  const float* brow = Bm + ((pos0 + k0) * G + g) * N;
  const float* cbc = cb + (((long long)b * G + g) * nc + c) * Q * Q;
  const int nn = cdiv(N, KS), ns = nn + cdiv(qc - k0, KS);
  float4 ra[4], rb[4];
  float acc[2][WN][4] = {}, lo[2][WN][4] = {}, tot[2][WN][4] = {};
  stages(ns, [&](int s) {
    if (s < nn) {
      const int n0 = s * KS;
      Tile<TM, KS>::load(ra, brow + n0, ldc, rv, N - n0, vec);
      Tile<TM, KS>::load(rb, gs + n0, N, P, N - n0, vec);
      return;
    }
    const int j0 = k0 + (s - nn) * KS;
    Tile<KS, TM>::load(ra, cbc + (long long)j0 * Q + k0, Q, qc - j0, rv,
                       vec);
    Tile<KS, TM>::load(rb, dyc + j0 * ldx, ldx, qc - j0, P, vec);
  }, [&](int s, int i) {
    float* at = buf + i * BUF;
    if (s < nn) {
      Tile<TM, KS>::store(ra, at, at + TILE, S4, ScaleRows{se});
      Tile<TM, KS>::store(rb, at + 2 * TILE, at + 3 * TILE, S4, Identity{});
      return;
    }
    const int j0 = k0 + (s - nn) * KS;
    Tile<KS, TM>::store(ra, at, at + TILE, S8, [&](int r, int cc,
                                                   float4 v) {
      const int q = j0 + r, k = k0 + cc;       // A[k][q] = CB[q][k] L[q][k]
      if (q >= qc || k > q) return make_float4(0.f, 0.f, 0.f, 0.f);
      const float cq = cum[q];
      const float4 ck = *reinterpret_cast<const float4*>(cum + k);
      return make_float4(v.x * __expf(cq - ck.x),
                         k + 1 <= q ? v.y * __expf(cq - ck.y) : 0.f,
                         k + 2 <= q ? v.z * __expf(cq - ck.z) : 0.f,
                         k + 3 <= q ? v.w * __expf(cq - ck.w) : 0.f);
    });
    Tile<KS, TM>::store(rb, at + 2 * TILE, at + 3 * TILE, S8, Identity{});
  }, [&](int s, int i) {
    if (s < nn) {
      mma_stage<false, false>(acc, lo, buf + i * BUF,
                              cdiv(min(KS, N - s * KS), 8));
      if (s % 2 == 1 || s == nn - 1) flush(tot, acc, lo);
      return;
    }
    const int j0 = k0 + (s - nn) * KS;
    // a warp whose rows k all lie past the stage's last q has only zeros
    const bool dead = j0 + KS - 1 < k0 + 32 * (threadIdx.x >> 6);
    mma_stage<true, true>(acc, lo, buf + i * BUF,
                          dead ? 0 : cdiv(min(KS, qc - j0), 8));
    if ((s - nn) % 2 == 1 || s == ns - 1) flush(tot, acc, lo);
  });

  row_dot(tot, xpart, [&](int r, int p) {
    return r < rv && p < P ? xk[r * ldx + p] : 0.f;
  });
  float* dxk = dxo + ((pos0 + k0) * H + h) * P;
  epilogue(tot, buf, [&](int r, int cc, float4 v) {
    if (r < rv) put4(dxk + r * ldx + cc, scale4(v, dtv[r]), P - cc, vec);
  });
  for (int r = threadIdx.x; r < min(rv, TM); r += THREADS)
    xdot[(pos0 + k0 + r) * H + h] = xpart[r] + xpart[TM + r];
}

// Kernel 4: per (b, chunk, causal pair of 64-row tiles (q tile ti >= k
// tile tj), group g, run of up to RUN of its heads), for each head in
// order: DX[q][k] = sum_p dy[q][p] x[k][p] dt[k] (A = dy stored [q][p], B =
// x dt stored [k][p]), D = DX L masked to k <= q < qc (before exp), W = D
// CB's row sums (into rintra[b, s=q, h][tj]) and column sums (into
// cintra[b, s=k, h][ti][warp row]), and D summed over the run's heads in
// registers, written to dsum[b, g, run, c] at [q][k].  d cum takes both of
// W's sums (row minus column) from these same values: where L is near
// diagonal (large dt |a|) the two nearly cancel, and taking them from
// different products left da ~1e-4 of its scale off.  Grid (the
// chunks' causal pairs, G * runs, B).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ cb, const float* __restrict__ dy,
                  const float* __restrict__ cumw, float* __restrict__ dsum,
                  double* __restrict__ rintra, double* __restrict__ cintra,
                  int S, int H, int P, int G, int Q, int nc, int runs,
                  int vec) {
  extern __shared__ __align__(16) float smem[];
  float* cq = smem;                            // [RUN][TM] cum at the q rows
  float* ck = cq + RUN * TM;                   // [RUN][TM] cum at the k rows
  float* dk = ck + RUN * TM;                   // [RUN][TM] masked dt, k rows
  float* cbs = dk + RUN * TM;                  // [32][THREADS] CB, a thread's
  float* buf = cbs + 32 * THREADS;

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
  const int g = blockIdx.y / runs, run = blockIdx.y % runs, b = blockIdx.z;
  const int hg = H / G, per = cdiv(hg, runs);
  const int h0 = g * hg + run * per, nh = min(per, hg - run * per);
  const int qc = min(Q, S - c * Q), q0 = ti * TM, k0 = tj * TM;
  const long long pos0 = (long long)b * S + (long long)c * Q;
  for (int idx = threadIdx.x; idx < nh * TM; idx += THREADS) {
    const int j = idx / TM, r = idx % TM, h = h0 + j;
    const long long bch = ((long long)b * nc + c) * H + h;
    const int q = q0 + r, k = k0 + r;
    cq[idx] = q < qc ? cumw[bch * Q + q] : 0.f;
    float kv = 0.f, d = 0.f;
    if (k < qc) {
      kv = cumw[bch * Q + k];
      d = dt[(pos0 + k) * H + h];
      if (mask != nullptr && !mask[pos0 + k]) d = 0.f;
    }
    ck[idx] = kv;
    dk[idx] = d;
  }
  const float* cbt = cb + (((long long)b * G + g) * nc + c) * Q * Q;
#pragma unroll                                 // CB at this thread's elements
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + frag_row(m, e), k = k0 + frag_col(n, e);
        cbs[((m * WN + n) * 4 + e) * THREADS + threadIdx.x] =
            q < qc && k <= q ? cbt[(long long)q * Q + k] : 0.f;
      }
  __syncthreads();

  const long long ldx = (long long)H * P;
  const int ps = cdiv(P, KS);
  const int wn = (threadIdx.x >> 5) & 1, tg = threadIdx.x & 3;
  // on a diagonal pair, warp (0, 1)'s columns k all lie past its rows q
  const bool dead = ti == tj && threadIdx.x >> 5 == 1;
  float4 ra[4], rb[4];
  float acc[2][WN][4] = {}, lo[2][WN][4] = {}, dsm[2][WN][4] = {};
  stages(nh * ps, [&](int s) {
    const int h = h0 + s / ps, p0 = s % ps * KS;
    Tile<TM, KS>::load(ra, dy + ((pos0 + q0) * H + h) * P + p0, ldx, qc - q0,
                       P - p0, vec);
    Tile<TM, KS>::load(rb, x + ((pos0 + k0) * H + h) * P + p0, ldx, qc - k0,
                       P - p0, vec);
  }, [&](int s, int i) {
    float* at = buf + i * BUF;
    Tile<TM, KS>::store(ra, at, at + TILE, S4, Identity{});
    Tile<TM, KS>::store(rb, at + 2 * TILE, at + 3 * TILE, S4,
                        ScaleRows{dk + s / ps * TM});
  }, [&](int s, int i) {
    const int j = s / ps, p0 = s % ps * KS;
    mma_stage<false, false>(acc, lo, buf + i * BUF,
                            dead ? 0 : cdiv(min(KS, P - p0), 8));
    if (s % ps != ps - 1) return;              // head j's D block is done
    double rs[2][2] = {}, cs[WN][2] = {};      // W's sums, f64
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = frag_row(m, e), cl = frag_col(n, e);
          const int q = q0 + r, k = k0 + cl;
          float d = 0.f;
          if (q < qc && k <= q)
            d = (lo[m][n][e] + acc[m][n][e]) *
                __expf(cq[j * TM + r] - ck[j * TM + cl]);
          const double w = (double)d * cbs[((m * WN + n) * 4 + e) * THREADS +
                                           threadIdx.x];
          rs[m][e >> 1] += w;
          cs[n][e & 1] += w;
          dsm[m][n][e] += d;
          acc[m][n][e] = 0.f;
          lo[m][n][e] = 0.f;
        }
    // the row sums over a quad's 4 lanes and the column sums over the 8
    // lanes of a column group, each lane ending with one of them (a
    // reduce-scatter: 3 and 7 shuffles); a partial per (k tile, warp
    // column) for the rows, per (q tile, warp row) for the columns
    const double r0 = quad_scatter(rs[0][0], rs[0][1], rs[1][0], rs[1][1]);
    const int q = q0 + frag_row(tg >> 1, 2 * (tg & 1));
    if (q < qc) rintra[(((pos0 + q) * H + h0 + j) * qt + tj) * 2 + wn] = r0;
    const int wm = threadIdx.x >> 6, gq = (threadIdx.x & 31) >> 2;
    const double c0 = column_scatter(cs);
    const int k = k0 + frag_col(gq >> 1, gq & 1);
    if (k < qc) cintra[(((pos0 + k) * H + h0 + j) * qt + ti) * 2 + wm] = c0;
  });

  float* ds = dsum + ((((long long)b * G + g) * runs + run) * nc + c) * Q * Q;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + frag_row(m, e), k = k0 + frag_col(n, e);
        if (q < qc && k < qc) ds[(long long)q * Q + k] = dsm[m][n][e];
      }
}

// Kernels 5: a group's dB (DB) or dC for one 64-row tile (positions t0 ..
// t0 + 63 of the chunk) and 64 state dims, as a sum over K of
//   phase 1, each run's summed D: dB[k][n] += sum_q D[q][k] C[q][n] (q from
//     t0), dC[q][n] += sum_k D[q][k] B[k][n] (k below the tile's end);
//   phase 2, each head of the group in order: its product W_h, dB's
//     (x[k][p] dt[k] se[k]) Gx[p][n] or dC's (exp(cum_q) dy[q][p]) S[p][n]
//     (none in chunk 0 without an initial state), the row scales read with
//     each stage's loads and applied before the split;
// each run's and each head's products summed on the MMAs, those sums added
// in f32 (flush).  Before a head's sum is added, its row term <R_t, W_h,t>
// (R = B for dB: T_k = <xdt_k, dxdt_inter,k>; R = C for dC: rinter_q =
// C_q . dC_inter,q), this block's 64 state dims of it, goes to rdot[b, s,
// h][n tile][warp column].  A block takes split `sp` of `splits` runs of
// the tile's units (phase 1's runs, then the heads; a unit is never cut):
// with one split it writes the result, else its partial sum into part[sp],
// which ssd_bwd_dbc_sum_kernel adds in split order.  Grid (the chunks'
// tiles, G * cdiv(N, 64) * splits, B).
template <bool DB>
__device__ __forceinline__ void dbc(
    const float* __restrict__ x, const float* __restrict__ dt,
    const uint8_t* __restrict__ mask, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ init,
    const float* __restrict__ states, const float* __restrict__ dy,
    const float* __restrict__ gx, const float* __restrict__ cumw,
    const float* __restrict__ dsum, float* __restrict__ out,
    float* __restrict__ part, double* __restrict__ rdot, int S, int H, int P,
    int G, int N, int Q, int nc, int runs, int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* rf = smem;                            // [32][THREADS] R, a thread's
  float* buf = rf + 32 * THREADS;
  int c, it;
  tile_of(blockIdx.x, Q, nc, c, it);
  const int ntiles = cdiv(N, TM), sp = blockIdx.y % splits;
  const int g = blockIdx.y / splits / ntiles;
  const int nt = blockIdx.y / splits % ntiles, n0 = nt * TM;
  const int b = blockIdx.z, hg = H / G;
  const int qc = min(Q, S - c * Q), t0 = it * TM, rv = qc - t0;
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const long long ldx = (long long)H * P, ldc = (long long)G * N;
  const int kbeg = DB ? t0 : 0, kend = DB ? qc : min(t0 + TM, qc);
  const int n1r = cdiv(kend - kbeg, KS), n1 = runs * n1r;
  const bool state = DB || c > 0 || init != nullptr;
  const int ps = cdiv(P, KS), units = runs + (state ? hg : 0);
  auto first = [&](int u) { return u <= runs ? u * n1r : n1 + (u - runs) * ps; };
  const int sb = first((int)((long long)units * sp / splits));
  const int se = first((int)((long long)units * (sp + 1) / splits));
  const long long qq = (long long)Q * Q;
  const float* ds0 = dsum + (((long long)b * G + g) * runs * nc + c) * qq;
  const float* oth = (DB ? Cm : Bm) + (pos0 * G + g) * N + n0;
  const float* rrow = (DB ? Bm : Cm) + ((pos0 + t0) * G + g) * N + n0;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(m, e), cl = frag_col(n, e);
        rf[((m * WN + n) * 4 + e) * THREADS + threadIdx.x] =
            r < rv && n0 + cl < N ? rrow[r * ldc + cl] : 0.f;
      }
  const int wn = (threadIdx.x >> 5) & 1, tg = threadIdx.x & 3;
  float4 ra[4], rb[4];
  float cr[4], dr[4], cl = 0.f;                // phase 2's row scale inputs
  float acc[2][WN][4] = {}, tot[2][WN][4] = {};
  if (se > sb) stages(se - sb, [&](int u) {
    const int s = sb + u;
    if (s < n1) {
      const int j0 = kbeg + s % n1r * KS;
      const float* ds = ds0 + (long long)(s / n1r) * nc * qq;
      if (DB)
        Tile<KS, TM>::load(ra, ds + (long long)j0 * Q + t0, Q, qc - j0, rv,
                           vec);
      else
        Tile<TM, KS>::load(ra, ds + (long long)t0 * Q + j0, Q, rv, kend - j0,
                           vec);
      Tile<KS, TM>::load(rb, oth + j0 * ldc, ldc, kend - j0, N - n0, vec);
      return;
    }
    const int h = g * hg + (s - n1) / ps, p0 = (s - n1) % ps * KS;
    const long long bch = ((long long)b * nc + c) * H + h;
    Tile<TM, KS>::load(ra, (DB ? x : dy) + ((pos0 + t0) * H + h) * P + p0, ldx,
                       rv, P - p0, vec);
    const float* sm = DB ? gx + bch * P * N
                      : c > 0 ? states + bch * P * N
                              : init + ((long long)b * H + h) * P * N;
    Tile<KS, TM>::load(rb, sm + (long long)p0 * N + n0, N, P - p0, N - n0,
                       vec);
    if (DB) cl = cumw[bch * Q + qc - 1];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = t0 + Tile<TM, KS>::row(q);
      cr[q] = k < qc ? cumw[bch * Q + k] : 0.f;
      dr[q] = 0.f;
      if (DB && k < qc && (mask == nullptr || mask[pos0 + k]))
        dr[q] = dt[(pos0 + k) * H + h];
    }
  }, [&](int u, int i) {
    const int s = sb + u;
    float* at = buf + i * BUF;
    if (s < n1) {
      if (DB)
        Tile<KS, TM>::store(ra, at, at + TILE, S8, Identity{});
      else
        Tile<TM, KS>::store(ra, at, at + TILE, S4, Identity{});
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ra[q] = DB ? scale4(scale4(ra[q], dr[q]), expf(cl - cr[q]))
                   : scale4(ra[q], expf(cr[q]));
      Tile<TM, KS>::store(ra, at, at + TILE, S4, Identity{});
    }
    Tile<KS, TM>::store(rb, at + 2 * TILE, at + 3 * TILE, S8, Identity{});
  }, [&](int u, int i) {
    const int s = sb + u;
    if (s < n1) {
      const int j0 = kbeg + s % n1r * KS;
      mma_stage<DB, true>(acc, acc, buf + i * BUF,
                          cdiv(min(KS, kend - j0), 8));
      if (s % n1r == n1r - 1) flush(tot, acc);
      return;
    }
    const int p0 = (s - n1) % ps * KS;
    mma_stage<false, true>(acc, acc, buf + i * BUF,
                           cdiv(min(KS, P - p0), 8));
    if ((s - n1) % ps != ps - 1) return;
    const int h = g * hg + (s - n1) / ps;      // head h's W_h is whole
    double v[2][2] = {};                       // its row terms, f64
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[m][e >> 1] += (double)acc[m][n][e] *
                          rf[((m * WN + n) * 4 + e) * THREADS + threadIdx.x];
    const double r0 = quad_scatter(v[0][0], v[0][1], v[1][0], v[1][1]);
    const int r = frag_row(tg >> 1, 2 * (tg & 1));
    if (r < rv) rdot[(((pos0 + t0 + r) * H + h) * ntiles + nt) * 2 + wn] = r0;
    flush(tot, acc);
  });

  float* dst = (splits == 1 ? out
                : part + (long long)sp * gridDim.z * S * ldc) +
               ((pos0 + t0) * G + g) * N + n0;
  epilogue(tot, buf, [&](int r, int cc, float4 v) {
    if (r < rv) put4(dst + r * ldc + cc, v, N - n0 - cc, vec);
  });
}

#define DBC_ARGS                                                             \
  const float *__restrict__ x, const float *__restrict__ dt,                \
      const uint8_t *__restrict__ mask, const float *__restrict__ Bm,        \
      const float *__restrict__ Cm, const float *__restrict__ init,          \
      const float *__restrict__ states, const float *__restrict__ dy,        \
      const float *__restrict__ gx, const float *__restrict__ cumw,          \
      const float *__restrict__ dsum, float *__restrict__ out,               \
      float *__restrict__ part, double *__restrict__ rdot, int S, int H,     \
      int P, int G, int N, int Q, int nc, int runs, int splits, int vec

__global__ void __launch_bounds__(THREADS) ssd_bwd_db_kernel(DBC_ARGS) {
  dbc<true>(x, dt, mask, Bm, Cm, init, states, dy, gx, cumw, dsum, out, part,
            rdot, S, H, P, G, N, Q, nc, runs, splits, vec);
}

__global__ void __launch_bounds__(THREADS) ssd_bwd_dc_kernel(DBC_ARGS) {
  dbc<false>(x, dt, mask, Bm, Cm, init, states, dy, gx, cumw, dsum, out, part,
             rdot, S, H, P, G, N, Q, nc, runs, splits, vec);
}

// Kernel 5's split sums: dB (blockIdx.y = 0) and dC (1), each element the
// sum of its `splits` partials in split order.  Grid (cdiv(B S G N, 256),
// 2).
__global__ void __launch_bounds__(RED_THREADS)
ssd_bwd_dbc_sum_kernel(const float* __restrict__ part, float* __restrict__ dB,
                       float* __restrict__ dC, long long total, int splits) {
  const long long e = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= total) return;
  const float* src = part + (long long)blockIdx.y * splits * total + e;
  float v = 0.f;
  for (int i = 0; i < splits; ++i) v += src[(long long)i * total];
  (blockIdx.y == 0 ? dB : dC)[e] = v;
}

// Kernel 6: per (b, chunk, head), one position a thread: d cum = W's row
// sums (kernel 4's k-tile partials) + rinter (kernel 5's dC partials; none
// in chunk 0 without an initial state) - W's column sums (kernel 4's
// partials) - T (kernel 5's dB partials), the last real position also
// gsdot + sum_k T_k (gsdot = exp(cum_last) <Gx, S>, S the state entering
// the chunk); d(dt a) = its reverse
// inclusive cumsum; ddt = a d(dt a) + xdot (0 where masked or past S), and
// the chunk's share of da, sum dt d(dt a).  Grid (nc, H, B).
__global__ void __launch_bounds__(RED_THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ init,
                      const float* __restrict__ states,
                      const float* __restrict__ gx,
                      const float* __restrict__ decay,
                      const double* __restrict__ rintra,
                      const double* __restrict__ cintra,
                      const double* __restrict__ rinter,
                      const double* __restrict__ tdot,
                      const float* __restrict__ xdot,
                      float* __restrict__ ddt, double* __restrict__ dapart,
                      int S, int H, int P, int N, int Q, int nc, int vec) {
  __shared__ double red[8], wsum[8], last;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int j = threadIdx.x, lane = j & 31, w = j >> 5;
  const int qc = min(Q, S - c * Q), qt = cdiv(Q, TM), nr = 2 * cdiv(N, TM);
  const long long pos0 = (long long)b * S + (long long)c * Q;
  const long long at = (pos0 + j) * H + h;
  const long long bc = ((long long)b * nc + c) * H + h;
  const bool real = j < qc;
  const bool live = real && (mask == nullptr || mask[pos0 + j]);
  const float* st =
      c > 0 ? states + bc * P * N
      : init != nullptr ? init + ((long long)b * H + h) * P * N : nullptr;
  double t = 0.0;
  if (real)
    for (int u = 0; u < nr; ++u) t += tdot[at * nr + u];
  const double tsum = block_sum<RED_THREADS>(t, red);
  double gv = 0.0;                             // <Gx, S>, 4 floats a load
  const float* gp = gx + bc * P * N;
  if (st != nullptr && vec)
    for (int e = 4 * j; e < P * N; e += 4 * RED_THREADS) {
      const float4 u = *reinterpret_cast<const float4*>(gp + e);
      const float4 z = *reinterpret_cast<const float4*>(st + e);
      gv += (double)u.x * z.x + (double)u.y * z.y + (double)u.z * z.z +
            (double)u.w * z.w;
    }
  else if (st != nullptr)
    for (int e = j; e < P * N; e += RED_THREADS) gv += (double)gp[e] * st[e];
  const double gs = block_sum<RED_THREADS>(gv, red);
  if (j == 0) last = decay[bc] * gs + tsum;
  __syncthreads();
  const int tiles = cdiv(qc, TM);
  const float dtj = live ? dt[at] : 0.f;
  double v = 0.0;
  if (real) {
    for (int u = 0; u < 2 * (j / TM + 1); ++u) v += rintra[at * 2 * qt + u];
    double ri = 0.0, ci = 0.0;
    if (st != nullptr)
      for (int u = 0; u < nr; ++u) ri += rinter[at * nr + u];
    for (int u = 2 * (j / TM); u < 2 * tiles; ++u) ci += cintra[at * 2 * qt + u];
    v = v + ri - ci - t;
  }
  if (j == qc - 1) v += last;
  // reverse inclusive scan: thread j sums positions j .. QMAX-1
  double incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += o;
  }
  if (lane == 0) wsum[w] = incl;
  __syncthreads();
  double base = 0.0;
  for (int k = RED_THREADS / 32 - 1; k > w; --k) base += wsum[k];
  const double dda = base + incl;
  if (real) ddt[at] = live ? (float)((double)a[h] * dda + xdot[at]) : 0.f;
  const double share = block_sum<RED_THREADS>(dtj * dda, red);
  if (j == 0) dapart[bc] = share;
}

// Kernel 7: da[h] = sum over (b, chunk) of dapart, in index order.
__global__ void ssd_bwd_da_kernel(const double* __restrict__ dapart,
                                  float* __restrict__ da, int H, int rows) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  double s = 0.0;
  for (int r = 0; r < rows; ++r) s += dapart[(long long)r * H + h];
  da[h] = (float)s;
}

constexpr size_t BUFS_BYTES = sizeof(float) * 2 * BUF;
constexpr size_t ADJ_SMEM = sizeof(float) * (2 * QMAX + 4) + BUFS_BYTES;
constexpr size_t DXDT_SMEM = sizeof(float) * (QMAX + 4 * TM) + BUFS_BYTES;
constexpr size_t DD_SMEM =
    sizeof(float) * (3 * RUN * TM + 32 * THREADS) + BUFS_BYTES;
constexpr size_t DBC_SMEM = sizeof(float) * 32 * THREADS + BUFS_BYTES;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Per device, on its first call: the SM count, the kernels' shared-memory
// limits, and the side stream and events that run kernel 4 and the dC
// kernel beside kernels 2-3 and the dB kernel (a call inside a graph
// capture then only launches and records).
struct Device {
  int sms;
  cudaStream_t side;
  cudaEvent_t fork, dd_done, dc_done;
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
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_adj_kernel, attr,
                                  (int)ADJ_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_dxdt_kernel, attr,
                                  (int)DXDT_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_dd_kernel, attr,
                                  (int)DD_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_db_kernel, attr,
                                  (int)DBC_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_dc_kernel, attr,
                                  (int)DBC_SMEM)) != cudaSuccess ||
      (err = cudaStreamCreateWithFlags(&d.side, cudaStreamNonBlocking)) !=
          cudaSuccess ||
      (err = cudaEventCreateWithFlags(&d.fork, cudaEventDisableTiming)) !=
          cudaSuccess ||
      (err = cudaEventCreateWithFlags(&d.dd_done, cudaEventDisableTiming)) !=
          cudaSuccess ||
      (err = cudaEventCreateWithFlags(&d.dc_done, cudaEventDisableTiming)) !=
          cudaSuccess)
    return err;
  ready |= 1ull << dev;
  return cudaSuccess;
}

// Where each piece of the workspace sits (16-byte aligned floats), and the
// grids.  Kernel 5 splits K where its blocks (tiles x groups x 64-column
// tiles x rows) are fewer than two an SM: into as many splits as bring
// them to two an SM, at most one a head.
struct Plan {
  int nc, qt, tiles, pairs, runs, splits;
  size_t gx, cum, rintra, cintra, rinter, tdot, xdot, dsum, part, decay,
      dapart, bytes;
};

Plan plan(int sms, int batch, int S, int H, int P, int G, int N, int Q) {
  Plan p;
  p.nc = cdiv(S, Q);
  p.qt = cdiv(Q, TM);
  const int qtl = cdiv(S - (p.nc - 1) * Q, TM);
  p.tiles = (p.nc - 1) * p.qt + qtl;
  p.pairs = (p.nc - 1) * (p.qt * (p.qt + 1) / 2) + qtl * (qtl + 1) / 2;
  p.runs = cdiv(H / G, RUN);
  const long long blocks = (long long)p.tiles * G * cdiv(N, TM) * batch;
  p.splits = (int)std::max(1LL, std::min<long long>(H / G, 2LL * sms / blocks));
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += (floats * sizeof(float) + 15) / 16 * 16;
    return at;
  };
  const size_t bsh = (size_t)batch * S * H, bch = (size_t)batch * p.nc * H;
  p.gx = take(bch * P * N);
  p.cum = take(bch * Q);
  p.rintra = take(2 * bsh * 2 * p.qt);         // doubles
  p.cintra = take(2 * bsh * 2 * p.qt);
  p.rinter = take(2 * bsh * 2 * cdiv(N, TM));
  p.tdot = take(2 * bsh * 2 * cdiv(N, TM));
  p.xdot = take(bsh);
  p.dsum = take((size_t)batch * G * p.runs * p.nc * Q * Q);
  p.part = take(p.splits > 1 ? 2 * (size_t)p.splits * batch * S * G * N : 0);
  p.decay = take(bch);
  p.dapart = take(2 * bch);
  p.bytes = off;
  return p;
}

bool valid(int batch, int S, int H, int P, int G, int N, int Q) {
  return batch >= 1 && S >= 1 && H >= 1 && P >= 1 && P <= PMAX && G >= 1 &&
         H % G == 0 && N >= 1 && N <= NMAX && Q >= 1 && Q <= QMAX &&
         batch <= 65535 && H * cdiv(N, TM) <= 65535 &&
         G * cdiv(H / G, RUN) <= 65535 && cdiv(S, Q) <= 65535;
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
  Device* d = nullptr;
  const cudaError_t err = prepare(&d);
  if (err != cudaSuccess) return (int)err;
  *bytes = (long long)plan(d->sms, batch, S, H, P, G, N, Q).bytes;
  return 0;
}

// The backward of one ssd_scan_tc_launch call on the same x, dt, a, B, C,
// mask and init: cb and states are that call's C B^T and chunk states, at
// ssd_scan_tc_layout's offsets in its workspace (states slot 0 unread: chunk
// 0 enters from init, or 0 where init is null).  dy (B,S,H,P) and dfinal
// (B,H,P,N; null: 0) are the output gradients.  Writes dx (B,S,H,P), ddt
// (B,S,H), da (H), dB and dC (B,S,G,N) and, where dinit is not null, the
// initial state's gradient (B,H,P,N).  ws: a 16-byte aligned buffer of
// ssd_scan_bwd_workspace's bytes.  Launches eight kernels (nine where
// kernel 5 splits K), ordered on `stream`: kernel 4 and the dC kernel on
// a side stream forked from it after kernel 1, beside kernels 2-3 and the
// dB kernel, joined back before the split sums and kernel 6.  Returns a
// cudaError_t (0 = launched).
int ssd_scan_bwd_launch(const float* x, const float* dt, const float* a,
                        const float* Bm, const float* Cm, const uint8_t* mask,
                        const float* init, const float* cb,
                        const float* states, const float* dy,
                        const float* dfinal, void* ws, float* dx, float* ddt,
                        float* da, float* dB, float* dC, float* dinit,
                        int batch, int S, int H, int P, int G, int N, int Q,
                        void* stream) {
  if (!valid(batch, S, H, P, G, N, Q)) return (int)cudaErrorInvalidValue;
  Device* d = nullptr;
  cudaError_t err = prepare(&d);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Plan pl = plan(d->sms, batch, S, H, P, G, N, Q);
  char* base = static_cast<char*>(ws);
  auto at = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  auto at2 = [&](size_t off) { return reinterpret_cast<double*>(base + off); };
  float *gx = at(pl.gx), *cumw = at(pl.cum), *xdot = at(pl.xdot);
  double *rintra = at2(pl.rintra), *cintra = at2(pl.cintra);
  double *rinter = at2(pl.rinter), *tdot = at2(pl.tdot);
  double* dapart = at2(pl.dapart);
  float *dsum = at(pl.dsum), *decay = at(pl.decay), *part = at(pl.part);
  const int nc = pl.nc, ntiles = cdiv(N, TM);
  const int vec = P % 4 == 0 && N % 4 == 0 && Q % 4 == 0 && aligned16(x) &&
                  aligned16(dy) && aligned16(Bm) && aligned16(Cm) &&
                  aligned16(cb) && aligned16(states) && aligned16(ws) &&
                  aligned16(dx) && aligned16(dB) && aligned16(dC) &&
                  (init == nullptr || aligned16(init));

  ssd_bwd_adj_kernel<<<dim3(nc, H * ntiles, batch), THREADS, ADJ_SMEM, st>>>(
      dt, a, Cm, mask, dy, gx, cumw, decay, S, H, P, G, N, Q, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaEventRecord(d->fork, st)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(d->side, d->fork, 0)) != cudaSuccess)
    return (int)err;
  // the side stream: kernel 4, then the dC kernel (they need cum, not Gx)
  const dim3 gdbc(pl.tiles, G * ntiles * pl.splits, batch);
  const long long total = (long long)batch * S * G * N;
  ssd_bwd_dd_kernel<<<dim3(pl.pairs, G * pl.runs, batch), THREADS, DD_SMEM,
                      d->side>>>(x, dt, mask, cb, dy, cumw, dsum, rintra,
                                 cintra, S, H, P, G, Q, nc, pl.runs, vec);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaEventRecord(d->dd_done, d->side)) != cudaSuccess)
    return (int)err;
  ssd_bwd_dc_kernel<<<gdbc, THREADS, DBC_SMEM, d->side>>>(
      x, dt, mask, Bm, Cm, init, states, dy, gx, cumw, dsum, dC,
      part + pl.splits * total, rinter, S, H, P, G, N, Q, nc, pl.runs,
      pl.splits, vec);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaEventRecord(d->dc_done, d->side)) != cudaSuccess)
    return (int)err;
  if (P * N % 4 == 0 && aligned16(ws) &&
      (dfinal == nullptr || aligned16(dfinal)) &&
      (dinit == nullptr || aligned16(dinit)))
    ssd_bwd_pass_kernel<4><<<dim3(cdiv(P * N / 4, PASS_THREADS), H, batch),
                             PASS_THREADS, 0, st>>>(dfinal, gx, decay, dinit,
                                                    H, P, N, nc);
  else
    ssd_bwd_pass_kernel<1><<<dim3(cdiv(P * N, PASS_THREADS), H, batch),
                             PASS_THREADS, 0, st>>>(dfinal, gx, decay, dinit,
                                                    H, P, N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dxdt_kernel<<<dim3(pl.tiles, H, batch), THREADS, DXDT_SMEM, st>>>(
      x, dt, Bm, mask, cb, dy, gx, cumw, dx, xdot, S, H, P, G, N, Q, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaStreamWaitEvent(st, d->dd_done, 0)) != cudaSuccess)
    return (int)err;
  ssd_bwd_db_kernel<<<gdbc, THREADS, DBC_SMEM, st>>>(
      x, dt, mask, Bm, Cm, init, states, dy, gx, cumw, dsum, dB, part, tdot,
      S, H, P, G, N, Q, nc, pl.runs, pl.splits, vec);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaStreamWaitEvent(st, d->dc_done, 0)) != cudaSuccess)
    return (int)err;
  if (pl.splits > 1) {
    ssd_bwd_dbc_sum_kernel<<<dim3((unsigned)((total + RED_THREADS - 1) /
                                             RED_THREADS),
                                  2),
                             RED_THREADS, 0, st>>>(part, dB, dC, total,
                                                   pl.splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssd_bwd_reduce_kernel<<<dim3(nc, H, batch), RED_THREADS, 0, st>>>(
      dt, a, mask, init, states, gx, decay, rintra, cintra, rinter, tdot, xdot,
      ddt, dapart, S, H, P, N, Q, nc,
      P * N % 4 == 0 && aligned16(ws) && aligned16(states) &&
          (init == nullptr || aligned16(init)));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_da_kernel<<<cdiv(H, RED_THREADS), RED_THREADS, 0, st>>>(
      dapart, da, H, batch * nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
