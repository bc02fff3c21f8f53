// Decode-size LUT GEMMs on Hopper's bf16 tensor cores (sm_90a).
//
// Replaces, for the calls kernels/lut_gemm/lut_gemm.py routes here (bf16 x,
// M <= 32, N % 16 == 0, K % 4 == 0, 16-byte aligned bases: takes_tc for the
// D&C wrappers, route() == "tc" for the full table), the Pallas TPU kernels
//   * src/repro/kernels/lut_gemm/lut_gemm.py:214 lut_gemm_dc
//       out = (x @ (HI[q>>2] + LO[q&3] - zp)) * scale
//   * src/repro/kernels/lut_gemm/lut_gemm.py:168 lut_gemm_dc_res
//       out = (x @ (HI[q>>2] + LO[q&3] + RES[q] - zp)) * scale
//   * src/repro/kernels/lut_gemm/lut_gemm.py:78 lut_gemm (full-table mode,
//     lut_gemm_tc_full_launch)
//       out = (x @ CB[q]) * scale
// which lut_gemm.cu ported first on f32 FMAs; that kernel keeps f32 x,
// unaligned shapes and the D&C calls at M > 32 (the full table's larger M
// run lut_gemm_wgmma.cu).
// x (M, K) bf16; codes (K, N) int8 in [0, 16), one per byte, row-major;
// hi, lo (4,) f32; res (16,) f32 or NULL; zp, scale (N,) f32; out (M, N) f32;
// in full-table mode cb (16,) f32 and no hi, lo, res or zp.
//
// What bounds it: bytes.  At decode's M = 8 a code byte feeds 16 flops; one
// yi-9b layer's 7 projections read 173 MB of codes, 0.052 ms at 3.35 TB/s.
// At that rate an SM must take ~14.5 codes a clock, which leaves its four
// schedulers ~9 thread instructions a code; lut_gemm.cu spends ~24 (its 8
// f32 FMAs a code alone take ~90% of the byte time).  So the products go
// to the tensor cores and the per-code work is a table lookup:
//   * exact bf16 pieces of the table.  The prologue builds the 16 f32 values
//     T[q] = HI[q>>2] + LO[q&3] (+ RES[q]) in the plain version's order (in
//     full-table mode T[q] = CB[q], read as it is) and
//     cuts each into three bf16 pieces by truncation: p1 = T with its low 16
//     bits cleared, p2 the same of T - p1, p3 = T - p1 - p2.  They sum back
//     to T exactly (3 x 8 significand bits; exact for |T| >= 2^-110 and T =
//     0); every partial sum p1, p1 + p2, T lies in T's binade, so even an
//     adder that aligns to its largest input keeps it; and x is bf16, so
//     every product x * p is exact in f32.  Pieces that are zero for all 16
//     codes are skipped by a branch every warp takes alike (each builds the
//     table from the same inputs; no host sync, so the launch still
//     captures in a graph): lut4's table T[q] = q runs one product, NF4 up
//     to three (NF4's full codebook too);
//   * mma.sync.m16n8k16 bf16 -> f32 with the weight as the 16-row A operand
//     (output columns) and x^T as the 8-column B operand (batch rows; M <=
//     32 is up to four n-tiles, which reuse each A fragment), plus one
//     product with an all-ones A: rowsum(x), in the same split and order as
//     the sums it corrects (the full table has no zero point and skips it);
//   * the fragment order chosen for contiguous bytes: a thread's 16 A rows
//     over eight m16 tiles are 16 consecutive columns (tile i, row g -> column
//     16 g + 2 i, row g + 8 -> 16 g + 2 i + 1), and its four k of a step
//     (2t, 2t+1, 2t+8, 2t+9) are the rows 4t .. 4t+3 of the 16-row K step,
//     with x permuted the same way.  So a thread reads one 16-byte chunk of
//     codes per row and one 8-byte chunk of x per n-tile;
//   * the lookup.  T[q] = q (lut4): the magic-number conversion, bf16
//     0x4300 | q = 128 + q by one byte permute, minus 128 (exact), 1.25
//     instructions a code and no table.  Any other table: a 256-entry
//     table indexed by the pair of codes an A register holds (q_even + 16
//     q_odd, one shift-or makes four indices, a byte permute each), one a
//     piece, its bf16x2 entries replicated 32 times against bank conflicts
//     (32 KB a piece), one 32-bit shared load a pair and piece.  Three
//     pieces are 6 bytes of shared memory a code: at 128 bytes a clock an
//     SM that bounds the table path near 35 us a yi-9b layer;
//   * the zero point in each warp's epilogue: acc - rowsum(x) zp[n] by one
//     fmaf, rowsum taken over the warp's own K steps, as acc is; then the
//     split sums and the scale.  At x = a row of I one warp holds acc =
//     T[q] and rowsum = 1, which rounds T[q] - zp once, as the plain
//     version does, and every other partial is zero: the dequantized
//     weight reads back bitwise (full table: acc = CB[q], times the scale);
//   * bytes in flight: each thread loads its own chunks straight into
//     registers (16-byte non-caching loads, masked past K, N and M), each
//     step's two steps ahead of the one it computes (a three-step register
//     ring): 64 KB an SM in flight at 16 warps.
//     A cp.async ring into shared memory of the same chunks streamed at
//     most ~1.7 TB/s on the card (tools/lut_gemm_stream_probe.py), the
//     register ring ~2.6 TB/s; the first two steps are in flight while the
//     prologue builds the table;
//   * split-K without a workspace or a second launch: 8 warps split a
//     block's K slice and are summed through shared memory in warp order;
//     up to 16 blocks of a thread-block cluster (above 8 a non-portable
//     size, which H100 takes) split K and are summed
//     through distributed shared memory in rank order, each rank writing
//     its share of the outputs; fewer when that many clusters would not
//     all fit on the card at once (a second wave of a few clusters would
//     double the time).  The order is fixed: results are deterministic;
//   * ragged M, N and K are masked in the kernel (zero-filled loads,
//     masked stores).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;                  // warps a block
constexpr int THREADS = NW * 32;
constexpr int MT = 8;                  // m16 tiles a warp: 16 columns a thread
constexpr int BN = 16 * MT;            // columns a block (every warp: all)
constexpr int KSTEP = 16;              // K rows an MMA step
constexpr int MAX_NT = 4;              // n8 tiles: M <= 32
constexpr int MAX_CLUSTER = 16;        // K slices summed through DSMEM
constexpr int TAB1_BYTES = 256 * 32 * 4;    // one piece's pairs, 32 copies
constexpr int TAB_BYTES = 3 * TAB1_BYTES;
constexpr int SLOTS = 4 * MT + 2;      // acc and 2 rowsums a thread, n-tile
constexpr int RING = 3;                // K steps a thread holds in registers
constexpr uint32_t BF16X2_ONES = 0x3F803F80u;
// a thread a pair-table entry (256), a zero point or scale a thread (2 BN)
static_assert(THREADS == 256 && THREADS == 2 * BN, "block geometry");

// how a code becomes its pieces: T[q] = q by the magic number, else the
// pair table with 1, 2 or 3 pieces
enum Path : int { MAGIC = 0, TABLE1 = 1, TABLE2 = 2, TABLE3 = 3 };

// the block's sums and the warps' partials, after the main loop (they
// reuse the tables' space)
template <int NT>
__host__ __device__ constexpr int red_bytes() {
  return (NT * 4 * MT * 32 + NW * NT * SLOTS * 32) * 4;
}

template <int NT>
__host__ __device__ constexpr int smem_bytes() {
  return TAB_BYTES > red_bytes<NT>() ? TAB_BYTES : red_bytes<NT>();
}

__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// d (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bytes (sel) of z, each under a 0x43 high byte -> bf16x2 {128 + q, 128 +
// q'}, then minus 128 (exact): the codes themselves as bf16
__device__ __forceinline__ uint32_t magic(uint32_t z, uint32_t sel) {
  const uint32_t v = __byte_perm(z, 0x43434343u, sel);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(v), "r"(BF16X2_ONES), "r"(0xC300C300u));
  return r;
}

// The pair tables, one a piece: entry (q_even + 16 q_odd) = bf16x2
// {p[q_even], p[q_odd]} at piece * TAB1_BYTES + idx * 128 + copy * 4, 32
// copies, so a warp's 32-bit loads hit every bank once whatever the
// indices and each lands in its A register.  Thread idx writes entry idx
// from the pieces lane q of every warp holds, its 16-byte stores rotated
// by idx so that neighbours hit other banks.
__device__ __forceinline__ void build_tables(uint8_t* smem,
                                             const uint32_t (&piece)[3],
                                             int pieces) {
  const int idx = threadIdx.x, qa = idx & 15, qb = idx >> 4;
  for (int p = 0; p < 3; ++p) {
    const uint32_t e = __shfl_sync(0xFFFFFFFFu, piece[p], qa) |
                       (__shfl_sync(0xFFFFFFFFu, piece[p], qb) << 16);
    if (p >= pieces) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint4*>(smem + p * TAB1_BYTES + idx * 128 +
                                ((c + idx) & 7) * 16) = make_uint4(e, e, e, e);
  }
}

// This thread's chunks of one K step: 16 code bytes (its columns) of rows
// 4t .. 4t+3, and per n-tile 4 bf16 of x (row 8j + g, the same k).
template <int NT>
struct Step {
  uint4 u[4];
  uint2 xv[NT];
};

// Where this thread's next K step is: the codes of its rows 4t .. 4t+3
// at its 16 columns and x's rows 8j + g at the same k; each load moves it
// one step on.  A row past K keeps the codes the buffer held (any code is
// a finite weight, and x past K is zero); a column past N is never stored.
template <int NT>
struct Cursor {
  const int8_t* c;
  const uint8_t* x[NT];
  int row;
  size_t step_bytes;         // 16 rows of codes
  bool col_ok;
  bool m_ok[NT];

  __device__ __forceinline__ Cursor(const uint8_t* __restrict__ xp,
                                    const int8_t* __restrict__ codes, int M,
                                    int K, int N, int col, int s) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    row = s * KSTEP + 4 * t;
    c = codes + (size_t)row * N + col;
    step_bytes = (size_t)KSTEP * N;
    col_ok = col < N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      m_ok[j] = 8 * j + g < M;
      x[j] = xp + ((size_t)(8 * j + g) * K + row) * 2;
    }
  }

  __device__ __forceinline__ void load(Step<NT>& st, int K, int N) {
#pragma unroll
    for (int kr = 0; kr < 4; ++kr)
      if (col_ok && row + kr < K) st.u[kr] = ldg_stream(c + (size_t)kr * N);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      st.xv[j] = (m_ok[j] && row < K)
                     ? __ldg(reinterpret_cast<const uint2*>(x[j]))
                     : make_uint2(0, 0);
      x[j] += KSTEP * 2;
    }
    c += step_bytes;
    row += KSTEP;
  }
};

// One K step into the accumulators: rowsum(x), then per word column c the
// A fragments of tiles 2c and 2c+1 (magic number or pair table) times x.
template <int NT, int PATH, bool FULL>
__device__ __forceinline__ void compute_step(const Step<NT>& st,
                                             const uint8_t* tab,
                                             float (&acc)[MT][NT][4],
                                             float (&rs)[NT][4]) {
  if (!FULL) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma(rs[j], BF16X2_ONES, BF16X2_ONES, BF16X2_ONES, BF16X2_ONES,
          st.xv[j].x, st.xv[j].y);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // word c of each row: columns 4c .. 4c+3, tiles 2c and 2c+1
    const uint32_t w0 = (&st.u[0].x)[c], w1 = (&st.u[1].x)[c];
    const uint32_t w2 = (&st.u[2].x)[c], w3 = (&st.u[3].x)[c];
    // byte n of i01 / i23: q(row 0) + 16 q(row 1) of column 4c + n
    const uint32_t i01 = w0 | (w1 << 4), i23 = w2 | (w3 << 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[3][4];
      if (PATH == MAGIC) {
        // z: {col 4c+2h: rows 0, 1}, {col 4c+2h+1: rows 0, 1} as bytes
        const uint32_t z01 = __byte_perm(w0, w1, h ? 0x7362 : 0x5140);
        const uint32_t z23 = __byte_perm(w2, w3, h ? 0x7362 : 0x5140);
        a[0][0] = magic(z01, 0x4140);
        a[0][1] = magic(z01, 0x4342);
        a[0][2] = magic(z23, 0x4140);
        a[0][3] = magic(z23, 0x4342);
      } else {
        // the index of A register r: byte 2h + (r & 1) of i01 (r < 2) or
        // of i23, moved to the low byte by one permute
        const uint32_t idx[4] = {__byte_perm(i01, 0, 0x4440 + 2 * h),
                                 __byte_perm(i01, 0, 0x4441 + 2 * h),
                                 __byte_perm(i23, 0, 0x4440 + 2 * h),
                                 __byte_perm(i23, 0, 0x4441 + 2 * h)};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int p = 0; p < PATH; ++p)
            a[p][r] = *reinterpret_cast<const uint32_t*>(
                tab + p * TAB1_BYTES + idx[r] * 128);
      }
      constexpr int NP = PATH == MAGIC ? 1 : PATH;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma(acc[2 * c + h][j], a[p][0], a[p][1], a[p][2], a[p][3],
              st.xv[j].x, st.xv[j].y);
    }
  }
}

// The warp's K steps [s0, s0 + nsteps): a three-step register ring, steps
// s0 and s0 + 1 already in flight in buf; each step's loads go out two
// steps ahead, before the step in hand is computed.
template <int NT, int PATH, bool FULL>
__device__ __forceinline__ void main_loop(Step<NT> (&buf)[RING],
                                          Cursor<NT>& cur, const uint8_t* smem,
                                          int K, int N, int nsteps,
                                          float (&acc)[MT][NT][4],
                                          float (&rs)[NT][4]) {
  const uint8_t* tab = smem + (threadIdx.x & 31) * 4;
  for (int i = 0; i < nsteps; i += RING) {
#pragma unroll
    for (int b = 0; b < RING; ++b) {
      if (i + b < nsteps) {
        if (i + b + RING - 1 < nsteps)
          cur.load(buf[(b + RING - 1) % RING], K, N);
        compute_step<NT, PATH, FULL>(buf[b], tab, acc, rs);
      }
    }
  }
}

// One block: BN columns of out over one K slice (cluster rank along y).
// FULL: the table is cb (hi, lo, res, zp unused), no rowsum, no zero point.
template <int NT, bool FULL>
__global__ void __launch_bounds__(THREADS, NT == 1 ? 2 : 1)
lut_gemm_tc_kernel(const uint8_t* __restrict__ x,
                   const int8_t* __restrict__ codes,
                   const float* __restrict__ hi, const float* __restrict__ lo,
                   const float* __restrict__ res,
                   const float* __restrict__ cb,
                   const float* __restrict__ zp,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_zp[BN], s_scale[BN];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * BN;
  const int col = col0 + 16 * (lane >> 2);
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();

  // this warp's K steps: the block's slice in NW contiguous runs; the
  // first two go in flight before anything else
  const int ksteps = (K + KSTEP - 1) / KSTEP;
  const int per = (ksteps + csize - 1) / csize;
  const int b0 = min(ksteps, rank * per), b1 = min(ksteps, b0 + per);
  const int wper = (b1 - b0 + NW - 1) / NW;
  const int s0 = min(b1, b0 + warp * wper);
  const int nsteps = min(b1, s0 + wper) - s0;
  Step<NT> buf[RING] = {};
  Cursor<NT> cur(x, codes, M, K, N, col, s0);
#pragma unroll
  for (int b = 0; b < RING - 1; ++b)
    if (b < nsteps) cur.load(buf[b], K, N);
  // one zero point or scale of the block's columns a thread, kept for
  // the epilogue
  const int zc = col0 + (tid & (BN - 1));
  const float zs = zc >= N         ? 0.f
                   : tid >= BN      ? scale[zc]
                   : FULL           ? 0.f
                                    : zp[zc];

  // the table, its pieces and the path, by every warp (the same inputs,
  // so the same path in every warp: no barrier on the magic path)
  uint32_t piece[3];
  int path;
  {
    const int q = lane & 15;
    float tq;
    if (FULL) {
      tq = cb[q];
    } else {
      tq = hi[q >> 2] + lo[q & 3];
      if (res != nullptr) tq = tq + res[q];
    }
    const uint32_t p1 = __float_as_uint(tq) & 0xFFFF0000u;
    const float r1 = tq - __uint_as_float(p1);
    const uint32_t p2 = __float_as_uint(r1) & 0xFFFF0000u;
    const float r2 = r1 - __uint_as_float(p2);
    piece[0] = p1 >> 16;
    piece[1] = p2 >> 16;
    piece[2] = __float_as_uint(r2) >> 16;
    const bool not_q = __any_sync(0xFFFFFFFFu, tq != (float)q);
    const bool has2 = __any_sync(0xFFFFFFFFu, (piece[1] & 0x7FFFu) != 0);
    const bool has3 = __any_sync(0xFFFFFFFFu, (piece[2] & 0x7FFFu) != 0);
    path = !not_q ? MAGIC : has3 ? TABLE3 : has2 ? TABLE2 : TABLE1;
  }
  if (path != MAGIC) {
    build_tables(smem, piece, path);
    __syncthreads();
  }

  float acc[MT][NT][4], rs[NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) rs[j][c] = 0.f;

  switch (path) {
    case MAGIC:
      main_loop<NT, MAGIC, FULL>(buf, cur, smem, K, N, nsteps, acc, rs);
      break;
    case TABLE1:
      main_loop<NT, TABLE1, FULL>(buf, cur, smem, K, N, nsteps, acc, rs);
      break;
    case TABLE2:
      main_loop<NT, TABLE2, FULL>(buf, cur, smem, K, N, nsteps, acc, rs);
      break;
    default:
      main_loop<NT, TABLE3, FULL>(buf, cur, smem, K, N, nsteps, acc, rs);
  }

  // the warps' partials, slot (j * SLOTS + e) * 32 + lane: e < 4 MT
  // acc[e / 4][j][e % 4] (column col + 2 (e / 4) + (e % 4) / 2, row 8 j +
  // 2 t + e % 2), then the rowsums of rows 8 j + 2 t and 8 j + 2 t + 1
  if (path != MAGIC) __syncthreads();       // the tables are free
  float* bsum = reinterpret_cast<float*>(smem);      // [NT * 4 MT][32]
  float* red = bsum + NT * 4 * MT * 32;              // [NW][NT * SLOTS][32]
  {
    float* mine = red + warp * NT * SLOTS * 32 + lane;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mine[(j * SLOTS + 4 * i + c) * 32] = acc[i][j][c];
      mine[(j * SLOTS + 4 * MT) * 32] = rs[j][0];
      mine[(j * SLOTS + 4 * MT + 1) * 32] = rs[j][1];
    }
  }
  (tid < BN ? s_zp : s_scale)[tid & (BN - 1)] = zs;
  __syncthreads();
  // each warp's split takes its zero point, acc - rowsum * zp by one
  // fmaf (the full table has none); the splits summed in warp order
  for (int e = tid; e < NT * 4 * MT * 32; e += THREADS) {
    const int j = e / (4 * MT * 32), ic = (e >> 5) % (4 * MT), ln = e & 31;
    const float z = s_zp[16 * (ln >> 2) + 2 * (ic >> 2) + ((ic & 3) >> 1)];
    const float* a = red + (j * SLOTS + ic) * 32 + ln;
    const float* r = red + (j * SLOTS + 4 * MT + (ic & 1)) * 32 + ln;
    float v = FULL ? a[0] : fmaf(-r[0], z, a[0]);
#pragma unroll
    for (int w = 1; w < NW; ++w)
      v += FULL ? a[w * NT * SLOTS * 32]
                : fmaf(-r[w * NT * SLOTS * 32], z, a[w * NT * SLOTS * 32]);
    bsum[e] = v;
  }

  // the cluster's blocks, summed in rank order through distributed shared
  // memory; each rank finishes its share of the outputs
  cluster.sync();
  constexpr int TOTAL = NT * 4 * MT * 32;
  for (int e = rank * THREADS + tid; e < TOTAL; e += csize * THREADS) {
    const int j = e / (4 * MT * 32), ic = (e >> 5) % (4 * MT), ln = e & 31;
    const int i = ic >> 2, c = ic & 3;
    const int n = col0 + 16 * (ln >> 2) + 2 * i + (c >> 1);
    const int m = 8 * j + 2 * (ln & 3) + (c & 1);
    if (m >= M || n >= N) continue;
    // every rank's partial in flight at once, then summed in rank order
    float part[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      part[q] = q < csize ? cluster.map_shared_rank(bsum, q)[e] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < csize) v += part[q];
    out[(size_t)m * N + n] = v * s_scale[n - col0];
  }
  cluster.sync();           // keep this block's sums until all have read
}

template <int NT, bool FULL>
cudaError_t launch(const void* x, const void* codes, const void* hi,
                   const void* lo, const void* res, const void* cb,
                   const void* zp, const void* scale, void* out, int M, int K,
                   int N, int splits, cudaStream_t st) {
  // the shared-memory limit and the non-portable cluster sizes are set once
  // per device (one bit each): a call inside a graph capture then only
  // launches
  static unsigned long long sized = 0;
  auto kern = lut_gemm_tc_kernel<NT, FULL>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((sized >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NT>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < 64) sized |= 1ull << dev;
  }
  // the largest cluster (K slices) <= splits whose clusters all fit on the
  // card at once: a second wave of a few clusters would double the time
  const int tiles = (N + BN - 1) / BN;
  static int fits[64][MAX_CLUSTER + 1];
  for (; splits > 1; --splits) {
    int& n = fits[dev < 64 ? dev : 63][splits];
    if (n == 0) {
      cudaLaunchConfig_t q = {};
      q.gridDim = dim3(1, splits, 1);
      q.blockDim = dim3(THREADS, 1, 1);
      q.dynamicSmemBytes = smem_bytes<NT>();
      cudaLaunchAttribute a[1];
      a[0].id = cudaLaunchAttributeClusterDimension;
      a[0].val.clusterDim.x = 1;
      a[0].val.clusterDim.y = splits;
      a[0].val.clusterDim.z = 1;
      q.attrs = a;
      q.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n, kern, &q);
      if (err != cudaSuccess) return err;
      n = n > 0 ? n : -1;
    }
    if (tiles <= n) break;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<NT>();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const uint8_t*>(x),
      static_cast<const int8_t*>(codes), static_cast<const float*>(hi),
      static_cast<const float*>(lo), static_cast<const float*>(res),
      static_cast<const float*>(cb), static_cast<const float*>(zp),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The checks both entry points share: x (M, K) bf16 and codes (K, N) int8,
// contiguous, 16-byte aligned, K % 4 == 0, N % 16 == 0, 1 <= M <= 32, K in
// `splits` (<= 16, the cluster size) slices.
bool valid(const void* x, const void* codes, int M, int K, int N,
           int splits) {
  return M > 0 && M <= 8 * MAX_NT && K > 0 && N > 0 && K % 4 == 0 &&
         N % 16 == 0 && splits > 0 && splits <= MAX_CLUSTER &&
         splits <= (K + KSTEP - 1) / KSTEP &&
         (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(codes) & 15) == 0 &&
         (N + BN - 1) / BN <= 65535;
}

template <bool FULL>
int dispatch(const void* x, const void* codes, const void* hi, const void* lo,
             const void* res, const void* cb, const void* zp,
             const void* scale, void* out, int M, int K, int N, int splits,
             void* stream) {
  if (!valid(x, codes, M, K, N, splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((M + 7) / 8) {
    case 1:
      return (int)launch<1, FULL>(x, codes, hi, lo, res, cb, zp, scale, out,
                                  M, K, N, splits, st);
    case 2:
      return (int)launch<2, FULL>(x, codes, hi, lo, res, cb, zp, scale, out,
                                  M, K, N, splits, st);
    case 3:
      return (int)launch<3, FULL>(x, codes, hi, lo, res, cb, zp, scale, out,
                                  M, K, N, splits, st);
    default:
      return (int)launch<4, FULL>(x, codes, hi, lo, res, cb, zp, scale, out,
                                  M, K, N, splits, st);
  }
}

}  // namespace

extern "C" {

// Geometry the host must respect; the Python wrapper reads these.
int lut_gemm_tc_block_n() { return BN; }
int lut_gemm_tc_max_m() { return 8 * MAX_NT; }
int lut_gemm_tc_max_cluster() { return MAX_CLUSTER; }
int lut_gemm_tc_kstep() { return KSTEP; }

// One D&C launch on `stream` (see valid() for the shapes); res may be NULL
// (lut_gemm_dc).  Returns the cudaError_t of the launch (0 = cudaSuccess).
int lut_gemm_tc_launch(const void* x, const void* codes, const void* hi,
                       const void* lo, const void* res, const void* zp,
                       const void* scale, void* out, int M, int K, int N,
                       int splits, void* stream) {
  return dispatch<false>(x, codes, hi, lo, res, nullptr, zp, scale, out, M,
                         K, N, splits, stream);
}

// One full-table launch: T[q] = cb[q], (16,) f32; no zero point.  As
// lut_gemm_tc_launch otherwise.
int lut_gemm_tc_full_launch(const void* x, const void* codes, const void* cb,
                            const void* scale, void* out, int M, int K, int N,
                            int splits, void* stream) {
  return dispatch<true>(x, codes, nullptr, nullptr, nullptr, cb, nullptr,
                        scale, out, M, K, N, splits, stream);
}

}  // extern "C"
