// SpMV / SpMM over a padded row layout, shared by the SELL, RGCSR and
// BCSR kernels (sell_spmv.cu, rgcsr_spmv.cu, bcsr_spmv.cu). Each format
// supplies a `Row` policy that yields, per stored position w of a row, the
// column to gather and whether the position holds a real entry:
//
//   struct Row {
//     struct Args { ... };                       // the format's index arrays
//     __device__ Row(const Args&, long long r);  // row r's state
//     __device__ int stop(int wg) const;  // positions from here on are masked
//     __device__ int fetch(long long e);  // the stored word at element e
//     static constexpr bool SHARED_COLS;  // rows share columns (below)
//   };
//
// The warp SpMM reads each row with one lane, a few positions ahead of the
// arithmetic:
//
//     __device__ bool take(int word, int w, long long* col);
//
// `fetch` and `take` are each called for w = 0, 1, 2, ... in order (fetch
// runs a few positions ahead), so either may carry state. A policy with
// SHARED_COLS reads `Args::group`: each aligned run of `group` rows (a
// power of two dividing 32) has the same column and mask at every
// position, so the warp SpMM reads x once for the run. The SpMV
// (spmv_lanes_kernel) reads each row with T lanes, lane t of the row
// taking positions w = t (mod T):
//
//     template <int T>
//     __device__ bool step(int word, bool in, long long* col);
//
// `step` is called by all 32 lanes of the warp together (it may shuffle),
// once for each step of T positions w0 + t, w0 = 0, T, 2T, ... in order;
// `in` is false for a position at or past the row's stop, whose word was
// not loaded. The BCSR SpMV has its own kernel, bcsr_spmv.cu.
//
// Layout on the card (kernels/padded.py::interleave): the flat (R, wg) view
// of the reference's (S, rows, wg) arrays, stored in chunks of 32 rows as
// (ceil(R / 32), wg, 32). Element w of row r lies at
// ((r / 32) * wg + w) * 32 + r % 32, so 32 neighbouring rows read 32
// neighbouring words per position.
//
// Arithmetic: one fixed order per row and column,
//   acc = +0;  for w: acc = acc + (ok ? val * x[clip(col)] : 0)
// with __fmul_rn/__fadd_rn (or the double forms), so no FMA contraction
// differs between kernels, column tiles or the plain torch versions. A
// masked term is never multiplied: a NaN or inf in x never reaches a
// padded entry. Both kernels stop each row at its `stop`: every later
// position is masked, and skipping a masked term is bitwise adding its +0
// (the accumulator starts at +0 and, under round-to-nearest, a sum is -0
// only when both addends are, so it is never -0, and acc + (+0) == acc
// for every other value).
//
// The kernels:
//   * spmv_lanes_kernel (SELL and RGCSR SpMV): LANES = 4 lanes a row, 256
//     threads a block, so that four times the rows' loads are in flight
//     (one thread a row left the head of SmolLM-135M at 1,536 warps, too
//     few to cover HBM latency). Lane t loads the word and value of its
//     row's positions t, t + 4, ... (the lanes of one t read 8 neighbouring
//     words a position), LANES_UNROLL steps of loads issued before their x
//     reads; the warp walks to the longest stop of its 8 rows and each lane
//     predicates off its loads past its own row's. The products of a step
//     reach the row's sum in position order through __shfl_sync: every
//     lane of the row adds p_0, p_1, p_2, p_3, so every lane holds the same
//     sum and lane t = 0 writes y. x is read through L1 (__ldg): on the
//     head of SmolLM-135M it is 2.3 KB, and staging it in shared memory
//     was no faster on the H100 (experiments/padded_spmv_geometry/). Bound
//     by bytes: the real entries' words and values, once.
//   * spmm_warp_kernel (SELL, RGCSR and BCSR SpMM): one warp per
//     interleaved chunk of 32 rows and slab of columns, lanes mapped to
//     columns. Lane i
//     loads row i's word and value for position w (one coalesced 128-byte
//     load each) and runs the Row policy; __ballot_sync gathers which rows
//     are live, the lanes write their (column, value) pairs to a per-warp
//     buffer in shared memory (SmemRows), and for each live row the warp
//     reads the row's pair with one broadcast load, so that lane b reads
//     x[col, c0 + b]: one conflict-free row of the slab's x columns, which
//     the block stages in shared memory where they fit (StagedX; else one
//     coalesced line through L1, GlobalX), per live (row, position); rows
//     that share their column with the row before (SHARED_COLS) take that
//     row's x instead of reading it again, and f32 rows in runs of two or
//     more are read two at a time (one 16-byte load of both pairs). Each
//     lane holds its columns' accumulators for all the chunk's rows in
//     registers; y is written at the end, one line per row. A full-width
//     f32 slab may give each lane NC = 2 columns (64 accumulators); a slab
//     narrower than a warp rounds up to a power of two BW and puts 32 / BW
//     row groups in the warp. The chunk stops at its longest row's stop,
//     and masked terms are skipped.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace padded {

constexpr int CHUNK = 32;  // rows per interleaved chunk: one warp
constexpr unsigned FULL = 0xFFFFFFFFu;
// spmv_lanes_kernel: lanes a row, threads a block, and steps of LANES
// positions whose loads are issued together. 1, 2, 4 and 8 lanes, 2 and 4
// steps, x staged or via L1 were timed on the H100
// (experiments/padded_spmv_geometry/).
constexpr int LANES = 4;
constexpr int LANES_THREADS = 256;
constexpr int LANES_UNROLL = 4;
// spmm_warp_kernel: most warps a block (kernels/tiling.py::
// PADDED_MAX_WARPS), positions whose loads run ahead of the arithmetic,
// rows a batch (x loads in flight per column), and the most shared memory
// a block may opt in to (tiling.MAX_SMEM_BYTES).
constexpr int WARP_MAX_THREADS = 512;
constexpr int AHEAD = 2;
constexpr int ROWS_UNROLL = 8;
constexpr int MAX_SMEM = 232448;

template <typename V> struct Num;
template <> struct Num<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Num<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

__device__ __forceinline__ long long clampll(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// Offset of row r's position 0; position w is CHUNK * w further on.
__device__ __forceinline__ long long row_base(long long r, int wg) {
  return (r / CHUNK) * (long long)wg * CHUNK + (r % CHUNK);
}

// y (R,) = A x with LANES lanes a row.
template <typename V, typename Row>
__global__ void __launch_bounds__(LANES_THREADS)
spmv_lanes_kernel(typename Row::Args ra, const V* __restrict__ val,
                  long long R, int wg, const V* __restrict__ x, long long n,
                  V* __restrict__ y) {
  constexpr int T = LANES;
  constexpr int RW = CHUNK / T;  // rows a warp
  const int lane = threadIdx.x & 31;
  const int t = lane / RW;  // this lane's positions: w = t (mod T)
  const long long first =
      (((long long)blockIdx.x * LANES_THREADS + threadIdx.x) >> 5) * RW;
  if (first >= R) return;  // the whole warp
  const long long row = first + lane % RW;
  const bool real = row < R;
  const long long rr = real ? row : R - 1;
  Row rp(ra, rr);
  const int stop = real ? rp.stop(wg) : 0;
  const int wstop = (int)__reduce_max_sync(FULL, (unsigned)stop);
  const long long e0 = row_base(rr, wg) + (long long)t * CHUNK;
  V acc = V(0);
  for (int w0 = 0; w0 < wstop; w0 += T * LANES_UNROLL) {
    int word[LANES_UNROLL];
    V v[LANES_UNROLL];
    bool in[LANES_UNROLL];
#pragma unroll
    for (int u = 0; u < LANES_UNROLL; ++u) {
      const long long e = e0 + (long long)(w0 + u * T) * CHUNK;
      in[u] = w0 + u * T + t < stop;
      word[u] = in[u] ? rp.fetch(e) : 0;
      v[u] = in[u] ? __ldg(val + e) : V(0);
    }
    V p[LANES_UNROLL];
#pragma unroll
    for (int u = 0; u < LANES_UNROLL; ++u) {
      long long col;
      const bool ok = rp.template step<T>(word[u], in[u], &col);
      p[u] = ok ? Num<V>::mul(v[u], __ldg(x + clampll(col, n - 1))) : V(0);
    }
#pragma unroll
    for (int u = 0; u < LANES_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < T; ++k)
        acc = Num<V>::add(acc, __shfl_sync(FULL, p[u], k * RW + lane % RW));
  }
  if (real && t == 0) y[row] = acc;
}

// Where a warp reads x of its slab: `at(col, off)` is x[col, c0 + bl + off]
// for the lane's column bl. Both are built by every thread of the block
// before any warp leaves.
//
// StagedX: the slab's (n, SW) columns copied to shared memory by the whole
// block, then read as xs[col * SW + off + bl] (32-bit addresses, no tag
// lookup, and never evicted by the streaming index and value loads).
template <typename V, int SW> struct StagedX {
  static constexpr bool IN_BOUNDS = true;  // columns past the slab read 0
  // Shared memory of the slab, rounded up to 16 bytes.
  __host__ __device__ static size_t bytes(long long n) {
    return ((size_t)n * SW * sizeof(V) + 15) & ~(size_t)15;
  }
  const V* xs;
  __device__ StagedX(const V* x, long long n, long long B, long long c0,
                     int sw, int bl) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    V* s = reinterpret_cast<V*>(smem_raw);
    for (long long i = threadIdx.x; i < n * SW; i += blockDim.x) {
      const int c = (int)(i % SW);
      s[i] = c < sw ? __ldg(x + (i / SW) * B + c0 + c) : V(0);
    }
    __syncthreads();
    xs = s + bl;
  }
  __device__ V at(int col, int off) const { return xs[col * SW + off]; }
};

// GlobalX: x read through L1 (__ldg), for a slab too large to stage; the
// warps resident on an SM walk the same slab, so its lines stay there.
template <typename V, int SW> struct GlobalX {
  static constexpr bool IN_BOUNDS = false;
  __host__ __device__ static size_t bytes(long long) { return 0; }
  const V* xb;
  long long B;
  __device__ GlobalX(const V* x, long long, long long B_, long long c0,
                     int, int bl)
      : xb(x + c0 + bl), B(B_) {}
  __device__ V at(int col, int off) const {
    return __ldg(xb + (long long)col * B + off);
  }
};

// How a warp hands each row's column and value (loaded by the row's own
// lane) to the lanes of its row group: through a per-warp buffer of 32
// (column, value) pairs in shared memory after the x slab, one 8-byte
// (f32) or 16-byte (f64) broadcast load per row. (Two __shfl_sync per row
// took as long or up to a fifth longer on an H100: PERF.md.)
template <typename V> struct SmemRows {
  struct alignas(sizeof(V) == 8 ? 16 : 8) Pair {
    int c;
    V v;
  };
  static constexpr size_t BYTES = CHUNK * sizeof(Pair);  // a warp's buffer
  Pair* buf;
  __device__ explicit SmemRows(size_t off) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    buf = reinterpret_cast<Pair*>(smem_raw + off) + (threadIdx.x >> 5) * CHUNK;
  }
  __device__ void put(int ci, V vi) {
    __syncwarp();  // every lane has read the previous position's pairs
    buf[threadIdx.x & 31] = Pair{ci, vi};
    __syncwarp();
  }
  __device__ void get(int src, int* ck, V* vk) const {
    const Pair p = buf[src];
    *ck = p.c;
    *vk = p.v;
  }
  // Rows src and src + 1 (src even, f32 pairs): one 16-byte load. The
  // rows share their column here (SHARED_COLS), so only src's is kept.
  __device__ void get2(int src, int* ck, V* v0, V* v1) const {
    static_assert(sizeof(Pair) == 8, "two f32 pairs a 16-byte load");
    const int4 q = *reinterpret_cast<const int4*>(buf + src);
    *ck = q.x;
    *v0 = __int_as_float(q.y);
    *v1 = __int_as_float(q.w);
  }
};

// Bit j set where row j of a lane's BW rows reads x itself: every row, or
// for a Row with SHARED_COLS the first of each aligned run of `group` rows
// (the runs align with the lane's rows: both are powers of two, and a
// chunk starts at a multiple of 32).
template <typename Row, int BW>
__device__ __forceinline__ unsigned lead_bits(const typename Row::Args& ra) {
  if constexpr (!Row::SHARED_COLS) {
    return FULL;
  } else {
    const int run = ra.group < BW ? ra.group : BW;
    unsigned bits = 0;
    for (int j = 0; j < BW; j += run) bits |= 1u << j;
    return bits;
  }
}

// The live bits of rows j .. j + RB - 1 of every row group.
template <int BW, int RB>
__device__ __forceinline__ constexpr unsigned batch_bits(int j) {
  unsigned rep = 0;
  for (int g = 0; g < CHUNK; g += BW) rep |= 1u << g;
  return (((RB >= 32) ? FULL : ((1u << RB) - 1u)) << j) * rep;
}

// Y (R, B) = A X, X (n, B) row-major, in column tiles of bt. A work item
// is one chunk of 32 rows and one slab of BW * NC columns of a tile; items
// run slab-major (block b: slab b / bps, chunks (b % bps) * warps + warp),
// so the warps resident at once share the slab's x lines. Lane (g, bl),
// g = lane / BW, owns rows g * BW + j (j < BW) of the chunk at columns
// c0 + c * BW + bl (c < NC). A row that shares its column with the row
// before (lead_bits) takes that row's x, which is the same value; with f32
// values and runs of 2 or more such rows, the lanes read rows two at a
// time (one 16-byte load of both pairs, one live bit, one x read).
template <typename V, typename Row, int BW, int NC, typename X>
__global__ void __launch_bounds__(WARP_MAX_THREADS)
spmm_warp_kernel(typename Row::Args ra, const V* __restrict__ val,
                 long long R, int wg, const V* __restrict__ x, long long n,
                 long long B, int bt, long long chunks, long long per_tile,
                 V* __restrict__ y) {
  constexpr int SW = BW * NC;               // columns of a slab
  constexpr int RB = ROWS_UNROLL < BW ? ROWS_UNROLL : BW;  // rows a batch
  // rows two at a time: runs of >= 2 rows sharing columns, f32 pairs
  constexpr bool PAIRS = Row::SHARED_COLS && sizeof(V) == 4 && RB >= 2;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long bps = (chunks + warps - 1) / warps;
  const long long slab = blockIdx.x / bps;
  const long long chunk = (blockIdx.x % bps) * warps + (threadIdx.x >> 5);
  const long long tile = slab / per_tile;
  const long long c0 = tile * bt + (slab % per_tile) * SW;
  const long long tend = (tile + 1) * bt < B ? (tile + 1) * bt : B;
  const int sw = (int)(tend - c0 < SW ? tend - c0 : SW);
  const int g = BW == CHUNK ? 0 : lane / BW;
  const int bl = BW == CHUNK ? lane : lane % BW;
  const X xs(x, n, B, c0, sw, bl);  // (StagedX synchronises the block)
  if (chunk >= chunks || sw <= 0) return;
  SmemRows<V> rows(X::bytes(n));

  const long long r = chunk * CHUNK + lane;  // the row whose words we load
  const bool real = r < R;
  Row row(ra, real ? r : R - 1);
  const int stop = (int)__reduce_max_sync(
      FULL, real ? (unsigned)row.stop(wg) : 0u);
  bool on[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) on[c] = c * BW + bl < sw;
  V acc[BW][NC];
#pragma unroll
  for (int j = 0; j < BW; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[j][c] = V(0);
  const unsigned lead = lead_bits<Row, BW>(ra);
  bool paired = false;
  if constexpr (PAIRS) paired = ra.group >= 2;  // warp-uniform
  V xg[NC];  // the x of the last row read, for the rows that share it
#pragma unroll
  for (int c = 0; c < NC; ++c) xg[c] = V(0);

  const long long e0 = chunk * (long long)wg * CHUNK + lane;
  int word[AHEAD];
  V vr[AHEAD];
#pragma unroll
  for (int p = 0; p < AHEAD; ++p)
    if (p < stop) {
      word[p] = row.fetch(e0 + (long long)p * CHUNK);
      vr[p] = __ldg(val + e0 + (long long)p * CHUNK);
    }
  for (int w0 = 0; w0 < stop; w0 += AHEAD) {
#pragma unroll
    for (int p = 0; p < AHEAD; ++p) {
      const int w = w0 + p;
      if (w >= stop) break;
      const int cur = word[p];
      const V v = vr[p];
      if (w + AHEAD < stop) {
        const long long e = e0 + (long long)(w + AHEAD) * CHUNK;
        word[p] = row.fetch(e);
        vr[p] = __ldg(val + e);
      }
      long long col;
      const bool ok = row.take(cur, w, &col) && real;
      const unsigned live = __ballot_sync(FULL, ok);
      if (live == 0) continue;
      rows.put((int)clampll(col, n - 1), v);
#pragma unroll
      for (int j = 0; j < BW; j += RB) {
        if ((live & batch_bits<BW, RB>(j)) == 0) continue;
        if constexpr (PAIRS) {
          if (paired) {  // rows j + 2h and j + 2h + 1 share column and mask
            constexpr int RP = RB / 2;
            int ck[RP];
            V v0[RP], v1[RP], xv[RP][NC];
            bool lk[RP];
#pragma unroll
            for (int h = 0; h < RP; ++h) {
              const int src = g * BW + j + 2 * h;
              rows.get2(src, &ck[h], &v0[h], &v1[h]);
              lk[h] = (live >> src) & 1u;
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                if (!((lead >> (j + 2 * h)) & 1u))
                  xv[h][c] = h ? xv[h > 0 ? h - 1 : 0][c] : xg[c];
                else
                  xv[h][c] = (lk[h] && (X::IN_BOUNDS || on[c]))
                                 ? xs.at(ck[h], c * BW)
                                 : V(0);
              }
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) xg[c] = xv[RP - 1][c];
#pragma unroll
            for (int h = 0; h < RP; ++h)
#pragma unroll
              for (int c = 0; c < NC; ++c)
                if (lk[h]) {
                  acc[j + 2 * h][c] = Num<V>::add(
                      acc[j + 2 * h][c], Num<V>::mul(v0[h], xv[h][c]));
                  acc[j + 2 * h + 1][c] = Num<V>::add(
                      acc[j + 2 * h + 1][c], Num<V>::mul(v1[h], xv[h][c]));
                }
            continue;
          }
        }
        int ck[RB];
        V vk[RB], xv[RB][NC];
        bool lk[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int src = g * BW + j + k;
          rows.get(src, &ck[k], &vk[k]);
          lk[k] = (live >> src) & 1u;  // warp-uniform when BW == 32
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (Row::SHARED_COLS && !((lead >> (j + k)) & 1u))
              xv[k][c] = k ? xv[k > 0 ? k - 1 : 0][c] : xg[c];
            else
              xv[k][c] = (lk[k] && (X::IN_BOUNDS || on[c]))
                             ? xs.at(ck[k], c * BW)
                             : V(0);
          }
        }
        // (A batch skipped above is dead, and so is every row that shares
        // the x of its rows: this carry may then be stale, never used.)
        if constexpr (Row::SHARED_COLS) {
#pragma unroll
          for (int c = 0; c < NC; ++c) xg[c] = xv[RB - 1][c];
        }
        // A lane past the slab's width sums what is never stored.
#pragma unroll
        for (int k = 0; k < RB; ++k)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (lk[k])
              acc[j + k][c] =
                  Num<V>::add(acc[j + k][c], Num<V>::mul(vk[k], xv[k][c]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BW; ++j) {
    const long long rr = chunk * CHUNK + g * BW + j;
    if (rr >= R) continue;
    V* yr = y + rr * B + c0 + bl;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (on[c]) yr[c * BW] = acc[j][c];
  }
}

// y (R,) = A x through spmv_lanes_kernel.
template <typename Row, typename V>
int launch_spmv_lanes(const typename Row::Args& ra, const void* val,
                      long long R, int wg, const void* x, long long n,
                      void* y, void* stream) {
  const long long blocks = (R * LANES + LANES_THREADS - 1) / LANES_THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  spmv_lanes_kernel<V, Row><<<(unsigned)blocks, LANES_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      ra, static_cast<const V*>(val), R, wg, static_cast<const V*>(x), n,
      static_cast<V*>(y));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// spmm_warp_kernel's launch: the geometry comes from kernels/tiling.py::
// padded_geometry and is checked here against the work it must cover.
// ---------------------------------------------------------------------------

struct WarpGeom {
  int bw;           // lanes of a row group: columns at once (power of 2)
  int nc;           // columns a lane (2 only at bw == 32, f32)
  int warps;        // warps a block
  int stage;        // 1: x of the slab staged in shared memory (StagedX)
  long long blocks;
};

struct WarpWork {
  long long chunks, per_tile, blocks;
  size_t smem;
};

// The blocks and shared memory a geometry needs for (R, n, B, bt), or
// blocks = -1 if it is not one this code takes.
inline WarpWork warp_work(const WarpGeom& g, long long R, long long n,
                          long long B, int bt, int itemsize) {
  WarpWork w{(R + CHUNK - 1) / CHUNK, 0, -1, 0};
  const bool pow2 = g.bw >= 1 && g.bw <= 32 && (g.bw & (g.bw - 1)) == 0;
  const bool nc_ok = g.nc == 1 || (g.nc == 2 && g.bw == 32 && itemsize == 4);
  if (!pow2 || !nc_ok || bt < 1 || g.warps < 1 ||
      g.warps * 32 > WARP_MAX_THREADS || (g.stage != 0 && g.stage != 1))
    return w;
  w.smem = g.stage ? (((size_t)n * g.bw * g.nc * itemsize + 15) & ~(size_t)15)
                   : 0;
  w.smem += (size_t)g.warps *
            (itemsize == 8 ? SmemRows<double>::BYTES : SmemRows<float>::BYTES);
  if (w.smem > (size_t)MAX_SMEM) return w;
  w.per_tile = (bt + g.bw * g.nc - 1) / (g.bw * g.nc);
  const long long tiles = (B + bt - 1) / bt;
  const long long bps = (w.chunks + g.warps - 1) / g.warps;
  w.blocks = tiles * w.per_tile * bps;
  if (w.blocks > INT_MAX) w.blocks = -1;
  return w;
}

template <typename V, typename Row, int BW, int NC, typename X>
int launch_warp(const typename Row::Args& ra, const void* val, long long R,
                int wg, const void* x, long long n, long long B, int bt,
                const WarpGeom& g, const WarpWork& w, void* y,
                void* stream) {
  auto* kern = spmm_warp_kernel<V, Row, BW, NC, X>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w.smem);
  if (err != cudaSuccess) return (int)err;
  if (!g.stage) {  // reading x through L1: give L1 the SM's most
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxL1);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)w.blocks, g.warps * 32, w.smem,
         static_cast<cudaStream_t>(stream)>>>(
      ra, static_cast<const V*>(val), R, wg, static_cast<const V*>(x), n, B,
      bt, w.chunks, w.per_tile, static_cast<V*>(y));
  return (int)cudaGetLastError();
}

template <typename V, typename Row, int BW, int NC>
int pick_x(const typename Row::Args& ra, const void* val, long long R,
           int wg, const void* x, long long n, long long B, int bt,
           const WarpGeom& g, const WarpWork& w, void* y, void* stream) {
  return g.stage ? launch_warp<V, Row, BW, NC, StagedX<V, BW * NC>>(
                       ra, val, R, wg, x, n, B, bt, g, w, y, stream)
                 : launch_warp<V, Row, BW, NC, GlobalX<V, BW * NC>>(
                       ra, val, R, wg, x, n, B, bt, g, w, y, stream);
}

#define PADDED_WARP_ARGS ra, val, R, wg, x, n, B, bt, g, w, y, stream

// Y (R, B) = A X through spmm_warp_kernel with the geometry `g`; refuses
// (cudaErrorInvalidValue) a geometry that does not cover the work or that
// is not instantiated.
template <typename Row, typename V>
int launch_spmm_warp(const typename Row::Args& ra, const void* val,
                     long long R, int wg, const void* x, long long n,
                     long long B, int bt, const WarpGeom& g, void* y,
                     void* stream) {
  const WarpWork w = warp_work(g, R, n, B, bt, (int)sizeof(V));
  if (w.blocks < 1 || w.blocks != g.blocks) return (int)cudaErrorInvalidValue;
  if (g.nc == 2) {
    if constexpr (sizeof(V) == 4)
      return pick_x<V, Row, 32, 2>(PADDED_WARP_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (g.nc != 1) return (int)cudaErrorInvalidValue;
  switch (g.bw) {
    case 1: return pick_x<V, Row, 1, 1>(PADDED_WARP_ARGS);
    case 2: return pick_x<V, Row, 2, 1>(PADDED_WARP_ARGS);
    case 4: return pick_x<V, Row, 4, 1>(PADDED_WARP_ARGS);
    case 8: return pick_x<V, Row, 8, 1>(PADDED_WARP_ARGS);
    case 16: return pick_x<V, Row, 16, 1>(PADDED_WARP_ARGS);
    default: return pick_x<V, Row, 32, 1>(PADDED_WARP_ARGS);
  }
}

#undef PADDED_WARP_ARGS

}  // namespace padded
