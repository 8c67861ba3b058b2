// Blocked CSR (BCSR) SpMV / SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/bcsr_spmv.py::_bcsr_kernel       (bcsr_spmv_pallas)
//   src/repro/kernels/bcsr_spmv.py::_bcsr_spmm_kernel  (bcsr_spmm_pallas,
//     with the column tiles of kernels/tiling.py::blocked_spmm as work
//     items of a flat grid)
// Block row s holds W slots of dense r x c tiles and their block columns
// (-1 = padded slot). Row i of block row s is read as W * c positions,
// position w * c + j holding values[s, w, i, j] at column
// block_cols[s, w] * c + j; per row and column b:
//   acc = +0;  for w, j: acc += block_cols[s,w] >= 0 ?
//                               val * x[clip(col), b] : 0
// w-major, then j. The mask is the block column only, as in the
// reference: a real block's cells past column n - 1 hold 0 and multiply
// x[n - 1]; a padded slot is a select. Block row s stops at its `stops`
// entry (one past its last real slot, kernels/bcsr_spmv.py): every later
// position is masked, and skipping a masked term is bitwise adding its +0
// (padded_rows.cuh).
//
// What bounds it: bytes. Each stored block is a 4-byte block column and
// r * c values of 4 or 8 bytes, each value used for one multiply-add per
// column: at most 1 flop per 4 bytes of matrix, far below the ~20 flops
// per byte where the H100's f32 rate (67 TFLOP/s) would meet its 3.35 TB/s
// of HBM. Fill-in counts: a stored block's zero cells are read and
// multiplied like real entries.
//
// Design. The values of each block row are uploaded as r padded rows of
// W * c positions, interleaved in chunks of 32 rows (padded_rows.cuh), so
// neighbouring rows read neighbouring words per position; the block
// columns stay the reference's (S, W) array, read once per slot.
//   * SpMV (bcsr_spmv_kernel): SPMV_LANES = 4 lanes a row (1, 2, 4 and 8
//     timed on the H100: experiments/bcsr_geometry/). Lane t loads and
//     multiplies the row's positions w = t (mod 4), so four times the
//     rows' loads are in flight (the head of SmolLM-135M as 2x2 has 1,536
//     warps of one-lane rows, too few to cover HBM latency); the lanes of
//     one t read 8 neighbouring words a position. The products reach the
//     sum in order through __shfl_sync: every lane of the row adds p_0,
//     p_1, p_2, p_3 of each step. Each lane issues the block columns and
//     values of UNROLL steps before their x reads. x is staged in shared
//     memory where it fits the 48 KB a block takes without opting in,
//     else read through L1.
//   * SpMM: padded_rows.cuh::spmm_warp_kernel with the BcsrRow policy
//     below. Where r divides 32 a chunk holds whole block rows, whose r
//     rows share every column and mask: the kernel reads each x row once
//     for them and, at f32 with r >= 2, two rows' (column, value) pairs a
//     load (SHARED_COLS), each row keeping its own order. The kernel is
//     bound by the instructions it issues per live (row, position) and
//     column, not by bytes: these cut them.
// No tensor cores: mma / wgmma sum in their own order, which would break
// the bitwise agreement with the plain versions.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a
// geometry it does not take.

#include "padded_rows.cuh"

namespace {

using padded::CHUNK;
using padded::FULL;
using padded::Num;

// The BCSR matrix as the kernels read it.
struct BcsrArgs {
  const int* bcols;  // (S, W) block columns, -1 = padded slot
  const int* stops;  // (S,) one past the last real slot, 0 if none
  int W;
  int r;
  int c;
  int group;  // rows sharing a column in the SpMM: r where r divides 32,
              // else 1
};

// spmm_warp_kernel's view of a row: position w's word is the block column
// of its slot w / c, loaded once per slot (fetch and take each walk the
// positions in order, so both count the place within a block).
struct BcsrRow {
  static constexpr bool SHARED_COLS = true;
  using Args = BcsrArgs;
  const int* bcols;  // this row's block row: W slots
  int c;
  int end;   // positions from here on are masked: stops[s] * c
  int slot;  // the next fetch's slot, and its place in the block
  int fj;
  int bcol;  // the block column fetched last
  int tj;    // the next take's place in its block
  __device__ BcsrRow(const Args& a, long long row) {
    const long long s = row / a.r;
    bcols = a.bcols + s * (long long)a.W;
    c = a.c;
    end = __ldg(a.stops + s) * a.c;
    slot = fj = tj = 0;
    bcol = -1;
  }
  __device__ int fetch(long long) {
    if (fj == 0) bcol = __ldg(bcols + slot);
    if (++fj == c) {
      fj = 0;
      ++slot;
    }
    return bcol;
  }
  __device__ bool take(int word, int, long long* col) {
    *col = (long long)word * c + tj;
    if (++tj == c) tj = 0;
    return word >= 0;
  }
  __device__ int stop(int) const { return end; }
};

constexpr int SPMV_THREADS = 256;
constexpr int SPMV_LANES = 4;  // lanes a row
constexpr int UNROLL = 4;      // steps of SPMV_LANES positions loaded together
// Most bytes of x staged in shared memory: what a block takes without
// opting in; a wider x is read through L1.
constexpr size_t SPMV_STAGE_BYTES = 48 * 1024;

// y (R,) = A x with SPMV_LANES lanes a row; x staged in shared memory if
// STAGE.
template <typename V, bool STAGE>
__global__ void __launch_bounds__(SPMV_THREADS)
bcsr_spmv_kernel(BcsrArgs a, const V* __restrict__ val, long long R, int wg,
                 const V* __restrict__ x, long long n, V* __restrict__ y) {
  constexpr int T = SPMV_LANES;
  constexpr int RW = CHUNK / T;  // rows a warp
  const V* xr = x;
  if constexpr (STAGE) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    V* s = reinterpret_cast<V*>(smem_raw);
    for (long long i = threadIdx.x; i < n; i += SPMV_THREADS)
      s[i] = __ldg(x + i);
    __syncthreads();
    xr = s;
  }
  const int lane = threadIdx.x & 31;
  const int t = lane / RW;  // this lane's positions: w = t (mod T)
  const long long first =
      (((long long)blockIdx.x * SPMV_THREADS + threadIdx.x) >> 5) * RW;
  if (first >= R) return;  // the whole warp
  const long long row = first + lane % RW;
  const bool real = row < R;
  const long long rr = real ? row : R - 1;
  const long long s = rr / a.r;
  const int* bc = a.bcols + s * (long long)a.W;
  const int stop = real ? __ldg(a.stops + s) * a.c : 0;
  const int wstop = (int)__reduce_max_sync(FULL, (unsigned)stop);
  const V* vr = val + padded::row_base(rr, wg) + (long long)t * CHUNK;
  int q = t / a.c;  // slot and place in the block of position w0 + t
  int j = t - q * a.c;
  const int dq = T / a.c, dj = T - dq * a.c;  // one step of T positions
  V acc = V(0);
  for (int w0 = 0; w0 < wstop; w0 += T * UNROLL) {
    int bcol[UNROLL], col[UNROLL];
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = w0 + u * T + t < stop;
      bcol[u] = in ? __ldg(bc + q) : -1;
      v[u] = in ? __ldg(vr + (long long)(w0 + u * T) * CHUNK) : V(0);
      col[u] = j;
      j += dj;
      q += dq;
      if (j >= a.c) {
        j -= a.c;
        ++q;
      }
    }
    V p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      p[u] = bcol[u] >= 0
                 ? Num<V>::mul(v[u], xr[padded::clampll(
                                         (long long)bcol[u] * a.c + col[u],
                                         n - 1)])
                 : V(0);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < T; ++k)
        acc = Num<V>::add(acc, __shfl_sync(FULL, p[u], k * RW + lane % RW));
  }
  if (real && t == 0) y[row] = acc;
}

template <typename V>
int spmv(const BcsrArgs& a, const void* val, long long R, int wg,
         const void* x, long long n, void* y, void* stream) {
  const long long blocks =
      (R * SPMV_LANES + SPMV_THREADS - 1) / SPMV_THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool stage = (size_t)n * sizeof(V) <= SPMV_STAGE_BYTES;
  auto* kern = stage ? bcsr_spmv_kernel<V, true> : bcsr_spmv_kernel<V, false>;
  kern<<<(unsigned)blocks, SPMV_THREADS, stage ? (size_t)n * sizeof(V) : 0,
         static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const V*>(val), R, wg, static_cast<const V*>(x), n,
      static_cast<V*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (R,) = A x, R = S * r, over the (S, W) block columns, the (S,) stops
// and the interleaved (ceil(R/32), wg = W * c, 32) values. f64 != 0
// selects double values.
int bcsr_spmv_launch(int f64, const void* bcols, const void* stops, int W,
                     int r, int c, const void* val, long long R, int wg,
                     const void* x, long long n, void* y, void* stream) {
  const BcsrArgs a{static_cast<const int*>(bcols),
                   static_cast<const int*>(stops), W, r, c, 1};
  if (r < 1 || c < 1 || wg != W * c) return (int)cudaErrorInvalidValue;
  return f64 ? spmv<double>(a, val, R, wg, x, n, y, stream)
             : spmv<float>(a, val, R, wg, x, n, y, stream);
}

// y (R, B) = A X, X (n, B) row-major, in column tiles of bt, through
// spmm_warp_kernel with the geometry of kernels/tiling.py::padded_geometry
// (bw, nc, warps, stage, blocks); a geometry that does not cover the work
// is refused with cudaErrorInvalidValue.
int bcsr_spmm_launch(int f64, const void* bcols, const void* stops, int W,
                     int r, int c, const void* val, long long R, int wg,
                     const void* x, long long n, long long B, int bt, int bw,
                     int nc, int warps, int stage, long long blocks, void* y,
                     void* stream) {
  const BcsrArgs a{static_cast<const int*>(bcols),
                   static_cast<const int*>(stops), W, r, c,
                   r >= 1 && CHUNK % r == 0 ? r : 1};
  if (r < 1 || c < 1 || wg != W * c) return (int)cudaErrorInvalidValue;
  const padded::WarpGeom g{bw, nc, warps, stage, blocks};
  return f64 ? padded::launch_spmm_warp<BcsrRow, double>(
                   a, val, R, wg, x, n, B, bt, g, y, stream)
             : padded::launch_spmm_warp<BcsrRow, float>(
                   a, val, R, wg, x, n, B, bt, g, y, stream);
}

const char* bcsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
