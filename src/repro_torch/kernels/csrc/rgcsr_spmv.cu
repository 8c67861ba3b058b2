// Row-grouped CSR (RGCSR) SpMV / SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/rgcsr_spmv.py::_rgcsr_kernel       (rgcsr_spmv_pallas)
//   src/repro/kernels/rgcsr_spmv.py::_rgcsr_spmm_kernel  (rgcsr_spmm_pallas,
//     with the column tiles of kernels/tiling.py::blocked_spmm as work
//     items of a flat grid)
// Per row r: col = int32 running sum of deltas[r, 0..w]; the term at w is
// w < nnz[r] ? val[r,w] * x[clip(col), b] : 0, summed left to right.
//
// What bounds it: bytes, as for SELL (sell_spmv.cu): a 4-byte delta and a
// 4- or 8-byte value per stored entry, one multiply-add per column, plus
// one 4-byte count per row. Each row stops at its count, so the padding
// past it is not read. The running sum adds one integer add per stored
// entry, which the loads hide. At B >= 64 the x reads dominate, as for
// SELL.
//
// Design (padded_rows.cuh), the SELL kernels' with the RgcsrRow policy; the
// deltas stay deltas on the card and the running sum is formed here:
//   * SpMV: spmv_lanes_kernel, 4 lanes a row of the flat (S * G) view, so
//     a group of G rows is only where a row's data lies and small groups
//     (G = 4) do not make small blocks. At each step the 4 lanes of a row
//     hold the deltas of 4 consecutive positions; each lane's column is the
//     row's carry plus the inclusive scan of the step's deltas up to its
//     own lane (log2 4 = 2 __shfl_up_sync, the row's lanes 8 apart), in
//     uint32_t, wrapping exactly as the reference's int32 cumsum; the carry
//     then takes the row's last lane's sum (one __shfl_sync). A lane at or
//     past its row's count loads nothing and scans a delta of 0: its
//     positions all lie after the row's last real one, so no real column
//     changes. The products are summed in position order as for SELL.
//   * SpMM: spmm_warp_kernel, one warp per chunk of 32 interleaved rows and
//     slab of columns, lanes mapped to columns, accumulators in registers
//     (sell_spmv.cu). Lane i keeps row i's int32 running sum and ballots
//     w < nnz; the chunk stops at its longest row (__reduce_max_sync of
//     the counts), since every later position is masked.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch.

#include "padded_rows.cuh"

namespace {

// RGCSR: columns are the running sum of the row's deltas (0 = padding);
// positions at or past the row's count are masked.
struct RgcsrRow {
  static constexpr bool SHARED_COLS = false;
  struct Args {
    const int* deltas;
    const int* nnz;  // (R,)
  };
  const int* deltas;
  int nnz;
  uint32_t col;  // int32 sum, wrapping as the reference's jnp.cumsum
  __device__ RgcsrRow(const Args& a, long long r)
      : deltas(a.deltas), nnz(__ldg(a.nnz + r)), col(0u) {}
  __device__ int fetch(long long e) const { return __ldg(deltas + e); }
  __device__ bool take(int delta, int w, long long* c) {
    col += (uint32_t)delta;
    *c = (long long)(int32_t)col;
    return w < nnz;
  }
  // Lane t of the row's T lanes (lane = t * RW + row % RW) holds the delta
  // of position w0 + t: its column is the sum up to w0 (`col`) plus the
  // inclusive scan of the step's deltas up to t.
  template <int T>
  __device__ bool step(int delta, bool in, long long* c) {
    constexpr int RW = padded::CHUNK / T;
    const int lane = threadIdx.x & 31;
    uint32_t s = in ? (uint32_t)delta : 0u;
#pragma unroll
    for (int k = 1; k < T; k *= 2) {
      const uint32_t o = __shfl_up_sync(padded::FULL, s, k * RW);
      if (lane >= k * RW) s += o;
    }
    *c = (long long)(int32_t)(col + s);
    col += __shfl_sync(padded::FULL, s, (T - 1) * RW + lane % RW);
    return in;  // in: w < the stop <= nnz
  }
  __device__ int stop(int wg) const { return nnz < wg ? nnz : wg; }
};

}  // namespace

extern "C" {

// y (R,) = A x over the interleaved (ceil(R/32), wg, 32) deltas / val
// arrays and the (R,) per-row counts. f64 != 0 selects double values.
int rgcsr_spmv_launch(int f64, const void* deltas, const void* nnz,
                      const void* val, long long R, int wg, const void* x,
                      long long n, void* y, void* stream) {
  const RgcsrRow::Args a{static_cast<const int*>(deltas),
                         static_cast<const int*>(nnz)};
  return f64 ? padded::launch_spmv_lanes<RgcsrRow, double>(a, val, R, wg,
                                                           x, n, y, stream)
             : padded::launch_spmv_lanes<RgcsrRow, float>(a, val, R, wg, x,
                                                          n, y, stream);
}

// y (R, B) = A X, X (n, B) row-major, in column tiles of bt, through
// spmm_warp_kernel with the geometry of kernels/tiling.py::padded_geometry
// (bw, nc, warps, stage, blocks); a geometry that does not cover the
// work is refused with cudaErrorInvalidValue.
int rgcsr_spmm_launch(int f64, const void* deltas, const void* nnz,
                      const void* val, long long R, int wg, const void* x,
                      long long n, long long B, int bt, int bw, int nc,
                      int warps, int stage, long long blocks, void* y,
                      void* stream) {
  const RgcsrRow::Args a{static_cast<const int*>(deltas),
                         static_cast<const int*>(nnz)};
  const padded::WarpGeom g{bw, nc, warps, stage, blocks};
  return f64 ? padded::launch_spmm_warp<RgcsrRow, double>(
                   a, val, R, wg, x, n, B, bt, g, y, stream)
             : padded::launch_spmm_warp<RgcsrRow, float>(
                   a, val, R, wg, x, n, B, bt, g, y, stream);
}

const char* rgcsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
