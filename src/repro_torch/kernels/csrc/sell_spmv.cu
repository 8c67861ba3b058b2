// SELL SpMV / SpMM for Hopper (sm_90a): the uncompressed comparator.
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/sell_spmv.py::_sell_kernel       (sell_spmv_pallas)
//   src/repro/kernels/sell_spmv.py::_sell_spmm_kernel  (sell_spmm_pallas,
//     with the column tiles of kernels/tiling.py::blocked_spmm as work
//     items of a flat grid)
// Per row r and column b: acc = +0; for w: acc += idx[r,w] >= 0 ?
// val[r,w] * x[clip(idx[r,w]), b] : 0.
//
// Row r stops at stops[r], one past its last index >= 0 (0 for a row of
// padding only; kernels/sell_spmv.py::row_stops, computed at upload): every
// later position is -1, and skipping it is bitwise adding its +0
// (padded_rows.cuh). A -1 before the stop is walked and masked.
//
// What bounds it: bytes. Each stored entry is a 4-byte index and a 4- or
// 8-byte value used for one multiply-add per column, about 1 flop per 6-12
// bytes of matrix, far below the ~20 flops per byte at which the H100's
// f32 rate (67 TFLOP/s) would meet its 3.35 TB/s of HBM. With the stops,
// the padding past each row's last entry is not read: SpMV reads the real
// entries, each row's 4-byte stop, and at most a partial sector a position
// where the rows of a sector end at different stops. At B >= 64 the x
// reads dominate the traffic (a 128-byte line of 32 columns per real
// entry), so SpMM is bound by how fast L1 serves them.
//
// Design (padded_rows.cuh):
//   * SpMV: spmv_lanes_kernel, 4 lanes a row of the flat (S * L) view
//     whatever the slice height L, 256 threads a block. Lane t loads the
//     indices and values of its row's positions t, t + 4, ..., four steps
//     of loads issued before their x reads, up to the row's stop; the four
//     products of each step reach the row's sum in position order through
//     __shfl_sync. x is read through L1.
//   * SpMM: spmm_warp_kernel. One warp per chunk of 32 interleaved rows
//     and slab of columns (the geometry, from kernels/tiling.py::
//     padded_geometry, is checked here): lanes load the chunk's indices
//     and values of a position in one coalesced run, ballot which rows are
//     real, and for each such row broadcast its column and value through
//     a per-warp buffer in shared memory, so that the warp reads one row
//     of the slab's x columns, staged in shared memory where they fit
//     (else one coalesced line through L1); each lane keeps one
//     accumulator per row and column of its own in registers (at most 64
//     words) and y is written once at the end. The chunk stops at its
//     longest row's stop (__reduce_max_sync of the stops); a -1 before it
//     is skipped: its index and value are loaded, nothing else.
//
// The padded arrays are stored on the card in chunks of 32 rows, so that
// the 32 rows of a warp read one coalesced run per position.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch.

#include "padded_rows.cuh"

namespace {

// SELL: the stored index is the column; -1 marks padding. Row r stops at
// stops[r].
struct SellRow {
  static constexpr bool SHARED_COLS = false;
  struct Args {
    const int* idx;
    const int* stops;  // (R,)
  };
  const int* idx;
  int end;
  __device__ SellRow(const Args& a, long long r)
      : idx(a.idx), end(__ldg(a.stops + r)) {}
  __device__ int fetch(long long e) const { return __ldg(idx + e); }
  __device__ bool take(int i, int, long long* col) {
    *col = i;
    return i >= 0;
  }
  template <int T>
  __device__ bool step(int i, bool in, long long* col) const {
    *col = i;
    return in && i >= 0;
  }
  __device__ int stop(int) const { return end; }
};

}  // namespace

extern "C" {

// y (R,) = A x over the interleaved (ceil(R/32), wg, 32) idx / val arrays
// and the (R,) stops. f64 != 0 selects double values.
int sell_spmv_launch(int f64, const void* idx, const void* stops,
                     const void* val, long long R, int wg, const void* x,
                     long long n, void* y, void* stream) {
  const SellRow::Args a{static_cast<const int*>(idx),
                        static_cast<const int*>(stops)};
  return f64 ? padded::launch_spmv_lanes<SellRow, double>(a, val, R, wg, x,
                                                          n, y, stream)
             : padded::launch_spmv_lanes<SellRow, float>(a, val, R, wg, x,
                                                         n, y, stream);
}

// y (R, B) = A X, X (n, B) row-major, in column tiles of bt, through
// spmm_warp_kernel with the geometry of kernels/tiling.py::padded_geometry
// (bw, nc, warps, stage, blocks); a geometry that does not cover the
// work is refused with cudaErrorInvalidValue.
int sell_spmm_launch(int f64, const void* idx, const void* stops,
                     const void* val, long long R, int wg, const void* x,
                     long long n, long long B, int bt, int bw, int nc,
                     int warps, int stage, long long blocks, void* y,
                     void* stream) {
  const SellRow::Args a{static_cast<const int*>(idx),
                        static_cast<const int*>(stops)};
  const padded::WarpGeom g{bw, nc, warps, stage, blocks};
  return f64 ? padded::launch_spmm_warp<SellRow, double>(a, val, R, wg, x, n,
                                                         B, bt, g, y, stream)
             : padded::launch_spmm_warp<SellRow, float>(a, val, R, wg, x, n,
                                                        B, bt, g, y, stream);
}

const char* sell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
