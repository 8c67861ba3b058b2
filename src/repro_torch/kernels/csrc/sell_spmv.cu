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
// What bounds it: bytes. Each stored entry is a 4-byte index and a 4- or
// 8-byte value used for one multiply-add per column, about 1 flop per 6-12
// bytes of matrix, far below the ~20 flops per byte at which the H100's
// f32 rate (67 TFLOP/s) would meet its 3.35 TB/s of HBM. The padding counts
// too: every row is stored to the matrix-wide longest row, and SpMV reads
// it all. At B >= 64 the x reads dominate the traffic (a 128-byte line of
// 32 columns per real entry), so SpMM is bound by how fast L1 serves them.
//
// Design (padded_rows.cuh):
//   * SpMV, first and simple: one thread per row of the flat (S * L) view,
//     128 per block, whatever the slice height L, the accumulator in a
//     register; every position up to the matrix-wide row length is walked,
//     as the Pallas kernel does. Left for later: stopping each row at its
//     own length (exact, since a masked term adds +0), a warp per long row.
//   * SpMM: spmm_warp_kernel. One warp per chunk of 32 interleaved rows
//     and slab of columns (the geometry, from kernels/tiling.py::
//     padded_geometry, is checked here): lanes load the chunk's indices
//     and values of a position in one coalesced run, ballot which rows are
//     real, and for each such row broadcast its column and value through
//     a per-warp buffer in shared memory, so that the warp reads one row
//     of the slab's x columns, staged in shared memory where they fit
//     (else one coalesced line through L1); each lane keeps one
//     accumulator per row and column of its own in registers (at most 64
//     words) and y is written once at the end. Padding (-1, anywhere in a
//     row) is skipped: every position up to the row length is walked, but
//     only its index and value are loaded.
//
// The padded arrays are stored on the card in chunks of 32 rows, so that
// the 32 rows of a warp read one coalesced run per position.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch.

#include "padded_rows.cuh"

namespace {

// SELL: the stored index is the column; -1 marks padding.
struct SellRow {
  static constexpr bool SHARED_COLS = false;
  struct Args {
    const int* idx;
  };
  const int* idx;
  __device__ SellRow(const Args& a, long long) : idx(a.idx) {}
  __device__ int fetch(long long e) const { return __ldg(idx + e); }
  __device__ bool take(int i, int, long long* col) {
    *col = i;
    return i >= 0;
  }
  __device__ bool next(long long e, int w, long long* col) {
    return take(fetch(e), w, col);
  }
  // A -1 may stand anywhere in a row: every position is walked.
  __device__ int stop(int wg) const { return wg; }
};

}  // namespace

extern "C" {

// y (R,) = A x over the interleaved (ceil(R/32), wg, 32) idx / val arrays.
// f64 != 0 selects double values.
int sell_spmv_launch(int f64, const void* idx, const void* val, long long R,
                     int wg, const void* x, long long n, void* y,
                     void* stream) {
  const SellRow::Args a{static_cast<const int*>(idx)};
  return f64 ? padded::launch_spmv<SellRow, double>(a, val, R, wg, x, n, y,
                                                    stream)
             : padded::launch_spmv<SellRow, float>(a, val, R, wg, x, n, y,
                                                   stream);
}

// y (R, B) = A X, X (n, B) row-major, in column tiles of bt, through
// spmm_warp_kernel with the geometry of kernels/tiling.py::padded_geometry
// (bw, nc, warps, stage, blocks); a geometry that does not cover the
// work is refused with cudaErrorInvalidValue.
int sell_spmm_launch(int f64, const void* idx, const void* val, long long R,
                     int wg, const void* x, long long n, long long B, int bt,
                     int bw, int nc, int warps, int stage, long long blocks,
                     void* y, void* stream) {
  const SellRow::Args a{static_cast<const int*>(idx)};
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
