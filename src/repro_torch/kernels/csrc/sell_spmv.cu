// SELL SpMV / SpMM for Hopper (sm_90a): the uncompressed comparator.
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/sell_spmv.py::_sell_kernel       (sell_spmv_pallas)
//   src/repro/kernels/sell_spmv.py::_sell_spmm_kernel  (sell_spmm_pallas,
//     with the column tiles of kernels/tiling.py::blocked_spmm as blockIdx.y)
// Per row r and column b: acc = +0; for w: acc += idx[r,w] >= 0 ?
// val[r,w] * x[clip(idx[r,w]), b] : 0.
//
// What bounds it: bytes. Each stored entry is a 4-byte index and a 4- or
// 8-byte value used for one multiply-add per column, about 1 flop per 6-12
// bytes of matrix, far below the ~20 flops per byte at which the H100's
// f32 rate (67 TFLOP/s) would meet its 3.35 TB/s of HBM. The padding counts
// too: every row is stored to the matrix-wide longest row, and the kernel
// reads it all.
//
// Design, first and simple (padded_rows.cuh): one thread per row of the
// flat (S * L) view, 128 per block, whatever the slice height L; the
// padded arrays are stored on the card in chunks of 32 rows so that a
// warp's loads of one position are one coalesced run; SpMV keeps its
// accumulator in a register, SpMM keeps a (columns, 128) tile in shared
// memory and reads x in its (n, B) layout through L1/L2. Every position up
// to the matrix-wide row length is walked, as the Pallas kernel does.
// Left for later: stopping each row at its own length (exact, since a
// masked term adds +0), a warp per row for long rows, x staged in shared
// memory for SpMM.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch.

#include "padded_rows.cuh"

namespace {

// SELL: the stored index is the column; -1 marks padding.
struct SellRow {
  struct Args {
    const int* idx;
  };
  const int* idx;
  __device__ SellRow(const Args& a, long long) : idx(a.idx) {}
  __device__ bool next(long long e, int, long long* col) {
    const int i = __ldg(idx + e);
    *col = i;
    return i >= 0;
  }
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

// y (R, B) = A X, X (n, B) row-major, in column tiles of bt
// (grid.y = ceil(B / bt)).
int sell_spmm_launch(int f64, const void* idx, const void* val, long long R,
                     int wg, const void* x, long long n, long long B, int bt,
                     void* y, void* stream) {
  const SellRow::Args a{static_cast<const int*>(idx)};
  return f64 ? padded::launch_spmm<SellRow, double>(a, val, R, wg, x, n, B,
                                                    bt, y, stream)
             : padded::launch_spmm<SellRow, float>(a, val, R, wg, x, n, B,
                                                   bt, y, stream);
}

const char* sell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
