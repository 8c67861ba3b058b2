// Blocked CSR (BCSR) SpMV / SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/bcsr_spmv.py::_bcsr_kernel       (bcsr_spmv_pallas)
//   src/repro/kernels/bcsr_spmv.py::_bcsr_spmm_kernel  (bcsr_spmm_pallas,
//     with the column tiles of kernels/tiling.py::blocked_spmm as blockIdx.y)
// Block row s holds W slots of dense r x c tiles and their block columns
// (-1 = padded slot). Row i of block row s is read as W * c positions,
// position w * c + j holding values[s, w, i, j] at column
// block_cols[s, w] * c + j; per row and column b:
//   acc = +0;  for w, j: acc += block_cols[s,w] >= 0 ?
//                               val * x[clip(col), b] : 0
// w-major, then j. The mask is the block column only, as in the
// reference: a real block's cells past column n - 1 hold 0 and multiply
// x[n - 1]; a padded slot is a select.
//
// What bounds it: bytes. Each stored block is a 4-byte block column and
// r * c values of 4 or 8 bytes, each value used for one multiply-add per
// column: at most 1 flop per 4 bytes of matrix, far below the ~20 flops
// per byte where the H100's f32 rate (67 TFLOP/s) would meet its 3.35 TB/s
// of HBM. Fill-in counts: a stored block's zero cells are read and
// multiplied like real entries.
//
// Design, first and simple: a third row policy of padded_rows.cuh. One
// thread per row of the flat (S * r) view, 128 per block; the values of
// each block row are uploaded as r padded rows of W * c positions,
// interleaved in chunks of 32 rows, so a warp's value loads are one
// coalesced run per position. The block columns are read from the
// reference's (S, W) array directly, once per block (every c positions):
// the r threads of a block row load the same word (one broadcast), and
// the 32-byte sector a warp fetches for slot w also holds slots w+1..w+7
// of the same block rows, so the later loads hit L1. That keeps the index
// traffic at 4 bytes per block, which an interleaved (S * r, W) copy
// would multiply by r (25-50% more bytes than the values at c = 2..4 and
// f32). Every slot up to W is walked, as the Pallas kernel does.
// Left for later: stopping each block row at its own block count, x
// staged in shared memory for SpMM, tensor-core tiles for large r * c.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch.

#include "padded_rows.cuh"

namespace {

// BCSR: the column of position w is the current block's column times c
// plus the position within the block; a padded slot (-1) masks it.
struct BcsrRow {
  struct Args {
    const int* bcols;  // (S, W) block columns, -1 = padded slot
    int W;
    int r;
    int c;
  };
  const int* bcols;  // this row's block row: W slots
  int c;
  int j;     // position within the current block
  int bcol;  // the current block's column
  __device__ BcsrRow(const Args& a, long long row)
      : bcols(a.bcols + (row / a.r) * (long long)a.W), c(a.c), j(0),
        bcol(-1) {}
  // Called for w = 0, 1, 2, ... in order.
  __device__ bool next(long long, int w, long long* col) {
    if (j == 0) bcol = __ldg(bcols + w / c);
    *col = (long long)bcol * c + j;
    if (++j == c) j = 0;
    return bcol >= 0;
  }
};

}  // namespace

extern "C" {

// y (R,) = A x, R = S * r, over the (S, W) block columns and the
// interleaved (ceil(R/32), wg = W * c, 32) values. f64 != 0 selects double
// values.
int bcsr_spmv_launch(int f64, const void* bcols, int W, int r, int c,
                     const void* val, long long R, int wg, const void* x,
                     long long n, void* y, void* stream) {
  const BcsrRow::Args a{static_cast<const int*>(bcols), W, r, c};
  return f64 ? padded::launch_spmv<BcsrRow, double>(a, val, R, wg, x, n, y,
                                                    stream)
             : padded::launch_spmv<BcsrRow, float>(a, val, R, wg, x, n, y,
                                                   stream);
}

// y (R, B) = A X, X (n, B) row-major, in column tiles of bt
// (grid.y = ceil(B / bt)).
int bcsr_spmm_launch(int f64, const void* bcols, int W, int r, int c,
                     const void* val, long long R, int wg, const void* x,
                     long long n, long long B, int bt, void* y,
                     void* stream) {
  const BcsrRow::Args a{static_cast<const int*>(bcols), W, r, c};
  return f64 ? padded::launch_spmm<BcsrRow, double>(a, val, R, wg, x, n, B,
                                                    bt, y, stream)
             : padded::launch_spmm<BcsrRow, float>(a, val, R, wg, x, n, B,
                                                   bt, y, stream);
}

const char* bcsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
