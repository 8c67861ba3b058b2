// Decode-only dtANS kernel for Hopper (sm_90a): the library's
// decompression entry point.
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/dtans_decode.py::_decode_kernel  (dtans_decode_pallas)
// It runs the same lock-step decoder as the fused SpMV / SpMM kernels
// (dtans_decode.cuh) and writes what it decodes instead of contracting
// it: per lane (row) of slice s, segment j and position i < H,
//   cols[s, lane, j*H + i] = valid ? column : -1
//   vals[s, lane, j*H + i] = valid ? value  : +0
// for every j < max_nseg of the matrix; the segments past the slice's
// own last one are written as padding too, so the output needs no fill.
//
// What bounds it. It reads the compressed matrix once and writes
// S * L * max_nseg * H * (4 + itemsize) bytes: for the SmolLM-135M head
// (384 slices of 128 lanes, max_nseg 40) that is 62.9 MB written against
// 10.4 MB read, about 0.022 ms at 3.35 TB/s. The decode's serial latency
// chain (table lookups, limb arithmetic and block-wide claims per segment)
// costs what it costs in the fused SpMV kernel; the stores below add to it
// (on an H100 the head's decode takes about 4x its SpMV: PERF.md).
//
// Design, first and simple: one block per slice, one thread per lane, the
// reference's row-major (S, L, max_nnz) output. A thread writes its H
// entries of a segment side by side, but neighbouring lanes are max_nnz
// entries apart, so a warp's stores touch 32 lines each; left so for now
// (staging a segment's (L, H) tile in shared memory would let a warp
// write whole lines). Threads past L decode nothing and write nothing.
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after its launch.

#include "dtans_decode.cuh"

namespace {

template <typename V, int MAXT>
__global__ void __launch_bounds__(MAXT)
dtans_decode_kernel(Args a, int* __restrict__ cols_out,
                    V* __restrict__ vals_out) {
  __shared__ int warp_tot[MAX_WARPS];
  __shared__ int smax;
  const BlockCtx bc{warp_tot, (int)(blockDim.x >> 5)};
  const int s = blockIdx.x;
  const bool in = (int)threadIdx.x < a.L;
  Lane st;
  long long cursor;
  long long esc_cur[2] = {0, 0};
  init_lane(a, s, in, bc, st, cursor);
  const int nseg = block_nseg(a, st, &smax);

  const long long max_nnz = (long long)a.max_nseg * H;
  const long long row = ((long long)s * a.L + threadIdx.x) * max_nnz;
  for (int j = 0; j < nseg; ++j) {
    long long cols[H];
    unsigned long long vbits[H];
    bool valid[H];
    decode_segment(a, s, j, bc, st, cursor, esc_cur, cols, vbits, valid);
    if (in) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const long long q = row + (long long)j * H + i;
        cols_out[q] = valid[i] ? (int)cols[i] : -1;
        vals_out[q] = valid[i] ? Num<V>::value(vbits[i]) : V(0);
      }
    }
  }
  if (in) {
    for (long long q = row + (long long)nseg * H; q < row + max_nnz; ++q) {
      cols_out[q] = -1;
      vals_out[q] = V(0);
    }
  }
}

constexpr int SMALL_BLOCK = 256;

template <typename V>
void launch_decode(int threads, dim3 grid, dim3 block, cudaStream_t cs,
                   const Args& a, void* cols, void* vals) {
  int* c = static_cast<int*>(cols);
  V* v = static_cast<V*>(vals);
  if (threads <= SMALL_BLOCK) {
    dtans_decode_kernel<V, SMALL_BLOCK><<<grid, block, 0, cs>>>(a, c, v);
  } else {
    dtans_decode_kernel<V, 1024><<<grid, block, 0, cs>>>(a, c, v);
  }
}

}  // namespace

extern "C" {

// cols (S, L, max_nseg * H) int32 and vals (S, L, max_nseg * H) = the
// decoded matrix, -1 / +0 at padding. f64 != 0 selects double values.
int dtans_decode_launch(int f64, const void* stream, long long wmax,
                        const void* esc, long long emax, const void* ns,
                        const void* nnz, const void* tab_symbol,
                        const void* tab_digit, const void* tab_base,
                        const void* tab_is_esc, int K, int pattern_bits,
                        int S, int L, int max_nseg, void* cols, void* vals,
                        void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tab_symbol,
                           tab_digit, tab_base, tab_is_esc, K, pattern_bits,
                           S, L, max_nseg);
  const int threads = threads_for(L);
  const dim3 grid(S, 1), block(threads);
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  if (f64) {
    launch_decode<double>(threads, grid, block, cs, a, cols, vals);
  } else {
    launch_decode<float>(threads, grid, block, cs, a, cols, vals);
  }
  return (int)cudaGetLastError();
}

const char* dtans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
