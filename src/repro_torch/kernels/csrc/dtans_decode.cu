// Decode-only dtANS kernel for Hopper (sm_90a): the library's
// decompression entry point.
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/dtans_decode.py::_decode_kernel  (dtans_decode_pallas)
// It runs the same warp-synchronous decoder as the fused SpMV / SpMM
// kernels (dtans_decode.cuh) and writes what it decodes instead of contracting
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
// chain (table lookups, limb arithmetic and claims per segment) costs
// what it costs in the fused SpMV kernel; the stores below add to it
// (PERF.md has both times on an H100).
//
// Design: the warp-synchronous decoder of dtans_decode.cuh in the SpMV
// kernel's geometry (persistent blocks, tables staged once per block,
// narrow slices packed several to a warp), one thread per lane, the
// reference's row-major (S, L, max_nnz) output. A thread writes its H
// entries of a segment side by side, but neighbouring lanes are max_nnz
// entries apart, so a warp's stores touch 32 lines each; left so for now
// (staging a segment's (L, H) tile in shared memory would let a warp
// write whole lines: ROADMAP queue B). Threads past L decode nothing and
// write nothing.
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after its launch.

#include "dtans_decode.cuh"

namespace {

template <typename V, int MAXT>
__global__ void __launch_bounds__(MAXT)
dtans_decode_kernel(Args a, Geom gm, int* __restrict__ cols_out,
                    V* __restrict__ vals_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = stage_tables(a, smem);
  const int warp = threadIdx.x >> 5;
  const int gi = warp / gm.uw;
  const UnitSmem us = unit_smem(
      smem + tables_bytes(a.T) + gi * unit_bytes(gm.uw), gm.uw);
  const long long max_nnz = (long long)a.max_nseg * H;
  for (long long u = (long long)blockIdx.x * gm.upb + gi; u < gm.units;
       u += (long long)gridDim.x * gm.upb) {
    Group g = make_group(a, gm, us, u, warp - gi * gm.uw, 1 + gi);
    Lane st;
    const int nseg = init_lane(a, g, st);
    const long long row = (g.s * a.L + g.lane) * max_nnz;
    for (int j = 0; j < nseg; ++j) {
      Seg sg;
      decode_segment(a, tb, g, st, j, sg);
      if (g.in) {
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const long long q = row + (long long)j * H + i;
          const bool ok = (sg.valid >> i) & 1u;
          cols_out[q] = ok ? (int)sg.col[i] : -1;
          vals_out[q] = ok ? Num<V>::value(sg.vb[i]) : V(0);
        }
      }
    }
    if (g.in) {
      for (long long q = row + (long long)nseg * H; q < row + max_nnz; ++q) {
        cols_out[q] = -1;
        vals_out[q] = V(0);
      }
    }
  }
}

template <typename V, int MAXT>
cudaError_t decode_t(int blocks, int threads, long long smem,
                     cudaStream_t cs, const Args& a, const Geom& gm,
                     void* cols, void* vals) {
  const cudaError_t err = opt_in(dtans_decode_kernel<V, MAXT>, smem);
  if (err != cudaSuccess) return err;
  dtans_decode_kernel<V, MAXT><<<blocks, threads, smem, cs>>>(
      a, gm, static_cast<int*>(cols), static_cast<V*>(vals));
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_decode(int blocks, int threads, long long smem,
                          cudaStream_t cs, const Args& a, const Geom& gm,
                          void* cols, void* vals) {
  return threads <= 256
             ? decode_t<V, 256>(blocks, threads, smem, cs, a, gm, cols, vals)
             : decode_t<V, 1024>(blocks, threads, smem, cs, a, gm, cols,
                                 vals);
}

}  // namespace

extern "C" {

// cols (S, L, max_nseg * H) int32 and vals (S, L, max_nseg * H) = the
// decoded matrix, -1 / +0 at padding. f64 != 0 selects double values; the
// geometry is the SpMV kernel's (kernels/tiling.py::geometry).
int dtans_decode_launch(int f64, const void* stream, long long wmax,
                        const void* esc, long long emax, const void* ns,
                        const void* nnz, const void* tables, int T,
                        int pattern_bits, int S, int L, int max_nseg,
                        int group, int uw, int spu, long long units, int upb,
                        int cw, int blocks, int threads, long long smem,
                        void* cols, void* vals, void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tables, T,
                           pattern_bits, S, L, max_nseg);
  const Geom gm = make_geom(group, uw, spu, units, upb, cw);
  if (threads != upb * uw * 32 ||
      smem < tables_bytes(T) + (long long)upb * unit_bytes(uw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const cudaError_t err =
      f64 ? launch_decode<double>(blocks, threads, smem, cs, a, gm, cols,
                                  vals)
          : launch_decode<float>(blocks, threads, smem, cs, a, gm, cols,
                                 vals);
  return (int)err;
}

const char* dtans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
