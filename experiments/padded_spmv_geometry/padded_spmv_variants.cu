// Variants of the SELL / RGCSR SpMV that the port does not ship, for
// time_padded_spmv_geometry.py: `kernel` is the port's
// src/repro_torch/kernels/csrc/padded_rows.cuh::spmv_lanes_kernel with
// lanes a row T (1, 2, 4 or 8), steps loaded together UNROLL (2 or 4) and
// x staged in shared memory (up to STAGE_BYTES) or read through L1 as
// template parameters (the port fixes them at LANES, LANES_UNROLL and x
// through L1). T = 1 is the thread-per-row shape of the kernel it
// replaced, with the row stops. The row policies (SellRow, RgcsrRow and their `step`) are the
// port's own. Only f32 is instantiated.
//
// C entries: sell_spmv_variant_launch / rgcsr_spmv_variant_launch take
// lanes, unroll and stage before the port's sell_spmv_launch /
// rgcsr_spmv_launch arguments, without the value-type flag.
//
// Built by the script with the port's nvcc flags and
// -I src/repro_torch/kernels/csrc; not part of the port's build.

#include "rgcsr_spmv.cu"
#include "sell_spmv.cu"

namespace variants {

using namespace padded;

// The most bytes of x a block stages: what it takes without opting in.
constexpr size_t STAGE_BYTES = 48 * 1024;

template <typename Row, int T, int UNROLL, bool STAGE>
__global__ void __launch_bounds__(LANES_THREADS)
kernel(typename Row::Args ra, const float* __restrict__ val, long long R,
       int wg, const float* __restrict__ x, long long n,
       float* __restrict__ y) {
  constexpr int RW = CHUNK / T;  // rows a warp
  const float* xr = x;  // read with __ldg unless STAGE
  if constexpr (STAGE) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* s = reinterpret_cast<float*>(smem_raw);
    for (long long i = threadIdx.x; i < n; i += LANES_THREADS)
      s[i] = __ldg(x + i);
    __syncthreads();
    xr = s;
  }
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
  float acc = 0.0f;
  for (int w0 = 0; w0 < wstop; w0 += T * UNROLL) {
    int word[UNROLL];
    float v[UNROLL];
    bool in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = e0 + (long long)(w0 + u * T) * CHUNK;
      in[u] = w0 + u * T + t < stop;
      word[u] = in[u] ? rp.fetch(e) : 0;
      v[u] = in[u] ? __ldg(val + e) : 0.0f;
    }
    float p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      long long col;
      const bool ok = rp.template step<T>(word[u], in[u], &col);
      const long long c = clampll(col, n - 1);
      p[u] = ok ? Num<float>::mul(v[u], STAGE ? xr[c] : __ldg(x + c)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < T; ++k)
        acc = Num<float>::add(acc,
                              __shfl_sync(FULL, p[u], k * RW + lane % RW));
  }
  if (real && t == 0) y[row] = acc;
}

template <typename Row, int T, int UNROLL>
int launch(const typename Row::Args& ra, const void* val, long long R,
           int wg, const void* x, long long n, int stage, void* y,
           void* stream) {
  const long long blocks = (R * T + LANES_THREADS - 1) / LANES_THREADS;
  const size_t smem = stage ? (size_t)n * sizeof(float) : 0;
  if (blocks > INT_MAX || smem > STAGE_BYTES)
    return (int)cudaErrorInvalidValue;
  auto* kern = stage ? kernel<Row, T, UNROLL, true>
                     : kernel<Row, T, UNROLL, false>;
  kern<<<(unsigned)blocks, LANES_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      ra, static_cast<const float*>(val), R, wg,
      static_cast<const float*>(x), n, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

#define VARIANT_ARGS ra, val, R, wg, x, n, stage, y, stream

template <typename Row, int T>
int pick_unroll(int unroll, const typename Row::Args& ra, const void* val,
                long long R, int wg, const void* x, long long n, int stage,
                void* y, void* stream) {
  switch (unroll) {
    case 2: return launch<Row, T, 2>(VARIANT_ARGS);
    case 4: return launch<Row, T, 4>(VARIANT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Row>
int launch_variant(int lanes, int unroll, int stage,
                   const typename Row::Args& ra, const void* val,
                   long long R, int wg, const void* x, long long n, void* y,
                   void* stream) {
  if (stage != 0 && stage != 1) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 1: return pick_unroll<Row, 1>(unroll, VARIANT_ARGS);
    case 2: return pick_unroll<Row, 2>(unroll, VARIANT_ARGS);
    case 4: return pick_unroll<Row, 4>(unroll, VARIANT_ARGS);
    case 8: return pick_unroll<Row, 8>(unroll, VARIANT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

#undef VARIANT_ARGS

}  // namespace variants

extern "C" {

int sell_spmv_variant_launch(int lanes, int unroll, int stage,
                             const void* idx, const void* stops,
                             const void* val, long long R, int wg,
                             const void* x, long long n, void* y,
                             void* stream) {
  const SellRow::Args a{static_cast<const int*>(idx),
                        static_cast<const int*>(stops)};
  return variants::launch_variant<SellRow>(lanes, unroll, stage, a, val, R,
                                           wg, x, n, y, stream);
}

int rgcsr_spmv_variant_launch(int lanes, int unroll, int stage,
                              const void* deltas, const void* nnz,
                              const void* val, long long R, int wg,
                              const void* x, long long n, void* y,
                              void* stream) {
  const RgcsrRow::Args a{static_cast<const int*>(deltas),
                         static_cast<const int*>(nnz)};
  return variants::launch_variant<RgcsrRow>(lanes, unroll, stage, a, val, R,
                                            wg, x, n, y, stream);
}

}  // extern "C"
