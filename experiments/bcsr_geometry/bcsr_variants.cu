// Variants of the BCSR SpMV and SpMM that the port does not ship, for
// time_bcsr_geometry.py:
//   * SpMV: `spmv_kernel` is the port's src/repro_torch/kernels/csrc/
//     bcsr_spmv.cu::bcsr_spmv_kernel with lanes a row T (1, 2, 4 or 8) a
//     template parameter (the port fixes it at SPMV_LANES = 4), and x
//     staged in shared memory or read through L1 as asked (the port
//     stages x where it fits 48 KB);
//   * SpMM: the port's padded_rows.cuh::spmm_warp_kernel with the BcsrRow
//     policy and `group` rows sharing a column as asked: 1 (every row
//     reads its own x) or r (the port, where r divides 32).
// The row policy, x readers and geometry check are the port's own. Only
// f32 is instantiated.
//
// C entries: bcsr_spmv_variant_launch takes lanes and stage,
// bcsr_spmm_variant_launch takes group, each before the port's
// bcsr_spmv_launch / bcsr_spmm_launch arguments, without the value-type
// flag.
//
// Built by the script with the port's nvcc flags and
// -I src/repro_torch/kernels/csrc; not part of the port's build.

#include "bcsr_spmv.cu"

namespace variants {

using namespace padded;

template <int T, bool STAGE>
__global__ void __launch_bounds__(SPMV_THREADS)
spmv_kernel(BcsrArgs a, const float* __restrict__ val, long long R, int wg,
            const float* __restrict__ x, long long n, float* __restrict__ y) {
  constexpr int RW = CHUNK / T;  // rows a warp
  const float* xr = x;
  if constexpr (STAGE) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* s = reinterpret_cast<float*>(smem_raw);
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
  const float* vr = val + row_base(rr, wg) + (long long)t * CHUNK;
  int q = t / a.c;  // slot and place in the block of position w0 + t
  int j = t - q * a.c;
  const int dq = T / a.c, dj = T - dq * a.c;  // one step of T positions
  float acc = 0.0f;
  for (int w0 = 0; w0 < wstop; w0 += T * UNROLL) {
    int bcol[UNROLL], col[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = w0 + u * T + t < stop;
      bcol[u] = in ? __ldg(bc + q) : -1;
      v[u] = in ? __ldg(vr + (long long)(w0 + u * T) * CHUNK) : 0.0f;
      col[u] = j;
      j += dj;
      q += dq;
      if (j >= a.c) {
        j -= a.c;
        ++q;
      }
    }
    float p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      p[u] = bcol[u] >= 0
                 ? Num<float>::mul(
                       v[u], xr[clampll((long long)bcol[u] * a.c + col[u],
                                        n - 1)])
                 : 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < T; ++k)
        acc = Num<float>::add(acc,
                              __shfl_sync(FULL, p[u], k * RW + lane % RW));
  }
  if (real && t == 0) y[row] = acc;
}

template <int T>
int launch_spmv(const BcsrArgs& a, const void* val, long long R, int wg,
                const void* x, long long n, int stage, void* y,
                void* stream) {
  const long long blocks = (R * T + SPMV_THREADS - 1) / SPMV_THREADS;
  const size_t smem = stage ? (size_t)n * sizeof(float) : 0;
  if (blocks > INT_MAX || smem > SPMV_STAGE_BYTES)
    return (int)cudaErrorInvalidValue;
  auto* kern = stage ? spmv_kernel<T, true> : spmv_kernel<T, false>;
  kern<<<(unsigned)blocks, SPMV_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(val), R, wg,
      static_cast<const float*>(x), n, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

}  // namespace variants

extern "C" {

int bcsr_spmv_variant_launch(int lanes, int stage, const void* bcols,
                             const void* stops, int W, int r, int c,
                             const void* val, long long R, int wg,
                             const void* x, long long n, void* y,
                             void* stream) {
  const BcsrArgs a{static_cast<const int*>(bcols),
                   static_cast<const int*>(stops), W, r, c, 1};
  if (r < 1 || c < 1 || wg != W * c || (stage != 0 && stage != 1))
    return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 1: return variants::launch_spmv<1>(a, val, R, wg, x, n, stage, y,
                                            stream);
    case 2: return variants::launch_spmv<2>(a, val, R, wg, x, n, stage, y,
                                            stream);
    case 4: return variants::launch_spmv<4>(a, val, R, wg, x, n, stage, y,
                                            stream);
    case 8: return variants::launch_spmv<8>(a, val, R, wg, x, n, stage, y,
                                            stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bcsr_spmm_variant_launch(int group, const void* bcols, const void* stops,
                             int W, int r, int c, const void* val,
                             long long R, int wg, const void* x, long long n,
                             long long B, int bt, int bw, int nc, int warps,
                             int stage, long long blocks, void* y,
                             void* stream) {
  const BcsrArgs a{static_cast<const int*>(bcols),
                   static_cast<const int*>(stops), W, r, c, group};
  if (r < 1 || c < 1 || wg != W * c ||
      (group != 1 && (group != r || CHUNK % r != 0)))
    return (int)cudaErrorInvalidValue;
  const padded::WarpGeom g{bw, nc, warps, stage, blocks};
  return padded::launch_spmm_warp<BcsrRow, float>(a, val, R, wg, x, n, B, bt,
                                                  g, y, stream);
}

}  // extern "C"
