// SpMV / SpMM over a padded row layout, shared by the SELL, RGCSR and
// BCSR kernels (sell_spmv.cu, rgcsr_spmv.cu, bcsr_spmv.cu). Each format
// supplies a `Row` policy that yields, per stored position w of a row, the
// column to gather and whether the position holds a real entry:
//
//   struct Row {
//     struct Args { ... };                       // the format's index arrays
//     __device__ Row(const Args&, long long r);  // row r's state
//     __device__ bool next(long long e, int w, long long* col);
//   };
//
// A fresh Row is made for every pass over a row, and `next` is called for
// w = 0, 1, 2, ... in order, so a policy may carry state from one position
// to the next.
//
// Layout on the card (kernels/padded.py::interleave): the flat (R, wg) view
// of the reference's (S, rows, wg) arrays, stored in chunks of 32 rows as
// (ceil(R / 32), wg, 32). Element w of row r lies at
// ((r / 32) * wg + w) * 32 + r % 32, so the 32 threads of a warp (32
// neighbouring rows) read 32 neighbouring words per position.
//
// Arithmetic: one fixed order per row and column,
//   acc = +0;  for w: acc = acc + (ok ? val * x[clip(col)] : 0)
// with __fmul_rn/__fadd_rn (or the double forms), so no FMA contraction
// differs between kernels, column tiles or the plain torch versions. A
// masked term is a select: x is never multiplied for a padded entry.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace padded {

constexpr int CHUNK = 32;     // rows per interleaved chunk: one warp
constexpr int THREADS = 128;  // rows (threads) per block
// Shared memory of one SpMM accumulator chunk: the 48 KB a block gets
// without opting in. Wider column tiles are walked in several chunks.
constexpr int SMEM_BUDGET = 48 * 1024;

template <typename V> struct Num;
template <> struct Num<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Num<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

__device__ __forceinline__ long long clampll(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// Offset of row r's position 0; position w is CHUNK * w further on.
__device__ __forceinline__ long long row_base(long long r, int wg) {
  return (r / CHUNK) * (long long)wg * CHUNK + (r % CHUNK);
}

// y (R,) = A x: one thread per row, the accumulator in a register.
template <typename V, typename Row>
__global__ void __launch_bounds__(THREADS)
spmv_kernel(typename Row::Args ra, const V* __restrict__ val, long long R,
            int wg, const V* __restrict__ x, long long n,
            V* __restrict__ y) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  Row row(ra, r);
  const long long e0 = row_base(r, wg);
  V acc = V(0);
#pragma unroll 8
  for (int w = 0; w < wg; ++w) {
    const long long e = e0 + (long long)w * CHUNK;
    long long col;
    const bool ok = row.next(e, w, &col);
    const V c = ok ? Num<V>::mul(__ldg(val + e), x[clampll(col, n - 1)])
                   : V(0);
    acc = Num<V>::add(acc, c);
  }
  y[r] = acc;
}

// y (R, B) = A X, X (n, B) row-major, for the column tile blockIdx.y of
// width bt. The tile is walked in chunks of cb columns whose accumulators,
// (cb, THREADS), sit in dynamic shared memory; each thread owns its own
// column of that array, so no barrier is needed.
template <typename V, typename Row>
__global__ void __launch_bounds__(THREADS)
spmm_kernel(typename Row::Args ra, const V* __restrict__ val, long long R,
            int wg, const V* __restrict__ x, long long n, long long B, int bt,
            int cb, V* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* acc = reinterpret_cast<V*>(smem_raw);
  const int t = threadIdx.x;
  const long long r = (long long)blockIdx.x * THREADS + t;
  if (r >= R) return;
  const long long b0 = (long long)blockIdx.y * bt;
  const int bw = (int)((B - b0) < bt ? (B - b0) : bt);
  const long long e0 = row_base(r, wg);
  for (int c0 = 0; c0 < bw; c0 += cb) {
    const int cw = (bw - c0) < cb ? (bw - c0) : cb;
    for (int b = 0; b < cw; ++b) acc[b * THREADS + t] = V(0);
    Row row(ra, r);
    for (int w = 0; w < wg; ++w) {
      const long long e = e0 + (long long)w * CHUNK;
      long long col;
      const bool ok = row.next(e, w, &col);
      const V v = __ldg(val + e);
      const V* xr = x + clampll(col, n - 1) * B + b0 + c0;
      for (int b = 0; b < cw; ++b) {
        const V c = ok ? Num<V>::mul(v, xr[b]) : V(0);
        acc[b * THREADS + t] = Num<V>::add(acc[b * THREADS + t], c);
      }
    }
    V* yr = y + r * B + b0 + c0;
    for (int b = 0; b < cw; ++b) yr[b] = acc[b * THREADS + t];
  }
}

inline dim3 row_grid(long long R, long long tiles) {
  return dim3((unsigned)((R + THREADS - 1) / THREADS), (unsigned)tiles);
}

template <typename Row, typename V>
int launch_spmv(const typename Row::Args& ra, const void* val, long long R,
                int wg, const void* x, long long n, void* y, void* stream) {
  spmv_kernel<V, Row><<<row_grid(R, 1), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ra, static_cast<const V*>(val), R, wg, static_cast<const V*>(x), n,
      static_cast<V*>(y));
  return (int)cudaGetLastError();
}

template <typename Row, typename V>
int launch_spmm(const typename Row::Args& ra, const void* val, long long R,
                int wg, const void* x, long long n, long long B, int bt,
                void* y, void* stream) {
  const int fit = SMEM_BUDGET / (THREADS * (int)sizeof(V));
  const int cb = bt < fit ? bt : fit;
  const size_t smem = (size_t)cb * THREADS * sizeof(V);
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_kernel<V, Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  spmm_kernel<V, Row><<<row_grid(R, (B + bt - 1) / bt), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      ra, static_cast<const V*>(val), R, wg, static_cast<const V*>(x), n, B,
      bt, cb, static_cast<V*>(y));
  return (int)cudaGetLastError();
}

}  // namespace padded
