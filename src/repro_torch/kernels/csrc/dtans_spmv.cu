// Fused dtANS decode + SpMV / SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/dtans_spmv.py::_spmv_kernel  (dtans_spmv_pallas)
//   src/repro/kernels/dtans_spmv.py::_spmm_kernel  (dtans_spmm_pallas, with
//     the column tiles of kernels/tiling.py::blocked_spmm as blockIdx.y)
// in their serial form (no `pipeline`), with the generic contraction and
// the `shared_cols` one (the fused BCSR-dtANS contraction,
// dtans_spmv.py:117-121 and :189-195) as a compile-time flag.
//
// What bounds it. The function reads the compressed matrix once (stream
// words, escapes, per-row counts, coding tables) plus x, and writes y: at
// the SmolLM-135M head that is ~10.4 MB of compressed bytes, so the memory
// bound is about 3 microseconds at 3.35 TB/s. The decode itself is serial per
// lane: each segment is a chain of table lookups, a 3-limb multiply-add
// and block-wide claims that depend on the previous segment, so the kernel
// is bound by that latency chain times the number of segments, unless
// enough slices are in flight per SM to hide it.
//
// Design, first and simple:
//   * grid (S, ceil(B / bn)); one block per slice of L rows, one thread per
//     lane (row). blockDim is L rounded up to whole warps; threads past L
//     take part in the block scans with take = 0. The decoder
//     (dtans_decode.cuh) is shared with the decode-only kernel.
//   * contraction per segment and RHS column:
//       s = ((c0 + c1) + c2) + c3,  c_i = valid_i ? v_i * x[col_i] : 0,
//       acc += s
//     with __fmul_rn/__fadd_rn (or the double forms), so no FMA
//     contraction can differ between schedules. SpMV keeps acc in a
//     register; SpMM keeps a (bn, L) tile in dynamic shared memory and
//     reads x in its (n, B) row-major layout.
//   * SHARED (a block-filled pack, every in-bounds lane of a slice decodes
//     the same columns): col_i is lane 0's, broadcast with __shfl_sync, so
//     the warp's x loads go to one address (one transaction) instead of
//     one per lane. The reference gathers at lane 0's columns of the slice
//     (cols[:, 0]); a warp shuffle reaches lane 0 of the thread's own
//     warp, which is lane 0 of the slice whenever L <= 32 (BCSR-dtANS
//     encodes at L = r <= 8). In a wider slice it is the warp's first
//     lane, which decodes lane 0's columns whenever any lane of its warp
//     holds a real entry (in-bounds lanes form a prefix). A valid term
//     then multiplies the same x as the generic path, so the fused result
//     is bitwise the generic one.
//   * each block stops at its own slice's last segment (a segment past
//     every lane's end is a no-op).
// Left for later: few blocks per SM at L = 128 (384 blocks for the head on
// 132 SMs) and 28-30 idle threads of 32 at BCSR-dtANS's L = r = 2..4, the
// coding tables read through __ldg rather than staged in shared memory,
// 64-bit limbs instead of 32-bit limbs with __umulhi, and the pipelined
// schedule.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch.

#include "dtans_decode.cuh"

namespace {

// The column lane i gathers at: its own, or lane 0's under SHARED. Every
// thread of the warp must call it.
template <bool SHARED>
__device__ __forceinline__ long long gather_col(long long col) {
  return SHARED ? __shfl_sync(0xFFFFFFFFu, col, 0) : col;
}

// MAXT: the most threads a block of this instantiation has, so that the
// register budget fits L <= 256 (the usual lane widths) without the 64
// registers a 1024-thread block allows.
template <typename V, int MAXT, bool SHARED>
__global__ void __launch_bounds__(MAXT)
dtans_spmv_kernel(Args a, const V* __restrict__ x, long long n,
                  V* __restrict__ y) {
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

  V acc = V(0);
  for (int j = 0; j < nseg; ++j) {
    long long cols[H];
    unsigned long long vbits[H];
    bool valid[H];
    decode_segment(a, s, j, bc, st, cursor, esc_cur, cols, vbits, valid);
    V sum = V(0);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const long long col = gather_col<SHARED>(cols[i]);
      V c = V(0);
      if (valid[i]) {
        c = Num<V>::mul(Num<V>::value(vbits[i]), x[clampll(col, n - 1)]);
      }
      sum = (i == 0) ? c : Num<V>::add(sum, c);
    }
    acc = Num<V>::add(acc, sum);
  }
  if (in) y[(long long)s * a.L + threadIdx.x] = acc;
}

template <typename V, int MAXT, bool SHARED>
__global__ void __launch_bounds__(MAXT)
dtans_spmm_kernel(Args a, const V* __restrict__ x, long long n, long long B,
                  int bn, V* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* acc = reinterpret_cast<V*>(smem_raw);  // (bn, blockDim.x)
  __shared__ int warp_tot[MAX_WARPS];
  __shared__ int smax;
  const BlockCtx bc{warp_tot, (int)(blockDim.x >> 5)};
  const int s = blockIdx.x;
  const int lp = blockDim.x;
  const int lane = threadIdx.x;
  const bool in = lane < a.L;
  const long long b0 = (long long)blockIdx.y * bn;
  const int bt = (int)((B - b0) < bn ? (B - b0) : bn);
  for (int b = 0; b < bt; ++b) acc[b * lp + lane] = V(0);

  Lane st;
  long long cursor;
  long long esc_cur[2] = {0, 0};
  init_lane(a, s, in, bc, st, cursor);
  const int nseg = block_nseg(a, st, &smax);

  for (int j = 0; j < nseg; ++j) {
    long long cols[H];
    unsigned long long vbits[H];
    bool valid[H];
    decode_segment(a, s, j, bc, st, cursor, esc_cur, cols, vbits, valid);
    V vals[H];
    const V* xr[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      vals[i] = Num<V>::value(vbits[i]);
      xr[i] = x + clampll(gather_col<SHARED>(cols[i]), n - 1) * B + b0;
    }
    // Each lane owns its row of the tile: no barrier is needed here.
    for (int b = 0; b < bt; ++b) {
      V sum = V(0);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const V c = valid[i] ? Num<V>::mul(vals[i], xr[i][b]) : V(0);
        sum = (i == 0) ? c : Num<V>::add(sum, c);
      }
      acc[b * lp + lane] = Num<V>::add(acc[b * lp + lane], sum);
    }
  }
  if (in) {
    V* yr = y + ((long long)s * a.L + lane) * B + b0;
    for (int b = 0; b < bt; ++b) yr[b] = acc[b * lp + lane];
  }
}

constexpr int SMALL_BLOCK = 256;

template <typename V, bool SHARED>
void spmv_for(int threads, dim3 grid, dim3 block, cudaStream_t cs,
              const Args& a, const V* x, long long n, V* y) {
  if (threads <= SMALL_BLOCK) {
    dtans_spmv_kernel<V, SMALL_BLOCK, SHARED><<<grid, block, 0, cs>>>(
        a, x, n, y);
  } else {
    dtans_spmv_kernel<V, 1024, SHARED><<<grid, block, 0, cs>>>(a, x, n, y);
  }
}

template <typename V>
void launch_spmv(bool shared, int threads, dim3 grid, dim3 block,
                 cudaStream_t cs, const Args& a, const void* x, long long n,
                 void* y) {
  const V* xv = static_cast<const V*>(x);
  V* yv = static_cast<V*>(y);
  if (shared) {
    spmv_for<V, true>(threads, grid, block, cs, a, xv, n, yv);
  } else {
    spmv_for<V, false>(threads, grid, block, cs, a, xv, n, yv);
  }
}

// Opts in to the tile's dynamic shared memory (above 48 KB it must be
// asked for), then launches.
template <typename V, int MAXT, bool SHARED>
cudaError_t launch_spmm_t(dim3 grid, dim3 block, size_t smem,
                          cudaStream_t cs, const Args& a, const V* x,
                          long long n, long long B, int bn, V* y) {
  const cudaError_t err = cudaFuncSetAttribute(
      dtans_spmm_kernel<V, MAXT, SHARED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dtans_spmm_kernel<V, MAXT, SHARED><<<grid, block, smem, cs>>>(a, x, n, B,
                                                                bn, y);
  return cudaSuccess;
}

template <typename V, bool SHARED>
cudaError_t spmm_for(int threads, dim3 grid, dim3 block, size_t smem,
                     cudaStream_t cs, const Args& a, const V* x,
                     long long n, long long B, int bn, V* y) {
  if (threads <= SMALL_BLOCK) {
    return launch_spmm_t<V, SMALL_BLOCK, SHARED>(grid, block, smem, cs, a,
                                                 x, n, B, bn, y);
  }
  return launch_spmm_t<V, 1024, SHARED>(grid, block, smem, cs, a, x, n, B,
                                        bn, y);
}

template <typename V>
cudaError_t launch_spmm(bool shared, int threads, dim3 grid, dim3 block,
                        size_t smem, cudaStream_t cs, const Args& a,
                        const void* x, long long n, long long B, int bn,
                        void* y) {
  const V* xv = static_cast<const V*>(x);
  V* yv = static_cast<V*>(y);
  return shared ? spmm_for<V, true>(threads, grid, block, smem, cs, a, xv,
                                    n, B, bn, yv)
                : spmm_for<V, false>(threads, grid, block, smem, cs, a, xv,
                                     n, B, bn, yv);
}

}  // namespace

extern "C" {

// y (S, L) = per-slice rows of A x. f64 != 0 selects double values;
// shared != 0 the shared-column contraction.
int dtans_spmv_launch(int f64, const void* stream, long long wmax,
                      const void* esc, long long emax, const void* ns,
                      const void* nnz, const void* tab_symbol,
                      const void* tab_digit, const void* tab_base,
                      const void* tab_is_esc, int K, int pattern_bits, int S,
                      int L, int max_nseg, int shared, const void* x,
                      long long n, void* y, void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tab_symbol,
                           tab_digit, tab_base, tab_is_esc, K, pattern_bits,
                           S, L, max_nseg);
  const int threads = threads_for(L);
  const dim3 grid(S, 1), block(threads);
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  if (f64) {
    launch_spmv<double>(shared != 0, threads, grid, block, cs, a, x, n, y);
  } else {
    launch_spmv<float>(shared != 0, threads, grid, block, cs, a, x, n, y);
  }
  return (int)cudaGetLastError();
}

// y (S, L, B) = per-slice rows of A X, X (n, B) row-major, in column
// tiles of bn (grid.y = ceil(B / bn)).
int dtans_spmm_launch(int f64, const void* stream, long long wmax,
                      const void* esc, long long emax, const void* ns,
                      const void* nnz, const void* tab_symbol,
                      const void* tab_digit, const void* tab_base,
                      const void* tab_is_esc, int K, int pattern_bits, int S,
                      int L, int max_nseg, int shared, const void* x,
                      long long n, long long B, int bn, void* y,
                      void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tab_symbol,
                           tab_digit, tab_base, tab_is_esc, K, pattern_bits,
                           S, L, max_nseg);
  const int threads = threads_for(L);
  const dim3 grid(S, (unsigned)((B + bn - 1) / bn)), block(threads);
  const size_t itemsize = f64 ? sizeof(double) : sizeof(float);
  const size_t smem = (size_t)bn * threads * itemsize;
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const cudaError_t err =
      f64 ? launch_spmm<double>(shared != 0, threads, grid, block, smem, cs,
                                a, x, n, B, bn, y)
          : launch_spmm<float>(shared != 0, threads, grid, block, smem, cs,
                               a, x, n, B, bn, y);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most static shared memory any SpMM instantiation has (the tile gets
// the rest of the block's opt-in limit).
int dtans_spmm_static_smem(long long* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(
          dtans_spmm_kernel<float, SMALL_BLOCK, false>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, 1024, false>),
      reinterpret_cast<const void*>(
          dtans_spmm_kernel<double, SMALL_BLOCK, false>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, 1024, false>),
      reinterpret_cast<const void*>(
          dtans_spmm_kernel<float, SMALL_BLOCK, true>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, 1024, true>),
      reinterpret_cast<const void*>(
          dtans_spmm_kernel<double, SMALL_BLOCK, true>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, 1024, true>)};
  long long most = 0;
  for (const void* fn : fns) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return (int)err;
    if ((long long)fa.sharedSizeBytes > most) most = fa.sharedSizeBytes;
  }
  *out = most;
  return 0;
}

const char* dtans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
