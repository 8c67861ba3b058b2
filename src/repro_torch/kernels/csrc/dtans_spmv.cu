// Fused dtANS decode + SpMV / SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/dtans_spmv.py::_spmv_kernel  (dtans_spmv_pallas)
//   src/repro/kernels/dtans_spmv.py::_spmm_kernel  (dtans_spmm_pallas, with
//     the column tiles of kernels/tiling.py::blocked_spmm)
// with the generic contraction and the `shared_cols` one (the fused
// BCSR-dtANS contraction, dtans_spmv.py:117-121 and :189-195) as a
// compile-time flag, and in the reference's `pipeline` schedule
// (_decode_contract, dtans_spmv.py:65-96): both kernels decode segment
// j + 1 while segment j is contracted, in the same contraction order, so
// `pipeline=True` and `pipeline=False` launch these same kernels and give
// the same bits.
//
// What bounds it. The function reads the compressed matrix once (stream
// words, escapes, per-row counts, coding tables) plus x, and writes y: at
// the SmolLM-135M head that is ~10.4 MB, about 3 microseconds at 3.35 TB/s;
// at B = 64 its 2 nnz B multiply-adds bound it at ~0.011 ms. The decode is
// a serial chain per lane (table lookups, limb arithmetic, claims that
// depend on the previous segment), so at small B the kernel is bound by
// that chain's latency times the segments, unless enough slices are in
// flight per SM to hide it; at large B the contraction's x reads bound it.
//
// Design (the decoder is dtans_decode.cuh's, warp-synchronous):
//   * persistent blocks (the geometry comes from kernels/tiling.py): the
//     coding tables are staged in shared memory once per block (where the
//     parameter set's plan puts them there; else read from global memory,
//     dtans_decode.cuh), and each
//     block loops over its share of the units (a warp of packed narrow
//     slices, or the warps of one wide slice);
//   * SpMV: one thread per lane, the accumulator in a register. After
//     decoding segment j + 1 it contracts segment j from registers; the x
//     loads of segment j are issued before the decode of j + 1, so their
//     latency hides behind it;
//   * SpMM, warp-specialised: the unit's decoder warps write each decoded
//     segment (column with a valid flag in bit 31, value) into a ring of
//     two segments in shared memory, a row's H entries together (at
//     PAPER's H = 4, 16 bytes: one vector access);
//     contraction warps, mapped to columns, read it under named barriers
//     (full / empty per stage), four rows a lane at a time so that 16 x
//     loads are in flight. Thread b owns column b0 + b of a row: its x
//     reads x[col, b0 + b] are coalesced (32 columns are one 128-byte
//     line; a tile narrower than 32 columns puts several row groups in a
//     warp), and it adds into acc[row][b] in shared memory, neighbouring
//     threads on neighbouring banks. Under SHARED the rows of a share
//     group load one x line per position. Each (row, column) is owned by
//     one thread and takes its terms in segment order;
//   * the contraction per segment and column is, in both kernels,
//       s = ((c0 + c1) + ...) + c_{H-1},  c_i = valid_i ? v_i * x[col_i] : 0,
//       acc += s
//     with __fmul_rn/__fadd_rn (or the double forms), so tiled, untiled,
//     SpMV and SpMM at B = 1 agree bitwise with each other and with the
//     plain torch version. x is read at clamp(col, 0, n - 1); masked terms
//     are selects;
//   * column tiles of bn columns are separate work items (the accumulator
//     tile is (rows, bn) in shared memory), so a slice is decoded once per
//     tile.
//
// Plain C interface (loaded with ctypes): every entry returns a CUDA error
// code, cudaGetLastError() after its launch.

#include "dtans_decode.cuh"

namespace {

constexpr int D = 2;  // SpMM ring depth, in segments
constexpr int INVALID = (int)0x80000000u;

__host__ __device__ inline long long spmv_need(int T, int uw, int upb) {
  return tables_bytes(T) + (long long)upb * unit_bytes(uw);
}

__host__ __device__ inline long long spmm_need(int T, int uw, int bn,
                                               int item) {
  const long long R = (long long)uw * 32;
  return tables_bytes(T) + unit_bytes(uw) + align16(D * H * R * 4) +
         align16(D * H * R * item) + align16(R * bn * item);
}

template <typename V, int MAXT, bool SHARED>
__global__ void __launch_bounds__(MAXT)
dtans_spmv_kernel(Args a, Geom gm, const V* __restrict__ x, long long n,
                  V* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = stage_tables(a, smem);
  const int warp = threadIdx.x >> 5;
  const int gi = warp / gm.uw;
  const UnitSmem us = unit_smem(
      smem + tables_bytes(a.T) + gi * unit_bytes(gm.uw), gm.uw);
  for (long long u = (long long)blockIdx.x * gm.upb + gi; u < gm.units;
       u += (long long)gridDim.x * gm.upb) {
    Group g = make_group(a, gm, us, u, warp - gi * gm.uw, 1 + gi);
    Lane st;
    const int nseg = init_lane(a, g, st);
    V acc = V(0);
    Seg cur;
    if (nseg > 0) decode_segment(a, tb, g, st, 0, cur);
    for (int j = 0; j < nseg; ++j) {
      int cols[H];
      gather_cols<SHARED>(g, cur, (int)n, cols);
      V xv[H];
#pragma unroll
      for (int i = 0; i < H; ++i)
        xv[i] = bit(cur.valid, i) ? __ldg(x + cols[i]) : V(0);
      Seg nxt = cur;
      if (j + 1 < nseg) decode_segment(a, tb, g, st, j + 1, nxt);
      V sum = V(0);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const V c = bit(cur.valid, i)
                        ? Num<V>::mul(Num<V>::value(cur.vb[i]), xv[i])
                        : V(0);
        sum = (i == 0) ? c : Num<V>::add(sum, c);
      }
      acc = Num<V>::add(acc, sum);
      cur = nxt;
    }
    if (g.in) y[g.s * a.L + g.lane] = acc;
  }
}

// Row r of unit u: its output row (slice * L + lane) and whether it is one.
__device__ __forceinline__ bool unit_row(const Args& a, const Geom& gm,
                                         long long u, int r,
                                         long long* yrow) {
  long long s = u;
  int lane = r;
  if (gm.uw == 1) {
    s = u * gm.spu + r / gm.group;
    lane = r % gm.group;
  }
  *yrow = s * a.L + lane;
  return lane < a.L && s < a.S;
}

// A ring row's H entries. At H = 4 (PAPER) a row is 16-byte aligned: one
// vector access each; other sets take one access an entry.
template <typename T>
__device__ __forceinline__ void store_entries(T* p, const T v[H]) {
#pragma unroll
  for (int i = 0; i < H; ++i) p[i] = v[i];
}
template <typename T>
__device__ __forceinline__ void load_entries(const T* p, T v[H]) {
#pragma unroll
  for (int i = 0; i < H; ++i) v[i] = p[i];
}
__device__ __forceinline__ void store_cols(int* p, const int v[H]) {
  if constexpr (H == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    store_entries(p, v);
  }
}
__device__ __forceinline__ void load_cols(const int* p, int v[H]) {
  if constexpr (H == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    load_entries(p, v);
  }
}
__device__ __forceinline__ void store_row(float* p, const float v[H]) {
  if constexpr (H == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    store_entries(p, v);
  }
}
__device__ __forceinline__ void store_row(double* p, const double v[H]) {
  if constexpr (H == 4) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  } else {
    store_entries(p, v);
  }
}
__device__ __forceinline__ void load_row(const float* p, float v[H]) {
  if constexpr (H == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    load_entries(p, v);
  }
}
__device__ __forceinline__ void load_row(const double* p, double v[H]) {
  if constexpr (H == 4) {
    const double2 q0 = reinterpret_cast<const double2*>(p)[0];
    const double2 q1 = reinterpret_cast<const double2*>(p)[1];
    v[0] = q0.x;
    v[1] = q0.y;
    v[2] = q1.x;
    v[3] = q1.y;
  } else {
    load_entries(p, v);
  }
}

constexpr int RB = 4;  // rows a contraction lane takes at once

template <typename V, int MAXT, bool SHARED>
__global__ void __launch_bounds__(MAXT)
dtans_spmm_kernel(Args a, Geom gm, const V* __restrict__ x, long long n,
                  long long B, int bn, V* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = stage_tables(a, smem);
  const int R = gm.uw * 32;  // rows of a unit (thread lanes)
  unsigned char* p = smem + tables_bytes(a.T);
  const UnitSmem us = unit_smem(p, gm.uw);
  p += unit_bytes(gm.uw);
  int* rcol = reinterpret_cast<int*>(p);  // [D][R][H]
  p += align16((long long)D * H * R * 4);
  V* rval = reinterpret_cast<V*>(p);      // [D][R][H]
  p += align16((long long)D * H * R * sizeof(V));
  V* acc = reinterpret_cast<V*>(p);       // [R][bn]
  const int nthreads = blockDim.x;
  const long long ntiles = (B + bn - 1) / bn;
  const long long items = gm.units * ntiles;
  const int warp = threadIdx.x >> 5;
  long long q = 0;  // segments through the ring so far

  if (warp < gm.uw) {
    // ---- decoder warps ----------------------------------------------------
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      Group g = make_group(a, gm, us, it / ntiles, warp, 1 + 2 * D);
      Lane st;
      const int nseg = init_lane(a, g, st);
      for (int j = 0; j < nseg; ++j, ++q) {
        Seg sg;
        decode_segment(a, tb, g, st, j, sg);
        int cols[H];
        gather_cols<SHARED>(g, sg, (int)n, cols);
        V vals[H];
#pragma unroll
        for (int i = 0; i < H; ++i) {
          if (!bit(sg.valid, i)) cols[i] |= INVALID;
          vals[i] = Num<V>::value(sg.vb[i]);
        }
        const int stage = (int)(q % D);
        if (q >= D) bar_sync(1 + D + stage, nthreads);
        const int at = (stage * R + g.r) * H;
        store_cols(rcol + at, cols);
        store_row(rval + at, vals);
        __threadfence_block();
        bar_arrive(1 + stage, nthreads);
      }
    }
    // Pair the contraction warps' last "empty" arrivals, so no barrier is
    // left half-arrived.
    for (long long k = q > D ? q - D : 0; k < q; ++k)
      bar_sync(1 + D + (int)(k % D), nthreads);
    return;
  }

  // ---- contraction warps ------------------------------------------------
  // A lane owns column b0 + ch * BW + bl of RB consecutive rows. BW is the
  // tile's width rounded up to a power of two, at most 32, so a narrow
  // tile puts 32 / BW row groups in a warp instead of idling lanes.
  const int ct = threadIdx.x - gm.uw * 32;
  const int cw = ct >> 5, cl = ct & 31;
  // Under SHARED the RB rows of a lane lie in one share group (the rows
  // that gather at one lane's columns) when the group has RB rows or
  // more: one x load per position for the RB rows.
  const bool one_x = SHARED && (gm.uw > 1 || gm.group >= RB);
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long u = it / ntiles;
    const long long b0 = (it % ntiles) * bn;
    const int bt = (int)((B - b0) < bn ? (B - b0) : bn);
    const int BW = bt >= 32 ? 32 : (bt <= 1 ? 1 : 1 << (32 - __clz(bt - 1)));
    const int bl = cl % BW, rl = cl / BW;
    const int nc = (bt + BW - 1) / BW;
    const int step = (32 / BW) * RB;  // rows a warp takes at once
    int mx = 0;
    for (int r = cl; r < R; r += 32) {
      long long yr;
      if (unit_row(a, gm, u, r, &yr)) mx = max(mx, (a.ns[yr] + LS - 1) / LS);
    }
    int nseg = (int)__reduce_max_sync(FULL, (unsigned)mx);
    nseg = nseg < a.max_nseg ? nseg : a.max_nseg;
    for (int rs = cw * step; rs < R; rs += gm.cw * step) {
      const int r0 = rs + rl * RB;
      if (r0 >= R) continue;
      for (int ch = 0; ch < nc; ++ch) {
        const int b = ch * BW + bl;
        if (b < bt)
          for (int k = 0; k < RB; ++k) acc[(r0 + k) * bn + b] = V(0);
      }
    }
    for (int j = 0; j < nseg; ++j, ++q) {
      const int stage = (int)(q % D);
      bar_sync(1 + stage, nthreads);
      for (int rs = cw * step; rs < R; rs += gm.cw * step) {
        const int r0 = rs + rl * RB;
        if (r0 >= R) continue;
        int c[RB][H];
        V v[RB][H];
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int at = (stage * R + r0 + k) * H;
          load_cols(rcol + at, c[k]);
          load_row(rval + at, v[k]);
        }
        for (int ch = 0; ch < nc; ++ch) {
          const int b = ch * BW + bl;
          const bool on = b < bt;
          const V* xb = x + b0 + b;
          V xv[RB][H];
          if (one_x) {
#pragma unroll
            for (int i = 0; i < H; ++i) {
              const long long col = c[0][i] & 0x7FFFFFFF;
              const V xi = (on && n > 0) ? __ldg(xb + col * B) : V(0);
#pragma unroll
              for (int k = 0; k < RB; ++k) xv[k][i] = xi;
            }
          } else {
#pragma unroll
            for (int k = 0; k < RB; ++k)
#pragma unroll
              for (int i = 0; i < H; ++i)
                xv[k][i] = (on && c[k][i] >= 0)
                               ? __ldg(xb + (long long)c[k][i] * B)
                               : V(0);
          }
          if (!on) continue;
#pragma unroll
          for (int k = 0; k < RB; ++k) {
            V sum = V(0);
#pragma unroll
            for (int i = 0; i < H; ++i) {
              const V t = c[k][i] >= 0 ? Num<V>::mul(v[k][i], xv[k][i])
                                       : V(0);
              sum = (i == 0) ? t : Num<V>::add(sum, t);
            }
            V* ap = acc + (r0 + k) * bn + b;
            *ap = Num<V>::add(*ap, sum);
          }
        }
      }
      bar_arrive(1 + D + stage, nthreads);
    }
    for (int rs = cw * step; rs < R; rs += gm.cw * step) {
      const int r0 = rs + rl * RB;
      if (r0 >= R) continue;
      for (int k = 0; k < RB; ++k) {
        long long yr;
        if (!unit_row(a, gm, u, r0 + k, &yr)) continue;
        for (int ch = 0; ch < nc; ++ch) {
          const int b = ch * BW + bl;
          if (b < bt) y[yr * B + b0 + b] = acc[(r0 + k) * bn + b];
        }
      }
    }
  }
}

template <typename V, int MAXT, bool SHARED>
cudaError_t spmv_t(int blocks, int threads, long long smem, cudaStream_t cs,
                   const Args& a, const Geom& gm, const void* x, long long n,
                   void* y) {
  const cudaError_t err = opt_in(dtans_spmv_kernel<V, MAXT, SHARED>, smem);
  if (err != cudaSuccess) return err;
  dtans_spmv_kernel<V, MAXT, SHARED><<<blocks, threads, smem, cs>>>(
      a, gm, static_cast<const V*>(x), n, static_cast<V*>(y));
  return cudaGetLastError();
}

template <typename V, bool SHARED>
cudaError_t spmv_for(int blocks, int threads, long long smem,
                     cudaStream_t cs, const Args& a, const Geom& gm,
                     const void* x, long long n, void* y) {
  return threads <= 256
             ? spmv_t<V, 256, SHARED>(blocks, threads, smem, cs, a, gm, x, n,
                                      y)
             : spmv_t<V, 1024, SHARED>(blocks, threads, smem, cs, a, gm, x,
                                       n, y);
}

template <typename V, int MAXT, bool SHARED>
cudaError_t spmm_t(int blocks, int threads, long long smem, cudaStream_t cs,
                   const Args& a, const Geom& gm, const void* x, long long n,
                   long long B, int bn, void* y) {
  const cudaError_t err = opt_in(dtans_spmm_kernel<V, MAXT, SHARED>, smem);
  if (err != cudaSuccess) return err;
  dtans_spmm_kernel<V, MAXT, SHARED><<<blocks, threads, smem, cs>>>(
      a, gm, static_cast<const V*>(x), n, B, bn, static_cast<V*>(y));
  return cudaGetLastError();
}

template <typename V, bool SHARED>
cudaError_t spmm_for(int blocks, int threads, long long smem,
                     cudaStream_t cs, const Args& a, const Geom& gm,
                     const void* x, long long n, long long B, int bn,
                     void* y) {
  return threads <= 512
             ? spmm_t<V, 512, SHARED>(blocks, threads, smem, cs, a, gm, x, n,
                                      B, bn, y)
             : spmm_t<V, 1024, SHARED>(blocks, threads, smem, cs, a, gm, x,
                                       n, B, bn, y);
}

}  // namespace

extern "C" {

// Shared memory the kernels need for a plan (kernels/tiling.py::smem_plan
// must give the same): spmm != 0 for SpMM at column tile bn.
long long dtans_smem_need(int spmm, int T, int uw, int upb, int bn,
                          int itemsize) {
  return spmm ? spmm_need(T, uw, bn, itemsize) : spmv_need(T, uw, upb);
}

// y (S, L) = per-slice rows of A x. f64 != 0 selects double values;
// shared != 0 the shared-column contraction. The geometry (group .. smem)
// is kernels/tiling.py::geometry's.
int dtans_spmv_launch(int f64, const void* stream, long long wmax,
                      const void* esc, long long emax, const void* ns,
                      const void* nnz, const void* tables, int T,
                      PatternArg pattern_bits, int S, int L, int max_nseg,
                      int group, int uw, int spu, long long units, int upb,
                      int cw, int blocks, int threads, long long smem,
                      int shared, const void* x, long long n, void* y,
                      void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tables, T,
                           pattern_bits, S, L, max_nseg);
  const Geom gm = make_geom(group, uw, spu, units, upb, cw);
  if (threads != upb * uw * 32 || smem < spmv_need(T, uw, upb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  cudaError_t err;
  if (f64) {
    err = shared ? spmv_for<double, true>(blocks, threads, smem, cs, a, gm,
                                          x, n, y)
                 : spmv_for<double, false>(blocks, threads, smem, cs, a, gm,
                                           x, n, y);
  } else {
    err = shared ? spmv_for<float, true>(blocks, threads, smem, cs, a, gm, x,
                                         n, y)
                 : spmv_for<float, false>(blocks, threads, smem, cs, a, gm, x,
                                          n, y);
  }
  return (int)err;
}

// y (S, L, B) = per-slice rows of A X, X (n, B) row-major, in column
// tiles of bn.
int dtans_spmm_launch(int f64, const void* stream, long long wmax,
                      const void* esc, long long emax, const void* ns,
                      const void* nnz, const void* tables, int T,
                      PatternArg pattern_bits, int S, int L, int max_nseg,
                      int group, int uw, int spu, long long units, int upb,
                      int cw, int blocks, int threads, long long smem,
                      int shared, const void* x, long long n, long long B,
                      int bn, void* y, void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tables, T,
                           pattern_bits, S, L, max_nseg);
  const Geom gm = make_geom(group, uw, spu, units, upb, cw);
  const int item = f64 ? 8 : 4;
  if (cw < 1 || upb != 1 || threads != (uw + cw) * 32 ||
      smem < spmm_need(T, uw, bn, item))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  cudaError_t err;
  if (f64) {
    err = shared ? spmm_for<double, true>(blocks, threads, smem, cs, a, gm,
                                          x, n, B, bn, y)
                 : spmm_for<double, false>(blocks, threads, smem, cs, a, gm,
                                           x, n, B, bn, y);
  } else {
    err = shared ? spmm_for<float, true>(blocks, threads, smem, cs, a, gm, x,
                                         n, B, bn, y)
                 : spmm_for<float, false>(blocks, threads, smem, cs, a, gm, x,
                                          n, B, bn, y);
  }
  return (int)err;
}

// The most static shared memory any instantiation has (the plan's dynamic
// shared memory gets the rest of the block's opt-in limit).
int dtans_spmm_static_smem(long long* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, 512, false>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, 1024, false>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, 512, false>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, 1024, false>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, 512, true>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, 1024, true>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, 512, true>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, 1024, true>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<float, 256, false>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<float, 1024, false>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<double, 256, false>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<double, 1024, false>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<float, 256, true>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<float, 1024, true>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<double, 256, true>),
      reinterpret_cast<const void*>(dtans_spmv_kernel<double, 1024, true>)};
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
