// Fused dtANS decode + SpMV / SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/dtans_spmv.py::_spmv_kernel  (dtans_spmv_pallas)
//   src/repro/kernels/dtans_spmv.py::_spmm_kernel  (dtans_spmm_pallas, with
//     the column tiles of kernels/tiling.py::blocked_spmm as blockIdx.y)
// in their serial, generic-contraction form (no `pipeline`, no
// `shared_cols`).
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
//     take part in the block scans with take = 0.
//   * stream claims (`_claim` in kernels/common.py) are a block-wide
//     exclusive scan in lane order: __ballot_sync + __popc per warp, warp
//     totals through shared memory. The cursor is block-uniform.
//   * escapes: per position, a block scan of is_esc (gated by `active`,
//     not by `valid`) ranks each lane in its table's escape stream; the
//     scan is skipped when no lane of the block escapes.
//   * state as in the reference: words as uint32, d and r as three 32-bit
//     limbs in 64-bit registers, digit groups (gacc/racc) in 64 bits (racc
//     can be exactly 2^32).
//   * contraction per segment and RHS column:
//       s = ((c0 + c1) + c2) + c3,  c_i = valid_i ? v_i * x[col_i] : 0,
//       acc += s
//     with __fmul_rn/__fadd_rn (or the double forms), so no FMA
//     contraction can differ between schedules. SpMV keeps acc in a
//     register; SpMM keeps a (bn, L) tile in dynamic shared memory and
//     reads x in its (n, B) row-major layout.
//   * each block stops at its own slice's last segment (a segment past
//     every lane's end is a no-op).
// Left for later: few blocks per SM at L = 128 (384 blocks for the head on
// 132 SMs), the coding tables read through __ldg rather than staged in
// shared memory, 64-bit limbs instead of 32-bit limbs with __umulhi, and
// the pipelined and shared-column schedules.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The paper's production parameters (core/params.py::PAPER); the Python
// wrapper refuses any other set.
constexpr int WB = 32;   // log2(W): stream word bits
constexpr int KB = 12;   // log2(K): table slot bits
constexpr int LS = 8;    // symbols per segment
constexpr int O = 3;     // words per segment
constexpr int F = 2;     // conditional loads per segment
constexpr int MB = 8;    // log2(M): multiplicity cap bits
constexpr int H = LS / 2;                       // nonzeros per segment
constexpr int G = (32 / MB) > 0 ? (32 / MB) : 1;  // digits per fold group
constexpr unsigned long long M32 = 0xFFFFFFFFull;
constexpr unsigned long long WM1 = (1ull << WB) - 1;
constexpr unsigned long long KM1 = (1ull << KB) - 1;
// Each kernel's static shared memory is warp_tot[MAX_WARPS] plus smax,
// 132 B, laid out in 144 B; kernels/tiling.py::STATIC_SMEM_BYTES must
// match what dtans_spmm_static_smem reports.
constexpr int MAX_WARPS = 32;

struct Args {
  const uint32_t* stream;            // (S, wmax)
  long long wmax;
  const unsigned long long* esc;     // (T, S, emax)
  long long emax;
  const int* ns;                     // (S, L)
  const int* nnz;                    // (S, L)
  const unsigned long long* tab_symbol;  // (T, K)
  const int* tab_digit;              // (T, K)
  const int* tab_base;               // (T, K)
  const int* tab_is_esc;             // (T, K)
  int K;
  int pattern_bits;                  // bit k = table of segment position k
  int S;
  int L;
  int max_nseg;
};

struct Lane {
  uint32_t w[O];
  unsigned long long d[3];
  unsigned long long r[3];
  long long col;
  int nsegs;
  int nnz;
};

struct BlockCtx {
  int* warp_tot;  // shared, MAX_WARPS ints
  int nwarps;
};

// Exclusive rank of this thread among the block's threads with `take`, in
// thread order; *total receives the block's count. Every thread of the
// block must call it.
__device__ __forceinline__ int block_rank(bool take, const BlockCtx& bc,
                                          int* total) {
  const unsigned lane = threadIdx.x & 31u;
  const int warp = (int)(threadIdx.x >> 5);
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, take);
  const int r = __popc(mask & ((1u << lane) - 1u));
  if (lane == 0) bc.warp_tot[warp] = __popc(mask);
  __syncthreads();
  int off = 0, tot = 0;
  for (int w = 0; w < bc.nwarps; ++w) {
    const int c = bc.warp_tot[w];
    off += (w < warp) ? c : 0;
    tot += c;
  }
  __syncthreads();
  *total = tot;
  return off + r;
}

__device__ __forceinline__ long long clampll(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ void limb_mul_add(unsigned long long d[3],
                                             unsigned long long m,
                                             unsigned long long a) {
  const unsigned long long t0 = d[0] * m + a;
  const unsigned long long t1 = d[1] * m + (t0 >> 32);
  const unsigned long long t2 = d[2] * m + (t1 >> 32);
  d[0] = t0 & M32;
  d[1] = t1 & M32;
  d[2] = t2 & M32;
}

__device__ __forceinline__ bool limb_ge_w(const unsigned long long r[3]) {
  const bool hi = (r[1] > 0) || (r[2] > 0);
  if (WB == 32) return hi;
  return hi || ((r[0] >> WB) > 0);
}

__device__ __forceinline__ void limb_shr(unsigned long long d[3]) {
  const unsigned long long full0 = d[0] | (d[1] << 32);
  const unsigned long long full1 = d[1] | (d[2] << 32);
  d[0] = (full0 >> WB) & M32;
  d[1] = (full1 >> WB) & M32;
  d[2] = d[2] >> WB;
}

// init_state (kernels/common.py): O claims in k order by every live lane.
__device__ __forceinline__ void init_lane(const Args& a, int s, bool in,
                                          const BlockCtx& bc, Lane& st,
                                          long long& cursor) {
  const int ns = in ? a.ns[(long long)s * a.L + threadIdx.x] : 0;
  st.nnz = in ? a.nnz[(long long)s * a.L + threadIdx.x] : 0;
  st.nsegs = (ns + LS - 1) / LS;
  const bool live = ns > 0;
  const uint32_t* row = a.stream + (long long)s * a.wmax;
  cursor = 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    int tot;
    const int rank = block_rank(live, bc, &tot);
    st.w[k] = live ? row[clampll(cursor + rank, a.wmax - 1)] : 0u;
    cursor += tot;
  }
  st.d[0] = st.d[1] = st.d[2] = 0;
  st.r[0] = 1;
  st.r[1] = st.r[2] = 0;
  st.col = 0;
}

// segment_step (kernels/common.py) for one lane: decodes segment j and
// returns its H (column, value bits, valid) triples.
__device__ __forceinline__ void decode_segment(
    const Args& a, int s, int j, const BlockCtx& bc, Lane& st,
    long long& cursor, long long esc_cur[2], long long cols[H],
    unsigned long long vbits[H], bool valid[H]) {
  const bool active = j < st.nsegs;  // nsegs == 0 past L
  unsigned long long syms[LS];
  uint32_t digs[LS], bass[LS];

  // ---- unpack + table lookups -----------------------------------------
#pragma unroll
  for (int k = 0; k < LS; ++k) {
    const int lo = k * KB;
    const int wi = lo / WB, sh = lo % WB;
    // little-endian word view: word wi is w[O - 1 - wi]
    unsigned long long pair = st.w[O - 1 - wi];
    if (wi + 1 < O) pair |= (unsigned long long)st.w[O - 2 - wi] << WB;
    const int slot = (int)((pair >> sh) & KM1);
    const int t = (a.pattern_bits >> k) & 1;
    const int ti = t * a.K + slot;
    unsigned long long sym = __ldg(a.tab_symbol + ti);
    const bool is_esc = active && (__ldg(a.tab_is_esc + ti) > 0);
    if (__syncthreads_or(is_esc)) {
      int tot;
      const int rank = block_rank(is_esc, bc, &tot);
      if (is_esc) {
        const long long e = clampll(esc_cur[t] + rank, a.emax - 1);
        sym = a.esc[((long long)t * a.S + s) * a.emax + e];
      }
      esc_cur[t] += tot;
    }
    syms[k] = sym;
    digs[k] = active ? (uint32_t)__ldg(a.tab_digit + ti) : 0u;
    bass[k] = active ? (uint32_t)__ldg(a.tab_base + ti) : 1u;
  }

  // ---- positions: even = delta, odd = value bits ------------------------
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int q = j * H + i;
    const bool ok = active && (q < st.nnz);
    if (ok) st.col += (long long)syms[2 * i];
    cols[i] = st.col;
    vbits[i] = syms[2 * i + 1];
    valid[i] = ok;
  }

  // ---- fold digits into the limb state (groups fit 32 bits) -------------
#pragma unroll
  for (int g0 = 0; g0 < LS; g0 += G) {
    unsigned long long gacc = 0, racc = 1;
#pragma unroll
    for (int k = g0; k < g0 + G && k < LS; ++k) {
      gacc = gacc * bass[k] + digs[k];
      racc = racc * bass[k];
    }
    limb_mul_add(st.d, racc, gacc);
    limb_mul_add(st.r, racc, 0ull);
  }

  // ---- refill -----------------------------------------------------------
  const bool refill = active && (j < st.nsegs - 1);
  const uint32_t* row = a.stream + (long long)s * a.wmax;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    uint32_t wk = 0u;
    bool popl = refill;
    if (k < F) {
      const bool cond = limb_ge_w(st.r) && refill;
      wk = (uint32_t)(st.d[0] & WM1);
      if (cond) {
        limb_shr(st.d);
        limb_shr(st.r);
      }
      popl = refill && !cond;
    }
    int tot;
    const int rank = block_rank(popl, bc, &tot);
    if (popl) wk = row[clampll(cursor + rank, a.wmax - 1)];
    cursor += tot;
    if (refill) st.w[k] = wk;
  }
}

template <typename V> struct Num;
template <> struct Num<float> {
  __device__ static float value(unsigned long long bits) {
    return __uint_as_float((unsigned)(bits & M32));
  }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Num<double> {
  __device__ static double value(unsigned long long bits) {
    return __longlong_as_double((long long)bits);
  }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

// Last segment any lane of this slice decodes, block-uniform.
__device__ __forceinline__ int block_nseg(const Args& a, const Lane& st,
                                          int* smax) {
  if (threadIdx.x == 0) *smax = 0;
  __syncthreads();
  if (st.nsegs > 0) atomicMax(smax, st.nsegs);
  __syncthreads();
  const int n = *smax;
  return n < a.max_nseg ? n : a.max_nseg;
}

// MAXT: the most threads a block of this instantiation has, so that the
// register budget fits L <= 256 (the usual lane widths) without the 64
// registers a 1024-thread block allows.
template <typename V, int MAXT>
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
      V c = V(0);
      if (valid[i]) {
        c = Num<V>::mul(Num<V>::value(vbits[i]),
                        x[clampll(cols[i], n - 1)]);
      }
      sum = (i == 0) ? c : Num<V>::add(sum, c);
    }
    acc = Num<V>::add(acc, sum);
  }
  if (in) y[(long long)s * a.L + threadIdx.x] = acc;
}

template <typename V, int MAXT>
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
      xr[i] = x + clampll(cols[i], n - 1) * B + b0;
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

Args make_args(const void* stream, long long wmax, const void* esc,
               long long emax, const void* ns, const void* nnz,
               const void* tab_symbol, const void* tab_digit,
               const void* tab_base, const void* tab_is_esc, int K,
               int pattern_bits, int S, int L, int max_nseg) {
  Args a;
  a.stream = static_cast<const uint32_t*>(stream);
  a.wmax = wmax;
  a.esc = static_cast<const unsigned long long*>(esc);
  a.emax = emax;
  a.ns = static_cast<const int*>(ns);
  a.nnz = static_cast<const int*>(nnz);
  a.tab_symbol = static_cast<const unsigned long long*>(tab_symbol);
  a.tab_digit = static_cast<const int*>(tab_digit);
  a.tab_base = static_cast<const int*>(tab_base);
  a.tab_is_esc = static_cast<const int*>(tab_is_esc);
  a.K = K;
  a.pattern_bits = pattern_bits;
  a.S = S;
  a.L = L;
  a.max_nseg = max_nseg;
  return a;
}

int threads_for(int L) { return ((L + 31) / 32) * 32; }

constexpr int SMALL_BLOCK = 256;

template <typename V>
void launch_spmv(int threads, dim3 grid, dim3 block, cudaStream_t cs,
                 const Args& a, const V* x, long long n, V* y) {
  if (threads <= SMALL_BLOCK) {
    dtans_spmv_kernel<V, SMALL_BLOCK><<<grid, block, 0, cs>>>(a, x, n, y);
  } else {
    dtans_spmv_kernel<V, 1024><<<grid, block, 0, cs>>>(a, x, n, y);
  }
}

// Opts in to the tile's dynamic shared memory (above 48 KB it must be
// asked for), then launches.
template <typename V, int MAXT>
cudaError_t launch_spmm_t(dim3 grid, dim3 block, size_t smem,
                          cudaStream_t cs, const Args& a, const V* x,
                          long long n, long long B, int bn, V* y) {
  const cudaError_t err = cudaFuncSetAttribute(
      dtans_spmm_kernel<V, MAXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dtans_spmm_kernel<V, MAXT><<<grid, block, smem, cs>>>(a, x, n, B, bn, y);
  return cudaSuccess;
}

template <typename V>
cudaError_t launch_spmm(int threads, dim3 grid, dim3 block, size_t smem,
                        cudaStream_t cs, const Args& a, const V* x,
                        long long n, long long B, int bn, V* y) {
  if (threads <= SMALL_BLOCK) {
    return launch_spmm_t<V, SMALL_BLOCK>(grid, block, smem, cs, a, x, n, B,
                                         bn, y);
  }
  return launch_spmm_t<V, 1024>(grid, block, smem, cs, a, x, n, B, bn, y);
}

}  // namespace

extern "C" {

// y (S, L) = per-slice rows of A x. f64 != 0 selects double values.
int dtans_spmv_launch(int f64, const void* stream, long long wmax,
                      const void* esc, long long emax, const void* ns,
                      const void* nnz, const void* tab_symbol,
                      const void* tab_digit, const void* tab_base,
                      const void* tab_is_esc, int K, int pattern_bits, int S,
                      int L, int max_nseg, const void* x, long long n,
                      void* y, void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tab_symbol,
                           tab_digit, tab_base, tab_is_esc, K, pattern_bits,
                           S, L, max_nseg);
  const int threads = threads_for(L);
  const dim3 grid(S, 1), block(threads);
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  if (f64) {
    launch_spmv<double>(threads, grid, block, cs, a,
                        static_cast<const double*>(x), n,
                        static_cast<double*>(y));
  } else {
    launch_spmv<float>(threads, grid, block, cs, a,
                       static_cast<const float*>(x), n,
                       static_cast<float*>(y));
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
                      int L, int max_nseg, const void* x, long long n,
                      long long B, int bn, void* y, void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tab_symbol,
                           tab_digit, tab_base, tab_is_esc, K, pattern_bits,
                           S, L, max_nseg);
  const int threads = threads_for(L);
  const dim3 grid(S, (unsigned)((B + bn - 1) / bn)), block(threads);
  const size_t itemsize = f64 ? sizeof(double) : sizeof(float);
  const size_t smem = (size_t)bn * threads * itemsize;
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const cudaError_t err =
      f64 ? launch_spmm<double>(threads, grid, block, smem, cs, a,
                                static_cast<const double*>(x), n, B, bn,
                                static_cast<double*>(y))
          : launch_spmm<float>(threads, grid, block, smem, cs, a,
                               static_cast<const float*>(x), n, B, bn,
                               static_cast<float*>(y));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most static shared memory any SpMM instantiation has (the tile gets
// the rest of the block's opt-in limit).
int dtans_spmm_static_smem(long long* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, SMALL_BLOCK>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<float, 1024>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, SMALL_BLOCK>),
      reinterpret_cast<const void*>(dtans_spmm_kernel<double, 1024>)};
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
