// The lock-step dtANS decoder for Hopper (sm_90a), shared by the fused
// SpMV / SpMM kernels (dtans_spmv.cu) and the decode-only kernel
// (dtans_decode.cu).
//
// It is the CUDA form of the JAX package's kernels/common.py::init_state
// and segment_step, one thread per lane (row) of a slice, one block per
// slice:
//   * stream claims (`_claim`) are a block-wide exclusive scan in lane
//     order: __ballot_sync + __popc per warp, warp totals through shared
//     memory. The cursor is block-uniform.
//   * escapes: per position, a block scan of is_esc (gated by `active`,
//     not by `valid`) ranks each lane in its table's escape stream; the
//     scan is skipped when no lane of the block escapes.
//   * state as in the reference: words as uint32, d and r as three 32-bit
//     limbs in 64-bit registers, digit groups (gacc/racc) in 64 bits (racc
//     can be exactly 2^32).
// Every thread of the block must call block_rank, init_lane,
// decode_segment and block_nseg: they hold block-wide barriers. Threads
// past L take part with nsegs = 0.

#pragma once

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

inline Args make_args(const void* stream, long long wmax, const void* esc,
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

inline int threads_for(int L) { return ((L + 31) / 32) * 32; }

}  // namespace
