// The warp-synchronous dtANS decoder for Hopper (sm_90a), shared by the
// fused SpMV / SpMM kernels (dtans_spmv.cu) and the decode-only kernel
// (dtans_decode.cu).
//
// It is the CUDA form of the JAX package's kernels/common.py::init_state
// and segment_step. One thread decodes one lane (row) of a slice. The
// threads that decode one slice form its group, and a unit is what one
// warp (or, for wide slices, a few warps) decodes together:
//   * L <= 32 ("narrow"): the group is L rounded up to a power of two, G,
//     and one warp packs 32 / G slices. A claim's rank and total are
//     __popc of the warp's __ballot_sync masked to the group's bits; no
//     barrier at all.
//   * L > 32 ("wide"): the group is ceil(L / 32) warps, one warp per 32
//     lanes. The warps exchange their counts through shared memory behind
//     one named barrier (bar.sync id, n) over only the group's warps.
//     All three refill claims of a segment and its escape count travel in
//     one 64-bit word of 16-bit fields per warp, so a segment costs one
//     barrier (two when some lane escapes).
// The geometry (group size, warps per unit, units per block) is computed
// in Python (kernels/tiling.py::geometry) and passed in.
//
// The parameter set (core/params.py::DtansParams) is compiled in: the
// build (kernels/_build.py) passes it as -D defines, one library a set,
// and without them the header is PAPER's. Every size is a constant of the
// set, so each set's code is compiled for it alone (PAPER's registers and
// spills are those of a header that knew no other set).
//
// Per segment:
//   * the LS table lookups are issued before any of them is used; a slot is
//     the u64 symbol, then the meta word of digit | base << MB |
//     is_esc << (2 MB + 1): one u32 where those 2 MB + 2 bits fit (12
//     bytes a slot; PAPER), one u64 where not (16 bytes; MB = 16)
//     (kernels/pack.py::pack_tables). The tables are staged once per
//     block in shared memory where the set's plan puts them there
//     (TABLES_SMEM, kernels/tiling.py::tables_in_smem), else every lookup
//     reads them from global memory through the read-only path;
//   * escapes are ranked only when some lane of the unit escapes (one
//     __any_sync, or the exchanged total): the rank of position k, lane l
//     in table t's stream is esc_cur[t] + the group's escapes at positions
//     k' < k of table t + the escapes at position k of lanes before l, the
//     order of the reference's per-position scan;
//   * the refill's stream words are prefetched: a segment's only claims
//     are its refill at the end, so when segment j starts the refill's
//     cursor is known, and the window [cursor, cursor + O G) of the
//     slice's stream row goes to shared memory with cp.async; the refill
//     then reads the window, not a dependent global load;
//   * the state is three 32-bit limbs (d, r) multiplied with __umulhi.
//     Digits fold in groups of DG = max(1, 32 / MB) (the last group
//     shorter where DG does not divide LS), so a group's radix racc is at
//     most 2^32; it can be exactly 2^32 (PAPER: a table base of 256, 4
//     digits a group): that multiply is a shift by one limb. With a 32-bit
//     word, limb_ge_w and limb_shr are limb moves; with a narrower one
//     they shift across the limbs, as the reference's _limb_ge_w and
//     _limb_shr do. A stream word holds WB bits in a uint32.
// Every thread of a unit must call init_lane and decode_segment the same
// number of times: they hold warp votes (and, wide, the group's barrier).
// Threads past L, or in a group past the last slice, take part with
// nsegs = 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The parameter set, PAPER's (core/params.py::PAPER) unless the build
// defines another; DTANS_TABLES_SMEM is kernels/tiling.py::tables_in_smem.
#ifndef DTANS_W_BITS
#define DTANS_W_BITS 32
#define DTANS_K_BITS 12
#define DTANS_L 8
#define DTANS_O 3
#define DTANS_F 2
#define DTANS_M_BITS 8
#define DTANS_TABLES_SMEM 1
#endif
constexpr int WB = DTANS_W_BITS;  // log2(W): stream word bits
constexpr int KB = DTANS_K_BITS;  // log2(K): table slot bits
constexpr int LS = DTANS_L;       // symbols per segment
constexpr int O = DTANS_O;        // words per segment
constexpr int F = DTANS_F;        // conditional loads per segment
constexpr int MB = DTANS_M_BITS;  // log2(M): multiplicity cap bits
constexpr bool TABLES_SMEM = DTANS_TABLES_SMEM != 0;
constexpr int H = LS / 2;                       // nonzeros per segment
constexpr int DG = (32 / MB) > 0 ? (32 / MB) : 1;  // digits per fold group
constexpr long long KSLOTS = 1ll << KB;
constexpr uint32_t KM1 = (uint32_t)((1ull << KB) - 1ull);
constexpr uint32_t WM1 = (uint32_t)((1ull << WB) - 1ull);
constexpr unsigned FULL = 0xFFFFFFFFu;
// A slot: the u64 symbol and MW 32-bit words of digit | base << MB |
// is_esc << ESC_SHIFT (kernels/pack.py::pack_tables).
constexpr int MW = (2 * MB + 2 <= 32) ? 1 : 2;
constexpr int SLOT_BYTES = 8 + 4 * MW;
constexpr int ESC_SHIFT = 2 * MB + 1;
// A wide group's exchange: 16-bit fields in u64 words, the O claims and
// the escape count (CW words) or the LS positions' escape counts (EW).
constexpr int CW = (O + 1 + 3) / 4;
constexpr int EW = (LS + 3) / 4;
constexpr int XW = CW > EW ? CW : EW;
// (kernels/dtans_spmv.py::check_params refuses m_bits = 32 by name.)
static_assert(WB >= 1 && WB <= 32, "stream words hold at most 32 bits");
static_assert(KB >= 1 && KB <= 32 && MB >= 1 && MB <= KB && MB <= 31,
              "slots of at most 32 bits; digits and bases fit a u32");
static_assert(LS >= 2 && LS % 2 == 0, "segments of (delta, value) pairs");
static_assert(F >= 1 && F <= O, "0 < f <= o");

using Meta = typename std::conditional<MW == 1, uint32_t,
                                      unsigned long long>::type;

// N bits in (N + 63) / 64 words, for masks of more than 64 positions.
template <int N>
struct BitsN {
  unsigned long long w[(N + 63) / 64];
};
// A mask of N positions: a u32 up to 32, a u64 up to 64, else `BitsN`.
template <int N>
using Bits = typename std::conditional<
    (N > 64), BitsN<N>,
    typename std::conditional<(N > 32), unsigned long long,
                              unsigned>::type>::type;
using EscMask = Bits<LS>;  // bit k: position k escapes
using ValidMask = Bits<H>;  // bit i: entry i of the segment is one
// Bit k: the table of segment position k (an int up to 32 positions).
using Pattern = typename std::conditional<(LS > 32), Bits<LS>, int>::type;
// The pattern as the C entries take it: one long long up to 64
// positions, else a host array of its (LS + 63) / 64 words.
using PatternArg = typename std::conditional<(LS > 64), const long long*,
                                            long long>::type;

// Bit k of a mask (k a constant once unrolled).
template <typename M>
__device__ __forceinline__ int bit(const M& m, int k) {
  return (int)((m >> k) & 1);
}
template <int N>
__device__ __forceinline__ int bit(const BitsN<N>& m, int k) {
  return (int)((m.w[k >> 6] >> (k & 63)) & 1ull);
}
__device__ __forceinline__ void set_bit(unsigned& m, int k) { m |= 1u << k; }
__device__ __forceinline__ void set_bit(unsigned long long& m, int k) {
  m |= 1ull << k;
}
template <int N>
__device__ __forceinline__ void set_bit(BitsN<N>& m, int k) {
  m.w[k >> 6] |= 1ull << (k & 63);
}
__device__ __forceinline__ int popc_mask(unsigned m) { return __popc(m); }
__device__ __forceinline__ int popc_mask(unsigned long long m) {
  return __popcll(m);
}
template <int N>
__device__ __forceinline__ int popc_mask(const BitsN<N>& m) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < (N + 63) / 64; ++i) c += __popcll(m.w[i]);
  return c;
}

struct Args {
  const uint32_t* stream;            // (S, wmax)
  long long wmax;
  const unsigned long long* esc;     // (T, S, emax)
  long long emax;
  const int* ns;                     // (S, L)
  const int* nnz;                    // (S, L)
  const int* tables;                 // (T, (2 + MW) K): K u64 symbols, K metas
  int T;
  Pattern pattern_bits;              // bit k = table of segment position k
  int S;
  int L;
  int max_nseg;
};

// Launch geometry (kernels/tiling.py::geometry).
struct Geom {
  int group;     // threads per slice: pow2 <= 32, or uw * 32
  int uw;        // warps per unit
  int spu;       // slices per unit (32 / group when narrow, else 1)
  long long units;
  int upb;       // units decoded at once per block (SpMM: 1)
  int cw;        // SpMM contraction warps (0 otherwise)
};

// ---- shared-memory plan ---------------------------------------------------
// tables | per concurrent unit: window, exchange | (SpMM) ring, accumulator.
// kernels/tiling.py::smem_plan computes the same sizes.
__host__ __device__ inline long long align16(long long v) {
  return (v + 15) & ~15ll;
}
// Shared memory of the tables: none where they stay in global memory.
__host__ __device__ inline long long tables_bytes(int T) {
  return TABLES_SMEM ? align16((long long)T * KSLOTS * SLOT_BYTES) : 0ll;
}
__host__ __device__ inline long long window_bytes(int uw) {
  return align16(2ll * O * uw * 32 * 4);
}
__host__ __device__ inline long long exchange_bytes(int uw) {
  return align16(2ll * uw * XW * 8) + align16(2ll * uw * 4);
}
__host__ __device__ inline long long unit_bytes(int uw) {
  return window_bytes(uw) + exchange_bytes(uw);
}

struct UnitSmem {
  uint32_t* win;              // [2][O * uw * 32]
  unsigned long long* xa;     // [2][uw][XW]
  int* xm;                    // [2][uw]
};

__device__ __forceinline__ UnitSmem unit_smem(unsigned char* base, int uw) {
  UnitSmem u;
  u.win = reinterpret_cast<uint32_t*>(base);
  u.xa = reinterpret_cast<unsigned long long*>(base + window_bytes(uw));
  u.xm = reinterpret_cast<int*>(base + window_bytes(uw) +
                                align16(2ll * uw * XW * 8));
  return u;
}

// A table is KSLOTS u64 symbols, then KSLOTS metas: TSYM u64s or TMETA
// metas from one table's start to the next's; an int offset where two
// tables stay under 2^31 bytes (every set up to k_bits = 26).
using TabIdx = typename std::conditional<
    (2 * KSLOTS * SLOT_BYTES < (1ll << 31)), int, long long>::type;
constexpr TabIdx TSYM = (TabIdx)(KSLOTS * SLOT_BYTES / 8);
constexpr TabIdx TMETA = (TabIdx)(KSLOTS * SLOT_BYTES / (int)sizeof(Meta));

struct Tables {
  const unsigned long long* sym;  // table t at sym + t * TSYM
  const Meta* meta;               // table t at meta + t * TMETA
};

// Where the set's plan stages them (TABLES_SMEM), copies the packed tables
// verbatim into the front of shared memory, then syncs the block; else
// points at them in global memory. Every thread of the block must call it.
__device__ __forceinline__ Tables stage_tables(const Args& a,
                                               unsigned char* smem) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(a.tables);
  if constexpr (TABLES_SMEM) {
    if constexpr (KSLOTS * SLOT_BYTES % 16 == 0) {
      const int4* src = reinterpret_cast<const int4*>(a.tables);
      int4* dst = reinterpret_cast<int4*>(smem);
      const int n16 = (int)(a.T * KSLOTS * SLOT_BYTES / 16);
      for (int i = threadIdx.x; i < n16; i += blockDim.x)
        dst[i] = __ldg(src + i);
    } else {
      int* dst = reinterpret_cast<int*>(smem);
      const int n4 = (int)(a.T * KSLOTS * SLOT_BYTES / 4);
      for (int i = threadIdx.x; i < n4; i += blockDim.x)
        dst[i] = __ldg(a.tables + i);
    }
    __syncthreads();
    base = smem;
  }
  Tables tb;
  tb.sym = reinterpret_cast<const unsigned long long*>(base);
  tb.meta = reinterpret_cast<const Meta*>(base + KSLOTS * 8);
  return tb;
}

// Slot `slot` of table t: from shared memory, or from global memory
// through the read-only path.
__device__ __forceinline__ unsigned long long table_sym(const Tables& tb,
                                                        int t,
                                                        uint32_t slot) {
  if constexpr (TABLES_SMEM) {
    return tb.sym[t * TSYM + slot];
  } else {
    return __ldg(tb.sym + t * TSYM + slot);
  }
}
__device__ __forceinline__ Meta table_meta(const Tables& tb, int t,
                                           uint32_t slot) {
  if constexpr (TABLES_SMEM) {
    return tb.meta[t * TMETA + slot];
  } else {
    return __ldg(tb.meta + t * TMETA + slot);
  }
}

// ---- barriers and async copies -------------------------------------------
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31u)) - 1u;
}

// ---- the group ------------------------------------------------------------
struct Group {
  long long s;     // slice this thread decodes (>= S: none)
  const uint32_t* row;  // its stream row (slice 0's when s >= S)
  int lane;        // lane within the slice
  bool in;         // lane < L and s < S
  int gthreads;    // threads of the group
  int gbase;       // warp lane of the group's lane 0 (0 when wide)
  unsigned gmask;  // the group's bits in the warp
  bool wide;
  int uw;          // warps of the group (wide)
  int wi;          // this warp's index in the group
  int bar;         // named barrier id (wide)
  uint32_t* win;   // window, parity 0; parity 1 at + O * gthreads
  unsigned long long* xa;
  int* xm;
  int xc;          // exchanges so far (slot = xc & 1)
  int r;           // thread index within the unit: wi * 32 + warp lane
};

// The group of unit u for a thread in warp `wi` of the unit.
__device__ __forceinline__ Group make_group(const Args& a, const Geom& gm,
                                            const UnitSmem& us, long long u,
                                            int wi, int bar) {
  Group g;
  const int wl = threadIdx.x & 31;
  g.wide = gm.uw > 1;
  g.uw = gm.uw;
  g.wi = wi;
  g.bar = bar;
  g.xa = us.xa;
  g.xm = us.xm;
  g.xc = 0;
  g.r = wi * 32 + wl;
  if (gm.uw == 1) {
    const int G = gm.group;
    const int gi = wl / G;
    g.gthreads = G;
    g.gbase = gi * G;
    g.gmask = (G == 32) ? FULL : (((1u << G) - 1u) << g.gbase);
    g.lane = wl - g.gbase;
    g.s = u * gm.spu + gi;
    g.win = us.win + gi * 2 * O * G;
  } else {
    g.gthreads = gm.uw * 32;
    g.gbase = 0;
    g.gmask = FULL;
    g.lane = g.r;
    g.s = u;
    g.win = us.win;
  }
  g.in = g.lane < a.L && g.s < a.S;
  g.row = a.stream + (g.s < a.S ? g.s : 0) * a.wmax;
  return g;
}

// Sums `nw` packed words of 16-bit fields over the group's warps (one
// word per warp, written by its lane 0): `pre` over the warps before this
// one, `tot` over all; `mx` gets the largest `mine_max`. Wide groups only.
template <int NW>
__device__ __forceinline__ void exchange(Group& g,
                                         const unsigned long long* mine,
                                         unsigned long long* pre,
                                         unsigned long long* tot,
                                         int mine_max, int* mx) {
  unsigned long long* slot = g.xa + (g.xc & 1) * g.uw * XW;
  int* mslot = g.xm + (g.xc & 1) * g.uw;
  ++g.xc;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) slot[g.wi * XW + w] = mine[w];
    mslot[g.wi] = mine_max;
  }
  bar_sync(g.bar, g.uw * 32);
  int m = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) pre[w] = tot[w] = 0ull;
  for (int k = 0; k < g.uw; ++k) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned long long v = slot[k * XW + w];
      tot[w] += v;
      if (k < g.wi) pre[w] += v;
    }
    m = max(m, mslot[k]);
  }
  *mx = m;
}

__device__ __forceinline__ int field(unsigned long long v, int k) {
  return (int)((v >> (16 * k)) & 0xFFFFull);
}
// Field k of a run of words (4 fields a word).
__device__ __forceinline__ int fields(const unsigned long long* v, int k) {
  return field(v[k >> 2], k & 3);
}

struct Claims {
  int off[O];   // this lane's word offset from the cursor, per claim
  int total;    // words the group claims in all
};

// O claims in k order (`take`), plus the unit-uniform escape flag and the
// largest segment count. Includes the group's synchronisation, so shared
// memory written before it (the window) is visible after it.
__device__ __forceinline__ Claims claim(Group& g, const bool take[O],
                                        int esc_count, int nsegs,
                                        bool* esc_any, int* nseg_max) {
  Claims c;
  const unsigned lt = lanemask_lt();
  unsigned b[O];
#pragma unroll
  for (int k = 0; k < O; ++k) b[k] = __ballot_sync(FULL, take[k]);
  if (!g.wide) {
    __syncwarp(FULL);
    int acc = 0;
#pragma unroll
    for (int k = 0; k < O; ++k) {
      const unsigned m = b[k] & g.gmask;
      c.off[k] = acc + __popc(m & lt);
      acc += __popc(m);
    }
    c.total = acc;
    *esc_any = __any_sync(FULL, esc_count > 0);
    *nseg_max = __reduce_max_sync(FULL, (unsigned)nsegs);
    return c;
  }
  // fields 0 .. O - 1: the claims; field O: the escape count
  unsigned long long mine[CW];
#pragma unroll
  for (int w = 0; w < CW; ++w) mine[w] = 0ull;
#pragma unroll
  for (int k = 0; k < O; ++k)
    mine[k >> 2] |= (unsigned long long)__popc(b[k]) << (16 * (k & 3));
  mine[O >> 2] |=
      (unsigned long long)__reduce_add_sync(FULL, (unsigned)esc_count)
      << (16 * (O & 3));
  unsigned long long pre[CW], tot[CW];
  exchange<CW>(g, mine, pre, tot,
               (int)__reduce_max_sync(FULL, (unsigned)nsegs), nseg_max);
  int acc = 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    c.off[k] = acc + fields(pre, k) + __popc(b[k] & lt);
    acc += fields(tot, k);
  }
  c.total = acc;
  *esc_any = fields(tot, O) > 0;
  return c;
}

// ---- limbs -----------------------------------------------------------------
// d = d * m + a (mod 2^96) in three 32-bit limbs; m <= 2^32, a < 2^32.
__device__ __forceinline__ void limb_mul_add(uint32_t d[3],
                                             unsigned long long m,
                                             uint32_t a) {
  if (m >> 32) {  // m == 2^32: a shift by one limb
    d[2] = d[1];
    d[1] = d[0];
    d[0] = a;
    return;
  }
  const uint32_t mm = (uint32_t)m;
  uint32_t lo0 = d[0] * mm;
  uint32_t hi0 = __umulhi(d[0], mm);
  lo0 += a;
  hi0 += (lo0 < a) ? 1u : 0u;
  uint32_t lo1 = d[1] * mm;
  uint32_t hi1 = __umulhi(d[1], mm);
  lo1 += hi0;
  hi1 += (lo1 < hi0) ? 1u : 0u;
  d[2] = d[2] * mm + hi1;
  d[1] = lo1;
  d[0] = lo0;
}

// r >= W (kernels/common.py::_limb_ge_w).
__device__ __forceinline__ bool limb_ge_w(const uint32_t r[3]) {
  if constexpr (WB == 32) {
    return (r[1] | r[2]) != 0u;
  } else {
    return (r[1] | r[2] | (r[0] >> (WB % 32))) != 0u;
  }
}

// d >>= WB (kernels/common.py::_limb_shr).
__device__ __forceinline__ void limb_shr(uint32_t d[3]) {
  if constexpr (WB == 32) {
    d[0] = d[1];
    d[1] = d[2];
    d[2] = 0u;
  } else {
    // (WB % 32: this branch has WB < 32; the other keeps the shift legal)
    constexpr int SH = WB % 32, UP = (32 - WB) % 32;
    d[0] = (d[0] >> SH) | (d[1] << UP);
    d[1] = (d[1] >> SH) | (d[2] << UP);
    d[2] = d[2] >> SH;
  }
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// ---- lane state and segments ---------------------------------------------
struct Lane {
  uint32_t w[O];
  uint32_t d[3];
  uint32_t r[3];
  int col;               // running column (columns < 2^31)
  int cursor;            // group-uniform stream cursor
  int esc0, esc1;        // group-uniform escape cursors, tables 0 / 1
  int nsegs;
  int nnz;
};

struct Seg {
  int col[H];
  unsigned long long vb[H];
  ValidMask valid;  // bit i: position i holds an entry
};

// init_state (kernels/common.py): O claims in k order by every live lane.
// Returns the unit's segment count (the loop bound of every thread).
__device__ __forceinline__ int init_lane(const Args& a, Group& g, Lane& st) {
  const long long at = g.s * a.L + g.lane;
  const int ns = g.in ? a.ns[at] : 0;
  st.nnz = g.in ? a.nnz[at] : 0;
  st.nsegs = (ns + LS - 1) / LS;
  const bool live = ns > 0;
  bool take[O];
#pragma unroll
  for (int k = 0; k < O; ++k) take[k] = live;
  bool esc_any;
  int nseg;
  const Claims c = claim(g, take, 0, st.nsegs, &esc_any, &nseg);
#pragma unroll
  for (int k = 0; k < O; ++k)
    st.w[k] = live ? __ldg(g.row + clampi(c.off[k], (int)a.wmax - 1)) : 0u;
  st.cursor = c.total;
  st.esc0 = st.esc1 = 0;
  st.d[0] = st.d[1] = st.d[2] = 0u;
  st.r[0] = 1u;
  st.r[1] = st.r[2] = 0u;
  st.col = 0;
  return nseg < a.max_nseg ? nseg : a.max_nseg;
}

// segment_step (kernels/common.py) for one lane: decodes segment j into
// `out` and advances the state.
__device__ __forceinline__ void decode_segment(const Args& a,
                                               const Tables& tb, Group& g,
                                               Lane& st, int j, Seg& out) {
  const bool active = j < st.nsegs;  // nsegs == 0 outside the matrix

  // ---- this segment's refill window, prefetched -----------------------
  uint32_t* win = g.win + (j & 1) * O * g.gthreads;
  if (g.s < a.S) {
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const int e = g.lane + i * g.gthreads;
      cp_async4(win + e, g.row + clampi(st.cursor + e, (int)a.wmax - 1));
    }
  }

  // ---- unpack + all LS table lookups -----------------------------------
  unsigned long long syms[LS];
  Meta meta[LS];
#pragma unroll
  for (int k = 0; k < LS; ++k) {
    const int lo = k * KB;
    const int wi = lo / WB, sh = lo % WB;
    // little-endian word view: word wi is w[O - 1 - wi]
    unsigned long long pair = st.w[O - 1 - wi];
    if (wi + 1 < O) pair |= (unsigned long long)st.w[O - 2 - wi] << WB;
    const uint32_t slot = (uint32_t)(pair >> sh) & KM1;
    const int t = bit(a.pattern_bits, k);
    syms[k] = table_sym(tb, t, slot);
    meta[k] = table_meta(tb, t, slot);
  }
  EscMask escm{};
  uint32_t digs[LS], bass[LS];
#pragma unroll
  for (int k = 0; k < LS; ++k) {
    if (active && ((meta[k] >> ESC_SHIFT) & 1u)) set_bit(escm, k);
    digs[k] = active ? (uint32_t)(meta[k] & ((1u << MB) - 1u)) : 0u;
    bass[k] = active ? (uint32_t)((meta[k] >> MB) & ((2u << MB) - 1u)) : 1u;
  }

  // ---- fold digits into the limb state (groups fit 32 bits) ------------
  // gacc < racc <= 2^32 fits 32 bits; racc's last factor is widened. The
  // last group is shorter where DG does not divide LS.
#pragma unroll
  for (int g0 = 0; g0 < LS; g0 += DG) {
    const int ge = g0 + DG < LS ? g0 + DG : LS;  // constant once unrolled
    uint32_t gacc = 0u, r3 = 1u;
#pragma unroll
    for (int k = g0; k < ge; ++k) gacc = gacc * bass[k] + digs[k];
#pragma unroll
    for (int k = g0; k < ge - 1; ++k) r3 *= bass[k];
    const unsigned long long racc = (unsigned long long)r3 * bass[ge - 1];
    limb_mul_add(st.d, racc, gacc);
    limb_mul_add(st.r, racc, 0u);
  }

  // ---- refill: local conditions first, then one round of claims --------
  const bool refill = active && (j < st.nsegs - 1);
  bool take[O];
  uint32_t wk[O];
#pragma unroll
  for (int k = 0; k < O; ++k) {
    wk[k] = 0u;
    take[k] = refill;
    if (k < F) {
      const bool cond = limb_ge_w(st.r) && refill;
      wk[k] = st.d[0] & WM1;
      if (cond) {
        limb_shr(st.d);
        limb_shr(st.r);
      }
      take[k] = refill && !cond;
    }
  }
  cp_async_wait_all();
  bool esc_any;
  int unused;
  const Claims c = claim(g, take, popc_mask(escm), 0, &esc_any, &unused);
#pragma unroll
  for (int k = 0; k < O; ++k) {
    if (take[k]) wk[k] = win[c.off[k]];
    if (refill) st.w[k] = wk[k];
  }
  st.cursor += c.total;

  // ---- escapes (rare): rank, then fetch ---------------------------------
  if (esc_any) {
    const unsigned lt = lanemask_lt();
    int cnt[LS], pre[LS];
    unsigned bk[LS];
#pragma unroll
    for (int k = 0; k < LS; ++k)
      bk[k] = __ballot_sync(FULL, (unsigned)bit(escm, k));
    if (!g.wide) {
#pragma unroll
      for (int k = 0; k < LS; ++k) {
        const unsigned m = bk[k] & g.gmask;
        cnt[k] = __popc(m);
        pre[k] = __popc(m & lt);
      }
    } else {
      unsigned long long mine[EW], wpre[EW], wtot[EW];
#pragma unroll
      for (int w = 0; w < EW; ++w) mine[w] = 0ull;
#pragma unroll
      for (int k = 0; k < LS; ++k)
        mine[k >> 2] |= (unsigned long long)__popc(bk[k]) << (16 * (k & 3));
      int unused2;
      exchange<EW>(g, mine, wpre, wtot, 0, &unused2);
#pragma unroll
      for (int k = 0; k < LS; ++k) {
        cnt[k] = fields(wtot, k);
        pre[k] = fields(wpre, k) + __popc(bk[k] & lt);
      }
    }
    const long long sl = g.s < a.S ? g.s : 0;
    const int emax1 = (int)a.emax - 1;
#pragma unroll
    for (int k = 0; k < LS; ++k) {
      const int t = bit(a.pattern_bits, k);
      const int cur = t ? st.esc1 : st.esc0;
      if (bit(escm, k)) {
        const int e = clampi(cur + pre[k], emax1);
        syms[k] = __ldg(a.esc + ((long long)t * a.S + sl) * a.emax + e);
      }
      if (t) {
        st.esc1 += cnt[k];
      } else {
        st.esc0 += cnt[k];
      }
    }
  }

  // ---- positions: even = delta, odd = value bits -------------------------
  out.valid = ValidMask{};
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int q = j * H + i;
    const bool ok = active && (q < st.nnz);
    if (ok) {
      st.col = (int)((uint32_t)st.col + (uint32_t)syms[2 * i]);
      set_bit(out.valid, i);
    }
    out.col[i] = st.col;
    out.vb[i] = syms[2 * i + 1];
  }
}

// The columns a segment's entries gather x at, clamped to [0, n - 1]: the
// lane's own, or (SHARED) the group's lane 0's, as the reference gathers
// at cols[:, 0]. In a wide group the shuffle reaches the warp's lane 0,
// which decodes lane 0's columns whenever any lane of its warp holds an
// entry (in-bounds lanes of a block-filled pack form a prefix). Every
// thread of the warp must call it.
template <bool SHARED>
__device__ __forceinline__ void gather_cols(const Group& g, const Seg& sg,
                                            int n, int cols[H]) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int c = SHARED ? __shfl_sync(FULL, sg.col[i], g.gbase) : sg.col[i];
    cols[i] = clampi(c, n - 1);
  }
}

template <typename V> struct Num;
template <> struct Num<float> {
  __device__ static float value(unsigned long long bits) {
    return __uint_as_float((unsigned)(bits & 0xFFFFFFFFull));
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

// Args::pattern_bits from the C entries' argument (`PatternArg`).
inline void set_pattern(int& p, long long v) { p = (int)v; }
inline void set_pattern(unsigned long long& p, long long v) {
  p = (unsigned long long)v;
}
template <int N>
inline void set_pattern(BitsN<N>& p, const long long* v) {
  for (int i = 0; i < (N + 63) / 64; ++i) p.w[i] = (unsigned long long)v[i];
}

inline Args make_args(const void* stream, long long wmax, const void* esc,
                      long long emax, const void* ns, const void* nnz,
                      const void* tables, int T, PatternArg pattern_bits,
                      int S, int L, int max_nseg) {
  Args a;
  a.stream = static_cast<const uint32_t*>(stream);
  a.wmax = wmax;
  a.esc = static_cast<const unsigned long long*>(esc);
  a.emax = emax;
  a.ns = static_cast<const int*>(ns);
  a.nnz = static_cast<const int*>(nnz);
  a.tables = static_cast<const int*>(tables);
  a.T = T;
  set_pattern(a.pattern_bits, pattern_bits);
  a.S = S;
  a.L = L;
  a.max_nseg = max_nseg;
  return a;
}

inline Geom make_geom(int group, int uw, int spu, long long units, int upb,
                      int cw) {
  Geom g;
  g.group = group;
  g.uw = uw;
  g.spu = spu;
  g.units = units;
  g.upb = upb;
  g.cw = cw;
  return g;
}

// Opts the kernel in to `smem` bytes of dynamic shared memory (above 48 KB
// it must be asked for); returns the error, if any.
template <typename Fn>
cudaError_t opt_in(Fn fn, long long smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
