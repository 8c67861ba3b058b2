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
// for every j < max_nseg of the matrix; the segments past the unit's own
// last one are written as padding too, so the output needs no fill.
//
// What bounds it. It reads the compressed matrix once and writes
// S * L * max_nseg * H * (4 + itemsize) bytes: for the SmolLM-135M head
// (384 slices of 128 lanes, max_nseg 40) that is 62.9 MB written against
// 10.4 MB read, about 0.022 ms at 3.35 TB/s. The decode's serial latency
// chain (table lookups, limb arithmetic and claims per segment) costs
// what it costs in the fused SpMV kernel; the stores must not add to it
// (PERF.md has both times on an H100).
//
// Design: the warp-synchronous decoder of dtans_decode.cuh in the SpMV
// kernel's geometry (persistent blocks, tables staged once per block,
// narrow slices packed several to a warp), one thread per lane, the
// reference's row-major (S, L, max_nseg * H) output. Neighbouring lanes
// are max_nseg * H entries apart in it, so a thread storing its own
// segment would put 16 bytes into each of 32 sectors per warp store.
// Instead each warp stages STAGE segments of its 32 rows in its own tile
// of shared memory (a thread writes its segment's columns as one 16-byte
// vector and its values as one (f32) or two (f64)), and every STAGE
// segments, and at the unit's last one, writes the tile out: lanes take
// consecutive 16-byte pieces of consecutive rows, so one store instruction
// writes whole 32-byte sectors of 16 (columns, f32 values) or 8 (f64
// values) rows. The segments from the unit's count to max_nseg are written
// the same way from registers. Row starts are multiples of max_nseg * 16
// bytes, so every piece is 16-byte aligned. The tile's rows are swizzled (piece p of row r at p ^ swz(r)),
// so that neither the per-thread writes nor the row-piece reads of a
// quarter-warp hit one bank twice, without padding. The tile belongs to its
// warp and flushes fall at unit-uniform segment counts: a __syncwarp
// orders them, no block barrier. Rows past L and slices past S write
// nothing. The stores are streaming (st.global.cs): the kernel never reads
// its output, which exceeds the 50 MB L2. The variants this design was
// chosen over (scalar stores, 16-byte vectors a thread, bulk copies,
// tiles of 4 and 8 segments, plain stores) are timed by
// experiments/decode_geometry/ (PERF.md).
//
// That is PAPER's layout, four entries (16 bytes of columns) a segment. A
// parameter set whose segments hold H != 4 entries stages entries, not
// segments: the same tile of TILE_ENTRIES = 8 entries a row (32 bytes of
// columns), each segment's entries appended as they come and the tile
// written out whenever it fills and at the unit's last segment, lanes
// taking consecutive entries of consecutive rows (scalar streaming
// stores: a row's run of entries need not start on 16 bytes). Its rows
// are swizzled by entry, as PAPER's are by piece.
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after its launch.

#include "dtans_decode.cuh"

namespace {

// Segments a warp stages before it writes them out: the least that
// writes whole sectors of a row's columns (kernels/tiling.py::
// DECODE_STAGE). Other sets stage TILE_ENTRIES entries a row.
constexpr int STAGE = 2;
constexpr int TILE_ENTRIES = STAGE * 4;

// A warp's staging tile: 32 rows x TILE_ENTRIES entries of columns (16
// bytes a PAPER segment) and of values (16 or 32 bytes a PAPER segment).
__host__ __device__ inline long long stage_bytes(int itemsize) {
  return 32ll * TILE_ENTRIES * (4 + itemsize);
}

__host__ __device__ inline long long decode_smem_need(int T, int uw, int upb,
                                                      int itemsize) {
  return tables_bytes(T) + (long long)upb * unit_bytes(uw) +
         (long long)upb * uw * stage_bytes(itemsize);
}

// The 16-byte slot of piece p of row r in a tile of N pieces a row (N a
// power of two up to 8). A quarter-warp's eight 16-byte accesses, one
// piece of eight consecutive rows or eight consecutive pieces, land in
// eight distinct slots modulo 8 (the 32 banks): rows r and r + 8 / N share
// a bank group unswizzled, and the XOR sends their piece to another slot.
template <int N>
__device__ __forceinline__ int slot(int r, int p) {
  static_assert(N >= 1 && N <= 8 && (N & (N - 1)) == 0, "pieces a row");
  return r * N + (p ^ (((r * N) >> 3) & (N - 1)));
}

// Writes pieces [0, kc) of the tile's 32 rows (N pieces a row) to `out`,
// rows `pitch` pieces apart from piece `first` on; `row` is the warp lane's
// output row, -1 for none. Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void flush(const int4* tile, int4* out,
                                      long long pitch, long long first,
                                      int kc, int row) {
  const int wl = threadIdx.x & 31;
  for (int c = wl; c < 32 * kc; c += 32) {
    const int r = kc == N ? c / N : c / kc;
    const int p = c - r * kc;
    const int g = __shfl_sync(FULL, row, r);
    if (g >= 0) __stcs(out + g * pitch + first + p, tile[slot<N>(r, p)]);
  }
}

// Writes `v` to pieces [first, first + kc) of every row (as `flush`).
__device__ __forceinline__ void fill(int4* out, long long pitch,
                                     long long first, int kc, int row,
                                     int4 v) {
  const int wl = threadIdx.x & 31;
  for (int c = wl; c < 32 * kc; c += 32) {
    const int r = c / kc;
    const int g = __shfl_sync(FULL, row, r);
    if (g >= 0) __stcs(out + g * pitch + first + (c - r * kc), v);
  }
}

// The slot of entry e of row r in an entry tile (sets with H != 4): row
// r's entries XOR (r / 4) % 8, so that a warp writing one entry of each of
// its 32 rows hits 32 banks (4-byte entries).
__device__ __forceinline__ int eslot(int r, int e) {
  return r * TILE_ENTRIES + (e ^ ((r >> 2) & (TILE_ENTRIES - 1)));
}

// Writes entries [0, kc) of the entry tile's 32 rows to `out`, rows `pitch`
// entries apart from entry `first` on (as `flush`).
template <typename B>
__device__ __forceinline__ void flush_entries(const B* tile, B* out,
                                              long long pitch,
                                              long long first, int kc,
                                              int row) {
  const int wl = threadIdx.x & 31;
  for (int c = wl; c < 32 * kc; c += 32) {
    const int r = c / kc;
    const int e = c - r * kc;
    const int g = __shfl_sync(FULL, row, r);
    if (g >= 0) __stcs(out + g * pitch + first + e, tile[eslot(r, e)]);
  }
}

// Writes `v` to entries [first, first + kc) of every row (as `fill`).
template <typename B>
__device__ __forceinline__ void fill_entries(B* out, long long pitch,
                                             long long first, int kc,
                                             int row, B v) {
  const int wl = threadIdx.x & 31;
  for (int c = wl; c < 32 * kc; c += 32) {
    const int r = c / kc;
    const int g = __shfl_sync(FULL, row, r);
    if (g >= 0) __stcs(out + g * pitch + first + (c - r * kc), v);
  }
}

// The output row of the thread's lane in unit u (the row index into
// (S * L, max_nseg * H)), -1 past L or S.
__device__ __forceinline__ int out_row(const Args& a, const Group& g) {
  return g.in ? (int)(g.s * a.L + g.lane) : -1;
}

// The decode of a set whose segments hold H != 4 entries, through the
// entry tile (`tile` at the warp's staging tile).
template <typename V>
__device__ __forceinline__ void decode_entries(const Args& a, const Geom& gm,
                                               const Tables& tb,
                                               const UnitSmem& us, long long u,
                                               int wi, int bar,
                                               unsigned char* tile,
                                               int* cols_out, void* vals_out) {
  using B = typename std::conditional<sizeof(V) == 4, unsigned,
                                      unsigned long long>::type;
  const int wl = threadIdx.x & 31;
  int* tcol = reinterpret_cast<int*>(tile);
  B* tval = reinterpret_cast<B*>(tcol + 32 * TILE_ENTRIES);
  B* vout = static_cast<B*>(vals_out);
  const long long pitch = (long long)a.max_nseg * H;  // entries a row
  Group g = make_group(a, gm, us, u, wi, bar);
  Lane st;
  const int nseg = init_lane(a, g, st);
  const int row = out_row(a, g);
  int fill = 0;          // entries in the tile (unit-uniform)
  long long first = 0;   // the tile's first entry in a row
  for (int j = 0; j < nseg; ++j) {
    Seg sg;
    decode_segment(a, tb, g, st, j, sg);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const bool ok = bit(sg.valid, i);
      tcol[eslot(wl, fill)] = ok ? sg.col[i] : -1;
      tval[eslot(wl, fill)] = ok ? (B)sg.vb[i] : (B)0;
      if (++fill == TILE_ENTRIES) {
        __syncwarp(FULL);
        flush_entries(tcol, cols_out, pitch, first, fill, row);
        flush_entries(tval, vout, pitch, first, fill, row);
        __syncwarp(FULL);
        first += fill;
        fill = 0;
      }
    }
  }
  if (fill > 0) {
    __syncwarp(FULL);
    flush_entries(tcol, cols_out, pitch, first, fill, row);
    flush_entries(tval, vout, pitch, first, fill, row);
    __syncwarp(FULL);
  }
  if (nseg < a.max_nseg) {
    const long long e0 = (long long)nseg * H;
    fill_entries(cols_out, pitch, e0, (int)(pitch - e0), row, -1);
    fill_entries(vout, pitch, e0, (int)(pitch - e0), row, (B)0);
  }
}

template <typename V, int MAXT>
__global__ void __launch_bounds__(MAXT)
dtans_decode_kernel(Args a, Geom gm, int4* __restrict__ cols_out,
                    int4* __restrict__ vals_out) {
  constexpr int NV = sizeof(V) / 4;  // 16-byte pieces of a segment's values
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = stage_tables(a, smem);
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const int gi = warp / gm.uw;
  unsigned char* units = smem + tables_bytes(a.T);
  const UnitSmem us = unit_smem(units + gi * unit_bytes(gm.uw), gm.uw);
  int4* tcol = reinterpret_cast<int4*>(
      units + gm.upb * unit_bytes(gm.uw) +
      warp * stage_bytes((int)sizeof(V)));
  int4* tval = tcol + 32 * STAGE;
  const long long cpitch = a.max_nseg;       // 16-byte pieces a row
  const long long vpitch = (long long)a.max_nseg * NV;
  for (long long u = (long long)blockIdx.x * gm.upb + gi; u < gm.units;
       u += (long long)gridDim.x * gm.upb) {
    if constexpr (H != 4) {
      decode_entries<V>(a, gm, tb, us, u, warp - gi * gm.uw, 1 + gi,
                        reinterpret_cast<unsigned char*>(tcol),
                        reinterpret_cast<int*>(cols_out), vals_out);
    } else {
      Group g = make_group(a, gm, us, u, warp - gi * gm.uw, 1 + gi);
      Lane st;
      const int nseg = init_lane(a, g, st);
      const int row = out_row(a, g);
      for (int j = 0; j < nseg; ++j) {
        Seg sg;
        decode_segment(a, tb, g, st, j, sg);
        const int p = j & (STAGE - 1);
        int4 c;
        c.x = bit(sg.valid, 0) ? sg.col[0] : -1;
        c.y = bit(sg.valid, 1) ? sg.col[1] : -1;
        c.z = bit(sg.valid, 2) ? sg.col[2] : -1;
        c.w = bit(sg.valid, 3) ? sg.col[3] : -1;
        tcol[slot<STAGE>(wl, p)] = c;
        unsigned long long vb[H];  // value bits, 0 (+0) where invalid
#pragma unroll
        for (int i = 0; i < H; ++i)
          vb[i] = bit(sg.valid, i) ? sg.vb[i] : 0ull;
        if constexpr (NV == 1) {
          tval[slot<STAGE>(wl, p)] =
              make_int4((int)(unsigned)vb[0], (int)(unsigned)vb[1],
                        (int)(unsigned)vb[2], (int)(unsigned)vb[3]);
        } else {
#pragma unroll
          for (int h = 0; h < NV; ++h)
            tval[slot<STAGE * NV>(wl, p * NV + h)] = make_int4(
                (int)(unsigned)vb[2 * h], (int)(unsigned)(vb[2 * h] >> 32),
                (int)(unsigned)vb[2 * h + 1],
                (int)(unsigned)(vb[2 * h + 1] >> 32));
        }
        if (p == STAGE - 1 || j == nseg - 1) {
          __syncwarp(FULL);
          const int j0 = j - p;
          flush<STAGE>(tcol, cols_out, cpitch, j0, p + 1, row);
          flush<STAGE * NV>(tval, vals_out, vpitch, (long long)j0 * NV,
                            (p + 1) * NV, row);
          __syncwarp(FULL);
        }
      }
      if (nseg < a.max_nseg) {
        fill(cols_out, cpitch, nseg, a.max_nseg - nseg, row,
             make_int4(-1, -1, -1, -1));
        fill(vals_out, vpitch, (long long)nseg * NV,
             (a.max_nseg - nseg) * NV, row, make_int4(0, 0, 0, 0));
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
      a, gm, static_cast<int4*>(cols), static_cast<int4*>(vals));
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

// The shared memory a decode block needs: tables, `upb` units' windows and
// exchange, and a staging tile per warp (kernels/tiling.py::smem_plan with
// stage=DECODE_STAGE).
long long dtans_decode_smem_need(int T, int uw, int upb, int itemsize) {
  return decode_smem_need(T, uw, upb, itemsize);
}

// cols (S, L, max_nseg * H) int32 and vals (S, L, max_nseg * H) = the
// decoded matrix, -1 / +0 at padding. f64 != 0 selects double values; the
// geometry is kernels/tiling.py::decode_geometry's. Refuses a geometry or
// plan short of its own count.
int dtans_decode_launch(int f64, const void* stream, long long wmax,
                        const void* esc, long long emax, const void* ns,
                        const void* nnz, const void* tables, int T,
                        PatternArg pattern_bits, int S, int L, int max_nseg,
                        int group, int uw, int spu, long long units, int upb,
                        int cw, int blocks, int threads, long long smem,
                        void* cols, void* vals, void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tables, T,
                           pattern_bits, S, L, max_nseg);
  const Geom gm = make_geom(group, uw, spu, units, upb, cw);
  if (threads != upb * uw * 32 ||
      smem < decode_smem_need(T, uw, upb, f64 ? 8 : 4) ||
      (long long)S * L > 0x7FFFFFFFll)
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
