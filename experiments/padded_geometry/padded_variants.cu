// Variants of the SELL / RGCSR SpMM that the port does not ship, for
// time_padded_geometry.py: rows a batch (x loads in flight per column)
// 2, 4 or 8, and each row's column and value handed to the lanes of its
// row group by two __shfl_sync (ShflRows) instead of the port's per-warp
// buffer in shared memory (padded::SmemRows). `kernel` is the port's
// src/repro_torch/kernels/csrc/padded_rows.cuh::spmm_warp_kernel with
// those two as template parameters (the port fixes them at ROWS_UNROLL
// and SmemRows); the row policies, x readers and geometry check are the
// port's own. Only f32 with the slab's x staged in shared memory (the
// port's geometry on the SmolLM-135M head) is instantiated.
//
// C entries: sell_spmm_variant_launch / rgcsr_spmm_variant_launch take
// rows a batch and shfl (1: ShflRows) before the port's sell_spmm_launch
// / rgcsr_spmm_launch arguments, without the value-type flag.
//
// Built by the script with the port's nvcc flags and
// -I src/repro_torch/kernels/csrc; not part of the port's build.

#include "rgcsr_spmv.cu"
#include "sell_spmv.cu"

namespace variants {

using namespace padded;

template <typename V> struct ShflRows {
  static constexpr size_t BYTES = 0;
  int c;
  V v;
  __device__ explicit ShflRows(size_t) {}
  __device__ void put(int ci, V vi) {
    c = ci;
    v = vi;
  }
  __device__ void get(int src, int* ck, V* vk) const {
    *ck = __shfl_sync(FULL, c, src);
    *vk = __shfl_sync(FULL, v, src);
  }
};

template <typename V, typename Row, int BW, int NC, int RB_, typename X,
          typename Rows>
__global__ void __launch_bounds__(WARP_MAX_THREADS)
kernel(typename Row::Args ra, const V* __restrict__ val, long long R, int wg,
       const V* __restrict__ x, long long n, long long B, int bt,
       long long chunks, long long per_tile, V* __restrict__ y) {
  constexpr int SW = BW * NC;               // columns of a slab
  constexpr int RB = RB_ < BW ? RB_ : BW;   // rows a batch
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long bps = (chunks + warps - 1) / warps;
  const long long slab = blockIdx.x / bps;
  const long long chunk = (blockIdx.x % bps) * warps + (threadIdx.x >> 5);
  const long long tile = slab / per_tile;
  const long long c0 = tile * bt + (slab % per_tile) * SW;
  const long long tend = (tile + 1) * bt < B ? (tile + 1) * bt : B;
  const int sw = (int)(tend - c0 < SW ? tend - c0 : SW);
  const int g = BW == CHUNK ? 0 : lane / BW;
  const int bl = BW == CHUNK ? lane : lane % BW;
  const X xs(x, n, B, c0, sw, bl);  // (StagedX synchronises the block)
  if (chunk >= chunks || sw <= 0) return;
  Rows rows(X::bytes(n));

  const long long r = chunk * CHUNK + lane;  // the row whose words we load
  const bool real = r < R;
  Row row(ra, real ? r : R - 1);
  const int stop = (int)__reduce_max_sync(
      FULL, real ? (unsigned)row.stop(wg) : 0u);
  bool on[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) on[c] = c * BW + bl < sw;
  V acc[BW][NC];
#pragma unroll
  for (int j = 0; j < BW; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[j][c] = V(0);

  const long long e0 = chunk * (long long)wg * CHUNK + lane;
  int word[AHEAD];
  V vr[AHEAD];
#pragma unroll
  for (int p = 0; p < AHEAD; ++p)
    if (p < stop) {
      word[p] = row.fetch(e0 + (long long)p * CHUNK);
      vr[p] = __ldg(val + e0 + (long long)p * CHUNK);
    }
  for (int w0 = 0; w0 < stop; w0 += AHEAD) {
#pragma unroll
    for (int p = 0; p < AHEAD; ++p) {
      const int w = w0 + p;
      if (w >= stop) break;
      const int cur = word[p];
      const V v = vr[p];
      if (w + AHEAD < stop) {
        const long long e = e0 + (long long)(w + AHEAD) * CHUNK;
        word[p] = row.fetch(e);
        vr[p] = __ldg(val + e);
      }
      long long col;
      const bool ok = row.take(cur, w, &col) && real;
      const unsigned live = __ballot_sync(FULL, ok);
      if (live == 0) continue;
      rows.put((int)clampll(col, n - 1), v);
#pragma unroll
      for (int j = 0; j < BW; j += RB) {
        if ((live & batch_bits<BW, RB>(j)) == 0) continue;
        int ck[RB];
        V vk[RB], xv[RB][NC];
        bool lk[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int src = g * BW + j + k;
          rows.get(src, &ck[k], &vk[k]);
          lk[k] = (live >> src) & 1u;  // warp-uniform when BW == 32
#pragma unroll
          for (int c = 0; c < NC; ++c)
            xv[k][c] = (lk[k] && (X::IN_BOUNDS || on[c]))
                           ? xs.at(ck[k], c * BW)
                           : V(0);
        }
        // A lane past the slab's width sums what is never stored.
#pragma unroll
        for (int k = 0; k < RB; ++k)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (lk[k])
              acc[j + k][c] =
                  Num<V>::add(acc[j + k][c], Num<V>::mul(vk[k], xv[k][c]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BW; ++j) {
    const long long rr = chunk * CHUNK + g * BW + j;
    if (rr >= R) continue;
    V* yr = y + rr * B + c0 + bl;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (on[c]) yr[c * BW] = acc[j][c];
  }
}

template <typename Row, int BW, int NC, int RB, typename Rows>
int launch(const typename Row::Args& ra, const void* val, long long R, int wg,
           const void* x, long long n, long long B, int bt, const WarpGeom& g,
           const WarpWork& w, void* y, void* stream) {
  using V = float;
  auto* kern = kernel<V, Row, BW, NC, RB, StagedX<V, BW * NC>, Rows>;
  // The port's count holds SmemRows' buffers; ShflRows needs none.
  const size_t smem = w.smem - (size_t)g.warps *
                                   (SmemRows<V>::BYTES - Rows::BYTES);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)w.blocks, g.warps * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(
      ra, static_cast<const V*>(val), R, wg, static_cast<const V*>(x), n, B,
      bt, w.chunks, w.per_tile, static_cast<V*>(y));
  return (int)cudaGetLastError();
}

#define VARIANT_ARGS ra, val, R, wg, x, n, B, bt, g, w, y, stream

template <typename Row, int BW, int NC, int RB>
int pick_rows(int shfl, const typename Row::Args& ra, const void* val,
              long long R, int wg, const void* x, long long n, long long B,
              int bt, const WarpGeom& g, const WarpWork& w, void* y,
              void* stream) {
  return shfl ? launch<Row, BW, NC, RB, ShflRows<float>>(VARIANT_ARGS)
              : launch<Row, BW, NC, RB, SmemRows<float>>(VARIANT_ARGS);
}

template <typename Row, int BW, int NC>
int pick_rb(int rb, int shfl, const typename Row::Args& ra, const void* val,
            long long R, int wg, const void* x, long long n, long long B,
            int bt, const WarpGeom& g, const WarpWork& w, void* y,
            void* stream) {
  switch (rb) {
    case 2: return pick_rows<Row, BW, NC, 2>(shfl, VARIANT_ARGS);
    case 4: return pick_rows<Row, BW, NC, 4>(shfl, VARIANT_ARGS);
    case 8: return pick_rows<Row, BW, NC, 8>(shfl, VARIANT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The port's launch_spmm_warp for the slabs the head's passes use (bw 4, 8
// and 32; two columns a lane at bw 32), staged x only.
template <typename Row>
int launch_variant(int rb, int shfl, const typename Row::Args& ra,
                   const void* val, long long R, int wg, const void* x,
                   long long n, long long B, int bt, const WarpGeom& g,
                   void* y, void* stream) {
  const WarpWork w = warp_work(g, R, n, B, bt, (int)sizeof(float));
  if (w.blocks < 1 || w.blocks != g.blocks || !g.stage)
    return (int)cudaErrorInvalidValue;
  if (g.nc == 2) return pick_rb<Row, 32, 2>(rb, shfl, VARIANT_ARGS);
  switch (g.bw) {
    case 4: return pick_rb<Row, 4, 1>(rb, shfl, VARIANT_ARGS);
    case 8: return pick_rb<Row, 8, 1>(rb, shfl, VARIANT_ARGS);
    case 32: return pick_rb<Row, 32, 1>(rb, shfl, VARIANT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

#undef VARIANT_ARGS

}  // namespace variants

extern "C" {

int sell_spmm_variant_launch(int rb, int shfl, const void* idx,
                             const void* stops, const void* val, long long R,
                             int wg, const void* x, long long n, long long B,
                             int bt, int bw, int nc, int warps, int stage,
                             long long blocks, void* y, void* stream) {
  const SellRow::Args a{static_cast<const int*>(idx),
                        static_cast<const int*>(stops)};
  const padded::WarpGeom g{bw, nc, warps, stage, blocks};
  return variants::launch_variant<SellRow>(rb, shfl, a, val, R, wg, x, n, B,
                                           bt, g, y, stream);
}

int rgcsr_spmm_variant_launch(int rb, int shfl, const void* deltas,
                              const void* nnz, const void* val, long long R,
                              int wg, const void* x, long long n, long long B,
                              int bt, int bw, int nc, int warps, int stage,
                              long long blocks, void* y, void* stream) {
  const RgcsrRow::Args a{static_cast<const int*>(deltas),
                         static_cast<const int*>(nnz)};
  const padded::WarpGeom g{bw, nc, warps, stage, blocks};
  return variants::launch_variant<RgcsrRow>(rb, shfl, a, val, R, wg, x, n, B,
                                            bt, g, y, stream);
}

}  // extern "C"
