// The other lane mapping for slices wider than a warp, kept to time it
// against the one the port ships (experiments/dtans_geometry/time_lane_mapping.py).
//
// The port's decoder (src/repro_torch/kernels/csrc/dtans_decode.cuh) gives
// a slice of L > 32 lanes ceil(L / 32) warps, one thread per lane, and
// exchanges the warps' claim counts behind one named barrier per segment.
// This kernel is the alternative: ONE warp per slice, each thread carrying
// LPT = ceil(L / 32) lanes in registers (lane = t + 32 q), ranks warp-local
// with no barrier: rank = sum over q' < q of popc(ballot_q') +
// popc(ballot_q & lanemask_lt). Same tables in shared memory, same refill
// window, same limbs, same contraction order, so its SpMV is bitwise the
// port's. Generic contraction only (no SHARED), f32 and f64.

#include "../../src/repro_torch/kernels/csrc/dtans_decode.cuh"

namespace {

template <typename V, int LPT>
__global__ void __launch_bounds__(256)
spmv_lanes_kernel(Args a, const V* __restrict__ x, int n, V* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = stage_tables(a, smem);
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + tables_bytes(a.T)) +
                  warp * 2 * O * 32 * LPT;
  const unsigned lt = lanemask_lt();
  const int wmax1 = (int)a.wmax - 1;
  for (int s = blockIdx.x * wpb + warp; s < a.S; s += gridDim.x * wpb) {
    const uint32_t* row = a.stream + (long long)s * a.wmax;
    uint32_t w[LPT][O], d[LPT][3], r[LPT][3];
    int col[LPT], nsegs[LPT], nnz[LPT];
    int nmax = 0;
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      const int lane = wl + 32 * q;
      const bool in = lane < a.L;
      const int ns = in ? a.ns[(long long)s * a.L + lane] : 0;
      nnz[q] = in ? a.nnz[(long long)s * a.L + lane] : 0;
      nsegs[q] = (ns + LS - 1) / LS;
      nmax = max(nmax, nsegs[q]);
      col[q] = 0;
      d[q][0] = d[q][1] = d[q][2] = 0u;
      r[q][0] = 1u;
      r[q][1] = r[q][2] = 0u;
    }
    int nseg = (int)__reduce_max_sync(FULL, (unsigned)nmax);
    nseg = nseg < a.max_nseg ? nseg : a.max_nseg;
    int cursor = 0, esc0 = 0, esc1 = 0;
#pragma unroll
    for (int k = 0; k < O; ++k) {
#pragma unroll
      for (int q = 0; q < LPT; ++q) {
        const unsigned b = __ballot_sync(FULL, nsegs[q] > 0);
        w[q][k] = nsegs[q] > 0
                      ? __ldg(row + clampi(cursor + __popc(b & lt), wmax1))
                      : 0u;
        cursor += __popc(b);
      }
    }
    V acc[LPT];
#pragma unroll
    for (int q = 0; q < LPT; ++q) acc[q] = V(0);
    for (int j = 0; j < nseg; ++j) {
      uint32_t* wj = win + (j & 1) * O * 32 * LPT;
#pragma unroll
      for (int i = 0; i < O * LPT; ++i)
        cp_async4(wj + wl + 32 * i,
                  row + clampi(cursor + wl + 32 * i, wmax1));
      unsigned long long syms[LPT][LS];
      unsigned escm[LPT];
      bool take[LPT][O], refill[LPT];
      uint32_t wk[LPT][O];
#pragma unroll
      for (int q = 0; q < LPT; ++q) {
        const bool active = j < nsegs[q];
        uint32_t digs[LS], bass[LS];
        escm[q] = 0u;
#pragma unroll
        for (int k = 0; k < LS; ++k) {
          const int lo = k * KB;
          const int wi = lo / WB, sh = lo % WB;
          unsigned long long pair = w[q][O - 1 - wi];
          if (wi + 1 < O) pair |= (unsigned long long)w[q][O - 2 - wi] << WB;
          const uint32_t slot = (uint32_t)(pair >> sh) & KM1;
          const int t = (a.pattern_bits >> k) & 1;
          syms[q][k] = tb.sym[t * (3 * KSLOTS / 2) + slot];
          const uint32_t meta = tb.meta[t * 3 * KSLOTS + slot];
          if (active && ((meta >> 17) & 1u)) escm[q] |= 1u << k;
          digs[k] = active ? (meta & 0xFFu) : 0u;
          bass[k] = active ? ((meta >> 8) & 0x1FFu) : 1u;
        }
#pragma unroll
        for (int g0 = 0; g0 < LS; g0 += DG) {
          uint32_t gacc = 0u, r3 = 1u;
#pragma unroll
          for (int k = g0; k < g0 + DG; ++k) gacc = gacc * bass[k] + digs[k];
#pragma unroll
          for (int k = g0; k < g0 + DG - 1; ++k) r3 *= bass[k];
          const unsigned long long racc =
              (unsigned long long)r3 * bass[g0 + DG - 1];
          limb_mul_add(d[q], racc, gacc);
          limb_mul_add(r[q], racc, 0u);
        }
        refill[q] = active && (j < nsegs[q] - 1);
#pragma unroll
        for (int k = 0; k < O; ++k) {
          wk[q][k] = 0u;
          take[q][k] = refill[q];
          if (k < F) {
            const bool cond = limb_ge_w(r[q]) && refill[q];
            wk[q][k] = d[q][0];
            if (cond) {
              limb_shr(d[q]);
              limb_shr(r[q]);
            }
            take[q][k] = refill[q] && !cond;
          }
        }
      }
      cp_async_wait_all();
      __syncwarp(FULL);
      int off = 0;
#pragma unroll
      for (int k = 0; k < O; ++k) {
#pragma unroll
        for (int q = 0; q < LPT; ++q) {
          const unsigned b = __ballot_sync(FULL, take[q][k]);
          if (take[q][k]) wk[q][k] = wj[off + __popc(b & lt)];
          off += __popc(b);
        }
      }
      cursor += off;
#pragma unroll
      for (int q = 0; q < LPT; ++q)
#pragma unroll
        for (int k = 0; k < O; ++k)
          if (refill[q]) w[q][k] = wk[q][k];
      unsigned any = 0u;
#pragma unroll
      for (int q = 0; q < LPT; ++q) any |= escm[q];
      if (__any_sync(FULL, any != 0u)) {
#pragma unroll
        for (int k = 0; k < LS; ++k) {
          const int t = (a.pattern_bits >> k) & 1;
          const int cur = t ? esc1 : esc0;
          int run = 0;
#pragma unroll
          for (int q = 0; q < LPT; ++q) {
            const unsigned b = __ballot_sync(FULL, (escm[q] >> k) & 1u);
            if ((escm[q] >> k) & 1u) {
              const int e = clampi(cur + run + __popc(b & lt),
                                   (int)a.emax - 1);
              syms[q][k] =
                  __ldg(a.esc + ((long long)t * a.S + s) * a.emax + e);
            }
            run += __popc(b);
          }
          if (t) {
            esc1 += run;
          } else {
            esc0 += run;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < LPT; ++q) {
        V sum = V(0);
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const bool ok = j < nsegs[q] && (j * H + i) < nnz[q];
          if (ok) col[q] = (int)((uint32_t)col[q] + (uint32_t)syms[q][2 * i]);
          V c = V(0);
          if (ok)
            c = Num<V>::mul(Num<V>::value(syms[q][2 * i + 1]),
                            __ldg(x + clampi(col[q], n - 1)));
          sum = (i == 0) ? c : Num<V>::add(sum, c);
        }
        acc[q] = Num<V>::add(acc[q], sum);
      }
    }
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      const int lane = wl + 32 * q;
      if (lane < a.L) y[(long long)s * a.L + lane] = acc[q];
    }
  }
}

template <typename V, int LPT>
int launch(const Args& a, int blocks, int threads, const void* x, int n,
           void* y, cudaStream_t cs) {
  const long long smem =
      tables_bytes(a.T) + (threads / 32) * 2ll * O * 32 * LPT * 4;
  cudaError_t err = opt_in(spmv_lanes_kernel<V, LPT>, smem);
  if (err != cudaSuccess) return (int)err;
  spmv_lanes_kernel<V, LPT><<<blocks, threads, smem, cs>>>(
      a, static_cast<const V*>(x), n, static_cast<V*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (S, L) = A x with one warp per slice, L <= 128 lanes (LPT <= 4).
int spmv_lanes_launch(int f64, const void* stream, long long wmax,
                      const void* esc, long long emax, const void* ns,
                      const void* nnz, const void* tables, int T,
                      int pattern_bits, int S, int L, int max_nseg,
                      int blocks, int threads, const void* x, long long n,
                      void* y, void* cuda_stream) {
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tables, T,
                           pattern_bits, S, L, max_nseg);
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const int lpt = (L + 31) / 32;
  if (lpt > 4 || threads > 256) return (int)cudaErrorInvalidValue;
  if (f64) {
    return lpt <= 2 ? launch<double, 2>(a, blocks, threads, x, (int)n, y, cs)
                    : launch<double, 4>(a, blocks, threads, x, (int)n, y, cs);
  }
  return lpt <= 2 ? launch<float, 2>(a, blocks, threads, x, (int)n, y, cs)
                  : launch<float, 4>(a, blocks, threads, x, (int)n, y, cs);
}

}  // extern "C"
