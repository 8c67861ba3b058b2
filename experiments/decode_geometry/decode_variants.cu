// Variants of the decode-only dtANS kernel's stores, for
// time_decode_geometry.py. Every variant runs the port's decoder
// (src/repro_torch/kernels/csrc/dtans_decode.cuh) in the port's geometry
// and writes the same (S, L, max_nseg * H) columns and values; they differ
// only in how the decoded segments reach device memory (MODE):
//   SCALAR  each thread stores its segment's 4 columns and 4 values one
//           scalar at a time into its own row, and the padding past the
//           unit's last segment one scalar at a time (the kernel before
//           the staged design);
//   VEC     each thread stores its segment as 16-byte vectors into its own
//           row (32 rows a warp store, half sectors), the padding the same;
//   STAGED  the port's design (csrc/dtans_decode.cu): KS segments staged
//           per warp in a swizzled shared-memory tile, written out by the
//           warp as consecutive 16-byte pieces of consecutive rows;
//   BULK    the staged tile, double-buffered (rows padded by 16 bytes
//           instead of swizzled, as a bulk copy reads a row contiguously),
//           written out by cp.async.bulk.global.shared::cta, one copy a row
//           and array, issued by lane 0 alone (ISS = 1) or by each lane for
//           its own row (ISS = 32), with commit_group / wait_group.read 1
//           before a buffer is written again.
// CS = true stores with st.global.cs (streaming: the output is never read
// again by the kernel and exceeds the 50 MB L2). Only f32 and blocks of up
// to 256 threads are instantiated (the SmolLM-135M head at L = 128 and the
// 4x4-blocked head at L = 4).
//
// C entry: decode_variant_launch(mode, ks, cs, iss, <the port's
// dtans_decode_launch arguments without f64 and ks>); the caller's smem
// must hold the variant's plan (the script computes it).
//
// Built by the script with the port's nvcc flags and
// -I src/repro_torch/kernels/csrc; not part of the port's build.

#include "dtans_decode.cuh"

namespace variants {

enum { SCALAR = 0, VEC = 1, STAGED = 2, BULK = 3 };

template <bool CS>
__device__ __forceinline__ void put4(int4* p, int4 v) {
  if constexpr (CS) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}
template <bool CS>
__device__ __forceinline__ void put1(int* p, int v) {
  if constexpr (CS) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

__device__ __forceinline__ long long stage_bytes(int ks) {
  return 32ll * ks * H * 8;  // f32: 16 B of columns, 16 B of values
}
// The bulk tile: two buffers of 32 rows of ks + 1 pieces, columns and values.
__device__ __forceinline__ long long bulk_bytes(int ks) {
  return 2ll * 2 * 32 * (ks + 1) * 16;
}

template <int N>
__device__ __forceinline__ int slot(int r, int p) {
  const int swz = N >= 8 ? (r & 7) : (((r * N) >> 3) & (N - 1));
  return r * N + (p ^ swz);
}

template <int N, bool CS>
__device__ __forceinline__ void flush(const int4* tile, int4* out,
                                      long long pitch, long long first,
                                      int kc, int row) {
  const int wl = threadIdx.x & 31;
  for (int c = wl; c < 32 * kc; c += 32) {
    const int r = kc == N ? c / N : c / kc;
    const int p = c - r * kc;
    const int g = __shfl_sync(FULL, row, r);
    if (g >= 0) put4<CS>(out + g * pitch + first + p, tile[slot<N>(r, p)]);
  }
}

template <bool CS>
__device__ __forceinline__ void fill(int4* out, long long pitch,
                                     long long first, int kc, int row,
                                     int4 v) {
  const int wl = threadIdx.x & 31;
  for (int c = wl; c < 32 * kc; c += 32) {
    const int r = c / kc;
    const int g = __shfl_sync(FULL, row, r);
    if (g >= 0) put4<CS>(out + g * pitch + first + (c - r * kc), v);
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(s), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int MODE, int KS, bool CS, int ISS>
__global__ void __launch_bounds__(256)
kernel(Args a, Geom gm, int4* __restrict__ cols_out,
       int4* __restrict__ vals_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = stage_tables(a, smem);
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const int gi = warp / gm.uw;
  unsigned char* units = smem + tables_bytes(a.T);
  const UnitSmem us = unit_smem(units + gi * unit_bytes(gm.uw), gm.uw);
  unsigned char* mine =
      units + gm.upb * unit_bytes(gm.uw) +
      warp * (MODE == BULK ? bulk_bytes(KS)
                           : (MODE == STAGED ? stage_bytes(KS) : 0));
  int4* tcol = reinterpret_cast<int4*>(mine);
  int4* tval = tcol + 32 * (MODE == BULK ? KS + 1 : KS);
  constexpr int BP = KS + 1;  // bulk row pitch, pieces
  int buf = 0;
  const long long pitch = a.max_nseg;  // 16-byte pieces a row
  int* cols1 = reinterpret_cast<int*>(cols_out);
  float* vals1 = reinterpret_cast<float*>(vals_out);
  for (long long u = (long long)blockIdx.x * gm.upb + gi; u < gm.units;
       u += (long long)gridDim.x * gm.upb) {
    Group g = make_group(a, gm, us, u, warp - gi * gm.uw, 1 + gi);
    Lane st;
    const int nseg = init_lane(a, g, st);
    const int row = g.in ? (int)(g.s * a.L + g.lane) : -1;
    for (int j = 0; j < nseg; ++j) {
      Seg sg;
      decode_segment(a, tb, g, st, j, sg);
      int4 c, v;
      c.x = (sg.valid & 1u) ? sg.col[0] : -1;
      c.y = (sg.valid & 2u) ? sg.col[1] : -1;
      c.z = (sg.valid & 4u) ? sg.col[2] : -1;
      c.w = (sg.valid & 8u) ? sg.col[3] : -1;
      v.x = (sg.valid & 1u) ? (int)(unsigned)sg.vb[0] : 0;
      v.y = (sg.valid & 2u) ? (int)(unsigned)sg.vb[1] : 0;
      v.z = (sg.valid & 4u) ? (int)(unsigned)sg.vb[2] : 0;
      v.w = (sg.valid & 8u) ? (int)(unsigned)sg.vb[3] : 0;
      if constexpr (MODE == SCALAR) {
        if (row >= 0) {
          const long long q = ((long long)row * pitch + j) * H;
          put1<CS>(cols1 + q, c.x);
          put1<CS>(cols1 + q + 1, c.y);
          put1<CS>(cols1 + q + 2, c.z);
          put1<CS>(cols1 + q + 3, c.w);
          put1<CS>(reinterpret_cast<int*>(vals1) + q, v.x);
          put1<CS>(reinterpret_cast<int*>(vals1) + q + 1, v.y);
          put1<CS>(reinterpret_cast<int*>(vals1) + q + 2, v.z);
          put1<CS>(reinterpret_cast<int*>(vals1) + q + 3, v.w);
        }
      } else if constexpr (MODE == VEC) {
        if (row >= 0) {
          put4<CS>(cols_out + (long long)row * pitch + j, c);
          put4<CS>(vals_out + (long long)row * pitch + j, v);
        }
      } else if constexpr (MODE == STAGED) {
        const int p = j & (KS - 1);
        tcol[slot<KS>(wl, p)] = c;
        tval[slot<KS>(wl, p)] = v;
        if (p == KS - 1 || j == nseg - 1) {
          __syncwarp(FULL);
          flush<KS, CS>(tcol, cols_out, pitch, j - p, p + 1, row);
          flush<KS, CS>(tval, vals_out, pitch, j - p, p + 1, row);
          __syncwarp(FULL);
        }
      } else {  // BULK
        const int p = j % KS;
        int4* bc = tcol + buf * 2 * 32 * BP;
        int4* bv = bc + 32 * BP;
        bc[wl * BP + p] = c;
        bv[wl * BP + p] = v;
        if (p == KS - 1 || j == nseg - 1) {
          fence_proxy_async();
          __syncwarp(FULL);
          const int j0 = j - p, bytes = (p + 1) * 16;
          if (ISS == 32) {
            if (row >= 0) {
              bulk_copy(cols_out + (long long)row * pitch + j0, bc + wl * BP,
                        bytes);
              bulk_copy(vals_out + (long long)row * pitch + j0, bv + wl * BP,
                        bytes);
            }
            bulk_commit();
            bulk_wait_read1();
          } else {
            if (wl == 0) {
              for (int r = 0; r < 32; ++r) {
                int lane, s;
                if (gm.uw == 1) {
                  lane = r % gm.group;
                  s = (int)(u * gm.spu + r / gm.group);
                } else {
                  lane = g.wi * 32 + r;
                  s = (int)u;
                }
                if (lane >= a.L || s >= a.S) continue;
                const long long gr = (long long)s * a.L + lane;
                bulk_copy(cols_out + gr * pitch + j0, bc + r * BP, bytes);
                bulk_copy(vals_out + gr * pitch + j0, bv + r * BP, bytes);
              }
              bulk_commit();
              bulk_wait_read1();
            }
          }
          __syncwarp(FULL);
          buf ^= 1;
        }
      }
    }
    if (nseg < a.max_nseg) {
      if constexpr (MODE == SCALAR) {
        if (row >= 0) {
          for (long long q = ((long long)row * pitch + nseg) * H;
               q < ((long long)row + 1) * pitch * H; ++q) {
            put1<CS>(cols1 + q, -1);
            put1<CS>(reinterpret_cast<int*>(vals1) + q, 0);
          }
        }
      } else if constexpr (MODE == VEC) {
        if (row >= 0) {
          for (int j = nseg; j < a.max_nseg; ++j) {
            put4<CS>(cols_out + (long long)row * pitch + j,
                     make_int4(-1, -1, -1, -1));
            put4<CS>(vals_out + (long long)row * pitch + j,
                     make_int4(0, 0, 0, 0));
          }
        }
      } else {
        fill<CS>(cols_out, pitch, nseg, a.max_nseg - nseg, row,
                 make_int4(-1, -1, -1, -1));
        fill<CS>(vals_out, pitch, nseg, a.max_nseg - nseg, row,
                 make_int4(0, 0, 0, 0));
      }
    }
  }
  if constexpr (MODE == BULK) {
    if (ISS == 32 || wl == 0) bulk_wait_all();
  }
}

template <int MODE, int KS, bool CS, int ISS>
cudaError_t go(int blocks, int threads, long long smem, cudaStream_t cs,
               const Args& a, const Geom& gm, void* cols, void* vals) {
  const cudaError_t err = opt_in(kernel<MODE, KS, CS, ISS>, smem);
  if (err != cudaSuccess) return err;
  kernel<MODE, KS, CS, ISS><<<blocks, threads, smem, cs>>>(
      a, gm, static_cast<int4*>(cols), static_cast<int4*>(vals));
  return cudaGetLastError();
}

template <int MODE, bool CS, int ISS>
cudaError_t by_ks(int ks, int blocks, int threads, long long smem,
                  cudaStream_t cs, const Args& a, const Geom& gm, void* cols,
                  void* vals) {
  switch (ks) {
    case 2:
      return go<MODE, 2, CS, ISS>(blocks, threads, smem, cs, a, gm, cols,
                                  vals);
    case 4:
      return go<MODE, 4, CS, ISS>(blocks, threads, smem, cs, a, gm, cols,
                                  vals);
    case 8:
      return go<MODE, 8, CS, ISS>(blocks, threads, smem, cs, a, gm, cols,
                                  vals);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace variants

extern "C" int decode_variant_launch(
    int mode, int ks, int cs_store, int iss, const void* stream,
    long long wmax, const void* esc, long long emax, const void* ns,
    const void* nnz, const void* tables, int T, int pattern_bits, int S,
    int L, int max_nseg, int group, int uw, int spu, long long units,
    int upb, int cw, int blocks, int threads, long long smem, void* cols,
    void* vals, void* cuda_stream) {
  using namespace variants;
  const Args a = make_args(stream, wmax, esc, emax, ns, nnz, tables, T,
                           pattern_bits, S, L, max_nseg);
  const Geom gm = make_geom(group, uw, spu, units, upb, cw);
  if (threads != upb * uw * 32 || threads > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const bool c = cs_store != 0;
  switch (mode) {
    case SCALAR:
      return c ? go<SCALAR, 2, true, 1>(blocks, threads, smem, st, a, gm,
                                        cols, vals)
               : go<SCALAR, 2, false, 1>(blocks, threads, smem, st, a, gm,
                                         cols, vals);
    case VEC:
      return c ? go<VEC, 2, true, 1>(blocks, threads, smem, st, a, gm, cols,
                                     vals)
               : go<VEC, 2, false, 1>(blocks, threads, smem, st, a, gm, cols,
                                      vals);
    case STAGED:
      return c ? by_ks<STAGED, true, 1>(ks, blocks, threads, smem, st, a, gm,
                                        cols, vals)
               : by_ks<STAGED, false, 1>(ks, blocks, threads, smem, st, a,
                                         gm, cols, vals);
    case BULK:
      return iss == 32
                 ? by_ks<BULK, false, 32>(ks, blocks, threads, smem, st, a,
                                          gm, cols, vals)
                 : by_ks<BULK, false, 1>(ks, blocks, threads, smem, st, a,
                                         gm, cols, vals);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
