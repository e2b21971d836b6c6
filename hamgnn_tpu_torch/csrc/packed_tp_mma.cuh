// What the pipeline kernels share.  All four (packed_tp_fwd.cu,
// packed_tp_bwd.cu and the edge-frame zonal_tp_fwd.cu, zonal_tp_bwd.cu): the
// Wcat-stage products on the tensor cores in 3xTF32, the fragment layouts
// and operand strides, cp.async copies and the occupancy query.  The
// lab-frame pair also: the host tables' record layouts, the loops unrolled
// to a column's d1 (with_d1) and the backward's slab build (a slab's
// coupling slots, compact x rows and BLK columns in shared memory).
//
// 3xTF32.  mma.sync m16n8k8 takes TF32 operands (10 mantissa bits); one pass
// is off by ~3e-4 * max|ref| at these shapes, over the kernels' 1e-4 limit.
// Each fp32 operand a is split into big = tf32(a) and small = tf32(a - big),
// and a*b is accumulated in fp32 as small*big + big*small + big*big: what is
// dropped (small*small and the rounding of small) is ~2^-22 of a*b, the
// accuracy of an fp32 FFMA.  tf32() rounds to nearest (ties away from zero)
// by integer arithmetic, so that the low 13 bits of both halves are zero
// whatever the tensor cores do with them.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32; gid = lane / 4, tig = lane % 4):
//   A 16x8: a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4)
//   B 8x8:  b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
//   C 16x8: c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
// Shared-memory row strides are chosen per operand so that these loads hit
// 32 distinct banks: stride_4mod8 where a warp reads [gid][tig] (rows by
// gid), stride_8mod16 where it reads [tig][gid] (rows by tig).
//
// bf16 (HAMGNN_TP_BF16).  Each kernel also has an instantiation whose
// Wcat-stage products take bfloat16 operands, as the JAX kernels' dots do
// under that switch: every operand is rounded to nearest (ties to even, as
// torch and JAX round) when its fragment is built from the fp32 values in
// shared or device memory, and one mma.sync m16n8k16 .bf16 accumulates the
// exact products in fp32, one pass into one accumulator.  Its coupling
// stage rounds sh and the coefficients to bf16 before its FFMAs: a product
// of two bf16 values is exact in fp32, so the FFMA chain computes the bf16
// dot's function.  Fragment layouts (PTX ISA, mma.m16n8k16 .bf16; two
// values a register, the lower k in the lower half):
//   A 16x16: a0 (gid, 2 tig .. +1), a1 (gid + 8, 2 tig ..), a2 (gid, 2 tig + 8 ..),
//            a3 (gid + 8, 2 tig + 8 ..)
//   B 16x8:  b0 (k = 2 tig .. +1, n = gid), b1 (k = 2 tig + 8 .. +1, n = gid)
//   C 16x8:  as for m16n8k8 above.
// A depth that is 8 mod 16 ends in a step whose upper half (a2, a3, b1) is
// zero.  The fp32 operand strides are kept: the bf16 loads are not free of
// bank conflicts (later work, as are bf16 staging, wgmma and TMA).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packed_tp {

constexpr int TE = 16;     // edges per tile: one m16 row tile per m3
constexpr int KS = 64;     // largest number of BLK columns in a slab
constexpr int MAXD1 = 13;  // largest input irrep dimension (l1 <= 6)
constexpr int GRP_W = 8;   // ints per output-chunk record
constexpr int COL_W = 4;   // ints per column record
constexpr int Q_W = 3;     // ints per coupling-slot record
constexpr int SLAB_W = 11; // ints per slab record
constexpr int G_W = 4;     // ints per x-group / slot-group record

// grp record: out offset, d3, V, Wcat offset, fan_in, column offset, coupling-slot
//             offset, slots per m3 (the last two read by the forward only)
// slab record: chunk, first column, columns, sq offset, slots, x-group offset, x groups,
//              slot-group offset, slot groups, xmap offset, compact x row length
// column record (backward): slot base in the slab's sq list, d1, offset in the
//                slab's compact x row, radial-weight column; (forward) slot offset
//                within an m3 block, d1, x offset, radial-weight column
// slot record (sq): coefficient offset, first SH component, count
// x group: compact x offset, d1, lst offset, count; slot group: slot base, d1, lst offset, count

__host__ __device__ inline int odd_stride(int n) { return n | 1; }
__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int stride_4mod8(int n) { return round8(n) + 4; }
__host__ __device__ inline int stride_8mod16(int n) {
  const int r = round8(n);
  return (r % 16) ? r : r + 8;
}

// ---------------------------------------------------------------- 3xTF32

__device__ __forceinline__ float tf32_round(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&a)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float b = tf32_round(a[i]);
    big[i] = __float_as_uint(b);
    small[i] = __float_as_uint(tf32_round(a[i] - b));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a * b in 3xTF32 into two accumulators, big*big into hi and the two
// correction terms into lo, so that two independent chains keep the tensor
// cores busy; the caller adds lo + hi into fp32 registers.
__device__ __forceinline__ void mma_3xtf32(float (&hi)[4], float (&lo)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
  split_tf32(a, ab, as);
  split_tf32(b, bb, bs);
  mma_tf32(lo, as, bb);
  mma_tf32(hi, ab, bb);
  mma_tf32(lo, ab, bs);
}

// The same with the two correction terms in accumulators of their own, so
// that each of the three chains is one product deep per call; the caller
// adds (lo + lo2) + hi into fp32 registers.
__device__ __forceinline__ void mma_3xtf32(float (&hi)[4], float (&lo)[4], float (&lo2)[4],
                                           const float (&a)[4], const float (&b)[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
  split_tf32(a, ab, as);
  split_tf32(b, bb, bs);
  mma_tf32(lo, as, bb);
  mma_tf32(hi, ab, bb);
  mma_tf32(lo2, ab, bs);
}

// ---------------------------------------------------------------- bf16

// a rounded to bf16 (to nearest, ties to even) and back to fp32
__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// a in the precision of a product's operands: bf16-rounded where BF16
template <bool BF16>
__device__ __forceinline__ float operand(float a) {
  return BF16 ? bf16_round(a) : a;
}

// acc + a * b for the mids: FFMA in fp32; in a bf16 instantiation a product
// rounded and then a sum rounded, as the plain version (and the JAX kernel)
// computes them, so that the fp32 values a bf16 product then rounds are the
// plain version's bit for bit
template <bool BF16>
__device__ __forceinline__ float mid_mac(float acc, float a, float b) {
  return BF16 ? __fadd_rn(acc, __fmul_rn(a, b)) : acc + a * b;
}

// two values, each rounded to bf16, in one register (lo in the lower half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k16 step of a bf16 product whose A operand is row-major in memory
// (element (r, k) at ar[r * ast + k], ar at row gid, column 2 tig of the
// step) and whose B operand is held as (n, k) rows (element (k, n) at
// br[n * bst + k], br at row gid, column 2 tig): both read two adjacent
// values a register.  Without `upper` the step is 8 deep.
__device__ __forceinline__ void mma_bf16_rows(float (&d)[4], const float* ar, int ast,
                                              const float* br, bool upper) {
  uint32_t a[4], b[2];
  a[0] = pack_bf16(ar[0], ar[1]);
  a[1] = pack_bf16(ar[8 * ast], ar[8 * ast + 1]);
  a[2] = upper ? pack_bf16(ar[8], ar[9]) : 0u;
  a[3] = upper ? pack_bf16(ar[8 * ast + 8], ar[8 * ast + 9]) : 0u;
  b[0] = pack_bf16(br[0], br[1]);
  b[1] = upper ? pack_bf16(br[8], br[9]) : 0u;
  mma_bf16(d, a, b);
}

// ---------------------------------------------------------------- cp.async

// 4-byte copy into shared memory; zero-fills where !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
// 16-byte copy (both addresses 16-byte aligned); zero-fills where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Blocks of nt threads of `kernel` resident on one SM at this shared-memory
// size (-1 where the runtime refuses the size).
inline int resident_per_sm(const void* kernel, int nt, size_t smem) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem) != cudaSuccess)
    return -1;
  return per_sm;
}

// ---------------------------------------------------------------- slab build

// f(Dim<d1>{}) for the odd input irrep dimensions d1 <= MAXD1, so that the
// inner loops over i < d1 are unrolled to exactly d1
template <int D>
struct Dim {
  static constexpr int value = D;
};
template <class F>
__device__ __forceinline__ void with_d1(int d1, F&& f) {
  switch (d1) {
    case 1: f(Dim<1>{}); break;
    case 3: f(Dim<3>{}); break;
    case 5: f(Dim<5>{}); break;
    case 7: f(Dim<7>{}); break;
    case 9: f(Dim<9>{}); break;
    case 11: f(Dim<11>{}); break;
    case 13: f(Dim<13>{}); break;
    default: break;
  }
}

// cp.async copies of n ints (a slab's records) into shared memory
template <int NT>
__device__ inline void stage_ints(int* dst, const int* __restrict__ src, int n) {
  for (int idx = threadIdx.x; idx < n; idx += NT)
    cp_async4(reinterpret_cast<float*>(dst) + idx, reinterpret_cast<const float*>(src) + idx, true);
}

// One slab's compact x rows, as cp.async copies: x_s[e * nxp + j] =
// x[e0 + e, xmap[j]] (zero past n_rows), and the same of dx into dx_s where
// given.  A thread owns a column j of the row for all the tile's edges, so it
// reads its x offset once; with xmap_s given it also keeps the offsets.
template <int NT>
__device__ inline void stage_x(float* x_s, float* dx_s, int nxp, const float* __restrict__ x,
                               const float* __restrict__ dx, int d_in, int e0, int n_rows,
                               const int* xmap, int* xmap_s, int nx) {
  for (int j = threadIdx.x; j < nx; j += NT) {
    const int xo = xmap[j];
    if (xmap_s) xmap_s[j] = xo;
#pragma unroll 4
    for (int e = 0; e < TE; ++e) {
      const bool ok = e < n_rows;
      const size_t at = (size_t)(e0 + e) * d_in + xo;
      cp_async4(x_s + e * nxp + j, ok ? x + at : x, ok);
      if (dx_s) cp_async4(dx_s + e * nxp + j, ok ? dx + at : dx, ok);
    }
  }
}

// A chunk's output gradient, as cp.async copies: G[(m3 * TE + e) * gst + v] =
// gy[e0 + e, b + v * d3 + m3] for v < V, read in gy's own order (contiguous
// per edge), zero past n_rows.  The pad columns V <= v < round8(V) are not
// written: the caller zeroes them once.
template <int NT>
__device__ inline void stage_g(float* G, int gst, const float* __restrict__ gy, int d_out,
                               int b, int d3, int V, int e0, int n_rows) {
  const int row = V * d3;
  for (int idx = threadIdx.x; idx < TE * row; idx += NT) {
    const int e = idx / row, o = idx - e * row;
    const int v = o / d3, m = o - v * d3;
    const bool ok = e < n_rows;
    cp_async4(G + (m * TE + e) * gst + v, ok ? gy + (size_t)(e0 + e) * d_out + b + o : gy, ok);
  }
}

// zero the pad columns V <= v < round8(V) of a G buffer of d3 * TE rows
template <int NT>
__device__ inline void zero_g_pad(float* G, int gst, int d3, int V) {
  const int pad = round8(V) - V;
  for (int idx = threadIdx.x; idx < d3 * TE * pad; idx += NT) {
    const int r = idx / pad;
    G[r * gst + V + idx - r * pad] = 0.f;
  }
}

// Coupling slots of one slab: Wsl[e * sqp + j] = sum_s coef_j[s] sh[e, s0_j + s]
// for the slab's n_sq slots j (sq: their records), a thread per slot for all
// the tile's edges, threads tid, tid + nthr, ...; dWsl, where given, is zeroed.
// BF16: both factors rounded to bf16 (the sum in the order of s, as B1's).
template <bool BF16>
__device__ inline void stage_slots(int tid, int nthr, float* Wsl, float* dWsl, int sqp,
                                   const float* sh_s, int S, const int* __restrict__ sq,
                                   int n_sq, const float* __restrict__ coef) {
  for (int j = tid; j < n_sq; j += nthr) {
    const int* qm = sq + j * Q_W;
    const float* cf = coef + __ldg(qm);
    const float* sr = sh_s + __ldg(qm + 1);
    const int ns = __ldg(qm + 2);
    float acc[TE];
#pragma unroll
    for (int e = 0; e < TE; ++e) acc[e] = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float c = operand<BF16>(__ldg(cf + s));
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] += c * operand<BF16>(sr[e * S + s]);
    }
#pragma unroll
    for (int e = 0; e < TE; ++e) {
      Wsl[e * sqp + j] = acc[e];
      if (dWsl) dWsl[e * sqp + j] = 0.f;
    }
  }
}

// One BLK column of one slab, all m3: A[m3 * TE * ast] = sc * sum_i
// W[m3 * d1 + i] x[i] (A: the column's entry in row e)
template <bool BF16, int D>
__device__ __forceinline__ void build_column(float* A, int ast, const float* wr, const float* xr,
                                             float sc, int d3) {
  float xv[D];
#pragma unroll
  for (int i = 0; i < D; ++i) xv[i] = xr[i];
  for (int m = 0; m < d3; ++m, wr += D) {
    float val = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) val = mid_mac<BF16>(val, wr[i], xv[i]);
    A[m * TE * ast] = val * sc;
  }
}

// BLK columns of one slab, all m3: A[(m3 * TE + e) * ast + c] =
// w_s[e * KS + c] * sum_i Wsl[e, sb_c + m3 * d1 + i] x_s[e, xo_c + i] for the
// slab's nc columns (cols_s: their records), without the factor where w_s is
// null; zero for c >= nc or e >= n_rows.  A thread builds the columns 2p and
// 2p + 1 of an edge; where both are of one coupling group (the u of one
// path) it reads their shared slots once for both.  The edge is the fastest
// index, so that a warp's lanes share their columns' d1 (the inner loops are
// unrolled to it).  ast must be even.  BF16: the mids as mid_mac builds them.
template <int NT, bool BF16>
__device__ inline void build_slab(float* A, int ast, const float* Wsl, int sqp, const float* x_s,
                                  int nxp, const float* w_s, const int* cols_s, int nc, int d3,
                                  int n_rows) {
  for (int idx = threadIdx.x; idx < TE * KS / 2; idx += NT) {
    const int e = idx % TE, c = 2 * (idx / TE);
    float* a = A + e * ast + c;
    if (c >= nc || e >= n_rows) {
      for (int m = 0; m < d3; ++m)
        *reinterpret_cast<float2*>(a + m * TE * ast) = make_float2(0.f, 0.f);
      continue;
    }
    const int* cm = cols_s + c * COL_W;
    const bool two = c + 1 < nc;
    const float sc0 = w_s ? w_s[e * KS + c] : 1.f;
    const float sc1 = w_s && two ? w_s[e * KS + c + 1] : 1.f;
    const float* wr = Wsl + e * sqp + cm[0];
    const float* x0 = x_s + e * nxp + cm[2];
    if (two && cm[COL_W] == cm[0] && cm[COL_W + 1] == cm[1]) {
      const float* x1 = x_s + e * nxp + cm[COL_W + 2];
      with_d1(cm[1], [&](auto D) {
        constexpr int n = decltype(D)::value;
        float xa[n], xb[n];
#pragma unroll
        for (int i = 0; i < n; ++i) {
          xa[i] = x0[i];
          xb[i] = x1[i];
        }
        for (int m = 0; m < d3; ++m, wr += n) {
          float v0 = 0.f, v1 = 0.f;
#pragma unroll
          for (int i = 0; i < n; ++i) {
            const float wv = wr[i];
            v0 = mid_mac<BF16>(v0, wv, xa[i]);
            v1 = mid_mac<BF16>(v1, wv, xb[i]);
          }
          *reinterpret_cast<float2*>(a + m * TE * ast) = make_float2(v0 * sc0, v1 * sc1);
        }
      });
    } else {
      with_d1(cm[1],
              [&](auto D) { build_column<BF16, decltype(D)::value>(a, ast, wr, x0, sc0, d3); });
      if (two) {
        const float* wr1 = Wsl + e * sqp + cm[COL_W];
        const float* x1 = x_s + e * nxp + cm[COL_W + 2];
        with_d1(cm[COL_W + 1], [&](auto D) {
          build_column<BF16, decltype(D)::value>(a + 1, ast, wr1, x1, sc1, d3);
        });
      } else {
        for (int m = 0; m < d3; ++m) a[m * TE * ast + 1] = 0.f;
      }
    }
  }
}

}  // namespace packed_tp
