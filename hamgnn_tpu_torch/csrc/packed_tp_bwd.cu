// Packed TP -> radial scale -> equivariant Linear, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_tp.py `_bwd_call`
// (PallasSpec._bwd_body), the backward of packed_tp_fwd.cu.  With the
// forward's notation (per output chunk (b, d3, V), BLK column c with slot
// base sb, d1, x offset xb and radial-weight column wc) and gy = d(out):
//
//   W[e,j]       = sum_s sh[e,s] coef_j[s]  (the slab's slots, recomputed)
//   mid[e,m3,c]  = sum_i W[e, sb+m3*d1+i] x[e, xb+i]            (recomputed)
//   dBLK[e,m3,c] = sum_v gy[e, b+v*d3+m3] Wcat[c,v]
//   dWcat[c,v]   = sum_e sum_m3 mid[e,m3,c] w[e,wc] gy[e, b+v*d3+m3]
//   dw[e,wc]    += sum_m3 dBLK[e,m3,c] mid[e,m3,c]
//   dx[e,xb+i]  += sum_m3 dBLK[e,m3,c] w[e,wc] W[e, sb+m3*d1+i]
//   dsh[e,s]    += sum_j coef_j[s] sum_{c on j} dBLK w x[e,xb+i]   (need_dsh)
//
// What bounds it.  At the bench widths the function does ~20 FLOP per byte
// of operands in fp32, near the H100's fp32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s): the node and edge plans are bound by operations (two Wcat-stage
// products of 4.2 GFLOP each at the node plan), the pair plan by bytes.  The
// previous design ran both products on the CUDA cores, one output per
// thread with two or three shared-memory loads per FMA, and summed each
// 8-edge tile's dWcat into its block's partial row in device memory: 2.2
// TFLOP/s at the node plan.
//
// What the design does about it: two passes over the same slabs (at most 64
// BLK columns of one output chunk; packed_tp_mma.cuh), split by what each
// output is summed over, both products on the tensor cores in 3xTF32.
//  * Edge pass (packed_tp_bwd_edge_kernel): a block owns one 16-edge tile,
//    so it alone writes that tile's rows of dx, dw and dsh, in a fixed order
//    and without atomics.  Per chunk and slab it copies in (cp.async) the
//    slab's column records, Wcat rows, compact x row and the dx values that
//    slab adds to, builds the mid slab, and each warp computes dBLK = G
//    Wcat^T for 8 columns and all m3 (K = V padded to 8 with zero columns),
//    takes dw and dmid = dBLK * w straight from the accumulator fragments and
//    writes dmid over the mids; dx and dW (for dsh) then gather from the
//    slab's x groups and slot groups, and dx is stored without a dependent
//    load.
//  * Weight pass (packed_tp_bwd_wcat_kernel): the grid is (work item, edge
//    split), a work item being a slab and 32 of its chunk's V columns (host
//    table `witems`; one item a slab where V <= 32), the heaviest slabs
//    first.  A block streams its split's tiles of sh, gy (its V columns), w
//    and compact x rows through shared memory with cp.async into a double
//    buffer, rebuilds BLK = mid * w for its columns and accumulates
//    dWcat[64, <= 32] = BLK^T G over K = its edges x d3 (two warps per m16
//    column tile, each half of K; 4 n8 tiles a warp): each tile's product
//    (K <= 72) in fragments, added into fp32 registers, so that no long sum
//    stays in the tensor cores' accumulation.  Then it writes its item's
//    part of one partial row.
//    packed_tp_bwd_reduce adds the splits in a fixed order, folds in
//    1/sqrt(fan_in) and scatters through the Wcat index into d(flat_w).  So
//    there is no read-modify-write of partials in device memory per tile,
//    no atomic anywhere, and a repeat is bit-identical.
//  * The mids are rebuilt in both passes (~2 GFLOP at the node plan):
//    cheaper than writing BLK to device memory and reading it back (1 GB).
//  * A slab computes only the coupling slots its columns use (at most 192)
//    and stages only the x values they read, so both passes fit two
//    256-thread blocks in an SM's shared memory; the inner loops are
//    unrolled to each column's d1.
//  * Variants.  BF16 = true is the instantiation of HAMGNN_TP_BF16=bwd|all:
//    sh and the coefficients rounded to bf16 in the coupling slots, both
//    Wcat-stage products one bf16 mma.sync m16n8k16 pass
//    (packed_tp_mma.cuh), and dsh's products (dmid x) and coefficients
//    rounded to bf16, as the JAX kernel's dots round them.  STORE = true
//    (HAMGNN_TP_STOREMID, `mids` given): both passes read the forward's
//    stored mids (host table `mcols`) instead of rebuilding them; the edge
//    pass still computes the coupling slots, which dx needs.  Both are
//    compile-time parameters: the default instantiation carries neither.
//  * Rows past E load zeros and store nothing.

#include "packed_tp_mma.cuh"

namespace {

using namespace packed_tp;

constexpr int NT = 256;      // threads per block, both passes: 8 warps, each 8 columns
                             // (edge pass) or an m16 column tile and half of K (weight pass)
constexpr int DST = KS + 8;  // mid / dmid / BLK row stride: float2 reads by (gid, 2 tig)
constexpr int RED_NT = 256;  // threads per block of the reduce
constexpr int ITEM_N8 = 4;   // n8 tiles of V a weight-pass item covers (32 columns)
constexpr int RED_FLOATS = 4 * ITEM_N8 * 4 * 32;  // the weight pass's K-half exchange

struct Layout {
  int d3_max = 1, v_max = 1, g_edge = 0, g_wcat = 0;
  Layout(const int* grp_host, int n_groups) {
    for (int k = 0; k < n_groups; ++k) {
      const int d3 = grp_host[k * GRP_W + 1], V = grp_host[k * GRP_W + 2];
      d3_max = d3 > d3_max ? d3 : d3_max;
      v_max = V > v_max ? V : v_max;
      const int ge = d3 * TE * stride_4mod8(V);
      const int gw = d3 * TE * stride_8mod16(V < 8 * ITEM_N8 ? V : 8 * ITEM_N8);
      g_edge = ge > g_edge ? ge : g_edge;
      g_wcat = gw > g_wcat ? gw : g_wcat;
    }
  }
  int a_floats() const { return align4(d3_max * TE * DST); }
  // edge pass: sh [TE][S] | W [TE][sqp] | dW [TE][sqp] (need_dsh) |
  //            G [d3*TE][stride_4mod8(V)] | Wcat [KS][stride_4mod8(V)] | mid/dmid [d3*TE][DST] |
  //            column records [KS][COL_W] | x groups [KS][G_W] | their columns [KS] |
  //            x offsets [nx_max] | x rows [TE][nxp] | dx rows [TE][nxp]
  size_t edge_floats(int S, int sq_max, int nx_max, int need_dsh) const {
    return (size_t)align4(TE * S) + (need_dsh ? 2 : 1) * (size_t)align4(TE * odd_stride(sq_max)) +
           align4(g_edge) + align4(KS * stride_4mod8(v_max)) + a_floats() + KS * COL_W +
           KS * G_W + KS + align4(nx_max) + 2 * (size_t)align4(TE * odd_stride(nx_max));
  }
  // weight pass: 2 x stage (sh [TE][S] | G [d3*TE][stride_8mod16(VB)] | w [TE][KS] |
  //              x rows [TE][nxp]) | column records [KS][COL_W] | x offsets [nx_max] |
  //              W [TE][sqp] | BLK [d3*TE][DST] (also the K-half exchange)
  int stage_floats(int S, int nx_max) const {
    return align4(TE * S) + align4(g_wcat) + TE * KS + align4(TE * odd_stride(nx_max));
  }
  size_t wcat_floats(int S, int sq_max, int nx_max) const {
    const int a = a_floats() > RED_FLOATS ? a_floats() : RED_FLOATS;
    return 2 * (size_t)stage_floats(S, nx_max) + KS * COL_W + align4(nx_max) +
           align4(TE * odd_stride(sq_max)) + a;
  }
};

// The slab's BLK columns from the forward's stored mids, laid out as
// build_slab lays them: A[(m3 * TE + e) * ast + c] = mid[e, m3, c] * w_s[e *
// KS + c] (the mid alone where w_s is null), zero for c >= nc or e >= n_rows;
// mc: the slab's first column's record in `mcols` (offset at m3 = 0, step
// per m3 in the (E, midw) buffer).
template <int NT>
__device__ inline void load_slab(float* A, int ast, const float* __restrict__ mids, int midw,
                                 const int2* __restrict__ mc, const float* w_s, int nc, int d3,
                                 int e0, int n_rows) {
  for (int idx = threadIdx.x; idx < d3 * TE * KS; idx += NT) {
    const int c = idx % KS, r = idx / KS, m = r / TE, e = r - m * TE;
    float v = 0.f;
    if (c < nc && e < n_rows) {
      const int2 q = __ldg(mc + c);
      v = __ldg(mids + (size_t)(e0 + e) * midw + q.x + m * q.y);
      if (w_s) v *= w_s[e * KS + c];
    }
    A[r * ast + c] = v;
  }
}

template <bool BF16, bool STORE>
__global__ void __launch_bounds__(NT, 2) packed_tp_bwd_edge_kernel(
    const float* __restrict__ x, const float* __restrict__ sh,
    const float* __restrict__ w, const float* __restrict__ wcat,
    const float* __restrict__ gy, const float* __restrict__ coef,
    const int* __restrict__ grp, const int* __restrict__ cols,
    const int* __restrict__ slab_base, const int* __restrict__ slabs,
    const int* __restrict__ sq, const int* __restrict__ xmap,
    const int* __restrict__ xgrp, const int* __restrict__ qgrp,
    const int* __restrict__ lst, float* __restrict__ dx, float* __restrict__ dsh,
    float* __restrict__ dw, const float* __restrict__ mids, const int2* __restrict__ mcols,
    int E, int d_in, int S, int n_ch, int d_out, int n_groups, int sq_max, int nx_max,
    int g_floats, int d3_max, int v_max, int has_w, int need_dsh, int midw) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int sqp = odd_stride(sq_max), nxp = odd_stride(nx_max);
  const int e0 = blockIdx.x * TE;
  const int n_rows = min(TE, E - e0);

  float* sh_s = smem;
  float* W_s = sh_s + align4(TE * S);
  float* dW_s = W_s + align4(TE * sqp);
  float* G_s = dW_s + (need_dsh ? align4(TE * sqp) : 0);
  float* B_s = G_s + align4(g_floats);
  float* D_s = B_s + align4(KS * stride_4mod8(v_max));
  int* cols_s = reinterpret_cast<int*>(D_s + align4(d3_max * TE * DST));
  int* xg_s = cols_s + KS * COL_W;
  int* lst_s = xg_s + KS * G_W;
  int* xmap_s = lst_s + KS;
  float* x_s = reinterpret_cast<float*>(xmap_s + align4(nx_max));
  float* dx_s = x_s + align4(TE * nxp);

  {
    const float* sg = sh + (size_t)e0 * S;
    const int n = n_rows * S;
    for (int idx = t; idx < TE * S; idx += NT) sh_s[idx] = idx < n ? sg[idx] : 0.f;
  }

  for (int k = 0; k < n_groups; ++k) {
    const int* gm = grp + (size_t)k * GRP_W;
    const int out_base = gm[0], d3 = gm[1], V = gm[2], wofs = gm[3], col_ofs = gm[5];
    const int ST = stride_4mod8(V), KV = round8(V);
    for (int s = slab_base[k]; s < slab_base[k + 1]; ++s) {
      const int* sl = slabs + (size_t)s * SLAB_W;
      const int c0 = sl[1], nc = sl[2], n_sq = sl[4];
      const int* sqs = sq + (size_t)sl[3] * Q_W;
      const int* xm = xmap + sl[9];
      const int nx = sl[10];
      __syncthreads();  // sh_s ready; the previous slab is done with every buffer

      // 1. copied in: the chunk's output gradient G[(m3*TE + e)][v] (first
      //    slab), the slab's column records, x groups and their columns, Wcat
      //    rows, x rows and the dx values it adds to; computed: its coupling
      //    slots
      if (s == slab_base[k]) {
        zero_g_pad<NT>(G_s, ST, d3, V);
        stage_g<NT>(G_s, ST, gy, d_out, out_base, d3, V, e0, n_rows);
      }
      const int xg_ofs = sl[5], n_xg = sl[6], qg_ofs = sl[7], n_qg = sl[8];
      const int lo0 = __ldg(xgrp + (size_t)xg_ofs * G_W + 2);
      stage_ints<NT>(cols_s, cols + (size_t)(col_ofs + c0) * COL_W, nc * COL_W);
      stage_ints<NT>(xg_s, xgrp + (size_t)xg_ofs * G_W, n_xg * G_W);
      stage_ints<NT>(lst_s, lst + lo0, nc);
      stage_x<NT>(x_s, dx_s, nxp, x, dx, d_in, e0, n_rows, xm, xmap_s, nx);
      for (int idx = t; idx < KS * KV; idx += NT) {
        const int c = idx / KV, v = idx - c * KV;
        const bool ok = c < nc && v < V;
        cp_async4(B_s + c * ST + v, ok ? wcat + wofs + (size_t)(c0 + c) * V + v : wcat, ok);
      }
      cp_async_commit();
      stage_slots<BF16>(t, NT, W_s, need_dsh ? dW_s : nullptr, sqp, sh_s, S, sqs, n_sq, coef);
      cp_async_wait_all();
      __syncthreads();

      // 2. the mid slab (unscaled), built or read from the stored mids
      if (STORE)
        load_slab<NT>(D_s, DST, mids, midw, mcols + col_ofs + c0, nullptr, nc, d3, e0, n_rows);
      else
        build_slab<NT, BF16>(D_s, DST, W_s, sqp, x_s, nxp, nullptr, cols_s, nc, d3, n_rows);
      __syncthreads();

      // 3. warp w: columns 8w..8w+7.  dBLK = G Wcat^T on the tensor cores,
      //    one m16 tile per m3; from the fragments dw += dBLK * mid and
      //    dmid = dBLK * w, written over the mids
      if (warp * 8 < nc) {
        const int c = warp * 8 + 2 * tig;
        int wc[2] = {0, 0};
        float wv[4] = {1.f, 1.f, 1.f, 1.f}, dw0[4] = {0.f, 0.f, 0.f, 0.f};
        if (has_w) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = gid + (q >> 1) * 8, h = q & 1;
            const bool ok = c + h < nc && e < n_rows;
            wc[h] = c + h < nc ? cols_s[(c + h) * COL_W + 3] : 0;
            wv[q] = ok ? __ldg(w + (size_t)(e0 + e) * n_ch + wc[h]) : 0.f;
            dw0[q] = ok ? dw[(size_t)(e0 + e) * n_ch + wc[h]] : 0.f;
          }
        }
        float dwa[4] = {0.f, 0.f, 0.f, 0.f};
        const float* br = B_s + (warp * 8 + gid) * ST + tig;
#pragma unroll 2
        for (int m = 0; m < d3; ++m) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          if (BF16) {
            const float* ar = G_s + (m * TE + gid) * ST + 2 * tig;
            for (int kk = 0; kk < KV; kk += 16)
              mma_bf16_rows(d, ar + kk, ST, br + tig + kk, kk + 8 < KV);
          } else {
            float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
            const float* ar = G_s + (m * TE + gid) * ST + tig;
            for (int kk = 0; kk < KV; kk += 8) {
              const float a[4] = {ar[kk], ar[8 * ST + kk], ar[kk + 4], ar[8 * ST + kk + 4]};
              const float b[2] = {br[kk], br[kk + 4]};
              mma_3xtf32(hi, lo, a, b);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) d[q] = lo[q] + hi[q];
          }
          float2* p0 = reinterpret_cast<float2*>(D_s + (m * TE + gid) * DST + c);
          float2* p1 = reinterpret_cast<float2*>(D_s + (m * TE + gid + 8) * DST + c);
          const float2 m0 = *p0, m1 = *p1;
          dwa[0] += d[0] * m0.x;
          dwa[1] += d[1] * m0.y;
          dwa[2] += d[2] * m1.x;
          dwa[3] += d[3] * m1.y;
          *p0 = make_float2(d[0] * wv[0], d[1] * wv[1]);
          *p1 = make_float2(d[2] * wv[2], d[3] * wv[3]);
        }
        if (has_w) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = gid + (q >> 1) * 8, h = q & 1;
            if (c + h < nc && e < n_rows) dw[(size_t)(e0 + e) * n_ch + wc[h]] = dw0[q] + dwa[q];
          }
        }
      }
      __syncthreads();

      // 4. dx: one thread per (edge, x group) sums its columns in order and
      //    stores the slab's dx values without a load of its own; the edge is
      //    the fastest index, so that a warp's lanes share their group's d1
      for (int idx = t; idx < TE * n_xg; idx += NT) {
        const int e = idx % TE, g = idx / TE;
        if (e >= n_rows) continue;
        const int* xg = xg_s + g * G_W;
        const int xo = xg[0], lo = xg[2] - lo0, n = xg[3];
        with_d1(xg[1], [&](auto D) {
          constexpr int d1 = decltype(D)::value;
          float acc[d1];
#pragma unroll
          for (int i = 0; i < d1; ++i) acc[i] = dx_s[e * nxp + xo + i];
          for (int j = 0; j < n; ++j) {
            const int c = lst_s[lo + j] - c0;
            const float* wr = W_s + e * sqp + cols_s[c * COL_W];
            for (int m = 0; m < d3; ++m, wr += d1) {
              const float dm = D_s[(m * TE + e) * DST + c];
#pragma unroll
              for (int i = 0; i < d1; ++i) acc[i] += dm * wr[i];
            }
          }
          float* p = dx + (size_t)(e0 + e) * d_in;
#pragma unroll
          for (int i = 0; i < d1; ++i) p[xmap_s[xo + i]] = acc[i];
        });
      }
      if (!need_dsh) continue;

      // 5. dW: one thread per (edge, slot group) owns the group's slots
      for (int idx = t; idx < TE * n_qg; idx += NT) {
        const int e = idx / n_qg, g = idx - e * n_qg;
        if (e >= n_rows) continue;
        const int* qg = qgrp + (size_t)(qg_ofs + g) * G_W;
        const int sb = __ldg(qg), lo = __ldg(qg + 2), n = __ldg(qg + 3);
        with_d1(__ldg(qg + 1), [&](auto D) {
          constexpr int d1 = decltype(D)::value;
          for (int j = 0; j < n; ++j) {
            const int c = __ldg(lst + lo + j) - c0;
            const float* xr = x_s + e * nxp + cols_s[c * COL_W + 2];
            float xv[d1];
#pragma unroll
            for (int i = 0; i < d1; ++i) xv[i] = xr[i];
            float* dr = dW_s + e * sqp + sb;
            for (int m = 0; m < d3; ++m, dr += d1) {
              const float dm = D_s[(m * TE + e) * DST + c];
#pragma unroll
              for (int i = 0; i < d1; ++i) dr[i] += operand<BF16>(dm * xv[i]);
            }
          }
        });
      }
      __syncthreads();

      // 6. dsh[e, s] += sum_j coef_j[s] dW[e, j] over the slab's slots
      for (int idx = t; idx < TE * S; idx += NT) {
        const int e = idx / S, sc = idx - e * S;
        if (e >= n_rows) continue;
        float acc = 0.f;
        for (int j = 0; j < n_sq; ++j) {
          const int* qm = sqs + j * Q_W;
          const int dd = sc - __ldg(qm + 1);
          if (dd >= 0 && dd < __ldg(qm + 2))
            acc += operand<BF16>(__ldg(coef + __ldg(qm) + dd)) * dW_s[e * sqp + j];
        }
        dsh[(size_t)(e0 + e) * S + sc] += acc;
      }
    }
  }
}

// a load the compiler does not merge with an earlier one of the same address
__device__ __forceinline__ int ld_int(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

template <bool BF16, bool STORE>
__global__ void __launch_bounds__(NT, 2) packed_tp_bwd_wcat_kernel(
    const float* __restrict__ x, const float* __restrict__ sh,
    const float* __restrict__ w, const float* __restrict__ gy,
    const float* __restrict__ coef, const int* __restrict__ grp,
    const int* __restrict__ cols, const int* __restrict__ slabs,
    const int* __restrict__ sq, const int* __restrict__ xmap,
    const int* __restrict__ items, float* __restrict__ part,
    const float* __restrict__ mids, const int2* __restrict__ mcols, int E, int d_in, int S,
    int n_ch, int d_out, int linear_numel, int sq_max, int nx_max, int stage_floats,
    int g_floats, int n_split, int tiles_per_split, int has_w, int midw) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int sqp = odd_stride(sq_max), nxp = odd_stride(nx_max);
  const int split = blockIdx.x % n_split;
  const int* item = items + 2 * (size_t)(blockIdx.x / n_split);
  const int* sl = slabs + (size_t)__ldg(item) * SLAB_W;
  const int v0 = __ldg(item + 1);
  const int c0 = sl[1], nc = sl[2], n_sq = sl[4];
  const int* sqs = sq + (size_t)sl[3] * Q_W;
  const int* xm = xmap + sl[9];
  const int nx = sl[10];
  const int* gm = grp + (size_t)sl[0] * GRP_W;
  const int d3 = gm[1];
  const int VB = min(gm[2] - v0, 8 * ITEM_N8);  // this item's V columns v0 ..
  const int g_base = gm[0] + v0 * d3;           // gy offset of column v0, m3 = 0
  const int* gcols = cols + (size_t)(gm[5] + c0) * COL_W;
  const int ST = stride_8mod16(VB), NV = round8(VB) / 8;
  const int n_tiles = (E + TE - 1) / TE;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  int* cols_s = reinterpret_cast<int*>(smem + 2 * stage_floats);
  int* xmap_s = cols_s + KS * COL_W;
  float* W_s = reinterpret_cast<float*>(xmap_s + align4(nx_max));
  float* A_s = W_s + align4(TE * sqp);
  auto stage_sh = [&](int b) { return smem + b * stage_floats; };
  auto stage_gb = [&](int b) { return stage_sh(b) + align4(TE * S); };
  auto stage_w = [&](int b) { return stage_gb(b) + align4(g_floats); };
  auto stage_xb = [&](int b) { return stage_w(b) + TE * KS; };

  // the slab's column records and x offsets, and the pad columns of G,
  // once for all its tiles
  for (int idx = t; idx < nc * COL_W; idx += NT) cols_s[idx] = __ldg(gcols + idx);
  for (int j = t; j < nx; j += NT) xmap_s[j] = __ldg(xm + j);
  zero_g_pad<NT>(stage_gb(0), ST, d3, VB);
  zero_g_pad<NT>(stage_gb(1), ST, d3, VB);
  __syncthreads();

  // sh, G, w and x rows of one tile into stage b, as cp.async copies
  auto issue = [&](int tile, int b) {
    const int e0 = tile * TE, n_rows = min(TE, E - e0);
    float* ss = stage_sh(b);
    for (int idx = t; idx < TE * S; idx += NT) {
      const bool ok = idx < n_rows * S;
      cp_async4(ss + idx, ok ? sh + (size_t)e0 * S + idx : sh, ok);
    }
    stage_g<NT>(stage_gb(b), ST, gy, d_out, g_base, d3, VB, e0, n_rows);
    if (has_w) {
      float* ws = stage_w(b);
      for (int idx = t; idx < TE * KS; idx += NT) {
        const int e = idx / KS, c = idx - e * KS;
        const bool ok = e < n_rows && c < nc;
        cp_async4(ws + idx, ok ? w + (size_t)(e0 + e) * n_ch + cols_s[c * COL_W + 3] : w, ok);
      }
    }
    stage_x<NT>(stage_xb(b), nullptr, nxp, x, nullptr, d_in, e0, n_rows, xmap_s, nullptr, nx);
    cp_async_commit();
  };

  // warp: m16 column tile mt (columns 16 mt ..), half kh of each tile's K
  const int mt = warp & 3, kh = warp >> 2;
  float acc[ITEM_N8][4];
#pragma unroll
  for (int n = 0; n < ITEM_N8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;

  if (tile0 < tile1) issue(tile0, 0);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int b = (tile - tile0) & 1;
    const int n_rows = min(TE, E - tile * TE);
    cp_async_wait_all();
    __syncthreads();  // stage b landed; the previous tile is done with W, BLK, stage b ^ 1
    if (tile + 1 < tile1) issue(tile + 1, b ^ 1);
    if (STORE) {
      load_slab<NT>(A_s, DST, mids, midw, mcols + gm[5] + c0, has_w ? stage_w(b) : nullptr, nc,
                    d3, tile * TE, n_rows);
    } else {
      stage_slots<BF16>(t, NT, W_s, nullptr, sqp, stage_sh(b), S, sqs, n_sq, coef);
      __syncthreads();
      build_slab<NT, BF16>(A_s, DST, W_s, sqp, stage_xb(b), nxp, has_w ? stage_w(b) : nullptr,
                           cols_s, nc, d3, n_rows);
    }
    __syncthreads();
    // dWcat[c, v] += sum_r BLK[r, c] G[r, v]: A operand BLK^T (rows c, read
    // [tig][gid]), B operand G; this warp's K half of the tile's d3*TE rows,
    // summed in fragments per n8 tile, then added into fp32 registers
    if (BF16 && mt * 16 < nc) {
      // bf16: one k16 step per m3 (its TE = 16 rows), the m3 alternating
      // between the two K halves
      const float* gs = stage_gb(b);
      for (int m = kh; m < d3; m += 2) {
        const float* ar = A_s + (m * TE + 2 * tig) * DST + mt * 16 + gid;
        const uint32_t a[4] = {pack_bf16(ar[0], ar[DST]), pack_bf16(ar[8], ar[DST + 8]),
                               pack_bf16(ar[8 * DST], ar[9 * DST]),
                               pack_bf16(ar[8 * DST + 8], ar[9 * DST + 8])};
        const float* gr = gs + (m * TE + 2 * tig) * ST + gid;
#pragma unroll
        for (int n = 0; n < ITEM_N8; ++n) {
          if (n < NV) {
            const uint32_t bv[2] = {pack_bf16(gr[n * 8], gr[ST + n * 8]),
                                    pack_bf16(gr[8 * ST + n * 8], gr[9 * ST + n * 8])};
            mma_bf16(acc[n], a, bv);
          }
        }
      }
    } else if (mt * 16 < nc) {
      const float* gs = stage_gb(b);
#pragma unroll
      for (int n = 0; n < ITEM_N8; ++n) {
        if (n < NV) {
          float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
          for (int ks = kh * d3; ks < (kh + 1) * d3; ++ks) {
            const float* ar = A_s + (ks * 8 + tig) * DST + mt * 16 + gid;
            const float* gr = gs + (ks * 8 + tig) * ST + n * 8 + gid;
            const float a[4] = {ar[0], ar[8], ar[4 * DST], ar[4 * DST + 8]};
            const float bv[2] = {gr[0], gr[4 * ST]};
            mma_3xtf32(hi, lo, a, bv);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[n][q] += lo[q] + hi[q];
        }
      }
    }
  }

  // the two K halves in a fixed order, then this split's partial row
  cp_async_wait_all();
  __syncthreads();
  float* red = A_s;
  if (kh == 1 && mt * 16 < nc) {
#pragma unroll
    for (int n = 0; n < ITEM_N8; ++n)
      if (n < NV)
#pragma unroll
        for (int q = 0; q < 4; ++q) red[((mt * ITEM_N8 + n) * 4 + q) * 32 + lane] = acc[n][q];
  }
  __syncthreads();
  if (kh == 0 && mt * 16 < nc) {
    // the item's records read again from the arguments, so that none of
    // them stays live in registers through the tile loop
    const int* it = items + 2 * (size_t)(blockIdx.x / n_split);
    const int* sl2 = slabs + (size_t)ld_int(it) * SLAB_W;
    const int* gm2 = grp + (size_t)ld_int(sl2) * GRP_W;
    const int V = ld_int(gm2 + 2), cb = ld_int(sl2 + 1);
    float* prow = part + (size_t)split * linear_numel + ld_int(gm2 + 3) + ld_int(it + 1);
#pragma unroll
    for (int n = 0; n < ITEM_N8; ++n) {
      if (n < NV) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = mt * 16 + gid + (q >> 1) * 8, v = n * 8 + 2 * tig + (q & 1);
          if (c < nc && v < VB)
            prow[(size_t)(cb + c) * V + v] =
                acc[n][q] + red[((mt * ITEM_N8 + n) * 4 + q) * 32 + lane];
        }
      }
    }
  }
}

// d(flat_w)[wcat_idx[k]] = wcat_scale[k] * sum_p part[p, k], splits in order
__global__ void packed_tp_bwd_reduce(const float* __restrict__ part, int n_split,
                                     int linear_numel, const float* __restrict__ scale,
                                     const int64_t* __restrict__ wcat_idx,
                                     float* __restrict__ dflat) {
  const int k = blockIdx.x * RED_NT + threadIdx.x;
  if (k >= linear_numel) return;
  float acc = 0.f;
  for (int p = 0; p < n_split; ++p) acc += part[(size_t)p * linear_numel + k];
  dflat[wcat_idx[k]] = acc * scale[k];
}

enum Pass { EDGE = 1, WCAT = 2 };

int run(int passes, const float* x, const float* sh, const float* w, const float* wcat,
        const float* gy, const float* coef, const int* grp, const int* cols,
        const int* slab_base, const int* slabs, const int* sq, const int* xmap, const int* xgrp,
        const int* qgrp, const int* lst, const int* items, const float* wcat_scale,
        const int64_t* wcat_idx, float* dx, float* dsh, float* dw, float* part, float* dflat,
        const int* grp_host, const float* mids, const int* mcols, int E, int d_in, int S,
        int n_ch, int d_out, int n_groups, int n_items, int linear_numel, int sq_max, int nx_max,
        int n_split, int has_w, int need_dsh, int midw, int bf16, void* stream) {
  if (E <= 0 || n_groups <= 0) return 0;
  if (mids && midw <= 0) return (int)cudaErrorInvalidValue;
  const int2* mc = reinterpret_cast<const int2*>(mcols);
  const int n_tiles = (E + TE - 1) / TE;
  if (n_split < 1 || n_split > n_tiles || n_items < 1 || sq_max < 0 || nx_max < 0)
    return (int)cudaErrorInvalidValue;
  const Layout lay(grp_host, n_groups);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (passes & EDGE) {
    const size_t smem = lay.edge_floats(S, sq_max, nx_max, need_dsh) * sizeof(float);
#define PACKED_TP_BWD_EDGE(PREC, STORED)                                                   \
  do {                                                                                      \
    err = cudaFuncSetAttribute(packed_tp_bwd_edge_kernel<PREC, STORED>,                      \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
    if (err != cudaSuccess) return (int)err;                                                \
    packed_tp_bwd_edge_kernel<PREC, STORED><<<n_tiles, NT, smem, st>>>(                      \
        x, sh, w, wcat, gy, coef, grp, cols, slab_base, slabs, sq, xmap, xgrp, qgrp, lst,   \
        dx, dsh, dw, mids, mc, E, d_in, S, n_ch, d_out, n_groups, sq_max, nx_max,           \
        lay.g_edge, lay.d3_max, lay.v_max, has_w, need_dsh, midw);                          \
  } while (0)
    if (bf16 && mids)
      PACKED_TP_BWD_EDGE(true, true);
    else if (bf16)
      PACKED_TP_BWD_EDGE(true, false);
    else if (mids)
      PACKED_TP_BWD_EDGE(false, true);
    else
      PACKED_TP_BWD_EDGE(false, false);
#undef PACKED_TP_BWD_EDGE
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & WCAT) {
    const size_t smem = lay.wcat_floats(S, sq_max, nx_max) * sizeof(float);
    const int tiles_per_split = (n_tiles + n_split - 1) / n_split;
#define PACKED_TP_BWD_WCAT(PREC, STORED)                                                   \
  do {                                                                                      \
    err = cudaFuncSetAttribute(packed_tp_bwd_wcat_kernel<PREC, STORED>,                      \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
    if (err != cudaSuccess) return (int)err;                                                \
    packed_tp_bwd_wcat_kernel<PREC, STORED><<<n_items * n_split, NT, smem, st>>>(            \
        x, sh, w, gy, coef, grp, cols, slabs, sq, xmap, items, part, mids, mc, E, d_in, S,  \
        n_ch, d_out, linear_numel, sq_max, nx_max, lay.stage_floats(S, nx_max), lay.g_wcat, \
        n_split, tiles_per_split, has_w, midw);                                             \
  } while (0)
    if (bf16 && mids)
      PACKED_TP_BWD_WCAT(true, true);
    else if (bf16)
      PACKED_TP_BWD_WCAT(true, false);
    else if (mids)
      PACKED_TP_BWD_WCAT(false, true);
    else
      PACKED_TP_BWD_WCAT(false, false);
#undef PACKED_TP_BWD_WCAT
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    packed_tp_bwd_reduce<<<(linear_numel + RED_NT - 1) / RED_NT, RED_NT, 0, st>>>(
        part, n_split, linear_numel, wcat_scale, wcat_idx, dflat);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block of a pass needs (pass 0: edge, 1: weight), in
// bytes, for the plan's chunk records (grp_host: the host copy of the grp
// table), its largest slab slot count and its longest compact x row.
size_t packed_tp_bwd_smem_bytes(const int* grp_host, int n_groups, int S, int sq_max,
                                int nx_max, int need_dsh, int pass) {
  const Layout lay(grp_host, n_groups);
  return (pass == 0 ? lay.edge_floats(S, sq_max, nx_max, need_dsh)
                    : lay.wcat_floats(S, sq_max, nx_max)) *
         sizeof(float);
}

int packed_tp_bwd_slab_cols(void) { return KS; }
int packed_tp_bwd_max_d1(void) { return MAXD1; }
int packed_tp_bwd_tile_edges(void) { return TE; }
// V columns of a weight-pass work item, in n8 tiles
int packed_tp_bwd_item_n8(void) { return ITEM_N8; }

// Blocks of a pass (0: edge, 1: weight) resident on one SM at this
// shared-memory size.
int packed_tp_bwd_resident_blocks(int pass, size_t smem) {
  return resident_per_sm(pass == 0 ? (const void*)packed_tp_bwd_edge_kernel<false, false>
                                   : (const void*)packed_tp_bwd_wcat_kernel<false, false>,
                         NT, smem);
}

#define PACKED_TP_BWD_PARAMS                                                                 \
  const float *x, const float *sh, const float *w, const float *wcat, const float *gy,       \
      const float *coef, const int *grp, const int *cols, const int *slab_base,              \
      const int *slabs, const int *sq, const int *xmap, const int *xgrp, const int *qgrp,    \
      const int *lst, const int *items, const float *wcat_scale, const int64_t *wcat_idx,    \
      float *dx, float *dsh, float *dw, float *part, float *dflat, const int *grp_host,      \
      const float *mids, const int *mcols, int E, int d_in, int S, int n_ch, int d_out,      \
      int n_groups, int n_items, int linear_numel, int sq_max, int nx_max, int n_split,      \
      int has_w, int need_dsh, int midw, int bf16, void *stream
#define PACKED_TP_BWD_ARGS                                                                   \
  x, sh, w, wcat, gy, coef, grp, cols, slab_base, slabs, sq, xmap, xgrp, qgrp, lst, items,   \
      wcat_scale, wcat_idx, dx, dsh, dw, part, dflat, grp_host, mids, mcols, E, d_in, S,     \
      n_ch, d_out, n_groups, n_items, linear_numel, sq_max, nx_max, n_split, has_w,         \
      need_dsh, midw, bf16, stream

// The backward: edge pass (dx, dw, dsh), weight pass and reduce (d(flat_w)).
// mids: null, or the forward's stored mids (E, midw), read in place of the
// recompute (mcols: per column its offset there and its step per m3); bf16:
// the bf16 instantiation.
int packed_tp_bwd(PACKED_TP_BWD_PARAMS) { return run(EDGE | WCAT, PACKED_TP_BWD_ARGS); }
// The edge pass alone, and the weight pass with the reduce alone (timing).
int packed_tp_bwd_edge(PACKED_TP_BWD_PARAMS) { return run(EDGE, PACKED_TP_BWD_ARGS); }
int packed_tp_bwd_wcat(PACKED_TP_BWD_PARAMS) { return run(WCAT, PACKED_TP_BWD_ARGS); }

const char* packed_tp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
