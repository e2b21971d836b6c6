// Zonal (edge-frame) TP -> radial scale -> equivariant Linear, backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_zonal.py `_zbwd_call`
// (ZonalPallasSpec._bwd_body), the backward of zonal_tp_fwd.cu.  With the
// forward's notation (an entry: a live column c of one |m3| = a, its +a and
// -a records coef_s * x_rot[e, xo_s], its radial-weight column wc) and
// gy = d(out_rot), per record (m3 = L +- a):
//
//   mid[e, m3, c]  = coef * x_rot[e, xo]                          (recomputed)
//   dBLK[e, m3, c] = sum_v gy[e, b + v*d3 + m3] Wcat[c, v]
//   dWcat[c, v]    = sum_e sum_m3 mid[e, m3, c] w[e, wc] gy[e, b + v*d3 + m3]
//   dw[e, wc]     += sum_m3 dBLK[e, m3, c] mid[e, m3, c]
//   dx_rot[e, xo] += coef * dBLK[e, m3, c] w[e, wc]
//
// The frame is data: there is no gradient to the spherical harmonics.
//
// What bounds it.  It reads x_rot, w and gy and writes dx_rot and dw once
// (~27 KB per edge at the node plan) for ~0.3 MFLOP per edge: its bound is
// the bytes.  The kernel before this one walked a block's edge tiles through
// five phases per 64-column slab, ran both products on the CUDA cores over
// every record (half of them structural zeros), and added dWcat, dx and dw
// into device memory per tile or slab: 26x its bound.
//
// What the design does about it: two passes over the entry tables of
// e3/zonal_kernel.py (only live records; an m16 row tile is (sign of m3,
// edge) over 8 edges, the +a and -a records sharing one B operand), split by
// what each output is summed over; both products on the tensor cores in
// 3xTF32 (packed_tp_mma.cuh), each product's K at most 64 and added into
// fp32 registers.
//  * Edge pass (zonal_tp_bwd_edge_kernel): a block owns one 8-edge tile, so
//    it alone writes that tile's rows of dx_rot and dw, in a fixed order and
//    without atomics.  x_rot rows are staged in shared memory once and dx_rot
//    rows summed there for the whole tile, then stored once.  Per chunk it
//    copies in the output gradient G; per stage its entry tables (a stage
//    ahead, double-buffered) and its column and x groups (at the stage's
//    start, landing during its products), so that no gather waits on a table
//    load from device memory.  Each warp computes dBLK = G Wcat^T for 8
//    entries and both signs (K = V padded to 8; the Wcat rows, one contiguous
//    block in entry order, read from device memory, where they stay in
//    cache), and from the accumulator fragments the recomputed mids (one
//    shared-memory gather each), dw's per-entry part P = dBLK+ mid+ + dBLK-
//    mid- and dmid = dBLK * w.  Then column groups sum P into dw (a stage
//    holds all entries of its columns, so dw is stored once), and x groups
//    (one thread owns an x offset) add coef * dmid into the shared dx_rot
//    rows.  Two barriers a stage.  The pass is latency-bound, so residency
//    is what it runs on: ~75 KB of shared memory at the bench node plan lets
//    three blocks share an SM (two ran it 1.4x slower on an H100; Wcat rows
//    staged in shared memory cost the edge plan a block an SM, and lost).
//  * Weight pass (zonal_tp_bwd_wcat_kernel): the grid is (work item, edge
//    split), a work item being <= 64 entries of one |m3| segment of a stage
//    and <= 32 of its chunk's V columns (host table `witems`), the heaviest
//    first, and the blocks of one edge split next to each other in the grid
//    (they share their edges' rows in cache).  A block streams its split's
//    edges, 16 a step, of gy (two rows, +a and -a), x_rot and w gathers, its
//    live columns only, through a double buffer in shared memory (cp.async);
//    a warp owns 16 entries and one sign, builds its A fragments of BLK^T
//    straight from the staged values and accumulates dWcat[16, 32] = BLK^T
//    G over its steps (K = 16 edges a step), each step's product added into
//    fp32 registers.  The two signs are added in a fixed order and the
//    item writes its part of one partial row, once.
//  * zonal_tp_bwd_reduce adds the splits in a fixed order, and per Wcat
//    element the entries that share its row (one per |m3| of its column),
//    folds in 1/sqrt(fan_in) and scatters through the Wcat index into
//    d(flat_w).  No atomics anywhere, no partial row rewritten per tile, and
//    a repeat is bit-identical.
//  * Rows past E load zeros and store nothing.
//  * BF16 = true is the instantiation of HAMGNN_TP_BF16=bwd|all: both
//    products one bf16 mma.sync m16n8k16 pass (packed_tp_mma.cuh); the
//    edge pass's K (V padded to 8) ends in a half-deep step where V is 8
//    mod 16, the weight pass takes a step's 16 edges as one k16 step.  The
//    mids, dw and dx stay fp32, as in the JAX kernel.

#include "packed_tp_mma.cuh"

namespace {

using namespace packed_tp;

constexpr int ZTE = 8;          // edges per tile: m16 rows are (sign of m3, edge)
constexpr int CAP = 128;        // entries of a stage (zonal_kernel.py STAGE_ENTRIES)
constexpr int NT = 256;         // threads per block, both passes
constexpr int NW = NT / 32;
constexpr int DST = CAP + 4;    // dmid / P row stride
constexpr int ZGRP_W = 7;       // ints per chunk record: b, d3, V, stages, wcol offset, fan_in
constexpr int STAGE_W = 14;     // ints per stage record
constexpr int CG_W = 4;         // column group: wc, add, offset, count
constexpr int XG_W = 3;         // x group: x offset, offset, count
constexpr int WITEM_W = 4;      // weight-pass item: stage, first entry, entries, first V column
constexpr int ITEM_ENT = 64;    // entries of a weight-pass item (4 m16 tiles)
constexpr int ITEM_N8 = 4;      // n8 tiles of V of a weight-pass item (32 columns)
constexpr int RED_NT = 256;     // threads per block of the reduce
constexpr int GATHER = 4;       // members of a group the edge pass's gathers read together

// ---------------------------------------------------------------- layouts

// A stage's entry tables in the edge pass's shared memory, in words: its
// entries' int4 and float2 records.
constexpr int T_EI = 0, T_EC = T_EI + 4 * CAP, T_ENT = T_EC + 2 * CAP;

// A stage's group tables, packed: column groups, their members, x groups,
// their members and coefficients, each part on a 16-byte boundary.
// (zonal_kernel.py tgrp_words: the most words a stage of the plan packs)
struct GroupLayout {
  int cg, cl, xg, xl, xc;
  __device__ explicit GroupLayout(const int* __restrict__ sm) {
    cg = 0;
    cl = align4(CG_W * __ldg(sm + 6));
    xg = cl + align4(__ldg(sm + 11));
    xl = xg + align4(XG_W * __ldg(sm + 8));
    xc = xl + align4(__ldg(sm + 13));
  }
};

// x and dx row stride: 4 mod 8 words where d_in is a multiple of 4 (rows
// copied in 16-byte pieces; the 8 edges' rows fall on distinct banks), else odd
__host__ __device__ inline int x_stride(int d_in) {
  return (d_in & 3) ? odd_stride(d_in) : stride_4mod8(d_in);
}

// edge pass: x rows [ZTE][xst(d_in)] | dx rows [ZTE][xst(d_in)] |
//            G [d3][ZTE][stride_4mod8(V)] (gmax floats per edge) |
//            dmid [16][DST] | P [ZTE][DST] | 2 x entry tables [T_ENT] |
//            group tables [tgrp words, the most a stage of the plan packs]
// (at the bench node plan ~75 KB, so that three blocks share an SM)
struct EdgeLayout {
  int xrow, g, tgrp;
  __host__ __device__ EdgeLayout(int d_in, int gmax, int tgrp_words)
      : xrow(align4(ZTE * x_stride(d_in))), g(align4(ZTE * gmax)), tgrp(align4(tgrp_words)) {}
  __host__ __device__ size_t floats() const {
    return 2 * (size_t)xrow + g + 16 * DST + ZTE * DST + 2 * T_ENT + tgrp;
  }
};

// weight pass: 2 x stage (G [2 WTE][GW] | x [2 WTE][XW] | w [WTE][XW]) |
//              x offsets [2][ITEM_ENT] | wc [ITEM_ENT] | sign exchange
constexpr int WTE = 16;                  // edges per weight-pass step (two 8-edge k-steps)
constexpr int GW = 40;                   // stride_8mod16(32): G read [row tig][v gid]
constexpr int XW = 72;                   // stride_8mod16(64): x, w read [row tig][entry gid]
constexpr int WSTAGE = 2 * WTE * GW + 2 * WTE * XW + WTE * XW;
constexpr int RED_FLOATS = 4 * ITEM_N8 * 4 * 32;
constexpr size_t wcat_floats() { return 2 * (size_t)WSTAGE + 3 * ITEM_ENT + RED_FLOATS; }

// ---------------------------------------------------------------- edge pass

// The tile's rows of x (d_in floats each, contiguous in device memory) into
// rows of stride xst, 16 bytes a copy where d_in is a multiple of 4; zero
// past n_rows.
__device__ inline void stage_rows(float* xs, int xst, const float* __restrict__ x, int d_in,
                                  int e0, int n_rows) {
  const float* xg = x + (size_t)e0 * d_in;
  if ((d_in & 3) == 0) {
    const int d4 = d_in / 4;
    for (int idx = threadIdx.x; idx < ZTE * d4; idx += NT) {
      const int e = idx / d4, i = 4 * (idx - e * d4);
      cp_async16(xs + e * xst + i, e < n_rows ? xg + (size_t)e * d_in + i : x, e < n_rows);
    }
  } else {
    for (int idx = threadIdx.x; idx < ZTE * d_in; idx += NT) {
      const int e = idx / d_in;
      cp_async4(xs + e * xst + idx - e * d_in, e < n_rows ? xg + idx : x, e < n_rows);
    }
  }
}

// A chunk's output gradient, as cp.async copies: G[(m3 * ZTE + e) * gst + v]
// = gy[e0 + e, b + v * d3 + m3], zero past n_rows and for V <= v < round8(V).
__device__ inline void stage_gz(float* G, int gst, const float* __restrict__ gy, int d_out,
                                int b, int d3, int V, int e0, int n_rows) {
  const int KV = round8(V), row = KV * d3;
  for (int idx = threadIdx.x; idx < ZTE * row; idx += NT) {
    const int e = idx / row, o = idx - e * row;
    const int m = o / KV, v = o - m * KV;
    const bool ok = e < n_rows && v < V;
    cp_async4(G + (m * ZTE + e) * gst + v, ok ? gy + (size_t)(e0 + e) * d_out + b + v * d3 + m : gy,
              ok);
  }
}

// Contiguous words into shared memory in 16-byte copies (both addresses on a
// 16-byte boundary; the host pads each stage's lists so that they are).
__device__ inline void copy_words(int* dst, const int* __restrict__ src, int n) {
  for (int idx = 4 * threadIdx.x; idx < n; idx += 4 * NT)
    cp_async16(reinterpret_cast<float*>(dst + idx), reinterpret_cast<const float*>(src) + idx,
               true);
}

// A stage's entry tables into buffer T (layout T_*), as cp.async copies.
__device__ inline void stage_entries(int* T, const int* __restrict__ sm,
                                     const int* __restrict__ ent_i,
                                     const float* __restrict__ ent_c) {
  const int ent0 = __ldg(sm + 1), n = __ldg(sm + 2);
  copy_words(T + T_EI, ent_i + 4 * (size_t)ent0, 4 * n);
  copy_words(T + T_EC, reinterpret_cast<const int*>(ent_c) + 2 * (size_t)ent0, 2 * n);
}

// A stage's group tables into T (GroupLayout), as cp.async copies.
__device__ inline void stage_groups(int* T, const int* __restrict__ sm, const GroupLayout& gl,
                                    const int* __restrict__ cgrp, const int* __restrict__ clst,
                                    const int* __restrict__ xgrp, const int* __restrict__ xlst,
                                    const float* __restrict__ xcoef) {
  const int cg_ofs = __ldg(sm + 5), n_cg = __ldg(sm + 6), xg_ofs = __ldg(sm + 7);
  const int n_xg = __ldg(sm + 8), cl_ofs = __ldg(sm + 10), n_cl = __ldg(sm + 11);
  const int xl_ofs = __ldg(sm + 12), n_xl = __ldg(sm + 13);
  copy_words(T + gl.cg, cgrp + CG_W * (size_t)cg_ofs, CG_W * n_cg);
  copy_words(T + gl.cl, clst + cl_ofs, n_cl);
  copy_words(T + gl.xg, xgrp + XG_W * (size_t)xg_ofs, XG_W * n_xg);
  copy_words(T + gl.xl, xlst + xl_ofs, n_xl);
  copy_words(T + gl.xc, reinterpret_cast<const int*>(xcoef) + xl_ofs, n_xl);
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 3) zonal_tp_bwd_edge_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ went, const float* __restrict__ gy,
    const int* __restrict__ zgrp, const int* __restrict__ stages,
    const int* __restrict__ ent_i, const float* __restrict__ ent_c,
    const int* __restrict__ wcol, const int* __restrict__ cgrp, const int* __restrict__ clst,
    const int* __restrict__ xgrp, const int* __restrict__ xlst,
    const float* __restrict__ xcoef, float* __restrict__ dx, float* __restrict__ dw, int E,
    int d_in, int n_ch, int d_out, int n_chunks, int gmax, int tgrp_words, int has_w) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int e0 = blockIdx.x * ZTE;
  const int n_rows = min(ZTE, E - e0);
  const int XST = x_stride(d_in);
  const EdgeLayout lay(d_in, gmax, tgrp_words);
  float* x_s = smem;
  float* dx_s = x_s + lay.xrow;
  float* G_s = dx_s + lay.xrow;
  float* D_s = G_s + lay.g;
  float* P_s = D_s + 16 * DST;
  int* T_s = reinterpret_cast<int*>(P_s + ZTE * DST);  // [2][T_ENT]
  int* Tg_s = T_s + 2 * T_ENT;                          // [tgrp_words]

  // the tile's x_rot rows, dx_rot rows zeroed, the first chunk's G and the
  // first stage's entry tables (a chunk without live entries has no stage)
  stage_rows(x_s, XST, x, d_in, e0, n_rows);
  for (int idx = t; idx < ZTE * XST; idx += NT) dx_s[idx] = 0.f;
  int k = 0, si = __ldg(zgrp + 3);
  while (k < n_chunks && si >= __ldg(zgrp + k * ZGRP_W + 4)) {
    if (++k < n_chunks) si = __ldg(zgrp + k * ZGRP_W + 3);
  }
  if (k < n_chunks) {
    const int* gm = zgrp + k * ZGRP_W;
    const int V = __ldg(gm + 2);
    stage_gz(G_s, round8(V) + 4, gy, d_out, __ldg(gm), __ldg(gm + 1), V, e0, n_rows);
    stage_entries(T_s, stages + (size_t)si * STAGE_W, ent_i, ent_c);
  }
  cp_async_commit();

  for (int buf = 0; k < n_chunks; buf ^= 1) {
    const int* gm = zgrp + k * ZGRP_W;
    const int d3 = __ldg(gm + 1), V = __ldg(gm + 2), col_ofs = __ldg(gm + 5);
    const int L = (d3 - 1) >> 1, ST = round8(V) + 4, KV = round8(V);
    const int* sm = stages + (size_t)si * STAGE_W;
    const int n = __ldg(sm + 2), n_cg = __ldg(sm + 6), n_xg = __ldg(sm + 8);
    const int cl_ofs = __ldg(sm + 10), xl_ofs = __ldg(sm + 12);
    const float* wrow = went + __ldg(sm + 9);
    const int* T = T_s + buf * T_ENT;
    const int4* ei_s = reinterpret_cast<const int4*>(T + T_EI);
    const float2* ec_s = reinterpret_cast<const float2*>(T + T_EC);
    const GroupLayout gl(sm);
    cp_async_wait_all();
    __syncthreads();  // G, this stage's entries (and x rows) landed; the previous gathers are done

    // 1. the next stage's entry tables into the other buffer, and this
    //    stage's group tables (their last readers, the previous stage's
    //    gathers, are done): both land during the products
    int kn = k, sn = si + 1;
    while (kn < n_chunks && sn >= __ldg(zgrp + kn * ZGRP_W + 4)) {
      if (++kn < n_chunks) sn = __ldg(zgrp + kn * ZGRP_W + 3);
    }
    if (kn < n_chunks)
      stage_entries(T_s + (buf ^ 1) * T_ENT, stages + (size_t)sn * STAGE_W, ent_i, ent_c);
    stage_groups(Tg_s, sm, gl, cgrp, clst, xgrp, xlst, xcoef);
    cp_async_commit();

    // 2. warp w: entry tiles w, w + NW, ... of the stage.  dBLK = G Wcat^T
    //    for both signs (rows gid: +a, gid + 8: -a; the Wcat rows, one
    //    contiguous block in entry order, read from device memory, where
    //    they stay in cache), then from the fragments P = dBLK+ mid+ +
    //    dBLK- mid- and dmid = dBLK * w
    for (int nt = warp; nt * 8 < n; nt += NW) {
      const int a = ei_s[nt * 8].w;
      const float* gp = G_s + ((L + a) * ZTE + gid) * ST + tig;
      const float* gq = G_s + ((L - a) * ZTE + gid) * ST + tig;
      const float* br = wrow + (size_t)(nt * 8 + gid) * V + tig;
      // the radial weights first, so that their loads overlap the product
      float wv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wv[h] = has_w && gid < n_rows
                    ? __ldg(w + (size_t)(e0 + gid) * n_ch +
                            __ldg(wcol + col_ofs + ei_s[nt * 8 + 2 * tig + h].z))
                    : (has_w ? 0.f : 1.f);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (BF16) {
        // A rows gid (+a) and gid + 8 (-a); B (n = entry, k = v) rows of Wcat
        const float* ga = gp + tig;
        const float* gb = gq + tig;
        const float* bb = br + tig;
        for (int kk = 0; kk < KV; kk += 16) {
          const bool up = kk + 8 < KV;
          const int k0 = kk + 2 * tig;
          const uint32_t a[4] = {pack_bf16(ga[kk], ga[kk + 1]), pack_bf16(gb[kk], gb[kk + 1]),
                                 up ? pack_bf16(ga[kk + 8], ga[kk + 9]) : 0u,
                                 up ? pack_bf16(gb[kk + 8], gb[kk + 9]) : 0u};
          const uint32_t b[2] = {
              pack_bf16(k0 < V ? __ldg(bb + kk) : 0.f, k0 + 1 < V ? __ldg(bb + kk + 1) : 0.f),
              up ? pack_bf16(k0 + 8 < V ? __ldg(bb + kk + 8) : 0.f,
                             k0 + 9 < V ? __ldg(bb + kk + 9) : 0.f)
                 : 0u};
          mma_bf16(d, a, b);
        }
      }
      for (int kq = 0; kq < (BF16 ? 0 : KV); kq += 64) {
        const int kend = min(KV, kq + 64);
        float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
        float lo2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int kk = kq; kk < kend; kk += 8) {
          const float av[4] = {gp[kk], gq[kk], gp[kk + 4], gq[kk + 4]};
          const float bv[2] = {kk + tig < V ? __ldg(br + kk) : 0.f,
                               kk + tig + 4 < V ? __ldg(br + kk + 4) : 0.f};
          mma_3xtf32(hi, lo, lo2, av, bv);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] += (lo[q] + lo2[q]) + hi[q];
      }
      const float* xr = x_s + gid * XST;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = nt * 8 + 2 * tig + h;
        const int4 ei = ei_s[j];
        const float2 cf = ec_s[j];
        P_s[gid * DST + j] = d[h] * (cf.x * xr[ei.x]) + d[2 + h] * (cf.y * xr[ei.y]);
        D_s[gid * DST + j] = d[h] * wv[h];
        D_s[(ZTE + gid) * DST + j] = d[2 + h] * wv[h];
      }
    }
    cp_async_wait_all();
    __syncthreads();  // dmid, P and the group tables ready; G is free

    // 3. the next chunk's G, overlapping the gathers
    if (kn < n_chunks && kn != k) {
      const int* gn = zgrp + kn * ZGRP_W;
      const int Vn = __ldg(gn + 2);
      stage_gz(G_s, round8(Vn) + 4, gy, d_out, __ldg(gn), __ldg(gn + 1), Vn, e0, n_rows);
    }
    cp_async_commit();

    // 4. gathers from the staged tables, one thread per (edge, group), the
    //    edge fastest (a group's record and members are read once for 8
    //    lanes; the group fastest was slower on an H100): dw per column
    //    group (stored once, or added where an earlier chunk wrote the
    //    column), dx_rot per x group into the shared rows
    const int* cg_s = Tg_s + gl.cg;
    const int* cl_s = Tg_s + gl.cl;
    const int* xg_s = Tg_s + gl.xg;
    const int* xl_s = Tg_s + gl.xl;
    const float* xc_s = reinterpret_cast<const float*>(Tg_s + gl.xc);
    for (int idx = t; idx < ZTE * (n_cg + n_xg); idx += NT) {
      const int e = idx & (ZTE - 1), g = idx >> 3;
      // (the first GATHER members of a group are read together, predicated;
      // the bench plans' groups have at most 5 members)
      if (g < n_cg) {
        if (!has_w || e >= n_rows) continue;
        const int* cg = cg_s + g * CG_W;
        const int* mem = cl_s + cg[2] - cl_ofs;
        const int cnt = cg[3];
        float pv[GATHER];
#pragma unroll
        for (int j = 0; j < GATHER; ++j) pv[j] = j < cnt ? P_s[e * DST + mem[j]] : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < GATHER; ++j) acc += pv[j];
        for (int j = GATHER; j < cnt; ++j) acc += P_s[e * DST + mem[j]];
        float* p = dw + (size_t)(e0 + e) * n_ch + cg[0];
        *p = cg[1] ? *p + acc : acc;
      } else {
        const int* xg = xg_s + (g - n_cg) * XG_W;
        const int lo = xg[1] - xl_ofs, cnt = xg[2];
        float dv[GATHER];
#pragma unroll
        for (int j = 0; j < GATHER; ++j) {
          const int code = j < cnt ? xl_s[lo + j] : 0;  // sign * CAP + entry
          dv[j] = j < cnt ? xc_s[lo + j] * D_s[((code / CAP) * ZTE + e) * DST + code % CAP] : 0.f;
        }
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < GATHER; ++j) acc += dv[j];
        for (int j = GATHER; j < cnt; ++j) {
          const int code = xl_s[lo + j];
          acc += xc_s[lo + j] * D_s[((code / CAP) * ZTE + e) * DST + code % CAP];
        }
        dx_s[e * XST + xg[0]] += acc;
      }
    }
    k = kn;
    si = sn;
  }

  // 5. the tile's dx_rot rows, once
  cp_async_wait_all();
  __syncthreads();
  if ((d_in & 3) == 0) {
    const int d4 = d_in / 4;
    for (int idx = t; idx < n_rows * d4; idx += NT) {
      const int e = idx / d4, i = 4 * (idx - e * d4);
      *reinterpret_cast<float4*>(dx + (size_t)(e0 + e) * d_in + i) =
          *reinterpret_cast<const float4*>(dx_s + e * XST + i);
    }
  } else {
    for (int idx = t; idx < n_rows * d_in; idx += NT) {
      const int e = idx / d_in;
      dx[(size_t)e0 * d_in + idx] = dx_s[e * XST + idx - e * d_in];
    }
  }
}

// ---------------------------------------------------------------- weight pass

template <bool BF16>
__global__ void __launch_bounds__(NT, 4) zonal_tp_bwd_wcat_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ gy, const int* __restrict__ zgrp,
    const int* __restrict__ stages, const int4* __restrict__ ent_i,
    const float2* __restrict__ ent_c, const int* __restrict__ wcol,
    const int* __restrict__ items, float* __restrict__ part, int E, int d_in, int n_ch,
    int d_out, int n_went, int n_items, int tiles_per_split, int has_w) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // split-major: the blocks running together share their edges' rows in cache
  const int split = blockIdx.x / n_items;
  const int* item = items + (size_t)(blockIdx.x - split * n_items) * WITEM_W;
  const int si = __ldg(item), q0 = __ldg(item + 1), nq = __ldg(item + 2), v0 = __ldg(item + 3);
  const int* sm = stages + (size_t)si * STAGE_W;
  const int* gm = zgrp + (size_t)__ldg(sm) * ZGRP_W;
  const int b = __ldg(gm), d3 = __ldg(gm + 1), V = __ldg(gm + 2);
  const int ent0 = __ldg(sm + 1) + q0, went0 = __ldg(sm + 9) + q0 * V + v0;
  const int L = (d3 - 1) >> 1, a = __ldg(ent_i + ent0).w;
  const int VB = min(V - v0, 8 * ITEM_N8), NV = (VB + 7) / 8;
  const int n_rows_sign = a > 0 ? 2 * WTE : WTE;  // G and x rows copied: -a only for a > 0
  const int n_tiles = (E + WTE - 1) / WTE;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  int* xo_s = reinterpret_cast<int*>(smem + 2 * WSTAGE);  // [2][ITEM_ENT]
  int* wc_s = xo_s + 2 * ITEM_ENT;                         // [ITEM_ENT]
  float* red = reinterpret_cast<float*>(wc_s + ITEM_ENT);
  auto stage_g = [&](int bf) { return smem + bf * WSTAGE; };
  auto stage_x = [&](int bf) { return stage_g(bf) + 2 * WTE * GW; };
  auto stage_w = [&](int bf) { return stage_x(bf) + 2 * WTE * XW; };

  // once: the item's x offsets and radial-weight columns; both buffers
  // zeroed, so that the pad columns (v >= VB, entries >= nq, the -a rows of
  // a = 0), which no copy writes, read as zeros; the w rows of a plan
  // without radial weights are ones
  const int* wc_chunk = wcol + __ldg(gm + 5);
  for (int j = t; j < ITEM_ENT; j += NT) {
    const int4 ei = j < nq ? __ldg(ent_i + ent0 + j) : make_int4(0, 0, 0, 0);
    xo_s[j] = ei.x;
    xo_s[ITEM_ENT + j] = ei.y;
    wc_s[j] = __ldg(wc_chunk + ei.z);
  }
  for (int idx = t; idx < 2 * WSTAGE; idx += NT) smem[idx] = 0.f;
  __syncthreads();
  if (!has_w)
    for (int idx = t; idx < 2 * WTE * XW; idx += NT)
      stage_w(idx / (WTE * XW))[idx % (WTE * XW)] = 1.f;

  // gy (rows +a, and -a for a > 0), x_rot and w gathers of one step's 16
  // edges into buffer bf, the item's live columns only (rows past E
  // zero-filled); row r of G and x: sign r / WTE, edge r % WTE
  auto issue = [&](int tile, int bf) {
    const int e0 = tile * WTE, n_rows = min(WTE, E - e0);
    float* gs = stage_g(bf);
    for (int idx = t; idx < n_rows_sign * VB; idx += NT) {
      const int r = idx / VB, v = idx - r * VB;
      const int e = r & (WTE - 1), m3 = (r >= WTE) ? L - a : L + a;
      const bool ok = e < n_rows;
      cp_async4(gs + r * GW + v, ok ? gy + (size_t)(e0 + e) * d_out + b + (v0 + v) * d3 + m3 : gy,
                ok);
    }
    float* xs = stage_x(bf);
    for (int idx = t; idx < n_rows_sign * nq; idx += NT) {
      const int r = idx / nq, j = idx - r * nq, e = r & (WTE - 1);
      const bool ok = e < n_rows;
      cp_async4(xs + r * XW + j,
                ok ? x + (size_t)(e0 + e) * d_in + xo_s[(r >= WTE) * ITEM_ENT + j] : x, ok);
    }
    if (has_w) {
      float* ws = stage_w(bf);
      for (int idx = t; idx < WTE * nq; idx += NT) {
        const int e = idx / nq, j = idx - e * nq;
        const bool ok = e < n_rows;
        cp_async4(ws + e * XW + j, ok ? w + (size_t)(e0 + e) * n_ch + wc_s[j] : w, ok);
      }
    }
    cp_async_commit();
  };

  // warp: entries mt * 16 .. + 15 of the item, sign kh (rows kh * WTE ..)
  const int mt = warp & 3, kh = warp >> 2;
  const int j0 = mt * 16 + gid, j1 = j0 + 8;
  const float c0 = j0 < nq ? (kh ? __ldg(ent_c + ent0 + j0).y : __ldg(ent_c + ent0 + j0).x) : 0.f;
  const float c1 = j1 < nq ? (kh ? __ldg(ent_c + ent0 + j1).y : __ldg(ent_c + ent0 + j1).x) : 0.f;
  const bool active = mt * 16 < nq && (kh == 0 || a > 0);
  float acc[ITEM_N8][4];
#pragma unroll
  for (int nn = 0; nn < ITEM_N8; ++nn)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nn][q] = 0.f;

  if (tile0 < tile1) issue(tile0, 0);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int bf = (tile - tile0) & 1;
    cp_async_wait_all();
    __syncthreads();  // buffer bf landed; the previous step is done with buffer bf ^ 1
    if (tile + 1 < tile1) issue(tile + 1, bf ^ 1);
    if (!active) continue;
    // A = BLK^T (rows: entries j0, j1; K: this sign's edges 8 ks + tig, + 4)
    const float* xs = stage_x(bf) + kh * WTE * XW;
    const float* ws = stage_w(bf);
    float av[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int r0 = (8 * ks + tig) * XW, r1 = r0 + 4 * XW;
      av[ks][0] = c0 * xs[r0 + j0] * ws[r0 + j0];
      av[ks][1] = c1 * xs[r0 + j1] * ws[r0 + j1];
      av[ks][2] = c0 * xs[r1 + j0] * ws[r1 + j0];
      av[ks][3] = c1 * xs[r1 + j1] * ws[r1 + j1];
    }
    if (BF16) {
      // one k16 step over the 16 edges: a0 (entry j0, edges 2 tig, 2 tig + 1),
      // a1 (j1, ..), a2 (j0, + 8), a3 (j1, + 8); the operands rounded to bf16
      float ev[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = (2 * tig + 8 * h) * XW, r1 = r0 + XW;
        ev[h][0] = c0 * xs[r0 + j0] * ws[r0 + j0];
        ev[h][1] = c0 * xs[r1 + j0] * ws[r1 + j0];
        ev[h][2] = c1 * xs[r0 + j1] * ws[r0 + j1];
        ev[h][3] = c1 * xs[r1 + j1] * ws[r1 + j1];
      }
      const uint32_t a[4] = {pack_bf16(ev[0][0], ev[0][1]), pack_bf16(ev[0][2], ev[0][3]),
                             pack_bf16(ev[1][0], ev[1][1]), pack_bf16(ev[1][2], ev[1][3])};
      const float* gr = stage_g(bf) + (kh * WTE + 2 * tig) * GW + gid;
#pragma unroll
      for (int nn = 0; nn < ITEM_N8; ++nn) {
        if (nn < NV) {
          const uint32_t bv[2] = {pack_bf16(gr[nn * 8], gr[GW + nn * 8]),
                                  pack_bf16(gr[8 * GW + nn * 8], gr[9 * GW + nn * 8])};
          mma_bf16(acc[nn], a, bv);
        }
      }
      continue;
    }
    const float* gs = stage_g(bf) + (kh * WTE + tig) * GW + gid;
#pragma unroll
    for (int nn = 0; nn < ITEM_N8; ++nn) {
      if (nn < NV) {
        float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
        float lo2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const float bv[2] = {gs[8 * ks * GW + nn * 8], gs[(8 * ks + 4) * GW + nn * 8]};
          mma_3xtf32(hi, lo, lo2, av[ks], bv);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nn][q] += (lo[q] + lo2[q]) + hi[q];
      }
    }
  }

  // the two signs in a fixed order (+a, then -a), then this split's part of
  // its partial row
  cp_async_wait_all();
  __syncthreads();
  if (kh == 1 && mt * 16 < nq) {
#pragma unroll
    for (int nn = 0; nn < ITEM_N8; ++nn)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[((mt * ITEM_N8 + nn) * 4 + q) * 32 + lane] = acc[nn][q];
  }
  __syncthreads();
  if (kh == 0 && mt * 16 < nq) {
    float* prow = part + (size_t)split * n_went + went0;
#pragma unroll
    for (int nn = 0; nn < ITEM_N8; ++nn) {
      if (nn < NV) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = mt * 16 + gid + (q >> 1) * 8, v = nn * 8 + 2 * tig + (q & 1);
          if (j < nq && v < VB)
            prow[(size_t)j * V + v] = acc[nn][q] + red[((mt * ITEM_N8 + nn) * 4 + q) * 32 + lane];
        }
      }
    }
  }
}

// d(flat_w)[wcat_idx[i]] = wcat_scale[i] * sum_p sum_{j in red_lst[i]} part[p, j]:
// splits in order, each over the entries that share the element's Wcat row
__global__ void zonal_tp_bwd_reduce(const float* __restrict__ part, int n_split, int n_went,
                                    int n_wcat, const int* __restrict__ red_ofs,
                                    const int* __restrict__ red_lst,
                                    const float* __restrict__ scale,
                                    const int64_t* __restrict__ wcat_idx,
                                    float* __restrict__ dflat) {
  const int i = blockIdx.x * RED_NT + threadIdx.x;
  if (i >= n_wcat) return;
  const int lo = red_ofs[i], hi = red_ofs[i + 1];
  float acc = 0.f;
  for (int p = 0; p < n_split; ++p)
    for (int j = lo; j < hi; ++j) acc += part[(size_t)p * n_went + red_lst[j]];
  dflat[wcat_idx[i]] = acc * scale[i];
}

enum Pass { EDGE = 1, WCAT = 2 };

int run(int passes, const float* x, const float* w, const float* went, const float* gy,
        const int* zgrp, const int* stages, const int* ent_i, const float* ent_c,
        const int* wcol, const int* cgrp, const int* clst, const int* xgrp,
        const int* xlst, const float* xcoef, const int* witems, const int* red_ofs,
        const int* red_lst, const int64_t* wcat_idx, const float* wcat_scale, float* dx,
        float* dw, float* part, float* dflat, int E, int d_in, int n_ch, int d_out,
        int n_chunks, int n_witems, int n_wcat, int n_went, int gmax, int tgrp_words,
        int n_split, int has_w, int bf16, void* stream) {
  if (E <= 0 || n_chunks <= 0) return 0;
  const int n_tiles = (E + ZTE - 1) / ZTE;
  if (n_split < 1 || n_split > (E + WTE - 1) / WTE || n_witems < 1 || d_in < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int4* ei = reinterpret_cast<const int4*>(ent_i);
  const float2* ec = reinterpret_cast<const float2*>(ent_c);
  cudaError_t err;
  if (passes & EDGE) {
    const size_t smem = EdgeLayout(d_in, gmax, tgrp_words).floats() * sizeof(float);
    err = cudaFuncSetAttribute(bf16 ? zonal_tp_bwd_edge_kernel<true>
                                    : zonal_tp_bwd_edge_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
#define ZONAL_TP_BWD_EDGE(B)                                                                \
  zonal_tp_bwd_edge_kernel<B><<<n_tiles, NT, smem, st>>>(                                    \
      x, w, went, gy, zgrp, stages, ent_i, ent_c, wcol, cgrp, clst, xgrp, xlst, xcoef, dx,  \
      dw, E, d_in, n_ch, d_out, n_chunks, gmax, tgrp_words, has_w)
    if (bf16)
      ZONAL_TP_BWD_EDGE(true);
    else
      ZONAL_TP_BWD_EDGE(false);
#undef ZONAL_TP_BWD_EDGE
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & WCAT) {
    const size_t smem = wcat_floats() * sizeof(float);
    err = cudaFuncSetAttribute(bf16 ? zonal_tp_bwd_wcat_kernel<true>
                                    : zonal_tp_bwd_wcat_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int w_tiles = (E + WTE - 1) / WTE;
    const int tiles_per_split = (w_tiles + n_split - 1) / n_split;
#define ZONAL_TP_BWD_WCAT(B)                                                                \
  zonal_tp_bwd_wcat_kernel<B><<<n_witems * n_split, NT, smem, st>>>(                         \
      x, w, gy, zgrp, stages, ei, ec, wcol, witems, part, E, d_in, n_ch, d_out, n_went,      \
      n_witems, tiles_per_split, has_w)
    if (bf16)
      ZONAL_TP_BWD_WCAT(true);
    else
      ZONAL_TP_BWD_WCAT(false);
#undef ZONAL_TP_BWD_WCAT
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    zonal_tp_bwd_reduce<<<(n_wcat + RED_NT - 1) / RED_NT, RED_NT, 0, st>>>(
        part, n_split, n_went, n_wcat, red_ofs, red_lst, wcat_scale, wcat_idx, dflat);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block of a pass needs (0: edge, 1: weight), in bytes:
// gmax is the most floats of a chunk's output gradient per edge and
// tgrp_words the most words of a stage's packed group tables in the edge
// pass (zonal_kernel.py gmax, tgrp_words).
size_t zonal_tp_bwd_smem_bytes(int d_in, int gmax, int tgrp_words, int pass) {
  return (pass == 0 ? EdgeLayout(d_in, gmax, tgrp_words).floats() : wcat_floats()) *
         sizeof(float);
}

int zonal_tp_bwd_tile_edges(void) { return ZTE; }
int zonal_tp_bwd_stage_entries(void) { return CAP; }
// entries and n8 tiles of V of a weight-pass work item
int zonal_tp_bwd_item_entries(void) { return ITEM_ENT; }
int zonal_tp_bwd_item_n8(void) { return ITEM_N8; }
// edges of a weight-pass step (its edge splits count these)
int zonal_tp_bwd_wcat_tile_edges(void) { return WTE; }

// Blocks of a pass (0: edge, 1: weight) resident on one SM at this
// shared-memory size.
int zonal_tp_bwd_resident_blocks(int pass, size_t smem) {
  return resident_per_sm(pass == 0 ? (const void*)zonal_tp_bwd_edge_kernel<false>
                                   : (const void*)zonal_tp_bwd_wcat_kernel<false>,
                         NT, smem);
}

#define ZONAL_TP_BWD_PARAMS                                                                  \
  const float *x, const float *w, const float *went, const float *gy, const int *zgrp,       \
      const int *stages, const int *ent_i, const float *ent_c, const int *wcol,              \
      const int *cgrp, const int *clst, const int *xgrp, const int *xlst, const float *xcoef, \
      const int *witems, const int *red_ofs, const int *red_lst, const int64_t *wcat_idx,    \
      const float *wcat_scale, float *dx, float *dw, float *part, float *dflat, int E,        \
      int d_in, int n_ch, int d_out, int n_chunks, int n_witems, int n_wcat, int n_went,     \
      int gmax, int tgrp_words, int n_split, int has_w, int bf16, void *stream
#define ZONAL_TP_BWD_ARGS                                                                    \
  x, w, went, gy, zgrp, stages, ent_i, ent_c, wcol, cgrp, clst, xgrp, xlst, xcoef, witems,   \
      red_ofs, red_lst, wcat_idx, wcat_scale, dx, dw, part, dflat, E, d_in, n_ch, d_out,     \
      n_chunks, n_witems, n_wcat, n_went, gmax, tgrp_words, n_split, has_w, bf16, stream

// The backward: edge pass (dx_rot, dw), weight pass and reduce (d(flat_w));
// bf16: the bf16 instantiation.
int zonal_tp_bwd(ZONAL_TP_BWD_PARAMS) { return run(EDGE | WCAT, ZONAL_TP_BWD_ARGS); }
// The edge pass alone, and the weight pass with the reduce alone (timing).
int zonal_tp_bwd_edge(ZONAL_TP_BWD_PARAMS) { return run(EDGE, ZONAL_TP_BWD_ARGS); }
int zonal_tp_bwd_wcat(ZONAL_TP_BWD_PARAMS) { return run(WCAT, ZONAL_TP_BWD_ARGS); }

const char* zonal_tp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
