// Zonal (edge-frame) TP -> radial scale -> equivariant Linear, forward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_zonal.py `_zfwd_call`
// (ZonalPallasSpec._fwd_body / _mids).  Its input is x already rotated into
// the edge frame, where the spherical harmonics are a constant and a CG
// contraction couples m1 = +-m3 only.  Per edge e and output chunk (b, d3, V),
// with L = (d3 - 1) / 2, a live record of row m3 = L +- a and column c is one
// scaled gather, and the output is its product with the chunk's Wcat block:
//
//   BLK[e, L+-a, c] = coef * x_rot[e, xo] * w[e, wc(c)]          (w optional)
//   out_rot[e, b + v*d3 + m3] = sum_c BLK[e, m3, c] * Wcat[c, v]
//
// The rotations themselves (batched Wigner-D products) run outside, as they
// do in the JAX package.
//
// What bounds it.  The function moves x_rot, w and out_rot once (14 KB per
// edge at the node plan) for ~0.15 MFLOP per edge: its bound is the bytes.
// The kernel before this one ran the dense product on the CUDA cores over
// every (m3, column) record, half of them structural zeros, one block per
// (edge tile, output chunk), so each block gathered the x_rot row anew: 15x
// its bound.
//
// What the design does about it (host tables: e3/zonal_kernel.py).
//  * Only live records.  The live columns of row L + a are those of L - a, so
//    the tables list *entries*: a live column of one |m3| = a, with the x
//    offset and coefficient of each of its two records.  Both records share
//    the radial weight and the Wcat row.  An m16 row tile of the product is
//    (sign of m3, edge) over 8 edges: rows 0-7 the +a records, 8-15 the -a
//    records, one B operand (the entries' Wcat rows) for both.  Structural
//    zeros are never built, read or multiplied; K is a segment's entry count
//    padded to 8 (a pad entry has coefficient 0 and builds no load).
//  * A block owns one 8-edge tile and walks every work item of the plan
//    (every output chunk), so x_rot is read from device memory once: its rows
//    are staged in shared memory, as are the radial weights of a chunk's
//    columns at the chunk's start, and each BLK value is two shared-memory
//    reads and two multiplies.
//  * Stages: a chunk's entries are cut into stages of at most 128 entries,
//    |m3|-major, each |m3| segment padded to 8.  Per stage the block builds
//    BLK (both signs) in shared memory, a thread issuing all its table and
//    radial-weight loads before it multiplies, then warps multiply.  Two
//    barriers a stage.  The B operand (the stage's Wcat rows; Wcat is
//    gathered in entry order on the host side) is read by the fragments
//    straight from device memory: it is shared by every block and stays in
//    cache, and a copy into shared memory would cost a third barrier.
//  * The product runs on the tensor cores: mma.sync m16n8k8 in 3xTF32 (fp32
//    accuracy, packed_tp_mma.cuh).  A work item is a chunk's output tiles
//    (|m3|, n8) of at most 64 V columns and 32 tiles, 8 warps of at most 4
//    tiles each; a warp multiplies its tiles' segment of each stage, each
//    32-entry part of K summed in fragments and added into fp32 registers, so
//    that no long sum stays in the tensor cores' accumulation.
//  * N is V padded to 8.  Chunks of 2 or 4 copies waste 75% or 50% of their
//    products' columns; their arithmetic scales with live records x V and is
//    a few percent of the kernel's, so the design takes the waste rather than
//    merging chunks into one item (which would need one B operand across
//    chunks of different Wcat blocks).  The build, not the product, is what
//    the kernel waits on.
//  * Residency: 256 threads, at most 64 registers, and at the bench node
//    plan ~44 KB of shared memory (x rows, one BLK stage, the chunk's radial
//    weights), so that four blocks share an SM and one block's build
//    overlaps another's product.  Occupancy is what this latency-bound
//    kernel runs on: four blocks an SM, with the Wcat fragments loaded 32
//    entries of K at a time to fit 64 registers (an 8-byte spill), ran
//    faster on an H100 than three at 80 registers (bench node plan 0.87
//    against 1.00 ms a launch).
//  * The output is written once, straight into the plan's u-major layout.
//    Rows past E load zeros and store nothing.
//  * BF16 = true is the instantiation of HAMGNN_TP_BF16=all: the product
//    one bf16 mma.sync m16n8k16 pass (packed_tp_mma.cuh) over each 16
//    entries of a segment, a segment's last 8 as a half-deep step.  The
//    mids are elementwise and stay fp32, as in the JAX kernel.

#include "packed_tp_mma.cuh"

namespace {

using namespace packed_tp;

constexpr int ZTE = 8;          // edges per tile: m16 rows are (sign of m3, edge)
constexpr int CAP = 128;        // entries of a stage (zonal_kernel.py STAGE_ENTRIES)
constexpr int NT = 256;         // threads per block
constexpr int NW = NT / 32;     // warps per block
constexpr int AST = CAP + 4;    // BLK row stride: fragment rows read by gid hit distinct banks
constexpr int ZGRP_W = 7;       // ints per chunk record: b, d3, V, first stage, end stage,
                                // wcol offset, fan_in
constexpr int STAGE_W = 14;     // ints per stage record
constexpr int SEG_W = 3;        // ints per segment record: a, first entry, entries
constexpr int ITEM_W = 3;       // ints per work item: chunk, first n8 tile, n8 tiles
constexpr int ITEM_N8 = 8;      // n8 tiles of V of a work item
constexpr int MAXP = 4;         // (|m3|, n8) output tiles a warp keeps
constexpr int ITEM_TILES = NW * MAXP;

constexpr int BUILD = CAP / 32;  // BLK entries a thread builds (a warp per edge)
static_assert(NW == ZTE, "the build takes one warp per edge of the tile");

// shared memory: x rows [ZTE][odd(d_in)] | BLK [16][AST] | radial weights of
// the chunk's columns [ZTE][odd(fan_max)]
__host__ __device__ inline int a_offset(int d_in) { return align4(ZTE * odd_stride(d_in)); }
__host__ __device__ inline size_t smem_floats(int d_in, int fan_max) {
  return (size_t)a_offset(d_in) + 16 * AST + ZTE * odd_stride(fan_max);
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 4) zonal_tp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ went, const int* __restrict__ zgrp,
    const int* __restrict__ stages, const int* __restrict__ segs,
    const int4* __restrict__ ent_i, const float2* __restrict__ ent_c,
    const int* __restrict__ wcol, const int* __restrict__ items, float* __restrict__ out, int E,
    int d_in, int n_ch, int d_out, int n_items, int fan_max, int has_w) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int e0 = blockIdx.x * ZTE;
  const int n_rows = min(ZTE, E - e0);
  const int XST = odd_stride(d_in);
  const int WST = odd_stride(fan_max);
  float* x_s = smem;
  float* A_s = smem + a_offset(d_in);
  float* W_s = A_s + 16 * AST;

  // 1. the tile's x_rot rows (contiguous in device memory), once
  {
    const float* xg = x + (size_t)e0 * d_in;
    for (int idx = t; idx < ZTE * d_in; idx += NT) {
      const int e = idx / d_in;
      cp_async4(x_s + e * XST + idx - e * d_in, e < n_rows ? xg + idx : x, e < n_rows);
    }
    cp_async_commit();
    cp_async_wait_all();
  }

  for (int it = 0; it < n_items; ++it) {
    const int* im = items + (size_t)it * ITEM_W;
    const int* gm = zgrp + (size_t)__ldg(im) * ZGRP_W;
    const int b = __ldg(gm), d3 = __ldg(gm + 1), V = __ldg(gm + 2);
    const int st0 = __ldg(gm + 3), st1 = __ldg(gm + 4);
    const int col_ofs = __ldg(gm + 5), fan_in = __ldg(gm + 6);
    const int n8 = __ldg(im + 2), v0 = 8 * __ldg(im + 1);
    const int VB = min(V - v0, 8 * n8);
    const int L = (d3 - 1) >> 1, ntiles = (L + 1) * n8;

    float acc[MAXP][4];
#pragma unroll
    for (int j = 0; j < MAXP; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

    // the radial weights of the chunk's columns for the tile's edges (the
    // previous item's builds, their last readers, are behind a barrier)
    if (has_w) {
      for (int idx = t; idx < ZTE * fan_in; idx += NT) {
        const int e = idx / fan_in, c = idx - e * fan_in;
        const bool ok = e < n_rows;
        cp_async4(W_s + e * WST + c,
                  ok ? w + (size_t)(e0 + e) * n_ch + __ldg(wcol + col_ofs + c) : w, ok);
      }
      cp_async_commit();
    }

    for (int si = st0; si < st1; ++si) {
      const int* sm = stages + (size_t)si * STAGE_W;
      const int ent0 = __ldg(sm + 1), n = __ldg(sm + 2);
      const int seg_ofs = __ldg(sm + 3), n_seg = __ldg(sm + 4), went0 = __ldg(sm + 9);
      cp_async_wait_all();
      __syncthreads();  // the radial weights landed; the previous stage's product is done with A

      // 2a. BLK: per (entry, edge) its +a and -a records; warp w builds edge
      //     w, its lanes consecutive entries (coalesced table loads, distinct
      //     banks), all of a thread's loads issued first
      {
        const int e = warp;  // NW == ZTE
        const bool row_ok = e < n_rows;
        float2 cf[BUILD];
        int4 ei[BUILD];
#pragma unroll
        for (int r = 0; r < BUILD; ++r) {
          const int j = lane + 32 * r;
          const bool ok = j < n && row_ok;
          cf[r] = ok ? __ldg(ent_c + ent0 + j) : make_float2(0.f, 0.f);
          ei[r] = ok ? __ldg(ent_i + ent0 + j) : make_int4(0, 0, 0, 0);
        }
        float sc[BUILD];
#pragma unroll
        for (int r = 0; r < BUILD; ++r) sc[r] = has_w ? W_s[e * WST + ei[r].z] : 1.f;
        const float* xr = x_s + e * XST;
#pragma unroll
        for (int r = 0; r < BUILD; ++r) {
          const int j = lane + 32 * r;
          if (j < n) {
            A_s[e * AST + j] = cf[r].x * xr[ei[r].x] * sc[r];
            A_s[(ZTE + e) * AST + j] = cf[r].y * xr[ei[r].y] * sc[r];
          }
        }
      }
      __syncthreads();

      // 2b. warp w: output tiles p = w, w + NW, ... (p = a * n8 + nt); each
      //     multiplies its |m3| segment of the stage by the segment's Wcat
      //     rows (read from device memory: they are shared by every block and
      //     stay in cache), 32 entries of K at a time
#pragma unroll
      for (int jt = 0; jt < MAXP; ++jt) {
        const int p = warp + jt * NW;
        if (p >= ntiles) continue;
        const int a = p / n8, nt = p - a * n8;
        int s0 = 0, ns = 0;
        for (int s = 0; s < n_seg; ++s) {
          const int* sg = segs + (size_t)(seg_ofs + s) * SEG_W;
          if (__ldg(sg) == a) {
            s0 = __ldg(sg + 1);
            ns = __ldg(sg + 2);
          }
        }
        const int v = v0 + nt * 8 + gid;
        const bool v_ok = v < V;
        if (BF16) {
          // B (k, n) row-major in device memory: b0 (k = 2 tig, 2 tig + 1), b1 (+ 8)
          const float* ar = A_s + gid * AST + 2 * tig;
          const float* br = went + went0 + (size_t)(2 * tig) * V + (v_ok ? v : 0);
          for (int k = s0; k < s0 + ns; k += 16) {
            const bool up = k + 8 < s0 + ns;
            const float* a0 = ar + k;
            const float* b0 = br + (size_t)k * V;
            const uint32_t a[4] = {pack_bf16(a0[0], a0[1]), pack_bf16(a0[8 * AST], a0[8 * AST + 1]),
                                   up ? pack_bf16(a0[8], a0[9]) : 0u,
                                   up ? pack_bf16(a0[8 * AST + 8], a0[8 * AST + 9]) : 0u};
            const uint32_t b[2] = {
                v_ok ? pack_bf16(__ldg(b0), __ldg(b0 + V)) : 0u,
                v_ok && up ? pack_bf16(__ldg(b0 + 8 * (size_t)V), __ldg(b0 + 9 * (size_t)V)) : 0u};
            mma_bf16(acc[jt], a, b);
          }
          continue;
        }
        const float* ar = A_s + gid * AST + tig;
        const float* br = went + went0 + (size_t)tig * V + (v_ok ? v : 0);
        for (int kq = s0; kq < s0 + ns; kq += 32) {
          const int nk = min(s0 + ns - kq, 32) / 8;
          // this 32-entry part's Wcat fragments first, so that their loads
          // overlap rather than wait one by one
          float bv[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = v_ok && q < nk;
            bv[q][0] = ok ? __ldg(br + (size_t)(kq + 8 * q) * V) : 0.f;
            bv[q][1] = ok ? __ldg(br + (size_t)(kq + 8 * q + 4) * V) : 0.f;
          }
          float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
          float lo2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < nk) {
              const int k = kq + 8 * q;
              const float av[4] = {ar[k], ar[8 * AST + k], ar[k + 4], ar[8 * AST + k + 4]};
              mma_3xtf32(hi, lo, lo2, av, bv[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[jt][q] += (lo[q] + lo2[q]) + hi[q];
        }
      }
    }

    // 3. out_rot[e, b + v*d3 + L +- a]: rows gid (+a) and gid + 8 (-a), once
#pragma unroll
    for (int jt = 0; jt < MAXP; ++jt) {
      const int p = warp + jt * NW;
      if (p >= ntiles) continue;
      const int a = p / n8, vb = (p - a * n8) * 8 + 2 * tig;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = vb + (q & 1), m3 = (q >> 1) ? L - a : L + a;
        if (gid < n_rows && v < VB && ((q >> 1) == 0 || a > 0))
          out[(size_t)(e0 + gid) * d_out + b + (v0 + v) * d3 + m3] = acc[jt][q];
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t zonal_tp_fwd_smem_bytes(int d_in, int fan_max) {
  return smem_floats(d_in, fan_max) * sizeof(float);
}

int zonal_tp_fwd_tile_edges(void) { return ZTE; }
int zonal_tp_fwd_stage_entries(void) { return CAP; }
// largest number of (|m3|, n8) output tiles of a work item, and of its n8 tiles
int zonal_tp_fwd_item_tiles(void) { return ITEM_TILES; }
int zonal_tp_fwd_item_n8(void) { return ITEM_N8; }

// Blocks resident on one SM at this shared-memory size.
int zonal_tp_fwd_resident_blocks(size_t smem) {
  return resident_per_sm((const void*)zonal_tp_fwd_kernel<false>, NT, smem);
}

// zgrp: per chunk (b, d3, V, first stage, end stage, wcol offset, fan_in);
// stages, segs, ent_i (int4: x offsets of the +a and -a records, column in
// the chunk, a), ent_c (float2: their coefficients): zonal_kernel.py
// ZonalKernelSpec._build_stages; wcol: per chunk column its radial-weight
// column; fan_max: the most columns of a chunk;
// went: Wcat in entry order; items: n_items work items (chunk, first n8
// tile, n8 tiles); bf16: the bf16 instantiation.
int zonal_tp_fwd(const float* x, const float* w, const float* went, const int* zgrp,
                 const int* stages, const int* segs, const int* ent_i, const float* ent_c,
                 const int* wcol, const int* items, float* out, int E, int d_in, int n_ch,
                 int d_out, int n_items, int fan_max, int has_w, int bf16, void* stream) {
  if (E <= 0 || n_items <= 0) return 0;
  if (d_in < 1 || fan_max < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(d_in, fan_max) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bf16 ? zonal_tp_fwd_kernel<true> : zonal_tp_fwd_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
#define ZONAL_TP_FWD(B)                                                                     \
  zonal_tp_fwd_kernel<B><<<(E + ZTE - 1) / ZTE, NT, smem, (cudaStream_t)stream>>>(          \
      x, w, went, zgrp, stages, segs, reinterpret_cast<const int4*>(ent_i),                 \
      reinterpret_cast<const float2*>(ent_c), wcol, items, out, E, d_in, n_ch, d_out,       \
      n_items, fan_max, has_w)
  if (bf16)
    ZONAL_TP_FWD(true);
  else
    ZONAL_TP_FWD(false);
#undef ZONAL_TP_FWD
  return (int)cudaGetLastError();
}

const char* zonal_tp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
