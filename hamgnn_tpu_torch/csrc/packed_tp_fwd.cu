// Packed TP -> radial scale -> equivariant Linear, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_tp.py `_fwd_call`
// (PallasSpec._fwd_body / _mids).  It computes what PackedTPPlan._apply
// computes, for every edge e:
//
//   W_g[e,i,k]   = sum_s sh[e,s] * C_g[s,i,k]                 (coupling)
//   mid_g[e,k,u] = sum_i W_g[e,i,k] * x[e, g, u, i]           (broadcast FMA)
//   BLK[e,m3,c]  = mid[e, column c of output chunk, m3] * w[e, c]   (w optional)
//   out[e, b + v*d3 + m3] = sum_c BLK[e,m3,c] * Wcat[c, v]    (Wcat product)
//
// What bounds it.  At the bench widths the function does about 20-40 FLOP
// per byte of operands in fp32, above the H100's ~20 FLOP/byte ridge for fp32
// CUDA cores (67 TFLOP/s over 3.35 TB/s): its bound is the operations, two
// thirds of them the Wcat product.  Inside the kernel the limit is latency:
// the BLK operand is built by gathers, and a barrier separates each slab's
// build from its product, so what hides the latency is the number of
// resident warps and the instructions each gather needs.
//
// What the design does about it.
//  * The TPU held a whole edge tile's mids in 120 MB of VMEM and repeated
//    every coupling column `mul` times.  Here nothing wide is stored: a block
//    owns 16 edges and one work item of an output chunk, computes the
//    chunk's coupling entries W_g once (per edge, then broadcast over u), and
//    builds the BLK operand slab by slab (64 columns) in shared memory: all
//    d3 components of a column share its x values and radial weight, so the
//    product runs on d3 * 16 rows at once.
//  * The Wcat product runs on the tensor cores: mma.sync m16n8k8 in 3xTF32
//    (fp32 accuracy, see packed_tp_mma.cuh).  Rows are (m3, edge), one m16
//    tile per m3; N is V padded to 8 with zero columns in shared memory; K is
//    the slab's 64 columns.  Each warp keeps the accumulators of its
//    (m3, n8) tiles in fragments across all slabs; each slab's sum (K = 64)
//    is added into fp32 registers, so that no long sum stays in the tensor
//    cores' accumulation.
//  * The build: a thread builds one column of one edge, all d3 rows; the
//    edge is the fastest index, so that a warp's lanes share their column's
//    d1 and the loops are unrolled to it (packed_tp_mma.cuh with_d1); x and
//    the radial weight come straight from device memory (L1).
//  * Residency: 512 threads and at most 64 registers a thread (up to two
//    accumulator fragments a warp), and shared memory of sh, the chunk's
//    coupling entries, one BLK slab and its Wcat rows (~100 KB at the bench
//    node plan), so that two blocks share an SM and one block's build
//    overlaps the other's product.  A design with one block an SM and a
//    three-stage pipeline inside it (the slab's coupling slots, copies and
//    build a step ahead, double buffers) was slower on the card.
//  * Work items (host table `fitems`): a chunk's (m3, n8) output tiles are
//    cut into items of at most 8 n8 tiles (64 of its V columns) and 64 tiles,
//    16 warps of at most 4 tiles each; a chunk with more (d3 * ceil(V/8) >
//    64, or V > 64) takes several items, each building the chunk's BLK
//    operand anew.  Limits: d1 <= 13 (MAXD1), d3 <= 64; the shared memory
//    (chunk's coupling entries) must fit the card (the wrapper checks it).
//  * Variants.  BF16 = true is the instantiation of HAMGNN_TP_BF16=all: sh
//    and the coefficients rounded to bf16 before the coupling FFMAs, and the
//    Wcat product one bf16 mma.sync m16n8k16 pass (packed_tp_mma.cuh).
//    STORE = true (HAMGNN_TP_STOREMID, `mids` given): the first work item of
//    each chunk also writes the mids it builds, unscaled, to device memory in
//    the layout of the JAX kernel's stored mids (host table `mcols`: per
//    column its offset at m3 = 0 and its step per m3), for the backward to
//    read.  Both are compile-time parameters, so that the default
//    instantiation carries no code of either.
//  * All layout work is host-side int32 tables (e3/tp_kernel.py KernelSpec):
//    per BLK column its coupling slot, d1, x offset (u-major layout, so no x
//    permutation) and radial-weight column; per coupling slot its nonzero
//    coupling range.  The output is written straight into the u-major
//    irreps layout.  Rows past E load zeros and store nothing.

#include "packed_tp_mma.cuh"

namespace {

using namespace packed_tp;

constexpr int NT = 512;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int AST = KS + 4;  // BLK row stride: fragment rows read by gid hit distinct banks
constexpr int ITEM_W = 3;    // ints per work item: chunk, first n8 tile, n8 tiles
constexpr int ITEM_N8 = 8;   // n8 tiles of an item (64 V columns)
constexpr int MAX_TILES_PER_WARP = 4;  // accumulator fragments a warp keeps

// shared memory: sh [TE][S] | W [TE][odd(nq_all)] | BLK [d3*TE][AST] | Wcat [KS][BST]
struct Layout {
  int nq_all_max = 0, d3_max = 1, bst_max = 8;
  Layout(const int* grp_host, int n_groups) {
    for (int k = 0; k < n_groups; ++k) {
      const int* g = grp_host + k * GRP_W;
      const int d3 = g[1], V = g[2], nq_all = d3 * g[7];
      const int bst = stride_8mod16(V < KS ? V : KS);
      nq_all_max = nq_all > nq_all_max ? nq_all : nq_all_max;
      d3_max = d3 > d3_max ? d3 : d3_max;
      bst_max = bst > bst_max ? bst : bst_max;
    }
  }
  int a_offset(int S) const { return align4(TE * S) + align4(TE * odd_stride(nq_all_max)); }
  size_t smem_floats(int S) const {
    return (size_t)a_offset(S) + align4(d3_max * TE * AST) + (size_t)KS * bst_max;
  }
};

template <bool BF16, bool STORE, int MAXP>
__global__ void __launch_bounds__(NT, MAXP <= 2 ? 2 : 1) packed_tp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ sh,
    const float* __restrict__ w, const float* __restrict__ wcat,
    const float* __restrict__ coef, const int* __restrict__ grp,
    const int* __restrict__ cols, const int* __restrict__ qtab,
    const int* __restrict__ items, float* __restrict__ out, float* __restrict__ mids,
    const int2* __restrict__ mcols, int E, int d_in, int S, int n_ch, int d_out, int a_ofs,
    int has_w, int midw) {
  extern __shared__ __align__(16) float smem[];
  const int* it = items + (size_t)blockIdx.y * ITEM_W;
  const int* gm = grp + (size_t)__ldg(it) * GRP_W;
  const int out_base = gm[0], d3 = gm[1], V = gm[2], wofs = gm[3];
  const int fan_in = gm[4], col_ofs = gm[5], q_ofs = gm[6], nq = gm[7];
  const int nt0 = __ldg(it + 1), n8 = __ldg(it + 2);
  float* const mid_out = STORE && nt0 == 0 ? mids : nullptr;  // one item of a chunk writes them
  const int v0 = nt0 * 8, VB = min(V - v0, n8 * 8);  // this item's V columns
  const int KV = n8 * 8, BST = stride_8mod16(VB);
  const int npairs = d3 * n8;
  const int nq_all = nq * d3, nqp = odd_stride(nq_all);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int e0 = blockIdx.x * TE;
  const int n_rows = min(TE, E - e0);

  float* sh_s = smem;                   // [TE][S]
  float* W_s = smem + align4(TE * S);   // [TE][nqp]  (odd stride)
  float* A_s = smem + a_ofs;            // [d3*TE][AST], row m3*TE + e
  float* B_s = A_s + align4(d3 * TE * AST);  // [KS][BST], this item's V columns

  // 1. the tile's SH rows (contiguous in device memory)
  {
    const float* sg = sh + (size_t)e0 * S;
    const int ns = n_rows * S;
    for (int idx = t; idx < TE * S; idx += NT)
      sh_s[idx] = idx < ns ? operand<BF16>(sg[idx]) : 0.f;
  }
  __syncthreads();

  // 2. the chunk's coupling entries W_g[e,i,k], all m3
  for (int idx = t; idx < TE * nq_all; idx += NT) {
    const int q = idx / TE, e = idx - q * TE;
    const int* qm = qtab + (size_t)(q_ofs + q) * Q_W;
    const float* cf = coef + __ldg(qm);
    const float* sr = sh_s + e * S + __ldg(qm + 1);
    const int ns = __ldg(qm + 2);
    float acc = 0.f;
    for (int s = 0; s < ns; ++s) acc += operand<BF16>(__ldg(cf + s)) * sr[s];
    W_s[e * nqp + q] = acc;
  }

  float acc[MAXP][4];
#pragma unroll
  for (int j = 0; j < MAXP; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < fan_in; c0 += KS) {
    __syncthreads();  // W_s ready / the previous slab's product is done
    // 3a. BLK slab: for each (column, edge) the d3 mids of that column
    for (int idx = t; idx < TE * KS; idx += NT) {
      const int e = idx % TE, c = idx / TE;
      const int gc = c0 + c;
      float* a = A_s + e * AST + c;
      if (gc < fan_in && e < n_rows) {
        const int* cm = cols + (size_t)(col_ofs + gc) * COL_W;
        const float* xr = x + (size_t)(e0 + e) * d_in + __ldg(cm + 2);
        const float sc = has_w ? __ldg(w + (size_t)(e0 + e) * n_ch + __ldg(cm + 3)) : 1.f;
        const float* wr = W_s + e * nqp + __ldg(cm);
        float* mo = nullptr;
        int mstep = 0;
        if (mid_out) {
          const int2 mc = __ldg(mcols + col_ofs + gc);
          mo = mid_out + (size_t)(e0 + e) * midw + mc.x;
          mstep = mc.y;
        }
        with_d1(__ldg(cm + 1), [&](auto D) {
          constexpr int n = decltype(D)::value;
          float xv[n];
#pragma unroll
          for (int i = 0; i < n; ++i) xv[i] = __ldg(xr + i);
          const float* wm = wr;
          for (int m = 0; m < d3; ++m, wm += nq) {
            float val = 0.f;
#pragma unroll
            for (int i = 0; i < n; ++i) val = mid_mac<BF16>(val, wm[i], xv[i]);
            a[m * TE * AST] = val * sc;
            if (mo) mo[m * mstep] = val;
          }
        });
      } else {
        for (int m = 0; m < d3; ++m) a[m * TE * AST] = 0.f;
      }
    }
    // 3b. the slab's Wcat rows, this item's columns, zero past fan_in and VB
    for (int idx = t; idx < KS * KV; idx += NT) {
      const int c = idx / KV, v = idx - c * KV;
      const bool ok = c0 + c < fan_in && v < VB;
      B_s[c * BST + v] = ok ? __ldg(wcat + wofs + (size_t)(c0 + c) * V + v0 + v) : 0.f;
    }
    __syncthreads();
    // 3c. warp w: (m3, n8) tiles w, w + NW, ...: the slab's product in
    //     fragments, added into the fp32 accumulators
#pragma unroll
    for (int j = 0; j < MAXP; ++j) {
      const int p = warp + j * NW;
      if (p < npairs) {
        const int m3 = p / n8, nt = p - m3 * n8;
        if (BF16) {
          // B is (k, n) row-major here: b0 (k = 2 tig, 2 tig + 1), b1 (+ 8)
          const float* ar = A_s + (m3 * TE + gid) * AST + 2 * tig;
          const float* br = B_s + 2 * tig * BST + nt * 8 + gid;
#pragma unroll
          for (int k = 0; k < KS; k += 16) {
            const float* a0 = ar + k;
            const float* b0 = br + k * BST;
            const uint32_t a[4] = {pack_bf16(a0[0], a0[1]), pack_bf16(a0[8 * AST], a0[8 * AST + 1]),
                                   pack_bf16(a0[8], a0[9]),
                                   pack_bf16(a0[8 * AST + 8], a0[8 * AST + 9])};
            const uint32_t b[2] = {pack_bf16(b0[0], b0[BST]), pack_bf16(b0[8 * BST], b0[9 * BST])};
            mma_bf16(acc[j], a, b);
          }
        } else {
          const float* ar = A_s + (m3 * TE + gid) * AST + tig;
          const float* br = B_s + tig * BST + nt * 8 + gid;
          float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < KS; k += 8) {
            const float a[4] = {ar[k], ar[8 * AST + k], ar[k + 4], ar[8 * AST + k + 4]};
            const float b[2] = {br[k * BST], br[(k + 4) * BST]};
            mma_3xtf32(hi, lo, a, b);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r] += lo[r] + hi[r];
        }
      }
    }
  }

  // 4. out[e, b + v*d3 + m3] (u-major irreps layout)
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    const int p = warp + j * NW;
    if (p < npairs) {
      const int m3 = p / n8, vb = (p - m3 * n8) * 8 + 2 * tig;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = gid + (r >> 1) * 8, v = vb + (r & 1);
        if (e < n_rows && v < VB)
          out[(size_t)(e0 + e) * d_out + out_base + (v0 + v) * d3 + m3] = acc[j][r];
      }
    }
  }
}

template <bool BF16, bool STORE, int MAXP>
cudaError_t launch(const float* x, const float* sh, const float* w, const float* wcat,
                   const float* coef, const int* grp, const int* cols, const int* qtab,
                   const int* items, float* out, float* mids, const int* mcols, int E, int d_in,
                   int S, int n_ch, int d_out, int n_items, int a_ofs, size_t smem, int has_w,
                   int midw, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_tp_fwd_kernel<BF16, STORE, MAXP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((E + TE - 1) / TE, n_items);
  packed_tp_fwd_kernel<BF16, STORE, MAXP><<<grid, NT, smem, stream>>>(
      x, sh, w, wcat, coef, grp, cols, qtab, items, out, mids,
      reinterpret_cast<const int2*>(mcols), E, d_in, S, n_ch, d_out, a_ofs, has_w, midw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes, for the plan's chunk records
// (grp_host: the host copy of the grp table) and S SH components.
size_t packed_tp_fwd_smem_bytes(const int* grp_host, int n_groups, int S) {
  return Layout(grp_host, n_groups).smem_floats(S) * sizeof(float);
}

int packed_tp_fwd_slab_cols(void) { return KS; }
int packed_tp_fwd_max_d1(void) { return MAXD1; }
// largest number of (m3, n8) output tiles of a work item, and of its n8 tiles
int packed_tp_fwd_max_pairs(void) { return NW * MAX_TILES_PER_WARP; }
int packed_tp_fwd_item_n8(void) { return ITEM_N8; }

// Blocks resident on one SM at this shared-memory size.
int packed_tp_fwd_resident_blocks(size_t smem) {
  return resident_per_sm((const void*)packed_tp_fwd_kernel<false, false, 1>, NT, smem);
}

// mids: null, or an (E, midw) buffer the mids are written to (mcols: per
// column its offset there and its step per m3); bf16: the bf16 instantiation.
int packed_tp_fwd(const float* x, const float* sh, const float* w, const float* wcat,
                  const float* coef, const int* grp, const int* cols, const int* qtab,
                  const int* items, float* out, float* mids, const int* mcols,
                  const int* grp_host, const int* items_host, int E, int d_in, int S, int n_ch,
                  int d_out, int n_groups, int n_items, int has_w, int midw, int bf16,
                  void* stream) {
  if (E <= 0 || n_groups <= 0 || n_items <= 0) return 0;
  if (mids && midw <= 0) return (int)cudaErrorInvalidValue;
  int max_pairs = 0;
  for (int i = 0; i < n_items; ++i) {
    const int* it = items_host + i * ITEM_W;
    if (it[0] < 0 || it[0] >= n_groups || it[2] < 1 || it[2] > ITEM_N8)
      return (int)cudaErrorInvalidValue;
    const int pairs = grp_host[it[0] * GRP_W + 1] * it[2];
    max_pairs = pairs > max_pairs ? pairs : max_pairs;
  }
  const int per_warp = (max_pairs + NW - 1) / NW;
  if (per_warp > MAX_TILES_PER_WARP) return (int)cudaErrorInvalidValue;
  const Layout lay(grp_host, n_groups);
  const size_t smem = lay.smem_floats(S) * sizeof(float);
  const int a_ofs = lay.a_offset(S);
  cudaStream_t st = (cudaStream_t)stream;
#define PACKED_TP_FWD_LAUNCH(PREC, STORED, PAIRS)                                          \
  launch<PREC, STORED, PAIRS>(x, sh, w, wcat, coef, grp, cols, qtab, items, out, mids, mcols, \
                              E, d_in, S, n_ch, d_out, n_items, a_ofs, smem, has_w, midw, st)
#define PACKED_TP_FWD_LAUNCH_P(PREC, STORED)                                               \
  (per_warp <= 1   ? PACKED_TP_FWD_LAUNCH(PREC, STORED, 1)                                \
   : per_warp <= 2 ? PACKED_TP_FWD_LAUNCH(PREC, STORED, 2)                                \
                   : PACKED_TP_FWD_LAUNCH(PREC, STORED, 4))
  cudaError_t err;
  if (bf16)
    err = mids ? PACKED_TP_FWD_LAUNCH_P(true, true) : PACKED_TP_FWD_LAUNCH_P(true, false);
  else
    err = mids ? PACKED_TP_FWD_LAUNCH_P(false, true) : PACKED_TP_FWD_LAUNCH_P(false, false);
#undef PACKED_TP_FWD_LAUNCH_P
#undef PACKED_TP_FWD_LAUNCH
  return (int)err;
}

const char* packed_tp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
