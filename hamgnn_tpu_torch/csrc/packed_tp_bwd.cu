// Packed TP -> radial scale -> equivariant Linear, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_tp.py `_bwd_call`
// (PallasSpec._bwd_body), the backward of packed_tp_fwd.cu.  With the
// forward's notation (per output chunk (b, d3, V), BLK column c with coupling
// slot qb, d1, x offset xb and radial-weight column wc) and gy = d(out):
//
//   W[e,q]       = sum_s sh[e,s] coef_q[s]                     (recomputed)
//   mid[e,m3,c]  = sum_i W[e, m3*nq+qb+i] x[e, xb+i]            (recomputed)
//   dBLK[e,m3,c] = sum_v gy[e, b+v*d3+m3] Wcat[c,v]
//   dWcat[c,v]   = sum_e sum_m3 mid[e,m3,c] w[e,wc] gy[e, b+v*d3+m3]
//   dw[e,wc]    += sum_m3 dBLK[e,m3,c] mid[e,m3,c]
//   dx[e,xb+i]  += sum_m3 dBLK[e,m3,c] w[e,wc] W[e, m3*nq+qb+i]
//   dsh[e,s]     = sum_q coef_q[s] sum_{c on q} dBLK w x[e,xb+i]   (need_dsh)
//
// What bounds it.  At the bench widths the function does ~20 FLOP per byte of
// operands in fp32, near the H100's fp32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s): the node and edge plans are bound by operations (the two Wcat
// products), the pair plan by bytes.  Inside the kernel the limit is, as in
// the forward, instruction issue and barriers between the slab phases.
//
// What the design does about it.
//  * The TPU kernel runs its grid in order and sums dWcat into one block the
//    grid revisits.  Here a block owns a contiguous range of 8-edge tiles and
//    walks them in order, so it alone writes the dx, dw and dsh rows of its
//    edges: they are summed in global memory in a fixed order, with no
//    atomics.  dWcat is summed per block into its own partial row, and a
//    second kernel (packed_tp_bwd_reduce) adds the rows in block order, folds
//    in 1/sqrt(fan_in) and scatters through the Wcat index into d(flat_w).
//    So a repeat gives bit-identical results.
//  * Nothing wide is stored: the mids are rebuilt slab by slab (64 columns,
//    all d3 components) in shared memory, as in the forward; dBLK for the slab
//    sits beside them.  A mid row (50 KB per edge in the node plan) never
//    exists, and neither does a dmid row.
//  * dx and dW (for dsh) gather from many columns (all paths of a source read
//    the same x values; all u of a path share a coupling slot).  Host-side
//    tables group each slab's columns by x offset and by coupling slot, so
//    one thread owns each (edge, x group) or (edge, slot group) and sums its
//    columns in a fixed order, without races.
//  * 8-edge tiles keep a block at ~83 KB of shared memory (node plan) and the
//    launch bounds cap registers at 64, so two 512-thread blocks share an SM
//    and one's barriers overlap the other's work.
//  * The ragged last tile is masked: rows past E load zeros and store nothing.
// A later PR may move the two products to wgmma; this one stays plain fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 8;        // edges per tile
constexpr int MIN_BLOCKS = 2;  // blocks per SM the register budget allows
constexpr int KS = 64;       // BLK columns per shared-memory slab
constexpr int AST = KS + 4;  // mid/dBLK slab row stride (floats)
constexpr int NT = 512;      // threads per block
constexpr int MAXD1 = 13;    // largest input irrep dimension (l1 <= 6)
constexpr int GRP_W = 8;     // ints per output-chunk record
constexpr int COL_W = 4;     // ints per column record
constexpr int Q_W = 3;       // ints per coupling-slot record
constexpr int SLAB_W = 4;    // ints per slab record
constexpr int G_W = 4;       // ints per x-group / slot-group record
constexpr int RED_NT = 256;  // threads per block of the reduce

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// shared-memory layout (floats):
// sh [TE][S] | W [TE][nqp] | dW [TE][nqp] (need_dsh) | G [TE*gmax] |
// w [TE][KS] | Wcat slab [KS][odd(V)] | mid [d3*TE][AST] | dBLK [d3*TE][AST]
__host__ __device__ inline size_t smem_floats(int S, int nq_all_max, int gmax,
                                              int d3_max, int v_max,
                                              int need_dsh) {
  const size_t nqp = odd_stride(nq_all_max);
  return (size_t)TE * S + (size_t)TE * nqp * (need_dsh ? 2 : 1) +
         (size_t)TE * gmax + (size_t)TE * KS + (size_t)KS * odd_stride(v_max) +
         2 * (size_t)d3_max * TE * AST;
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS) packed_tp_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ sh,
    const float* __restrict__ w, const float* __restrict__ wcat,
    const float* __restrict__ gy, const float* __restrict__ coef,
    const int* __restrict__ grp, const int* __restrict__ col,
    const int* __restrict__ qtab, const int* __restrict__ slab_base,
    const int* __restrict__ slab, const int* __restrict__ xgrp,
    const int* __restrict__ qgrp, const int* __restrict__ lst,
    float* __restrict__ dx, float* __restrict__ dsh, float* __restrict__ dw,
    float* __restrict__ part, int E, int d_in, int S, int n_ch, int d_out,
    int n_groups, int linear_numel, int nq_all_max, int gmax, int d3_max,
    int v_max, int tiles_per_block, int n_tiles, int has_w, int need_dsh) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int nqp = odd_stride(nq_all_max);
  const int VP = odd_stride(v_max);
  float* sh_s = smem;
  float* W_s = sh_s + TE * S;
  float* dW_s = W_s + TE * nqp;
  float* G_s = dW_s + (need_dsh ? TE * nqp : 0);
  float* w_s = G_s + TE * gmax;
  float* B_s = w_s + TE * KS;
  float* A_s = B_s + KS * VP;
  float* D_s = A_s + d3_max * TE * AST;
  float* prow = part + (size_t)blockIdx.x * linear_numel;

  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(n_tiles, tile0 + tiles_per_block);
  for (int tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0;
    const int e0 = tile * TE;
    const int n_rows = min(TE, E - e0);

    __syncthreads();  // the previous tile is done with sh_s
    {
      const float* sg = sh + (size_t)e0 * S;
      const int ns = n_rows * S;
      for (int idx = t; idx < TE * S; idx += NT) sh_s[idx] = idx < ns ? sg[idx] : 0.f;
    }

    for (int k = 0; k < n_groups; ++k) {
      const int* gm = grp + (size_t)k * GRP_W;
      const int out_base = gm[0], d3 = gm[1], V = gm[2], wofs = gm[3];
      const int fan_in = gm[4], col_ofs = gm[5], q_ofs = gm[6], nq = gm[7];
      const int nq_all = nq * d3;
      const int M = d3 * TE;
      __syncthreads();  // sh_s ready; the previous chunk is done with W/dW/G

      // 1. coupling slots W[e, q] of this chunk, all m3 (and dW = 0)
      for (int idx = t; idx < TE * nq_all; idx += NT) {
        const int q = idx / TE, e = idx - q * TE;
        const int* qm = qtab + (size_t)(q_ofs + q) * Q_W;
        const float* cf = coef + qm[0];
        const float* sr = sh_s + e * S + qm[1];
        float acc = 0.f;
        for (int s = 0; s < qm[2]; ++s) acc += cf[s] * sr[s];
        W_s[e * nqp + q] = acc;
        if (need_dsh) dW_s[e * nqp + q] = 0.f;
      }
      // 2. the chunk's output gradient, G[(m3*TE + e)*V + v]
      for (int idx = t; idx < M * V; idx += NT) {
        const int r = idx / V, v = idx - r * V;
        const int m = r / TE, e = r - m * TE;
        G_s[idx] = e < n_rows
                       ? __ldg(gy + (size_t)(e0 + e) * d_out + out_base + v * d3 + m)
                       : 0.f;
      }

      const int* sl = slab + (size_t)slab_base[k] * SLAB_W;
      for (int c0 = 0; c0 < fan_in; c0 += KS, sl += SLAB_W) {
        const int nc = min(KS, fan_in - c0);
        __syncthreads();  // W_s/G_s ready; the previous slab is consumed

        // 3a. mid slab (unscaled) and the radial weights of its columns
        for (int idx = t; idx < TE * KS; idx += NT) {
          const int e = idx / KS, c = idx - e * KS;
          if (c < nc && e < n_rows) {
            const int* cm = col + (size_t)(col_ofs + c0 + c) * COL_W;
            const int qb = cm[0], d1 = cm[1];
            const float* xr = x + (size_t)(e0 + e) * d_in + cm[2];
            float xv[MAXD1];
#pragma unroll
            for (int i = 0; i < MAXD1; ++i) xv[i] = i < d1 ? __ldg(xr + i) : 0.f;
            w_s[e * KS + c] = has_w ? __ldg(w + (size_t)(e0 + e) * n_ch + cm[3]) : 1.f;
            const float* wr = W_s + e * nqp + qb;
            for (int m = 0; m < d3; ++m, wr += nq) {
              float val = 0.f;
#pragma unroll
              for (int i = 0; i < MAXD1; ++i)
                if (i < d1) val += wr[i] * xv[i];
              A_s[(m * TE + e) * AST + c] = val;
            }
          } else {
            w_s[e * KS + c] = 0.f;
            for (int m = 0; m < d3; ++m) A_s[(m * TE + e) * AST + c] = 0.f;
          }
        }
        // 3b. Wcat slab, odd row stride
        for (int idx = t; idx < KS * V; idx += NT) {
          const int c = idx / V, v = idx - c * V;
          B_s[c * VP + v] = c < nc ? __ldg(wcat + wofs + (size_t)(c0 + c) * V + v) : 0.f;
        }
        __syncthreads();

        // 3c. dBLK[r, c] = sum_v G[r, v] Wcat[c, v]
        for (int idx = t; idx < M * KS; idx += NT) {
          const int r = idx / KS, c = idx - r * KS;
          const float* gr = G_s + r * V;
          const float* br = B_s + c * VP;
          float acc = 0.f;
          for (int v = 0; v < V; ++v) acc += gr[v] * br[v];
          D_s[r * AST + c] = acc;
        }
        // 3d. this block's dWcat partial: sum_r mid[r, c] w[e, c] G[r, v]
        for (int idx = t; idx < nc * V; idx += NT) {
          const int c = idx / V, v = idx - c * V;
          float acc = 0.f;
          for (int r = 0; r < M; ++r)
            acc += A_s[r * AST + c] * w_s[(r % TE) * KS + c] * G_s[r * V + v];
          float* p = prow + wofs + (size_t)c0 * V + idx;
          *p = first ? acc : *p + acc;
        }
        __syncthreads();

        // 3e. dw[e, wc] += sum_m3 dBLK mid; then dBLK -> dmid = dBLK * w
        for (int idx = t; idx < TE * KS; idx += NT) {
          const int e = idx / KS, c = idx - e * KS;
          if (c < nc && e < n_rows) {
            const float sc = w_s[e * KS + c];
            float acc = 0.f;
            for (int m = 0; m < d3; ++m) {
              float* dp = D_s + (m * TE + e) * AST + c;
              acc += *dp * A_s[(m * TE + e) * AST + c];
              *dp *= sc;
            }
            if (has_w) {
              float* p = dw + (size_t)(e0 + e) * n_ch + col[(size_t)(col_ofs + c0 + c) * COL_W + 3];
              *p += acc;
            }
          }
        }
        __syncthreads();

        // 3f. dx: one thread per (edge, x group) sums its columns in order
        const int xg_ofs = sl[0], n_xg = sl[1], qg_ofs = sl[2], n_qg = sl[3];
        for (int idx = t; idx < TE * n_xg; idx += NT) {
          const int e = idx / n_xg, g = idx - e * n_xg;
          if (e >= n_rows) continue;
          const int* xg = xgrp + (size_t)(xg_ofs + g) * G_W;
          const int xb = xg[0], d1 = xg[1], lo = xg[2], n = xg[3];
          float acc[MAXD1];
#pragma unroll
          for (int i = 0; i < MAXD1; ++i) acc[i] = 0.f;
          for (int j = 0; j < n; ++j) {
            const int c = lst[lo + j] - c0;
            const int qb = col[(size_t)(col_ofs + c0 + c) * COL_W];
            const float* wr = W_s + e * nqp + qb;
            for (int m = 0; m < d3; ++m, wr += nq) {
              const float dm = D_s[(m * TE + e) * AST + c];
#pragma unroll
              for (int i = 0; i < MAXD1; ++i)
                if (i < d1) acc[i] += dm * wr[i];
            }
          }
          float* p = dx + (size_t)(e0 + e) * d_in + xb;
#pragma unroll
          for (int i = 0; i < MAXD1; ++i)
            if (i < d1) p[i] += acc[i];
        }
        // 3g. dW for dsh: one thread per (edge, slot group)
        if (need_dsh) {
          for (int idx = t; idx < TE * n_qg; idx += NT) {
            const int e = idx / n_qg, g = idx - e * n_qg;
            if (e >= n_rows) continue;
            const int* qg = qgrp + (size_t)(qg_ofs + g) * G_W;
            const int qb = qg[0], d1 = qg[1], lo = qg[2], n = qg[3];
            for (int j = 0; j < n; ++j) {
              const int c = lst[lo + j] - c0;
              const float* xr = x + (size_t)(e0 + e) * d_in +
                                col[(size_t)(col_ofs + c0 + c) * COL_W + 2];
              float xv[MAXD1];
#pragma unroll
              for (int i = 0; i < MAXD1; ++i) xv[i] = i < d1 ? __ldg(xr + i) : 0.f;
              float* dr = dW_s + e * nqp + qb;
              for (int m = 0; m < d3; ++m, dr += nq) {
                const float dm = D_s[(m * TE + e) * AST + c];
#pragma unroll
                for (int i = 0; i < MAXD1; ++i)
                  if (i < d1) dr[i] += dm * xv[i];
              }
            }
          }
        }
      }

      // 4. dsh[e, s] += sum_q coef_q[s] dW[e, q] over this chunk's slots
      if (need_dsh) {
        __syncthreads();
        for (int idx = t; idx < TE * S; idx += NT) {
          const int e = idx / S, s = idx - e * S;
          if (e >= n_rows) continue;
          float acc = 0.f;
          for (int q = 0; q < nq_all; ++q) {
            const int* qm = qtab + (size_t)(q_ofs + q) * Q_W;
            const int d = s - qm[1];
            if (d >= 0 && d < qm[2]) acc += coef[qm[0] + d] * dW_s[e * nqp + q];
          }
          dsh[(size_t)(e0 + e) * S + s] += acc;
        }
      }
    }
  }
}

// d(flat_w)[wcat_idx[k]] = wcat_scale[k] * sum_b part[b, k], blocks in order
__global__ void packed_tp_bwd_reduce(const float* __restrict__ part, int nblk,
                                     int linear_numel,
                                     const float* __restrict__ scale,
                                     const int64_t* __restrict__ wcat_idx,
                                     float* __restrict__ dflat) {
  const int k = blockIdx.x * RED_NT + threadIdx.x;
  if (k >= linear_numel) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += part[(size_t)b * linear_numel + k];
  dflat[wcat_idx[k]] = acc * scale[k];
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t packed_tp_bwd_smem_bytes(int S, int nq_all_max, int gmax, int d3_max,
                                int v_max, int need_dsh) {
  return smem_floats(S, nq_all_max, gmax, d3_max, v_max, need_dsh) * sizeof(float);
}

// BLK columns per slab (the host's slab tables must use the same) and the
// largest input-irrep dimension the kernel takes.
int packed_tp_bwd_slab_cols(void) { return KS; }
int packed_tp_bwd_max_d1(void) { return MAXD1; }
int packed_tp_bwd_tile_edges(void) { return TE; }

// Blocks resident on the whole card at this shared-memory size: the grid
// size, each block walking a contiguous range of edge tiles.
int packed_tp_bwd_resident_blocks(size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (cudaFuncSetAttribute(packed_tp_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, packed_tp_bwd_kernel,
                                                    NT, smem) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

int packed_tp_bwd(const float* x, const float* sh, const float* w,
                  const float* wcat, const float* gy, const float* coef,
                  const int* grp, const int* col, const int* qtab,
                  const int* slab_base, const int* slab, const int* xgrp,
                  const int* qgrp, const int* lst, const float* wcat_scale,
                  const int64_t* wcat_idx, float* dx, float* dsh, float* dw,
                  float* part, float* dflat, int E, int d_in, int S, int n_ch,
                  int d_out, int n_groups, int linear_numel, int nq_all_max,
                  int gmax, int d3_max, int v_max, int nblk,
                  int tiles_per_block, int has_w, int need_dsh, void* stream) {
  if (E <= 0 || n_groups <= 0) return 0;
  const int n_tiles = (E + TE - 1) / TE;
  if (nblk < 1 || tiles_per_block < 1 || (long long)nblk * tiles_per_block < n_tiles ||
      (nblk - 1) * tiles_per_block >= n_tiles || v_max < 1 || v_max > NT)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      packed_tp_bwd_smem_bytes(S, nq_all_max, gmax, d3_max, v_max, need_dsh);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      packed_tp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_tp_bwd_kernel<<<nblk, NT, smem, st>>>(
      x, sh, w, wcat, gy, coef, grp, col, qtab, slab_base, slab, xgrp, qgrp, lst,
      dx, dsh, dw, part, E, d_in, S, n_ch, d_out, n_groups, linear_numel,
      nq_all_max, gmax, d3_max, v_max, tiles_per_block, n_tiles, has_w, need_dsh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  packed_tp_bwd_reduce<<<(linear_numel + RED_NT - 1) / RED_NT, RED_NT, 0, st>>>(
      part, nblk, linear_numel, wcat_scale, wcat_idx, dflat);
  return (int)cudaGetLastError();
}

const char* packed_tp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
