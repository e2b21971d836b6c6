// Zonal (edge-frame) TP -> radial scale -> equivariant Linear, backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_zonal.py `_zbwd_call`
// (ZonalPallasSpec._bwd_body), the backward of zonal_tp_fwd.cu.  With the
// forward's notation (per output chunk (b, d3, V), component m3 and BLK
// column c: x offsets xo1, xo2 and coefficients c1, c2 of the rotated x,
// radial-weight column wc) and gy = d(out_rot):
//
//   mid[e,m3,c]  = c1 x_rot[e,xo1] + c2 x_rot[e,xo2]              (recomputed)
//   dBLK[e,m3,c] = sum_v gy[e, b+v*d3+m3] Wcat[c,v]
//   dWcat[c,v]   = sum_e sum_m3 mid[e,m3,c] w[e,wc] gy[e, b+v*d3+m3]
//   dw[e,wc]    += sum_m3 dBLK[e,m3,c] mid[e,m3,c]
//   dx_rot[e,xo] += sum over the (m3, c, term) with that offset of
//                   coefficient * dBLK[e,m3,c] w[e,wc]
//
// The frame is data: there is no gradient to the spherical harmonics.
//
// What bounds it.  It reads x_rot, w and gy and writes dx_rot and dw once
// (~27 KB per edge at the node plan) for ~0.43 MFLOP per edge in the two
// Wcat products: 16 FLOP per byte, under the fp32 CUDA-core ridge of 20, so
// its bound is the bytes.  Inside the kernel the limit is, as in
// packed_tp_bwd.cu, instruction issue and the barriers between slab phases.
//
// What the design does about it.
//  * The TPU kernel runs its grid in order and sums dWcat into one block the
//    grid revisits.  Here a block owns a contiguous range of 16-edge tiles and
//    walks them in order, so it alone writes the dx_rot and dw rows of its
//    edges: they are summed in global memory in a fixed order, with no
//    atomics.  dWcat is summed per block into its own partial row, and a
//    second kernel (zonal_tp_bwd_reduce) adds the rows in block order, folds
//    in 1/sqrt(fan_in) and scatters through the Wcat index into d(flat_w).
//    So a repeat gives bit-identical results.
//  * Nothing wide is stored: the mids are rebuilt slab by slab (64 columns,
//    all d3 components) in shared memory with one or two FMAs each; dBLK for
//    the slab sits beside them.  Neither a mid row nor a dmid row ever exists.
//  * dx_rot gathers: m1 = +-m3 sends the components of one column to
//    different x offsets, and all paths of a source to the same ones.
//    Host-side tables group each slab's (m3, column, term) entries by x
//    offset, so one thread owns an (edge, x offset) and sums its entries in a
//    fixed order, without races.
//  * Without the coupling slots and the sh tile a 16-edge tile needs ~104 KB
//    of shared memory at the bench plans (the lab-frame backward fits 8 edges
//    in 83 KB), so every barrier covers twice the work and the Wcat slabs are
//    read half as often; the launch bounds cap registers at 64 so that two
//    512-thread blocks still share an SM and one's barriers overlap the
//    other's work.
//  * The ragged last tile is masked: rows past E load zeros and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 16;         // edges per tile
constexpr int MIN_BLOCKS = 2;  // blocks per SM the register budget allows
constexpr int KS = 64;         // BLK columns per shared-memory slab
constexpr int AST = KS + 4;    // mid/dBLK slab row stride (floats)
constexpr int NT = 512;        // threads per block
constexpr int GRP_W = 7;       // ints per output-chunk record
constexpr int SLAB_W = 2;      // ints per slab record
constexpr int XG_W = 3;        // ints per x-group record
constexpr int RED_NT = 256;    // threads per block of the reduce

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// shared-memory layout (floats):
// G [TE*gmax] | w [TE][KS] | Wcat slab [KS][odd(V)] | mid [d3*TE][AST] |
// dBLK [d3*TE][AST]
__host__ __device__ inline size_t smem_floats(int gmax, int d3_max, int v_max) {
  return (size_t)TE * gmax + (size_t)TE * KS + (size_t)KS * odd_stride(v_max) +
         2 * (size_t)d3_max * TE * AST;
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS) zonal_tp_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ wcat, const float* __restrict__ gy,
    const int* __restrict__ grp, const int2* __restrict__ zsrc,
    const float2* __restrict__ zcoef, const int* __restrict__ wcol,
    const int* __restrict__ slab_base, const int* __restrict__ slab,
    const int* __restrict__ xgrp, const int* __restrict__ lst,
    const float* __restrict__ lcoef, float* __restrict__ dx,
    float* __restrict__ dw, float* __restrict__ part, int E, int d_in, int n_ch,
    int d_out, int n_groups, int linear_numel, int gmax, int d3_max, int v_max,
    int tiles_per_block, int n_tiles, int has_w) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int VP = odd_stride(v_max);
  float* G_s = smem;
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

    for (int k = 0; k < n_groups; ++k) {
      const int* gm = grp + (size_t)k * GRP_W;
      const int out_base = gm[0], d3 = gm[1], V = gm[2], wofs = gm[3];
      const int fan_in = gm[4], rec_ofs = gm[5], col_ofs = gm[6];
      const int M = d3 * TE;
      __syncthreads();  // the previous chunk is done with G

      // 1. the chunk's output gradient, G[(m3*TE + e)*V + v]
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
        __syncthreads();  // G_s ready; the previous slab is consumed

        // 2a. mid slab (unscaled) and the radial weights of its columns
        for (int idx = t; idx < TE * KS; idx += NT) {
          const int e = idx / KS, c = idx - e * KS;
          if (c < nc && e < n_rows) {
            const float* xr = x + (size_t)(e0 + e) * d_in;
            w_s[e * KS + c] =
                has_w ? __ldg(w + (size_t)(e0 + e) * n_ch + __ldg(wcol + col_ofs + c0 + c))
                      : 1.f;
            const int2* sr = zsrc + rec_ofs + c0 + c;
            const float2* cr = zcoef + rec_ofs + c0 + c;
            for (int m = 0; m < d3; ++m, sr += fan_in, cr += fan_in) {
              const int2 so = __ldg(sr);
              const float2 cf = __ldg(cr);
              float val = cf.x * __ldg(xr + so.x);
              if (cf.y != 0.f) val += cf.y * __ldg(xr + so.y);
              A_s[(m * TE + e) * AST + c] = val;
            }
          } else {
            w_s[e * KS + c] = 0.f;
            for (int m = 0; m < d3; ++m) A_s[(m * TE + e) * AST + c] = 0.f;
          }
        }
        // 2b. Wcat slab, odd row stride
        for (int idx = t; idx < KS * V; idx += NT) {
          const int c = idx / V, v = idx - c * V;
          B_s[c * VP + v] = c < nc ? __ldg(wcat + wofs + (size_t)(c0 + c) * V + v) : 0.f;
        }
        __syncthreads();

        // 2c. dBLK[r, c] = sum_v G[r, v] Wcat[c, v]
        for (int idx = t; idx < M * KS; idx += NT) {
          const int r = idx / KS, c = idx - r * KS;
          const float* gr = G_s + r * V;
          const float* br = B_s + c * VP;
          float acc = 0.f;
          for (int v = 0; v < V; ++v) acc += gr[v] * br[v];
          D_s[r * AST + c] = acc;
        }
        // 2d. this block's dWcat partial: sum_r mid[r, c] w[e, c] G[r, v]
        for (int idx = t; idx < nc * V; idx += NT) {
          const int c = idx / V, v = idx - c * V;
          float acc = 0.f;
          for (int r = 0; r < M; ++r)
            acc += A_s[r * AST + c] * w_s[(r % TE) * KS + c] * G_s[r * V + v];
          float* p = prow + wofs + (size_t)c0 * V + idx;
          *p = first ? acc : *p + acc;
        }
        __syncthreads();

        // 2e. dw[e, wc] += sum_m3 dBLK mid; then dBLK -> dmid = dBLK * w
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
              float* p = dw + (size_t)(e0 + e) * n_ch + wcol[col_ofs + c0 + c];
              *p += acc;
            }
          }
        }
        __syncthreads();

        // 2f. dx_rot: one thread per (edge, x offset) sums its entries in order
        const int xg_ofs = sl[0], n_xg = sl[1];
        for (int idx = t; idx < TE * n_xg; idx += NT) {
          const int e = idx / n_xg, g = idx - e * n_xg;
          if (e >= n_rows) continue;
          const int* xg = xgrp + (size_t)(xg_ofs + g) * XG_W;
          const int xo = xg[0], lo = xg[1], n = xg[2];
          float acc = 0.f;
          for (int j = 0; j < n; ++j) {
            const int code = __ldg(lst + lo + j);  // m3 * KS + slab column
            const int m = code / KS, c = code - m * KS;
            acc += __ldg(lcoef + lo + j) * D_s[(m * TE + e) * AST + c];
          }
          dx[(size_t)(e0 + e) * d_in + xo] += acc;
        }
      }
    }
  }
}

// d(flat_w)[wcat_idx[k]] = wcat_scale[k] * sum_b part[b, k], blocks in order
__global__ void zonal_tp_bwd_reduce(const float* __restrict__ part, int nblk,
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
size_t zonal_tp_bwd_smem_bytes(int gmax, int d3_max, int v_max) {
  return smem_floats(gmax, d3_max, v_max) * sizeof(float);
}

// BLK columns per slab (the host's slab tables must use the same) and the
// edges per tile.
int zonal_tp_bwd_slab_cols(void) { return KS; }
int zonal_tp_bwd_tile_edges(void) { return TE; }

// Blocks resident on the whole card at this shared-memory size: the grid
// size, each block walking a contiguous range of edge tiles.
int zonal_tp_bwd_resident_blocks(size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (cudaFuncSetAttribute(zonal_tp_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zonal_tp_bwd_kernel,
                                                    NT, smem) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// Tables as in zonal_tp_fwd, plus per output chunk the index of its first
// slab (slab_base), per slab (first x group, number of x groups), per x
// group (x offset, offset into lst/lcoef, count), and per entry its
// m3 * KS + slab column (lst) and coefficient (lcoef).
int zonal_tp_bwd(const float* x, const float* w, const float* wcat,
                 const float* gy, const int* grp, const int* zsrc,
                 const float* zcoef, const int* wcol, const int* slab_base,
                 const int* slab, const int* xgrp, const int* lst,
                 const float* lcoef, const float* wcat_scale,
                 const int64_t* wcat_idx, float* dx, float* dw, float* part,
                 float* dflat, int E, int d_in, int n_ch, int d_out,
                 int n_groups, int linear_numel, int gmax, int d3_max,
                 int v_max, int nblk, int tiles_per_block, int has_w,
                 void* stream) {
  if (E <= 0 || n_groups <= 0) return 0;
  const int n_tiles = (E + TE - 1) / TE;
  if (nblk < 1 || tiles_per_block < 1 || (long long)nblk * tiles_per_block < n_tiles ||
      (nblk - 1) * tiles_per_block >= n_tiles || v_max < 1 || v_max > NT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = zonal_tp_bwd_smem_bytes(gmax, d3_max, v_max);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      zonal_tp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  zonal_tp_bwd_kernel<<<nblk, NT, smem, st>>>(
      x, w, wcat, gy, grp, reinterpret_cast<const int2*>(zsrc),
      reinterpret_cast<const float2*>(zcoef), wcol, slab_base, slab, xgrp, lst,
      lcoef, dx, dw, part, E, d_in, n_ch, d_out, n_groups, linear_numel, gmax,
      d3_max, v_max, tiles_per_block, n_tiles, has_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zonal_tp_bwd_reduce<<<(linear_numel + RED_NT - 1) / RED_NT, RED_NT, 0, st>>>(
      part, nblk, linear_numel, wcat_scale, wcat_idx, dflat);
  return (int)cudaGetLastError();
}

const char* zonal_tp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
