// Zonal (edge-frame) TP -> radial scale -> equivariant Linear, forward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_zonal.py `_zfwd_call`
// (ZonalPallasSpec._fwd_body / _mids).  Its input is x already rotated into
// the edge frame, where the spherical harmonics are a constant and the CG
// contraction leaves at most two terms per mid column.  Per edge e, output
// chunk (b, d3, V), component m3 and BLK column c of the chunk:
//
//   mid[e,m3,c]  = c1[m3,c] * x_rot[e, xo1[m3,c]] + c2[m3,c] * x_rot[e, xo2[m3,c]]
//   BLK[e,m3,c]  = mid[e,m3,c] * w[e, wc[c]]                    (w optional)
//   out_rot[e, b + v*d3 + m3] = sum_c BLK[e,m3,c] * Wcat[c, v]  (Wcat GEMM)
//
// The rotations themselves (batched Wigner-D products) run outside, as they
// do in the JAX package.
//
// What bounds it.  The function moves x_rot, w and out_rot once (14 KB per
// edge at the node plan) and does ~0.2 MFLOP per edge, almost all in the
// Wcat product: 16 FLOP per byte, under the H100's fp32 CUDA-core ridge of 20
// (67 TFLOP/s over 3.35 TB/s), so its bound is the bytes.  Inside the kernel
// the limit is the same as in packed_tp_fwd.cu: shared-memory traffic of the
// product and the barriers between a slab's build and its product.
//
// What the design does about it.
//  * The TPU kernel builds a whole edge tile's mids in VMEM by tiling x
//    blocks along lanes and multiplying by coefficient vectors.  Here nothing
//    wide is stored: one block owns TE edges and one output chunk, and builds
//    the BLK operand slab by slab (KS columns, all d3 components) in shared
//    memory in the GEMM's prologue: one or two FMAs per element from a
//    host-side table, no coupling stage, no sh tile.
//  * Unlike the lab-frame kernel the sources depend on m3 (m1 = +-m3), so the
//    table has one record per (chunk, m3, column): two x offsets and two
//    coefficients; the radial-weight column depends on the column alone.
//  * x_rot and out_rot use the plan's u-major layouts, so the rotations
//    before and after are plain batched products on views.
//  * The product is packed_tp_fwd.cu's: one B value in a register per
//    column, RMAX row accumulators per thread, A rows read as float4.
//  * The ragged last tile is masked: rows past E load zeros and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 16;       // edges per block
constexpr int KS = 64;       // BLK columns per shared-memory slab
constexpr int AST = KS + 4;  // A-slab row stride (floats), keeps float4 alignment
constexpr int NT = 512;      // threads per block
constexpr int GRP_W = 7;     // ints per output-chunk record

template <int RMAX>
__global__ void __launch_bounds__(NT) zonal_tp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ wcat, const int* __restrict__ grp,
    const int2* __restrict__ zsrc, const float2* __restrict__ zcoef,
    const int* __restrict__ wcol, float* __restrict__ out, int E, int d_in,
    int n_ch, int d_out, int has_w) {
  extern __shared__ __align__(16) float smem[];
  const int* gm = grp + (size_t)blockIdx.y * GRP_W;
  const int out_base = gm[0], d3 = gm[1], V = gm[2], wofs = gm[3];
  const int fan_in = gm[4], rec_ofs = gm[5], col_ofs = gm[6];
  const int e0 = blockIdx.x * TE;
  const int t = threadIdx.x;
  const int n_rows = min(TE, E - e0);

  float* A_s = smem;                 // [d3*TE][AST], row m3*TE + e
  float* B_s = A_s + d3 * TE * AST;  // [KS][V]

  // thread -> (v, row group); rows rg, rg + NG, ... of the d3*TE rows
  const int M = d3 * TE;
  const int NG = NT / V;
  const int v = t % V;
  const int rg = t / V;
  const bool active = rg < NG && rg < M;
  const int R = (M + NG - 1) / NG;
  float acc[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < fan_in; c0 += KS) {
    __syncthreads();  // the previous slab is consumed
    // 1. BLK slab: per (edge, column) its d3 two-term mids, scaled by w
    for (int idx = t; idx < TE * KS; idx += NT) {
      const int e = idx / KS, c = idx - e * KS;
      const int gc = c0 + c;
      if (gc < fan_in && e < n_rows) {
        const float* xr = x + (size_t)(e0 + e) * d_in;
        const float sc =
            has_w ? __ldg(w + (size_t)(e0 + e) * n_ch + __ldg(wcol + col_ofs + gc))
                  : 1.f;
        const int2* sr = zsrc + rec_ofs + gc;
        const float2* cr = zcoef + rec_ofs + gc;
        for (int m = 0; m < d3; ++m, sr += fan_in, cr += fan_in) {
          const int2 so = __ldg(sr);
          const float2 cf = __ldg(cr);
          float val = cf.x * __ldg(xr + so.x);
          if (cf.y != 0.f) val += cf.y * __ldg(xr + so.y);
          A_s[(m * TE + e) * AST + c] = val * sc;
        }
      } else {
        for (int m = 0; m < d3; ++m) A_s[(m * TE + e) * AST + c] = 0.f;
      }
    }
    // 2. Wcat slab
    for (int idx = t; idx < KS * V; idx += NT) {
      const int c = idx / V;
      const int gc = c0 + c;
      B_s[idx] = gc < fan_in ? __ldg(wcat + wofs + (size_t)gc * V + (idx - c * V)) : 0.f;
    }
    __syncthreads();
    // 3. product over the d3*TE rows
    if (active) {
#pragma unroll 4
      for (int c = 0; c < KS; c += 4) {
        const float b0 = B_s[(c + 0) * V + v];
        const float b1 = B_s[(c + 1) * V + v];
        const float b2 = B_s[(c + 2) * V + v];
        const float b3 = B_s[(c + 3) * V + v];
#pragma unroll
        for (int j = 0; j < RMAX; ++j) {
          const int r = rg + NG * j;
          if (j < R && r < M) {
            const float4 a = *reinterpret_cast<const float4*>(A_s + r * AST + c);
            acc[j] += a.x * b0 + a.y * b1 + a.z * b2 + a.w * b3;
          }
        }
      }
    }
  }

  // 4. write out_rot[e, b + v*d3 + m3] (u-major irreps layout)
  if (active) {
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
      const int r = rg + NG * j;
      if (j < R && r < M) {
        const int m3 = r / TE, e = r - m3 * TE;
        if (e < n_rows) out[(size_t)(e0 + e) * d_out + out_base + v * d3 + m3] = acc[j];
      }
    }
  }
}

template <int RMAX>
cudaError_t launch(const float* x, const float* w, const float* wcat,
                   const int* grp, const int2* zsrc, const float2* zcoef,
                   const int* wcol, float* out, int E, int d_in, int n_ch,
                   int d_out, int n_groups, size_t smem, int has_w,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      zonal_tp_fwd_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((E + TE - 1) / TE, n_groups);
  zonal_tp_fwd_kernel<RMAX><<<grid, NT, smem, stream>>>(
      x, w, wcat, grp, zsrc, zcoef, wcol, out, E, d_in, n_ch, d_out, has_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the launch needs, in bytes, for the largest d3 and V of the
// plan's output chunks (the wrapper checks it against the card).
size_t zonal_tp_fwd_smem_bytes(int d3_max, int v_max) {
  return (size_t)(d3_max * TE * AST + KS * v_max) * sizeof(float);
}

// Rows of the product one thread accumulates for a chunk of (d3, V), and the
// most the kernel takes.
int zonal_tp_fwd_rows_per_thread(int d3, int v) {
  const int ng = NT / v;
  return ng > 0 ? (d3 * TE + ng - 1) / ng : -1;
}
int zonal_tp_fwd_max_rows(void) { return 32; }

// grp: n_groups records (out offset b, d3, V, Wcat offset, fan_in, record
// offset, column offset); zsrc/zcoef: per (chunk, m3, column) record two x
// offsets and two coefficients, at record offset + m3 * fan_in + column;
// wcol: per column of a chunk its radial-weight column, at column offset +
// column.
int zonal_tp_fwd(const float* x, const float* w, const float* wcat,
                 const int* grp, const int* zsrc, const float* zcoef,
                 const int* wcol, float* out, int E, int d_in, int n_ch,
                 int d_out, int n_groups, int d3_max, int v_max, int r_max,
                 int has_w, void* stream) {
  if (E <= 0 || n_groups <= 0) return 0;
  if (v_max < 1 || v_max > NT || r_max < 1 || r_max > 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = zonal_tp_fwd_smem_bytes(d3_max, v_max);
  cudaStream_t st = (cudaStream_t)stream;
  const int2* zs = reinterpret_cast<const int2*>(zsrc);
  const float2* zc = reinterpret_cast<const float2*>(zcoef);
  cudaError_t err;
  if (r_max <= 4)
    err = launch<4>(x, w, wcat, grp, zs, zc, wcol, out, E, d_in, n_ch, d_out,
                    n_groups, smem, has_w, st);
  else if (r_max <= 8)
    err = launch<8>(x, w, wcat, grp, zs, zc, wcol, out, E, d_in, n_ch, d_out,
                    n_groups, smem, has_w, st);
  else if (r_max <= 16)
    err = launch<16>(x, w, wcat, grp, zs, zc, wcol, out, E, d_in, n_ch, d_out,
                     n_groups, smem, has_w, st);
  else
    err = launch<32>(x, w, wcat, grp, zs, zc, wcol, out, E, d_in, n_ch, d_out,
                     n_groups, smem, has_w, st);
  return (int)err;
}

const char* zonal_tp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
