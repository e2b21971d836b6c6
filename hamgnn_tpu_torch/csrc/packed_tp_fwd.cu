// Packed TP -> radial scale -> equivariant Linear, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel hamgnn_tpu/e3/pallas_tp.py `_fwd_call`
// (PallasSpec._fwd_body / _mids).  It computes what PackedTPPlan._apply
// computes, for every edge e:
//
//   W_g[e,i,k]   = sum_s sh[e,s] * C_g[s,i,k]                 (coupling)
//   mid_g[e,k,u] = sum_i W_g[e,i,k] * x[e, g, u, i]           (broadcast FMA)
//   BLK[e,m3,c]  = mid[e, column c of output chunk, m3] * w[e, c]   (w optional)
//   out[e, b + v*d3 + m3] = sum_c BLK[e,m3,c] * Wcat[c, v]    (Wcat GEMM)
//
// What bounds it.  At the bench widths the function does about 20-40 FLOP
// per byte of operands in fp32 (no TF32 here), above the H100's ~20 FLOP/byte
// ridge for fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s): its bound is the
// operations, chiefly the Wcat product.  Inside the kernel the limit is
// instruction issue and latency: the BLK operand is built by gathers, and
// barriers separate each slab's build from its product.
//
// What the design does about it.
//  * The TPU held a whole edge tile's mids in 120 MB of VMEM and repeated
//    every coupling column `mul` times (its VPU cannot repeat elements).
//    Here nothing wide is ever stored: one block owns TE edges and one output
//    chunk; it computes only the W_g entries that chunk needs (once per edge,
//    then broadcast over u) and builds the BLK operand of the Wcat product
//    slab by slab (KS columns) in shared memory, in the GEMM's prologue.  A
//    mid row (up to ~50 KB per edge) never exists.
//  * All d3 components m3 of the chunk share a column's x values, radial
//    weight and Wcat row; only the coupling slot differs.  So one thread
//    loads a column's x and w once and writes its d3 BLK rows, and the
//    product runs on d3 * TE rows at once: small-multiplicity chunks (V = 2,
//    d3 = 9) keep every thread busy and a chunk needs one pass, not d3.
//  * All layout work is host-side int32 tables (see e3/tp_kernel.py): per
//    BLK column its coupling slot, d1, x offset (reference u-major layout, so
//    no x permutation) and radial-weight column; per coupling slot its
//    nonzero coupling range.  The output is written straight into the
//    u-major irreps layout.
//  * The GEMM keeps one B value in a register per column and RMAX row
//    accumulators per thread, reading A rows as float4 broadcasts.
//  * The ragged last tile is masked: rows past E load zeros and store nothing.
// A later PR may move the product to wgmma/TMA; this one stays plain fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 16;       // edges per block
constexpr int KS = 64;       // BLK columns per shared-memory slab
constexpr int AST = KS + 4;  // A-slab row stride (floats), keeps float4 alignment
constexpr int NT = 512;      // threads per block
constexpr int MAXD1 = 13;    // largest input irrep dimension (l1 <= 6)
constexpr int GRP_W = 8;     // ints per output-chunk record
constexpr int COL_W = 4;     // ints per column record
constexpr int Q_W = 3;       // ints per coupling-slot record

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// shared-memory layout: sh [TE][S] | W [TE][odd(nq_all)] | A [d3*TE][AST] | B [KS][V]
__host__ __device__ inline int a_offset(int S, int nq_all_max) {
  return (TE * (S + odd_stride(nq_all_max)) + 3) & ~3;
}

template <int RMAX>
__global__ void __launch_bounds__(NT) packed_tp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ sh,
    const float* __restrict__ w, const float* __restrict__ wcat,
    const float* __restrict__ coef, const int* __restrict__ grp,
    const int* __restrict__ col, const int* __restrict__ qtab,
    float* __restrict__ out, int E, int d_in, int S, int n_ch, int d_out,
    int nq_all_max, int has_w) {
  extern __shared__ __align__(16) float smem[];
  const int* gm = grp + (size_t)blockIdx.y * GRP_W;
  const int out_base = gm[0], d3 = gm[1], V = gm[2], wofs = gm[3];
  const int fan_in = gm[4], col_ofs = gm[5], q_ofs = gm[6], nq = gm[7];
  const int nq_all = nq * d3;
  const int nqp = odd_stride(nq_all);
  const int e0 = blockIdx.x * TE;
  const int t = threadIdx.x;
  const int n_rows = min(TE, E - e0);

  float* sh_s = smem;                           // [TE][S]
  float* W_s = sh_s + TE * S;                   // [TE][nqp]  (odd stride)
  float* A_s = smem + a_offset(S, nq_all_max);  // [d3*TE][AST], row m3*TE + e
  float* B_s = A_s + d3 * TE * AST;             // [KS][V]

  // 1. the tile's SH rows (contiguous in global memory)
  {
    const float* sg = sh + (size_t)e0 * S;
    const int ns = n_rows * S;
    for (int idx = t; idx < TE * S; idx += NT) sh_s[idx] = idx < ns ? sg[idx] : 0.f;
  }
  __syncthreads();

  // 2. the coupling entries W_g[e,i,k] of this output chunk, all m3
  for (int idx = t; idx < TE * nq_all; idx += NT) {
    const int q = idx / TE, e = idx - q * TE;
    const int* qm = qtab + (size_t)(q_ofs + q) * Q_W;
    const float* cf = coef + qm[0];
    const float* sr = sh_s + e * S + qm[1];
    float acc = 0.f;
    for (int s = 0; s < qm[2]; ++s) acc += cf[s] * sr[s];
    W_s[e * nqp + q] = acc;
  }

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
    __syncthreads();  // W_s ready / previous slab consumed
    // 3a. BLK slab: for each (edge, column) the d3 mids of that column
    for (int idx = t; idx < TE * KS; idx += NT) {
      const int e = idx / KS, c = idx - e * KS;
      const int gc = c0 + c;
      if (gc < fan_in && e < n_rows) {
        const int* cm = col + (size_t)(col_ofs + gc) * COL_W;
        const int qb = cm[0], d1 = cm[1];
        const float* xr = x + (size_t)(e0 + e) * d_in + cm[2];
        float xv[MAXD1];
#pragma unroll
        for (int i = 0; i < MAXD1; ++i) xv[i] = i < d1 ? __ldg(xr + i) : 0.f;
        const float sc = has_w ? __ldg(w + (size_t)(e0 + e) * n_ch + cm[3]) : 1.f;
        const float* wr = W_s + e * nqp + qb;
        for (int m = 0; m < d3; ++m, wr += nq) {
          float val = 0.f;
#pragma unroll
          for (int i = 0; i < MAXD1; ++i)
            if (i < d1) val += wr[i] * xv[i];
          A_s[(m * TE + e) * AST + c] = val * sc;
        }
      } else {
        for (int m = 0; m < d3; ++m) A_s[(m * TE + e) * AST + c] = 0.f;
      }
    }
    // 3b. Wcat slab
    for (int idx = t; idx < KS * V; idx += NT) {
      const int c = idx / V;
      const int gc = c0 + c;
      B_s[idx] = gc < fan_in ? __ldg(wcat + wofs + (size_t)gc * V + (idx - c * V)) : 0.f;
    }
    __syncthreads();
    // 3c. product over the d3*TE rows
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

  // 4. write out[e, b + v*d3 + m3] (u-major irreps layout)
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
cudaError_t launch(const float* x, const float* sh, const float* w,
                   const float* wcat, const float* coef, const int* grp,
                   const int* col, const int* qtab, float* out, int E,
                   int d_in, int S, int n_ch, int d_out, int n_groups,
                   int nq_all_max, size_t smem, int has_w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_tp_fwd_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((E + TE - 1) / TE, n_groups);
  packed_tp_fwd_kernel<RMAX><<<grid, NT, smem, stream>>>(
      x, sh, w, wcat, coef, grp, col, qtab, out, E, d_in, S, n_ch, d_out,
      nq_all_max, has_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the launch needs, in bytes, for the largest chunk's
// d3 * nq coupling slots, d3 and V (the wrapper checks it against the card).
size_t packed_tp_fwd_smem_bytes(int S, int nq_all_max, int d3_max, int v_max) {
  return (size_t)(a_offset(S, nq_all_max) + d3_max * TE * AST + KS * v_max) *
         sizeof(float);
}

// Rows of the product one thread accumulates for a chunk of (d3, V).
int packed_tp_fwd_rows_per_thread(int d3, int v) {
  const int ng = NT / v;
  return ng > 0 ? (d3 * TE + ng - 1) / ng : -1;
}

// Largest number of rows per thread the kernel takes, and its input-irrep
// dimension limit.
int packed_tp_fwd_max_rows(void) { return 32; }
int packed_tp_fwd_max_d1(void) { return MAXD1; }

int packed_tp_fwd(const float* x, const float* sh, const float* w,
                  const float* wcat, const float* coef, const int* grp,
                  const int* col, const int* qtab, float* out, int E, int d_in,
                  int S, int n_ch, int d_out, int n_groups, int nq_all_max,
                  int d3_max, int v_max, int r_max, int has_w, void* stream) {
  if (E <= 0 || n_groups <= 0) return 0;
  if (v_max < 1 || v_max > NT || r_max < 1 || r_max > 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = packed_tp_fwd_smem_bytes(S, nq_all_max, d3_max, v_max);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (r_max <= 4)
    err = launch<4>(x, sh, w, wcat, coef, grp, col, qtab, out, E, d_in, S,
                    n_ch, d_out, n_groups, nq_all_max, smem, has_w, st);
  else if (r_max <= 8)
    err = launch<8>(x, sh, w, wcat, coef, grp, col, qtab, out, E, d_in, S,
                    n_ch, d_out, n_groups, nq_all_max, smem, has_w, st);
  else if (r_max <= 16)
    err = launch<16>(x, sh, w, wcat, coef, grp, col, qtab, out, E, d_in, S,
                     n_ch, d_out, n_groups, nq_all_max, smem, has_w, st);
  else
    err = launch<32>(x, sh, w, wcat, coef, grp, col, qtab, out, E, d_in, S,
                     n_ch, d_out, n_groups, nq_all_max, smem, has_w, st);
  return (int)err;
}

const char* packed_tp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
