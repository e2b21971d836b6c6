// Hopper probes of the primitives the fused TP kernels are built from.
//
// Counterparts of the Pallas closures of tools_dev/mosaic_probe.py (k_repeat
// ... k_slice_dot; TE=128, K=16, MUL=64) and tools_dev/mosaic_probe2.py
// (k_tile ... k_dot_t and the gridded k_acc; TE=128, K=25, MUL=48).  Those
// asked whether Mosaic lowers a lane tile, a (TE,K*MUL)<->(TE,K,MUL) reshape,
// a lane reduce, a small product, and with which semantics.  A GPU has no
// lane layout: every reshape, slice, tile and repeat below is index
// arithmetic on a row-major tile, which is what these probes establish; what
// they keep of the originals is the function and the staging.  The closures
// held whole (TE, K*MUL) arrays in VMEM (512 KB at K*MUL=1024); a block has
// at most 227 KB of shared memory, so one block per 128-row tile walks its
// tile in slices of RS rows, each staged in (static, < 48 KB) shared memory.
//
// Every probe is bound by bytes (a few hundred KB at most) and by launch
// latency; none is tuned.  Products are shared-memory FFMA loops in fp32, in
// the order of the contraction index, no library call.  k_acc crosses
// blocks: per-tile partial products, then one block adds them in tile order
// (the order of the sequential Pallas grid), so a repeat is bit-identical;
// no atomics.
//
// C interface: probe_<name>(inputs..., out[, scratch], rows, stream) returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int TE = 128;  // rows of a tile: one block each
constexpr int RS = 8;    // rows of the tile staged in shared memory at a time
constexpr int NT = 256;  // threads per block
constexpr int NV = 24;   // columns of the small products

constexpr int K1 = 16, M1 = 64, KM1 = K1 * M1;  // mosaic_probe.py
constexpr int K2 = 25, M2 = 48, KM2 = K2 * M2;  // mosaic_probe2.py

// rows [r0, r0 + RS) x columns [c0, c0 + width) of g (leading dimension ld)
// into s (RS x width, row-major); rows past `rows` as zeros
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g,
                                      int r0, int rows, int width, int ld,
                                      int c0) {
  for (int i = threadIdx.x; i < RS * width; i += NT) {
    const int r = i / width, c = i - r * width;
    s[i] = (r0 + r < rows) ? g[(size_t)(r0 + r) * ld + c0 + c] : 0.f;
  }
}

// the slices of this block's tile
#define FOR_SLICES(r0)                                                  \
  for (int r0 = (int)blockIdx.x * TE, r_end = min(rows, r0 + TE); \
       r0 < r_end; r0 += RS)

// ---- mosaic_probe.py -------------------------------------------------------

// k_repeat (:37): (TE,K) -> (TE,4K), the lane TILE a|a|a|a
__global__ void k_repeat_kernel(const float* __restrict__ a,
                                float* __restrict__ o, int rows) {
  __shared__ float s[RS * K1];
  FOR_SLICES(r0) {
    stage(s, a, r0, rows, K1, K1, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * 4 * K1; i += NT) {
      const int r = i / (4 * K1), j = i % (4 * K1);
      if (r0 + r < rows) o[(size_t)(r0 + r) * 4 * K1 + j] = s[r * K1 + j % K1];
    }
    __syncthreads();
  }
}

// k_squeeze (:48): view (TE,K,MUL), row 3 of the middle axis -> (TE,MUL)
__global__ void k_squeeze_kernel(const float* __restrict__ x,
                                 float* __restrict__ o, int rows) {
  __shared__ float s[RS * KM1];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, KM1, KM1, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * M1; i += NT) {
      const int r = i / M1, m = i % M1;
      if (r0 + r < rows) o[(size_t)(r0 + r) * M1 + m] = s[r * KM1 + 3 * M1 + m];
    }
    __syncthreads();
  }
}

// k_merge128 (:56) and k_merge64 (:64): view (TE,G,L), add 1, merge back to
// (TE,G*L); L = 128 merged on the TPU, L = 64 did not
template <int G, int L>
__device__ __forceinline__ void merge_body(const float* __restrict__ x,
                                           float* __restrict__ o, int rows) {
  __shared__ float s[RS * G * L];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, G * L, G * L, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * G * L; i += NT) {
      const int r = i / (G * L), g = (i / L) % G, l = i % L;
      if (r0 + r < rows)
        o[(size_t)(r0 + r) * G * L + g * L + l] = s[(r * G + g) * L + l] + 1.0f;
    }
    __syncthreads();
  }
}

__global__ void k_merge128_kernel(const float* __restrict__ x,
                                  float* __restrict__ o, int rows) {
  merge_body<8, 128>(x, o, rows);
}

__global__ void k_merge64_kernel(const float* __restrict__ x,
                                 float* __restrict__ o, int rows) {
  merge_body<K1, M1>(x, o, rows);
}

// k_outer (:71): sum_k a[r,k] * b[r,m] -> (TE,MUL)
__global__ void k_outer_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ o, int rows) {
  __shared__ float sa[RS * K1], sb[RS * M1];
  FOR_SLICES(r0) {
    stage(sa, a, r0, rows, K1, K1, 0);
    stage(sb, b, r0, rows, M1, M1, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * M1; i += NT) {
      const int r = i / M1, m = i % M1;
      float acc = 0.f;
      for (int k = 0; k < K1; ++k) acc += sa[r * K1 + k] * sb[r * M1 + m];
      if (r0 + r < rows) o[(size_t)(r0 + r) * M1 + m] = acc;
    }
    __syncthreads();
  }
}

// k_lred (:79): view (TE,K,MUL), sum over the last axis -> (TE,K)
__global__ void k_lred_kernel(const float* __restrict__ x,
                              float* __restrict__ o, int rows) {
  __shared__ float s[RS * KM1];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, KM1, KM1, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * K1; i += NT) {
      const int r = i / K1, k = i % K1;
      float acc = 0.f;
      for (int m = 0; m < M1; ++m) acc += s[r * KM1 + k * M1 + m];
      if (r0 + r < rows) o[(size_t)(r0 + r) * K1 + k] = acc;
    }
    __syncthreads();
  }
}

// k_atadd (:86): zeros (TE,K*MUL) with x[:, :128] added into columns 64..191
__global__ void k_atadd_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int rows) {
  __shared__ float s[RS * 128];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, 128, KM1, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * KM1; i += NT) {
      const int r = i / KM1, c = i % KM1;
      float v = 0.f;
      if (c >= 64 && c < 64 + 128) v += s[r * 128 + c - 64];
      if (r0 + r < rows) o[(size_t)(r0 + r) * KM1 + c] = v;
    }
    __syncthreads();
  }
}

// k_gather (:94): columns 0, K, 2K, ... -> (TE,MUL)
__global__ void k_gather_kernel(const float* __restrict__ x,
                                float* __restrict__ o, int rows) {
  __shared__ float s[RS * KM1];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, KM1, KM1, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * M1; i += NT) {
      const int r = i / M1, j = i % M1;
      if (r0 + r < rows) o[(size_t)(r0 + r) * M1 + j] = s[r * KM1 + j * K1];
    }
    __syncthreads();
  }
}

// s (RS x depth, staged) @ w (depth x NV, staged) -> rows r0.. of o
__device__ __forceinline__ void slice_dot(const float* s, const float* sw,
                                          int depth, float* __restrict__ o,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < RS * NV; i += NT) {
    const int r = i / NV, n = i % NV;
    float acc = 0.f;
    for (int k = 0; k < depth; ++k) acc += s[r * depth + k] * sw[k * NV + n];
    if (r0 + r < rows) o[(size_t)(r0 + r) * NV + n] = acc;
  }
}

// k_dot (:101): (TE,MUL) @ (MUL,24)
__global__ void k_dot_kernel(const float* __restrict__ a,
                             const float* __restrict__ w,
                             float* __restrict__ o, int rows) {
  __shared__ float s[RS * M1], sw[M1 * NV];
  for (int i = threadIdx.x; i < M1 * NV; i += NT) sw[i] = w[i];
  FOR_SLICES(r0) {
    stage(s, a, r0, rows, M1, M1, 0);
    __syncthreads();
    slice_dot(s, sw, M1, o, r0, rows);
    __syncthreads();
  }
}

// k_slice_dot (:110): view (TE,K,MUL), rows 2 and 3 of the middle axis
// added, then @ (MUL,24)
__global__ void k_slice_dot_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   float* __restrict__ o, int rows) {
  __shared__ float s2[RS * 2 * M1], s[RS * M1], sw[M1 * NV];
  for (int i = threadIdx.x; i < M1 * NV; i += NT) sw[i] = w[i];
  FOR_SLICES(r0) {
    stage(s2, x, r0, rows, 2 * M1, KM1, 2 * M1);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * M1; i += NT) {
      const int r = i / M1, m = i % M1;
      s[i] = s2[r * 2 * M1 + m] + s2[r * 2 * M1 + M1 + m];
    }
    __syncthreads();
    slice_dot(s, sw, M1, o, r0, rows);
    __syncthreads();
  }
}

// ---- mosaic_probe2.py ------------------------------------------------------

// k_tile (:33): (TE,MUL) tiled K times along the columns -> (TE,K*MUL)
__global__ void k_tile_kernel(const float* __restrict__ a,
                              float* __restrict__ o, int rows) {
  __shared__ float s[RS * M2];
  FOR_SLICES(r0) {
    stage(s, a, r0, rows, M2, M2, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * KM2; i += NT) {
      const int r = i / KM2, j = i % KM2;
      if (r0 + r < rows) o[(size_t)(r0 + r) * KM2 + j] = s[r * M2 + j % M2];
    }
    __syncthreads();
  }
}

// k_erep (:44): each element of (TE,K) repeated MUL times -> (TE,K*MUL)
__global__ void k_erep_kernel(const float* __restrict__ a,
                              float* __restrict__ o, int rows) {
  __shared__ float s[RS * K2];
  FOR_SLICES(r0) {
    stage(s, a, r0, rows, K2, K2, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * KM2; i += NT) {
      const int r = i / KM2, j = i % KM2;
      if (r0 + r < rows) o[(size_t)(r0 + r) * KM2 + j] = s[r * K2 + j / M2];
    }
    __syncthreads();
  }
}

// k_split_sum (:55): view (TE,K,MUL), sum over the middle axis (the dx op)
__global__ void k_split_sum_kernel(const float* __restrict__ x,
                                   float* __restrict__ o, int rows) {
  __shared__ float s[RS * KM2];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, KM2, KM2, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * M2; i += NT) {
      const int r = i / M2, m = i % M2;
      float acc = 0.f;
      for (int k = 0; k < K2; ++k) acc += s[r * KM2 + k * M2 + m];
      if (r0 + r < rows) o[(size_t)(r0 + r) * M2 + m] = acc;
    }
    __syncthreads();
  }
}

// k_bc_merge (:67): (TE,K,1) broadcast to (TE,K,MUL), merged to (TE,K*MUL);
// walked over the three axes of the broadcast, not over the merged columns
__global__ void k_bc_merge_kernel(const float* __restrict__ a,
                                  float* __restrict__ o, int rows) {
  __shared__ float s[RS * K2];
  FOR_SLICES(r0) {
    stage(s, a, r0, rows, K2, K2, 0);
    __syncthreads();
    for (int rk = threadIdx.x / M2; rk < RS * K2; rk += NT / M2) {
      const int r = rk / K2, k = rk % K2, m = threadIdx.x % M2;
      if (threadIdx.x < (NT / M2) * M2 && r0 + r < rows)
        o[((size_t)(r0 + r) * K2 + k) * M2 + m] = s[r * K2 + k];
    }
    __syncthreads();
  }
}

// k_rep_slice (:76): columns 3..9 of (TE,K) tiled 5 times -> (TE,35)
__global__ void k_rep_slice_kernel(const float* __restrict__ a,
                                   float* __restrict__ o, int rows) {
  __shared__ float s[RS * 7];
  FOR_SLICES(r0) {
    stage(s, a, r0, rows, 7, K2, 3);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * 35; i += NT) {
      const int r = i / 35, j = i % 35;
      if (r0 + r < rows) o[(size_t)(r0 + r) * 35 + j] = s[r * 7 + j % 7];
    }
    __syncthreads();
  }
}

// k_concat (:83): column block i scaled by i, the K blocks side by side
__global__ void k_concat_kernel(const float* __restrict__ x,
                                float* __restrict__ o, int rows) {
  __shared__ float s[RS * KM2];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, KM2, KM2, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < RS * KM2; i += NT) {
      const int r = i / KM2, j = i % KM2;
      if (r0 + r < rows)
        o[(size_t)(r0 + r) * KM2 + j] = s[i] * (float)(j / M2);
    }
    __syncthreads();
  }
}

// k_dot_odd (:91): columns 7..126 of (TE,K*MUL) @ (120,24)
__global__ void k_dot_odd_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 float* __restrict__ o, int rows) {
  __shared__ float s[RS * 120], sw[120 * NV];
  for (int i = threadIdx.x; i < 120 * NV; i += NT) sw[i] = w[i];
  FOR_SLICES(r0) {
    stage(s, x, r0, rows, 120, KM2, 7);
    __syncthreads();
    slice_dot(s, sw, 120, o, r0, rows);
    __syncthreads();
  }
}

// a_tile^T (MUL x TE) @ b_tile[:, :NV] -> (MUL, NV), the contraction over
// the TE rows of one tile in row order; a (TE,MUL) and b (TE,ldb) staged whole
__device__ __forceinline__ void tile_dot_t(const float* __restrict__ a,
                                           const float* __restrict__ b, int ldb,
                                           float* sa, float* sb,
                                           float* __restrict__ o) {
  for (int i = threadIdx.x; i < TE * M2; i += NT) sa[i] = a[i];
  for (int i = threadIdx.x; i < TE * NV; i += NT)
    sb[i] = b[(size_t)(i / NV) * ldb + i % NV];
  __syncthreads();
  for (int i = threadIdx.x; i < M2 * NV; i += NT) {
    const int m = i / NV, n = i % NV;
    float acc = 0.f;
    for (int r = 0; r < TE; ++r) acc += sa[r * M2 + m] * sb[r * NV + n];
    o[i] = acc;
  }
}

// k_dot_t (:100): (TE,MUL)^T @ (TE,24) -> (MUL,24), the dWcat op; one tile
__global__ void k_dot_t_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ o) {
  __shared__ float sa[TE * M2], sb[TE * NV];
  tile_dot_t(a, b, NV, sa, sb, o);
}

// k_acc (:111), first pass: tile t's a_t^T @ a_t[:, :24] into part[t]
__global__ void k_acc_partial_kernel(const float* __restrict__ a,
                                     float* __restrict__ part) {
  __shared__ float sa[TE * M2], sb[TE * NV];
  const float* at = a + (size_t)blockIdx.x * TE * M2;
  tile_dot_t(at, at, M2, sa, sb, part + (size_t)blockIdx.x * M2 * NV);
}

// k_acc, second pass: out (64,32) = 0, out[3:3+MUL, :24] += part[t] for t in
// tile order, as the sequential grid adds them
__global__ void k_acc_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ o, int n_tiles) {
  for (int i = threadIdx.x; i < 64 * 32; i += NT) {
    const int r = i / 32, c = i % 32;
    float acc = 0.f;
    if (r >= 3 && r < 3 + M2 && c < NV)
      for (int t = 0; t < n_tiles; ++t)
        acc += part[((size_t)t * M2 + (r - 3)) * NV + c];
    o[i] = acc;
  }
}

inline int tiles(int rows) { return (rows + TE - 1) / TE; }

}  // namespace

#define ROWWISE_1(name, kernel)                                          \
  int probe_##name(const float* a, float* o, int rows, void* stream) {   \
    if (rows <= 0) return 0;                                             \
    kernel<<<tiles(rows), NT, 0, (cudaStream_t)stream>>>(a, o, rows);    \
    return (int)cudaGetLastError();                                      \
  }

#define ROWWISE_2(name, kernel)                                          \
  int probe_##name(const float* a, const float* b, float* o, int rows,   \
                   void* stream) {                                       \
    if (rows <= 0) return 0;                                             \
    kernel<<<tiles(rows), NT, 0, (cudaStream_t)stream>>>(a, b, o, rows); \
    return (int)cudaGetLastError();                                      \
  }

extern "C" {

ROWWISE_1(k_repeat, k_repeat_kernel)
ROWWISE_1(k_squeeze, k_squeeze_kernel)
ROWWISE_1(k_merge128, k_merge128_kernel)
ROWWISE_1(k_merge64, k_merge64_kernel)
ROWWISE_2(k_outer, k_outer_kernel)
ROWWISE_1(k_lred, k_lred_kernel)
ROWWISE_1(k_atadd, k_atadd_kernel)
ROWWISE_1(k_gather, k_gather_kernel)
ROWWISE_2(k_dot, k_dot_kernel)
ROWWISE_2(k_slice_dot, k_slice_dot_kernel)

ROWWISE_1(k_tile, k_tile_kernel)
ROWWISE_1(k_erep, k_erep_kernel)
ROWWISE_1(k_split_sum, k_split_sum_kernel)
ROWWISE_1(k_bc_merge, k_bc_merge_kernel)
ROWWISE_1(k_rep_slice, k_rep_slice_kernel)
ROWWISE_1(k_concat, k_concat_kernel)
ROWWISE_2(k_dot_odd, k_dot_odd_kernel)

// one tile: rows must be TE
int probe_k_dot_t(const float* a, const float* b, float* o, int rows,
                  void* stream) {
  if (rows != TE) return (int)cudaErrorInvalidValue;
  k_dot_t_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(a, b, o);
  return (int)cudaGetLastError();
}

// rows a multiple of TE; part: scratch of (rows / TE) * MUL * 24 floats
int probe_k_acc(const float* a, float* o, float* part, int rows,
                void* stream) {
  if (rows <= 0 || rows % TE != 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = rows / TE;
  k_acc_partial_kernel<<<n_tiles, NT, 0, (cudaStream_t)stream>>>(a, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_acc_reduce_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(part, o, n_tiles);
  return (int)cudaGetLastError();
}

const char* probe_ops_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
