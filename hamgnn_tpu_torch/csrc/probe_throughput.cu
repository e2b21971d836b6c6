// Hopper throughput probes of the primitives of the TP mid stage.
//
// Counterparts of the timed Pallas kernels of tools_dev/vpu_probe.py (p1,
// p3, p4, p4b, p4c, p5, p6, p7) at its sizes: E edges, S = 25 spherical
// components, D1 = 5, MUL = 24, K = 40 (K*MUL = 960 columns per chunk, a slab
// of D1*K*MUL = 4,800 columns), the Wcat-stage product (E,2048) @ (2048,64).
// Each times one primitive alone, so that a redesign of the fused kernels
// knows its rates on this card:
//
//   p1  per i: W_i = sh @ Crep_i, x_i tiled K times, multiply, add   (ops)
//   p3  the same function as one wide product W = sh @ Crep (all D1
//       blocks at once), one multiply, a tree sum over the D1 blocks   (ops)
//   p4 / p4b / p4c  8 sweeps acc *= b (fp32, bf16x2) or acc += a*b (FFMA)
//       over the slab                                                 (bytes)
//   p4c_ns256  p4c with 256 sweeps, enough arithmetic per byte to read the
//       FFMA rate of the card (the original stops at 8)                 (ops)
//   p5  the tiling of x alone                                         (bytes)
//   p6  sh @ Crep alone, written out                                  (bytes)
//   p7  (E,2048) @ (2048,64) in fp32 FFMA, and p7_tf32 the same on the
//       tensor cores (wmma m16n16k8, tf32 operands, fp32 accumulate)   (ops / bytes)
//
// What bounds each on an H100 is in brackets.  The TPU versions re-read the
// slab from VMEM on every sweep; here a thread keeps its elements in
// registers across the sweeps, so p4/p4c move each byte once and are bound by
// device memory.  The products stage their operands in shared memory and
// accumulate register tiles of 8 x 4 (p1, p6, p7) or 5 x 4 x 4 (p3) per
// thread; p7 and p7_tf32 load the next stage with cp.async while they compute
// on the current one (depth 64 and two stages were the best of a sweep over
// depths 16-128 and 2-6 stages, all within 15% wherever three blocks fit an SM).
// No library call, no atomics.  They take E as a multiple of 64.
//
// C interface: probe_<name>(inputs..., out, E, stream) returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int S = 25, D1 = 5, MUL = 24, K = 40;
constexpr int KM = K * MUL;   // 960
constexpr int W = D1 * KM;    // 4800
constexpr int XW = D1 * MUL;  // 120
constexpr int NS = 8;         // sweeps
constexpr int NS_DEEP = 256;  // sweeps of p4c_ns256
constexpr int FAN = 2048, V = 64;

constexpr int BM = 64;  // edges per block of the products
constexpr int BN = 96;  // columns per block of p1, p3, p6: 4 * MUL

// ---- staging ---------------------------------------------------------------

// rows [e0, e0 + BM) of g (E x width) into s, row-major
__device__ __forceinline__ void stage_rows(float* s, const float* __restrict__ g,
                                           int e0, int width) {
  const float* src = g + (size_t)e0 * width;
  for (int i = threadIdx.x; i < BM * width; i += blockDim.x) s[i] = src[i];
}

// rows [e0, e0 + BM) of sh (E x S) into s transposed, [s][BM], so that a
// thread reads the components of its 4 or 8 edges with 16-byte loads
__device__ __forceinline__ void stage_sh_t(float* s, const float* __restrict__ sh,
                                           int e0) {
  const float* src = sh + (size_t)e0 * S;
  for (int i = threadIdx.x; i < BM * S; i += blockDim.x) s[i] = src[(i % BM) * S + i / BM];
}

// columns [n0, n0 + BN) of the D1 blocks of crep (S x W) into s as [i][s][BN]
__device__ __forceinline__ void stage_crep(float* s, const float* __restrict__ crep,
                                           int n0) {
  for (int t = threadIdx.x; t < D1 * S * BN; t += blockDim.x) {
    const int c = t % BN, sr = (t / BN) % S, i = t / (BN * S);
    s[t] = crep[(size_t)sr * W + i * KM + n0 + c];
  }
}

// ---- p1: per i, dot + tile + multiply + add --------------------------------

// grid (E / BM, KM / BN), 192 threads: thread (eg, cg) owns edges eg*8..+7
// and columns cg*4..+3 of the block's tile
__global__ void __launch_bounds__(192)
p1_kernel(const float* __restrict__ x, const float* __restrict__ sh,
          const float* __restrict__ crep, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* sh_s = smem;               // S x BM (transposed)
  float* x_s = sh_s + BM * S;       // BM x XW
  float* c_s = x_s + BM * XW;       // D1 x S x BN
  const int e0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  stage_sh_t(sh_s, sh, e0);
  stage_rows(x_s, x, e0, XW);
  stage_crep(c_s, crep, n0);
  __syncthreads();
  const int eg = threadIdx.x / 24, cg = threadIdx.x % 24;
  const int xm = (cg * 4) % MUL;  // n0 is a multiple of MUL
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < D1; ++i) {
    float wv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[j][q] = 0.f;
#pragma unroll 5
    for (int s = 0; s < S; ++s) {
      const float4 c4 = *reinterpret_cast<const float4*>(&c_s[(i * S + s) * BN + cg * 4]);
      const float4 a0 = *reinterpret_cast<const float4*>(&sh_s[s * BM + eg * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sh_s[s * BM + eg * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wv[j][0] += a[j] * c4.x;
        wv[j][1] += a[j] * c4.y;
        wv[j][2] += a[j] * c4.z;
        wv[j][3] += a[j] * c4.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b4 = *reinterpret_cast<const float4*>(
          &x_s[(eg * 8 + j) * XW + i * MUL + xm]);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[j][q] = (i == 0) ? wv[j][q] * b[q] : acc[j][q] + wv[j][q] * b[q];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(&out[(size_t)(e0 + eg * 8 + j) * KM + n0 + cg * 4]) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}

// ---- p3: one wide product, one multiply, tree sum --------------------------

// grid as p1, 384 threads: thread (eg, cg) owns edges eg*4..+3 and columns
// cg*4..+3 of all D1 blocks
__global__ void __launch_bounds__(384)
p3_kernel(const float* __restrict__ x, const float* __restrict__ sh,
          const float* __restrict__ crep, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* sh_s = smem;
  float* x_s = sh_s + BM * S;
  float* c_s = x_s + BM * XW;
  const int e0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  stage_sh_t(sh_s, sh, e0);
  stage_rows(x_s, x, e0, XW);
  stage_crep(c_s, crep, n0);
  __syncthreads();
  const int eg = threadIdx.x / 24, cg = threadIdx.x % 24;
  const int xm = (cg * 4) % MUL;
  float wv[D1][4][4];
#pragma unroll
  for (int i = 0; i < D1; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[i][j][q] = 0.f;
#pragma unroll 5
  for (int s = 0; s < S; ++s) {
    const float4 a4 = *reinterpret_cast<const float4*>(&sh_s[s * BM + eg * 4]);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      const float4 c4 = *reinterpret_cast<const float4*>(&c_s[(i * S + s) * BN + cg * 4]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wv[i][j][0] += a[j] * c4.x;
        wv[i][j][1] += a[j] * c4.y;
        wv[i][j][2] += a[j] * c4.z;
        wv[i][j][3] += a[j] * c4.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float p[D1][4];
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      const float4 b4 = *reinterpret_cast<const float4*>(
          &x_s[(eg * 4 + j) * XW + i * MUL + xm]);
      p[i][0] = wv[i][j][0] * b4.x;
      p[i][1] = wv[i][j][1] * b4.y;
      p[i][2] = wv[i][j][2] * b4.z;
      p[i][3] = wv[i][j][3] * b4.w;
    }
    float r[4];
    // the halving tree of the original over D1 = 5 blocks
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = ((p[0][q] + p[2][q]) + (p[1][q] + p[3][q])) + p[4][q];
    *reinterpret_cast<float4*>(&out[(size_t)(e0 + eg * 4 + j) * KM + n0 + cg * 4]) =
        make_float4(r[0], r[1], r[2], r[3]);
  }
}

// ---- p4, p4b, p4c: sweeps over the slab ------------------------------------

__global__ void p4_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                          float4* __restrict__ out, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 acc = a[i];
    const float4 bv = b[i];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      acc.x *= bv.x;
      acc.y *= bv.y;
      acc.z *= bv.z;
      acc.w *= bv.w;
    }
    out[i] = acc;
  }
}

// eight bf16 values (four __nv_bfloat162) per thread and step
__global__ void p4b_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                           uint4* __restrict__ out, size_t n8) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    uint4 av = a[i];
    const uint4 bv = b[i];
    __nv_bfloat162* acc = reinterpret_cast<__nv_bfloat162*>(&av);
    const __nv_bfloat162* bb = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = __hmul2(acc[q], bb[q]);
    out[i] = av;
  }
}

template <int SWEEPS>
__global__ void p4c_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                           float4* __restrict__ out, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 av = a[i], bv = b[i];
    float4 acc = av;
#pragma unroll 32
    for (int s = 0; s < SWEEPS; ++s) {
      acc.x = fmaf(av.x, bv.x, acc.x);
      acc.y = fmaf(av.y, bv.y, acc.y);
      acc.z = fmaf(av.z, bv.z, acc.z);
      acc.w = fmaf(av.w, bv.w, acc.w);
    }
    out[i] = acc;
  }
}

// ---- p5: the tiling alone --------------------------------------------------

// 8 edges per block: x rows staged, each D1 block of MUL columns written K
// times side by side, 16 bytes per thread and store
__global__ void p5_kernel(const float* __restrict__ x, float* __restrict__ out, int E) {
  constexpr int TB = 8;
  __shared__ __align__(16) float xs[TB * XW];
  const int e0 = blockIdx.x * TB;
  for (int i = threadIdx.x; i < TB * XW; i += blockDim.x) {
    const int e = e0 + i / XW;
    xs[i] = e < E ? x[(size_t)e0 * XW + i] : 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < TB * (W / 4); t += blockDim.x) {
    const int r = t / (W / 4), c = (t % (W / 4)) * 4;
    const int i = c / KM, m = (c % KM) % MUL;
    if (e0 + r < E)
      *reinterpret_cast<float4*>(&out[(size_t)(e0 + r) * W + c]) =
          *reinterpret_cast<const float4*>(&xs[r * XW + i * MUL + m]);
  }
}

// ---- p6: sh @ Crep alone ---------------------------------------------------

// grid (E / BM, W / BN), 192 threads, thread tile 8 x 4
__global__ void __launch_bounds__(192)
p6_kernel(const float* __restrict__ sh, const float* __restrict__ crep,
          float* __restrict__ out) {
  __shared__ __align__(16) float sh_s[BM * S];
  __shared__ __align__(16) float c_s[S * BN];
  const int e0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  stage_rows(sh_s, sh, e0, S);
  for (int t = threadIdx.x; t < S * BN; t += blockDim.x)
    c_s[t] = crep[(size_t)(t / BN) * W + n0 + t % BN];
  __syncthreads();
  const int eg = threadIdx.x / 24, cg = threadIdx.x % 24;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  for (int s = 0; s < S; ++s) {
    const float4 c4 = *reinterpret_cast<const float4*>(&c_s[s * BN + cg * 4]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = sh_s[(eg * 8 + j) * S + s];
      acc[j][0] += a * c4.x;
      acc[j][1] += a * c4.y;
      acc[j][2] += a * c4.z;
      acc[j][3] += a * c4.w;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(&out[(size_t)(e0 + eg * 8 + j) * W + n0 + cg * 4]) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}

// ---- p7: (E, FAN) @ (FAN, V) -----------------------------------------------

constexpr int KC = 64;        // depth of one stage
constexpr int AP = KC + 4;    // padded row of the A tile (16-byte multiple)
constexpr int BP = V + 4;     // padded row of the B tile
constexpr int STAGES = 2;     // stages in the cp.async ring: one loads while one computes
constexpr int STAGE_FLOATS = BM * AP + KC * BP;
constexpr size_t P7_SMEM = (size_t)STAGES * STAGE_FLOATS * sizeof(float);

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start the copies of one stage: A rows e0.. x depth k0.. into as (BM x AP),
// B depth k0.. into bs (KC x BP); 16 bytes per copy, no registers in between
__device__ __forceinline__ void issue_p7(float* as, float* bs,
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int e0, int k0) {
  for (int t = threadIdx.x; t < BM * (KC / 4); t += blockDim.x) {
    const int r = t / (KC / 4), kq = (t % (KC / 4)) * 4;
    cp_async16(&as[r * AP + kq], &a[(size_t)(e0 + r) * FAN + k0 + kq]);
  }
  for (int t = threadIdx.x; t < KC * (V / 4); t += blockDim.x) {
    const int k = t / (V / 4), nq = (t % (V / 4)) * 4;
    cp_async16(&bs[k * BP + nq], &b[(size_t)(k0 + k) * V + nq]);
  }
}

// The ring: STAGES - 1 stages are in flight while compute(as, bs) works on
// one.  The barrier at the top of step `it` also frees the stage computed
// at it - 1, which is the one the step then refills.
template <typename Compute>
__device__ __forceinline__ void p7_pipeline(const float* __restrict__ a,
                                            const float* __restrict__ b, int e0,
                                            Compute compute) {
  extern __shared__ __align__(32) float ring[];
  constexpr int NK = FAN / KC;
  for (int st = 0; st < STAGES - 1; ++st) {
    float* dst = ring + st * STAGE_FLOATS;
    issue_p7(dst, dst + BM * AP, a, b, e0, st * KC);
    cp_async_commit();
  }
  for (int it = 0; it < NK; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < NK) {
      float* dst = ring + (nxt % STAGES) * STAGE_FLOATS;
      issue_p7(dst, dst + BM * AP, a, b, e0, nxt * KC);
    }
    cp_async_commit();
    const float* as = ring + (it % STAGES) * STAGE_FLOATS;
    compute(as, as + BM * AP);
  }
}

// fp32 FFMA: grid E / BM, 128 threads, thread tile 8 x 4
__global__ void __launch_bounds__(128)
p7_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out) {
  const int e0 = blockIdx.x * BM;
  const int eg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  p7_pipeline(a, b, e0, [&](const float* as, const float* bs) {
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 bv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[kk] = *reinterpret_cast<const float4*>(&bs[(k + kk) * BP + cg * 4]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 av = *reinterpret_cast<const float4*>(&as[(eg * 8 + j) * AP + k]);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[j][0] += ak[kk] * bv[kk].x;
          acc[j][1] += ak[kk] * bv[kk].y;
          acc[j][2] += ak[kk] * bv[kk].z;
          acc[j][3] += ak[kk] * bv[kk].w;
        }
      }
    }
  });
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(&out[(size_t)(e0 + eg * 8 + j) * V + cg * 4]) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}

// tensor cores: grid E / BM, 4 warps, warp w owns rows 16w..16w+15 and all V
// columns as four m16n16k8 accumulators; operands rounded to tf32
__global__ void __launch_bounds__(128)
p7_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out) {
  using namespace nvcuda;
  const int e0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[V / 16];
#pragma unroll
  for (int n = 0; n < V / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  p7_pipeline(a, b, e0, [&](const float* as, const float* bs) {
#pragma unroll
    for (int k = 0; k < KC; k += 8) {
      wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> af;
      wmma::load_matrix_sync(af, &as[warp * 16 * AP + k], AP);
#pragma unroll
      for (int t = 0; t < af.num_elements; ++t) af.x[t] = wmma::__float_to_tf32(af.x[t]);
#pragma unroll
      for (int n = 0; n < V / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &bs[k * BP + n * 16], BP);
#pragma unroll
        for (int t = 0; t < bf.num_elements; ++t) bf.x[t] = wmma::__float_to_tf32(bf.x[t]);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
  });
#pragma unroll
  for (int n = 0; n < V / 16; ++n)
    wmma::store_matrix_sync(&out[(size_t)(e0 + warp * 16) * V + n * 16], acc[n], V,
                            wmma::mem_row_major);
}

template <typename Kern>
cudaError_t launch_p7(Kern kern, const float* a, const float* b, float* out, int E,
                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P7_SMEM);
  if (err != cudaSuccess) return err;
  kern<<<E / BM, 128, P7_SMEM, st>>>(a, b, out);
  return cudaGetLastError();
}

constexpr size_t P13_SMEM = (size_t)(BM * S + BM * XW + D1 * S * BN) * sizeof(float);

template <typename Kern>
cudaError_t launch_p13(Kern kern, int threads, const float* x, const float* sh,
                       const float* crep, float* out, int E, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P13_SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(E / BM, KM / BN), threads, P13_SMEM, st>>>(x, sh, crep, out);
  return cudaGetLastError();
}

inline int sweep_blocks(void) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (sms > 0 ? sms : 132) * 8;
}

}  // namespace

extern "C" {

// the row multiple the products take E in
int probe_throughput_edge_quantum(void) { return BM; }

int probe_p1(const float* x, const float* sh, const float* crep, float* out,
             int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_p13(p1_kernel, 192, x, sh, crep, out, E, (cudaStream_t)stream);
}

int probe_p3(const float* x, const float* sh, const float* crep, float* out,
             int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_p13(p3_kernel, 384, x, sh, crep, out, E, (cudaStream_t)stream);
}

int probe_p4(const float* a, const float* b, float* out, int E, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  p4_kernel<<<sweep_blocks(), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
      reinterpret_cast<float4*>(out), (size_t)E * W / 4);
  return (int)cudaGetLastError();
}

// a, b, out: bf16
int probe_p4b(const void* a, const void* b, void* out, int E, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  p4b_kernel<<<sweep_blocks(), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
      reinterpret_cast<uint4*>(out), (size_t)E * W / 8);
  return (int)cudaGetLastError();
}

int probe_p4c(const float* a, const float* b, float* out, int E, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  p4c_kernel<NS><<<sweep_blocks(), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
      reinterpret_cast<float4*>(out), (size_t)E * W / 4);
  return (int)cudaGetLastError();
}

int probe_p4c_ns256(const float* a, const float* b, float* out, int E, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  p4c_kernel<NS_DEEP><<<sweep_blocks(), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
      reinterpret_cast<float4*>(out), (size_t)E * W / 4);
  return (int)cudaGetLastError();
}

int probe_p5(const float* x, float* out, int E, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  p5_kernel<<<(E + 7) / 8, 256, 0, (cudaStream_t)stream>>>(x, out, E);
  return (int)cudaGetLastError();
}

int probe_p6(const float* sh, const float* crep, float* out, int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  p6_kernel<<<dim3(E / BM, W / BN), 192, 0, (cudaStream_t)stream>>>(sh, crep, out);
  return (int)cudaGetLastError();
}

int probe_p7(const float* a, const float* b, float* out, int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_p7(p7_kernel, a, b, out, E, (cudaStream_t)stream);
}

int probe_p7_tf32(const float* a, const float* b, float* out, int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_p7(p7_tf32_kernel, a, b, out, E, (cudaStream_t)stream);
}

const char* probe_throughput_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
