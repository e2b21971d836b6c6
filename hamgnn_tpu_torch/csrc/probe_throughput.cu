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
//       tensor cores (mma.sync m16n8k8, tf32 operands, fp32 accumulate) (ops / bytes)
//
// What bounds each on an H100 is in brackets.  The TPU versions re-read the
// slab from VMEM on every sweep; here a thread keeps its elements in
// registers across the sweeps, so p4/p4c move each byte once and are bound by
// device memory.
//
// p1, p3, p6 and p7_tf32 are persistent: a fixed number of blocks, each with
// its own even share of the work.  p6 (bound by the 383 MB it writes at E =
// 19,968), p1 and p3 (bound by their products) keep a panel of Crep in shared
// memory, already split for 3xTF32 mma.sync, and walk edge tiles, p6 two
// blocks an SM with 192 columns of one D1 block, p1 and p3 (one template, the
// summing order a compile-time parameter) two an SM with 96 columns of all
// five, the sum over i in registers; the stores of a tile drain while the
// next one computes.  p7 is bound by its FFMAs: 128 x 64 tiles with
// 8 x 8 register tiles a thread (16 shared loads of 16 bytes feed 256 FFMA),
// the tiles' depth chunks split evenly over 396 blocks, three an SM ("stream-K"),
// so that all 132 SMs carry the same work, and a second kernel that adds each
// tile's partial sums in a fixed order (bit-identical on a repeat).  p7_tf32
// is bound by reading A: one block an SM streams its share of the rows
// through a five-stage ring of TMA copies on mbarriers, a loader warp and a
// converter warp (B rounded to TF32 once a stage) feeding four consumer warps.
// No library call, no atomics.  They take E as a multiple of 64.
//
// C interface: probe_<name>(inputs..., out[, scratch], E, stream) returns the
// cudaError_t of the launch; p7 alone takes scratch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "packed_tp_mma.cuh"

namespace {

constexpr int S = 25, D1 = 5, MUL = 24, K = 40;
constexpr int KM = K * MUL;   // 960
constexpr int W = D1 * KM;    // 4800
constexpr int XW = D1 * MUL;  // 120
constexpr int NS = 8;         // sweeps
constexpr int NS_DEEP = 256;  // sweeps of p4c_ns256
constexpr int FAN = 2048, V = 64;

constexpr int BM = 64;  // the row multiple the products take E in

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

// ---- cp.async and the mbarrier ring ----------------------------------------

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one arrival that also adds `bytes` to the transfers the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global into
// shared memory by the copy engine, counted on `bar` when they have landed
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// box (x, y) of a 2D tensor map (x the inner coordinate) into shared memory by
// the copy engine, counted on `bar` when it has landed
__device__ __forceinline__ void tensor_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// ---- p7_tf32: (E, FAN) @ (FAN, V) on the tensor cores ----------------------
//
// Bound by reading A once (E x 2,048 fp32: 164 MB at E = 19,968); its 5.2
// GFLOP take the tensor cores a fifth of that time.  So it is a stream: one
// persistent block an SM takes an even contiguous share of the rows (151 or
// 152 at E = 19,968; T7_TM a pass at most, so that B, which every row needs
// whole, is read once a pass: 69 MB from L2 in all, against 164 MB for
// 64-row tiles) and walks their depth in chunks of T7_KC through a ring of
// T7_STAGES stages, with three kinds of warps and no block-wide barrier in
// the loop:
//   - a loader warp refills a stage as soon as its consumers free it, with
//     two copies that complete on the stage's "full" mbarrier: one TMA box
//     of the share's rows x 32 depths of A (a tensor map made at launch, its
//     box as tall as the largest share, 128-byte swizzle) and one bulk copy
//     of B's 32 x 64 chunk.  The copy engine's cost goes by the request: on
//     an H100 boxes of 32 rows (five a chunk) took 0.079 ms, of 8 rows 0.113,
//     a bulk copy a row 0.34;
//   - a converter warp rounds each chunk of B to TF32 once, in mma.sync
//     fragment order, as soon as it lands, and says so on "bfull" (done by
//     the loader, it held the refills back: 0.071 ms against 0.066);
//   - T7_CW consumer warps, one an SM sub-partition, own m16 tiles q, q + 4,
//     q + 8 of a pass (32 fp32 accumulators a tile and lane), round their A
//     fragments, run mma.sync m16n8k8 and free the stage on "empty".
// The A stream alone (no B, no products) takes 0.057 ms of the 0.066.
//
// The depth of a 32-deep chunk is permuted so that a lane reads its A
// fragments with 16-byte loads: virtual k = tig (and tig + 4) of step s is
// depth 8 tig + s (and 8 tig + 4 + s), so lane (gid, tig) holds depths
// 8 tig .. 8 tig + 7 of its rows, the 16-byte pieces 2 tig and 2 tig + 1 of
// a 128-byte row, which the swizzle puts at pieces (2 tig) ^ gid and
// (2 tig + 1) ^ gid: distinct banks.  B's fragments follow the same depth
// map; the converter's lanes take their n8-tile pairs and column halves in a
// rotated order so that its loads, too, hit distinct banks.  Each output is
// summed by one lane in depth order: bit-identical on a repeat.  Rows past
// a block's share are read with it (at most 7, or beyond E zero-filled) but
// never written.

constexpr int T7_KC = 32;                        // depth of a chunk: one permuted block
constexpr int T7_STAGES = 5;
constexpr int T7_CW = 4;                         // consumer warps, one an SM sub-partition
constexpr int T7_TM = 160;                       // rows of a pass: ten m16 tiles
constexpr int T7_MT = 3;                         // m16 tiles of a consumer warp at most
constexpr int T7_NT = 32 * (T7_CW + 2);          // and the loader and converter warps
constexpr int T7_NKC = FAN / T7_KC;              // chunks a pass
constexpr int T7_A_FLOATS = T7_TM * T7_KC;       // rows of 128 bytes, swizzled
constexpr int T7_B_FLOATS = T7_KC * V;           // raw, then in fragment order
constexpr int T7_STAGE_FLOATS = T7_A_FLOATS + 2 * T7_B_FLOATS;
constexpr size_t T7_SMEM = (size_t)T7_STAGES * T7_STAGE_FLOATS * sizeof(float) + 1024 +
                           3 * T7_STAGES * sizeof(uint64_t);
static_assert(T7_KC == 32 && V == 64, "p7_tf32: one permuted 32-deep block a chunk, 8 n8 tiles");
static_assert(T7_TM / 16 <= T7_CW * T7_MT, "p7_tf32: every m16 tile of a pass has a warp");
static_assert((T7_STAGE_FLOATS * 4) % 1024 == 0, "p7_tf32: every stage's box on a 1,024-byte boundary");

// loader: start the copies of chunk c (pass c / T7_NKC) into a stage
__device__ __forceinline__ void t7_issue(float* stage, uint64_t* full, const CUtensorMap* amap,
                                         int box_rows, const float* __restrict__ b, int lo,
                                         int c) {
  const int row0 = lo + (c / T7_NKC) * T7_TM, k0 = (c % T7_NKC) * T7_KC;
  mbar_arrive_expect_tx(full, (unsigned)(box_rows * T7_KC + T7_B_FLOATS) * 4u);
  tensor_load_2d(stage, amap, k0, row0, full);
  bulk_load(stage + T7_A_FLOATS, b + (size_t)k0 * V, T7_B_FLOATS * 4, full);
}

// converter: B's chunk (raw, rows of 64) rounded to TF32 into fragment order:
// frag[((s * 4 + np) * 32 + lane) * 4 ..] = b0, b1 of n8 tile 2 np, then of
// 2 np + 1, for step s (b0 at depth 8 tig + s, b1 at +4).  Lane (gid, tig)
// takes pair np = (n + tig) % 4 at turn n, and lanes with tig >= 2 read the
// second column half first: the four lanes of a gid read four banks apart.
__device__ __forceinline__ void t7_convert(const float* raw, uint32_t* frag, int lane) {
  const int gid = lane / 4, tig = lane % 4, swap = tig >> 1;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int np = (n + tig) & 3;
      const float* r = raw + (8 * tig + s) * V + 16 * np + gid;  // depth 8 tig + s
      const float* first = r + 8 * swap;
      const float* second = r + 8 * (1 - swap);
      const uint32_t x0 = __float_as_uint(packed_tp::tf32_round(first[0]));
      const uint32_t x1 = __float_as_uint(packed_tp::tf32_round(first[4 * V]));
      const uint32_t y0 = __float_as_uint(packed_tp::tf32_round(second[0]));
      const uint32_t y1 = __float_as_uint(packed_tp::tf32_round(second[4 * V]));
      *reinterpret_cast<uint4*>(&frag[((s * 4 + np) * 32 + lane) * 4]) =
          swap ? make_uint4(y0, y1, x0, x1) : make_uint4(x0, x1, y0, y1);
    }
}

__global__ void __launch_bounds__(T7_NT, 1)
p7_tf32_kernel(const __grid_constant__ CUtensorMap amap, const float* __restrict__ b,
               float* __restrict__ out, int E, int box_rows) {
  extern __shared__ __align__(16) float t7_ring[];
  // the swizzled boxes land on 1,024-byte boundaries
  float* ring = t7_ring + ((1024 - (smem_addr(t7_ring) & 1023)) & 1023) / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T7_STAGES * T7_STAGE_FLOATS);
  uint64_t* bfull = full + T7_STAGES;  // B converted (32 converter lanes)
  uint64_t* empty = bfull + T7_STAGES; // stage free again (T7_CW consumer warps)
  // this block's rows: an even contiguous share of E
  const int lo = (int)((long long)E * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)E * (blockIdx.x + 1) / gridDim.x);
  if (lo >= hi) return;
  const int chunks = (hi - lo + T7_TM - 1) / T7_TM * T7_NKC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T7_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&bfull[s], 32);
      mbar_init(&empty[s], T7_CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T7_CW) {
    // loader: refill each stage once its consumers are done with it
    if (lane == 0)
      for (int c = 0; c < chunks; ++c) {
        const int st = c % T7_STAGES;
        if (c >= T7_STAGES) mbar_wait(&empty[st], (c / T7_STAGES - 1) & 1);
        t7_issue(ring + st * T7_STAGE_FLOATS, &full[st], &amap, box_rows, b, lo, c);
      }
    return;
  }
  if (warp == T7_CW + 1) {
    // converter: B of each chunk into fragment order as soon as it lands
    for (int c = 0; c < chunks; ++c) {
      const int st = c % T7_STAGES;
      float* stage = ring + st * T7_STAGE_FLOATS;
      mbar_wait(&full[st], (c / T7_STAGES) & 1);
      t7_convert(stage + T7_A_FLOATS, reinterpret_cast<uint32_t*>(stage + T7_A_FLOATS + T7_B_FLOATS),
                 lane);
      mbar_arrive(&bfull[st]);
    }
    return;
  }

  // consumers: warp w owns m16 tiles q, q + 4, q + 8 (below T7_TM / 16) of
  // each pass, q = (w + 2) % 4, so that the two warps with three tiles share
  // no SM sub-partition with the loader or the converter
  const int gid = lane / 4, tig = lane % 4, q0 = (warp + 2) % 4;
  float acc[T7_MT][8][4];
#pragma unroll
  for (int mt = 0; mt < T7_MT; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][n][r] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % T7_STAGES, par = (c / T7_STAGES) & 1;
    const int row0 = lo + (c / T7_NKC) * T7_TM, rows = min(T7_TM, hi - row0);
    const float* as = ring + st * T7_STAGE_FLOATS;
    const uint32_t* frag = reinterpret_cast<const uint32_t*>(as + T7_A_FLOATS + T7_B_FLOATS);
    mbar_wait(&full[st], par);
    mbar_wait(&bfull[st], par);
    // tile q0 + 4 mt holds rows of this pass (the same in every lane)
    bool live[T7_MT];
    uint32_t af[T7_MT][2][8];  // [tile][row gid / gid + 8][depth 8 tig + d]
#pragma unroll
    for (int mt = 0; mt < T7_MT; ++mt) {
      const int tile = q0 + 4 * mt;
      live[mt] = tile < T7_TM / 16 && 16 * tile < rows;
      if (live[mt])
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* src = as + (16 * tile + 8 * h + gid) * T7_KC;
          const float4 v0 = *reinterpret_cast<const float4*>(src + 4 * ((2 * tig) ^ gid));
          const float4 v1 = *reinterpret_cast<const float4*>(src + 4 * ((2 * tig + 1) ^ gid));
          const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int d = 0; d < 8; ++d) af[mt][h][d] = __float_as_uint(packed_tp::tf32_round(v[d]));
        }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const uint4 w = *reinterpret_cast<const uint4*>(&frag[((s * 4 + np) * 32 + lane) * 4]);
        const uint32_t b0[2] = {w.x, w.y}, b1[2] = {w.z, w.w};
#pragma unroll
        for (int mt = 0; mt < T7_MT; ++mt)
          if (live[mt]) {
            const uint32_t af4[4] = {af[mt][0][s], af[mt][1][s], af[mt][0][s + 4], af[mt][1][s + 4]};
            packed_tp::mma_tf32(acc[mt][2 * np], af4, b0);
            packed_tp::mma_tf32(acc[mt][2 * np + 1], af4, b1);
          }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (c % T7_NKC == T7_NKC - 1) {
      // the pass is done: its rows out, the sums cleared
#pragma unroll
      for (int mt = 0; mt < T7_MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * (q0 + 4 * mt) + 8 * h + gid;
          if (live[mt] && r < rows) {
            float* dst = out + (size_t)(row0 + r) * V + 2 * tig;
#pragma unroll
            for (int n = 0; n < 8; ++n)
              *reinterpret_cast<float2*>(&dst[8 * n]) =
                  make_float2(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
          }
        }
#pragma unroll
      for (int mt = 0; mt < T7_MT; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][n][r] = 0.f;
    }
  }
}

// ---- p6: sh @ Crep alone ---------------------------------------------------
//
// Bound by the 383 MB it writes.  Persistent blocks, two an SM, walk work
// items (panel, edge tile) in panel-major order, each block a contiguous run
// of them, so that it keeps its panel of Crep (P6_PN columns) in shared memory
// for all its tiles and loads one at most twice.  The product runs on the
// tensor cores in 3xTF32 (mma.sync m16n8k8, packed_tp_mma.cuh): depth 0..23
// as three k8 steps, depth 24, the last of S = 25, as one FFMA, so the short
// sum keeps fp32 accuracy.  The panel is split into big and small TF32 halves
// once, in B-fragment order (one 16-byte load a lane and k8 step); a warp
// splits its A fragments once a tile.  The sh tile of the next item loads by
// cp.async while this one computes, issued after the barrier at which every
// warp has left the item that last read its buffer.  Each warp owns 16 rows
// x 96 columns of a tile: its fragments go through its part of a staging
// tile in shared memory (a row stride of 8 mod 32 floats: conflict-free float2 writes) to
// 16-byte streaming stores (st.global.cs) of whole row segments, issued as
// soon as the warp is done, without waiting for the block: the stores drain
// while the other warps and the next tile compute (on an H100 this beat a
// barrier after the products and stores by the whole block).

constexpr int P6_BM = 64;               // edges per tile
constexpr int P6_PN = 192;              // columns per panel: 24 n8 tiles
constexpr int P6_PANELS = W / P6_PN;    // 25
constexpr int P6_KT = 3;                // k8 steps on the tensor cores (depth 0..23)
constexpr int P6_NT = 256;              // 8 warps: 4 row groups of 16 x 2 halves of the panel
constexpr int P6_WN = P6_PN / 2;        // columns of a warp
constexpr int P6_OS = P6_PN + 8;        // staging row stride
constexpr int P6_BFRAG = (P6_PN / 8) * P6_KT * 32 * 4;  // split panel, uint32
constexpr size_t P6_SMEM =
    (size_t)(P6_BFRAG + P6_PN + 2 * P6_BM * S + P6_BM * P6_OS) * sizeof(float);
static_assert(W % P6_PN == 0 && P6_KT * 8 + 1 == S, "p6 tiling");

// NJ n8 tiles of crep from column col0 into shared memory, split for 3xTF32:
// bf[((j * P6_KT + s) * 32 + lane) * 4 ..] = big b0, big b1, small b0, small b1
// of n8 tile j, k8 step s (b0 at depth 8s + tig, b1 at 8s + tig + 4, column
// col0 + 8j + gid), and depth 24 as b24[0 .. 8 NJ)
template <int NJ>
__device__ __forceinline__ void load_split_panel(uint32_t* bf, float* b24,
                                                 const float* __restrict__ crep, int col0) {
  for (int t = threadIdx.x; t < NJ * P6_KT * 32; t += blockDim.x) {
    const int lane = t % 32, s = (t / 32) % P6_KT, j = t / (32 * P6_KT);
    const int col = col0 + 8 * j + lane / 4, k = 8 * s + lane % 4;
    const float b[2] = {crep[(size_t)k * W + col], crep[(size_t)(k + 4) * W + col]};
    uint32_t big[2], small[2];
    packed_tp::split_tf32(b, big, small);
    *reinterpret_cast<uint4*>(&bf[4 * t]) = make_uint4(big[0], big[1], small[0], small[1]);
  }
  for (int c = threadIdx.x; c < 8 * NJ; c += blockDim.x) b24[c] = crep[(size_t)(S - 1) * W + col0 + c];
}

// rows [e0, e0 + P6_BM) of sh: 6,400 contiguous bytes
__device__ __forceinline__ void p6_issue_sh(float* dst, const float* __restrict__ sh, int e0) {
  const float* src = sh + (size_t)e0 * S;
  for (int q = threadIdx.x; q < P6_BM * S / 4; q += P6_NT) cp_async16(&dst[4 * q], &src[4 * q]);
}

__global__ void __launch_bounds__(P6_NT, 2)
p6_kernel(const float* __restrict__ sh, const float* __restrict__ crep,
          float* __restrict__ out, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* bf = reinterpret_cast<uint32_t*>(smem);
  float* b24 = smem + P6_BFRAG;
  float* sh_s = b24 + P6_PN;                 // two tiles of P6_BM x S
  float* st = sh_s + 2 * P6_BM * S;          // P6_BM x P6_OS
  const long long items = (long long)P6_PANELS * n_tiles;
  const long long lo = items * blockIdx.x / gridDim.x;
  const long long hi = items * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r0 = 16 * (warp % 4), j0 = (P6_WN / 8) * (warp / 4);  // first n8 tile
  int panel = -1;
  p6_issue_sh(sh_s, sh, (int)(lo % n_tiles) * P6_BM);
  cp_async_commit();
  for (long long it = lo; it < hi; ++it) {
    const int pn = (int)(it / n_tiles), e0 = (int)(it % n_tiles) * P6_BM;
    const float* cur = sh_s + ((it - lo) & 1) * P6_BM * S;
    // a new panel (the same test in every thread) waits until every warp is
    // done with the old one
    if (pn != panel) {
      __syncthreads();
      load_split_panel<P6_PN / 8>(bf, b24, crep, pn * P6_PN);
      panel = pn;
    }
    cp_async_wait<0>();
    // this tile and the panel are in place, and every warp is done with the
    // last item, so the other sh buffer is free for the next tile
    __syncthreads();
    if (it + 1 < hi)
      p6_issue_sh(sh_s + ((it + 1 - lo) & 1) * P6_BM * S, sh, (int)((it + 1) % n_tiles) * P6_BM);
    cp_async_commit();

    // A fragments of rows r0.., split once for all the warp's n8 tiles
    uint32_t abig[P6_KT][4], asmall[P6_KT][4];
#pragma unroll
    for (int s = 0; s < P6_KT; ++s) {
      const int k = 8 * s + tig;
      const float a[4] = {cur[(r0 + gid) * S + k], cur[(r0 + gid + 8) * S + k],
                          cur[(r0 + gid) * S + k + 4], cur[(r0 + gid + 8) * S + k + 4]};
      packed_tp::split_tf32(a, abig[s], asmall[s]);
    }
    const float a24lo = cur[(r0 + gid) * S + S - 1], a24hi = cur[(r0 + gid + 8) * S + S - 1];
#pragma unroll 4
    for (int j = j0; j < j0 + P6_WN / 8; ++j) {
      float hi_[4] = {0.f, 0.f, 0.f, 0.f}, lo_[4] = {0.f, 0.f, 0.f, 0.f},
            lo2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < P6_KT; ++s) {
        const uint4 b = *reinterpret_cast<const uint4*>(&bf[((j * P6_KT + s) * 32 + lane) * 4]);
        const uint32_t bb[2] = {b.x, b.y}, bs[2] = {b.z, b.w};
        packed_tp::mma_tf32(lo_, asmall[s], bb);
        packed_tp::mma_tf32(hi_, abig[s], bb);
        packed_tp::mma_tf32(lo2, abig[s], bs);
      }
      const int c = 8 * j + 2 * tig;
      const float2 b = *reinterpret_cast<const float2*>(&b24[c]);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = (lo_[q] + lo2[q]) + hi_[q];
      v[0] = fmaf(a24lo, b.x, v[0]);
      v[1] = fmaf(a24lo, b.y, v[1]);
      v[2] = fmaf(a24hi, b.x, v[2]);
      v[3] = fmaf(a24hi, b.y, v[3]);
      *reinterpret_cast<float2*>(&st[(r0 + gid) * P6_OS + c]) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(&st[(r0 + gid + 8) * P6_OS + c]) = make_float2(v[2], v[3]);
    }
    __syncwarp();

    // the warp stores its own 16 x P6_WN block as whole row segments, 16
    // bytes a lane and store, with no wait for the other warps; no other
    // warp touches this part of the staging tile
    const int c0 = 8 * j0;
    float* dst = out + (size_t)(e0 + r0) * W + pn * P6_PN + c0;
#pragma unroll
    for (int i = 0; i < 16 * P6_WN / 4 / 32; ++i) {
      const int q = lane + 32 * i, r = q / (P6_WN / 4), c = 4 * (q % (P6_WN / 4));
      __stcs(reinterpret_cast<float4*>(&dst[(size_t)r * W + c]),
             *reinterpret_cast<const float4*>(&st[(r0 + r) * P6_OS + c0 + c]));
    }
  }
}

// ---- p1 and p3: per i, dot + tile + multiply, summed over i ----------------
//
// Bound by their products: 4.96 GFLOP at E = 19,968 (counted in fp32), 77 MB
// written.  The two compute one function, out = sum over i of W_i x_i with
// W_i = sh @ Crep_i and x_i tiled, in two summing orders: p1 adds block by
// block (W_0 x_0, then + W_i x_i, one rounding a term), p3 rounds each
// product p_i = W_i x_i and adds them in its closure's halving tree,
// ((p0 + p2) + (p1 + p3)) + p4.  One template serves both, the order a
// compile-time parameter.  Laid out as p6: persistent blocks walk items
// (panel, 64-edge tile) in panel-major order, each block a contiguous run of
// them, and keep the panel for all its tiles.  A panel is PN output columns
// with their columns of all D1 = 5 blocks of Crep, split once into 3xTF32
// halves in B-fragment order; the sh tile of the next item loads by cp.async
// while this one computes.  Each warp owns 16 rows x 8 WJ columns (WJ n8
// tiles): per block i it forms W_i's fragments (depth 0..23 in 3xTF32
// mma.sync, depth 24 by one FFMA) and multiplies each by its x value (column
// c takes x[e, i * 24 + c mod 24]: a warp's columns start on a multiple of
// 24, so n8 tile q takes the three pairs 8 (q mod 3) + 2 tig, +1 of its two
// rows, read from global memory).  p3 walks the tree as four steps over the
// tiles, blocks 0, 2, then 1 and 3 together (their sum p1 + p3 lives only
// inside one tile's step), then 4, so that it keeps one set of sums, as p1
// does.  The sums stay in registers and leave as 8-byte streaming stores,
// whole 32-byte sectors.

template <int WJ>
struct P13Layout {
  static constexpr int NJ = 2 * WJ;                   // n8 tiles of a panel
  static constexpr int PN = 8 * NJ;                   // output columns of a panel
  static constexpr int PANELS = KM / PN;
  static constexpr int BFRAG = D1 * NJ * P6_KT * 32 * 4;
  static constexpr size_t SMEM = (size_t)(BFRAG + D1 * PN + 2 * P6_BM * S) * sizeof(float);
  static_assert(KM % PN == 0 && (8 * WJ) % MUL == 0,
                "p1/p3: a warp's columns start on a multiple of MUL");
};

// p1: 6 n8 tiles a warp, two blocks an SM (128 registers)
constexpr int P1_WJ = 6, P1_MINB = 2;
// p3: the same; a second set of sums is never live (see above)
constexpr int P3_WJ = 6, P3_MINB = 2;

// W_i's fragment of n8 tile j (rows gid, gid + 8, columns 2 tig, +1):
// depth 0..23 in 3xTF32 mma.sync from the split panel bfi of block i, depth
// 24 by FFMA from b24i
template <int NJ>
__device__ __forceinline__ void p13_wfrag(float (&v)[4], const uint32_t* bfi, const float* b24i,
                                          int j, int lane, const uint32_t (&abig)[P6_KT][4],
                                          const uint32_t (&asmall)[P6_KT][4], float a24lo,
                                          float a24hi) {
  float hi_[4] = {0.f, 0.f, 0.f, 0.f}, lo_[4] = {0.f, 0.f, 0.f, 0.f},
        lo2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < P6_KT; ++s) {
    const uint4 b = *reinterpret_cast<const uint4*>(&bfi[((j * P6_KT + s) * 32 + lane) * 4]);
    const uint32_t bb[2] = {b.x, b.y}, bs[2] = {b.z, b.w};
    packed_tp::mma_tf32(lo_, asmall[s], bb);
    packed_tp::mma_tf32(hi_, abig[s], bb);
    packed_tp::mma_tf32(lo2, abig[s], bs);
  }
  const float2 b = *reinterpret_cast<const float2*>(&b24i[8 * j + 2 * (lane % 4)]);
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = (lo_[r] + lo2[r]) + hi_[r];
  v[0] = fmaf(a24lo, b.x, v[0]);
  v[1] = fmaf(a24lo, b.y, v[1]);
  v[2] = fmaf(a24hi, b.x, v[2]);
  v[3] = fmaf(a24hi, b.y, v[3]);
}

// x of rows gid and gid + 8, columns 8 c + 2 tig, +1 of block i, c < 3
__device__ __forceinline__ void p13_xload(float2 (&xv)[3][2], const float* xrow, int i) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xv[c][0] = __ldg(reinterpret_cast<const float2*>(xrow + i * MUL + 8 * c));
    xv[c][1] = __ldg(reinterpret_cast<const float2*>(xrow + 8 * XW + i * MUL + 8 * c));
  }
}

template <bool TREE, int WJ, int MINB>
__global__ void __launch_bounds__(P6_NT, MINB)
p13_kernel(const float* __restrict__ x, const float* __restrict__ sh,
           const float* __restrict__ crep, float* __restrict__ out, int n_tiles) {
  using L = P13Layout<WJ>;
  extern __shared__ __align__(16) float smem[];
  uint32_t* bf = reinterpret_cast<uint32_t*>(smem);  // [i][j][s][lane][4]
  float* b24 = smem + L::BFRAG;                      // [i][PN]
  float* sh_s = b24 + D1 * L::PN;                    // two tiles of P6_BM x S
  const long long items = (long long)L::PANELS * n_tiles;
  const long long lo = items * blockIdx.x / gridDim.x;
  const long long hi = items * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r0 = 16 * (warp % 4), j0 = WJ * (warp / 4);
  int panel = -1;
  p6_issue_sh(sh_s, sh, (int)(lo % n_tiles) * P6_BM);
  cp_async_commit();
  for (long long it = lo; it < hi; ++it) {
    const int pn = (int)(it / n_tiles), e0 = (int)(it % n_tiles) * P6_BM;
    const float* cur = sh_s + ((it - lo) & 1) * P6_BM * S;
    if (pn != panel) {
      // every warp is done with the old panel
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < D1; ++i)
        load_split_panel<L::NJ>(bf + i * L::NJ * P6_KT * 32 * 4, b24 + i * L::PN, crep,
                                i * KM + pn * L::PN);
      panel = pn;
    }
    cp_async_wait<0>();
    // this tile and the panel are in place, and every warp is done with the
    // last item, so the other sh buffer is free for the next tile
    __syncthreads();
    if (it + 1 < hi)
      p6_issue_sh(sh_s + ((it + 1 - lo) & 1) * P6_BM * S, sh, (int)((it + 1) % n_tiles) * P6_BM);
    cp_async_commit();

    uint32_t abig[P6_KT][4], asmall[P6_KT][4];
#pragma unroll
    for (int s = 0; s < P6_KT; ++s) {
      const int k = 8 * s + tig;
      const float a[4] = {cur[(r0 + gid) * S + k], cur[(r0 + gid + 8) * S + k],
                          cur[(r0 + gid) * S + k + 4], cur[(r0 + gid + 8) * S + k + 4]};
      packed_tp::split_tf32(a, abig[s], asmall[s]);
    }
    const float a24lo = cur[(r0 + gid) * S + S - 1], a24hi = cur[(r0 + gid + 8) * S + S - 1];
    const float* xrow = x + (size_t)(e0 + r0 + gid) * XW + 2 * tig;
    float acc[WJ][4];
    // p1: one block a step, in order; p3: blocks 0, 2, then 1 and 3, then 4
    constexpr int STEPS = TREE ? D1 - 1 : D1;
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      const int i = !TREE ? step : step == 0 ? 0 : step == 1 ? 2 : step == 2 ? 1 : 4;
      const bool pair = TREE && step == 2;  // blocks 1 and 3
      float2 xv[3][2], xw[3][2];
      p13_xload(xv, xrow, i);
      if (pair) p13_xload(xw, xrow, 3);
#pragma unroll
      for (int q = 0; q < WJ; ++q) {
        const int j = j0 + q;
        float v[4];
        p13_wfrag<L::NJ>(v, bf + i * L::NJ * P6_KT * 32 * 4, b24 + i * L::PN, j, lane, abig,
                         asmall, a24lo, a24hi);
        const float xq[4] = {xv[q % 3][0].x, xv[q % 3][0].y, xv[q % 3][1].x, xv[q % 3][1].y};
        if (!TREE) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[q][r] = step == 0 ? v[r] * xq[r] : fmaf(v[r], xq[r], acc[q][r]);
        } else {
          // each product rounded, then the tree's sums (no contraction)
          float p[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) p[r] = __fmul_rn(v[r], xq[r]);
          if (pair) {
            float w3[4];
            p13_wfrag<L::NJ>(w3, bf + 3 * L::NJ * P6_KT * 32 * 4, b24 + 3 * L::PN, j, lane,
                             abig, asmall, a24lo, a24hi);
            const float xq3[4] = {xw[q % 3][0].x, xw[q % 3][0].y, xw[q % 3][1].x,
                                  xw[q % 3][1].y};
#pragma unroll
            for (int r = 0; r < 4; ++r) p[r] = __fadd_rn(p[r], __fmul_rn(w3[r], xq3[r]));
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[q][r] = step == 0 ? p[r] : __fadd_rn(acc[q][r], p[r]);
        }
      }
    }
    float* dst = out + (size_t)(e0 + r0 + gid) * KM + pn * L::PN + 2 * tig;
#pragma unroll
    for (int q = 0; q < WJ; ++q) {
      __stcs(reinterpret_cast<float2*>(dst + 8 * (j0 + q)), make_float2(acc[q][0], acc[q][1]));
      __stcs(reinterpret_cast<float2*>(dst + 8 * KM + 8 * (j0 + q)),
             make_float2(acc[q][2], acc[q][3]));
    }
  }
}

#define P1_KERNEL p13_kernel<false, P1_WJ, P1_MINB>
#define P3_KERNEL p13_kernel<true, P3_WJ, P3_MINB>
constexpr size_t P1_SMEM = P13Layout<P1_WJ>::SMEM;
constexpr size_t P3_SMEM = P13Layout<P3_WJ>::SMEM;

// ---- p7: (E, FAN) @ (FAN, V) in fp32 FFMA ------------------------------------
//
// Bound by its FFMAs.  Tiles of P7_BM rows x V columns, thread tile 8 x 8
// (rows ty + 16 j, columns 4 tx.. and 32 + 4 tx..), so that 16 loads of
// 16 bytes from shared memory feed 256 FFMA.  The work is spread evenly over
// P7_BLOCKS blocks (three an SM on 132 SMs, up to 168 registers a thread and
// no spills; fewer blocks below 396 chunks) by splitting the chunks of depth
// P7_KC of all tiles, in tile-major order, into equal contiguous runs (a
// "stream-K" split): a run covers the end of one tile, whole tiles, the
// start of another, and each such segment's partial sums go to scratch slot
// block + tile.  A second kernel adds each tile's segments in block order,
// so the result is bit-identical from run to run.  A two-stage cp.async
// ring runs across segments; rows past E are zero-filled and not stored.

constexpr int P7_BM = 128;                  // rows of a tile
constexpr int P7_KC = 32;                   // depth of a chunk
constexpr int P7_STAGES = 2;
constexpr int P7_AP = P7_KC + 4;            // padded A row: four rows of a warp in distinct banks
constexpr int P7_NT = 128;
constexpr int P7_BLOCKS = 396;              // the runs: three blocks an SM on 132 SMs
constexpr int P7_CHUNKS = FAN / P7_KC;      // chunks a tile
constexpr int P7_STAGE = P7_BM * P7_AP + P7_KC * V;
constexpr size_t P7_RING_SMEM = (size_t)P7_STAGES * P7_STAGE * sizeof(float);
constexpr int P7_RED_NT = 256;

// chunks of E rows, and the runs they are split into: P7_BLOCKS, or one a
// chunk where there are fewer, so that no run is empty
__host__ __device__ __forceinline__ long long p7_chunks(int E) {
  return (long long)((E + P7_BM - 1) / P7_BM) * P7_CHUNKS;
}
__host__ __device__ __forceinline__ int p7_runs(long long chunks) {
  return chunks < P7_BLOCKS ? (int)chunks : P7_BLOCKS;
}

// the run that holds chunk c (the last b with chunks * b / runs <= c)
__host__ __device__ __forceinline__ int p7_block_of(long long c, long long chunks) {
  const int runs = p7_runs(chunks);
  return (int)(((c + 1) * runs - 1) / chunks);
}

// chunk c (tile c / P7_CHUNKS, depth (c % P7_CHUNKS) * P7_KC) into one stage
__device__ __forceinline__ void p7_issue(float* stage, const float* __restrict__ a,
                                         const float* __restrict__ b, long long c, int E) {
  const int row0 = (int)(c / P7_CHUNKS) * P7_BM, k0 = (int)(c % P7_CHUNKS) * P7_KC;
  float* as = stage;
  float* bs = stage + P7_BM * P7_AP;
  for (int t = threadIdx.x; t < P7_BM * (P7_KC / 4); t += P7_NT) {
    const int r = t / (P7_KC / 4), kq = 4 * (t % (P7_KC / 4));
    const bool valid = row0 + r < E;
    packed_tp::cp_async16(&as[r * P7_AP + kq],
                          &a[(size_t)(valid ? row0 + r : 0) * FAN + k0 + kq], valid);
  }
  for (int t = threadIdx.x; t < P7_KC * (V / 4); t += P7_NT)
    cp_async16(&bs[4 * t], &b[(size_t)k0 * V + 4 * t]);
}

__global__ void __launch_bounds__(P7_NT, 3)
p7_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ part, int E) {
  // the reduce may launch now; it waits for this grid to end before it reads
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ __align__(16) float ring[];
  const long long chunks = p7_chunks(E);
  const long long lo = chunks * blockIdx.x / gridDim.x;
  const long long hi = chunks * (blockIdx.x + 1) / gridDim.x;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;
  for (int st = 0; st < P7_STAGES - 1; ++st) {
    if (lo + st < hi) p7_issue(ring + st * P7_STAGE, a, b, lo + st, E);
    cp_async_commit();
  }
  for (long long c = lo; c < hi; ++c) {
    cp_async_wait<P7_STAGES - 2>();
    // also frees the stage computed last step, which is refilled below
    __syncthreads();
    const long long nxt = c + P7_STAGES - 1;
    if (nxt < hi) p7_issue(ring + ((nxt - lo) % P7_STAGES) * P7_STAGE, a, b, nxt, E);
    cp_async_commit();
    const float* as = ring + ((c - lo) % P7_STAGES) * P7_STAGE;
    const float* bs = as + P7_BM * P7_AP;
#pragma unroll
    for (int k = 0; k < P7_KC; k += 4) {
      float4 av[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        av[j] = *reinterpret_cast<const float4*>(&as[(ty + 16 * j) * P7_AP + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[(k + kk) * V + 4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[(k + kk) * V + 32 + 4 * tx]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x = kk == 0 ? av[j].x : kk == 1 ? av[j].y : kk == 2 ? av[j].z : av[j].w;
          acc[j][0] = fmaf(x, b0.x, acc[j][0]);
          acc[j][1] = fmaf(x, b0.y, acc[j][1]);
          acc[j][2] = fmaf(x, b0.z, acc[j][2]);
          acc[j][3] = fmaf(x, b0.w, acc[j][3]);
          acc[j][4] = fmaf(x, b1.x, acc[j][4]);
          acc[j][5] = fmaf(x, b1.y, acc[j][5]);
          acc[j][6] = fmaf(x, b1.z, acc[j][6]);
          acc[j][7] = fmaf(x, b1.w, acc[j][7]);
        }
      }
    }
    // the segment ends with its tile or with the run: its partial sums to
    // slot block + tile
    if ((c + 1) % P7_CHUNKS == 0 || c + 1 == hi) {
      float* dst = part + ((size_t)blockIdx.x + (size_t)(c / P7_CHUNKS)) * P7_BM * V;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* row = dst + (ty + 16 * j) * V;
        *reinterpret_cast<float4*>(&row[4 * tx]) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        *reinterpret_cast<float4*>(&row[32 + 4 * tx]) =
            make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

// out row r = the segments of tile r / P7_BM added in block order; four
// columns a thread.  griddepcontrol.wait returns once p7_kernel has ended
// and its writes are visible; `part` is written while this kernel starts,
// so it is read through the coherent path, not the read-only one.
__global__ void __launch_bounds__(P7_RED_NT)
p7_reduce_kernel(const float* part, float* __restrict__ out, int E) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long q = (long long)blockIdx.x * P7_RED_NT + threadIdx.x;
  if (q >= (long long)E * (V / 4)) return;
  const int r = (int)(q / (V / 4)), c = 4 * (int)(q % (V / 4)), t = r / P7_BM;
  const long long chunks = p7_chunks(E);
  const int b_lo = p7_block_of((long long)t * P7_CHUNKS, chunks);
  const int b_hi = p7_block_of((long long)(t + 1) * P7_CHUNKS - 1, chunks);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int blk = b_lo; blk <= b_hi; ++blk) {
    const float4 p = *reinterpret_cast<const float4*>(
        &part[(((size_t)blk + t) * P7_BM + r % P7_BM) * V + c]);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  *reinterpret_cast<float4*>(&out[(size_t)r * V + c]) = s;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so that
// the library is not linked against libcuda (null where it is missing)
inline EncodeTiled encode_tiled(void) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return (EncodeTiled)fn;
}

inline int sm_count(void) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

inline int sweep_blocks(void) {
  const int sms = sm_count();
  return (sms > 0 ? sms : 132) * 8;
}

// blocks of nt threads of `kernel` resident on one SM with `smem` bytes of
// shared memory, the carveout set to the most shared memory (-1: refused)
template <typename Kern>
int resident_per_sm(Kern kernel, int nt, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  return packed_tp::resident_per_sm((const void*)kernel, nt, smem);
}

}  // namespace

extern "C" {

// the row multiple the products take E in
int probe_throughput_edge_quantum(void) { return BM; }

// blocks of p1 / p3 resident on one SM (two by design; -1: the size is refused)
int probe_p1_resident_per_sm(void) { return resident_per_sm(P1_KERNEL, P6_NT, P1_SMEM); }
int probe_p3_resident_per_sm(void) { return resident_per_sm(P3_KERNEL, P6_NT, P3_SMEM); }

int probe_p1(const float* x, const float* sh, const float* crep, float* out,
             int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  static int blocks = 0;
  if (blocks <= 0) blocks = probe_p1_resident_per_sm() * sm_count();
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  P1_KERNEL<<<blocks, P6_NT, P1_SMEM, (cudaStream_t)stream>>>(x, sh, crep, out, E / P6_BM);
  return (int)cudaGetLastError();
}

int probe_p3(const float* x, const float* sh, const float* crep, float* out,
             int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  static int blocks = 0;
  if (blocks <= 0) blocks = probe_p3_resident_per_sm() * sm_count();
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  P3_KERNEL<<<blocks, P6_NT, P3_SMEM, (cudaStream_t)stream>>>(x, sh, crep, out, E / P6_BM);
  return (int)cudaGetLastError();
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

// blocks of p6 resident on one SM (two by design; -1: the size is refused)
int probe_p6_resident_per_sm(void) { return resident_per_sm(p6_kernel, P6_NT, P6_SMEM); }

int probe_p6(const float* sh, const float* crep, float* out, int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  static int blocks = 0;
  if (blocks <= 0) blocks = probe_p6_resident_per_sm() * sm_count();
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  p6_kernel<<<blocks, P6_NT, P6_SMEM, (cudaStream_t)stream>>>(sh, crep, out, E / P6_BM);
  return (int)cudaGetLastError();
}

// blocks of p7 resident on one SM (three by design, so that its P7_BLOCKS
// runs are all in flight at once on 132 SMs)
int probe_p7_resident_per_sm(void) { return resident_per_sm(p7_kernel, P7_NT, P7_RING_SMEM); }

// floats of p7's scratch at E rows: (P7_BLOCKS + ceil(E / P7_BM)) * P7_BM * V,
// the segments' partial sums (slot block + tile)
long long probe_p7_scratch_floats(int E) {
  return ((long long)P7_BLOCKS + (E + P7_BM - 1) / P7_BM) * P7_BM * V;
}

// scratch: probe_p7_scratch_floats(E) floats
int probe_p7(const float* a, const float* b, float* out, float* part, int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  static int ready = 0;
  if (!ready) ready = probe_p7_resident_per_sm() > 0 ? 1 : -1;
  if (ready < 0) return (int)cudaErrorInvalidConfiguration;
  p7_kernel<<<p7_runs(p7_chunks(E)), P7_NT, P7_RING_SMEM, st>>>(a, b, part, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((long long)E * (V / 4) + P7_RED_NT - 1) / P7_RED_NT));
  cfg.blockDim = dim3(P7_RED_NT);
  cfg.stream = st;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, p7_reduce_kernel, (const float*)part, out, E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// blocks of p7_tf32 resident on one SM (one by design: its ring takes most
// of the shared memory)
int probe_p7_tf32_resident_per_sm(void) {
  return resident_per_sm(p7_tf32_kernel, T7_NT, T7_SMEM);
}

int probe_p7_tf32(const float* a, const float* b, float* out, int E, void* stream) {
  if (E <= 0 || E % BM != 0) return (int)cudaErrorInvalidValue;
  static int blocks = 0;
  if (blocks <= 0) blocks = probe_p7_tf32_resident_per_sm() > 0 ? sm_count() : -1;
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  static EncodeTiled encode = nullptr;
  if (!encode) encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  // one box a chunk: the largest share of rows (at most a pass), rounded up
  // to the eight rows of a swizzle pattern
  const int share = (E + blocks - 1) / blocks;
  const int box_rows = (min(share, T7_TM) + 7) / 8 * 8;
  CUtensorMap amap;
  const cuuint64_t dims[2] = {(cuuint64_t)FAN, (cuuint64_t)E};
  const cuuint64_t strides[1] = {(cuuint64_t)FAN * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)T7_KC, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)a, dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  p7_tf32_kernel<<<blocks, T7_NT, T7_SMEM, (cudaStream_t)stream>>>(amap, b, out, E, box_rows);
  return (int)cudaGetLastError();
}

const char* probe_throughput_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
