// Hopper probes of the primitives the fused TP kernels are built from.
//
// Counterparts of the Pallas closures of tools_dev/mosaic_probe.py (k_repeat
// ... k_slice_dot; TE=128, K=16, MUL=64) and tools_dev/mosaic_probe2.py
// (k_tile ... k_dot_t and the gridded k_acc; TE=128, K=25, MUL=48).  Those
// asked whether Mosaic lowers a lane tile, a (TE,K*MUL)<->(TE,K,MUL) reshape,
// a lane reduce, a small product, and with which semantics.  A GPU has no
// lane layout: every reshape, slice, tile and repeat below is index
// arithmetic on row-major rows, which is what these probes establish.
//
// Every probe is bound by its bytes, or at a few hundred rows by the launch;
// none does enough arithmetic for the tensor cores to matter.  So the design
// spreads the work over the whole card:
//  - the grid covers the output, not one block per 128-row tile: a launch
//    takes min(ceil(units / NT), RESIDENT blocks an SM) blocks of NT threads,
//    and each thread walks its units with a grid stride, UNROLL units' loads
//    in flight before their stores (`walk`);
//  - index maps (repeat, squeeze, merge, atadd, gather, tile, erep, bc_merge,
//    rep_slice, concat) use no shared memory and no barrier: a thread computes
//    its output's source index and reads through the read-only path, 16 bytes
//    a load and a store where the row width and column offset allow (gather
//    reads one strided value a unit, rep_slice's rows of 25 and 35 floats
//    take no 16-byte units);
//  - reductions keep one order, so the same inputs give the same bits:
//    split_sum adds k = 0..24 in order with lanes over m, lred adds a lane
//    group's two float4s and then a shuffle tree, outer adds k in order;
//  - row x small weight (dot, slice_dot, dot_odd) stages the weight in shared
//    memory once per block; at bench rows a thread keeps 2 rows x 8 columns
//    of outputs in registers (shared-memory and L1 traffic, not the FFMAs,
//    set the pace of a product this small), below a few thousand rows one
//    output; rows are read straight from device memory 16 bytes at a time,
//    and the contraction index runs in order, so both give the same bits;
//  - contractions over rows (dot_t, acc) spread a tile's 48 x 24 outputs over
//    six blocks, a thread four outputs over an eighth of the tile's rows, the
//    eighths added in order through shared memory; k_acc's reduce adds the
//    tiles' partials in tile order (the order of the sequential Pallas grid),
//    one thread per output, so a repeat is bit-identical; no atomics.  The
//    reduce is a programmatic dependent launch: it starts while the partials
//    are computed and waits for them, which hides one launch's latency.
//
// C interface: probe_<name>(inputs..., out[, scratch], rows, stream) returns
// the cudaError_t of the launch.  Pointers are 16-byte aligned (the wrapper
// checks).

#include <cuda_runtime.h>

namespace {

typedef long long idx_t;

constexpr int TE = 128;       // rows of a k_acc / k_dot_t tile
constexpr int NT = 256;       // threads of a walking block
constexpr int UNROLL = 4;     // units of a thread in flight at once
constexpr int RESIDENT = 8;   // walking blocks an SM (2,048 threads)
constexpr int NV = 24;        // columns of the small products

constexpr int K1 = 16, M1 = 64, KM1 = K1 * M1;  // mosaic_probe.py
constexpr int K2 = 25, M2 = 48, KM2 = K2 * M2;  // mosaic_probe2.py

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

// Every unit u < n of the grid: map.at(u) for UNROLL units of the thread,
// then map.put(u, value) for each.  A map names its units per row.
template <class Map>
__device__ __forceinline__ void walk(const Map& map, idx_t n) {
  const idx_t stride = (idx_t)gridDim.x * NT;
  for (idx_t u0 = (idx_t)blockIdx.x * NT + threadIdx.x; u0 < n; u0 += stride * UNROLL) {
    typename Map::value v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (u0 + j * stride < n) v[j] = map.at(u0 + j * stride);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (u0 + j * stride < n) map.put(u0 + j * stride, v[j]);
  }
}

// an output of float4s: unit u is floats 4u..4u+3 of o
struct Out4 {
  float* o;
  typedef float4 value;
  __device__ void put(idx_t u, float4 v) const { st4(o + 4 * u, v); }
};

// an output of floats: unit u is o[u]
struct Out1 {
  float* o;
  typedef float value;
  __device__ void put(idx_t u, float v) const { o[u] = v; }
};

// ---- mosaic_probe.py -------------------------------------------------------

// k_repeat (:37): (TE,K) -> (TE,4K), the lane TILE a|a|a|a
struct Repeat : Out4 {
  const float* a;
  static constexpr int per_row = 4 * K1 / 4;
  __device__ float4 at(idx_t u) const {
    const idx_t r = u / per_row;
    return ld4(a + r * K1 + 4 * (int)(u % per_row % (K1 / 4)));
  }
};

// k_squeeze (:48): view (TE,K,MUL), row 3 of the middle axis -> (TE,MUL)
struct Squeeze : Out4 {
  const float* x;
  static constexpr int per_row = M1 / 4;
  __device__ float4 at(idx_t u) const {
    const idx_t r = u / per_row;
    return ld4(x + r * KM1 + 3 * M1 + 4 * (int)(u % per_row));
  }
};

// k_merge128 (:56) and k_merge64 (:64): view (TE,G,L), add 1, merge back to
// (TE,G*L); L = 128 merged on the TPU, L = 64 did not.  Row-major, both views
// are the identity on the floats.
struct PlusOne : Out4 {
  const float* x;
  static constexpr int per_row = KM1 / 4;
  __device__ float4 at(idx_t u) const {
    const float4 v = ld4(x + 4 * u);
    return make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
  }
};

// k_outer (:71): sum_k a[r,k] * b[r,m] -> (TE,MUL), k = 0..K-1 in order
struct Outer : Out4 {
  const float* a;
  const float* b;
  static constexpr int per_row = M1 / 4;
  __device__ float4 at(idx_t u) const {
    const idx_t r = u / per_row;
    const float4 bv = ld4(b + 4 * u);
    float4 acc = splat(0.f);
#pragma unroll
    for (int q = 0; q < K1 / 4; ++q) {
      const float4 av = ld4(a + r * K1 + 4 * q);
      const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc.x = fmaf(ak[e], bv.x, acc.x);
        acc.y = fmaf(ak[e], bv.y, acc.y);
        acc.z = fmaf(ak[e], bv.z, acc.z);
        acc.w = fmaf(ak[e], bv.w, acc.w);
      }
    }
    return acc;
  }
};

// k_lred (:79): view (TE,K,MUL), sum over the last axis -> (TE,K).  A group
// of LG lanes per (row, k): lane l adds float4s l and l + LG of the 64, then
// a shuffle tree over the group.  n = rows * K1 * LG is a multiple of 32 and
// so is the grid stride, so every warp runs the shuffles whole.
constexpr int LG = M1 / 8;
struct LaneReduce {
  const float* x;
  float* o;
  typedef float value;
  static constexpr int per_row = K1 * LG;
  __device__ float at(idx_t u) const {
    const float* g = x + (u / LG) * M1 + 4 * (int)(u % LG);
    const float4 v0 = ld4(g), v1 = ld4(g + 4 * LG);
    return ((v0.x + v0.y) + (v0.z + v0.w)) + ((v1.x + v1.y) + (v1.z + v1.w));
  }
  __device__ void put(idx_t u, float s) const {
#pragma unroll
    for (int d = LG / 2; d > 0; d /= 2) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (u % LG == 0) o[u / LG] = s;
  }
};

// k_atadd (:86): zeros (TE,K*MUL) with x[:, :128] added into columns 64..191
struct AtAdd : Out4 {
  const float* x;
  static constexpr int per_row = KM1 / 4;
  __device__ float4 at(idx_t u) const {
    const idx_t r = u / per_row;
    const int c = (int)(u % per_row) - 64 / 4;
    return (c >= 0 && c < 128 / 4) ? ld4(x + r * KM1 + 4 * c) : splat(0.f);
  }
};

// k_gather (:94): columns 0, K, 2K, ... -> (TE,MUL): one 32-byte sector a
// value, a unit a value, so that a warp's load touches 16 lines of 128 bytes
// and its store is one line
struct Gather : Out1 {
  const float* x;
  static constexpr int per_row = M1;
  __device__ float at(idx_t u) const {
    return __ldg(x + (u / per_row) * KM1 + K1 * (int)(u % per_row));
  }
};

// Row x small weight.  A `Row` hands out row r's contraction operand as
// float4 chunks 0..chunks-1; element e of chunk q is index 4q + e - lead
// (those outside 0..depth-1 are unused).

// k_dot (:101): (TE,MUL) @ (MUL,24)
struct DotRow {
  const float* a;
  static constexpr int depth = M1, chunks = M1 / 4, lead = 0;
  __device__ float4 chunk(idx_t r, int q) const { return ld4(a + r * M1 + 4 * q); }
};

// k_slice_dot (:110): view (TE,K,MUL), rows 2 and 3 of the middle axis
// added in registers, then @ (MUL,24)
struct SliceSumRow {
  const float* x;
  static constexpr int depth = M1, chunks = M1 / 4, lead = 0;
  __device__ float4 chunk(idx_t r, int q) const {
    const float4 s = ld4(x + r * KM1 + 2 * M1 + 4 * q);
    const float4 t = ld4(x + r * KM1 + 3 * M1 + 4 * q);
    return make_float4(s.x + t.x, s.y + t.y, s.z + t.z, s.w + t.w);
  }
};

// k_dot_odd (mosaic_probe2.py:91): columns 7..126 of (TE,K*MUL).  Column 7
// is not 16-byte aligned: the row is read as the aligned float4s of columns
// 4..127 (the same 32-byte sectors), and columns 4..6 and 127 go unused.
struct OddRow {
  const float* x;
  static constexpr int depth = 120, chunks = 31, lead = 3;
  __device__ float4 chunk(idx_t r, int q) const { return ld4(x + r * KM2 + 4 + 4 * q); }
};

// rows @ w (Row::depth x NV), the contraction index in order for every output
// (so both shapes below give the same bits).  The weight goes into shared
// memory once per block.  A thread keeps PR rows x PC columns of outputs in
// registers: at bench rows 2 x 8, so that a weight load serves 2 rows and a
// row value 8 columns and the shared-memory and L1 traffic stays below the
// FFMA rate; a launch with fewer than DOT_TILED_MIN such tiles (a few
// thousand rows) spreads one output a thread instead, as its time is the
// latency of one thread's chain and not the card's throughput.
constexpr idx_t DOT_TILED_MIN = 4096;
template <int PR, int PC>
__host__ __device__ inline idx_t tile_units(int rows) {
  return (idx_t)((rows + PR - 1) / PR) * (NV / PC);
}
__host__ __device__ inline bool dot_tiled(int rows) {
  return tile_units<2, 8>(rows) >= DOT_TILED_MIN;
}
__host__ __device__ inline idx_t dot_units(int rows) {
  return dot_tiled(rows) ? tile_units<2, 8>(rows) : tile_units<1, 1>(rows);
}

template <int PR, int PC, class Row>
__device__ __forceinline__ void small_dot_tiles(const Row& row, const float* sw,
                                                float* __restrict__ o, int rows) {
  const idx_t n = tile_units<PR, PC>(rows);
  for (idx_t u = (idx_t)blockIdx.x * NT + threadIdx.x; u < n; u += (idx_t)gridDim.x * NT) {
    const idx_t r0 = u / (NV / PC) * PR;
    const int c = (int)(u % (NV / PC));
    float acc[PR][PC];
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int q = 0; q < Row::chunks; ++q) {
      float v[PR][4];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const float4 x = r0 + i < rows ? row.chunk(r0 + i, q) : splat(0.f);
        v[i][0] = x.x; v[i][1] = x.y; v[i][2] = x.z; v[i][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e - Row::lead;
        if (k < 0 || k >= Row::depth) continue;
        float wk[PC];
        if constexpr (PC == 1) {
          wk[0] = sw[k * NV + c];
        } else {
#pragma unroll
          for (int h = 0; h < PC / 4; ++h) {
            const float4 w4 = reinterpret_cast<const float4*>(sw + k * NV + PC * c)[h];
            wk[4 * h] = w4.x; wk[4 * h + 1] = w4.y; wk[4 * h + 2] = w4.z; wk[4 * h + 3] = w4.w;
          }
        }
#pragma unroll
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(v[i][e], wk[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      if (r0 + i >= rows) continue;
      float* out = o + (r0 + i) * NV + PC * c;
      if constexpr (PC == 1) {
        out[0] = acc[i][0];
      } else {
#pragma unroll
        for (int h = 0; h < PC / 4; ++h)
          st4(out + 4 * h, make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                       acc[i][4 * h + 3]));
      }
    }
  }
}

template <class Row>
__device__ __forceinline__ void small_dot(const Row& row, const float* __restrict__ w,
                                          float* __restrict__ o, int rows) {
  __shared__ __align__(16) float sw[Row::depth * NV];
  for (int i = threadIdx.x; i < Row::depth * NV / 4; i += NT)
    reinterpret_cast<float4*>(sw)[i] = ld4(w + 4 * i);
  __syncthreads();
  if (dot_tiled(rows))
    small_dot_tiles<2, 8>(row, sw, o, rows);
  else
    small_dot_tiles<1, 1>(row, sw, o, rows);
}

// ---- mosaic_probe2.py ------------------------------------------------------

// k_tile (:33): (TE,MUL) tiled K times along the columns -> (TE,K*MUL)
struct Tile : Out4 {
  const float* a;
  static constexpr int per_row = KM2 / 4;
  __device__ float4 at(idx_t u) const {
    const idx_t r = u / per_row;
    return ld4(a + r * M2 + 4 * (int)(u % per_row % (M2 / 4)));
  }
};

// k_erep (:44): each element of (TE,K) repeated MUL times -> (TE,K*MUL).
// k_bc_merge (:67), (TE,K,1) broadcast to (TE,K,MUL) and merged, is the same
// map: a float4 of the output lies in one block of MUL and takes one a[r,k]
// (so a walk over the broadcast's three axes, as in its TPU form, gains nothing).
struct ElementRepeat : Out4 {
  const float* a;
  static constexpr int per_row = KM2 / 4;
  __device__ float4 at(idx_t u) const {
    const idx_t r = u / per_row;
    return splat(__ldg(a + r * K2 + (int)(u % per_row) / (M2 / 4)));
  }
};

// k_split_sum (:55): view (TE,K,MUL), sum over the middle axis (the dx op),
// lanes over m, k = 0..K-1 in order
struct SplitSum : Out4 {
  const float* x;
  static constexpr int per_row = M2 / 4;
  __device__ float4 at(idx_t u) const {
    const float* s = x + (u / per_row) * KM2 + 4 * (int)(u % per_row);
    float4 acc = splat(0.f);
#pragma unroll
    for (int k = 0; k < K2; ++k) {
      const float4 v = ld4(s + k * M2);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    return acc;
  }
};

// k_rep_slice (:76): columns 3..9 of (TE,K) tiled 5 times -> (TE,35); rows
// of 25 and 35 floats take no 16-byte units
struct RepSlice : Out1 {
  const float* a;
  static constexpr int per_row = 35;
  __device__ float at(idx_t u) const {
    return __ldg(a + (u / per_row) * K2 + 3 + (int)(u % per_row) % 7);
  }
};

// k_concat (:83): column block i scaled by i, the K blocks side by side
struct Concat : Out4 {
  const float* x;
  static constexpr int per_row = KM2 / 4;
  __device__ float4 at(idx_t u) const {
    const float4 v = ld4(x + 4 * u);
    const float s = (float)((int)(u % per_row) / (M2 / 4));
    return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
  }
};

// a tile's a^T (MUL x TE) @ b[:, :NV] -> (MUL, NV) in row-major o.  DOT_NT
// threads a block; block `part` of DOT_PARTS takes DOT_M of the MUL rows of
// the output; thread (s, mi, n4) adds four outputs (m, 4 n4 .. 4 n4 + 3) over
// the rows [s TE/DOT_Q, (s+1) TE/DOT_Q) in order, and the DOT_Q parts are
// added in order through shared memory.
constexpr int DOT_PARTS = 6, DOT_M = M2 / DOT_PARTS, DOT_Q = 8;
constexpr int DOT_NT = DOT_Q * DOT_M * (NV / 4);  // 384
__device__ __forceinline__ void tile_dot_t(const float* __restrict__ a,
                                           const float* __restrict__ b, int ldb,
                                           int part, float* __restrict__ o) {
  __shared__ float4 sp[DOT_Q][DOT_M * (NV / 4)];
  const int t = threadIdx.x, q = t / (DOT_M * (NV / 4)), j = t % (DOT_M * (NV / 4));
  const int m = part * DOT_M + j / (NV / 4), n4 = j % (NV / 4);
  float4 acc = splat(0.f);
#pragma unroll 8
  for (int r = q * (TE / DOT_Q); r < (q + 1) * (TE / DOT_Q); ++r) {
    const float av = __ldg(a + r * M2 + m);
    const float4 bv = ld4(b + r * ldb + 4 * n4);
    acc.x = fmaf(av, bv.x, acc.x);
    acc.y = fmaf(av, bv.y, acc.y);
    acc.z = fmaf(av, bv.z, acc.z);
    acc.w = fmaf(av, bv.w, acc.w);
  }
  sp[q][j] = acc;
  __syncthreads();
  if (q == 0) {
#pragma unroll
    for (int p = 1; p < DOT_Q; ++p) {
      acc.x += sp[p][j].x; acc.y += sp[p][j].y; acc.z += sp[p][j].z; acc.w += sp[p][j].w;
    }
    st4(o + m * NV + 4 * n4, acc);
  }
}

// ---- the __global__ functions ------------------------------------------------

#define MAP_KERNEL_1(kernel, Map, field)                                    \
  __global__ void kernel(const float* __restrict__ a, float* __restrict__ o, \
                         int rows) {                                         \
    Map map;                                                                 \
    map.o = o;                                                               \
    map.field = a;                                                           \
    walk(map, (idx_t)rows * Map::per_row);                                   \
  }

MAP_KERNEL_1(k_repeat_kernel, Repeat, a)
MAP_KERNEL_1(k_squeeze_kernel, Squeeze, x)
MAP_KERNEL_1(k_merge128_kernel, PlusOne, x)
MAP_KERNEL_1(k_merge64_kernel, PlusOne, x)
MAP_KERNEL_1(k_lred_kernel, LaneReduce, x)
MAP_KERNEL_1(k_atadd_kernel, AtAdd, x)
MAP_KERNEL_1(k_gather_kernel, Gather, x)
MAP_KERNEL_1(k_tile_kernel, Tile, a)
MAP_KERNEL_1(k_erep_kernel, ElementRepeat, a)
MAP_KERNEL_1(k_split_sum_kernel, SplitSum, x)
MAP_KERNEL_1(k_bc_merge_kernel, ElementRepeat, a)
MAP_KERNEL_1(k_rep_slice_kernel, RepSlice, a)
MAP_KERNEL_1(k_concat_kernel, Concat, x)

__global__ void k_outer_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               float* __restrict__ o, int rows) {
  Outer map;
  map.o = o;
  map.a = a;
  map.b = b;
  walk(map, (idx_t)rows * Outer::per_row);
}

__global__ void k_dot_kernel(const float* __restrict__ a, const float* __restrict__ w,
                             float* __restrict__ o, int rows) {
  small_dot(DotRow{a}, w, o, rows);
}

__global__ void k_slice_dot_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   float* __restrict__ o, int rows) {
  small_dot(SliceSumRow{x}, w, o, rows);
}

__global__ void k_dot_odd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                 float* __restrict__ o, int rows) {
  small_dot(OddRow{x}, w, o, rows);
}

// k_dot_t (mosaic_probe2.py:100): (TE,MUL)^T @ (TE,24) -> (MUL,24), the dWcat
// op; one tile over DOT_PARTS blocks
__global__ void k_dot_t_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               float* __restrict__ o) {
  tile_dot_t(a, b, NV, blockIdx.x, o);
}

// k_acc (:111), first pass: tile blockIdx.y's a_t^T @ a_t[:, :24] into
// part[t].  It lets the second pass launch at once (Hopper's programmatic
// dependent launch); that pass waits for it to end before reading.
__global__ void k_acc_partial_kernel(const float* __restrict__ a, float* __restrict__ part) {
  asm volatile("griddepcontrol.launch_dependents;");
  const float* at = a + (idx_t)blockIdx.y * TE * M2;
  tile_dot_t(at, at, M2, blockIdx.x, part + (idx_t)blockIdx.y * M2 * NV);
}

// k_acc, second pass: out (64,32) = 0, out[3:3+MUL, :24] += part[t] for t in
// tile order, as the sequential grid adds them; one thread per output.
// griddepcontrol.wait returns once the first pass has ended and its writes
// are visible; `part` is written while this kernel runs, so it is read
// through the coherent path, not the read-only one.
__global__ void k_acc_reduce_kernel(const float* part, float* __restrict__ o, int n_tiles) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * NT + threadIdx.x, r = i / 32 - 3, c = i % 32;
  float acc = 0.f;
  if (r >= 0 && r < M2 && c < NV) {
#pragma unroll 8
    for (int t = 0; t < n_tiles; ++t) acc += part[((idx_t)t * M2 + r) * NV + c];
  }
  o[i] = acc;
}

// blocks of a walk over `units`: enough for one unit a thread, at most
// RESIDENT an SM (0 when the device cannot be read: the launch then fails)
int walk_blocks(idx_t units) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  const idx_t need = (units + NT - 1) / NT, cap = (idx_t)RESIDENT * sms;
  return (int)(need < cap ? need : cap);
}

}  // namespace

// a row-wise launcher; `units` (an expression of `rows`) sizes the grid
#define ROWWISE_1(name, kernel, units)                                        \
  int probe_##name(const float* a, float* o, int rows, void* stream) {        \
    if (rows <= 0) return 0;                                                  \
    kernel<<<walk_blocks(units), NT, 0, (cudaStream_t)stream>>>(a, o, rows);  \
    return (int)cudaGetLastError();                                           \
  }

#define ROWWISE_2(name, kernel, units)                                        \
  int probe_##name(const float* a, const float* b, float* o, int rows,        \
                   void* stream) {                                            \
    if (rows <= 0) return 0;                                                  \
    kernel<<<walk_blocks(units), NT, 0, (cudaStream_t)stream>>>(a, b, o,      \
                                                                 rows);       \
    return (int)cudaGetLastError();                                           \
  }

#define PER_ROW(Map) ((idx_t)rows * Map::per_row)

extern "C" {

ROWWISE_1(k_repeat, k_repeat_kernel, PER_ROW(Repeat))
ROWWISE_1(k_squeeze, k_squeeze_kernel, PER_ROW(Squeeze))
ROWWISE_1(k_merge128, k_merge128_kernel, PER_ROW(PlusOne))
ROWWISE_1(k_merge64, k_merge64_kernel, PER_ROW(PlusOne))
ROWWISE_2(k_outer, k_outer_kernel, PER_ROW(Outer))
ROWWISE_1(k_lred, k_lred_kernel, PER_ROW(LaneReduce))
ROWWISE_1(k_atadd, k_atadd_kernel, PER_ROW(AtAdd))
ROWWISE_1(k_gather, k_gather_kernel, PER_ROW(Gather))
ROWWISE_2(k_dot, k_dot_kernel, dot_units(rows))
ROWWISE_2(k_slice_dot, k_slice_dot_kernel, dot_units(rows))

ROWWISE_1(k_tile, k_tile_kernel, PER_ROW(Tile))
ROWWISE_1(k_erep, k_erep_kernel, PER_ROW(ElementRepeat))
ROWWISE_1(k_split_sum, k_split_sum_kernel, PER_ROW(SplitSum))
ROWWISE_1(k_bc_merge, k_bc_merge_kernel, PER_ROW(ElementRepeat))
ROWWISE_1(k_rep_slice, k_rep_slice_kernel, PER_ROW(RepSlice))
ROWWISE_1(k_concat, k_concat_kernel, PER_ROW(Concat))
ROWWISE_2(k_dot_odd, k_dot_odd_kernel, dot_units(rows))

// one tile: rows must be TE
int probe_k_dot_t(const float* a, const float* b, float* o, int rows,
                  void* stream) {
  if (rows != TE) return (int)cudaErrorInvalidValue;
  k_dot_t_kernel<<<DOT_PARTS, DOT_NT, 0, (cudaStream_t)stream>>>(a, b, o);
  return (int)cudaGetLastError();
}

// rows a multiple of TE; part: scratch of (rows / TE) * MUL * 24 floats
int probe_k_acc(const float* a, float* o, float* part, int rows,
                void* stream) {
  if (rows <= 0 || rows % TE != 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = rows / TE;
  k_acc_partial_kernel<<<dim3(DOT_PARTS, n_tiles), DOT_NT, 0, (cudaStream_t)stream>>>(
      a, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(64 * 32 / NT);
  cfg.blockDim = dim3(NT);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k_acc_reduce_kernel, (const float*)part, o, n_tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* probe_ops_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
