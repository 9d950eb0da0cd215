// Shared pieces of the embedding-table update kernels (sm_90a):
// fused_table_adam.cu and sparse_table_adam.cu, and lower_bound and kLanes
// for the densify kernels (densify_tile.cuh).
//
//  * adam_update: the optax-ordered table update of
//    deepfm_tpu/ops/pallas/adam_kernel.py::_adam_kernel, one element at a
//    time, in its literal f32 op order:
//      g  = g + wd*p
//      g  = noclip ? g : g/gnorm*clip
//      mu = (1-b1)*g + b1*mu
//      nu = (1-b2)*(g*g) + b2*nu
//      p' = p - lr*((mu/bc1) / (sqrt(nu/bc2) + eps))
//    Every operation is an explicitly rounded intrinsic (__fmul_rn,
//    __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an
//    FMA: the result equals the same chain of separate PyTorch elementwise
//    ops bit for bit. mu and nu are stored round-to-nearest in their own
//    type (f32 or bf16); the math is f32. load8 / store8 move 8 elements
//    of f32 or bf16 in 16-byte accesses, for fused_table_adam.cu's vectors.
//  * the segmented row sum over a SORTED (id, cotangent) stream: a block
//    owns a tile of table rows, finds each row's contiguous run of pairs,
//    and sums the run in stream order. Deterministic, no float atomics;
//    equal to a sequential scatter-add in the stream's order.
//  * the packed table layout (deepfm_tpu/utils/layout.py): `pack` logical
//    rows of `dcol` columns side by side in each physical row of 128 floats,
//    logical row r in physical row r / pack from lane (r % pack) * dcol;
//    lanes from pack * dcol on are dead and hold 0. pack == 1 with a row
//    width of dcol is the logical layout. A block owns tile_phys_rows(pack)
//    physical rows, i.e. that many times pack logical rows: a run of equal
//    ids never crosses a physical row, so tiles split the stream cleanly.
//  * a fixed-order reduction of per-block partial sums to one scalar.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace table_update {

constexpr int kThreads = 256;      // threads per block of every kernel here
constexpr int kTileRows = 128;     // table rows per block (densify, sparse Adam)
constexpr int kMaxTileLogical = 1024;  // logical rows per block, packed layout
constexpr int kLanes = 128;        // floats per physical row, packed layout
constexpr int kReduceThreads = 1024;

// Per-launch scalars, read from device memory (the trainer computes them on
// the card, so no launch waits for the host): the TPU kernel's SMEM vector
// [lr, wd, gnorm, clip, bc1, bc2, eps, noclip].
struct Scalars {
  float lr, wd, gnorm, clip, bc1, bc2, eps;
  bool noclip;
};

// Static Adam constants, rounded to f32 on the host as JAX rounds its
// Python-float constants: (1 - b1), b1, (1 - b2), b2.
struct Betas {
  float one_m_b1, b1, one_m_b2, b2;
};

__device__ __forceinline__ Scalars load_scalars(const float* s) {
  Scalars out;
  out.lr = s[0];
  out.wd = s[1];
  out.gnorm = s[2];
  out.clip = s[3];
  out.bc1 = s[4];
  out.bc2 = s[5];
  out.eps = s[6];
  out.noclip = s[7] > 0.0f;
  return out;
}

__device__ __forceinline__ float load_moment(const float* m, int64_t i) {
  return m[i];
}
__device__ __forceinline__ float load_moment(const __nv_bfloat16* m,
                                             int64_t i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ void store_moment(float* m, int64_t i, float v) {
  m[i] = v;
}
__device__ __forceinline__ void store_moment(__nv_bfloat16* m, int64_t i,
                                             float v) {
  m[i] = __float2bfloat16_rn(v);
}

// Eight consecutive elements from / to a 16-byte aligned address: two
// float4 of f32, or one 16-byte word of bf16 (stored round-to-nearest,
// as store_moment stores one).
__device__ __forceinline__ void load8(const float* src, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float v[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float v[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(v[2 * i]),
                                                __float2bfloat16_rn(v[2 * i + 1]));
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
}

// One element of the update; returns p' and leaves the f32 moments in
// mu / nu (the caller stores them in their type).
__device__ __forceinline__ float adam_update(float p, float grad, float& mu,
                                             float& nu, const Scalars& s,
                                             const Betas& b) {
  float g = __fadd_rn(grad, __fmul_rn(s.wd, p));
  if (!s.noclip) g = __fmul_rn(__fdiv_rn(g, s.gnorm), s.clip);
  mu = __fadd_rn(__fmul_rn(b.one_m_b1, g), __fmul_rn(b.b1, mu));
  nu = __fadd_rn(__fmul_rn(b.one_m_b2, __fmul_rn(g, g)), __fmul_rn(b.b2, nu));
  const float mu_hat = __fdiv_rn(mu, s.bc1);
  const float nu_hat = __fdiv_rn(nu, s.bc2);
  const float step = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), s.eps));
  return __fadd_rn(p, -__fmul_rn(s.lr, step));
}

// First position in sorted ids[lo, hi) whose id is >= v.
__device__ __forceinline__ int64_t lower_bound(const int* ids, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (static_cast<int64_t>(ids[mid]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Physical rows per block of a table with `pack` logical rows per physical
// row: kTileRows, or fewer so that a tile holds at most kMaxTileLogical
// logical rows (the size of the blocks' run-start array).
__host__ __device__ __forceinline__ int tile_phys_rows(int pack) {
  const int t = kMaxTileLogical / pack;
  return t < kTileRows ? t : kTileRows;
}

// Element e of a tile stored row-major with `width` floats per physical row:
// returns false for a dead lane, else sets the tile-local logical row and its
// column (see the packed layout above).
__device__ __forceinline__ bool tile_element(int e, int width, int dcol,
                                             int pack, int& row, int& col) {
  const int r = e / width;
  const int lane = e - r * width;
  const int sub = lane / dcol;
  col = lane - sub * dcol;
  row = r * pack + sub;
  return sub < pack;
}

// bounds[t] = first stream position whose id is >= t * rows_per_tile, for
// t in [0, num_tiles]: the searchsorted of the tile bounds.
__global__ void tile_bounds_kernel(const int* __restrict__ sids, int64_t n,
                                   int64_t num_tiles, int64_t rows_per_tile,
                                   int64_t* __restrict__ bounds) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t <= num_tiles) bounds[t] = lower_bound(sids, 0, n, t * rows_per_tile);
}

// Fills starts[0..rows] (shared memory) with the stream position where each
// row of the tile [row0, row0 + rows) begins; starts[rows] ends the tile's
// last row (before the tile bound when the table ends inside the tile, so
// ids past the table's last row contribute nothing).
__device__ __forceinline__ void tile_row_starts(const int* __restrict__ sids,
                                                const int64_t* __restrict__ bounds,
                                                int64_t row0, int rows,
                                                int64_t* starts) {
  const int64_t s0 = bounds[blockIdx.x];
  const int64_t s1 = bounds[blockIdx.x + 1];
  for (int r = threadIdx.x; r <= rows; r += blockDim.x) {
    starts[r] = lower_bound(sids, s0, s1, row0 + r);
  }
  __syncthreads();
}

// Sum of column c over the stream run [a, b) of rows of width D, in stream
// order.
__device__ __forceinline__ float run_sum(const float* __restrict__ cts,
                                         int64_t a, int64_t b, int D, int c) {
  float g = 0.0f;
  for (int64_t i = a; i < b; ++i) g = __fadd_rn(g, cts[i * D + c]);
  return g;
}

// Fixed-order block reduction of one float per thread (blockDim.x a power of
// two, at most kReduceThreads); thread 0 gets the sum.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kReduceThreads];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = blockDim.x >> 1; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  return red[0];
}

// out[0] = sum of partials[0..count), in a fixed order: thread t sums
// partials t, t + kReduceThreads, ... sequentially, then a fixed tree.
__global__ void final_sum_kernel(const float* __restrict__ partials,
                                 int64_t count, float* __restrict__ out) {
  float v = 0.0f;
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    v = __fadd_rn(v, partials[i]);
  }
  const float total = block_sum(v);
  if (threadIdx.x == 0) out[0] = total;
}

inline int64_t num_tiles(int64_t rows, int64_t rows_per_tile = kTileRows) {
  return (rows + rows_per_tile - 1) / rows_per_tile;
}

// Launches the tile-bound search over tiles of rows_per_tile (logical) rows;
// bounds holds num_tiles(rows, rows_per_tile) + 1 entries.
inline cudaError_t launch_tile_bounds(const int* sids, int64_t n, int64_t rows,
                                      int64_t* bounds, cudaStream_t stream,
                                      int64_t rows_per_tile = kTileRows) {
  const int64_t tiles = num_tiles(rows, rows_per_tile);
  const int64_t grid = (tiles + 1 + kThreads - 1) / kThreads;
  tile_bounds_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      sids, n, tiles, rows_per_tile, bounds);
  return cudaGetLastError();
}

}  // namespace table_update
