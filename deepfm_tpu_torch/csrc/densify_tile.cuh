// The tiled densify kernel shared by densify_rows_grad.cu (logical layout)
// and densify_rows_grad_packed.cu (packed layout), for Hopper (sm_90a):
// out = zeros((num_rows, dcol)).at[ids].add(ct), laid out `pack` logical
// rows of `dcol` columns per physical row of `width` floats (logical: pack 1,
// width dcol; packed: width 128, dead lanes and padding rows 0).
//
// What bounds it: the write stream. Every output element is written once
// (707 MB logical, 761 MB packed at bench.py's 10.4M-row table), the sorted
// pairs are read once (31 MB). The design keeps the per-element work off
// that stream:
//  * a persistent grid (grid a few times the resident blocks, kBlocksPerSM
//    an SM) in which block b owns the contiguous tiles [b*T/G, (b+1)*T/G)
//    of T tiles of tile_phys physical rows;
//  * each tile's stream range [s0, s1) is a lower_bound of its first and
//    last row, searched for up to kBoundBatch tiles at once by all threads;
//  * the tile is built in shared memory: zeroed with 16-byte stores; the
//    pairs are staged with cp.async in windows of up to chunk_pairs that
//    run on across the block's tiles (one load serves many tiles); the
//    runs are summed by table_update::add_runs (which also builds
//    sparse_table_adam.cu's tile gradients): they are found by warp
//    ballots (warp w takes the runs that start in its eighth of the
//    tile's pairs, no per-row search and no block-wide compaction), and
//    each run is added by one warp, lane c down column c,
//    in stream order from shared memory into the tile (a run cut by a
//    window boundary carries its sum in the tile: the adds stay in stream
//    order from 0.0f), so a 16,384-long run is a chain of shared-memory
//    adds;
//  * the tile leaves in one cp.async.bulk store (after
//    fence.proxy.async), while the block builds the next tile in the other
//    of two buffers; a buffer is rebuilt only after
//    cp.async.bulk.wait_group.read has seen its store read it. A tile whose
//    byte count is not a multiple of 16 (only the last) stores its last
//    floats with plain stores.
// No float atomics: each element is the sequential sum of its run, so the
// result equals a sequential scatter-add in stream order bit for bit and
// repeats on every launch. Ids outside [0, num_rows) contribute nothing.
//
// The tile plan (tile_phys, chunk_pairs, grid, shared-memory bytes) comes
// from the Python wrapper (ops/kernels/grad.py::densify_plan); launch()
// checks it against the arithmetic here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "table_update.cuh"

namespace densify_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;   // blocks resident per SM (launch bounds)
constexpr int kBoundBatch = 256;  // tile bounds searched at once
constexpr int64_t kMaxSmem = 232448;  // dynamic shared memory of a block

struct Geometry {
  int64_t num_rows;  // logical rows
  int64_t phys;      // physical rows of the output
  int dcol;          // columns of a logical row
  int pack;          // logical rows per physical row
  int width;         // floats per physical row
  int tile_phys;     // physical rows per tile, a multiple of 4
  int chunk_pairs;   // pairs a staged window holds
};

// Dynamic shared memory of one block: two tile buffers, the tile bounds of a
// batch, and a window of staged pairs (rows and ids).
__host__ __device__ inline int64_t smem_bytes(const Geometry& g) {
  return 2 * 4LL * g.tile_phys * g.width + 8LL * (kBoundBatch + 1) +
         static_cast<int64_t>(g.chunk_pairs) * (4LL * g.dcol + 4);
}

using table_update::smem_addr;

// One bulk store of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared to global memory, committed as its own group.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most one bulk group (the other buffer's) still reads shared
// memory.
__device__ __forceinline__ void bulk_wait_read_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
densify_tiles_kernel(const int* __restrict__ sids,
                     const float* __restrict__ cts, int64_t n, Geometry g,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_floats = g.tile_phys * g.width;
  float* bufs = reinterpret_cast<float*>(smem);
  int64_t* bnd = reinterpret_cast<int64_t*>(bufs + 2 * tile_floats);
  float* vals = reinterpret_cast<float*>(bnd + kBoundBatch + 1);
  int* ids = reinterpret_cast<int*>(vals + g.chunk_pairs * g.dcol);

  const int64_t rows_per_tile = static_cast<int64_t>(g.tile_phys) * g.pack;
  const int64_t tiles = (g.phys + g.tile_phys - 1) / g.tile_phys;
  const int64_t tb = tiles * blockIdx.x / gridDim.x;
  const int64_t te = tiles * (blockIdx.x + 1) / gridDim.x;
  int built = 0;  // tiles this block has built: buffer built & 1
  int64_t w0 = 0, w1 = 0;  // the window of the stream staged in ids / vals
  for (int64_t base = tb; base < te; base += kBoundBatch) {
    const int count = static_cast<int>(
        te - base < kBoundBatch ? te - base : kBoundBatch);
    __syncthreads();  // the previous batch's bounds are no longer read
    for (int j = threadIdx.x; j <= count; j += kThreads) {
      const int64_t row = (base + j) * rows_per_tile;
      bnd[j] = table_update::lower_bound(sids, 0, n,
                                         row < g.num_rows ? row : g.num_rows);
    }
    __syncthreads();
    const int64_t batch_end = bnd[count];
    for (int j = 0; j < count; ++j, ++built) {
      const int64_t t = base + j;
      float* buf = bufs + (built & 1) * tile_floats;
      if (threadIdx.x == 0) bulk_wait_read_one();
      __syncthreads();  // this buffer's last store has read it
      float4* buf4 = reinterpret_cast<float4*>(buf);
      for (int e = threadIdx.x; e < tile_floats / 4; e += kThreads) {
        buf4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();  // the tile is zeroed
      const int64_t row0 = t * rows_per_tile;
      const int64_t s1 = bnd[j + 1];
      for (int64_t s = bnd[j]; s < s1;) {
        if (s >= w1) {  // stage the next window, across tiles of the batch
          __syncthreads();  // the last window is consumed
          w0 = s;
          w1 = s + g.chunk_pairs < batch_end ? s + g.chunk_pairs : batch_end;
          const int len = static_cast<int>(w1 - w0);
          for (int i = threadIdx.x; i < len; i += kThreads) {
            table_update::cp_async4(ids + i, sids + w0 + i);
          }
          const float* src = cts + w0 * g.dcol;
          for (int i = threadIdx.x; i < len * g.dcol; i += kThreads) {
            table_update::cp_async4(vals + i, src + i);
          }
          table_update::cp_async_wait_all();
          __syncthreads();
        }
        const int64_t e = s1 < w1 ? s1 : w1;
        table_update::add_runs(ids, vals, static_cast<int>(s - w0),
                               static_cast<int>(e - w0), row0, g.dcol, g.pack,
                               g.width, buf);
        s = e;
      }
      const int64_t phys0 = t * g.tile_phys;
      const int floats = static_cast<int>(
          (g.phys - phys0 < g.tile_phys ? g.phys - phys0 : g.tile_phys) *
          g.width);
      const int bulk = floats & ~3;
      float* dst = out + phys0 * g.width;
      fence_async_shared();  // the tile's writes, seen by the bulk store
      __syncthreads();
      if (threadIdx.x == 0 && bulk > 0) {
        bulk_store(dst, buf, static_cast<uint32_t>(bulk) * 4u);
      }
      for (int e = bulk + threadIdx.x; e < floats; e += kThreads) {
        dst[e] = buf[e];
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// Checks the plan and launches; returns a cudaError_t. Nothing here
// synchronises.
inline int launch(const int* sids, const float* cts, int64_t n,
                  const Geometry& g, int grid, int64_t smem, float* out,
                  cudaStream_t stream) {
  if (g.num_rows <= 0) return 0;
  const int64_t tiles =
      g.tile_phys > 0 ? (g.phys + g.tile_phys - 1) / g.tile_phys : 0;
  if (g.dcol < 1 || g.pack < 1 || g.pack * g.dcol > g.width ||
      g.phys != (g.num_rows + g.pack - 1) / g.pack || g.tile_phys < 4 ||
      g.tile_phys % 4 != 0 || g.chunk_pairs < 1 || grid < 1 ||
      grid > tiles || smem != smem_bytes(g) || smem > kMaxSmem ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      densify_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  densify_tiles_kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      sids, cts, n, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace densify_tile
