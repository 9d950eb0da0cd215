// Embedding-gradient densification for Hopper (sm_90a): the backward of the
// table gather, out = zeros((rows, D)).at[ids].add(ct), deterministic.
//
// Replaces deepfm_tpu/ops/pallas/grad_kernel.py :: densify_rows_grad /
// _densify_kernel. The TPU kernel builds a one-hot matrix per tile and sums
// the cotangents with a bf16 MXU matmul on a 3-way mantissa split; that is
// a matrix-unit artifact. Here the pairs arrive sorted by id (a stable
// torch.sort in the wrapper, as the JAX wrapper sorts in XLA), so every
// row's duplicates form one contiguous run and are summed in stream order:
// no atomics, the same result on every launch, and bit-equal to a
// sequential scatter-add in the original order.
//
// What bounds it on this card: bytes. Every element of the dense gradient
// is written once (rows * D * 4 bytes: 707 MB at bench.py's 10.4M-row
// table), and the sorted pairs are read once (n * (4 + 4*D) bytes: 31 MB).
// Design: one block of 256 threads per tile of 128 rows. A first kernel
// finds each tile's stream range (a searchsorted of the tile bounds); the
// block then finds each row's run with a binary search inside that range
// and walks the tile's rows*D elements with consecutive threads on
// consecutive addresses, so the writes of the mostly-zero output coalesce.

#include "table_update.cuh"

namespace {

using namespace table_update;

__global__ void __launch_bounds__(kThreads)
densify_kernel(const int* __restrict__ sids, const float* __restrict__ cts,
               const int64_t* __restrict__ bounds, int64_t rows, int D,
               float* __restrict__ out) {
  __shared__ int64_t starts[kTileRows + 1];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int tile_rows = static_cast<int>(
      rows - row0 < kTileRows ? rows - row0 : kTileRows);
  tile_row_starts(sids, bounds, row0, tile_rows, starts);
  const int elems = tile_rows * D;
  float* tile = out + row0 * D;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / D;
    const int c = e - r * D;
    tile[e] = run_sum(cts, starts[r], starts[r + 1], D, c);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). sids (n,) int32 sorted ids,
// cts (n, D) f32 cotangent rows in the same order, bounds scratch of
// ceil(rows / 128) + 1 int64, out (rows, D) f32. Ids outside [0, rows)
// contribute nothing. Returns a cudaError_t (0: launched). Nothing here
// synchronises.
extern "C" int densify_rows_grad_launch(const int* sids, const float* cts,
                                        long long n, int D, long long rows,
                                        long long* bounds, float* out,
                                        void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tile_bounds(sids, n, rows,
                                       reinterpret_cast<int64_t*>(bounds), s);
  if (err != cudaSuccess) return (int)err;
  densify_kernel<<<static_cast<unsigned>(num_tiles(rows)), kThreads, 0, s>>>(
      sids, cts, reinterpret_cast<const int64_t*>(bounds), rows, D, out);
  return (int)cudaGetLastError();
}

extern "C" const char* densify_rows_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
