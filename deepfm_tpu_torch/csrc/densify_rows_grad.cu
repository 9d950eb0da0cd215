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
// Design: the tiled kernel of densify_tile.cuh on the logical layout
// (pack 1, a physical row is a logical row of D floats): tiles of rows
// built in shared memory and written with bulk stores.

#include "densify_tile.cuh"

// Plain C entry point (bound with ctypes). sids (n,) int32 sorted ids,
// cts (n, D) f32 cotangent rows in the same order, out (rows, D) f32,
// 16-byte aligned; tile_rows, chunk_pairs, grid and smem are the wrapper's
// plan (ops/kernels/grad.py::densify_plan). Ids outside [0, rows)
// contribute nothing. Returns a cudaError_t (0: launched). Nothing here
// synchronises.
extern "C" int densify_rows_grad_launch(const int* sids, const float* cts,
                                        long long n, int D, long long rows,
                                        int tile_rows, int chunk_pairs,
                                        int grid, long long smem, float* out,
                                        void* stream) {
  const densify_tile::Geometry g{rows, rows, D, 1, D, tile_rows, chunk_pairs};
  return densify_tile::launch(sids, cts, n, g, grid, smem, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* densify_rows_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
