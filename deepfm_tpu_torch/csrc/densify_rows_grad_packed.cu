// Packed-layout embedding-gradient densification for Hopper (sm_90a): the
// backward of the gather from a packed (phys, 128) table,
// zeros((num_rows, dcol)).at[ids].add(ct) laid out `pack` logical rows per
// physical row (logical row r in physical row r / pack, lanes
// [(r % pack) * dcol, (r % pack + 1) * dcol)), dead lanes and padding rows 0.
//
// Replaces deepfm_tpu/ops/pallas/packed_grad_kernel.py ::
// densify_rows_grad_packed / _densify_kernel. The TPU kernel fans each
// pair out over the lanes of its physical row with a masked one-hot MXU
// matmul on a 3-way bf16 mantissa split, and falls back to an XLA scatter
// from 2^24 logical rows on (its ids travel as f32). Those are matrix-unit
// and f32-id artifacts and are not carried over: the pairs arrive sorted by
// logical id (a stable torch.sort in the wrapper), each logical row's
// duplicates form one contiguous run summed in stream order, ids are int32
// (up to 2^31 - 1 rows), no atomics. The result is bit-equal to the logical
// densify (densify_rows_grad.cu) packed afterwards, and to a sequential
// scatter-add in the original order.
//
// What bounds it on this card: bytes. Every element of the packed gradient
// is written once, dead lanes included (phys * 512 bytes: 760.7 MB at
// bench.py's 10.4M-row table, pack 7), and the sorted pairs are read once
// (n * (4 + 4 * dcol) bytes: 31 MB); about 0.24 ms at 3.35 TB/s.
// Design: the tiled kernel of densify_tile.cuh with physical rows of 128
// floats: a tile of whole physical rows is built in shared memory (a run of
// equal ids never crosses a physical row) and written with bulk stores,
// dead lanes and padding rows as the zeros the tile was built on.

#include "densify_tile.cuh"

// Plain C entry point (bound with ctypes). sids (n,) int32 sorted logical
// ids, cts (n, dcol) f32 cotangent rows in the same order, out
// (ceil(num_rows / pack), 128) f32, 16-byte aligned; tile_phys,
// chunk_pairs, grid and smem are the wrapper's plan
// (ops/kernels/grad.py::densify_plan). Ids outside [0, num_rows) contribute
// nothing. Returns a cudaError_t (0: launched). Nothing here synchronises.
extern "C" int densify_rows_grad_packed_launch(
    const int* sids, const float* cts, long long n, int dcol, int pack,
    long long num_rows, int tile_phys, int chunk_pairs, int grid,
    long long smem, float* out, void* stream) {
  const densify_tile::Geometry g{
      num_rows, (num_rows + pack - 1) / (pack > 0 ? pack : 1), dcol, pack,
      table_update::kLanes, tile_phys, chunk_pairs};
  return densify_tile::launch(sids, cts, n, g, grid, smem, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* densify_rows_grad_packed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
