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
// Design: the sorted-pairs / tile-bounds scheme of densify_rows_grad.cu,
// tiled over physical rows. A block owns tile_phys_rows(pack) physical rows
// (128 at pack 7), i.e. that many times pack logical rows; a run of equal
// ids never crosses a physical row, so the tile bounds split the stream
// cleanly. The block finds each logical row's run with a binary search
// inside its range and writes its whole 512-byte rows with consecutive
// threads on consecutive addresses, zeros included.

#include "table_update.cuh"

namespace {

using namespace table_update;

__global__ void __launch_bounds__(kThreads)
densify_packed_kernel(const int* __restrict__ sids,
                      const float* __restrict__ cts,
                      const int64_t* __restrict__ bounds, int64_t num_rows,
                      int64_t phys_rows, int dcol, int pack,
                      float* __restrict__ out) {
  __shared__ int64_t starts[kMaxTileLogical + 1];
  const int tile = tile_phys_rows(pack);
  const int64_t phys0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int tile_phys = static_cast<int>(
      phys_rows - phys0 < tile ? phys_rows - phys0 : tile);
  const int64_t row0 = phys0 * pack;
  // logical rows of the tile that lie inside the table (the last tile may
  // end inside a physical row)
  const int64_t left = num_rows - row0;
  const int rows = static_cast<int>(
      left < static_cast<int64_t>(tile_phys) * pack ? left : tile_phys * pack);
  tile_row_starts(sids, bounds, row0, rows, starts);
  const int elems = tile_phys * kLanes;
  float* dst = out + phys0 * kLanes;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    int row, col;
    float g = 0.0f;
    if (tile_element(e, kLanes, dcol, pack, row, col) && row < rows) {
      g = run_sum(cts, starts[row], starts[row + 1], dcol, col);
    }
    dst[e] = g;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). sids (n,) int32 sorted logical
// ids, cts (n, dcol) f32 cotangent rows in the same order, bounds scratch of
// ceil(num_rows / (tile_phys_rows(pack) * pack)) + 1 int64, out
// (ceil(num_rows / pack), 128) f32. Ids outside [0, num_rows) contribute
// nothing. Returns a cudaError_t (0: launched). Nothing here synchronises.
extern "C" int densify_rows_grad_packed_launch(const int* sids,
                                               const float* cts, long long n,
                                               int dcol, int pack,
                                               long long num_rows,
                                               long long* bounds, float* out,
                                               void* stream) {
  if (dcol < 1 || pack < 1 || pack * dcol > kLanes) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = tile_phys_rows(pack);
  const int64_t phys = (num_rows + pack - 1) / pack;
  cudaError_t err = launch_tile_bounds(
      sids, n, num_rows, reinterpret_cast<int64_t*>(bounds), s,
      static_cast<int64_t>(tile) * pack);
  if (err != cudaSuccess) return (int)err;
  densify_packed_kernel<<<static_cast<unsigned>(num_tiles(phys, tile)),
                          kThreads, 0, s>>>(
      sids, cts, reinterpret_cast<const int64_t*>(bounds), num_rows, phys,
      dcol, pack, out);
  return (int)cudaGetLastError();
}

extern "C" const char* densify_rows_grad_packed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
