// Fused sparse backward-optimizer for Hopper (sm_90a): the two kernels of
// deepfm_tpu/ops/pallas/sparse_adam_kernel.py.
//
// 1. sparse_table_adam — replaces sparse_table_adam_packed /
//    _sparse_adam_kernel. Per tile of table rows: sum the sorted
//    (id, cotangent) pairs into each row's gradient (the segmented row sum
//    of densify_rows_grad.cu), apply decay + clip + Adam
//    (table_update::adam_update, shared with fused_table_adam.cu) to p, mu
//    and nu in place, and add up p'^2. The dense gradient never reaches
//    device memory. One kernel serves both table layouts through `pack`:
//    the packed (phys, 128) layout of the TPU kernel (pack = 128 / dcol
//    logical rows per physical row, logical element (r, c) at
//    (r / pack) * 128 + (r % pack) * dcol + c) and the logical (rows, dcol)
//    layout (pack = 1). A block owns tile_phys_rows(pack) physical rows
//    (128 in both layouts at d = 16). Dead lanes of a packed row take the
//    update with g = p = mu = nu = 0 and stay 0; sum(p'^2) covers the whole
//    tile. On the same logical state both layouts give the same p, mu and
//    nu bit for bit (the same run sums, the same per-element arithmetic);
//    sum(p'^2) differs by its summation order.
//    What bounds it: bytes. p read + written (8 B) and mu, nu read +
//    written (8 B in bf16, 16 B in f32) per element, plus the pairs once:
//    2.83 GB + 31 MB at bench.py's 10.4M x 17 logical table with bf16
//    moments (about 0.85 ms at 3.35 TB/s), 3.04 GB + 31 MB packed (the
//    dead lanes move too; about 0.92 ms).
//    sum(p'^2) is reduced per block into a partials array and then summed
//    by one block in a fixed order: the carried table_psq is deterministic.
//
// 2. segment_sumsq — replaces segment_sumsq_pairs / _segsumsq_kernel:
//    sum over runs of equal sorted ids of ||sum of the run's rows||^2. The
//    TPU kernel walks the stream sequentially and contracts (c, c) pairwise
//    Gram blocks on the MXU, carrying the open run between grid steps;
//    blocks here run in parallel, so each run belongs to the block holding
//    its first pair, whose thread walks the run (past the block's end if it
//    must) and sums it in stream order. Run squares are reduced per block,
//    then summed in a fixed order. The ids are logical in both layouts.
//    What bounds it: bytes, the pairs read once (31 MB, about 9 us).

#include "table_update.cuh"

namespace {

using namespace table_update;

// kPacked = (pack > 1, width == kLanes): the packed instantiation splits
// an element index with the constant row width; the logical one keeps the
// plain row / column split, with no per-element division by dcol.
template <typename M, bool kPacked>
__global__ void __launch_bounds__(kThreads)
sparse_adam_kernel(float* __restrict__ p, M* __restrict__ mu,
                   M* __restrict__ nu, int64_t rows, int width, int dcol,
                   int pack, const int* __restrict__ sids,
                   const float* __restrict__ cts,
                   const int64_t* __restrict__ bounds,
                   const float* __restrict__ scalars, Betas betas,
                   float* __restrict__ partials) {
  __shared__ int64_t starts[kMaxTileLogical + 1];
  const Scalars s = load_scalars(scalars);
  const int tile = tile_phys_rows(pack);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int tile_rows = static_cast<int>(
      rows - row0 < tile ? rows - row0 : tile);
  tile_row_starts(sids, bounds, row0 * pack, tile_rows * pack, starts);
  const int elems = tile_rows * width;
  const int64_t base = row0 * width;
  float psq = 0.0f;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    int r, c;
    bool live = true;
    if (kPacked) {
      live = tile_element(e, kLanes, dcol, pack, r, c);
    } else {
      r = e / width;
      c = e - r * width;
    }
    const float grad =
        live ? run_sum(cts, starts[r], starts[r + 1], dcol, c) : 0.0f;
    const int64_t i = base + e;
    float m = load_moment(mu, i);
    float v = load_moment(nu, i);
    const float pn = adam_update(p[i], grad, m, v, s, betas);
    p[i] = pn;
    store_moment(mu, i, m);
    store_moment(nu, i, v);
    psq = __fadd_rn(psq, __fmul_rn(pn, pn));
  }
  const float total = block_sum(psq);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
segment_sumsq_kernel(const int* __restrict__ sids,
                     const float* __restrict__ cts, int64_t n, int D,
                     float* __restrict__ partials) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float sq = 0.0f;
  if (i < n && (i == 0 || sids[i] != sids[i - 1])) {
    const int id = sids[i];
    int64_t end = i + 1;
    while (end < n && sids[end] == id) ++end;
    for (int c = 0; c < D; ++c) {
      const float g = run_sum(cts, i, end, D, c);
      sq = __fadd_rn(sq, __fmul_rn(g, g));
    }
  }
  const float total = block_sum(sq);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename M>
cudaError_t launch_adam(float* p, void* mu, void* nu, int64_t rows,
                        int width, int dcol, int pack, const int* sids,
                        const float* cts, int64_t n, const float* scalars,
                        Betas betas, int64_t* bounds, float* partials,
                        float* psq, cudaStream_t stream) {
  const int tile = tile_phys_rows(pack);
  cudaError_t err = launch_tile_bounds(sids, n, rows * pack, bounds, stream,
                                       static_cast<int64_t>(tile) * pack);
  if (err != cudaSuccess) return err;
  const int64_t tiles = num_tiles(rows, tile);
  const unsigned grid = static_cast<unsigned>(tiles);
  if (pack > 1) {
    sparse_adam_kernel<M, true><<<grid, kThreads, 0, stream>>>(
        p, static_cast<M*>(mu), static_cast<M*>(nu), rows, width, dcol, pack,
        sids, cts, bounds, scalars, betas, partials);
  } else {
    sparse_adam_kernel<M, false><<<grid, kThreads, 0, stream>>>(
        p, static_cast<M*>(mu), static_cast<M*>(nu), rows, width, dcol, pack,
        sids, cts, bounds, scalars, betas, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  final_sum_kernel<<<1, kReduceThreads, 0, stream>>>(partials, tiles, psq);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t
// (0: launched) and synchronises nothing.
//
// sparse_table_adam_launch: p (rows, width) f32 physical rows, each holding
// `pack` logical rows of dcol columns (pack = 1, width = dcol: the logical
// layout; pack > 1, width = 128: the packed one); mu, nu shaped like p, bf16
// (moments_bf16 = 1) or f32, all updated in place; sids (n,) int32 sorted
// logical ids; cts (n, dcol) f32 in the same order; scalars: 8 f32 on the
// device [lr, wd, gnorm, clip, bc1, bc2, eps, noclip]; bounds scratch of
// ceil(rows / tile_phys_rows(pack)) + 1 int64; partials scratch of
// ceil(rows / tile_phys_rows(pack)) f32; psq: one f32, receives
// sum(p'^2). Ids outside [0, rows * pack) contribute nothing.
extern "C" int sparse_table_adam_launch(float* p, void* mu, void* nu,
                                        int moments_bf16, long long rows,
                                        int width, int dcol, int pack,
                                        const int* sids, const float* cts,
                                        long long n, const float* scalars,
                                        float one_m_b1, float b1,
                                        float one_m_b2, float b2,
                                        long long* bounds, float* partials,
                                        float* psq, void* stream) {
  if (dcol < 1 || pack < 1 || pack * dcol > width
      || (pack > 1 && width != kLanes)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return (int)cudaMemsetAsync(psq, 0, sizeof(float),
                                             static_cast<cudaStream_t>(stream));
  const Betas betas{one_m_b1, b1, one_m_b2, b2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* bnd = reinterpret_cast<int64_t*>(bounds);
  const cudaError_t err =
      moments_bf16
          ? launch_adam<__nv_bfloat16>(p, mu, nu, rows, width, dcol, pack,
                                       sids, cts, n, scalars, betas, bnd,
                                       partials, psq, s)
          : launch_adam<float>(p, mu, nu, rows, width, dcol, pack, sids, cts,
                               n, scalars, betas, bnd, partials, psq, s);
  return (int)err;
}

// segment_sumsq_launch: sids (n,) int32 sorted; cts (n, D) f32 in the same
// order; partials scratch of ceil(n / 256) f32; out: one f32.
extern "C" int segment_sumsq_launch(const int* sids, const float* cts,
                                    long long n, int D, float* partials,
                                    float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    segment_sumsq_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        sids, cts, n, D, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  final_sum_kernel<<<1, kReduceThreads, 0, s>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

extern "C" const char* sparse_table_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
