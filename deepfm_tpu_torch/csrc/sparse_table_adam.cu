// Fused sparse backward-optimizer for Hopper (sm_90a): the two kernels of
// deepfm_tpu/ops/pallas/sparse_adam_kernel.py.
//
// 1. sparse_table_adam — replaces sparse_table_adam_packed /
//    _sparse_adam_kernel: sum the sorted (id, cotangent) pairs into each
//    row's gradient (the segmented row sum of densify_rows_grad.cu), apply
//    decay + clip + Adam (table_update::adam_update, shared with
//    fused_table_adam.cu) to p, mu and nu in place, and add up p'^2. The
//    dense gradient never reaches device memory. One kernel serves both
//    table layouts through `pack`: the packed (phys, 128) layout of the TPU
//    kernel (logical element (r, c) at (r / pack) * 128 + (r % pack) * dcol
//    + c) and the logical (rows, dcol) layout (pack = 1). Dead lanes of a
//    packed row take the update with g = p = mu = nu = 0 and stay 0. On the
//    same logical state both layouts give the same p, mu and nu bit for
//    bit (the same run sums, the same per-element arithmetic); sum(p'^2)
//    differs by its summation order.
//    What bounds it: bytes. p read + written (8 B) and mu, nu read +
//    written (8 B in bf16, 16 B in f32) per element, plus the pairs once:
//    2.83 GB + 31 MB at bench.py's 10.4M x 17 logical table with bf16
//    moments (about 0.85 ms at 3.35 TB/s), 3.04 GB + 31 MB packed (the
//    dead lanes move too; about 0.92 ms). About 4 % of the rows have pairs.
//    Design (the plan, Tile, comes from ops/kernels/sparse_adam.py::
//    sparse_adam_plan; the launch recomputes it and refuses a mismatch):
//     * a block owns one tile of tile_phys physical rows, at most 4096
//       elements (two 16-byte vectors a thread; the launch refuses rows so
//       wide that the fewest rows making a multiple of 8 elements pass
//       that: 512 * gcd(width, 8) floats at most); its element count is a
//       multiple of 8, so every tile starts on
//       the table's vector grid. A tile is cut into a scalar head (up to the
//       first element where p, mu and nu are all 16-byte aligned: the same
//       offset in every tile), vectors of 8 elements and a scalar tail.
//       The grid is one block a tile: the card's block scheduler balances
//       a tile with a long run against the others.
//     * first each thread issues the loads of its vectors (p as two float4,
//       bf16 moments as one 16-byte word each) and keeps them raw in
//       registers, so the table streams in while the gradient is built;
//     * the tile's pairs [bounds[t], bounds[t+1]) (bounds: one
//       searchsorted a tile, by tile_bounds_kernel) arrive in shared
//       memory, ids and rows, by cp.async, a window at a time, and are
//       summed into a zeroed shared-memory copy of the tile's gradient by
//       the densify kernels' segmented row sum (table_update::add_runs): a
//       warp a run, found by ballots, lane c down column c in stream order
//       from 0.0f, as the plain version sums; a run cut by a window's end
//       carries its sum in the tile, so a 16,384-pair run is a chain of
//       shared-memory adds (fault 3: one thread walked it from device
//       memory). So a block waits on two round trips to device memory (the
//       bounds, then the pairs) before its update, while its table vectors
//       stream in;
//     * then the update, 8 elements at a time from registers and the
//       shared gradient, stored in 16-byte accesses. In the packed layout
//       an element whose p, mu, nu and gradient are all +0 (a dead lane) is
//       left as it is where the update would leave it so (zeros_stay_zero):
//       updating it would take the IEEE divider's slow path.
//     Tried and slower on an H100: a run map (each run's start and end
//     written by a pass over the pairs, then a thread a (run, column)
//     summing from device memory: three round trips), a persistent block
//     that loads the next tile's vectors while it works on this one (199
//     registers in f32, 128 with spills in bf16: too few warps an SM),
//     register caps of 40-48, four vectors a thread, and a thread a run
//     (its columns one after another; runs past 64 pairs summed by the
//     block from a ring): 1.31-1.34 ms of device time at bench.py's
//     logical table against 1.11-1.15 with add_runs.
//    sum(p'^2) is reduced per block (a fixed shuffle tree) into a partials
//    array and then by one block in a fixed order: the carried table_psq
//    is deterministic.
//
// 2. segment_sumsq — replaces segment_sumsq_pairs / _segsumsq_kernel:
//    sum over runs of equal sorted ids of ||sum of the run's rows||^2. The
//    TPU kernel walks the stream sequentially and contracts (c, c) pairwise
//    Gram blocks on the MXU, carrying the open run between grid steps;
//    blocks here run in parallel, so each run belongs to the block holding
//    its first pair. A run of at most kLongRun pairs is summed by that
//    pair's thread, column after column, in stream order; a longer one
//    (its end found by a binary search) by the whole block from staged rows
//    (staged_column_sums: each column in stream order), its squares summed
//    by a fixed tree over the columns. Run squares are reduced per block,
//    then summed in a fixed order. The ids are logical in both layouts.
//    What bounds it: bytes, the pairs read once (31 MB, about 9 us).

#include "table_update.cuh"

namespace {

using namespace table_update;

constexpr int kThreadVectors = 2;  // 16-byte vectors of p a thread, at most
constexpr int kTileElements = kThreadVectors * kThreads * kVector;  // a tile's elements
constexpr int kWindowFloats = 4608;  // a window of staged pairs (rows and ids)
constexpr int kLongRun = 64;          // segment_sumsq: a longer run is summed from staged rows
constexpr int kStages = 3;            // its staging ring: kStages chunks of
constexpr int kStageFloats = 1536;    // kStageFloats floats each

// A table and its tiles (the plan of ops/kernels/sparse_adam.py).
struct Tile {
  int64_t rows;   // physical rows
  int width;      // floats a physical row
  int dcol;       // columns a logical row
  int pack;       // logical rows a physical row
  int head;       // elements of every tile before its first vector, or -1:
                  // no common 16-byte boundary, every element scalar
  int tile_phys;  // physical rows a tile
};

// Physical rows a tile: the most, in steps that keep the tile's element
// count a multiple of kVector, with at most kTileElements elements (at
// least one step: a wider tile is refused).
inline int tile_rows(int width) {
  int q = 1;
  while ((q * width) % kVector != 0) ++q;
  const int t = kTileElements / width / q * q;
  return t < q ? q : t;
}

// Pairs a window holds (at least one: dcol is at most kTileElements).
__host__ __device__ inline int window_pairs(int dcol) {
  return kWindowFloats / (dcol + 1);
}

// Dynamic shared memory of a block, under the 48 KB a block has without an
// opt-in: the tile's gradient (kVector floats more, for the shift that
// aligns its vectors) and a window of the tile's pairs.
inline int smem_bytes(const Tile& g) {
  return 4 * (g.tile_phys * g.width + kVector) +
         4 * window_pairs(g.dcol) * (g.dcol + 1);
}

// Column sums of `count` rows of dcol floats at src (one run of pairs), each
// column summed in stream order from 0.0f, by the whole block, kThreads
// columns a pass: the pass's columns of the rows arrive by cp.async in a
// ring of kStages chunks, two in flight while thread j adds column c0 + j
// of the third. fin(c, sum) runs on column c's thread once the ring is
// free. Every thread of the block must call it with the same arguments.
template <class Fin>
__device__ void staged_column_sums(const float* __restrict__ src, int count,
                                   int dcol, float* ring, const Fin& fin) {
  for (int c0 = 0; c0 < dcol; c0 += kThreads) {
    const int cw = dcol - c0 < kThreads ? dcol - c0 : kThreads;  // its columns
    const int per = kStageFloats / cw;  // rows a chunk
    const int chunks = (count + per - 1) / per;
    const int c = c0 + threadIdx.x;
    const auto issue = [&](int k) {
      if (k < chunks) {
        const int first = k * per;
        const int n = (count - first < per ? count - first : per) * cw;
        const float* from = src + static_cast<int64_t>(first) * dcol + c0;
        float* to = ring + (k % kStages) * kStageFloats;
        if (cw == dcol) {  // whole rows: one contiguous copy
          for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(to + i, from + i);
        } else {
          for (int i = threadIdx.x; i < n; i += kThreads) {
            cp_async4(to + i, from + static_cast<int64_t>(i / cw) * dcol + i % cw);
          }
        }
      }
      cp_async_commit();
    };
    issue(0);
    issue(1);
    float acc = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      cp_async_wait<1>();  // this thread's copies of chunk k
      __syncthreads();     // everyone's; and chunk k-1, in chunk k+2's slot, is summed
      issue(k + 2);
      if (c < dcol) {
        const float* buf = ring + (k % kStages) * kStageFloats + threadIdx.x;
        const int rows = count - k * per < per ? count - k * per : per;
        for (int j = 0; j < rows; ++j) acc = __fadd_rn(acc, buf[j * cw]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
    if (c < dcol) fin(c, acc);
  }
}

// bounds[t] = first stream position whose id is >= min(t * rows_per_tile,
// limit), for t in [0, tiles]: ids at or past `limit` (the table's logical
// rows) fall in no tile.
__global__ void tile_bounds_kernel(const int* __restrict__ sids, int64_t n,
                                   int64_t tiles, int64_t rows_per_tile,
                                   int64_t limit, int64_t* __restrict__ bounds) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t <= tiles) {
    const int64_t row = t * rows_per_tile;
    bounds[t] = lower_bound(sids, 0, n, row < limit ? row : limit);
  }
}

// A tile's elements: the first, the scalar head, the vectors and the
// scalar elements (head and tail).
struct Span {
  int64_t e0;
  int hs, nv, ns;
};

__device__ __forceinline__ Span span_of(const Tile& g, int64_t t) {
  const int64_t phys0 = t * g.tile_phys;
  const int L = static_cast<int>(
      (g.rows - phys0 < g.tile_phys ? g.rows - phys0 : g.tile_phys) * g.width);
  Span s;
  s.e0 = phys0 * g.width;
  s.hs = g.head < 0 ? L : (g.head < L ? g.head : L);
  s.nv = (L - s.hs) / kVector;
  s.ns = L - kVector * s.nv;
  return s;
}

// This thread's vectors of one tile (vector threadIdx.x + k * kThreads),
// raw, as loaded.
template <typename M>
struct Vectors {
  Vec8<float> p[kThreadVectors];
  Vec8<M> mu[kThreadVectors], nu[kThreadVectors];

  __device__ __forceinline__ void load(const float* pp, const M* mp,
                                       const M* np, const Span& s) {
#pragma unroll
    for (int k = 0; k < kThreadVectors; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < s.nv) {
        const int64_t i = s.e0 + s.hs + kVector * v;
        p[k].load(pp + i);
        mu[k].load(mp + i);
        nu[k].load(np + i);
      }
    }
  }
};

// Whether adam_update takes an element whose p, mu, nu and gradient are all
// +0 to +0, +0, +0: true for any Adam a trainer runs (finite scalars, eps
// and the bias corrections positive, betas in [0, 1]). Such an element (a
// packed row's dead lane) is then left as it is: updating it would take
// the IEEE divider's slow path, which a zero dividend takes (it slowed the
// whole packed stream on an H100).
__device__ __forceinline__ bool zeros_stay_zero(const Scalars& s, const Betas& b) {
  return isfinite(s.lr) && isfinite(s.wd) && !isnan(s.gnorm) &&
         (s.noclip || isfinite(s.clip)) && s.eps > 0.0f && isfinite(s.eps) &&
         s.bc1 > 0.0f && s.bc2 > 0.0f && b.one_m_b1 >= 0.0f && b.b1 >= 0.0f &&
         b.one_m_b2 >= 0.0f && b.b2 >= 0.0f &&
         isfinite(b.one_m_b1 + b.b1 + b.one_m_b2 + b.b2);
}

template <bool kCheckZeros>
__device__ __forceinline__ float update(float p, float grad, float& mu,
                                        float& nu, const Scalars& s,
                                        const Betas& b, bool keep_zeros) {
  if (kCheckZeros && keep_zeros &&
      (__float_as_uint(p) | __float_as_uint(grad) | __float_as_uint(mu) |
       __float_as_uint(nu)) == 0u) {
    return p;
  }
  return adam_update(p, grad, mu, nu, s, b);
}

// One block a tile. kPacked: the packed layout, whose dead lanes (all +0)
// are left as they are where zeros_stay_zero holds. With bf16 moments four
// blocks an SM (at most 64 registers; a few spill, and the stream is still
// faster than with fewer blocks); with f32 moments the compiler's choice
// (the same cap made it slower), on an H100.
template <typename M, bool kPacked>
__global__ void __launch_bounds__(kThreads, sizeof(M) == 2 ? 4 : 1)
sparse_adam_kernel(float* __restrict__ p, M* __restrict__ mu,
                   M* __restrict__ nu, const Tile g,
                   const int* __restrict__ sids, const float* __restrict__ cts,
                   const int64_t* __restrict__ bounds,
                   const float* __restrict__ scalars, Betas betas,
                   float* __restrict__ partials) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  const int64_t t = blockIdx.x;
  const Span span = span_of(g, t);
  // tile element e's gradient is gbuf[e + shift]: the vectors' 16-byte aligned
  const int shift = g.head < 0 ? 0 : (kVector - g.head) & (kVector - 1);
  float* gbuf = sm;
  // a window of the tile's pairs: rows, then ids
  const int window = window_pairs(g.dcol);
  float* wrows = sm + g.tile_phys * g.width + kVector;
  int* wids = reinterpret_cast<int*>(wrows + window * g.dcol);

  // 1. this thread's table vectors, raw, in flight until the update
  Vectors<M> cur;
  cur.load(p, mu, nu, span);
  float sc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i] = scalars[i];

  // 2. the tile's pairs [s0, s1), a window at a time: ids and rows by
  // cp.async, their runs added in stream order into the zeroed gradient
  const int64_t s0 = bounds[t], s1 = bounds[t + 1];
  float4* g4 = reinterpret_cast<float4*>(gbuf);
  for (int i = tid; i < (g.tile_phys * g.width + kVector) / 4; i += kThreads) {
    g4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int64_t row0 = t * g.tile_phys * g.pack;  // the tile's first logical row
  for (int64_t w0 = s0; w0 < s1; w0 += window) {
    const int n = static_cast<int>(s1 - w0 < window ? s1 - w0 : window);
    for (int i = tid; i < n; i += kThreads) cp_async4(wids + i, sids + w0 + i);
    const float* from = cts + w0 * g.dcol;
    for (int i = tid; i < n * g.dcol; i += kThreads) cp_async4(wrows + i, from + i);
    cp_async_wait_all();
    __syncthreads();  // the window (and the zeroed gradient)
    add_runs(wids, wrows, 0, n, row0, g.dcol, g.pack, g.width, gbuf + shift);
    __syncthreads();  // the window is spent
  }
  if (s1 == s0) __syncthreads();  // the gradient is complete

  // 3. the update
  const Scalars s = make_scalars(sc);
  const bool keep_zeros = kPacked && zeros_stay_zero(s, betas);
  float psq = 0.0f;
#pragma unroll
  for (int k = 0; k < kThreadVectors; ++k) {
    const int v = tid + k * kThreads;
    if (v < span.nv) {
      const int le = span.hs + kVector * v;
      float pf[kVector], m[kVector], w[kVector];
      cur.p[k].unpack(pf);
      cur.mu[k].unpack(m);
      cur.nu[k].unpack(w);
      const float4 ga = reinterpret_cast<const float4*>(gbuf + shift + le)[0];
      const float4 gb = reinterpret_cast<const float4*>(gbuf + shift + le)[1];
      const float gr[kVector] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int e = 0; e < kVector; ++e) {
        pf[e] = update<kPacked>(pf[e], gr[e], m[e], w[e], s, betas, keep_zeros);
        psq = __fadd_rn(psq, __fmul_rn(pf[e], pf[e]));
      }
      const int64_t i = span.e0 + le;
      store8(p + i, pf);
      store8(mu + i, m);
      store8(nu + i, w);
    }
  }
  for (int u = tid; u < span.ns; u += kThreads) {
    const int le = u < span.hs ? u : kVector * span.nv + u;
    const int64_t i = span.e0 + le;
    float m = load_moment(mu, i);
    float w = load_moment(nu, i);
    const float pn = update<kPacked>(p[i], gbuf[shift + le], m, w, s, betas, keep_zeros);
    p[i] = pn;
    store_moment(mu, i, m);
    store_moment(nu, i, w);
    psq = __fadd_rn(psq, __fmul_rn(pn, pn));
  }
  const float total = block_total(psq, red);
  if (tid == 0) partials[t] = total;
}

__global__ void __launch_bounds__(kThreads)
segment_sumsq_kernel(const int* __restrict__ sids,
                     const float* __restrict__ cts, int64_t n, int D,
                     float* __restrict__ partials) {
  __shared__ __align__(16) float ring[kStages * kStageFloats];
  __shared__ int64_t ends[kThreads];
  __shared__ unsigned long_heads[kWarps];
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = first + tid;
  float sq = 0.0f;
  bool is_long = false;
  if (i < n && (i == 0 || sids[i] != sids[i - 1])) {
    const int id = sids[i];
    int64_t end = i + 1;
    while (end < n && end - i <= kLongRun && sids[end] == id) ++end;
    if (end < n && sids[end] == id) {
      ends[tid] = lower_bound(sids, end, n, static_cast<int64_t>(id) + 1);
      is_long = true;
    } else {
      for (int c = 0; c < D; ++c) {
        float g = 0.0f;
        for (int64_t k = i; k < end; ++k) g = __fadd_rn(g, cts[k * D + c]);
        sq = __fadd_rn(sq, __fmul_rn(g, g));
      }
    }
  }
  const unsigned heads = __ballot_sync(0xffffffffu, is_long);
  if ((tid & 31) == 0) long_heads[tid >> 5] = heads;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    for (unsigned h = long_heads[w]; h != 0u; h &= h - 1u) {
      const int j = w * 32 + __ffs(h) - 1;
      const int64_t a = first + j;
      float part = 0.0f;  // this thread's columns' squares
      staged_column_sums(cts + a * D, static_cast<int>(ends[j] - a), D, ring,
                         [&](int, float v) { part = __fadd_rn(part, __fmul_rn(v, v)); });
      const float run_sq = block_total(part, red);
      if (tid == j) sq = run_sq;
    }
  }
  const float total = block_total(sq, red);
  if (tid == 0) partials[blockIdx.x] = total;
}

template <typename M, bool kPacked>
cudaError_t launch_adam(float* p, void* mu, void* nu, const Tile& g,
                        const int* sids, const float* cts, int64_t n,
                        const float* scalars, Betas betas, int64_t* bounds,
                        float* partials, float* psq, cudaStream_t stream) {
  const int64_t tiles = (g.rows + g.tile_phys - 1) / g.tile_phys;
  tile_bounds_kernel<<<static_cast<unsigned>((tiles + kThreads) / kThreads),
                       kThreads, 0, stream>>>(
      sids, n, tiles, static_cast<int64_t>(g.tile_phys) * g.pack,
      g.rows * g.pack, bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sparse_adam_kernel<M, kPacked>
      <<<static_cast<unsigned>(tiles), kThreads, smem_bytes(g), stream>>>(
          p, static_cast<M*>(mu), static_cast<M*>(nu), g, sids, cts, bounds,
          scalars, betas, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  final_sum_kernel<<<1, kThreads, 0, stream>>>(partials, tiles, psq);
  return cudaGetLastError();
}

template <typename M>
cudaError_t launch_layout(float* p, void* mu, void* nu, const Tile& g,
                          const int* sids, const float* cts, int64_t n,
                          const float* scalars, Betas betas, int64_t* bounds,
                          float* partials, float* psq, cudaStream_t stream) {
  return g.pack > 1
             ? launch_adam<M, true>(p, mu, nu, g, sids, cts, n, scalars, betas,
                                    bounds, partials, psq, stream)
             : launch_adam<M, false>(p, mu, nu, g, sids, cts, n, scalars,
                                     betas, bounds, partials, psq, stream);
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
// device [lr, wd, gnorm, clip, bc1, bc2, eps, noclip]; tile_phys, head and
// smem: the caller's plan (sparse_adam_plan), refused
// (cudaErrorInvalidValue) unless it is this file's for these pointers and
// the tile holds at most kTileElements elements;
// bounds scratch of ceil(rows / tile_phys) + 1 int64; partials scratch of
// ceil(rows / tile_phys) f32; psq: one f32, receives sum(p'^2). Ids
// outside [0, rows * pack) contribute nothing.
extern "C" int sparse_table_adam_launch(float* p, void* mu, void* nu,
                                        int moments_bf16, long long rows,
                                        int width, int dcol, int pack,
                                        const int* sids, const float* cts,
                                        long long n, const float* scalars,
                                        float one_m_b1, float b1,
                                        float one_m_b2, float b2,
                                        int tile_phys, int head, int smem,
                                        long long* bounds, float* partials,
                                        float* psq, void* stream) {
  if (dcol < 1 || pack < 1 || pack * dcol > width ||
      (pack > 1 && width != kLanes) || n < 0 || n > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[3] = {p, mu, nu};
  const int msize = moments_bf16 ? 2 : 4;
  const int sizes[3] = {4, msize, msize};
  const Tile g{rows, width, dcol, pack, aligned_head(ptrs, sizes, 3),
               tile_rows(width)};
  if (tile_phys != g.tile_phys || head != g.head || smem != smem_bytes(g) ||
      static_cast<int64_t>(g.tile_phys) * width > kTileElements) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaMemsetAsync(psq, 0, sizeof(float), s);
  const Betas betas{one_m_b1, b1, one_m_b2, b2};
  int64_t* bnd = reinterpret_cast<int64_t*>(bounds);
  const cudaError_t err =
      moments_bf16
          ? launch_layout<__nv_bfloat16>(p, mu, nu, g, sids, cts, n, scalars,
                                         betas, bnd, partials, psq, s)
          : launch_layout<float>(p, mu, nu, g, sids, cts, n, scalars, betas,
                                 bnd, partials, psq, s);
  return (int)err;
}

// segment_sumsq_launch: sids (n,) int32 sorted; cts (n, D) f32 in the same
// order; partials scratch of ceil(n / 256) f32; out:
// one f32.
extern "C" int segment_sumsq_launch(const int* sids, const float* cts,
                                    long long n, int D, float* partials,
                                    float* out, void* stream) {
  if (D < 1 || n < 0 || n > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    segment_sumsq_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        sids, cts, n, D, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  final_sum_kernel<<<1, kThreads, 0, s>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

extern "C" const char* sparse_table_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
