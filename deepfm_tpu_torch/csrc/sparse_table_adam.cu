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
//    warps here run in parallel, so each run belongs to the chunk holding
//    its first pair.
//    What bounds it: bytes, the pairs read once (31 MB at bench.py's
//    425,984 x 17, about 9 us at 3.35 TB/s).
//    Design (the plan, SsqPlan, comes from ops/kernels/sparse_adam.py::
//    segment_sumsq_plan; the launch recomputes it and refuses a mismatch):
//     * the pairs are cut into chunks of 32 (a lane each); each warp of a
//       grid of one wave (kSsqWarps) takes a contiguous range of chunks,
//       the ranges one chunk apart at most, and stages the next chunk's
//       ids (with the pair before and after it) and rows in shared memory
//       by coalesced 16-byte cp.async while it sums this one: warps never
//       wait on each other until the block's end;
//     * a run belongs to the chunk holding its first pair (its head, found
//       from the staged ids). A run that ends in its chunk is summed by its
//       head's lane from shared memory (rows D floats apart: D odd is
//       conflict-free), eight columns at a time, so lanes whose runs differ
//       in length do not split the warp; one that goes on past the chunk
//       by the warp from device memory (lane c down column c) when it ends
//       within kSsqScan pairs; a longer one is listed and summed by the
//       whole block after its warps, from device memory through a ring of
//       cp.async chunks (run_square_block), its end found by a binary
//       search. All take each column in stream order from 0.0f and add its
//       square column after column, so a run's square has the same bits
//       whichever sums it;
//     * a lane adds its runs' squares in chunk order, a warp its lanes' by
//       a shuffle tree, a block its warps' in order and then its long
//       runs' in the order of their heads; the last block to finish, found
//       by an integer ticket, sums the blocks' partials in index order and
//       resets the ticket: one launch a call, no float atomics, the same
//       bits every call. Rows too wide to stage two chunks a warp in 48 KB
//       (`staged` = 0, D > 22) are read by the lanes from device memory.
//    Tried and slower on an H100 (chip_smoke.segment_sumsq_probe): a block
//    a tile of 512 pairs staged whole before its sums (0.027 ms of device
//    time at bench.py's shape against the parent's 0.024), and blocks
//    taking tiles of 256 in turn, staging the next while summing this one
//    (0.028): their barriers and the lanes' split between one-pair runs
//    and longer ones held them.
//    The ids are logical in both table layouts.

#include "table_update.cuh"

namespace {

using namespace table_update;

constexpr int kThreadVectors = 2;  // 16-byte vectors of p a thread, at most
constexpr int kTileElements = kThreadVectors * kThreads * kVector;  // a tile's elements
constexpr int kWindowFloats = 4608;  // a window of staged pairs (rows and ids)
// segment_sumsq (its plan, SsqPlan, below)
constexpr int kSsqChunk = 32;         // pairs a chunk: a lane each
constexpr int kSsqScan = 64;          // a run reaching further past its chunk is long
constexpr int kSsqSmemLimit = 48 * 1024;  // a block's shared memory without an opt-in
constexpr int kSsqWarps = 132 * 4 * kWarps;  // warps of the grid, at most: a wave of an H100
constexpr int kSsqIds = 36;           // ids a stage buffer: the pair before, 32, the pair after (+ pad)
constexpr int kSsqWarpChunks = 15;    // chunks a warp, at most (the grid grows past a wave)
constexpr int kStages = 3;            // the block's staging ring: kStages chunks of
constexpr int kStageFloats = 1536;    // kStageFloats floats each
constexpr int kRingFloats = kStages * kStageFloats;

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

// ||column sums||^2 of `count` rows of D floats at src in device memory
// (one run of pairs), by the whole block, kThreads columns a pass: each
// column summed in stream order from 0.0f, the pass's columns of the rows
// arriving by cp.async in a ring of kStages chunks, two in flight while
// thread j adds column c0 + j of the third; then thread 0 adds the pass's
// squares in column order (colbuf: kThreads floats). The result is valid
// on thread 0. Every thread of the block must call it with the same
// arguments.
__device__ float run_square_block(const float* __restrict__ src, int count,
                                  int D, float* ring, float* colbuf) {
  float sq = 0.0f;
  for (int c0 = 0; c0 < D; c0 += kThreads) {
    const int cw = D - c0 < kThreads ? D - c0 : kThreads;  // its columns
    const int per = kStageFloats / cw;  // rows a chunk
    const int chunks = (count + per - 1) / per;
    const int c = c0 + threadIdx.x;
    const auto issue = [&](int k) {
      if (k < chunks) {
        const int first = k * per;
        const int n = (count - first < per ? count - first : per) * cw;
        const float* from = src + static_cast<int64_t>(first) * D + c0;
        float* to = ring + (k % kStages) * kStageFloats;
        if (cw == D) {  // whole rows: one contiguous copy
          for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(to + i, from + i);
        } else {
          for (int i = threadIdx.x; i < n; i += kThreads) {
            cp_async4(to + i, from + static_cast<int64_t>(i / cw) * D + i % cw);
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
      if (c < D) {
        const float* buf = ring + (k % kStages) * kStageFloats + threadIdx.x;
        const int rows = count - k * per < per ? count - k * per : per;
        for (int j = 0; j < rows; ++j) acc = __fadd_rn(acc, buf[j * cw]);
      }
    }
    cp_async_wait<0>();
    if (c < D) colbuf[threadIdx.x] = acc;
    __syncthreads();  // the ring is free, the pass's sums are in colbuf
    if (threadIdx.x == 0) {
      for (int j = 0; j < cw; ++j) sq = __fadd_rn(sq, __fmul_rn(colbuf[j], colbuf[j]));
    }
    __syncthreads();  // colbuf is read
  }
  return sq;
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

// One segment_sumsq launch (ops/kernels/sparse_adam.py::SegmentSumsqPlan):
// the pairs cut into chunks of kSsqChunk; a grid of `grid` blocks of
// kWarps warps (one wave, or more where a warp would take more than
// kSsqWarpChunks chunks), warp w taking a contiguous range of chunks (the
// ranges differ by one chunk at most); `staged`: a chunk's rows are staged in
// shared memory with its ids (else its lanes read their rows from device
// memory). Shared memory, in floats: two stage buffers a warp (each the
// chunk's rows, then kSsqIds ids), or the block path's ring and a pass of
// column sums where larger (they reuse them); the block's list of long-run
// heads (`cap` of them), its warps' sums and the list's count.
struct SsqPlan {
  int64_t n;
  int D;
  int staged;
  int64_t chunks, grid, q, r;  // warp w: q chunks, one more for w < r
  int buf_floats, region_floats, cap;
  int64_t smem;
};

inline SsqPlan ssq_plan_of(int64_t n, int D, int staged) {
  SsqPlan g;
  g.n = n;
  g.D = D;
  g.staged = staged;
  g.chunks = (n + kSsqChunk - 1) / kSsqChunk;
  const int64_t blocks = (g.chunks + kWarps - 1) / kWarps;
  const int64_t wave = kSsqWarps / kWarps;
  const int64_t least = (g.chunks + kWarps * kSsqWarpChunks - 1) / (kWarps * kSsqWarpChunks);
  g.grid = blocks < wave ? blocks : wave;
  if (g.grid < least) g.grid = least;
  if (g.grid < 1) g.grid = 1;
  g.q = g.chunks / (g.grid * kWarps);
  g.r = g.chunks % (g.grid * kWarps);
  const int64_t rows = staged ? static_cast<int64_t>(kSsqChunk) * D : 0;
  const int64_t buf = ((rows + 3) & ~int64_t{3}) + kSsqIds;
  const int64_t bufs = 2 * kWarps * buf;
  const int64_t ring = kRingFloats + kThreads;  // and a pass of column sums
  const int64_t region = bufs > ring ? bufs : ring;
  g.buf_floats = buf > (int64_t{1} << 28) ? -1 : static_cast<int>(buf);
  g.region_floats = region > (int64_t{1} << 28) ? -1 : static_cast<int>(region);
  // the heads of a block's long runs lie more than kSsqScan pairs apart
  const int64_t span = kWarps * (g.q + (g.r > 0)) * kSsqChunk;
  g.cap = static_cast<int>(span / (kSsqScan + 1) + 1);
  g.smem = 4 * (region + ((g.cap + 3) & ~3) + kWarps + 4);
  return g;
}

// Rows staged when two stage buffers a warp fit kSsqSmemLimit.
inline SsqPlan ssq_plan(int64_t n, int D) {
  const SsqPlan g = ssq_plan_of(n, D, 1);
  return g.smem <= kSsqSmemLimit ? g : ssq_plan_of(n, D, 0);
}

// ||column sums||^2 of `count` rows of D floats at src, by one thread:
// each column in stream order from 0.0f, its square added column after
// column. Eight columns at a time, so that a lane whose run is one pair
// (most are) and a lane whose run is longer take the same instructions but
// for the trip count of the row loop: the warp does not split.
__device__ __forceinline__ float run_square_thread(const float* src,
                                                   int count, int D) {
  float sq = 0.0f;
  int c = 0;
  for (; c + 8 <= D; c += 8) {
    float g[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = 0.0f;
    for (int k = 0; k < count; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i) g[i] = __fadd_rn(g[i], src[k * D + c + i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sq = __fadd_rn(sq, __fmul_rn(g[i], g[i]));
  }
  for (; c < D; ++c) {
    float g = 0.0f;
    for (int k = 0; k < count; ++k) g = __fadd_rn(g, src[k * D + c]);
    sq = __fadd_rn(sq, __fmul_rn(g, g));
  }
  return sq;
}

// The same by a warp from device memory, lane c down column c (and
// c + 32, ...), four rows' loads in flight, the squares added in column
// order on every lane. Every lane must call it.
__device__ __forceinline__ float run_square_warp(const float* __restrict__ src,
                                                 int count, int D) {
  const int lane = threadIdx.x & 31;
  float sq = 0.0f;
  for (int c0 = 0; c0 < D; c0 += 32) {
    float g = 0.0f;
    if (c0 + lane < D) {
      const float* col = src + c0 + lane;
      int k = 0;
      for (; k + 4 <= count; k += 4) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = col[static_cast<int64_t>(k + i) * D];
#pragma unroll
        for (int i = 0; i < 4; ++i) g = __fadd_rn(g, v[i]);
      }
      for (; k < count; ++k) g = __fadd_rn(g, col[static_cast<int64_t>(k) * D]);
    }
    const int cw = D - c0 < 32 ? D - c0 : 32;
    for (int j = 0; j < cw; ++j) {
      const float v = __shfl_sync(0xffffffffu, g, j);
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
  }
  return sq;
}

// Start this lane's cp.async copies of chunk c into buf: the ids of pairs
// 32c - 1 .. 32c + 32 (those in [0, n)) at ids[0..33], and, staged, the
// chunk's rows, by 16-byte copies when cts is 16-byte aligned and the
// chunk whole (its rows then start and end on 16-byte boundaries).
__device__ __forceinline__ void stage_chunk(const int* __restrict__ sids,
                                            const float* __restrict__ cts,
                                            const SsqPlan& g, int64_t c,
                                            float* buf) {
  const int lane = threadIdx.x & 31;
  const int64_t p0 = c * kSsqChunk;
  const int nv = g.n - p0 < kSsqChunk ? static_cast<int>(g.n - p0) : kSsqChunk;
  const int rows = g.staged ? ((kSsqChunk * g.D + 3) & ~3) : 0;
  int* ids = reinterpret_cast<int*>(buf + rows);
  for (int i = lane; i < kSsqChunk + 2; i += 32) {
    const int64_t pos = p0 - 1 + i;
    if (pos >= 0 && pos < g.n) cp_async4(ids + i, sids + pos);
  }
  if (g.staged) {
    const float* src = cts + p0 * g.D;
    const int total = nv * g.D;
    if (nv == kSsqChunk && (reinterpret_cast<uintptr_t>(cts) & 15) == 0) {
      for (int v = lane; v < total / 4; v += 32) cp_async16(buf + 4 * v, src + 4 * v);
    } else {
      for (int i = lane; i < total; i += 32) cp_async4(buf + i, src + i);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sumsq_kernel(const int* __restrict__ sids,
                     const float* __restrict__ cts, const SsqPlan g,
                     float* __restrict__ out, float* __restrict__ partials,
                     unsigned* __restrict__ ticket) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = g.D;
  int* long_heads = reinterpret_cast<int*>(sm + g.region_floats);
  float* warp_sums = reinterpret_cast<float*>(long_heads + ((g.cap + 3) & ~3));
  int* nlong = reinterpret_cast<int*>(warp_sums + kWarps);
  if (tid == 0) *nlong = 0;
  __syncthreads();

  // 1. each warp its chunks, the next one's copies in flight while this
  // one is summed; a lane adds its runs' squares in chunk order
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t c0 = w * g.q + (w < g.r ? w : g.r);
  const int64_t c1 = c0 + g.q + (w < g.r ? 1 : 0);
  float* const bufs = sm + 2 * warp * g.buf_floats;  // this warp's two
  const int rows_floats = g.staged ? ((kSsqChunk * D + 3) & ~3) : 0;
  float acc = 0.0f;
  if (c0 < c1) stage_chunk(sids, cts, g, c0, bufs);
  cp_async_commit();
  for (int64_t c = c0, it = 0; c < c1; ++c, ++it) {
    if (c + 1 < c1) {
      stage_chunk(sids, cts, g, c + 1, bufs + ((it + 1) & 1) * g.buf_floats);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies (the next chunk's may fly)
    __syncwarp();
    const float* buf = bufs + (it & 1) * g.buf_floats;
    const int* ids = reinterpret_cast<const int*>(buf + rows_floats) + 1;
    const int64_t p0 = c * kSsqChunk;
    const int nv = g.n - p0 < kSsqChunk ? static_cast<int>(g.n - p0) : kSsqChunk;
    const int id = lane < nv ? ids[lane] : 0;
    const bool head = lane < nv && (p0 + lane == 0 || ids[lane - 1] != id);
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    // the next head, or the chunk's end; a run reaching the end goes on
    // when the pair after the chunk has its id
    const unsigned after = lane < 31 ? heads >> (lane + 1) : 0u;
    const int e = after ? lane + __ffs(after) : nv;
    const bool goes_on = head && e == nv && p0 + nv < g.n && ids[nv] == id;
    if (head && !goes_on) {
      const float* src = g.staged ? buf + lane * D : cts + (p0 + lane) * D;
      acc = __fadd_rn(acc, run_square_thread(src, e - lane, D));
    }
    // a run going on past the chunk (its last head): its end within
    // kSsqScan pairs by the warp, from device memory, else a long run
    const unsigned on = __ballot_sync(0xffffffffu, goes_on);
    if (on != 0u) {
      const int owner = __ffs(on) - 1;
      const int run_id = __shfl_sync(0xffffffffu, id, owner);
      const int64_t a = p0 + owner;
      int64_t end = -1;
      for (int64_t b = p0 + kSsqChunk; b < p0 + kSsqChunk + kSsqScan; b += 32) {
        const int64_t j = b + lane;
        const unsigned ended = __ballot_sync(0xffffffffu, j >= g.n || sids[j] != run_id);
        if (ended != 0u) {
          end = b + __ffs(ended) - 1;
          break;
        }
      }
      if (end >= 0) {
        const float sq = run_square_warp(cts + a * D, static_cast<int>(end - a), D);
        if (lane == owner) acc = __fadd_rn(acc, sq);
      } else if (lane == 0) {
        long_heads[atomicAdd(nlong, 1)] = static_cast<int>(a);
      }
    }
    __syncwarp();  // the buffer is read: the chunk after next may take it
  }
  cp_async_wait_all();
  // the warp's sum: a shuffle tree over its lanes
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();  // every warp done: the stage buffers may hold the ring

  // 2. the block's sum: its warps' in order, then its long runs in the
  // order of their heads, each summed by the block from device memory
  const int count = *nlong;
  if (tid == 0) {  // the heads in stream order (few: each run is long)
    for (int i = 1; i < count; ++i) {
      const int v = long_heads[i];
      int k = i - 1;
      while (k >= 0 && long_heads[k] > v) {
        long_heads[k + 1] = long_heads[k];
        --k;
      }
      long_heads[k + 1] = v;
    }
  }
  __syncthreads();
  float part = 0.0f;
  if (tid == 0) {
    for (int k = 0; k < kWarps; ++k) part = __fadd_rn(part, warp_sums[k]);
  }
  for (int i = 0; i < count; ++i) {
    const int64_t a = long_heads[i];
    const int64_t end = lower_bound(sids, a + 1, g.n, static_cast<int64_t>(sids[a]) + 1);
    const float sq = run_square_block(cts + a * D, static_cast<int>(end - a), D,
                                      sm, sm + kRingFloats);
    if (tid == 0) part = __fadd_rn(part, sq);
  }

  // 3. the last block to finish sums the blocks' partials in index order
  if (tid == 0) {
    partials[blockIdx.x] = part;
    __threadfence();  // the partial before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    float s = 0.0f;
    int64_t i = tid;
    for (; i + 3 * kThreads < gridDim.x; i += 4 * kThreads) {  // 4 loads in flight
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __ldcg(partials + i + k * kThreads);
#pragma unroll
      for (int k = 0; k < 4; ++k) s = __fadd_rn(s, v[k]);
    }
    for (; i < gridDim.x; i += kThreads) s = __fadd_rn(s, __ldcg(partials + i));
    const float all = block_total(s, red);
    if (tid == 0) {
      out[0] = all;
      *ticket = 0u;  // ready for the next call
    }
  }
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
// order; staged, threads, smem and grid: the caller's plan
// (segment_sumsq_plan), refused (cudaErrorInvalidValue) unless it is this
// file's; scratch: 1 + grid f32, scratch[0] receives the sum, the rest
// holds the blocks' partials; ticket: one unsigned, 0 before the call and
// after it (calls that share a ticket must not overlap: one stream).
extern "C" int segment_sumsq_launch(const int* sids, const float* cts,
                                    long long n, int D, int staged,
                                    int threads, int smem, long long grid,
                                    float* scratch, unsigned* ticket,
                                    void* stream) {
  if (D < 1 || n < 0 || n > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const SsqPlan g = ssq_plan(n, D);
  if (staged != g.staged || threads != kThreads || smem != g.smem ||
      grid != g.grid || g.smem > kSsqSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  segment_sumsq_kernel<<<static_cast<unsigned>(g.grid), kThreads,
                         static_cast<size_t>(g.smem),
                         static_cast<cudaStream_t>(stream)>>>(
      sids, cts, g, scratch, scratch + 1, ticket);
  return (int)cudaGetLastError();
}

extern "C" const char* sparse_table_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
