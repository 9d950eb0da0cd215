// Shared by the f32 CIN-stack forward (cin_stack_fwd.cu) and backward
// (cin_stack_bwd.cu): the per-layer metadata, the cp.async primitives, the
// 8 x 8 register-cell product, the x0 tile staging, the plan geometry both
// launches recompute, and one layer's product, `layer_product`, which is
// the forward's layer and the backward's remat (the bf16 kernels share
// cin_stack_mma.cuh instead).
//
// A block owns a tile of tile_b samples whose columns n = b_local * D + d
// are padded to nt (a multiple of 8); every f32 row a kernel keeps in
// shared memory (x0, hidden states, comps, dcomp, A) is nt floats long, at
// position n. A product is cut into 8 x 8 register cells (8 rows, 8
// columns: 4 at c and 4 at c + half of the pass's window, so that float4
// reads of shared memory are free of bank conflicts), and its cells into
// passes of at most `threads` cells (`passes_of`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cin {

constexpr int kMaxLayers = 8;
constexpr int kMaxThreads = 256;  // threads of a block, at most
constexpr int kMaxChunk = 32;     // K rows (k = h*F + f) a chunk, at most
constexpr int kMaxDevices = 64;
constexpr int kSmemPerBlock = 232448;  // Hopper: 227 KB a block
constexpr int kSmemPerSm = 233472;     // 228 KB an SM, of which
constexpr int kSmemReserved = 1024;    // each block reserves 1 KB
constexpr int kRegsPerSm = 65536;
constexpr int kMaxThreadsPerSm = 2048;
constexpr int kMaxBlocksPerSm = 32;
constexpr int kFullWarps = 16;  // warps an SM needs to keep the FP32 pipes fed

struct Layers {
  const float* w[kMaxLayers];     // (K_i, mpad_i) k-major
  const float* bias[kMaxLayers];  // (mpad_i,) f32, zero-padded
  int m[kMaxLayers];              // maps of layer i
  int mpad[kMaxLayers];           // m rounded up to a multiple of 8
  int direct[kMaxLayers];         // maps pooled into the output
  int next[kMaxLayers];           // maps handed on as the hidden state
  int col[kMaxLayers];            // first output column of layer i
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return ceil_div(a, b) * b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The passes of a product of `groups` 8-row groups by cx 8-column groups
// on `threads` threads: n passes of at most `groups` row groups by at most
// `cols` column groups (a window of the tile's columns). Whole rows of
// cells where they fit, in passes of near-equal size; else one row group a
// pass, its columns cut into near-equal windows.
struct Passes {
  int n, groups, cols;
};

__host__ __device__ inline Passes passes_of(int groups, int cx, int threads) {
  if (cx > threads) {
    const int windows = ceil_div(cx, threads);
    return {groups * windows, 1, ceil_div(cx, windows)};
  }
  const int n = ceil_div(groups, threads / cx);
  return {n, ceil_div(groups, n), cx};
}

// Blocks an SM holds: registers (at most `max_regs` a thread, the launch
// bounds), threads and shared memory.
inline int blocks_per_sm(int threads, int smem, int max_regs) {
  int b = kRegsPerSm / (threads * max_regs);
  b = imin(b, kMaxThreadsPerSm / threads);
  b = imin(b, kSmemPerSm / (smem + kSmemReserved));
  return imin(b, kMaxBlocksPerSm);
}

// A chunk's barrier and copies, in k steps of a cell: the plans' units of
// a block's work.
constexpr int kChunkSteps = 8;

// The plans' cost of a launch: rounds of blocks over the card's slots,
// each as long as its block's work over the share of the SM it gets (an
// SM whose blocks hold fewer than kFullWarps warps leaves its pipes idle).
inline double launch_cost(long long tiles, int sms, int bps, int threads, double work) {
  const long long slots = (long long)sms * bps;
  const long long rounds = (tiles + slots - 1) / slots;
  const int warps = bps * threads / 32;
  return (double)rounds * bps * threads * work / imin(warps, kFullWarps);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// 4 bytes from global to shared memory (any alignment).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// acc[i][j] += a[kk * ap + i] * b[kk * bp + c(j)] for kk < n <= MaxN, in
// order of kk, c(j) = j for j < 4 and half + j - 4 after: one cell's
// steps, unrolled in full.
template <int MaxN>
__device__ __forceinline__ void cell_product(float (&acc)[8][8], const float* a, int ap,
                                             const float* b, int bp, int half, int n) {
#pragma unroll
  for (int kk = 0; kk < MaxN; ++kk) {
    if (kk >= n) break;
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * ap);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * ap + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + kk * bp);
    const float4 b1 = *reinterpret_cast<const float4*>(b + kk * bp + half);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_cell(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// Rows r_lo .. r_hi - 1 of a cell (+ bias, then ReLU, with `relu`) into
// rows of `pitch` floats from `row0`: columns 0..3 and half..half+3.
__device__ __forceinline__ void store_cell(const float (&acc)[8][8], const float* bv,
                                           bool relu, float* row0, int pitch, int half,
                                           int r_lo, int r_hi) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < r_lo || i >= r_hi) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = relu ? fmaxf(acc[i][j] + bv[i], 0.f) : acc[i][j];
    float* row = row0 + (size_t)(i - r_lo) * pitch;
    *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + half) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// x0[b0 + bl, f, d] -> xs[f, bl * D + d], zero beyond the nb samples of
// the tile and in the padding columns.
__device__ void stage_x0(const float* __restrict__ x0, float* xs, int b0, int nb,
                         int F, int D, int nt) {
  const size_t FD = (size_t)F * D;
  for (int i = threadIdx.x; i < F * nt; i += blockDim.x) {
    const int f = i / nt;
    const int n = i - f * nt;
    const int bl = n / D;
    float v = 0.f;
    if (bl < nb) v = __ldg(x0 + (size_t)(b0 + bl) * FD + (size_t)f * D + (n - bl * D));
    xs[i] = v;
  }
}

// What one layer's product reads besides its hidden state and weights.
struct Tile {
  const float* xs;  // x0 of the tile: F rows of nt
  int F, nt, kc;    // fields, columns, K rows a chunk at most
  float* stage;     // the stage region: two weight stages, two product
                    // buffers; after a pass, rows of its comp
  int stage_floats; // floats of the stage region
  int wpitch;       // floats a weight stage row: 8 * the most map groups a pass
};

// Floats of a layer product's stage region: two weight stages of kc rows
// of wpitch and two product buffers of kc rows of the widest window (cols
// column groups).
__host__ __device__ inline int product_stage_floats(int kc, int wpitch, int cols) {
  return 2 * kc * (wpitch + 8 * cols);
}

// One CIN layer of the tile, as one GEMM in shared memory:
//
//   comp[m, n] = relu(sum_{k=(h,f)} W[m, k] * (hid[h, n] * x0[f, n]) + b[m])
//
// for m < M and every column n < nt, in f32. Each output starts from 0 and
// adds its K = H*F terms in the order of k (h-major, f ascending) by fmaf,
// each term's product rounded to f32 first, then the bias; so the forward
// and the remat, which both call this routine, give the same bits whatever
// their tiles. K is walked in chunks of kc consecutive rows k (across
// hidden rows); a chunk's weight rows (k-major, this pass's maps) arrive
// by cp.async one chunk ahead, and one chunk ahead of the product the
// block forms the chunk's outer product, hid[k / F] * x0[k % F], once for
// all maps of the pass, into one of two buffers. After each pass
// its comps (relu(acc + b)) go through the stage region, `rows` maps at a
// time, and `emit(m0, rows, col0, width, buf)` hands them on: buf row r is
// map m0 + r over tile columns col0 .. col0 + width - 1. emit runs on every
// thread between two barriers. hid may be overwritten by emit only in a
// layer of one pass. The caller synchronises before the call.
template <typename Emit>
__device__ void layer_product(const Tile& t, const float* hid, int H,
                              const float* __restrict__ wt,
                              const float* __restrict__ bias, int M, int MP,
                              Emit&& emit) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, warps = threads / 32;
  const int cx = t.nt / 8;
  const int G = MP / 8;
  const Passes P = passes_of(G, cx, threads);
  const int K = H * t.F;
  const int chunks = ceil_div(K, t.kc);
  const int ppitch = 8 * P.cols;
  float* const ws = t.stage;                   // [2][kc][wpitch]
  float* const ps = ws + 2 * t.kc * t.wpitch;  // [2][kc][ppitch]

  for (int g0 = 0; g0 < G; g0 += P.groups) {
    const int ng = imin(P.groups, G - g0);
    for (int c0 = 0; c0 < cx; c0 += P.cols) {
      const int nc = imin(P.cols, cx - c0);
      const int width = 8 * nc, half = 4 * nc, col0 = 8 * c0;
      // chunk c: rows k = c * kc .. c * kc + rows - 1
      auto copy_weights = [&](int c) {
        const int rows = imin(t.kc, K - c * t.kc);
        const int pieces = 2 * ng;
        const float* src = wt + (size_t)c * t.kc * MP + 8 * g0;
        float* dst = ws + (c & 1) * t.kc * t.wpitch;
        for (int i = tid; i < rows * pieces; i += threads) {
          const int r = i / pieces;
          const int q = i - r * pieces;
          cp_async16(dst + r * t.wpitch + 4 * q, src + (size_t)r * MP + 4 * q);
        }
      };
      // the chunk's outer product, four columns a lane
      auto form_products = [&](int c) {
        const int k0 = c * t.kc;
        const int rows = imin(t.kc, K - k0);
        float* dst = ps + (c & 1) * t.kc * ppitch;
        for (int r = warp; r < rows; r += warps) {
          const int h = (k0 + r) / t.F;
          const int f = k0 + r - h * t.F;
          const float4* hrow = reinterpret_cast<const float4*>(hid + (size_t)h * t.nt + col0);
          const float4* x4 = reinterpret_cast<const float4*>(t.xs + (size_t)f * t.nt + col0);
          float4* d4 = reinterpret_cast<float4*>(dst + r * ppitch);
          for (int s = lane; s < width / 4; s += 32) {
            const float4 hv = hrow[s], xv = x4[s];
            d4[s] = make_float4(__fmul_rn(hv.x, xv.x), __fmul_rn(hv.y, xv.y),
                                __fmul_rn(hv.z, xv.z), __fmul_rn(hv.w, xv.w));
          }
        }
      };

      // cell: map group g0 + cg, column group c0 + cc (columns cc*4 and
      // half + cc*4 of the window); a thread without a cell only copies
      const bool on = tid < ng * nc;
      const int cg = on ? tid / nc : 0;
      const int cc = on ? tid - cg * nc : 0;
      float acc[8][8];
      zero_cell(acc);
      copy_weights(0);
      cp_async_commit();
      form_products(0);
      for (int c = 0; c < chunks; ++c) {
        cp_async_wait_all();  // this thread's copies of chunk c
        __syncthreads();      // everyone's copies and products of chunk c;
                              // chunk c - 1's stage and buffer are free
        if (c + 1 < chunks) copy_weights(c + 1);
        cp_async_commit();
        if (c + 1 < chunks) form_products(c + 1);
        if (on) {
          cell_product<kMaxChunk>(acc, ws + (c & 1) * t.kc * t.wpitch + cg * 8,
                                      t.wpitch, ps + (c & 1) * t.kc * ppitch + cc * 4,
                                      ppitch, half, imin(t.kc, K - c * t.kc));
        }
      }
      __syncthreads();  // every chunk is read: the stage region is free

      float bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) bv[i] = on ? __ldg(bias + 8 * (g0 + cg) + i) : 0.f;
      const int R = t.stage_floats / width;  // comp rows a round
      const int maps = imin(8 * ng, M - 8 * g0);
      for (int r0 = 0; r0 < maps; r0 += R) {
        if (on) {
          const int lo = imax(r0 - cg * 8, 0);
          const int hi = imin(r0 + R - cg * 8, 8);
          if (lo < hi) {
            store_cell(acc, bv, true, t.stage + (size_t)(cg * 8 + lo - r0) * width + cc * 4,
                       width, half, lo, hi);
          }
        }
        __syncthreads();
        emit(8 * g0 + r0, imin(R, maps - r0), col0, width,
             static_cast<const float*>(t.stage));
        __syncthreads();
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to `smem` on the current
// device, once per device and size (a per-device attribute; `smem_set` is
// the caller's per-kernel cache).
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, int smem, int (&smem_set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  return cudaSuccess;
}

// The SMs of the current device.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace cin
