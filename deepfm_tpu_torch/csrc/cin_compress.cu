// One CIN layer's compression for Hopper (sm_90a).
//
// Replaces deepfm_tpu/ops/pallas/cin_kernel.py :: cin_compress_pallas /
// _cin_kernel. For hidden (B, H, D), x0 (B, F, D), a weight of M maps over
// K = H*F channels and a bias,
//
//   out[b,m,d] = sum_{h,f} W[m, h*F+f] * hidden[b,h,d] * x0[b,f,d] + bias[m]
//
// pre-ReLU, in f32 throughout (the wrapper casts the inputs to f32 and the
// output back to hidden's dtype).
//
// What bounds it on this card: operations. At the xDeepFM paper's Criteo
// shape (B=4096, F=27, D=10, H=M=200) a layer is 88.7 GFLOP against 74 MB
// of f32 input and output, far above the H100's ops:byte ridge. It runs on
// the FP32 FMA pipes (67 TFLOP/s on the data sheet), not the tensor cores:
// TF32 would change what the kernel rounds.
//
// Design. One GEMM with M rows, N = B*D columns (n = b*D + d) and K = H*F:
//
//   out[m, n] = sum_k Wt[k, m] * (hidden[b, k / F, d] * x0[b, k % F, d])
//
// The plan (ops/kernels/cin.py::compress_plan, recomputed and checked by
// the launch below) cuts the maps into tiles of up to 256, each a whole
// number of 8-map groups: M <= 256 is one tile with at most 7 maps on zero
// weights (the k-major weight's padding to a multiple of 8). A block owns
// one map tile by 8*cx columns, so the outer product of its columns is
// formed once for all its maps. Each thread owns an 8 (maps) x 8 (columns)
// register tile (its "cell"): map group g, columns c*4.. and 4*cx + c*4..
// of the tile, so a k step is four float4 reads of shared memory (the
// weights' broadcast within a warp) for 64 FFMA; cx (8 to 10 column
// groups) is chosen from the shape so that the last wave of blocks is
// nearly full.
//
// K is walked in chunks, one barrier a chunk: a chunk is one hidden row h
// and a block of up to kBK fields (F is cut into ceil(F / kBK) blocks of
// near-equal size), i.e. the contiguous weight rows k = h*F + f0 .. h*F +
// f0 + rows - 1, in the order of k. Every operand reaches shared memory by
// cp.async one chunk ahead, so no thread waits on device memory:
//  * the chunk's weight rows (k-major, contiguous) into one of two stages;
//  * x0: for F <= 2*kBK all F rows of the block's columns once, at the
//    start (resident); for larger F the chunk's field block into one of two
//    stages;
//  * the chunk's hidden row into one of two stages.
// One chunk ahead of the product, the block forms the chunk's outer
// product, hidden row h times x0 rows f0.., into one of two buffers, each
// element once, rounded to f32 as the plain version rounds its outer
// product. The (B, K, D) outer product never exists in device memory, and
// shared memory depends on F alone and stays under half an SM for every F,
// so any shape fits: none is refused for shared memory. The shared-memory
// pitches are constants (the widest tile), so every read of the inner loop
// has an immediate offset. Each output is summed over K in one fixed order
// from 0, with no atomics and no split of K: a repeat launch gives the
// same bits. At the end the tile's outputs go through shared memory and
// leave sample by sample, each sample's (map, d) run contiguous. Ragged B,
// D and M are masked here.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads of a block, at most
constexpr int kBlocksPerSm = 2;  // launch bounds: at most 128 registers
constexpr int kMaxGroups = 32;   // 8-map groups of a map tile, at most
constexpr int kMinCx = 8;        // column groups of a tile (8 columns each)
constexpr int kMaxCx = 10;
constexpr int kBK = 32;          // K rows (fields of one h) a chunk, at most
constexpr int kWP = kMaxGroups * 8;  // weight stage row pitch (floats)
constexpr int kBP = kMaxCx * 8;      // x0, hidden and product row pitch
constexpr int kBH = kBP / 2;         // where a cell's second 4 columns start
constexpr int kMinThreads = 128;  // threads of a block, at least (>= kBP)
constexpr int kSmemPerSm = 233472;  // 228 KB an SM,
constexpr int kSmemReserved = 1024;  // of which each block reserves 1 KB

// Field blocks of a chunk: ceil(F / kBK), each of ceil(F / blocks) fields
// but the last.
int field_blocks(int F) { return (F + kBK - 1) / kBK; }
int field_chunk(int F) {
  const int blocks = field_blocks(F);
  return (F + blocks - 1) / blocks;
}

// x0 resident (all F rows staged once) rather than staged by chunk.
bool x0_resident(int F) { return F <= 2 * kBK; }

// Dynamic shared memory of a block: two weight stages, two product
// buffers, two hidden rows and x0 (resident, or two stages).
int smem_bytes(int F) {
  return 4 * (2 * kBK * kWP + 2 * kBK * kBP + 2 * kBP + (x0_resident(F) ? F : 2 * kBK) * kBP);
}

// q = n / d for 0 <= n < 2^31 by a multiply and a shift (the rule of
// CUTLASS's FastDivmod): mul = ceil(2^p / d), p = 31 + ceil(log2 d).
struct FastDiv {
  int d;
  unsigned mul;
  int shr;
};

__host__ __device__ FastDiv make_fastdiv(int d) {
  FastDiv f{d, 0u, 0};
  if (d != 1) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    const int p = 31 + l;
    f.mul = static_cast<unsigned>(((1ULL << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shr);
}

struct Params {
  int N, H, F, D, M, MP;
  int tile_maps;  // 8 * groups of a map tile
  int cx;         // column groups: 8 * cx columns a tile
  int fchunk;     // fields of a chunk: field_chunk(F)
  bool x0_resident;
  FastDiv fblocks;  // field_blocks(F)
  FastDiv fdivD;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
cin_compress_kernel(const float* __restrict__ hid, const float* __restrict__ x0,
                    const float* __restrict__ wt, const float* __restrict__ bias,
                    float* __restrict__ out, const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* const ws = smem;                    // [2][kBK][kWP]
  float* const bs = ws + 2 * kBK * kWP;      // [2][kBK][kBP]
  float* const hs = bs + 2 * kBK * kBP;      // [2][kBP]
  float* const xs = hs + 2 * kBP;            // [F][kBP] or [2][kBK][kBP]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * 8 * p.cx;
  const int m0 = blockIdx.y * p.tile_maps;
  const int chunks = p.H * p.fblocks.d;

  // Weight copies: 16-byte piece wq of rows wr, wr + wstep, ... of a chunk.
  const int wpieces = p.tile_maps / 4;
  const int wstep = blockDim.x / wpieces;
  const int wq = tid % wpieces;
  const int wr = tid / wpieces;
  const bool w_on = wr < wstep && m0 + wq * 4 < p.MP;

  // x0 and hidden copies: position tid % kBP of rows tid / kBP + i * xstep.
  // Position s < kBH holds tile column s, position kBH + s tile column
  // 4*cx + s.
  const int xstep = blockDim.x / kBP;
  const int xp = tid % kBP;
  const int xr = tid / kBP;
  const int tcol = xp < kBH ? xp : 4 * p.cx + xp - kBH;
  const bool x_on = xr < xstep && xp % kBH < 4 * p.cx && n0 + tcol < p.N;
  const int xb = x_on ? (n0 + tcol) / p.D : 0;
  const int xd = x_on ? n0 + tcol - xb * p.D : 0;
  const float* const hcol = hid + (size_t)xb * p.H * p.D + xd;  // + h * D

  // Chunk c: hidden row h, fields f0 .. f0 + rows - 1.
  auto chunk_h = [&](int c) { return fdiv(c, p.fblocks); };
  auto chunk_f0 = [&](int c, int h) { return (c - h * p.fblocks.d) * p.fchunk; };
  auto chunk_rows = [&](int f0) { return min(p.fchunk, p.F - f0); };

  auto copy_weights = [&](int c) {
    if (!w_on) return;
    const int h = chunk_h(c);
    const int f0 = chunk_f0(c, h);
    const int rows = chunk_rows(f0);
    const float* const src = wt + ((size_t)h * p.F + f0 + wr) * p.MP + m0 + wq * 4;
    float* const dst = ws + (c & 1) * (kBK * kWP) + wr * kWP + wq * 4;
    for (int r = 0; wr + r < rows; r += wstep) cp_async16(dst + r * kWP, src + (size_t)r * p.MP);
  };
  auto copy_rows = [&](int c) {  // the hidden row; x0 rows when by chunk
    if (!x_on) return;
    const int h = chunk_h(c);
    if (xr == 0) cp_async4(hs + (c & 1) * kBP + xp, hcol + (size_t)h * p.D);
    if (!p.x0_resident) {
      const int f0 = chunk_f0(c, h);
      const int rows = chunk_rows(f0);
      const float* const xcol = x0 + (size_t)xb * p.F * p.D + xd;
      float* const dst = xs + (c & 1) * (kBK * kBP) + xp;
      for (int r = xr; r < rows; r += xstep) {
        cp_async4(dst + r * kBP, xcol + (size_t)(f0 + r) * p.D);
      }
    }
  };
  // The chunk's outer product: row r is hidden row h times x0 row f0 + r;
  // warp w forms rows w, w + warps, ..., lane l positions l, l + 32, ...
  auto form_products = [&](int c) {
    const int lane = tid % 32;
    const int h = chunk_h(c);
    const int f0 = chunk_f0(c, h);
    const int rows = chunk_rows(f0);
    const float* const hrow = hs + (c & 1) * kBP + lane;
    const float* const xrow =
        (p.x0_resident ? xs + f0 * kBP : xs + (c & 1) * (kBK * kBP)) + lane;
    float* const dst = bs + (c & 1) * (kBK * kBP) + lane;
    float hv[(kBP + 31) / 32];
#pragma unroll
    for (int i = 0; i < kBP; i += 32) hv[i / 32] = i + 32 <= kBP || lane < kBP - i ? hrow[i] : 0.f;
    for (int r = tid / 32; r < rows; r += blockDim.x / 32) {
#pragma unroll
      for (int i = 0; i < kBP; i += 32) {
        if (i + 32 <= kBP || lane < kBP - i) {
          dst[r * kBP + i] = __fmul_rn(hv[i / 32], xrow[r * kBP + i]);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // Group of chunk c: its weights and the rows of chunk c + 1; the first
  // group also holds chunk 0's rows (and x0, when resident).
  if (p.x0_resident && x_on) {
    const float* const xcol = x0 + (size_t)xb * p.F * p.D + xd;
    for (int f = xr; f < p.F; f += xstep) cp_async4(xs + f * kBP + xp, xcol + (size_t)f * p.D);
  }
  copy_rows(0);
  copy_weights(0);
  if (chunks > 1) copy_rows(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  form_products(0);

  // Compute cell: map group cg, column group cc; a thread with no cell
  // runs the k loop on cell 0 and stores nothing.
  const bool c_on = tid < (p.tile_maps / 8) * p.cx;
  const int cg = c_on ? tid / p.cx : 0;
  const int cc = c_on ? tid - cg * p.cx : 0;
  const float* const a_cell = ws + cg * 8;
  const float* const b_cell = bs + cc * 4;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();  // this thread's copies of chunk c's group
    __syncthreads();  // everyone's copies of chunk c's group and products of
                      // chunk c; chunk c - 1's buffers are free
    if (c + 1 < chunks) {
      copy_weights(c + 1);
      if (c + 2 < chunks) copy_rows(c + 2);
    }
    cp_async_commit();
    if (c + 1 < chunks) form_products(c + 1);
    const int rows = chunk_rows(chunk_f0(c, chunk_h(c)));
    const float* a = a_cell + (c & 1) * (kBK * kWP);
    const float* b = b_cell + (c & 1) * (kBK * kBP);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk >= rows) break;
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kWP);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kWP + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kBP);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kBP + kBH);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every cell is summed: the stages and buffers are free

  // The tile's outputs (+ bias) go through shared memory, [map][position],
  // and leave in the order of out: sample by sample, each sample's run of
  // (map, d) contiguous.
  float* const ot = smem;  // [tile_maps][kBP], over the weight and product stages
  if (c_on) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + cg * 8 + i;
      const float bm = m < p.M ? __ldg(bias + m) : 0.f;
      float* const row = ot + (cg * 8 + i) * kBP + cc * 4;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[i][0] + bm, acc[i][1] + bm, acc[i][2] + bm, acc[i][3] + bm);
      *reinterpret_cast<float4*>(row + kBH) =
          make_float4(acc[i][4] + bm, acc[i][5] + bm, acc[i][6] + bm, acc[i][7] + bm);
    }
  }
  __syncthreads();
  const int tile_cols = 8 * p.cx;
  const int last = min(n0 + tile_cols, p.N) - 1;  // the tile's last column
  const int b0 = n0 / p.D;
  const int maps = min(p.tile_maps, p.M - m0);
  const int run = maps * p.D;  // a sample's outputs in this map tile
  const FastDiv by_run = make_fastdiv(run);
  const int total = (last / p.D - b0 + 1) * run;
  for (int e = tid; e < total; e += blockDim.x) {
    const int bl = fdiv(e, by_run);
    const int r = e - bl * run;
    const int ml = fdiv(r, p.fdivD);
    const int d = r - ml * p.D;
    const int t = (b0 + bl) * p.D + d - n0;  // tile column
    if (t >= 0 && n0 + t <= last) {
      out[((size_t)(b0 + bl) * p.M + m0 + ml) * p.D + d] =
          ot[ml * kBP + (t < 4 * p.cx ? t : kBH + t - 4 * p.cx)];
    }
  }
}

// The launch plan; ops/kernels/cin.py::compress_plan computes the same.
struct Plan {
  int tile_maps, map_tiles, cx, threads;
  long long col_tiles;
};

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

int blocks_per_sm(int threads, int smem) {
  const int by_regs = 65536 / (threads * 128);
  const int by_smem = kSmemPerSm / (smem + kSmemReserved);
  return by_regs < by_smem ? by_regs : by_smem;
}

// Every cell, and at least kMinThreads.
int plan_threads(int groups, int cx) {
  const int need = groups * cx > kMinThreads ? groups * cx : kMinThreads;
  return (need + 31) / 32 * 32;
}

Plan make_plan(long long N, int MP, int F, int sms) {
  Plan pl{};
  const int groups = MP / 8;
  pl.map_tiles = ceil_div(groups, kMaxGroups);
  const int tile_groups = ceil_div(groups, pl.map_tiles);
  pl.tile_maps = 8 * tile_groups;
  long long best = -1;
  for (int cx = kMaxCx; cx >= kMinCx; --cx) {
    if (tile_groups * cx > kThreads) continue;
    const int threads = plan_threads(tile_groups, cx);
    const long long tiles = (N + 8 * cx - 1) / (8 * cx);
    const long long slots = (long long)sms * blocks_per_sm(threads, smem_bytes(F));
    const long long rounds = (tiles * pl.map_tiles + slots - 1) / slots;
    const long long cost = rounds * (threads / 32);
    if (best < 0 || cost < best) {
      best = cost;
      pl.cx = cx;
      pl.threads = threads;
      pl.col_tiles = tiles;
    }
  }
  return pl;
}

}  // namespace

// Plain C entry point (bound with ctypes). hid (B, H, D), x0 (B, F, D) and
// out (B, M, D) are f32, contiguous; wt is the weight k-major, (H*F, MP) f32
// with MP a multiple of 8 and maps M..MP-1 zero; bias (M,) f32. tile_maps,
// cx, threads and smem are the caller's plan (compress_plan), recomputed
// here for this device: a mismatch returns cudaErrorInvalidValue. Returns a
// cudaError_t: 0 on a successful launch. The kernel runs on `stream` and
// nothing here synchronises.
extern "C" int cin_compress(const void* hid, const void* x0, const void* wt,
                            const void* bias, void* out, int B, int H, int F,
                            int D, int M, int MP, int tile_maps, int cx,
                            int threads, int smem, void* stream) {
  if (B < 0 || H < 1 || F < 1 || D < 1 || M < 1 || MP < M || MP % 8 != 0 ||
      MP - M > 7) {
    return (int)cudaErrorInvalidValue;
  }
  const long long N = (long long)B * D;
  if (N > INT_MAX - kThreads || (long long)H * F > INT_MAX - kBK ||
      (long long)H * field_blocks(F) > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Plan pl = make_plan(N, MP, F, sms);
  if (tile_maps != pl.tile_maps || cx != pl.cx || threads != pl.threads ||
      smem != smem_bytes(F) || pl.map_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(cin_compress_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p{(int)N, H, F, D, M, MP, pl.tile_maps, pl.cx, field_chunk(F),
           x0_resident(F), make_fastdiv(field_blocks(F)), make_fastdiv(D)};
  const dim3 grid((unsigned)pl.col_tiles, (unsigned)pl.map_tiles);
  cin_compress_kernel<<<grid, pl.threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hid), static_cast<const float*>(x0),
      static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

// The kernel as compiled: out[0..3] = registers a thread, local memory a
// thread (bytes: spills and stack), static shared memory (bytes), and the
// blocks an SM holds at `threads` threads and `smem` bytes of dynamic
// shared memory. Returns a cudaError_t.
extern "C" int cin_compress_attributes(int threads, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, cin_compress_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(cin_compress_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cin_compress_kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  return (int)cudaSuccess;
}

// Message for an error code returned by cin_compress.
extern "C" const char* cin_compress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
