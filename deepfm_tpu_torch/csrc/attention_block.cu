// Field self-attention block of AttentionDeepFM for Hopper (sm_90a): the
// forward. (The backward is csrc/attention_bwd.cu; both are built from the
// pieces in csrc/attention_tile.cuh.)
//
// Replaces deepfm_tpu/ops/pallas/attention_fmajor_kernel.py ::
// make_attention_block_fmajor.forward / _attn_fwd_kernel. Per sample, with
// x (F, d):
//
//   qkv = x . [wq|wk|wv] + [bq|bk|bv]                       (F, 3a), f32
//   s_ij = (q_i . k_j) * hd^-1/2 per head; w = softmax_j(s)  f32
//   ctx_i = sum_j w_ij v_j                                   (F, a), f32
//   out = op(ctx) . wo + bo;  with residual: LayerNorm(out + x) * ls + lb
//
// op casts to the compute type (x's: bf16 or f32); the weights arrive in
// that type, the biases and LayerNorm parameters in f32, q/k/v, scores,
// softmax, context and LayerNorm stay f32, every product accumulates in
// f32, and the output leaves in x's type. This is the TPU kernel's
// rounding, not block_oracle's (which computes everything in bf16).
//
// What bounds it on this card: at bench.py's shape (B=16384, F=27, d=16,
// a=64, H=4) the projections are 3.6 GFLOP and the attention core 3.1
// GFLOP against ~28 MB of x and out in bf16: bytes, if every operation ran
// at the bf16 tensor-core rate, but the core's f32 work at the FP32 rate
// (the mixed bound) takes longer. Design: the backward's forward half.
//  * A block walks tiles of S samples (the plan's), S*F consecutive rows
//    padded to a multiple of 16, the weights resident in shared memory for
//    all of its tiles; a grid of as many blocks as the card holds (or one a
//    tile). There are no sums across samples, so the partition does not
//    reach the bits.
//  * A tile: x's rows in; qkv = x . Wqkv + b as one product over the
//    tile's rows (mma.sync in bf16, FP32-pipe lanes in f32); the core, a
//    warp per (sample, head) and a lane per query, the scores, softmax and
//    context in registers and a per-warp scratch; out = op(ctx) . wo + bo
//    (+ x) as a second product, op(ctx) rounded to bf16 on its way into
//    the fragments, written over x's rows; LayerNorm statistics a thread a
//    row; the normalised rows leave with consecutive threads on
//    consecutive elements.
//  * The plan takes two blocks an SM where they hold as many core warps
//    as one block would (one tile's loads and barriers overlap the other's
//    work), else one; each with the most core warps and then the most
//    samples that fit.
//
// The plan is computed by deepfm_tpu_torch/ops/kernels/attention.py::
// forward_plan; the launch recomputes it here and refuses a mismatch.
//
// AutoInt's interacting layer (Song et al., CIKM 2019, section 4.4) is this
// file's second kernel, interact_fwd_kernel, on the same tile pieces. Per
// sample, with x (F, d) and no biases:
//
//   [q|k|v|res] = x . [wq|wk|wv|wres]                    (F, 4a), f32
//   w = softmax_j((q_i . k_j) * scale) per head (scale 1: the paper's
//   unscaled inner product); ctx_i = sum_j w_ij v_j       (F, a), f32
//   out = ReLU(ctx + res)                                 (F, a), cast once
//
// It differs from the block above in five ways: no output projection and
// no biases, the scale a parameter, a projected residual and a ReLU in
// place of residual + LayerNorm, an output width (a) that may differ from
// the input width (d), and layers stacked by the caller. A tile: x's rows
// in; [q|k|v] as one product over the tile's rows; the core; then res = x .
// wres as a second product over the same rows whose epilogue adds the
// context and takes the ReLU in place over ctx; the rows leave with
// consecutive threads on consecutive elements. The four weights sit in
// shared memory side by side, [wq|wk|wv|wres] (d, 4a) with each head padded
// as q/k/v are, so res's padded columns line up with ctx's. Its plan
// (interacting_forward_plan) is chosen by the same rule as the block's.

#include "attention_tile.cuh"

namespace {

using namespace attention_tile;

constexpr int kMaxSamples = 8;
constexpr int kSmemPerSm = 233472;  // 228 KB an SM
constexpr int kSmemReserved = 1024;  // of which each block reserves 1 KB

Plan make_fwd_plan(int B, int F, int d, int a, int H, int S, int NC,
                   float scale, int residual) {
  Plan p = plan_geometry(B, F, d, a, H, S, NC, scale, residual);
  p.o_wo = p.dp * p.WS;
  p.o_bqkv = p.o_wo + p.ap * p.OS;
  p.o_bo = p.o_bqkv + p.n3;
  p.o_ls = p.o_bo + p.dp;
  p.o_lb = p.o_ls + p.dp;
  p.o_x = p.o_lb + p.dp;  // x's rows, then y over them
  p.o_qkv = p.o_x + p.RP * p.XS;
  p.o_ctx = p.o_qkv + p.RP * p.QS;
  p.o_scr = p.o_ctx + p.RP * p.CS;  // a core warp's F x FS scores each
  p.o_stats = p.o_scr + NC * F * p.FS;  // a row's mean, then its 1/std
  p.total = p.o_stats + 2 * p.RP;
  return p;
}

// For one and for two blocks an SM, the most core warps and then the most
// samples a tile that fit a block's share of the SM's shared memory; of the
// two, the one with more core warps an SM (two blocks on a tie). False
// where even one sample and one warp do not fit one block. `make(S, NC)`
// lays out a tile of S samples with NC core warps.
template <class Make>
bool choose_plan_by(int H, const Make& make, Plan* out, int* blocks_per_sm) {
  bool found = false;
  for (int blocks = 2; blocks >= 1; --blocks) {
    const int share = kSmemPerSm / blocks - kSmemReserved;
    const int limit = share < kSmemMax ? share : kSmemMax;
    bool fits = false;
    Plan p;
    for (int nc = kWarps; nc >= 1 && !fits; --nc) {
      for (int s = kMaxSamples; s >= 1 && !fits; --s) {
        if (nc > s * H) continue;
        p = make(s, nc);
        fits = 4LL * p.total <= limit;
      }
    }
    if (fits && (!found || p.NC * blocks > out->NC * *blocks_per_sm)) {
      *out = p;
      *blocks_per_sm = blocks;
      found = true;
    }
  }
  return found;
}

bool choose_fwd_plan(int B, int F, int d, int a, int H, float scale,
                     int residual, Plan* out, int* blocks_per_sm) {
  return choose_plan_by(
      H, [&](int s, int nc) { return make_fwd_plan(B, F, d, a, H, s, nc, scale, residual); },
      out, blocks_per_sm);
}

// The interacting layer's tile: [wq|wk|wv|wres] (d, 4a padded), x's rows,
// [q|k|v], ctx (then the output over it), a core warp's F x FS scores each.
Plan make_interact_fwd_plan(int B, int F, int d, int a, int H, int S, int NC,
                            float scale) {
  Plan p = plan_geometry(B, F, d, a, H, S, NC, scale, 0);
  p.WS = row_stride(4 * p.ap);
  p.o_x = p.dp * p.WS;
  p.o_qkv = p.o_x + p.RP * p.XS;
  p.o_ctx = p.o_qkv + p.RP * p.QS;
  p.o_scr = p.o_ctx + p.RP * p.CS;
  p.total = p.o_scr + NC * F * p.FS;
  return p;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_kernel(const void* __restrict__ x_g, const void* __restrict__ wqkv_g,
                const float* __restrict__ bqkv_g, const void* __restrict__ wo_g,
                const float* __restrict__ bo_g, const float* __restrict__ ls_g,
                const float* __restrict__ lb_g, void* __restrict__ out_g,
                const Plan p) {
  using io = Io<BF16>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int F = p.F, d = p.d, a = p.a, a3 = 3 * p.a;
  const int XS = p.XS, QS = p.QS, CS = p.CS, WS = p.WS, OS = p.OS;
  float* wq = sm;
  float* wo = sm + p.o_wo;
  float* bqkv = sm + p.o_bqkv;
  float* bo = sm + p.o_bo;
  float* ls = sm + p.o_ls;
  float* lb = sm + p.o_lb;
  float* xs = sm + p.o_x;
  float* qkv = sm + p.o_qkv;
  float* ctx = sm + p.o_ctx;
  float* scr = sm + p.o_scr + warp * F * p.FS;
  float* mean = sm + p.o_stats;
  float* inv = mean + p.RP;

  // zero everything (pads, rows no sample fills), then the weights into
  // their padded places
  for (int i = tid; i < p.total; i += kThreads) sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < d * a3; i += kThreads) {
    const int c = i / a3;
    wq[c * WS + qkv_col(p, i - c * a3)] = io::load(wqkv_g, i);
  }
  for (int j = tid; j < a3; j += kThreads) bqkv[qkv_col(p, j)] = bqkv_g[j];
  for (int i = tid; i < a * d; i += kThreads) {
    const int j = i / d;
    wo[head_row(p, j) * OS + (i - j * d)] = io::load(wo_g, i);
  }
  for (int c = tid; c < d; c += kThreads) {
    bo[c] = bo_g[c];
    ls[c] = ls_g[c];
    lb[c] = lb_g[c];
  }

  const int tiles = (p.B + p.S - 1) / p.S;
  const int mt = p.RP / 16;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * p.S;
    const int sv = min(p.S, p.B - b0);
    const int R = sv * F;  // valid rows; rows R..RP-1 are never stored
    const size_t e0 = (size_t)b0 * F * d;
    // (the previous tile's last barrier: its rows are stored)
    load_rows(p.RP * d, R * d, d, XS, xs, [&](size_t i) { return io::load(x_g, e0 + i); });
    __syncthreads();
    // ---- qkv = x . Wqkv + bqkv
    product<BF16>(
        mt, p.n3 / 16, p.dp, [&](int m, int k) { return xs[m * XS + k]; },
        [&](int k, int n) { return wq[k * WS + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) { qkv[r * QS + c] = v + bqkv[c]; }, warp, g, t);
    __syncthreads();
    // ---- the core: ctx
    core<false>(p, qkv, ctx, scr, sv, warp, lane);
    __syncthreads();
    // ---- y = op(ctx) . op(wo) + bo (+ x), over x's rows
    product<BF16>(
        mt, p.dp / 16, p.ap, [&](int m, int k) { return ctx[m * CS + k]; },
        [&](int k, int n) { return wo[k * OS + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) {
          v += bo[c];
          if (p.residual) v += xs[r * XS + c];
          xs[r * XS + c] = v;
        },
        warp, g, t);
    __syncthreads();
    // ---- LayerNorm: a thread a row's statistics, then a thread an element
    if (p.residual) {
      for (int r = tid; r < R; r += kThreads) {
        const float* yr = xs + r * XS;
        float m = 0.f;
        for (int c = 0; c < d; ++c) m += yr[c];
        m /= d;
        float var = 0.f;
        for (int c = 0; c < d; ++c) var += (yr[c] - m) * (yr[c] - m);
        var /= d;
        mean[r] = m;
        inv[r] = rsqrtf(var + kLnEps);
      }
      __syncthreads();
    }
    for (int i = tid; i < R * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      float v = xs[r * XS + c];
      if (p.residual) v = (v - mean[r]) * inv[r] * ls[c] + lb[c];
      io::store(out_g, e0 + i, v);
    }
    __syncthreads();
  }
}

// Raises (never lowers) the kernel's dynamic shared-memory limit on the
// current device to `smem`; the launch and the attributes share it.
template <bool BF16>
cudaError_t ensure_fwd_smem(int smem) {
  static int smem_set[kMaxDevices] = {};
  return ensure_smem(attn_fwd_kernel<BF16>, smem, smem_set);
}

template <bool BF16>
cudaError_t fwd(const void* x, const void* wqkv, const float* bqkv,
                const void* wo, const float* bo, const float* ls,
                const float* lb, void* out, const Plan& p, int grid,
                cudaStream_t stream) {
  const int smem = 4 * p.total;
  const cudaError_t err = ensure_fwd_smem<BF16>(smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<BF16><<<grid, kThreads, smem, stream>>>(
      x, wqkv, bqkv, wo, bo, ls, lb, out, p);
  return cudaGetLastError();
}

// The interacting layer: x (B, F, d) -> ReLU(ctx + x . wres) (B, F, a), in
// x's type; w = [wq|wk|wv|wres] (d, 4a) in x's type.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
interact_fwd_kernel(const void* __restrict__ x_g, const void* __restrict__ w_g,
                    void* __restrict__ out_g, const Plan p) {
  using io = Io<BF16>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int F = p.F, d = p.d, a = p.a, a4 = 4 * p.a;
  const int XS = p.XS, QS = p.QS, CS = p.CS, WS = p.WS;
  float* w = sm;
  float* xs = sm + p.o_x;
  float* qkv = sm + p.o_qkv;
  float* ctx = sm + p.o_ctx;
  float* scr = sm + p.o_scr + warp * F * p.FS;

  for (int i = tid; i < p.total; i += kThreads) sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < d * a4; i += kThreads) {
    const int c = i / a4;
    w[c * WS + qkv_col(p, i - c * a4)] = io::load(w_g, i);
  }

  const int tiles = (p.B + p.S - 1) / p.S;
  const int mt = p.RP / 16;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * p.S;
    const int sv = min(p.S, p.B - b0);
    const int R = sv * F;
    const size_t e0 = (size_t)b0 * F * d;
    load_rows(p.RP * d, R * d, d, XS, xs, [&](size_t i) { return io::load(x_g, e0 + i); });
    __syncthreads();
    // ---- [q|k|v] = x . [wq|wk|wv]
    product<BF16>(
        mt, p.n3 / 16, p.dp, [&](int m, int k) { return xs[m * XS + k]; },
        [&](int k, int n) { return w[k * WS + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) { qkv[r * QS + c] = v; }, warp, g, t);
    __syncthreads();
    core<false>(p, qkv, ctx, scr, sv, warp, lane);
    __syncthreads();
    // ---- ReLU(ctx + x . wres) over ctx (each element read and written by
    // the lane that owns it)
    product<BF16>(
        mt, p.ap / 16, p.dp, [&](int m, int k) { return xs[m * XS + k]; },
        [&](int k, int n) { return w[k * WS + p.n3 + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) {
          const float s = ctx[r * CS + c] + v;
          ctx[r * CS + c] = s < 0.f ? 0.f : s;
        },
        warp, g, t);
    __syncthreads();
    const size_t o0 = (size_t)b0 * F * a;
    for (int i = tid; i < R * a; i += kThreads) {
      const int r = i / a;
      io::store(out_g, o0 + i, ctx[r * CS + head_row(p, i - r * a)]);
    }
    __syncthreads();
  }
}

template <bool BF16>
cudaError_t ensure_interact_smem(int smem) {
  static int smem_set[kMaxDevices] = {};
  return ensure_smem(interact_fwd_kernel<BF16>, smem, smem_set);
}

template <bool BF16>
cudaError_t interact_fwd(const void* x, const void* w, void* out, const Plan& p,
                         int grid, cudaStream_t stream) {
  const int smem = 4 * p.total;
  const cudaError_t err = ensure_interact_smem<BF16>(smem);
  if (err != cudaSuccess) return err;
  interact_fwd_kernel<BF16><<<grid, kThreads, smem, stream>>>(x, w, out, p);
  return cudaGetLastError();
}

// registers, local bytes and static shared memory of `kernel`, and the
// blocks an SM holds at `smem` bytes of dynamic shared memory
cudaError_t kernel_attributes(const void* kernel, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (bound with ctypes); every pointer is a device
// pointer on the current device. x and out (B, F, d), wqkv (d, 3a) and wo
// (a, d) in the compute type (bf16 selects bf16); bqkv (3a,), bo, ls, lb
// (d,) f32. `samples`, `core_warps`, `blocks_per_sm`, `grid` and `smem`
// are the wrapper's plan (forward_plan; grid: a block a tile, at most
// blocks_per_sm an SM), refused (cudaErrorInvalidValue) unless they are
// this file's. Returns a cudaError_t, 0 on a successful launch; the kernel
// runs on `stream` and nothing here synchronises.
extern "C" int attention_block_fwd(const void* x, const void* wqkv,
                                   const float* bqkv, const void* wo,
                                   const float* bo, const float* ls,
                                   const float* lb, void* out, int B, int F,
                                   int d, int a, int H, float scale,
                                   int residual, int bf16, int samples,
                                   int core_warps, int blocks_per_sm, int grid,
                                   int smem, void* stream) {
  if (B < 1 || F < 1 || d < 1 || H < 1 || a < H || a % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  int blocks = 0;
  if (!choose_fwd_plan(B, F, d, a, H, scale, residual, &p, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + p.S - 1) / p.S;
  const int want_grid = tiles < blocks * sms ? tiles : blocks * sms;
  if (p.S != samples || p.NC != core_warps || blocks != blocks_per_sm ||
      4 * p.total != smem || grid != want_grid) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? fwd<true>(x, wqkv, bqkv, wo, bo, ls, lb, out, p, grid, st)
             : fwd<false>(x, wqkv, bqkv, wo, bo, ls, lb, out, p, grid, st);
  return (int)err;
}

// The forward kernel as compiled (bf16 selects its bf16 instance): out[0..3]
// = registers a thread, local memory a thread (bytes: spills and stack),
// static shared memory (bytes), and the blocks an SM holds at `smem` bytes
// of dynamic shared memory. Returns a cudaError_t.
extern "C" int attention_block_fwd_attributes(int bf16, int smem, int* out) {
  const void* kernel = bf16 ? reinterpret_cast<const void*>(attn_fwd_kernel<true>)
                            : reinterpret_cast<const void*>(attn_fwd_kernel<false>);
  const cudaError_t err = bf16 ? ensure_fwd_smem<true>(smem) : ensure_fwd_smem<false>(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_attributes(kernel, smem, out);
}

// Plain C entry point of the interacting layer; every pointer is a device
// pointer on the current device. x (B, F, d), w = [wq|wk|wv|wres] (d, 4a)
// and out (B, F, a) in the compute type (bf16 selects bf16). `samples`,
// `core_warps`, `blocks_per_sm`, `grid` and `smem` are the wrapper's plan
// (interacting_forward_plan), refused (cudaErrorInvalidValue) unless they
// are this file's. Returns a cudaError_t, 0 on a successful launch; the
// kernel runs on `stream` and nothing here synchronises.
extern "C" int interacting_fwd(const void* x, const void* w, void* out, int B,
                               int F, int d, int a, int H, float scale,
                               int bf16, int samples, int core_warps,
                               int blocks_per_sm, int grid, int smem,
                               void* stream) {
  if (B < 1 || F < 1 || d < 1 || H < 1 || a < H || a % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  int blocks = 0;
  if (!choose_plan_by(
          H, [&](int s, int nc) { return make_interact_fwd_plan(B, F, d, a, H, s, nc, scale); },
          &p, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + p.S - 1) / p.S;
  const int want_grid = tiles < blocks * sms ? tiles : blocks * sms;
  if (p.S != samples || p.NC != core_warps || blocks != blocks_per_sm ||
      4 * p.total != smem || grid != want_grid) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? interact_fwd<true>(x, w, out, p, grid, st)
             : interact_fwd<false>(x, w, out, p, grid, st);
  return (int)err;
}

// The interacting layer's kernel as compiled, as
// attention_block_fwd_attributes gives the block's.
extern "C" int interacting_fwd_attributes(int bf16, int smem, int* out) {
  const void* kernel = bf16 ? reinterpret_cast<const void*>(interact_fwd_kernel<true>)
                            : reinterpret_cast<const void*>(interact_fwd_kernel<false>);
  const cudaError_t err =
      bf16 ? ensure_interact_smem<true>(smem) : ensure_interact_smem<false>(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_attributes(kernel, smem, out);
}

// Message for an error code returned by the entry points.
extern "C" const char* attention_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
