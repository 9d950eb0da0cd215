// Backward of AttentionDeepFM's field self-attention block for Hopper
// (sm_90a).
//
// Replaces deepfm_tpu/ops/pallas/attention_fmajor_kernel.py ::
// make_attention_block_fmajor.backward / _attn_bwd_kernel. Per sample, with
// x (F, d) in the compute type (bf16 or f32) and g (F, d) f32, it recomputes
// the forward (as the TPU kernel does: the softmax weights of a batch would
// be B*H*F*F*4 bytes in device memory):
//
//   qkv = x . [wq|wk|wv] + [bq|bk|bv]                   (F, 3a), f32
//   w = softmax_j((q_i . k_j) * hd^-1/2) per head, ctx_i = sum_j w_ij v_j
//   y = op(ctx) . wo + bo (+ x); with residual yn = LayerNorm(y)
//
// then the LayerNorm/residual adjoint dout (and dls, dlb), dbo, dWo =
// op(ctx)^T op(dout), dctx = op(dout) . op(wo)^T, per query the softmax
// adjoint ds = w * (dw - sum_j dw * w) * scale with dw = dctx . v^T,
// dq = ds . k, dk = ds^T . q, dv = w^T . dctx; dall = [dq|dk|dv];
// dWqkv = op(dall)^T x, dbqkv = sum dall, dx = dout + op(dall) . Wqkv^T.
// op casts to the compute type; q/k/v, scores, softmax, ctx, dctx and dall
// are f32 and every product accumulates in f32: the TPU kernel's rounding.
//
// What bounds it on this card: operations. At bench.py's shape (B=16384,
// F=27, d=16, a=64, H=4) the six projection products are 10.9 GFLOP and the
// attention core's six products 9.2 GFLOP against ~57 MB of x, g and dx.
// Design:
//  * A block walks tiles of S samples (the plan's), S*F consecutive rows,
//    padded to a multiple of 16 rows. The projections are row-wise, so
//    each is one product over the tile's rows, cut into 16x16 output tiles
//    that the 8 warps take in turn. In bf16 every projection operand is
//    bf16 (x, the weights, op(ctx), op(dout), op(dall)), so a tile is
//    mma.sync m16n8k16 bf16 -> f32 on the tensor cores: the products have
//    K of 16 to 192 and N of 16 to 192 over ~112 rows, too small for a
//    warpgroup's 64-row wgmma to pay for its shared-memory descriptors,
//    and the operands are cast from f32 shared memory on the way into the
//    fragments. In f32 the same tiles run on the FP32 pipes (no TF32), each
//    lane computing the 8 outputs its mma fragment would hold.
//  * The attention core runs on the FP32 pipes, one warp per (sample, head)
//    and one lane per field (lanes wrap for F > 32). Lane = query: scores,
//    softmax and context (forward), then scores, dw, the row sum
//    sum_j dw_ij w_ij (taken as the plain version takes it) and ds, kept in
//    a per-warp scratch of two F x F matrices with an odd row stride. Lane
//    = key: dv_j and dk_j from the scratch's other axis. The other operand
//    is a row of q, k, v or dctx, read by every lane at once (a broadcast,
//    no bank conflicts), 16 floats at a time in float4s; the lane's own
//    row sits in registers. Heads are padded to a multiple of 4 floats
//    (zeros), so chunks stay 16-byte aligned and pads add exact zeros.
//    dv goes into v's place, dq into dctx's, dk into k's and dq last into
//    q's, each once nothing reads the old value, so [dq|dk|dv] overwrites
//    q/k/v in place.
//  * Shared memory, not threads, limits the samples in flight: the tile's
//    qkv (f32) alone is 20.7 KB a sample. One block (256 threads) fills an
//    SM; latency is hidden by independent accumulators (16 per lane in
//    the core's sums, 8 per lane in a product tile).
//    On an H100 the core is bound by shared-memory wavefronts, not FMAs: a
//    broadcast float4 load costs one wavefront per quarter-warp, so each
//    FMA of a lane pays one wavefront; reading each key row once for
//    several (sample, head) pairs a warp is the next step.
//  * Parameter gradients (dWqkv, dbqkv, dWo, dbo, dls, dlb) accumulate in
//    shared memory across the block's tiles in tile order, each element
//    owned by one warp's tile or one thread; each block writes one partial
//    and attn_reduce_kernel adds the partials in block order. The grid is
//    a fixed function of the shape. No float atomics: two launches give
//    the same bits.
//
// The plan (S, the number of core warps, the shared-memory layout) is
// computed by deepfm_tpu_torch/ops/kernels/attention.py::backward_plan;
// the launch recomputes it here and refuses a mismatch.
//
// AutoInt's interacting layer (csrc/attention_block.cu has its forward) is
// this file's second kernel, interact_bwd_kernel. Per sample, with x (F, d)
// in the compute type, w4 = [wq|wk|wv|wres] (d, 4a) and the output's
// cotangent g (F, a) in the compute type, it recomputes the forward and
// then
//
//   dres = g * (ctx + res > 0)   (the ReLU's mask; dctx = dres too)
//   ds = w * (dw - sum_j dw * w) * scale with dw = dctx . v^T, dq = ds . k,
//   dk = ds^T . q, dv = w^T . dctx;  dall4 = [dq|dk|dv|dres]     (F, 4a)
//   dW4 = x^T op(dall4), dx = op(dall4) . w4^T
//
// op casts to the compute type; q/k/v/res, scores, softmax, ctx and dall4
// are f32 and every product accumulates in f32.
// Design, where it departs from the block's:
//  * Shared memory holds w4 and a tile's x, [q|k|v|res] (then dall4 over
//    it), ctx (dctx, then dx over it) and the core warps' scratch, but no
//    gradient accumulator: at d = a = 64 the block's layout (weights, dW
//    accumulators and a 64-wide tile together) asks 243,968 B, over the
//    limit. Each block's dW4 partial (d rounded up to 16 rows, 4a padded
//    columns, f32) lives in device memory instead, where the block's first
//    tile writes it and each later tile reads and adds to it: every element
//    is owned by one lane of one warp (product's fixed order of tiles), so
//    the sums run in tile order with no barrier and no atomics. The 64 KB
//    partial of a block at d = 64 stays in L2 (132 blocks: 8.6 MB).
//  * dW4 and dx are the same two products over op(dall4) that the block
//    takes over op([dq|dk|dv]), 4a wide; the block's LayerNorm, bias and
//    output projection stages have no counterpart.
//  * interact_reduce_kernel adds the partials in block order into the real
//    (d, 4a) layout; the grid is the block's fixed 132. Two launches give
//    the same bits.
// Its plan (interacting_backward_plan) takes the most core warps, then the
// most samples, that fit one block, as the block's does.

#include "attention_tile.cuh"

namespace {

using namespace attention_tile;

constexpr int kMaxSamples = 8;
constexpr int kBlocks = 132;  // one block an SM of an H100 SXM

Plan make_plan(int B, int F, int d, int a, int H, int S, int NC, float scale,
               int residual) {
  Plan p = plan_geometry(B, F, d, a, H, S, NC, scale, residual);
  p.o_wo = p.dp * p.WS;
  p.o_bqkv = p.o_wo + p.ap * p.OS;
  p.o_bo = p.o_bqkv + p.n3;
  p.o_ls = p.o_bo + p.dp;
  p.o_dw = p.o_ls + p.dp;
  p.o_dwo = p.o_dw + p.dp * p.WS;
  p.o_db = p.o_dwo + p.ap * p.OS;  // dbqkv (n3) | dbo | dls | dlb (dp each)
  p.o_x = p.o_db + p.n3 + 3 * p.dp;
  p.o_y = p.o_x + p.RP * p.XS;
  p.o_dout = p.o_y + p.RP * p.XS;
  p.o_qkv = p.o_dout + p.RP * p.XS;
  p.o_ctx = p.o_qkv + p.RP * p.QS;
  p.o_scr = p.o_ctx + p.RP * p.CS;
  // the core warps' scratch; between the two cores it holds the tile's g
  // and the column sums' partials (3 floats for at most max(kThreads, d)
  // (group, column) pairs)
  const int scratch = NC * 2 * F * p.FS;
  const int between = p.RP * p.XS + 3 * (kThreads > d ? kThreads : d);
  p.total = p.o_scr + (scratch > between ? scratch : between);
  return p;
}

// The most core warps, then the most samples a tile, that fit one block's
// shared memory; false where even one sample and one warp do not.
// `make(S, NC)` lays out a tile of S samples with NC core warps.
template <class Make>
bool choose_plan_by(int H, const Make& make, Plan* out) {
  for (int nc = kWarps; nc >= 1; --nc) {
    for (int s = kMaxSamples; s >= 1; --s) {
      if (nc > s * H) continue;
      const Plan p = make(s, nc);
      if (4LL * p.total <= kSmemMax) {
        *out = p;
        return true;
      }
    }
  }
  return false;
}

bool choose_plan(int B, int F, int d, int a, int H, float scale, int residual,
                 Plan* out) {
  return choose_plan_by(
      H, [&](int s, int nc) { return make_plan(B, F, d, a, H, s, nc, scale, residual); },
      out);
}

// Gradient partial layout per block (real, unpadded): dwqkv (d, 3a) | dbqkv
// (3a) | dwo (a, d) | dbo (d) | dls (d) | dlb (d).
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const void* __restrict__ x_g, const float* __restrict__ g_g,
                const void* __restrict__ wqkv_g, const float* __restrict__ bqkv_g,
                const void* __restrict__ wo_g, const float* __restrict__ bo_g,
                const float* __restrict__ ls_g, void* __restrict__ dx_g,
                float* __restrict__ part, const int n_part, const Plan p) {
  using io = Io<BF16>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int F = p.F, d = p.d, a = p.a, a3 = 3 * p.a;
  float* wq = sm;
  float* wo = sm + p.o_wo;
  float* bqkv = sm + p.o_bqkv;
  float* bo = sm + p.o_bo;
  float* ls = sm + p.o_ls;
  float* dw = sm + p.o_dw;
  float* dwo = sm + p.o_dwo;
  float* db = sm + p.o_db;
  float* xs = sm + p.o_x;
  float* y = sm + p.o_y;
  float* dout = sm + p.o_dout;
  float* qkv = sm + p.o_qkv;
  float* ctx = sm + p.o_ctx;
  float* scr = sm + p.o_scr + warp * 2 * F * p.FS;
  // between the cores the scratch holds the tile's g (RP x XS), then the
  // column sums' partials: ng groups of rows for each of the d columns
  float* gs = sm + p.o_scr;
  float* colp = gs + p.RP * p.XS;
  const int ng = d < kThreads ? kThreads / d : 1;
  const int XS = p.XS, QS = p.QS, CS = p.CS, WS = p.WS, OS = p.OS;

  // zero everything (pads, accumulators, rows no sample fills), then the
  // weights into their padded places
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
  }

  const int tiles = (p.B + p.S - 1) / p.S;
  const int mt = p.RP / 16;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * p.S;
    const int sv = min(p.S, p.B - b0);
    const int R = sv * F;  // valid rows; rows R..RP-1 stay out of every sum
    const size_t e0 = (size_t)b0 * F * d;
    // (no barrier: the previous tile's last stage reads only y)
    load_rows(p.RP * d, R * d, d, XS, xs, [&](size_t i) { return io::load(x_g, e0 + i); });
    __syncthreads();
    // ---- qkv = x . Wqkv + bqkv
    product<BF16>(
        mt, p.n3 / 16, p.dp, [&](int m, int k) { return xs[m * XS + k]; },
        [&](int k, int n) { return wq[k * WS + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) { qkv[r * QS + c] = v + bqkv[c]; }, warp, g, t);
    __syncthreads();
    // ---- forward core: ctx
    core<false>(p, qkv, ctx, scr, sv, warp, lane);
    __syncthreads();
    // ---- y = op(ctx) . op(wo) + bo (+ x); g into the idle scratch
    load_rows(p.RP * d, R * d, d, XS, gs, [&](size_t i) { return g_g[e0 + i]; });
    product<BF16>(
        mt, p.dp / 16, p.ap, [&](int m, int k) { return ctx[m * CS + k]; },
        [&](int k, int n) { return wo[k * OS + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) {
          v += bo[c];
          if (p.residual) v += xs[r * XS + c];
          y[r * XS + c] = v;
        },
        warp, g, t);
    __syncthreads();
    // ---- LayerNorm / residual adjoint, a thread a row: yn into y, dout
    for (int r = tid; r < p.RP; r += kThreads) {
      float* yr = y + r * XS;
      float* dr = dout + r * XS;
      if (r >= R) {
        for (int c = 0; c < d; ++c) dr[c] = 0.f;
        continue;
      }
      const float* gr = gs + r * XS;
      if (!p.residual) {
        for (int c = 0; c < d; ++c) dr[c] = gr[c];
        continue;
      }
      float mean = 0.f;
      for (int c = 0; c < d; ++c) mean += yr[c];
      mean /= d;
      float var = 0.f;
      for (int c = 0; c < d; ++c) var += (yr[c] - mean) * (yr[c] - mean);
      var /= d;
      const float inv = rsqrtf(var + kLnEps);
      float m1 = 0.f, m2 = 0.f;
      for (int c = 0; c < d; ++c) {
        const float yn = (yr[c] - mean) * inv;
        yr[c] = yn;
        const float dyn = gr[c] * ls[c];
        m1 += dyn;
        m2 += dyn * yn;
      }
      m1 /= d;
      m2 /= d;
      for (int c = 0; c < d; ++c) dr[c] = inv * (gr[c] * ls[c] - m1 - yr[c] * m2);
    }
    __syncthreads();
    // ---- dbo, dls, dlb: each column's rows in ng interleaved groups, the
    // groups' partials added in group order in the next stage; and dWo +=
    // op(ctx)^T op(dout)
    for (int u = tid; u < ng * d; u += kThreads) {
      const int grp = u / d, c = u - grp * d;
      float sb = 0.f, sl = 0.f, sg = 0.f;
      for (int r = grp; r < R; r += ng) {
        sb += dout[r * XS + c];
        if (p.residual) {
          const float gv = gs[r * XS + c];
          sl += gv * y[r * XS + c];
          sg += gv;
        }
      }
      colp[3 * u] = sb;
      colp[3 * u + 1] = sl;
      colp[3 * u + 2] = sg;
    }
    product<BF16>(
        p.ap / 16, p.dp / 16, p.RP, [&](int m, int k) { return ctx[k * CS + m]; },
        [&](int k, int n) { return dout[k * XS + n]; },
        [&](int r, int c) { return dwo[r * OS + c]; },
        [&](int r, int c, float v) { dwo[r * OS + c] = v; }, warp, g, t);
    __syncthreads();
    // ---- dctx = op(dout) . op(wo)^T, over ctx; the column partials' sums
    for (int c = tid; c < d; c += kThreads) {
      float sb = 0.f, sl = 0.f, sg = 0.f;
      for (int grp = 0; grp < ng; ++grp) {
        const float* q = colp + 3 * (grp * d + c);
        sb += q[0];
        sl += q[1];
        sg += q[2];
      }
      db[p.n3 + c] += sb;
      db[p.n3 + p.dp + c] += sl;
      db[p.n3 + 2 * p.dp + c] += sg;
    }
    product<BF16>(
        mt, p.ap / 16, p.dp, [&](int m, int k) { return dout[m * XS + k]; },
        [&](int k, int n) { return wo[n * OS + k]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) { ctx[r * CS + c] = v; }, warp, g, t);
    __syncthreads();
    // ---- backward core: [dq|dk|dv] over qkv
    core<true>(p, qkv, ctx, scr, sv, warp, lane);
    __syncthreads();
    // ---- dbqkv (a thread a column), dWqkv += x^T op(dall), and
    // dx = dout (with residual) + op(dall) . Wqkv^T into y
    for (int j = tid; j < p.n3; j += kThreads) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < R; ++r) s += qkv[r * QS + j];
      db[j] += s;
    }
    product<BF16>(
        p.dp / 16, p.n3 / 16, p.RP, [&](int m, int k) { return xs[k * XS + m]; },
        [&](int k, int n) { return qkv[k * QS + n]; },
        [&](int r, int c) { return dw[r * WS + c]; },
        [&](int r, int c, float v) { dw[r * WS + c] = v; }, warp, g, t);
    product<BF16>(
        mt, p.dp / 16, p.n3, [&](int m, int k) { return qkv[m * QS + k]; },
        [&](int k, int n) { return wq[n * WS + k]; },
        [&](int r, int c) { return p.residual ? dout[r * XS + c] : 0.f; },
        [&](int r, int c, float v) { y[r * XS + c] = v; }, warp, g, t);
    __syncthreads();
    for (int i = tid; i < R * d; i += kThreads) {
      const int r = i / d;
      io::store(dx_g, e0 + i, y[r * XS + (i - r * d)]);
    }
  }
  __syncthreads();
  // the block's partial, unpadded
  const int n_wqkv = d * a3, n_wo = a * d;
  for (int i = tid; i < n_part; i += kThreads) {
    float v;
    if (i < n_wqkv) {
      const int c = i / a3;
      v = dw[c * WS + qkv_col(p, i - c * a3)];
    } else if (i < n_wqkv + a3) {
      v = db[qkv_col(p, i - n_wqkv)];
    } else if (i < n_wqkv + a3 + n_wo) {
      const int k = i - n_wqkv - a3, j = k / d;
      v = dwo[head_row(p, j) * OS + (k - j * d)];
    } else {
      const int k = i - n_wqkv - a3 - n_wo, which = k / d;
      v = db[p.n3 + which * p.dp + (k - which * d)];
    }
    part[(size_t)blockIdx.x * n_part + i] = v;
  }
}

// out[i] = sum over blocks of part[blk, i], in block order.
__global__ void attn_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, const int n,
                                   const int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int b = 0; b < blocks; ++b) v += part[(size_t)b * n + i];
  out[i] = v;
}

template <bool BF16>
cudaError_t bwd(const void* x, const float* g, const void* wqkv,
                const float* bqkv, const void* wo, const float* bo,
                const float* ls, void* dx, float* part, float* grads,
                int n_part, const Plan& p, int grid, cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  const int smem = 4 * p.total;
  cudaError_t err = ensure_smem(attn_bwd_kernel<BF16>, smem, smem_set);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<BF16><<<grid, kThreads, smem, stream>>>(
      x, g, wqkv, bqkv, wo, bo, ls, dx, part, n_part, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_reduce_kernel<<<(n_part + 255) / 256, 256, 0, stream>>>(part, grads, n_part, grid);
  return cudaGetLastError();
}

// ---- AutoInt's interacting layer

// w4 (d rounded up to 16, 4a padded), x's rows, [q|k|v|res] and then dall4
// over it, ctx (dctx, then dx: as wide as the wider of a and d), and each
// core warp's two F x FS matrices
Plan make_interact_plan(int B, int F, int d, int a, int H, int S, int NC,
                        float scale) {
  Plan p = plan_geometry(B, F, d, a, H, S, NC, scale, 0);
  p.WS = row_stride(4 * p.ap);
  p.QS = p.WS;
  p.CS = row_stride(p.ap > p.dp ? p.ap : p.dp);
  p.o_x = p.dp * p.WS;
  p.o_qkv = p.o_x + p.RP * p.XS;
  p.o_ctx = p.o_qkv + p.RP * p.QS;
  p.o_scr = p.o_ctx + p.RP * p.CS;
  p.total = p.o_scr + NC * 2 * F * p.FS;
  return p;
}

bool choose_interact_plan(int B, int F, int d, int a, int H, float scale, Plan* out) {
  return choose_plan_by(
      H, [&](int s, int nc) { return make_interact_plan(B, F, d, a, H, s, nc, scale); },
      out);
}

// part: (gridDim.x, dp * 4ap) f32, this block's dW4 partial in the padded
// layout; x, g, w4 and dx in the compute type.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
interact_bwd_kernel(const void* __restrict__ x_g, const void* __restrict__ g_g,
                    const void* __restrict__ w_g, void* __restrict__ dx_g,
                    float* __restrict__ part, const Plan p) {
  using io = Io<BF16>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int F = p.F, d = p.d, a = p.a, a4 = 4 * p.a, n4 = 4 * p.ap;
  const int XS = p.XS, QS = p.QS, CS = p.CS, WS = p.WS, r3 = 3 * p.ap;
  float* w = sm;
  float* xs = sm + p.o_x;
  float* qkv = sm + p.o_qkv;
  float* ctx = sm + p.o_ctx;
  float* scr = sm + p.o_scr + warp * 2 * F * p.FS;
  float* dw = part + (size_t)blockIdx.x * p.dp * n4;

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
    const int R = sv * F;  // valid rows; rows R..RP-1 of dall4 stay 0
    const size_t e0 = (size_t)b0 * F * d, o0 = (size_t)b0 * F * a;
    load_rows(p.RP * d, R * d, d, XS, xs, [&](size_t i) { return io::load(x_g, e0 + i); });
    __syncthreads();
    // ---- [q|k|v|res] = x . w4
    product<BF16>(
        mt, n4 / 16, p.dp, [&](int m, int k) { return xs[m * XS + k]; },
        [&](int k, int n) { return w[k * WS + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) { qkv[r * QS + c] = v; }, warp, g, t);
    __syncthreads();
    core<false>(p, qkv, ctx, scr, sv, warp, lane);
    __syncthreads();
    // ---- dres = g under the ReLU's mask, into res's place and over ctx
    for (int i = tid; i < R * a; i += kThreads) {
      const int r = i / a, c = head_row(p, i - r * a);
      const float pre = ctx[r * CS + c] + qkv[r * QS + r3 + c];
      const float gv = pre > 0.f ? io::load(g_g, o0 + i) : 0.f;
      ctx[r * CS + c] = gv;
      qkv[r * QS + r3 + c] = gv;
    }
    __syncthreads();
    core<true>(p, qkv, ctx, scr, sv, warp, lane);
    __syncthreads();
    // ---- dW4 += x^T op(dall4) into the block's partial; dx = op(dall4) .
    // w4^T over ctx
    const bool first = tile == (int)blockIdx.x;
    product<BF16>(
        p.dp / 16, n4 / 16, p.RP, [&](int m, int k) { return xs[k * XS + m]; },
        [&](int k, int n) { return qkv[k * QS + n]; },
        [&](int r, int c) { return first ? 0.f : dw[r * n4 + c]; },
        [&](int r, int c, float v) { dw[r * n4 + c] = v; }, warp, g, t);
    product<BF16>(
        mt, p.dp / 16, n4, [&](int m, int k) { return qkv[m * QS + k]; },
        [&](int k, int n) { return w[n * WS + k]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) { ctx[r * CS + c] = v; }, warp, g, t);
    __syncthreads();
    for (int i = tid; i < R * d; i += kThreads) {
      const int r = i / d;
      io::store(dx_g, e0 + i, ctx[r * CS + (i - r * d)]);
    }
    // (the next tile writes ctx only after two barriers)
  }
}

// out (d, 4a) real layout: out[i] = sum over blocks of the partials' padded
// element, in block order.
__global__ void interact_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, const Plan p,
                                       const int blocks) {
  const int a4 = 4 * p.a, n4 = 4 * p.ap;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.d * a4) return;
  const int c = i / a4;
  const size_t src = (size_t)c * n4 + qkv_col(p, i - c * a4);
  const size_t stride = (size_t)p.dp * n4;
  float v = 0.f;
  for (int b = 0; b < blocks; ++b) v += part[b * stride + src];
  out[i] = v;
}

template <bool BF16>
cudaError_t interact_bwd(const void* x, const void* g, const void* w, void* dx,
                         float* part, float* grads, const Plan& p, int grid,
                         cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  const int smem = 4 * p.total;
  cudaError_t err = ensure_smem(interact_bwd_kernel<BF16>, smem, smem_set);
  if (err != cudaSuccess) return err;
  interact_bwd_kernel<BF16><<<grid, kThreads, smem, stream>>>(x, g, w, dx, part, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = p.d * 4 * p.a;
  interact_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, grads, p, grid);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); every pointer is a device pointer
// on the current device. x and dx (B, F, d), wqkv (d, 3a) and wo (a, d) in
// the compute type (bf16 selects bf16); g (B, F, d) f32; bqkv (3a,), bo, ls
// (d,) f32; part (grid, n_part) f32 workspace; grads (n_part,) f32 in the
// partial layout above. `samples`, `core_warps`, `grid` and `smem` are the
// wrapper's plan, refused (cudaErrorInvalidValue) unless they are this
// file's. Returns a cudaError_t, 0 on a successful launch; the kernels run on
// `stream` and nothing here synchronises.
extern "C" int attention_bwd(const void* x, const float* g, const void* wqkv,
                             const float* bqkv, const void* wo, const float* bo,
                             const float* ls, void* dx, float* part, float* grads,
                             int n_part, int B, int F, int d, int a, int H,
                             float scale, int residual, int bf16, int samples,
                             int core_warps, int grid, int smem, void* stream) {
  if (B < 1 || F < 1 || d < 1 || H < 1 || a < H || a % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  if (!choose_plan(B, F, d, a, H, scale, residual, &p)) return (int)cudaErrorInvalidValue;
  const int tiles = (B + p.S - 1) / p.S;
  const int want_grid = tiles < kBlocks ? tiles : kBlocks;
  if (p.S != samples || p.NC != core_warps || 4 * p.total != smem ||
      grid != want_grid || n_part != d * 3 * a + 3 * a + a * d + 3 * d) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? bwd<true>(x, g, wqkv, bqkv, wo, bo, ls, dx, part, grads, n_part, p, grid, st)
           : bwd<false>(x, g, wqkv, bqkv, wo, bo, ls, dx, part, grads, n_part, p, grid, st);
  return (int)err;
}

// Plain C entry point of the interacting layer's backward; every pointer is
// a device pointer on the current device. x and dx (B, F, d), g (B, F, a)
// and w = [wq|wk|wv|wres] (d, 4a) in the compute type (bf16 selects bf16);
// part (grid, dp * 4ap) f32 workspace (dp: d rounded up to 16; ap: a with
// each head padded to 4 floats, rounded up to 16); grads (d, 4a) f32.
// `samples`, `core_warps`, `grid` and `smem` are the wrapper's plan
// (interacting_backward_plan), refused (cudaErrorInvalidValue) unless they
// are this file's. Returns a cudaError_t, 0 on a successful launch; the
// kernels run on `stream` and nothing here synchronises.
extern "C" int interacting_bwd(const void* x, const void* g, const void* w,
                               void* dx, float* part, float* grads, int n_part,
                               int B, int F, int d, int a, int H, float scale,
                               int bf16, int samples, int core_warps, int grid,
                               int smem, void* stream) {
  if (B < 1 || F < 1 || d < 1 || H < 1 || a < H || a % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  if (!choose_interact_plan(B, F, d, a, H, scale, &p)) return (int)cudaErrorInvalidValue;
  const int tiles = (B + p.S - 1) / p.S;
  const int want_grid = tiles < kBlocks ? tiles : kBlocks;
  if (p.S != samples || p.NC != core_warps || 4 * p.total != smem ||
      grid != want_grid || n_part != p.dp * 4 * p.ap) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? interact_bwd<true>(x, g, w, dx, part, grads, p, grid, st)
           : interact_bwd<false>(x, g, w, dx, part, grads, p, grid, st);
  return (int)err;
}

// Message for an error code returned by the entry point.
extern "C" const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
