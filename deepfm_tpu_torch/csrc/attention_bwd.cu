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
//  * The attention core is the tiled core of attention_tile.cuh, on all 8
//    warps: every (sample, head) pair of the tile at once, each thread a
//    register tile of 5 rows by 4 or 8 columns of one pair's product (5 x 5
//    of an F x F one), phase by phase with a barrier between: scores, the
//    softmax (a thread a row, the row in registers up to 40 keys), ctx
//    with the ReLU's mask; dw, the softmax's adjoint (a thread a row), dv
//    and dq together, dk, dq into q's place. The lane-per-query core it
//    replaces (one warp a pair, one lane a query, the other operand a
//    float4 that every lane reads at once) paid a shared-memory wavefront
//    an FMA, ran on 3-4 warps while the rest waited, and wrapped F = 39
//    over 32 lanes: 6.93 of 9.19 ms at d = 64 (PERF.md). Each value a
//    thread loads now feeds 5 to 8 FMAs.
//  * ctx is not kept: each thread's ctx tile goes straight into the mask,
//    dres = g where ctx + res > 0, over res (its g loaded before the
//    tile's sums, and the whole tile's g asked into L2 as the tile
//    starts). The backward keeps the recomputed forward's softmax in the
//    scratch instead of recomputing the scores (6 products a pair, not 7)
//    and reads dctx from dres's columns, so ctx's rows are free for dq
//    while dv goes over v, and dk over k after both.
//  * Bits: each sum runs in the lane-per-query core's order (the tile
//    header says how), and the softmax and its adjoint are that core's
//    steps, so the recomputed softmax, context and ReLU mask are the
//    forward kernel's bits (interact_fwd_kernel keeps that core), and dx
//    and dW4 the lane-per-query backward's.
//  * Element loops (x's rows in, g's mask on the fallback, dq's copy, dx
//    out) step a (row, head, column) walk: an integer division by a
//    runtime width an element cost more than their loads.
//  * Shared memory holds w4, a tile's [q|k|v|res] (then dall4 over it), ctx
//    (dq, then dx over it) and one region that holds x's rows for the two
//    products that read them and, between them, the pairs' F x F matrices
//    (every pair's softmax W, then every pair's dw / ds, 48,672 B at the
//    paper's 2 samples of 2 heads); x is loaded again after the core (the
//    next tile's is asked into L2 as a tile starts). No gradient
//    accumulator: at d = a = 64 the block's layout asks 243,968 B, over
//    the limit. Each block's dW4 partial (d rounded up to 16 rows, 4a
//    padded columns, f32) lives in device memory instead, where the
//    block's first tile writes it and each later tile reads and adds to
//    it: every element is owned by one lane of one warp (product's fixed
//    order of tiles), so the sums run in tile order with no barrier and no
//    atomics. The 64 KB partial of a block at d = 64 stays in L2 (132
//    blocks: 8.6 MB).
//  * dW4 and dx are the same two products over op(dall4) that the block
//    takes over op([dq|dk|dv]), 4a wide; the block's LayerNorm, bias and
//    output projection stages have no counterpart.
//  * interact_reduce_kernel adds the partials in block order into the real
//    (d, 4a) layout; the grid is the block's fixed 132. Two launches give
//    the same bits.
// Its plan (interacting_backward_plan) takes the tiled layout with the
// most samples a tile that fits one block; where none does (two F x F
// matrices for every pair of even one sample outgrow x's rows, as at
// F = 65-69, d = 64, 2 heads), the lane-per-query core's layout with the
// most core warps, then samples, as the block's backward does.

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

// The lane-per-query layout (the fallback): w4 (d rounded up to 16, 4a
// padded), x's rows, [q|k|v|res] and then dall4 over it, ctx (dctx, then
// dx: as wide as the wider of a and d), and each core warp's two F x FS
// matrices
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

// The tiled layout: w4, [q|k|v|res] (then dall4), ctx (dq, then dx), and
// one region that holds x's rows for the
// two products that read them and, between, the tiled core's every pair's
// W and then every pair's D (x is read again after it). All 8 warps run
// the core.
Plan make_tiled_interact_plan(int B, int F, int d, int a, int H, int S,
                              float scale) {
  Plan p = plan_geometry(B, F, d, a, H, S, kWarps, scale, 0);
  p.WS = row_stride(4 * p.ap);
  p.QS = p.WS;
  p.CS = row_stride(p.ap > p.dp ? p.ap : p.dp);
  p.o_qkv = p.dp * p.WS;
  p.o_ctx = p.o_qkv + p.RP * p.QS;
  p.o_x = p.o_ctx + p.RP * p.CS;
  p.o_scr = p.o_x;
  const int rows = p.RP * p.XS, mats = S * H * F * p.FS;
  p.o_d = p.o_scr + mats;
  p.total = p.o_x + (rows > 2 * mats ? rows : 2 * mats);
  return p;
}

// The tiled layout with the most samples a tile that fits one block, else
// the lane-per-query layout as the block's backward chooses it; false where
// neither fits. *tiled says which.
bool choose_interact_plan(int B, int F, int d, int a, int H, float scale, Plan* out,
                          bool* tiled) {
  for (int s = kMaxSamples; s >= 1; --s) {
    const Plan p = make_tiled_interact_plan(B, F, d, a, H, s, scale);
    if (4LL * p.total <= kSmemMax) {
      *out = p;
      *tiled = true;
      return true;
    }
  }
  *tiled = false;
  return choose_plan_by(
      H, [&](int s, int nc) { return make_interact_plan(B, F, d, a, H, s, nc, scale); },
      out);
}

// The elements i = threadIdx.x, + kThreads, ... of a row-major walk, each
// i = (r * H + h) * n + c: r a row, h a head (H of them; 1 for plain rows),
// c < n within it. next() steps to the thread's next element with no
// division (an integer division by a runtime width cost more than these
// loops' loads).
struct Walk {
  int r, h, c;     // where the thread is
  int sr, sh, sc;  // kThreads in the same terms
  int H, n;
  __device__ Walk(int H_, int n_) : H(H_), n(n_) {
    split(threadIdx.x, &r, &h, &c);
    split(kThreads, &sr, &sh, &sc);
  }
  __device__ void split(int i, int* rr, int* hh, int* cc) const {
    const int q = i / n;
    *cc = i - q * n;
    *rr = q / H;
    *hh = q - *rr * H;
  }
  __device__ __forceinline__ void next() {
    c += sc;
    if (c >= n) {
      c -= n;
      ++h;
    }
    h += sh;
    if (h >= H) {
      h -= H;
      ++r;
    }
    r += sr;
  }
};

// x's rows of a tile into xs, every element of its RP x dp part written
// (rows past R and columns past d 0: the tiled core's scratch lies over
// them between the products), each thread's loads in flight together
template <bool BF16>
__device__ __forceinline__ void load_x(const Plan& p, const void* x_g, size_t e0, int R,
                                       float* xs) {
  using io = Io<BF16>;
  constexpr int U = 8;
  const int n = p.RP * p.dp;
  Walk at(1, p.dp);
  for (int base = threadIdx.x; base < n; base += U * kThreads) {
    float v[U];
    int o[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads;
      o[u] = at.r * p.XS + at.c;
      v[u] = i < n && at.r < R && at.c < p.d ? io::load(x_g, e0 + (size_t)at.r * p.d + at.c)
                                             : 0.f;
      at.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * kThreads < n) xs[o[u]] = v[u];
    }
  }
}

// The tiled core's forward half for the sv valid samples and the ReLU's
// mask: W (softmax) of every pair, then each thread's ctx tile goes
// straight into the mask, dres = g where ctx + res > 0, over res (ctx is
// not kept: the backward reads dctx = dres there). Its g is loaded before
// the tile's sums, so that the loads land while they run.
template <bool BF16, int M4>
__device__ void tiled_forward(const Plan& p, int pairs, float* qkv, float* W, const void* g_g,
                              size_t o0) {
  const int F = p.F, QS = p.QS;
  tiled_scores<M4, true>(p, pairs, qkv, 0, p.ap, W);
  __syncthreads();
  tiled_softmax(p, pairs, W);
  __syncthreads();
  each_tile<4>(pairs, F, p.hdp, [&](int pr, int r0, int c0) {
    const int s = pr / p.H, h = pr - s * p.H;
    float* res = qkv + s * F * QS + 3 * p.ap + h * p.hdp + c0;
    const size_t gi = o0 + (size_t)s * F * p.a + h * p.hd + c0;
    float gv[kTm][4];
#pragma unroll
    for (int u = 0; u < kTm; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[u][e] = r0 + u < F && c0 + e < p.hd
                       ? Io<BF16>::load(g_g, gi + (size_t)(r0 + u) * p.a + e)
                       : 0.f;
      }
    }
    mix_tile<false, 4>(p, W + pr * F * p.FS, pair_at(p, qkv, QS, pr) + 2 * p.ap, QS, r0, c0,
                       [&](int u, const float (&ctx)[4]) {
#pragma unroll
                         for (int e = 0; e < 4; ++e) {
                           float* q = res + (r0 + u) * QS + e;
                           *q = ctx[e] + *q > 0.f ? gv[u][e] : 0.f;
                         }
                       });
  });
}

// dv and dq of every pair, dv over v and dq over the ctx rows: 2 * pairs
// products, the first half dv
template <int TN>
__device__ __forceinline__ void tiled_dv_dq(const Plan& p, int pairs, float* qkv, float* ctx,
                                            const float* W, const float* D) {
  const int F = p.F, FS = p.FS, QS = p.QS, ap = p.ap;
  each_tile<TN>(2 * pairs, F, p.hdp, [&](int vp, int r0, int c0) {
    if (vp < pairs) {
      float* rows = pair_at(p, qkv, QS, vp);
      mix_tile<true, TN>(p, W + vp * F * FS, rows + 3 * ap, QS, r0, c0,
                         ToRows<TN>{rows + 2 * ap, QS, r0, c0});
    } else {
      const int pr = vp - pairs;
      mix_tile<false, TN>(p, D + pr * F * FS, pair_at(p, qkv, QS, pr) + ap, QS, r0, c0,
                          ToRows<TN>{pair_at(p, ctx, p.CS, pr), p.CS, r0, c0});
    }
  });
}

// The tiled core's backward half, W of every pair in the scratch and
// dctx = dres in the res columns: D = dw, then ds; dv over v, dq over the
// ctx rows; dk over k; dq into q's place. Leaves the scratch free.
template <int M4>
__device__ void tiled_backward(const Plan& p, int pairs, float* qkv, float* ctx, float* W,
                               float* D) {
  const int F = p.F, FS = p.FS, QS = p.QS, ap = p.ap;
  tiled_scores<M4, false>(p, pairs, qkv, 3 * ap, 2 * ap, D);
  __syncthreads();
  tiled_softmax_adjoint(p, pairs, W, D);
  __syncthreads();
  // dv_j = sum_i w_ij dctx_i (v last read by dw); dq_i = sum_j ds_ij k_j
  if (p.hdp % 8 == 0) {
    tiled_dv_dq<8>(p, pairs, qkv, ctx, W, D);
  } else {
    tiled_dv_dq<4>(p, pairs, qkv, ctx, W, D);
  }
  __syncthreads();
  // dk_j = sum_i ds_ij q_i (k last read by dq)
  each_tile<4>(pairs, F, p.hdp, [&](int pr, int r0, int c0) {
    float* rows = pair_at(p, qkv, QS, pr);
    mix_tile<true, 4>(p, D + pr * F * FS, rows, QS, r0, c0, ToRows<4>{rows + ap, QS, r0, c0});
  });
  __syncthreads();
  // (row, head, float4 of the head) of the pairs' rows
  Walk at(p.H, p.hdp / 4);
  for (int u = threadIdx.x; u < pairs * F * (p.hdp / 4); u += kThreads, at.next()) {
    const int c = at.h * p.hdp + 4 * at.c;
    *reinterpret_cast<float4*>(qkv + at.r * QS + c) =
        *reinterpret_cast<const float4*>(ctx + at.r * p.CS + c);
  }
}

// The tiled core's forward half and mask, or its backward half, at the
// chunk width M4 = p.m4
template <bool BF16>
__device__ void tiled_forward_at(const Plan& p, int pairs, float* qkv, float* W,
                                 const void* g_g, size_t o0) {
  switch (p.m4) {
    case 4: tiled_forward<BF16, 4>(p, pairs, qkv, W, g_g, o0); break;
    case 3: tiled_forward<BF16, 3>(p, pairs, qkv, W, g_g, o0); break;
    case 2: tiled_forward<BF16, 2>(p, pairs, qkv, W, g_g, o0); break;
    default: tiled_forward<BF16, 1>(p, pairs, qkv, W, g_g, o0); break;
  }
}

__device__ void tiled_backward_at(const Plan& p, int pairs, float* qkv, float* ctx, float* W,
                                  float* D) {
  switch (p.m4) {
    case 4: tiled_backward<4>(p, pairs, qkv, ctx, W, D); break;
    case 3: tiled_backward<3>(p, pairs, qkv, ctx, W, D); break;
    case 2: tiled_backward<2>(p, pairs, qkv, ctx, W, D); break;
    default: tiled_backward<1>(p, pairs, qkv, ctx, W, D); break;
  }
}

// part: (gridDim.x, dp * 4ap) f32, this block's dW4 partial in the padded
// layout; x, g, w4 and dx in the compute type. Tiled: the tiled core on
// all warps (make_tiled_interact_plan), else the lane-per-query core on
// p.NC warps (make_interact_plan).
template <bool BF16, bool Tiled>
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
  float* scr = Tiled ? sm + p.o_scr : sm + p.o_scr + warp * 2 * F * p.FS;
  float* D = sm + p.o_d;  // tiled: every pair's D
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
    load_x<BF16>(p, x_g, e0, R, xs);
    __syncthreads();
    if constexpr (Tiled) {
      // into L2 while the tile's products run: its g (read by the mask)
      // and the next tile's x
      constexpr size_t es = BF16 ? 2 : 4;
      prefetch_l2(static_cast<const char*>(g_g) + o0 * es, (size_t)R * a * es);
      const int nt = tile + gridDim.x;
      if (nt < tiles) {
        prefetch_l2(static_cast<const char*>(x_g) + (size_t)nt * p.S * F * d * es,
                    (size_t)min(p.S, p.B - nt * p.S) * F * d * es);
      }
    }
    // ---- [q|k|v|res] = x . w4
    product<BF16>(
        mt, n4 / 16, p.dp, [&](int m, int k) { return xs[m * XS + k]; },
        [&](int k, int n) { return w[k * WS + n]; },
        [](int, int) { return 0.f; },
        [&](int r, int c, float v) { qkv[r * QS + c] = v; }, warp, g, t);
    __syncthreads();
    if constexpr (Tiled) {
      tiled_forward_at<BF16>(p, sv * p.H, qkv, scr, g_g, o0);
    } else {
      core<false>(p, qkv, ctx, scr, sv, warp, lane);
      __syncthreads();
      // ---- dres = g under the ReLU's mask, over res and over ctx (where
      // the lane-per-query core reads dctx); g's loads in flight together
      constexpr int U = 8;
      Walk at(p.H, p.hd);  // (row, head, element of the head) of g's rows
      for (int base = tid; base < R * a; base += U * kThreads) {
        float gv[U];
        int r[U], c[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = base + u * kThreads;
          gv[u] = i < R * a ? io::load(g_g, o0 + i) : 0.f;
          r[u] = at.r;
          c[u] = at.h * p.hdp + at.c;
          at.next();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (base + u * kThreads < R * a) {
            const float pre = ctx[r[u] * CS + c[u]] + qkv[r[u] * QS + r3 + c[u]];
            const float v = pre > 0.f ? gv[u] : 0.f;
            ctx[r[u] * CS + c[u]] = v;
            qkv[r[u] * QS + r3 + c[u]] = v;
          }
        }
      }
    }
    __syncthreads();
    if constexpr (Tiled) {
      tiled_backward_at(p, sv * p.H, qkv, ctx, scr, D);
      load_x<BF16>(p, x_g, e0, R, xs);  // the scratch's last readers are behind a barrier
    } else {
      core<true>(p, qkv, ctx, scr, sv, warp, lane);
    }
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
    Walk at_dx(1, d);
    for (int i = tid; i < R * d; i += kThreads, at_dx.next()) {
      io::store(dx_g, e0 + i, ctx[at_dx.r * CS + at_dx.c]);
    }
    // (the next tile writes ctx only after two barriers, and x's region
    // after one: its last readers are above that barrier)
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

template <bool BF16, bool Tiled>
cudaError_t interact_bwd(const void* x, const void* g, const void* w, void* dx,
                         float* part, float* grads, const Plan& p, int grid,
                         cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  const int smem = 4 * p.total;
  cudaError_t err = ensure_smem(interact_bwd_kernel<BF16, Tiled>, smem, smem_set);
  if (err != cudaSuccess) return err;
  interact_bwd_kernel<BF16, Tiled><<<grid, kThreads, smem, stream>>>(x, g, w, dx, part, p);
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
// `samples`, `core_warps`, `tiled`, `grid` and `smem` are the wrapper's
// plan (interacting_backward_plan), refused (cudaErrorInvalidValue) unless
// they are this file's. Returns a cudaError_t, 0 on a successful launch;
// the kernels run on `stream` and nothing here synchronises.
extern "C" int interacting_bwd(const void* x, const void* g, const void* w,
                               void* dx, float* part, float* grads, int n_part,
                               int B, int F, int d, int a, int H, float scale,
                               int bf16, int samples, int core_warps, int tiled,
                               int grid, int smem, void* stream) {
  if (B < 1 || F < 1 || d < 1 || H < 1 || a < H || a % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  bool is_tiled = false;
  if (!choose_interact_plan(B, F, d, a, H, scale, &p, &is_tiled)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (B + p.S - 1) / p.S;
  const int want_grid = tiles < kBlocks ? tiles : kBlocks;
  if (p.S != samples || p.NC != core_warps || (int)is_tiled != tiled ||
      4 * p.total != smem || grid != want_grid || n_part != p.dp * 4 * p.ap) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_tiled) {
    err = bf16 ? interact_bwd<true, true>(x, g, w, dx, part, grads, p, grid, st)
               : interact_bwd<false, true>(x, g, w, dx, part, grads, p, grid, st);
  } else {
    err = bf16 ? interact_bwd<true, false>(x, g, w, dx, part, grads, p, grid, st)
               : interact_bwd<false, false>(x, g, w, dx, part, grads, p, grid, st);
  }
  return (int)err;
}

// Message for an error code returned by the entry point.
extern "C" const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
