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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSamples = 8;
constexpr int kBlocks = 132;  // one block an SM of an H100 SXM
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 64;
constexpr float kLnEps = 1e-5f;

template <bool BF16>
struct Io;

template <>
struct Io<false> {
  __device__ static float load(const void* p, size_t i) {
    return static_cast<const float*>(p)[i];
  }
  __device__ static void store(void* p, size_t i, float v) {
    static_cast<float*>(p)[i] = v;
  }
};

template <>
struct Io<true> {
  __device__ static float load(const void* p, size_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static void store(void* p, size_t i, float v) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// A row stride of n floats: a multiple of 4 (16-byte rows) that is not a
// multiple of 8, so the 8 rows of an mma fragment start on distinct banks.
__host__ __device__ inline int row_stride(int n) {
  const int s = round_up(n, 4);
  return s % 8 == 0 ? s + 4 : s;
}

struct Plan {
  int B, F, d, a, H, hd;
  int hdp, ap, n3, dp;          // padded head, [q|k|v] section, 3 * ap, d
  int m4;                       // float4s of a head chunk in the core
  int WS, OS, XS, QS, CS, FS;   // row strides: wqkv, wo, x/y/dout, qkv, ctx, scratch
  int S, NC, RP;                // samples a tile, core warps, rows a tile
  float scale;
  int residual;
  // shared-memory regions, in floats from the start
  int o_wo, o_bqkv, o_bo, o_ls, o_dw, o_dwo, o_db, o_x, o_y, o_dout, o_qkv,
      o_ctx, o_scr, total;
};

Plan make_plan(int B, int F, int d, int a, int H, int S, int NC, float scale,
               int residual) {
  Plan p;
  p.B = B; p.F = F; p.d = d; p.a = a; p.H = H; p.hd = a / H;
  p.hdp = round_up(p.hd, 4);
  // the widest chunk (at most 4 float4s) that divides the padded head
  const int h4 = p.hdp / 4;
  p.m4 = h4 % 4 == 0 ? 4 : h4 % 3 == 0 ? 3 : h4 % 2 == 0 ? 2 : 1;
  p.ap = round_up(H * p.hdp, 16);
  p.n3 = 3 * p.ap;
  p.dp = round_up(d, 16);
  p.WS = row_stride(p.n3);
  p.OS = row_stride(p.dp);
  p.XS = row_stride(p.dp);
  p.QS = row_stride(p.n3);
  p.CS = row_stride(p.ap);
  p.FS = F | 1;
  p.S = S; p.NC = NC; p.RP = round_up(S * F, 16);
  p.scale = scale; p.residual = residual;
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
bool choose_plan(int B, int F, int d, int a, int H, float scale, int residual,
                 Plan* out) {
  for (int nc = kWarps; nc >= 1; --nc) {
    for (int s = kMaxSamples; s >= 1; --s) {
      if (nc > s * H) continue;
      const Plan p = make_plan(B, F, d, a, H, s, nc, scale, residual);
      if (4LL * p.total <= kSmemMax) {
        *out = p;
        return true;
      }
    }
  }
  return false;
}

// ---- products of 16x16 output tiles -----------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One k16 step of a 16x16 tile: c[h] is the f32 accumulator fragment of
// mma.m16n8k16 for columns h*8..h*8+7 (c[h][0..1]: row g, columns 2t, 2t+1;
// c[h][2..3]: row g+8). A(m, k) and B(k, n) read the operands (m, n within
// the tile, k absolute); in bf16 they are rounded to bf16 into the
// fragments (op), in f32 each lane runs the same 8 outputs on the FMA pipes
// in order of k.
template <bool BF16, class LA, class LB>
__device__ __forceinline__ void mma_step(float (&c)[2][4], const LA& A,
                                         const LB& B, int k0, int g, int t) {
  if constexpr (BF16) {
    const int ka = k0 + 2 * t;
    const uint32_t a0 = pack_bf16(A(g, ka), A(g, ka + 1));
    const uint32_t a1 = pack_bf16(A(g + 8, ka), A(g + 8, ka + 1));
    const uint32_t a2 = pack_bf16(A(g, ka + 8), A(g, ka + 9));
    const uint32_t a3 = pack_bf16(A(g + 8, ka + 8), A(g + 8, ka + 9));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = h * 8 + g;
      const uint32_t b0 = pack_bf16(B(ka, n), B(ka + 1, n));
      const uint32_t b1 = pack_bf16(B(ka + 8, n), B(ka + 9, n));
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[h][0]), "+f"(c[h][1]), "+f"(c[h][2]), "+f"(c[h][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const float lo = A(g, k0 + kk);
      const float hi = A(g + 8, k0 + kk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float b0 = B(k0 + kk, h * 8 + 2 * t);
        const float b1 = B(k0 + kk, h * 8 + 2 * t + 1);
        c[h][0] = fmaf(lo, b0, c[h][0]);
        c[h][1] = fmaf(lo, b1, c[h][1]);
        c[h][2] = fmaf(hi, b0, c[h][2]);
        c[h][3] = fmaf(hi, b1, c[h][3]);
      }
    }
  }
}

// fn(row, col, value) for the 8 elements of a lane's fragments (tile-relative)
template <class Fn>
__device__ __forceinline__ void each(float (&c)[2][4], int g, int t, Fn fn) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 4; ++q) fn(g + (q >> 1) * 8, h * 8 + 2 * t + (q & 1), c[h][q]);
  }
}

// Every 16x16 tile of an (mt*16) x (nt*16) output over K (a multiple of
// 16), the warps taking tiles in turn, two at a time (independent
// accumulators, so one tile's loads overlap the other's products; a warp
// with one tile left computes it twice and keeps one). init(row, col)
// gives a fragment element's start value, fin(row, col, v) takes its
// result; rows, columns and A(m, k), B(k, n) are absolute.
template <bool BF16, class LA, class LB, class Init, class Fin>
__device__ __forceinline__ void product(int mt, int nt, int K, const LA& A,
                                        const LB& B, const Init& init,
                                        const Fin& fin, int warp, int g,
                                        int t) {
  const int tiles = mt * nt;
  for (int t0 = warp; t0 < tiles; t0 += 2 * kWarps) {
    const bool two = t0 + kWarps < tiles;
    const int t1 = two ? t0 + kWarps : t0;
    const int m0 = (t0 / nt) * 16, n0 = (t0 % nt) * 16;
    const int m1 = (t1 / nt) * 16, n1 = (t1 % nt) * 16;
    float c0[2][4], c1[2][4];
    each(c0, g, t, [&](int r, int col, float& v) { v = init(m0 + r, n0 + col); });
    each(c1, g, t, [&](int r, int col, float& v) { v = init(m1 + r, n1 + col); });
    const auto A0 = [&](int m, int k) { return A(m0 + m, k); };
    const auto B0 = [&](int k, int n) { return B(k, n0 + n); };
    const auto A1 = [&](int m, int k) { return A(m1 + m, k); };
    const auto B1 = [&](int k, int n) { return B(k, n1 + n); };
    for (int k0 = 0; k0 < K; k0 += 16) {
      mma_step<BF16>(c0, A0, B0, k0, g, t);
      mma_step<BF16>(c1, A1, B1, k0, g, t);
    }
    each(c0, g, t, [&](int r, int col, float& v) { fin(m0 + r, n0 + col, v); });
    if (two) each(c1, g, t, [&](int r, int col, float& v) { fin(m1 + r, n1 + col, v); });
  }
}

// ---- the attention core: M4 float4s (up to 16 floats) of a head at a time,
// M4 a compile-time divisor of the padded head's float4 count (the plan's
// m4), so the chunk loops carry no guards and unroll across keys

template <int M4>
__device__ __forceinline__ void load_chunk(float (&r)[16], const float* p) {
#pragma unroll
  for (int u = 0; u < M4; ++u) {
    const float4 v = reinterpret_cast<const float4*>(p)[u];
    r[4 * u] = v.x; r[4 * u + 1] = v.y; r[4 * u + 2] = v.z; r[4 * u + 3] = v.w;
  }
}

template <int M4>
__device__ __forceinline__ void store_chunk(float* p, const float (&r)[16]) {
#pragma unroll
  for (int u = 0; u < M4; ++u) {
    reinterpret_cast<float4*>(p)[u] =
        make_float4(r[4 * u], r[4 * u + 1], r[4 * u + 2], r[4 * u + 3]);
  }
}

// sum_e r[e] * p[e] in order of e
template <int M4>
__device__ __forceinline__ float dot_chunk(const float (&r)[16], const float* p) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < M4; ++u) {
    const float4 v = reinterpret_cast<const float4*>(p)[u];
    s = fmaf(r[4 * u], v.x, s);
    s = fmaf(r[4 * u + 1], v.y, s);
    s = fmaf(r[4 * u + 2], v.z, s);
    s = fmaf(r[4 * u + 3], v.w, s);
  }
  return s;
}

// acc[e] += w * p[e]
template <int M4>
__device__ __forceinline__ void axpy_chunk(float (&acc)[16], float w, const float* p) {
#pragma unroll
  for (int u = 0; u < M4; ++u) {
    const float4 v = reinterpret_cast<const float4*>(p)[u];
    acc[4 * u] = fmaf(w, v.x, acc[4 * u]);
    acc[4 * u + 1] = fmaf(w, v.y, acc[4 * u + 1]);
    acc[4 * u + 2] = fmaf(w, v.z, acc[4 * u + 2]);
    acc[4 * u + 3] = fmaf(w, v.w, acc[4 * u + 3]);
  }
}

// The head's rows of one sample: q at q0 + i*QS, k at + ap, v at + 2ap;
// ctx (or dctx) at c0 + i*CS.
struct Head {
  float* q0;
  float* c0;
};

// W[j*FS + i] = s_ij, then the softmax over j in place, for query i: the
// lane's own column of the scratch. With dctx, D[j*FS + i] = dctx_i . v_j.
// The maximum is taken as the last chunk's scores land; exp is the SFU's
// (ex2 of x * log2 e, relative error ~1e-6 at these arguments) and the
// normalisation a multiply by 1 / sum: f32 softmax weights within a few
// ulp of e / sum(e).
template <bool WithDw, int M4>
__device__ __forceinline__ void scores_softmax(const Plan& p, const Head& hd,
                                               float* W, float* D, int i) {
  const int F = p.F, FS = p.FS, nch = p.hdp / 4;
  const float* qi = hd.q0 + i * p.QS;
  const float* ci = hd.c0 + i * p.CS;
  float mx = __int_as_float(0xff800000);  // -inf
  for (int c4 = 0; c4 < nch; c4 += M4) {
    const bool first = c4 == 0, last = c4 + M4 >= nch;
    float q[16], dc[16];
    load_chunk<M4>(q, qi + 4 * c4);
    if constexpr (WithDw) load_chunk<M4>(dc, ci + 4 * c4);
    const float* kb = hd.q0 + p.ap + 4 * c4;
    const float* vb = hd.q0 + 2 * p.ap + 4 * c4;
#pragma unroll 4
    for (int j = 0; j < F; ++j) {
      float s = dot_chunk<M4>(q, kb + j * p.QS);
      if (!first) s += W[j * FS + i];
      if (last) {
        s *= p.scale;
        mx = fmaxf(mx, s);
      }
      W[j * FS + i] = s;
      if constexpr (WithDw) {
        float dw = dot_chunk<M4>(dc, vb + j * p.QS);
        if (!first) dw += D[j * FS + i];
        D[j * FS + i] = dw;
      }
    }
  }
  float sum = 0.f;
#pragma unroll 4
  for (int j = 0; j < F; ++j) {
    const float e = __expf(W[j * FS + i] - mx);
    W[j * FS + i] = e;
    sum += e;
  }
  const float inv = 1.f / sum;
#pragma unroll 4
  for (int j = 0; j < F; ++j) W[j * FS + i] *= inv;
}

// out_r = sum_t M[t, r] * row_t for r = this lane's rows (query rows when
// M is indexed [j*FS + i] and summed over j, key rows when summed over i),
// chunk by chunk, each sum in order of t. `ByKey`: M's first index is r.
template <bool ByKey, int M4>
__device__ __forceinline__ void mix_rows(const Plan& p, const float* M,
                                         const float* src, int sstride,
                                         float* dst, int dstride, int lane) {
  const int F = p.F, FS = p.FS, nch = p.hdp / 4;
  for (int r = lane; r < F; r += 32) {
    for (int c4 = 0; c4 < nch; c4 += M4) {
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll 4
      for (int t = 0; t < F; ++t) {
        const float w = ByKey ? M[r * FS + t] : M[t * FS + r];
        axpy_chunk<M4>(acc, w, src + t * sstride + 4 * c4);
      }
      store_chunk<M4>(dst + r * dstride + 4 * c4, acc);
    }
  }
}

// Forward core of one (sample, head): ctx of every query.
template <int M4>
__device__ void core_forward(const Plan& p, const Head& hd, float* W, int lane) {
  for (int i = lane; i < p.F; i += 32) scores_softmax<false, M4>(p, hd, W, nullptr, i);
  // each lane reads only its own column of W
  mix_rows<false, M4>(p, W, hd.q0 + 2 * p.ap, p.QS, hd.c0, p.CS, lane);
}

// Backward core of one (sample, head): [dq|dk|dv] over q/k/v in place; the
// ctx rows hold dctx on entry and are spent.
template <int M4>
__device__ void core_backward(const Plan& p, const Head& hd, float* W,
                              float* D, int lane) {
  const int F = p.F, FS = p.FS;
  for (int i = lane; i < F; i += 32) {
    scores_softmax<true, M4>(p, hd, W, D, i);
    float sdot = 0.f;
#pragma unroll 4
    for (int j = 0; j < F; ++j) sdot += D[j * FS + i] * W[j * FS + i];
#pragma unroll 4
    for (int j = 0; j < F; ++j) {
      D[j * FS + i] = W[j * FS + i] * (D[j * FS + i] - sdot) * p.scale;
    }
  }
  __syncwarp();
  // dv_j = sum_i w_ij dctx_i, into v (read last by the score pass)
  mix_rows<true, M4>(p, W, hd.c0, p.CS, hd.q0 + 2 * p.ap, p.QS, lane);
  __syncwarp();
  // dq_i = sum_j ds_ij k_j, into dctx (read last by dv)
  mix_rows<false, M4>(p, D, hd.q0 + p.ap, p.QS, hd.c0, p.CS, lane);
  __syncwarp();
  // dk_j = sum_i ds_ij q_i, into k (read last by dq)
  mix_rows<true, M4>(p, D, hd.q0, p.QS, hd.q0 + p.ap, p.QS, lane);
  __syncwarp();
  const int nch = p.hdp / 4;
  for (int i = lane; i < F; i += 32) {
    for (int u = 0; u < nch; ++u) {
      reinterpret_cast<float4*>(hd.q0 + i * p.QS)[u] =
          reinterpret_cast<const float4*>(hd.c0 + i * p.CS)[u];
    }
  }
  __syncwarp();  // the scratch is reused by the warp's next pair
}

// The core warps' (sample, head) pairs of a tile of sv samples, forward or
// backward, at the chunk width M4.
template <bool Backward, int M4>
__device__ void core_pairs(const Plan& p, float* qkv, float* ctx, float* W,
                           int sv, int warp, int lane) {
  for (int pi = warp; pi < sv * p.H; pi += p.NC) {
    const int s = pi / p.H, h = pi - s * p.H;
    const Head hd{qkv + s * p.F * p.QS + h * p.hdp, ctx + s * p.F * p.CS + h * p.hdp};
    if constexpr (Backward) {
      core_backward<M4>(p, hd, W, W + p.F * p.FS, lane);
    } else {
      core_forward<M4>(p, hd, W, lane);
    }
  }
}

template <bool Backward>
__device__ void core(const Plan& p, float* qkv, float* ctx, float* W, int sv,
                     int warp, int lane) {
  if (warp >= p.NC) return;
  switch (p.m4) {
    case 4: core_pairs<Backward, 4>(p, qkv, ctx, W, sv, warp, lane); break;
    case 3: core_pairs<Backward, 3>(p, qkv, ctx, W, sv, warp, lane); break;
    case 2: core_pairs<Backward, 2>(p, qkv, ctx, W, sv, warp, lane); break;
    default: core_pairs<Backward, 1>(p, qkv, ctx, W, sv, warp, lane); break;
  }
}

// dst[r * stride + c] = ld(r * d + c) for the n = rows * d elements of a
// tile's rows (element i < valid read, the rest 0), each thread's loads
// issued together so that their latencies overlap
template <class Ld>
__device__ __forceinline__ void load_rows(int n, int valid, int d, int stride,
                                          float* dst, const Ld& ld) {
  constexpr int U = 8;
  for (int base = threadIdx.x; base < n; base += U * kThreads) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < valid ? ld((size_t)i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads;
      if (i < n) {
        const int r = i / d;
        dst[r * stride + (i - r * d)] = v[u];
      }
    }
  }
}

// Padded column of real column j of [q|k|v] (3a), and padded row of real
// row j of wo (a).
__device__ __forceinline__ int qkv_col(const Plan& p, int j) {
  const int z = j / p.a, w = j - z * p.a, h = w / p.hd;
  return z * p.ap + h * p.hdp + (w - h * p.hd);
}
__device__ __forceinline__ int head_row(const Plan& p, int j) {
  const int h = j / p.hd;
  return h * p.hdp + (j - h * p.hd);
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

template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, int smem, int (&smem_set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  return cudaSuccess;
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

// Message for an error code returned by the entry point.
extern "C" const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
