// Shared pieces of the field self-attention block's kernels for Hopper
// (sm_90a): attention_block.cu (the forward) and attention_bwd.cu (the
// backward, which recomputes the forward), and of AutoInt's interacting
// layer in the same two files (its scale a parameter, 1 for AutoInt's
// unscaled scores; its Plan's strides set by its own layout). All walk
// tiles of S samples, S*F consecutive rows padded to a multiple of 16, with
// the weights and the tile's tensors in shared memory:
//  * the tile geometry (Plan): heads padded to a multiple of 4 floats and
//    the [q|k|v] sections and d to a multiple of 16 (zeros, so pads add
//    exact zeros), and row strides that keep an mma fragment's 8 rows on
//    distinct banks; qkv_col / head_row place a weight's real columns and
//    rows in it;
//  * product: a row-wise projection over the tile's rows as 16x16 output
//    tiles that the 8 warps take in turn; in bf16 mma.sync m16n8k16 bf16 ->
//    f32 on the tensor cores, the operands rounded to bf16 on their way
//    from f32 shared memory into the fragments; in f32 the same tiles on
//    the FP32 pipes (no TF32), each lane computing the 8 outputs its
//    fragment would hold, in order of k;
//  * the attention core on the FP32 pipes, one warp per (sample, head) and
//    one lane per field (lanes wrap for F > 32): scores_softmax, mix_rows,
//    core_forward and core_backward (attention_bwd.cu's head note has the
//    design);
//  * the tiled core's pieces (each_tile, tiled_scores, mix_tile, ToRows,
//    tiled_softmax, tiled_softmax_adjoint), which only the interacting
//    layer's backward calls: every pair of a tile at once, a register tile
//    of outputs a thread, each sum in the lane-per-query core's order;
//  * prefetch_l2, a hint that brings device memory into L2 ahead of use;
//  * load_rows, a tile's rows from device memory with each thread's loads
//    in flight together.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attention_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;  // dynamic shared memory of a block, at most
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
  // shared-memory regions, in floats from the start (each kernel sets
  // those it uses)
  int o_wo, o_bqkv, o_bo, o_ls, o_lb, o_dw, o_dwo, o_db, o_x, o_y, o_dout,
      o_qkv, o_ctx, o_scr, o_stats, o_d, total;
};

// The geometry of a tile of S samples with NC core warps.
inline Plan plan_geometry(int B, int F, int d, int a, int H, int S, int NC,
                          float scale, int residual) {
  Plan p = {};
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
  return p;
}

// ---- products of 16x16 output tiles ---------------------------------------

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

// ---- the tiled core (AutoInt's interacting backward, attention_bwd.cu):
// every (sample, head) pair of a tile at once over all the block's
// threads, each thread a register tile of kTm rows by TN columns of one
// pair's product, so each value it reads from shared memory feeds kTm or
// TN FMAs where the lane-per-query core above feeds one. Each output's sum
// runs in the order that core takes it: an F x F product (q_i . k_j or
// dctx_i . v_j) as chunks of 4*M4 floats, each an fmaf chain from 0 in
// order of e, the chunks added in order; an F x hdp product
// (sum_t M[t, r] row_t) as an fmaf chain over t from 0. A pair's two F x F
// matrices lie in two areas of the scratch, W (softmax) at W + pr*F*FS and
// D (dw, then ds) at D + pr*F*FS, element (query i, key j) at j*FS + i.
// Bounds of the paper's shape (F = 39, 4 pairs a tile):
// a row block of 5 makes 8 blocks of 40 rows, 256 threads a product.

constexpr int kTm = 5;

// body(pair, r0, c0) for every (pair, kTm-row block, TN-column block) of
// `pairs` R x C outputs, the block's threads taking them in turn: a
// quarter-warp takes 8 row blocks of one column block
template <int TN, class Body>
__device__ __forceinline__ void each_tile(int pairs, int R, int C, const Body& body) {
  const int tr = (R + kTm - 1) / kTm;
  const int per = tr * ((C + TN - 1) / TN);
  for (int u = threadIdx.x; u < pairs * per; u += kThreads) {
    const int pr = u / per, w = u - pr * per, cb = w / tr;
    body(pr, (w - cb * tr) * kTm, cb * TN);
  }
}

// Pair pr = (sample s, head h): its head's columns in the tile's rows
// (stride `stride`, first row of sample 0 at `base`)
__device__ __forceinline__ float* pair_at(const Plan& p, float* base, int stride, int pr) {
  const int s = pr / p.H;
  return base + s * p.F * stride + (pr - s * p.H) * p.hdp;
}

// M[j*FS + i] = (sum_e a_i[e] b_j[e]) (* scale) for every pair, a_i at
// row i of the pair's columns at `ao` in rows, b_j at `bo`; pair pr's M at
// M + pr*F*FS
template <int M4, bool Scale>
__device__ __forceinline__ void tiled_scores(const Plan& p, int pairs, float* rows,
                                             int ao, int bo, float* M) {
  const int F = p.F, QS = p.QS, FS = p.FS, nch = p.hdp / 4;
  each_tile<kTm>(pairs, F, F, [&](int pr, int i0, int j0) {
    const float* base = pair_at(p, rows, QS, pr);
    const float* a[kTm];
    const float* b[kTm];
#pragma unroll
    for (int u = 0; u < kTm; ++u) {
      a[u] = base + ao + min(i0 + u, F - 1) * QS;
      b[u] = base + bo + min(j0 + u, F - 1) * QS;
    }
    float tot[kTm][kTm] = {};
    for (int c4 = 0; c4 < nch; c4 += M4) {
      float acc[kTm][kTm] = {};
#pragma unroll
      for (int w = 0; w < M4; ++w) {
        float4 av[kTm], bv[kTm];
#pragma unroll
        for (int u = 0; u < kTm; ++u) {
          av[u] = reinterpret_cast<const float4*>(a[u])[c4 + w];
          bv[u] = reinterpret_cast<const float4*>(b[u])[c4 + w];
        }
#pragma unroll
        for (int u = 0; u < kTm; ++u) {
#pragma unroll
          for (int v = 0; v < kTm; ++v) acc[u][v] = fmaf(av[u].x, bv[v].x, acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kTm; ++u) {
#pragma unroll
          for (int v = 0; v < kTm; ++v) acc[u][v] = fmaf(av[u].y, bv[v].y, acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kTm; ++u) {
#pragma unroll
          for (int v = 0; v < kTm; ++v) acc[u][v] = fmaf(av[u].z, bv[v].z, acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kTm; ++u) {
#pragma unroll
          for (int v = 0; v < kTm; ++v) acc[u][v] = fmaf(av[u].w, bv[v].w, acc[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < kTm; ++u) {
#pragma unroll
        for (int v = 0; v < kTm; ++v) tot[u][v] = c4 == 0 ? acc[u][v] : acc[u][v] + tot[u][v];
      }
    }
    float* m = M + pr * F * FS;
#pragma unroll
    for (int u = 0; u < kTm; ++u) {
#pragma unroll
      for (int v = 0; v < kTm; ++v) {
        if (i0 + u < F && j0 + v < F) {
          m[(j0 + v) * FS + i0 + u] = Scale ? tot[u][v] * p.scale : tot[u][v];
        }
      }
    }
  });
}

// out_r = sum_t M[t*FS + r] src_t (M[r*FS + t] with ByKey) for kTm rows
// from r0 and TN columns from c0 of one pair; out(u, v) takes row r0 + u's
// TN sums (rows below F only)
template <bool ByKey, int TN, class Out>
__device__ __forceinline__ void mix_tile(const Plan& p, const float* M, const float* src,
                                         int sstride, int r0, int c0, const Out& out) {
  const int F = p.F, FS = p.FS, mt = ByKey ? 1 : FS;
  int mr[kTm];
#pragma unroll
  for (int u = 0; u < kTm; ++u) {
    const int r = min(r0 + u, F - 1);
    mr[u] = ByKey ? r * FS : r;
  }
  float acc[kTm][TN] = {};
  src += c0;
#pragma unroll 2
  for (int t = 0; t < F; ++t) {
    float m[kTm], s[TN];
#pragma unroll
    for (int u = 0; u < kTm; ++u) m[u] = M[mr[u] + t * mt];
#pragma unroll
    for (int w = 0; w < TN / 4; ++w) {
      const float4 v = reinterpret_cast<const float4*>(src + t * sstride)[w];
      s[4 * w] = v.x; s[4 * w + 1] = v.y; s[4 * w + 2] = v.z; s[4 * w + 3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < kTm; ++u) {
#pragma unroll
      for (int e = 0; e < TN; ++e) acc[u][e] = fmaf(m[u], s[e], acc[u][e]);
    }
  }
#pragma unroll
  for (int u = 0; u < kTm; ++u) {
    if (r0 + u < F) out(u, acc[u]);
  }
}

// mix_tile's plain output: TN columns from c0 of rows from r0 of dst
template <int TN>
struct ToRows {
  float* dst;
  int stride, r0, c0;
  __device__ __forceinline__ void operator()(int u, const float (&v)[TN]) const {
#pragma unroll
    for (int w = 0; w < TN / 4; ++w) {
      reinterpret_cast<float4*>(dst + (r0 + u) * stride + c0)[w] =
          make_float4(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
    }
  }
};

// A thread's row of the F x F scratch is read kRow elements at a time, the
// loads issued together (the row's stores would otherwise keep each load
// behind the last store), and taken in order of j
constexpr int kRow = 8;

// Rows of up to kRowMax keys are read into registers once (all loads in
// flight together); longer rows take three passes over the scratch
constexpr int kRowMax = 40;

// The softmax over the keys of every (pair, query) row of the pairs' W, in
// place, a thread a row: scores_softmax's steps (the maximum, then exp of
// the difference summed in order of j, then a multiply by 1 / sum)
__device__ __forceinline__ void tiled_softmax(const Plan& p, int pairs, float* Wall) {
  const int F = p.F, FS = p.FS;
  if (F <= kRowMax) {
    for (int r = threadIdx.x; r < pairs * F; r += kThreads) {
      float* W = Wall + (r / F) * F * FS + r % F;
      float e[kRowMax];
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int j = 0; j < kRowMax; ++j) e[j] = j < F ? W[j * FS] : mx;
#pragma unroll
      for (int j = 0; j < kRowMax; ++j) mx = fmaxf(mx, e[j]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRowMax; ++j) {
        if (j < F) {
          e[j] = __expf(e[j] - mx);
          sum += e[j];
        }
      }
      const float inv = 1.f / sum;
#pragma unroll
      for (int j = 0; j < kRowMax; ++j) {
        if (j < F) W[j * FS] = e[j] * inv;
      }
    }
    return;
  }
  for (int r = threadIdx.x; r < pairs * F; r += kThreads) {
    float* W = Wall + (r / F) * F * FS + r % F;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j0 = 0; j0 < F; j0 += kRow) {
      float e[kRow];
#pragma unroll
      for (int u = 0; u < kRow; ++u) e[u] = j0 + u < F ? W[(j0 + u) * FS] : mx;
#pragma unroll
      for (int u = 0; u < kRow; ++u) mx = fmaxf(mx, e[u]);
    }
    float sum = 0.f;
    for (int j0 = 0; j0 < F; j0 += kRow) {
      float e[kRow];
#pragma unroll
      for (int u = 0; u < kRow; ++u) e[u] = j0 + u < F ? W[(j0 + u) * FS] : 0.f;
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        if (j0 + u < F) {
          e[u] = __expf(e[u] - mx);
          W[(j0 + u) * FS] = e[u];
          sum += e[u];
        }
      }
    }
    const float inv = 1.f / sum;
    for (int j0 = 0; j0 < F; j0 += kRow) {
      float e[kRow];
#pragma unroll
      for (int u = 0; u < kRow; ++u) e[u] = j0 + u < F ? W[(j0 + u) * FS] : 0.f;
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        if (j0 + u < F) W[(j0 + u) * FS] = e[u] * inv;
      }
    }
  }
}

// The softmax's adjoint of every (pair, query) row, D = dw in, ds out, a
// thread a row: core_backward's steps (sdot = sum_j dw * w in order of j,
// then ds = w * (dw - sdot) * scale)
__device__ __forceinline__ void tiled_softmax_adjoint(const Plan& p, int pairs,
                                                      const float* Wall, float* Dall) {
  const int F = p.F, FS = p.FS;
  for (int r = threadIdx.x; r < pairs * F; r += kThreads) {
    const int at = (r / F) * F * FS + r % F;
    const float* W = Wall + at;
    float* D = Dall + at;
    float sdot = 0.f;
    for (int j0 = 0; j0 < F; j0 += kRow) {
      float dv[kRow], wv[kRow];
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        dv[u] = j0 + u < F ? D[(j0 + u) * FS] : 0.f;
        wv[u] = j0 + u < F ? W[(j0 + u) * FS] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        if (j0 + u < F) sdot += dv[u] * wv[u];
      }
    }
    for (int j0 = 0; j0 < F; j0 += kRow) {
      float dv[kRow], wv[kRow];
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        dv[u] = j0 + u < F ? D[(j0 + u) * FS] : 0.f;
        wv[u] = j0 + u < F ? W[(j0 + u) * FS] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        if (j0 + u < F) D[(j0 + u) * FS] = wv[u] * (dv[u] - sdot) * p.scale;
      }
    }
  }
}

// Ask L2 for the 128-byte lines of `bytes` bytes from `ptr`, the block's
// threads a line each (a hint: nothing waits for it)
__device__ __forceinline__ void prefetch_l2(const void* ptr, size_t bytes) {
  const char* c = static_cast<const char*>(ptr);
  for (size_t o = threadIdx.x * 128; o < bytes; o += kThreads * 128) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
  }
  if (threadIdx.x == 0 && bytes > 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(c + bytes - 1));
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

}  // namespace attention_tile
