// CIN-stack backward for Hopper (sm_90a): the adjoints of the whole
// Compressed Interaction Network stack of xDeepFM.
//
// Replaces deepfm_tpu/ops/pallas/cin_stack_kernel.py ::
// make_cin_stack_pallas.backward_pallas / _stack_bwd_kernel. Given x0
// (B, F, D), the weights, biases and the pooled output's cotangent g
// (B, sum(direct)), it returns dx0 (B, F, D), dW_i (M_i, H_i*F) and
// db_i (M_i,), walking the layers last to first:
//
//   dcomp = [g broadcast over d | dhid_next]   (split-half; a sum without)
//   dcomp *= (comp > 0)
//   db   += sum_{b,d} dcomp
//   dW   += sum_{b,d} dcomp[m] * outer[(h,f)],  outer = hid[h] * x0[f]
//   A     = W^T dcomp;  dhid = sum_f A * x0;  dx0 += sum_h A * hid
//
// and at layer 0, where hid = x0, dhid is folded into dx0.
//
// What bounds it on this card: operations. At the xDeepFM bench shape
// (B=16384, F=27, D=16, [128,128] split) it is three forwards' products
// (the remat, dW and A), ~500 GFLOP, against ~0.4 GB of device memory
// traffic. This is the f32 instance, on the FP32 FMA pipes (67 TFLOP/s on
// the data sheet); the bf16 operand mode runs on the tensor cores in
// csrc/cin_stack_bwd_mma.cu.
//
// Design: three steps, no float atomics, so two launches give the same bits.
//
//  1. cin_bwd_tile_kernel, one block per tile of tile_b samples (columns
//     n = b_local*D + d, padded to nt, as in the forward): recompute every
//     layer's comp in shared memory (remat, as the TPU kernel does:
//     stashing the comps from the forward would cost B*sum(M_i)*D*4 bytes,
//     268 MB at the bench shape, and a round trip through device memory)
//     with the forward's own layer routine (cin_stack.cuh, layer_product),
//     so the remat's comps and ReLU masks are the forward's bit for bit;
//     keep of each but the last layer only its hidden rows and the sign
//     bits of its maps, and of the last its comp. Then walk the layers
//     backward: dcomp in shared memory; A = W^T dcomp in chunks of hc
//     hidden rows (arows = round_up(hc*F, 8) rows of A in shared memory,
//     over the remat's stage region), as 8 x 8 register cells whose
//     weights arrive by cp.async, mc maps a stage, one stage ahead; from
//     each chunk the dx0 contribution, then dhid, written over the
//     layer's hidden rows (nothing reads them again), in a fixed order.
//     dx0 leaves the block once. dcomp and each hidden state are written
//     to device memory for step 2, and the tile's per-map sums of dcomp
//     (its db share) to a partial buffer. The plan (tile, threads, kc, hc,
//     mc) is ops/kernels/cin_stack.py::fp32_backward_plan, recomputed
//     below.
//  2. cin_dw_kernel: each dW_i is a product over K = B*D,
//     dW[m, (h,f)] = sum_k dcomp[m, k] * hid[h, k] * x0[f, k], with the
//     outer product formed on the fly from hid and x0. The TPU sums dW in
//     one output block that its sequential grid revisits; on Hopper a
//     partial dW per sample tile would be 1.26 MB each (5.2 GB at the bench
//     shape), so instead each block owns a 128 (maps) x 128 (outer rows)
//     tile of dW over one of S_i fixed chunks of K (split-K), and writes
//     its partial: 8 x 8 register cells over steps of 32 columns of K in
//     two stages (dcomp by cp.async, the outer product formed from hid and
//     x0 one step ahead). S_i is chosen per layer from the SM count and
//     the layer's dW grid (dw_splits), so that a small layer or a small
//     batch still fills the card.
//  3. sum_splits_kernel adds the S_i partials of each dW element in order;
//     db_reduce_kernel adds the tiles' db partials of each map in a fixed
//     tree. The partition depends only on the shapes and the SM count.
//
#include <climits>

#include "cin_stack.cuh"

namespace {

using namespace cin;

constexpr int kKC = 32;      // K (= b*D + d) columns per step of the dW product
constexpr int kDwM = 128;    // maps per dW tile
constexpr int kDwN = 128;    // outer rows (h, f) per dW tile
constexpr int kDwThreads = 256;
constexpr int kDwBlocksPerSm = 2;  // the dW kernel's blocks an SM
constexpr int kSplitColumns = 512;  // K columns a split, at least
constexpr int kMaxSplits = 64;
constexpr int kMaxRegs = 255;  // registers a thread: the tile kernel's bounds (256, 1)
constexpr int kMaxStage = 32;  // maps a weight stage of A, at most
constexpr int kReduceThreads = 256;

struct BwdLayers {
  const float* wm[kMaxLayers];  // (M_i, kpad_i) m-major by chunks
  int kpad[kMaxLayers];        // ceil(H_i / hc) * round_up(hc * F, 8)
  int off[kMaxLayers];         // first map of layer i in the stacked maps
  int hoff[kMaxLayers];        // first row of layer i's hidden state (i > 0)
};

// The tile kernel's plan: the caller's (tile_b, threads, kc, hc, mc) and
// what follows from them.
struct Plan {
  int tile_b, nt, threads, kc, hc, mc;
  int wpitch, arows, apitch, region, words, smem;
};

// Shape totals of the stack: hsum (hidden rows of layers 1..n-1), mmax,
// msum.
struct Totals {
  int hsum, mmax, msum;
};

Totals totals(const int* m, const int* next, int n_layers) {
  Totals t{0, 0, 0};
  for (int l = 0; l < n_layers; ++l) {
    if (l > 0) t.hsum += next[l - 1];
    t.mmax = imax(t.mmax, m[l]);
    t.msum += m[l];
  }
  return t;
}

// The tile kernel's layout (floats, rows of nt unless noted):
//   xs F, hids hsum (layer i's dhid is written over its hidden rows once
//   they are read), dcs mmax, dx0s F,
//   region: the remat's stage region, or one chunk of A (arows rows) and
//           two weight stages of mc rows of apitch,
//   masks (msum - M_last) * words uint32.
bool layout(int F, int D, const int* m, const int* mpad, const int* next,
            int n_layers, int tile_b, int kc, int hc, int mc, Plan* p) {
  const Totals T = totals(m, next, n_layers);
  const int nt = round_up(tile_b * D, 8);
  const int cx = nt / 8;
  const int arows = round_up(hc * F, 8);
  int gmax = arows / 8;
  for (int l = 0; l < n_layers; ++l) gmax = imax(gmax, mpad[l] / 8);
  const int threads = imin(kMaxThreads, round_up(gmax * cx, 32));
  int wgroups = 0, cols = 0;
  for (int l = 0; l < n_layers; ++l) {
    const Passes P = passes_of(mpad[l] / 8, cx, threads);
    wgroups = imax(wgroups, P.groups);
    cols = P.cols;
  }
  const Passes A = passes_of(arows / 8, cx, threads);
  const int stage = product_stage_floats(kc, 8 * wgroups, cols);
  const long long adj = (long long)arows * nt + 2LL * mc * 8 * A.groups;
  const long long region = stage > adj ? stage : adj;
  const int words = ceil_div(nt, 32);
  const long long floats = (long long)(2 * F + T.hsum + T.mmax) * nt + region +
                           (long long)(T.msum - m[n_layers - 1]) * words;
  if (4 * floats > kSmemPerBlock) return false;
  *p = {tile_b, nt, threads, kc, hc, mc, 8 * wgroups, arows, 8 * A.groups,
        (int)region, words, (int)(4 * floats)};
  return true;
}

// fp32_backward_plan's search: each candidate tile (as the forward's),
// hidden rows a chunk of A (hc, 8 down to 1), maps a weight stage of A
// (mc: 32, 16, 8, 4, 2, 1) and K rows a chunk of the remat (kc: 32, 16,
// .., 1); of those that fit, the least launch_cost, the first on a tie. A
// block's work in k steps, each layer: the remat's passes x (K and
// kChunkSteps a chunk), and A's chunks x passes x (M and kChunkSteps a
// weight stage).
bool make_plan(int batch, int F, int D, const int* m, const int* mpad,
               const int* next, int n_layers, int sms, Plan* out) {
  double best = -1.0;
  auto consider = [&](int tb, int kc, int hc, int mc) {
    Plan p;
    if (!layout(F, D, m, mpad, next, n_layers, tb, kc, hc, mc, &p)) return;
    const Passes A = passes_of(p.arows / 8, p.nt / 8, p.threads);
    double work = 0.0;
    int H = F;
    for (int l = 0; l < n_layers; ++l) {
      const Passes P = passes_of(mpad[l] / 8, p.nt / 8, p.threads);
      work += (double)P.n * (H * F + ceil_div(H * F, kc) * kChunkSteps);
      work += (double)ceil_div(H, hc) * A.n * (m[l] + ceil_div(m[l], mc) * kChunkSteps);
      H = next[l];
    }
    const int bps = blocks_per_sm(p.threads, p.smem, kMaxRegs);
    if (bps < 1) return;
    const double cost =
        launch_cost(((long long)batch + tb - 1) / tb, sms, bps, p.threads, work);
    if (best < 0.0 || cost < best) {
      best = cost;
      *out = p;
    }
  };
  int last_tb = 0;
  for (int cols = 128; cols >= 8; cols /= 2) {
    const int tb = imax(1, imin(batch, cols / D));
    if (tb == last_tb) continue;
    last_tb = tb;
    for (int hc = 8; hc >= 1; --hc)
      for (int mc = kMaxStage; mc >= 1; mc /= 2)
        for (int kc = kMaxChunk; kc >= 1; kc /= 2) consider(tb, kc, hc, mc);
  }
  return best >= 0.0;
}

// dW splits of one layer: of 1 .. min(kMaxSplits, K / kSplitColumns)
// splits, a split's columns a multiple of kKC, the one whose rounds of the
// dW grid (tiles of kDwM maps by kDwN outer rows, times the splits) over
// the card's slots times a split's columns is least, the fewest on a tie.
// *chunk is a split's columns.
int dw_splits(int M, int HF, int K, int sms, int* chunk) {
  const long long tiles = (long long)ceil_div(HF, kDwN) * ceil_div(M, kDwM);
  const long long slots = (long long)sms * kDwBlocksPerSm;
  const int most = imin(kMaxSplits, imax(1, K / kSplitColumns));
  long long best = -1;
  for (int s = 1; s <= most; ++s) {
    const int c = round_up(ceil_div(K, s), kKC);
    const long long cost = (tiles * ceil_div(K, c) + slots - 1) / slots * c;
    if (best < 0 || cost < best) {
      best = cost;
      *chunk = c;
    }
  }
  return ceil_div(K, *chunk);
}

// A[r, n] = sum_m Wm[m, k0 + r] * dcs[m, n] for the arows rows r of one
// chunk of hc hidden rows (each chunk's columns of Wm zero-padded to
// arows, so each row group's 8 weights are 16-byte aligned) and every
// column n, into As (arows rows of nt): the layer product's cells and
// passes, the weights of mc maps at a time staged by cp.async one step
// ahead, each output summed over m in order from 0.
__device__ void adjoint_chunk(const Plan p, const float* __restrict__ wm, int kpad,
                              int k0, const float* dcs, int M, float* As, float* wst) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int cx = p.nt / 8;
  const Passes P = passes_of(p.arows / 8, cx, threads);
  const int steps = ceil_div(M, p.mc);
  for (int g0 = 0; g0 < p.arows / 8; g0 += P.groups) {
    const int ng = imin(P.groups, p.arows / 8 - g0);
    for (int c0 = 0; c0 < cx; c0 += P.cols) {
      const int nc = imin(P.cols, cx - c0);
      const int half = 4 * nc, col0 = 8 * c0;
      auto copy_weights = [&](int s) {
        const int m0 = s * p.mc;
        const int rows = imin(p.mc, M - m0);
        const int pieces = 2 * ng;
        const float* src = wm + (size_t)m0 * kpad + k0 + 8 * g0;
        float* dst = wst + (s & 1) * p.mc * p.apitch;
        for (int i = tid; i < rows * pieces; i += threads) {
          const int r = i / pieces;
          const int q = i - r * pieces;
          cp_async16(dst + r * p.apitch + 4 * q, src + (size_t)r * kpad + 4 * q);
        }
      };
      const bool on = tid < ng * nc;
      const int cg = on ? tid / nc : 0;
      const int cc = on ? tid - cg * nc : 0;
      float acc[8][8];
      zero_cell(acc);
      copy_weights(0);
      cp_async_commit();
      for (int s = 0; s < steps; ++s) {
        cp_async_wait_all();
        __syncthreads();
        if (s + 1 < steps) copy_weights(s + 1);
        cp_async_commit();
        if (on) {
          const int m0 = s * p.mc;
          cell_product<kMaxStage>(acc, wst + (s & 1) * p.mc * p.apitch + cg * 8,
                                      p.apitch, dcs + (size_t)m0 * p.nt + col0 + cc * 4,
                                      p.nt, half, imin(p.mc, M - m0));
        }
      }
      __syncthreads();  // the stages are free for the next pass
      if (on) {
        const float no_bias[8] = {};
        store_cell(acc, no_bias, false, As + (size_t)(8 * (g0 + cg)) * p.nt + col0 + cc * 4,
                   p.nt, half, 0, 8);
      }
    }
  }
}

// The tile kernel (shared memory as in `layout`). The remat runs every
// layer through layer_product, the forward's own routine, so its comps and
// ReLU masks are the forward's bit for bit: of each layer but the last it
// keeps only the hidden rows and the sign bits of its maps; the last
// layer's comp is recomputed into dcs when the walk starts there.
__global__ void __launch_bounds__(kMaxThreads, 1)
cin_bwd_tile_kernel(const float* __restrict__ x0, const float* __restrict__ g,
                    const Layers layers, const BwdLayers bl,
                    const int n_layers, const int batch, const int F,
                    const int D, const Plan p, const Totals T,
                    const int out_dim, float* __restrict__ dx0,
                    float* __restrict__ dcomp, float* __restrict__ hid_out,
                    float* __restrict__ db_part) {
  extern __shared__ __align__(16) float smem[];
  const int nt = p.nt;
  const int NT = blockDim.x;
  const int words = p.words;
  float* const xs = smem;
  float* const hids = xs + (size_t)F * nt;
  float* const dcs = hids + (size_t)T.hsum * nt;
  float* const dx0s = dcs + (size_t)T.mmax * nt;
  float* const region = dx0s + (size_t)F * nt;
  uint32_t* const masks = reinterpret_cast<uint32_t*>(region + p.region);
  float* const As = region;
  float* const wst = region + (size_t)p.arows * nt;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * p.tile_b;
  const int nb = min(p.tile_b, batch - b0);
  const int ncol = nb * D;  // real columns of the tile
  const long long K = (long long)batch * D;
  const long long kcol = (long long)b0 * D;
  const int last = n_layers - 1;

  stage_x0(x0, xs, b0, nb, F, D, nt);
  for (int i = tid; i < F * nt; i += NT) dx0s[i] = 0.f;
  __syncthreads();

  const Tile t{xs, F, nt, p.kc, region, p.region, p.wpitch};
  // ---- remat of every layer: masks and hidden rows; the last one's comp --
  for (int l = 0; l <= last; ++l) {
    const int M = layers.m[l];
    const int H = l == 0 ? F : layers.next[l - 1];
    const float* hid = l == 0 ? xs : hids + (size_t)bl.hoff[l] * nt;
    const int first_next = M - layers.next[l];
    uint32_t* mk = masks + (size_t)bl.off[l] * words;
    float* hnext = hids + (size_t)(l < last ? bl.hoff[l + 1] : 0) * nt;
    layer_product(t, hid, H, layers.w[l], layers.bias[l], M, layers.mpad[l],
                  [&](int m0, int rows, int col0, int width, const float* buf) {
      if (l == last) {  // the last layer's comp, into dcs
        for (int i = tid; i < rows * width; i += NT) {
          const int r = i / width;
          const int s = i - r * width;
          dcs[(size_t)(m0 + r) * nt + col0 + s] = buf[i];
        }
        return;
      }
      // sign bits of the window's columns: word w covers columns 32w..
      const int w0 = col0 / 32;
      const int nw = (col0 + width - 1) / 32 - w0 + 1;
      for (int i = tid; i < rows * nw; i += NT) {
        const int r = i / nw;
        const int w = w0 + (i - r * nw);
        const int lo = max(32 * w, col0);
        const int hi = min(32 * w + 32, col0 + width);
        uint32_t bits = 0;
        for (int n = lo; n < hi; ++n) {
          bits |= (uint32_t)(buf[(size_t)r * width + n - col0] > 0.f) << (n - 32 * w);
        }
        uint32_t* word = mk + (size_t)(m0 + r) * words + w;
        *word = 32 * w < col0 ? *word | bits : bits;
      }
      const int lo = max(m0, first_next);
      const int cnt = (m0 + rows - lo) * width;
      for (int i = tid; i < cnt; i += NT) {
        const int r = i / width;
        const int s = i - r * width;
        hnext[(size_t)(lo - first_next + r) * nt + col0 + s] =
            buf[(size_t)(lo - m0 + r) * width + s];
      }
    });
  }

  // ---- adjoints, last layer first ---------------------------------------
  for (int l = last; l >= 0; --l) {
    const int M = layers.m[l];
    const int dir = layers.direct[l];
    const int col = layers.col[l];
    const bool split = dir < M;
    const bool has_next = l < last;
    const int H = l == 0 ? F : layers.next[l - 1];
    const float* hid = l == 0 ? xs : hids + (size_t)bl.hoff[l] * nt;
    const uint32_t* mk = masks + (size_t)bl.off[l] * words;
    float* dcomp_l = dcomp + (size_t)bl.off[l] * K;
    // dhid of the layer above, over its hidden rows
    const float* dhid = has_next ? hids + (size_t)bl.hoff[l + 1] * nt : nullptr;

    // dcomp, masked by comp > 0; zero in the padding columns
    for (int i = tid; i < M * nt; i += NT) {
      const int m = i / nt;
      const int n = i - m * nt;
      float v = 0.f;
      if (n < ncol) {
        const int b = b0 + n / D;
        const float gv = m < dir ? g[(size_t)b * out_dim + col + m] : 0.f;
        if (split) {
          v = m < dir ? gv : dhid[(size_t)(m - dir) * nt + n];
        } else {
          v = has_next ? gv + dhid[(size_t)m * nt + n] : gv;
        }
        const bool alive = l == last ? dcs[i] > 0.f
                                     : (mk[m * words + n / 32] >> (n % 32)) & 1u;
        if (!alive) v = 0.f;
        dcomp_l[(size_t)m * K + kcol + n] = v;
      }
      dcs[i] = v;
    }
    // this layer's hidden state, for the dW product
    if (l > 0) {
      float* hid_l = hid_out + (size_t)bl.hoff[l] * K;
      for (int i = tid; i < H * nt; i += NT) {
        const int h = i / nt;
        const int n = i - h * nt;
        if (n < ncol) hid_l[(size_t)h * K + kcol + n] = hid[i];
      }
    }
    __syncthreads();

    // the tile's share of db, summed over its columns in order (f32)
    for (int m = tid; m < M; m += NT) {
      const float* row = dcs + (size_t)m * nt;
      float s = 0.f;
      for (int n = 0; n < ncol; ++n) s += row[n];
      db_part[(size_t)blockIdx.x * T.msum + bl.off[l] + m] = s;
    }

    // A = W^T dcomp by chunks of hc hidden rows; from each, dx0's share
    // (sum over the chunk's h of A * hid), then dhid (sum over f of A *
    // x0) over the chunk's hidden rows, which nothing reads again; layer
    // 0's hidden state is x0, so its dhid is added to dx0
    float* const hid_w = l == 0 ? dx0s : hids + (size_t)bl.hoff[l] * nt;
    for (int h0 = 0; h0 < H; h0 += p.hc) {
      adjoint_chunk(p, bl.wm[l], bl.kpad[l], h0 / p.hc * p.arows, dcs, M, As, wst);
      __syncthreads();
      // four columns a thread: float4 rows of nt / 4
      const int hc = min(p.hc, H - h0);
      const int nq = nt / 4;
      const float4* A4 = reinterpret_cast<const float4*>(As);
      const float4* h4 = reinterpret_cast<const float4*>(hid + (size_t)h0 * nt);
      const float4* x4 = reinterpret_cast<const float4*>(xs);
      for (int i = tid; i < F * nq; i += NT) {
        const int f = i / nq;
        const int q = i - f * nq;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int hl = 0; hl < hc; ++hl) {
          const float4 a = A4[((size_t)hl * F + f) * nq + q];
          const float4 h = h4[(size_t)hl * nq + q];
          s = make_float4(fmaf(a.x, h.x, s.x), fmaf(a.y, h.y, s.y), fmaf(a.z, h.z, s.z),
                          fmaf(a.w, h.w, s.w));
        }
        float4* d = reinterpret_cast<float4*>(dx0s) + i;
        const float4 o = *d;
        *d = make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w);
      }
      __syncthreads();
      for (int i = tid; i < hc * nq; i += NT) {
        const int hl = i / nq;
        const int q = i - hl * nq;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int f = 0; f < F; ++f) {
          const float4 a = A4[((size_t)hl * F + f) * nq + q];
          const float4 x = x4[(size_t)f * nq + q];
          s = make_float4(fmaf(a.x, x.x, s.x), fmaf(a.y, x.y, s.y), fmaf(a.z, x.z, s.z),
                          fmaf(a.w, x.w, s.w));
        }
        float4* o = reinterpret_cast<float4*>(hid_w + (size_t)(h0 + hl) * nt) + q;
        if (l == 0) {
          const float4 v = *o;
          s = make_float4(v.x + s.x, v.y + s.y, v.z + s.z, v.w + s.w);
        }
        *o = s;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < F * nt; i += NT) {
    const int f = i / nt;
    const int n = i - f * nt;
    if (n < ncol) {
      const int bl_ = n / D;
      dx0[((size_t)(b0 + bl_) * F + f) * D + (n - bl_ * D)] = dx0s[i];
    }
  }
}

// One split of dW for one layer: dw_part[s, m, (h,f)] = sum over the
// split's K columns of dcomp[m, k] * hid[h, k] * x0[f, k], hid = x0 at
// layer 0 (hid == nullptr); a block owns kDwM maps by kDwN outer rows. K
// is walked in steps of kKC columns through two stages: a step's dcomp
// columns arrive by cp.async, transposed to [k][m], and its outer product
// is formed from hid and x0 loaded into registers, both one step ahead of
// the product; each output is summed over the split's columns in order.
__global__ void __launch_bounds__(kDwThreads, kDwBlocksPerSm)
cin_dw_kernel(const float* __restrict__ dcomp, const float* __restrict__ hid,
              const float* __restrict__ x0, float* __restrict__ dw_part,
              const int M, const int H, const int F, const int D,
              const int K, const int chunk) {
  constexpr int kWarps = kDwThreads / 32;
  constexpr int kRA = kDwM / kWarps;  // dcomp rows a warp copies a step
  constexpr int kRB = kDwN / kWarps;  // outer rows a warp forms a step
  constexpr int kAP = kDwM + 4;       // row pitches of the stages
  constexpr int kBP = kDwN + 4;
  extern __shared__ __align__(16) float dw_smem[];
  float* const dcs = dw_smem;                // [2][kKC][kAP]
  float* const ous = dcs + 2 * kKC * kAP;    // [2][kKC][kBP]
  const int HF = H * F;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % (kDwN / 8);
  const int ty = tid / (kDwN / 8);
  const int m0 = blockIdx.y * kDwM;
  const int n0 = blockIdx.x * kDwN;
  const int s = blockIdx.z;
  const int kb0 = s * chunk;
  const int ke = min(K, kb0 + chunk);

  // dcomp of step kb into stage st, lane = column k - kb (zero past the
  // split or the maps)
  auto copy_dcomp = [&](int kb, int st) {
    const int k = kb + lane;
    float* dst = dcs + st * kKC * kAP + lane * kAP;
#pragma unroll
    for (int r = 0; r < kRA; ++r) {
      const int i = warp + kWarps * r;
      if (k < ke && m0 + i < M) {
        cp_async4(dst + i, dcomp + (size_t)(m0 + i) * K + k);
      } else {
        dst[i] = 0.f;
      }
    }
  };
  // x0 and the hidden state of the outer rows of step kb, lane = k - kb
  float rx[kRB], rh[kRB];
  auto fetch = [&](int kb) {
    const int k = kb + lane;
    const bool kin = k < ke;
    const int b = kin ? k / D : 0;
    const int d = kin ? k - b * D : 0;
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const int nn = n0 + warp + kWarps * r;
      rx[r] = rh[r] = 0.f;
      if (kin && nn < HF) {
        const int h = nn / F;
        const int f = nn - h * F;
        rx[r] = __ldg(x0 + ((size_t)b * F + f) * D + d);
        rh[r] = hid ? hid[(size_t)h * K + k]
                    : __ldg(x0 + ((size_t)b * F + h) * D + d);
      }
    }
  };
  auto store_outer = [&](int st) {
    float* dst = ous + st * kKC * kBP + lane * kBP;
#pragma unroll
    for (int r = 0; r < kRB; ++r) dst[warp + kWarps * r] = __fmul_rn(rh[r], rx[r]);
  };

  float acc[8][8];
  zero_cell(acc);
  if (kb0 < ke) {
    copy_dcomp(kb0, 0);
    cp_async_commit();
    fetch(kb0);
    store_outer(0);
  }
  for (int kb = kb0, st = 0; kb < ke; kb += kKC, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // step kb's stage is complete; the other one is free
    const bool more = kb + kKC < ke;
    if (more) {
      copy_dcomp(kb + kKC, st ^ 1);
      fetch(kb + kKC);
    }
    cp_async_commit();
    // the cell: maps ty*8 .. ty*8+7, outer rows tx*4.. and kDwN/2 + tx*4..
    cell_product<kKC>(acc, dcs + st * kKC * kAP + ty * 8, kAP,
                         ous + st * kKC * kBP + tx * 4, kBP, kDwN / 2, kKC);
    if (more) store_outer(st ^ 1);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
    float* row = dw_part + ((size_t)s * M + m) * HF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : kDwN / 2 + tx * 4 + j - 4);
      if (n < HF) row[n] = acc[i][j];
    }
  }
}

// Dynamic shared memory of the dW kernel: two stages of dcomp and of the
// outer product.
constexpr int kDwSmem = 4 * 2 * kKC * (kDwM + 4 + kDwN + 4);

// out[i] = sum_{t < S} part[t * n + i], in order of t.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, const long long n,
                                  const int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int t = 0; t < S; ++t) s += part[(size_t)t * n + i];
  out[i] = s;
}

// db[m] = sum over tiles of db_part[tile, m]: each thread a strided share
// in order, then a fixed tree over the block.
__global__ void __launch_bounds__(kReduceThreads)
db_reduce_kernel(const float* __restrict__ part, float* __restrict__ db,
                 const int tiles, const int msum) {
  __shared__ float red[kReduceThreads];
  const int m = blockIdx.x;
  float s = 0.f;
  for (int t = threadIdx.x; t < tiles; t += kReduceThreads) {
    s += part[(size_t)t * msum + m];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) db[m] = red[0];
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// except the per-layer arrays, which are host arrays of n_layers entries.
//   x0 (B, F, D) f32; g (B, out_dim) f32; wt_i k-major (H_i*F, mpad_i)
//   and wm_i m-major (M_i, kpad_i) f32 weights, zero-padded; wm_i holds
//   W_i's columns by chunks of hc hidden rows (hc*F columns), each chunk
//   zero-padded to round_up(hc*F, 8) columns; biases_i (mpad_i,) f32.
//   Outputs: dx0 (B, F, D) f32, dws_i (M_i, H_i*F) f32, db (sum M_i,) f32.
//   Workspace (f32): dcomp (sum M_i, B*D), hid (sum_{i>0} H_i, B*D),
//   db_part (tiles, sum M_i), dw_part (sum_i splits_i * M_i*H_i*F).
// tile_b, nt, threads, kc, hc, mc and smem are the tile kernel's plan and
// splits the dW splits of each layer (fp32_backward_plan), recomputed here
// for this device: a mismatch returns cudaErrorInvalidValue. Returns a
// cudaError_t: 0 on a successful launch. The kernels run on `stream` and
// nothing here synchronises.
extern "C" int cin_stack_bwd(const void* x0, const float* g,
                             const void* const* wt, const void* const* wm,
                             const void* const* biases, const int* m,
                             const int* mpad, const int* direct,
                             const int* next, const int* kpad, int n_layers,
                             int batch, int F, int D, int tile_b, int nt,
                             int threads, int kc, int hc, int mc, int smem,
                             const int* splits, float* dx0, float* dcomp,
                             float* hid, float* db_part, float* dw_part,
                             float* const* dws, float* db, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || F < 1 || D < 1 ||
      (long long)batch * D > INT_MAX - 2 * kMaxSplits * kKC)
    return (int)cudaErrorInvalidValue;
  Layers layers = {};
  BwdLayers bl = {};
  int col = 0, msum = 0, hsum = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (m[l] < 1 || mpad[l] != round_up(m[l], 8) || direct[l] + next[l] < m[l])
      return (int)cudaErrorInvalidValue;
    layers.w[l] = static_cast<const float*>(wt[l]);
    layers.bias[l] = static_cast<const float*>(biases[l]);
    layers.m[l] = m[l];
    layers.mpad[l] = mpad[l];
    layers.direct[l] = direct[l];
    layers.next[l] = next[l];
    layers.col[l] = col;
    bl.wm[l] = static_cast<const float*>(wm[l]);
    bl.kpad[l] = kpad[l];
    bl.off[l] = msum;
    bl.hoff[l] = hsum;
    if (l > 0) hsum += next[l - 1];
    col += direct[l];
    msum += m[l];
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!make_plan(batch, F, D, m, mpad, next, n_layers, sms, &p) || p.tile_b != tile_b ||
      p.nt != nt || p.threads != threads || p.kc != kc || p.hc != hc || p.mc != mc ||
      p.smem != smem)
    return (int)cudaErrorInvalidValue;
  const int K = batch * D;
  int chunks[kMaxLayers];
  for (int l = 0; l < n_layers; ++l) {
    const int H = l == 0 ? F : next[l - 1];
    if (kpad[l] != ceil_div(H, hc) * p.arows ||
        dw_splits(m[l], H * F, K, sms, &chunks[l]) != splits[l])
      return (int)cudaErrorInvalidValue;
  }
  const Totals T = totals(m, next, n_layers);
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  static int smem_set[kMaxDevices] = {};
  static int dw_smem_set[kMaxDevices] = {};
  err = ensure_smem(cin_bwd_tile_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  err = ensure_smem(cin_dw_kernel, kDwSmem, dw_smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (batch + tile_b - 1) / tile_b;
  cin_bwd_tile_kernel<<<tiles, threads, smem, stream_>>>(
      static_cast<const float*>(x0), g, layers, bl, n_layers, batch, F, D, p, T,
      col, dx0, dcomp, hid, db_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  size_t part_off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int M = m[l];
    const int H = l == 0 ? F : next[l - 1];
    const int HF = H * F;
    float* part = dw_part + part_off;
    const dim3 grid(ceil_div(HF, kDwN), ceil_div(M, kDwM), splits[l]);
    cin_dw_kernel<<<grid, kDwThreads, kDwSmem, stream_>>>(
        dcomp + (size_t)bl.off[l] * K, l == 0 ? nullptr : hid + (size_t)bl.hoff[l] * K,
        static_cast<const float*>(x0), part, M, H, F, D, K, chunks[l]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)M * HF;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream_>>>(
        part, dws[l], n, splits[l]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    part_off += (size_t)splits[l] * n;
  }
  db_reduce_kernel<<<msum, kReduceThreads, 0, stream_>>>(db_part, db, tiles, msum);
  return (int)cudaGetLastError();
}

// Message for an error code returned by cin_stack_bwd.
extern "C" const char* cin_stack_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
