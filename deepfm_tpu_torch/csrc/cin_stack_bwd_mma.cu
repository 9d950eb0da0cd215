// CIN-stack backward in bf16 on Hopper's tensor cores (sm_90a, mma.sync).
//
// Replaces deepfm_tpu/ops/pallas/cin_stack_kernel.py ::
// make_cin_stack_pallas.backward_pallas / _stack_bwd_kernel in its bf16
// operand mode (the f32 mode is csrc/cin_stack_bwd.cu). Given x0 (B, F, D)
// bf16, the weights, biases and the pooled output's cotangent g (B,
// sum(direct)) f32, it returns dx0 (B, F, D), dW_i (M_i, H_i*F) and db_i
// (M_i,) in f32, walking the layers last to first:
//
//   dcomp = [g broadcast over d | dhid_next]   (split-half; a sum without)
//   dcomp *= (comp > 0)
//   db   += sum_{b,d} dcomp                              (f32)
//   dW   += sum_{b,d} op(dcomp)[m] * op(op(hid)[h] * x0[f])
//   A     = op(W)^T op(dcomp)
//   dhid  = sum_f A * x0;   dx0 += sum_h A * hid         (f32, hid unrounded)
//
// and at layer 0, where hid = x0, dhid is folded into dx0. op rounds to
// bf16 (a matmul operand), as the TPU kernel does; x0 is bf16, so its f32
// value is exact.
//
// What bounds it on this card: operations. At bench.py's xDeepFM shape
// (B=16384, F=27, D=16, [128,128] split) it is three products of a
// forward's size (the remat, A and dW), ~500 GFLOP, against ~0.2 GB of
// device memory traffic, so all three run as mma.sync m16n8k16 bf16 -> f32
// products. Each k16 step's products start from a zero accumulator and are
// added to the f32 sums by round-to-nearest adds (the tensor cores' own f32
// sum is not round-to-nearest; see csrc/cin_stack_fwd_mma.cu).
//
// Design: three steps, no float atomics, so two launches give the same bits.
//
//  1. cin_bwd_mma_tile_kernel, one block of 8 warps per tile of TB samples
//     (columns n = b_local*D + d, padded to NTP, as in the forward):
//     * Remat: every layer's comp is recomputed by the forward's own layer
//       product (cin_stack_mma.cuh, layer_product: the same k16 steps in
//       the same order), so the comps, and with them the ReLU masks, are
//       bit for bit those of cin_stack_fwd_mma. Only the sign bits of each
//       layer's maps (assembled from warp ballots) and the hidden rows, in
//       f32, are kept: in shared memory (the resident layout) or in a
//       device-memory region of the tile (the streamed one, below).
//     * dcomp: a warp per map, a lane per column; the tile's db share
//       summed in f32 over the lane's columns in order, then by a fixed
//       butterfly of shuffles; dcomp is kept in bf16 (its only use as an
//       operand) in shared memory and written, with each layer's hidden
//       state rounded to bf16 and x0 transposed to (F, B*D), to the dW
//       workspace.
//     * A = W^T dcomp: the product's rows are (h, f) with F padded to 16
//       (one m16 tile = one h and 16 fields, i.e. 16 consecutive columns of
//       the re-laid weight), its K the maps padded to 16, its N the
//       columns, 16 a warp. A fragments come from the forward's re-laid
//       weight (mma_weight) through ldmatrix.x4.trans, staged T tiles x KM
//       k16 steps a chunk by double-buffered cp.async; B fragments from
//       dcomp in shared memory (ldmatrix.x4.trans), one load for all T
//       tiles of a step. A never leaves registers. The tiles go f-chunk
//       first, so a lane keeps its x0 values and its dx0 sums over h of one
//       f-chunk in registers: dx0[f, n] += sum_h A * hid[h, n], added to
//       its group's dx0 (even or odd h) once an f-chunk; the two are added
//       at the end. dhid[h, n], the sum of A * x0 over
//       the tile's 16 rows, is a lane's two rows and then a transposing
//       butterfly over the 8 row lanes (4 shuffles for 4 columns), added
//       over the f-chunks in order. A warp owns its columns, so neither
//       needs an atomic. Pad rows (f >= F) contribute nothing. The epilogue
//       reads and writes f32 rows NTP + 8 long (x0, dx0): the 8 row lanes
//       fall in distinct banks.
//  2. cin_dw_mma_kernel: dW[m, j] = sum_k dcomp[m, k] * op(hid[h, k] *
//     x0[f, k]), j = h*F + f, over K = B*D in S fixed chunks (split-K: a
//     partial dW per sample tile would be 1.26 MB at the bench shape). A
//     block owns 128 maps x 128 columns j of one chunk; 8 warps of 64 x 32;
//     dcomp, hid and x0 stream through shared memory by cp.async, 64 k a
//     stage, double-buffered; the B fragments are formed in registers as
//     bf16x2 products of hid and x0 pairs (exact, as in the forward). Each
//     split's partial is written; columns j >= H*F are never written.
//  3. sum_splits_kernel adds the S partials of each dW element in order;
//     db_reduce_kernel adds the tiles' db partials of each map in a fixed
//     tree. The partition depends only on the shapes.
//
// Two layouts of the tile kernel's shared memory, chosen by the plan from
// the shape:
//  * Resident: every hidden state, dhid and the two dx0 sums in f32 in
//    shared memory. The plan wherever it fits with one remat pass of every
//    map, and of every shape whose f32 count (cin_stack.py::stack_smem)
//    fits one block, whose plans and bits it keeps.
//  * Streamed, elsewhere, where it fits: each layer's f32 hidden rows,
//    dhid and the two dx0 sums live in the tile's region of a device-memory
//    workspace (ws.tiles), and shared memory keeps only the remat's current input
//    rows, in bf16 (the values the operand rounds to, so the comps stay
//    the forward's), then its weight stages; A's W^T stages reuse both.
//    The plan asks one remat pass of as many maps as the warps take. At
//    the xDeepFM paper's Criteo CIN (F=39, D=10, 3 x 200 maps) the tile
//    then holds 128 columns (12 samples): remat passes of 128 maps and A
//    stages of 8 tiles by all 13 map steps, where the resident layout fit
//    64 columns, 16 maps a pass (one of the remat's four groups of warps
//    worked) and A stages of 4 tiles by 1 step (half of A's warps found no
//    columns). The workspace is 350 KB a tile (120 MB at B=4096), written
//    and read by its own block, mostly from L2. Each block streams every
//    layer's weights from L2 twice (the remat and A), so the wider tile,
//    with half the blocks, is the faster: 7.9 against 9.5 ms for the tile
//    kernel at B=4096 (an H100 80GB HBM3 at 700 W).
//
// Ragged batch tiles (zero x0 columns, dcomp 0 there), odd F (zero weight
// columns, skipped rows), D not a multiple of 8 (columns are (b, d) pairs;
// the workspace rows are padded to a multiple of 8 and read with zero
// fill) and M not a multiple of 16 (zero weight rows, dcomp rows 0) are
// masked. The plan (TB, NTP, WN, whether g is staged, RP, T, KM, shared
// memory, splits, dW shared memory, in the layout the caller names) is
// computed by deepfm_tpu_torch/ops/kernels/cin_stack.py::mma_backward_plan;
// the launch recomputes it here and refuses a mismatch.

#include "cin_stack_mma.cuh"

namespace {

using namespace cinmma;

constexpr int kWarps = 8;            // the tile kernel: 8 warps
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 4;               // m16 tiles a warp in the remat
// A = W^T dcomp: 4 groups of 32 columns x 2 groups of hidden rows (h
// even, h odd); a warp takes at most kAMine of a stage's row tiles
constexpr int kACols = 32;
constexpr int kAPass = kACols * 4;   // columns a pass of A
constexpr int kAMine = 5;
constexpr int kATiles = 8;           // row tiles of A a stage at most
constexpr int kSmemMax = 232448;     // a block's shared memory at most
// dW: a block of 8 warps owns 128 maps x 128 columns; K staged 64 at a
// time, each stage row padded by 8 bf16 (144 bytes: 8 rows at the same
// column fall in distinct banks)
constexpr int kDwM = 128, kDwN = 128, kDwK = 64, kDwStride = kDwK + 8;
constexpr int kSplitColumns = 4096, kMaxSplits = 64;
constexpr int kReduceThreads = 256;

struct Layers {
  const bf16* w[kMaxLayers];      // (mp16_i, H_i * Fp), as the forward's
  const float* bias[kMaxLayers];  // (M_i,) f32
  int m[kMaxLayers];
  int direct[kMaxLayers];
  int next[kMaxLayers];
  int col[kMaxLayers];   // first output column of layer i
  int h[kMaxLayers];     // input hidden rows of layer i (F at layer 0)
  int off[kMaxLayers];   // first map of layer i in the stacked maps
  int hoff[kMaxLayers];  // first row of layer i's hidden state (i > 0)
};

struct Plan {
  int F, D, FC, TB, NTP, WN, WM, NB, RP, KC, T, KM, DS, gstage, stream;
  int n_layers, msum, hsum, hin, hmax, mp16max, out_dim, splits;
  int o_hid, o_mask, o_dcs, o_dhid, o_dx0, o_xf, o_g, o_region, total, dw_smem;
};

// Bytes of the dW kernel's shared memory for a layer of H hidden rows.
int dw_layer_smem(int H, int F) {
  const int hr = min(H, (kDwN - 1) / F + 2);
  const int fr = min(F, kDwN);
  return 2 * (kDwM + hr + fr) * kDwStride * 2;
}

// The layout of one plan; total is its shared-memory bytes.
Plan layout(const Plan& s, int WN, int TB, int gstage, int RP, int T, int KM) {
  Plan p = s;
  p.gstage = gstage;
  p.WN = WN; p.WM = kWarps / WN; p.NB = 32 * WN; p.TB = TB;
  p.NTP = round_up(TB * p.D, p.NB);
  p.RP = RP; p.KC = p.NB / 16; p.T = T; p.KM = KM; p.DS = p.NTP + 8;
  const int F = p.F, NTP = p.NTP;
  const int remat = 4 * RP * p.NB;                 // two W stages of KC steps
  const int adj = 2 * KM * 16 * (32 * T + 16);     // two W^T stages
  const int gbytes = gstage ? round_up(4 * TB * p.out_dim, 16) : 0;
  p.o_mask = round_up(2 * F * NTP, 16);
  if (!p.stream) {
    p.o_hid = p.o_mask;
    p.o_mask += 4 * p.hsum * NTP;
  }
  p.o_dcs = p.o_mask + round_up(p.msum * NTP / 8, 16);
  p.o_dhid = p.o_dcs + round_up(2 * p.mp16max * p.DS, 16);
  p.o_dx0 = p.o_dhid + (p.stream ? 0 : 4 * p.hmax * NTP);
  p.o_xf = p.o_dx0 + (p.stream ? 0 : 2 * 4 * F * p.DS);
  p.o_g = p.o_xf + 4 * F * p.DS;
  if (p.stream) {
    // the remat's input rows, then its W stages; A's W^T stages over both
    p.o_hid = p.o_g + gbytes;
    p.o_region = p.o_hid + round_up(2 * p.hin * NTP, 16);
    const int need = p.o_region + remat;
    p.total = p.o_hid + adj > need ? p.o_hid + adj : need;
  } else {
    p.o_region = p.o_g + gbytes;
    p.total = p.o_region + (remat > adj ? remat : adj);
  }
  return p;
}

// The same search as mma_backward_plan, in the layout `stream` names.
// Resident: the widest column pass, then the tile's cotangent staged in
// shared memory, then the most maps a remat pass, then the most A tiles and
// map steps a chunk, whose shared memory fits one block. Streamed: the
// widest column pass that holds one remat pass of every map (of as many as
// its warps take), then the cotangent staged, then the most A tiles and map
// steps. False if nothing fits.
bool make_plan(int batch, int F, int D, const Layers& L, int n_layers, int stream,
               Plan* out) {
  Plan s = {};
  s.F = F; s.D = D; s.FC = round_up(F, 16) / 16; s.n_layers = n_layers;
  s.hmax = F;
  s.stream = stream;
  int mmax = 0, dw = 0;
  for (int l = 0; l < n_layers; ++l) {
    s.msum += L.m[l];
    if (l > 0) s.hsum += L.next[l - 1];
    if (l > 0 && L.next[l - 1] > s.hin) s.hin = L.next[l - 1];
    if (l + 1 < n_layers && L.next[l] > s.hmax) s.hmax = L.next[l];
    if (L.m[l] > mmax) mmax = L.m[l];
    s.out_dim += L.direct[l];
    const int b = dw_layer_smem(L.h[l], F);
    if (b > dw) dw = b;
  }
  s.mp16max = round_up(mmax, 16);
  s.dw_smem = dw;
  // a layer of 1 or 3 hidden rows puts up to 8 of a stage's 8 row tiles in
  // one group of A's warps, more than kAMine: stages of 4 tiles then
  bool small_odd = false;
  for (int l = 0; l < n_layers; ++l) small_odd |= L.h[l] == 1 || L.h[l] == 3;
  const long long K = (long long)batch * D;
  long long splits = (K + kSplitColumns - 1) / kSplitColumns;
  s.splits = (int)(splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits));
  const int msteps = s.mp16max / 16;
  for (int WN = 4; WN >= 1; WN /= 2) {
    const int NB = 32 * WN;
    const int TB = D > NB ? 1 : (batch < NB / D ? batch : NB / D);
    const int most = (kWarps / WN) * 16 * kMT;
    const int full = s.mp16max < most ? s.mp16max : most;
    for (int gstage = 1; gstage >= 0; --gstage) {
      for (int RP = full; RP >= (stream ? full : 16); RP -= 16) {
        for (int T = small_odd ? kATiles / 2 : kATiles; T >= 1; T /= 2) {
          for (int KM = msteps; KM >= 1; --KM) {
            const Plan p = layout(s, WN, TB, gstage, RP, T, KM);
            if (p.total <= kSmemMax) {
              *out = p;
              return true;
            }
          }
        }
      }
    }
  }
  return false;
}

// Offset in bf16 elements of (map row r, 16-byte granule q) in an A stage
// of T tiles: rows of 2T + 1 granules (an odd count: the 8 rows an
// ldmatrix phase reads fall in distinct banks).
__device__ __forceinline__ int astage_off(int r, int q, int T) {
  return (r * (2 * T + 1) + q) * 8;
}

// 16 bytes from global to shared memory, of which the first `bytes` are
// read and the rest filled with zeros.
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Workspace of the dW step, bf16 rows of Kp = round_up(B*D, 8) columns:
// xT (F rows) x0 transposed, hid (sum_{i>0} H_i rows) each layer's input
// hidden state rounded, dcomp (sum M_i rows) each layer's dcomp rounded;
// and, in the streamed layout, a region of tile_floats f32 a tile: its
// hidden rows (hsum x NTP), its two dx0 sums (2 x F x DS), then dhid
// (hmax x NTP).
struct Workspace {
  bf16* xT;
  bf16* hid;
  bf16* dcomp;
  float* db_part;  // (tiles, msum)
  float* tiles;    // streamed layout: a region of tile_floats a tile
  long long tile_floats;
  long long Kp;
};

// The remat's epilogue of one pass: the sign bits of the pass's maps (one
// word per map and 32 columns, from ballots) and, below the last layer,
// its hidden rows in f32.
__device__ __forceinline__ void remat_epilogue(
    const float (&acc)[kMT][kNT][4], const float* __restrict__ bias, int M,
    int m0, int my0, int my_mt, int cp0, int wn, uint32_t* mk, int words,
    float* hnext, int hfirst, int NTP) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    if (i < my_mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + (my0 + i) * 16 + g + half * 8;
        const bool valid = m < M;
        const float bv = valid ? __ldg(bias + m) : 0.f;
        const bool keep = hnext != nullptr && valid && m >= hfirst;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // the forward's comp, bit for bit
            const float c = fmaxf(acc[i][j][2 * half + q] + bv, 0.f);
            const uint32_t bal = __ballot_sync(0xffffffffu, c > 0.f);
            const uint32_t nib = (bal >> (4 * g)) & 0xfu;
#pragma unroll
            for (int tt = 0; tt < 4; ++tt)
              word |= ((nib >> tt) & 1u) << (j * 8 + 2 * tt + q);
            if (keep)
              hnext[(size_t)(m - hfirst) * NTP + cp0 + wn * 32 + j * 8 + 2 * t + q] = c;
          }
        }
        if (t == 0 && valid) mk[(size_t)m * words + (cp0 + wn * 32) / 32] = word;
      }
    }
  }
}

// The tile kernel (step 1). Shared memory, rows of NTP columns unless noted:
//   xs     F rows      x0 (bf16)
//   hids   hsum rows   the input hidden state of each layer i > 0 (f32)
//   masks  msum * NTP bits: comp > 0 for every layer
//   dcs    mp16max rows of DS = NTP + 8 columns: one layer's dcomp (bf16)
//   dhid   hmax rows   dhid of the layer above, then of this layer (f32)
//   dx0s   2 x F rows of DS columns: dx0 (f32), one per group of hidden
//          rows of A's warps
//   xf     F rows of DS columns: x0 (f32), for the group sums
//   gs     TB x out_dim: the tile's cotangent g (f32), where it fits
//   region             the remat's W stages, then the A product's W^T stages
// Streamed, hids, dx0s and dhid are the tile's region of ws.tiles, and
// after gs come hcur, hin rows: the input hidden state of the layer the
// remat is at (bf16), then the remat's W stages; A's W^T stages start at
// hcur.
__global__ void __launch_bounds__(kThreads, 1)
cin_bwd_mma_tile_kernel(const bf16* __restrict__ x0, const float* __restrict__ gout,
                        const Layers L, const int batch, const Plan p,
                        float* __restrict__ dx0, const Workspace ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const xs = reinterpret_cast<bf16*>(smem);
  float* const tile_ws = p.stream ? ws.tiles + blockIdx.x * ws.tile_floats : nullptr;
  // where each layer's f32 hidden rows and the dx0 sums live
  float* const hids = p.stream ? tile_ws : reinterpret_cast<float*>(smem + p.o_hid);
  bf16* const hcur = reinterpret_cast<bf16*>(smem + p.o_hid);
  uint32_t* const masks = reinterpret_cast<uint32_t*>(smem + p.o_mask);
  bf16* const dcs = reinterpret_cast<bf16*>(smem + p.o_dcs);
  float* const dhid = p.stream
                         ? tile_ws + (size_t)p.hsum * p.NTP + (size_t)2 * p.F * p.DS
                         : reinterpret_cast<float*>(smem + p.o_dhid);
  float* const dx0s = p.stream ? tile_ws + (size_t)p.hsum * p.NTP
                               : reinterpret_cast<float*>(smem + p.o_dx0);
  float* const xf = reinterpret_cast<float*>(smem + p.o_xf);
  float* const gs = reinterpret_cast<float*>(smem + p.o_g);
  bf16* const stages = reinterpret_cast<bf16*>(smem + p.o_region);
  bf16* const astages = p.stream ? hcur : stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / p.WN, wn = warp - wm * p.WN;
  const int F = p.F, D = p.D, NTP = p.NTP, DS = p.DS, FC = p.FC, T = p.T, KM = p.KM;
  const int b0 = blockIdx.x * p.TB;
  const int nb = min(p.TB, batch - b0);
  const int ncol = nb * D;  // real columns of the tile
  const long long kcol = (long long)b0 * D;
  const long long Kp = ws.Kp;
  const int words = NTP / 32;  // mask words per map
  const int last = p.n_layers - 1;
  const Geometry geo = {F, FC, NTP, p.NB, p.WN, p.WM, p.RP, p.KC};
  const ThreadPos tp = {warp, lane, g, t, wn};
  const int rstage = p.RP * p.KC * 16;  // bf16 of a remat W stage

  // x0[b0 + bl, f, d] -> xs[f, bl * D + d] and, for the dW step, xT[f, k];
  // dx0 starts at 0; the tile's cotangent into gs where the plan stages it
  const size_t FD = (size_t)F * D;
  for (int i = tid; i < F * NTP; i += kThreads) {
    const int f = i / NTP;
    const int n = i - f * NTP;
    const int bl = n / D;
    bf16 v = __float2bfloat16_rn(0.f);
    if (bl < nb) {
      v = x0[(size_t)(b0 + bl) * FD + (size_t)f * D + (n - bl * D)];
      ws.xT[(size_t)f * Kp + kcol + n] = v;
    }
    xs[i] = v;
    xf[(size_t)f * DS + n] = __bfloat162float(v);
    dx0s[(size_t)f * DS + n] = 0.f;
    dx0s[(size_t)(F + f) * DS + n] = 0.f;
  }
  if (p.gstage) {
    for (int i = tid; i < nb * p.out_dim; i += kThreads) gs[i] = gout[(size_t)b0 * p.out_dim + i];
  }
  __syncthreads();

  // ---- remat: every layer's masks, and its hidden rows below the last ----
  for (int l = 0; l <= last; ++l) {
    const int M = L.m[l];
    const int mp16 = round_up(M, 16);
    float* const hnext = l < last ? hids + (size_t)L.hoff[l + 1] * NTP : nullptr;
    uint32_t* const mk = masks + (size_t)L.off[l] * words;
    const int K16 = FC * L.h[l];
    const LayerSteps ly = {L.h[l], K16, (K16 + p.KC - 1) / p.KC,
                           (size_t)L.h[l] * FC * 16};
    for (int cp0 = 0; cp0 < NTP; cp0 += p.NB) {
      for (int m0 = 0; m0 < mp16; m0 += p.RP) {
        const int rows = min(p.RP, mp16 - m0);
        const int mt = rows / 16;
        const int mtw = (mt + p.WM - 1) / p.WM;
        const int my0 = wm * mtw;
        const int my_mt = max(0, min(mtw, mt - my0));
        float acc[kMT][kNT][4];
        if (l == 0 || p.stream) {
          // x0, or the streamed layer's input rows in bf16 (the values the
          // f32 rows round to)
          layer_product<kWarps, kMT>(acc, xs, l == 0 ? xs : hcur, ly, L.w[l], m0,
                                     rows, cp0, stages, geo, 16 * FC, rstage, tp,
                                     my0, my_mt);
        } else {
          const float* hid = hids + (size_t)L.hoff[l] * NTP;
          layer_product<kWarps, kMT>(acc, xs, hid, ly, L.w[l], m0, rows, cp0,
                                     stages, geo, 16 * FC, rstage, tp, my0,
                                     my_mt);
        }
        remat_epilogue(acc, L.bias[l], M, m0, my0, my_mt, cp0, wn, mk, words,
                       hnext, M - L.next[l], NTP);
      }
    }
    if (p.stream && l < last) {
      // the next layer's input: its f32 rows, written by every pass, in
      // bf16 into shared memory
      __syncthreads();
      for (int i = tid; i < L.next[l] * NTP; i += kThreads)
        hcur[i] = __float2bfloat16_rn(hnext[i]);
    }
  }
  __syncthreads();

  // ---- adjoints, last layer first ---------------------------------------
  for (int l = last; l >= 0; --l) {
    const int M = L.m[l];
    const int mp16 = round_up(M, 16);
    const int H = L.h[l];
    const int dir = L.direct[l];
    const int col = L.col[l];
    const bool split = dir < M;
    const bool has_next = l < last;
    const uint32_t* const mk = masks + (size_t)L.off[l] * words;
    const float* const hidf = l > 0 ? hids + (size_t)L.hoff[l] * NTP : nullptr;

    // dcomp, masked by comp > 0, zero in the pad rows and columns: bf16 in
    // dcs and the workspace; the tile's db share from the f32 values
    for (int m = warp; m < mp16; m += kWarps) {
      float s = 0.f;
#pragma unroll 4
      for (int n = lane; n < NTP; n += 32) {
        float v = 0.f;
        if (m < M && n < ncol) {
          const int bl = n / D;
          float gv = 0.f;
          if (m < dir) {
            gv = p.gstage ? gs[bl * p.out_dim + col + m]
                          : __ldg(gout + (size_t)(b0 + bl) * p.out_dim + col + m);
          }
          if (split) {
            v = m < dir ? gv : dhid[(size_t)(m - dir) * NTP + n];
          } else {
            v = has_next ? gv + dhid[(size_t)m * NTP + n] : gv;
          }
          if (!((mk[(size_t)m * words + (n >> 5)] >> (n & 31)) & 1u)) v = 0.f;
          ws.dcomp[(size_t)(L.off[l] + m) * Kp + kcol + n] = __float2bfloat16_rn(v);
        }
        s += v;
        dcs[(size_t)m * DS + n] = __float2bfloat16_rn(v);
      }
      s = warp_sum(s);
      if (lane == 0 && m < M) ws.db_part[(size_t)blockIdx.x * p.msum + L.off[l] + m] = s;
    }
    // this layer's hidden state, rounded, for the dW step
    if (l > 0) {
      for (int i = tid; i < H * NTP; i += kThreads) {
        const int h = i / NTP;
        const int n = i - h * NTP;
        if (n < ncol)
          ws.hid[(size_t)(L.hoff[l] + h) * Kp + kcol + n] = __float2bfloat16_rn(hidf[i]);
      }
    }

    // A = W^T dcomp by chunks of T row tiles x KM map steps, passes of
    // kAPass columns. The row tiles (h, f-chunk) go f-chunk first, so a
    // lane keeps its x0 values and its dx0 sums of one f-chunk in
    // registers over every h; dhid and dx0 from each finished tile
    const int R = H * FC;   // row tiles
    const int MK = mp16 / 16;
    const int ngroups = (R + T - 1) / T;
    const int nmc = (MK + KM - 1) / KM;
    const int nchunks = ((NTP + kAPass - 1) / kAPass) * ngroups * nmc;
    const int st_elems = KM * 16 * (2 * T + 1) * 8;
    const bf16* const W = L.w[l];
    const size_t wrow = (size_t)H * FC * 16;
    // a thread copies granule gq (of the 2T a stage row) of every r_step-th
    // row (T is a power of two, so 2T divides the block)
    const int gq = tid & (2 * T - 1);
    const int r_step = kThreads / (2 * T);
    auto issue = [&](int c) {
      const int mc = c % nmc;
      const int r0 = (c / nmc) % ngroups * T;
      const int k0 = mc * KM * 16;
      const int nrow = min(KM * 16, mp16 - k0);
      bf16* const st = astages + (c & 1) * st_elems;
      const int rt = r0 + (gq >> 1);  // row tile: f-chunk rt / H, h rt % H
      if (rt < R) {
        const int fc = rt / H;
        int r = tid / (2 * T);
        const bf16* src = W + (size_t)(k0 + r) * wrow + (size_t)(rt - fc * H) * FC * 16 +
                          fc * 16 + (gq & 1) * 8;
        for (; r < nrow; r += r_step) {
          cp_async16(st + astage_off(r, gq, T), src);
          src += (size_t)r_step * wrow;
        }
      }
      cp_async_commit();
    };

    const int wc = warp & 3;   // column group
    const int wr = warp >> 2;  // hidden rows h % 2 == wr
    float* const dx0w = dx0s + (size_t)wr * F * DS;
    int mine[kAMine];
    int nmine = 0;
    float acc[kAMine][4][4];
    float2 xa[4], xb[4];  // x0 of rows fa, fb at the lane's columns, per n8 tile
    float2 da[4], db[4];  // their dx0 sums over this warp's h
    int cur_fc = -1;
    const float2 zero = make_float2(0.f, 0.f);
    // add the lane's dx0 sums of f-chunk cur_fc to the warp group's dx0
    auto flush = [&](int cb) {
      const int fa = cur_fc * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = cb + j * 8 + 2 * t;
        if (fa < F) {
          float2* const d = reinterpret_cast<float2*>(dx0w + (size_t)fa * DS + n);
          const float2 o = *d;
          *d = make_float2(o.x + da[j].x, o.y + da[j].y);
        }
        if (fa + 8 < F) {
          float2* const d = reinterpret_cast<float2*>(dx0w + (size_t)(fa + 8) * DS + n);
          const float2 o = *d;
          *d = make_float2(o.x + db[j].x, o.y + db[j].y);
        }
      }
    };
    issue(0);
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait_all();
      __syncthreads();  // chunk c is in; every warp is done with c - 1
      if (c + 1 < nchunks) issue(c + 1);
      const int mc = c % nmc;
      const int grp = (c / nmc) % ngroups;
      const int r0 = grp * T;
      const int tiles = min(T, R - r0);
      const int k0 = mc * KM;
      const int ksteps = min(KM, MK - k0);
      const int cb = c / (nmc * ngroups) * kAPass + wc * kACols;
      if (cb >= NTP) continue;
      if (mc == 0) {
        // this warp's tiles of the group: those whose h has its parity
        nmine = 0;
        int h = r0 - r0 / H * H;
#pragma unroll
        for (int i = 0; i < kATiles; ++i) {
          if (i < tiles && nmine < kAMine && (h & 1) == wr) mine[nmine++] = i;
          if (++h == H) h = 0;
        }
#pragma unroll
        for (int i = 0; i < kAMine; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
      }
      const bf16* const st = astages + (c & 1) * st_elems;
      const int lq = lane >> 3, l8 = lane & 7;
      for (int s = 0; s < ksteps; ++s) {
        // B: dcomp[maps of the step, the warp's 32 columns], four n8 tiles
        uint32_t b[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ldmatrix_x4_trans(b[u], dcs + (size_t)((k0 + s) * 16 + (lq & 1) * 8 + l8) * DS +
                                      cb + u * 16 + (lq >> 1) * 8);
#pragma unroll
        for (int i = 0; i < kAMine; ++i) {
          if (i < nmine) {
            // A: W^T of the tile, W's rows (maps) read transposed
            uint32_t a[4];
            ldmatrix_x4_trans(a, st + astage_off(s * 16 + (lq >> 1) * 8 + l8,
                                                 2 * mine[i] + (lq & 1), T));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_add(acc[i][j], a, b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
          }
        }
      }
      if (mc + 1 < nmc) continue;
      // the tiles are done. A lane holds rows g, g + 8 (fields fa, fb) of
      // columns n, n + 1 of each n8 tile j
#pragma unroll
      for (int i = 0; i < kAMine; ++i) {
        if (i < nmine) {
          const int rt = r0 + mine[i];
          const int fc = rt / H;
          const int h = rt - fc * H;
          if (fc != cur_fc) {
            if (cur_fc >= 0) flush(cb);
            cur_fc = fc;
            const int fa = fc * 16 + g;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = cb + j * 8 + 2 * t;
              xa[j] = fa < F ? *reinterpret_cast<const float2*>(xf + (size_t)fa * DS + n) : zero;
              xb[j] = fa + 8 < F ? *reinterpret_cast<const float2*>(xf + (size_t)(fa + 8) * DS + n) : zero;
              da[j] = db[j] = zero;
            }
          }
          // dhid[h, n]: A * x0 summed over the tile's 16 rows: the lane's
          // two rows, then a transposing butterfly over the 8 row lanes that
          // leaves lane g with value e = 4 (g & 1) + 2 (g >> 1 & 1) + (g >> 2)
          // of (n8 tile e >> 1, column 2t + (e & 1))
          float v[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[2 * j] = acc[i][j][0] * xa[j].x + acc[i][j][2] * xb[j].x;
            v[2 * j + 1] = acc[i][j][1] * xa[j].y + acc[i][j][3] * xb[j].y;
          }
          const bool b1 = g & 1, b2 = (g >> 1) & 1, b3 = (g >> 2) & 1;
          float k4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            k4[k] = (b1 ? v[4 + k] : v[k]) +
                    __shfl_xor_sync(0xffffffffu, b1 ? v[k] : v[4 + k], 4);
          float k2[2];
#pragma unroll
          for (int k = 0; k < 2; ++k)
            k2[k] = (b2 ? k4[2 + k] : k4[k]) +
                    __shfl_xor_sync(0xffffffffu, b2 ? k4[k] : k4[2 + k], 8);
          const float sum = (b3 ? k2[1] : k2[0]) +
                            __shfl_xor_sync(0xffffffffu, b3 ? k2[0] : k2[1], 16);
          float* const dh = dhid + (size_t)h * NTP + cb + (2 * b1 + b2) * 8 + 2 * t + b3;
          *dh = fc == 0 ? sum : *dh + sum;
          // dx0[f, n] += A * hid[h, n]
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = cb + j * 8 + 2 * t;
            const float2 hv = hidf ? *reinterpret_cast<const float2*>(hidf + (size_t)h * NTP + n)
                                   : *reinterpret_cast<const float2*>(xf + (size_t)h * DS + n);
            da[j].x += acc[i][j][0] * hv.x;
            da[j].y += acc[i][j][1] * hv.y;
            db[j].x += acc[i][j][2] * hv.x;
            db[j].y += acc[i][j][3] * hv.y;
          }
        }
      }
      // the pass's last group: its f-chunk's sums go to dx0
      if (grp + 1 == ngroups) {
        if (cur_fc >= 0) flush(cb);
        cur_fc = -1;
      }
    }
    __syncthreads();
  }
  // layer 0's hidden state is x0: fold its dhid into dx0, then store
  for (int i = tid; i < F * NTP; i += kThreads) {
    const int f = i / NTP;
    const int n = i - f * NTP;
    if (n < ncol) {
      const int bl = n / D;
      dx0[((size_t)(b0 + bl) * F + f) * D + (n - bl * D)] =
          dx0s[(size_t)f * DS + n] + dx0s[(size_t)(F + f) * DS + n] + dhid[i];
    }
  }
}

// One split of dW for one layer (step 2): dw_part[s, m, j] = sum over the
// split's K columns of dcomp[m, k] * op(hid[h, k] * x0[f, k]), j = h*F + f.
// Shared memory: two stages of (128 dcomp rows, the block's hidden rows,
// its x0 rows) x kDwK columns, rows kDwStride long. A block's columns j0 ..
// j0 + 127 take hidden rows h_lo .. h_hi and, when F > 128, a window of
// at most 128 fields starting at j0 % F (slot = (f - j0 % F) mod F).
__global__ void __launch_bounds__(256, 2)
cin_dw_mma_kernel(const bf16* __restrict__ dcomp, const bf16* __restrict__ hid,
                  const bf16* __restrict__ xT, float* __restrict__ dw_part,
                  const int M, const int H, const int F, const long long K,
                  const long long Kp, const long long chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const st0 = reinterpret_cast<bf16*>(smem);
  const int HF = H * F;
  const int j0 = blockIdx.x * kDwN;
  const int m0 = blockIdx.y * kDwM;
  const int s = blockIdx.z;
  const long long kb0 = (long long)s * chunk;
  const long long ke = min(K, kb0 + chunk);
  const int h_lo = j0 / F;
  const int hr = min(H - 1, (j0 + kDwN - 1) / F) - h_lo + 1;
  const int hr_max = min(H, (kDwN - 1) / F + 2);
  const int fr = min(F, kDwN);
  const int f_first = F <= kDwN ? 0 : j0 % F;
  const int xrow0 = kDwM + hr_max;  // first x0 row of a stage
  const int st_elems = (xrow0 + fr) * kDwStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 maps x 32 columns

  // the lane's column of each n8 tile: its hidden and x0 rows in a stage
  int hoffs[4], xoffs[4];
  bool jv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jj = j0 + wn * 32 + j * 8 + g;
    jv[j] = jj < HF;
    const int h = jv[j] ? jj / F : h_lo;
    const int f = jv[j] ? jj - h * F : f_first;
    hoffs[j] = (kDwM + h - h_lo) * kDwStride + 2 * t;
    xoffs[j] = (xrow0 + (f - f_first + F) % F) * kDwStride + 2 * t;
  }

  // chunk kb's rows into stage buf, 16 bytes a thread at a time, zero past
  // the split's end (dcomp rows past M are left alone: they only reach
  // rows of dW that are never written)
  const int nrows = kDwM + hr + fr;
  auto issue = [&](long long kb, int buf) {
    bf16* const st = st0 + buf * st_elems;
    for (int i = tid; i < nrows * (kDwK / 8); i += 256) {
      const int r = i >> 3;
      const int q = i & 7;
      const bf16* src;
      int srow;
      if (r < kDwM) {
        if (m0 + r >= M) continue;
        src = dcomp + (size_t)(m0 + r) * Kp;
        srow = r;
      } else if (r < kDwM + hr) {
        src = hid + (size_t)(h_lo + r - kDwM) * Kp;
        srow = r;
      } else {
        const int slot = r - kDwM - hr;
        src = xT + (size_t)((f_first + slot) % F) * Kp;
        srow = xrow0 + slot;
      }
      const long long k = kb + q * 8;
      const long long left = ke - k;
      const int bytes = left >= 8 ? 16 : (left > 0 ? (int)left * 2 : 0);
      cp_async16_fill(st + srow * kDwStride + q * 8, bytes > 0 ? src + k : src, bytes);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const long long nk = ke > kb0 ? (ke - kb0 + kDwK - 1) / kDwK : 0;
  if (nk > 0) issue(kb0, 0);
  for (long long c = 0; c < nk; ++c) {
    cp_async_wait_all();
    __syncthreads();  // stage c is in; every warp is done with c - 1
    if (c + 1 < nk) issue(kb0 + (c + 1) * kDwK, (int)((c + 1) & 1));
    const bf16* const st = st0 + (c & 1) * st_elems;
#pragma unroll
    for (int ks = 0; ks < kDwK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(a[i], st + (size_t)(wm * 64 + i * 16 + (lane & 15)) * kDwStride +
                              ks * 16 + (lane >> 4) * 8);
      }
      // B: op(hid[h, k] * x0[f, k]) for k = 2t, 2t+1 and 2t+8, 2t+9
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = ks * 16 + q * 8;
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(st + hoffs[j] + o);
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(st + xoffs[j] + o);
          const __nv_bfloat162 prod = __hmul2_rn(hv, xv);
          b[j][q] = jv[j] ? *reinterpret_cast<const uint32_t*>(&prod) : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_add(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
      float* const row = dw_part + ((size_t)s * M + m) * HF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = j0 + wn * 32 + j * 8 + 2 * t;
        if (jj < HF) row[jj] = acc[i][j][2 * half];
        if (jj + 1 < HF) row[jj + 1] = acc[i][j][2 * half + 1];
      }
    }
  }
}

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

cudaError_t launch(const bf16* x0, const float* g, const Layers& L, int batch,
                   const Plan& p, float* dx0, const Workspace& ws,
                   float* dw_part, float* const* dws, float* db,
                   cudaStream_t stream) {
  static int tile_smem[kMaxDevices] = {};
  cudaError_t err = ensure_smem(cin_bwd_mma_tile_kernel, p.total, tile_smem);
  if (err != cudaSuccess) return err;
  static int dw_smem[kMaxDevices] = {};
  err = ensure_smem(cin_dw_mma_kernel, p.dw_smem, dw_smem);
  if (err != cudaSuccess) return err;
  const int tiles = (batch + p.TB - 1) / p.TB;
  cin_bwd_mma_tile_kernel<<<tiles, kThreads, p.total, stream>>>(x0, g, L, batch, p,
                                                                dx0, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long K = (long long)batch * p.D;
  long long chunk = (K + p.splits - 1) / p.splits;
  chunk = (chunk + kDwK - 1) / kDwK * kDwK;
  size_t part_off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int M = L.m[l];
    const int H = L.h[l];
    const long long n = (long long)M * H * p.F;
    const dim3 grid((H * p.F + kDwN - 1) / kDwN, (M + kDwM - 1) / kDwM, p.splits);
    cin_dw_mma_kernel<<<grid, 256, dw_layer_smem(H, p.F), stream>>>(
        ws.dcomp + (size_t)L.off[l] * ws.Kp,
        l == 0 ? ws.xT : ws.hid + (size_t)L.hoff[l] * ws.Kp, ws.xT,
        dw_part + part_off, M, H, p.F, K, ws.Kp, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        dw_part + part_off, dws[l], n, p.splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    part_off += (size_t)p.splits * n;
  }
  db_reduce_kernel<<<p.msum, kReduceThreads, 0, stream>>>(ws.db_part, db, tiles,
                                                          p.msum);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// except the per-layer arrays, which are host arrays of n_layers entries.
//   x0 (B, F, D) bf16; g (B, sum(direct)) f32; weights_i re-laid out as the
//   forward's (mma_weight: (round_up(M_i, 16), H_i * round_up(F, 16))
//   bf16), biases_i (M_i,) f32; m, direct, next ints.
//   (TB, NTP, WN, gstage, RP, T, KM, smem, splits, dw_smem) is the
//   caller's plan in the layout `streamed` names (0 resident, 1 streamed);
//   it must equal the plan recomputed here.
//   Outputs: dx0 (B, F, D) f32, dws_i (M_i, H_i*F) f32, db (sum M_i,) f32.
//   Workspace: xT (F, Kp), hid (max(1, sum_{i>0} H_i), Kp) and dcomp (sum
//   M_i, Kp) bf16 with Kp = round_up(B*D, 8); db_part (tiles, sum M_i) and
//   dw_part (splits * sum_i M_i*H_i*F) f32; streamed, tile_ws (tiles *
//   ((sum_{i>0} H_i + hmax) * NTP + 2 * F * (NTP + 8))) f32, hmax the
//   most hidden rows of a layer (unread otherwise).
//   Nothing needs zeroing.
// Returns a cudaError_t: 0 on a successful launch. The kernels run on
// `stream` and nothing here synchronises.
extern "C" int cin_stack_bwd_mma(
    const void* x0, const float* g, const void* const* weights,
    const void* const* biases, const int* m, const int* direct,
    const int* next, int n_layers, int batch, int F, int D, int TB, int NTP,
    int WN, int gstage, int RP, int T, int KM, int smem, int splits,
    int dw_smem, int streamed, float* dx0, void* xT, void* hid,
    void* dcomp, float* db_part, float* dw_part, float* tile_ws, float* const* dws,
    float* db, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || F < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  Layers L = {};
  int col = 0, off = 0, hoff = 0;
  for (int l = 0; l < n_layers; ++l) {
    L.w[l] = static_cast<const bf16*>(weights[l]);
    L.bias[l] = static_cast<const float*>(biases[l]);
    L.m[l] = m[l];
    L.direct[l] = direct[l];
    L.next[l] = next[l];
    L.col[l] = col;
    L.h[l] = l == 0 ? F : next[l - 1];
    L.off[l] = off;
    L.hoff[l] = hoff;
    if (l > 0) hoff += next[l - 1];
    col += direct[l];
    off += m[l];
  }
  Plan p;
  if ((streamed != 0 && streamed != 1) ||
      !make_plan(batch, F, D, L, n_layers, streamed, &p) || p.TB != TB ||
      p.NTP != NTP || p.WN != WN || p.gstage != gstage || p.RP != RP || p.T != T ||
      p.KM != KM || p.total != smem || p.splits != splits || p.dw_smem != dw_smem)
    return (int)cudaErrorInvalidValue;
  const Workspace ws = {static_cast<bf16*>(xT), static_cast<bf16*>(hid),
                        static_cast<bf16*>(dcomp), db_part, tile_ws,
                        (long long)(p.hsum + p.hmax) * p.NTP + 2LL * F * p.DS,
                        (long long)round_up(batch * D, 8)};
  return (int)launch(static_cast<const bf16*>(x0), g, L, batch, p, dx0, ws,
                     dw_part, dws, db, static_cast<cudaStream_t>(stream));
}

// The tile kernel as compiled: out[0..3] = registers a thread, local
// memory a thread (bytes: spills and stack), static shared memory (bytes),
// and the blocks an SM holds at `smem` bytes of dynamic shared memory.
// Returns a cudaError_t.
extern "C" int cin_stack_bwd_mma_attributes(int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, cin_bwd_mma_tile_kernel);
  if (err != cudaSuccess) return (int)err;
  static int tile_smem[kMaxDevices] = {};
  err = ensure_smem(cin_bwd_mma_tile_kernel, smem, tile_smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cin_bwd_mma_tile_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  return (int)cudaSuccess;
}

// Message for an error code returned by cin_stack_bwd_mma.
extern "C" const char* cin_stack_bwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
