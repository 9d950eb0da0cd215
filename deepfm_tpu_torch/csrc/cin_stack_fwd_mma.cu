// CIN-stack forward in bf16 on Hopper's tensor cores (sm_90a, mma.sync).
//
// Replaces deepfm_tpu/ops/pallas/cin_stack_kernel.py ::
// make_cin_stack_pallas.forward / _stack_kernel in its bf16 operand mode
// (the f32 mode is csrc/cin_stack_fwd.cu). For every layer i
//
//   comp[b,m,d] = relu(sum_{h,f} W_i[m, h*F+f] * op(hid[b,h,d] * x0[b,f,d]) + b_i[m])
//
// then split-half routing (the first `direct` maps are pooled over d into
// the output, the last `next` maps become the next layer's hidden state).
// The rounding is the TPU kernel's: bf16 x0 and weights, the outer product
// formed in f32 and rounded to bf16 (op, a matmul operand), f32
// accumulation, f32 bias, ReLU and pooling, the hidden state rounded to bf16
// before it is handed on, the output stored as bf16. An m16n8k16 bf16
// product receives exactly these operands; the f32 sums are taken in
// another order than the plain version's, and each step's 16 products are
// summed inside the tensor core, whose additions are not round-to-nearest.
//
// What bounds it on this card: operations. At bench.py's xDeepFM shape
// (B=16384, F=27, D=16, [128,128] split) a forward is ~165 GFLOP against
// ~15 MB of bf16 input and output, and at the xDeepFM paper's CIN (B=4096,
// F=27, D=10, 3 x 200, no split) ~189 GFLOP; both sit far above the
// H100's ops:byte ridge, so the work goes to the bf16 tensor cores.
//
// Design. A block owns a tile of TB samples, whose columns n = bl*D + d are
// padded to NTP (a multiple of the column pass NB = 32 * WN). Each layer
// is one product per (column pass, pass of RP maps):
//
//   comp[m, n] = sum_k W[m, k] * B[k, n],  k = (h, f),  n = (sample, d)
//
// run as mma.sync.m16n8k16 bf16 -> f32. The WARPS warps form WM x WN
// groups; a warp owns up to MT m16 tiles of the pass and kNT = 4 n8 tiles
// (32 columns), so each B fragment feeds up to MT products and each A
// fragment 4. Two instances: 8 warps with MT = 4 (at most 128 registers,
// two blocks an SM) where every layer's maps fit one pass and two blocks
// fit an SM's shared memory (bench.py's [128,128] CIN); else 12 warps with
// MT = 5 (170 registers, one block an SM; the paper's 200 maps are 13
// m-tiles, one pass of 3 x 5).
//  * F is padded to Fp = round_up(F, 16) with zero weight columns, so a
//    k16 step is one hidden row h and 16 consecutive fields. The steps run
//    f-chunk first (fc outer, h inner): a lane keeps its 4 x0 values per n8
//    tile in registers for a whole f-chunk and reuses them for every h.
//  * B fragments are formed in registers and never stored: per step a lane
//    reads one hid[h, n] (bf16 in shared memory) and multiplies it by its
//    four x0 values as two bf16x2 products (mul.rn.bf16x2). The product of
//    two bf16 values is exact in f32, so this is the f32 product rounded
//    to nearest even, the outer product's bf16 rounding, in 2 instructions
//    instead of 4 multiplies and 2 conversions.
//  * Each step's products start from a zero accumulator and are added to
//    the f32 sums with round-to-nearest adds. Carried in the tensor cores'
//    own accumulator over all K = H*Fp, whose additions are not
//    round-to-nearest, the comps drifted several times further from the
//    plain version's (PERF.md, PR 9); this way a step's error is relative
//    to that step's 16 products alone, at the cost of 4 FP32 adds a
//    product.
//  * A is W, re-laid out by the wrapper as (round_up(M, 16), H * Fp) bf16,
//    row-major, column h*Fp + f, zeros in the pads. It is streamed through
//    shared memory in chunks of KC steps (RP rows x 32 bytes a step) with
//    cp.async, double-buffered, one barrier a chunk, and read with
//    ldmatrix.x4. The two 16-byte halves of a row swap places on every
//    other group of four rows, so the 8 rows of an ldmatrix phase hit
//    distinct banks.
//  * The step loop is unrolled by 2, so one step's fragment loads overlap
//    the other's products; each step's A fragments are loaded together
//    before its products.
//  * Shared memory: x0 (F x NTP bf16), two hidden-state buffers (max next
//    x NTP bf16, ping-pong between layers), one region that holds the two W
//    stages during the products and the pass's f32 comps (RP x NB) in the
//    epilogue, and the pooled sums (TB x max direct f32).
//  * Epilogue in f32: bias and ReLU into the region; then each direct map of
//    each sample is summed over its d columns in order and added to its
//    pooled sum in column-pass order; the next maps are rounded to bf16 into
//    the next hidden buffer. No float atomics: two launches give the same
//    bits. Ragged batch tiles (zero x0 columns), odd F (zero weight
//    columns), D not a multiple of 8 and M not a multiple of 16 (rows past M
//    are computed on zero weights and never read) are masked.
//
// The plan (TB, NTP, WN, RP, MT, shared-memory bytes) is computed by
// deepfm_tpu_torch/ops/kernels/cin_stack.py::forward_plan; the launch
// recomputes it here and refuses a mismatch.

#include "cin_stack_mma.cuh"

namespace {

using namespace cinmma;

constexpr int kSmemMax = 232448;   // a block's shared memory at most
constexpr int kSmemTwo = 115712;   // each of two blocks on one SM (228 KB, 1 KB each reserved)

struct Layers {
  const bf16* w[kMaxLayers];      // (mp16_i, H_i * Fp), see above
  const float* bias[kMaxLayers];  // (M_i,) f32
  int m[kMaxLayers];
  int direct[kMaxLayers];
  int next[kMaxLayers];
  int col[kMaxLayers];  // first output column of layer i
};

struct Plan {
  int F, D, FC, TB, NTP, WARPS, WN, WM, NB, RP, KC, MT, maxdir;
  int o_hid0, o_hid1, o_region, o_pool, total;  // bytes from the start
};

// The layout of one plan; total is its shared-memory bytes.
Plan layout(int F, int D, int hn, int maxdir, int WARPS, int WN, int TB, int RP,
            int MT) {
  Plan p = {};
  p.F = F; p.D = D; p.FC = round_up(F, 16) / 16;
  p.WARPS = WARPS; p.WN = WN; p.WM = WARPS / WN; p.NB = 32 * WN;
  p.TB = TB; p.NTP = round_up(TB * D, p.NB);
  p.RP = RP; p.KC = p.NB / 16; p.MT = MT; p.maxdir = maxdir;
  p.o_hid0 = round_up(2 * F * p.NTP, 16);
  p.o_hid1 = p.o_hid0 + round_up(2 * hn * p.NTP, 16);
  p.o_region = p.o_hid1 + round_up(2 * hn * p.NTP, 16);
  p.o_pool = p.o_region + 4 * RP * p.NB;  // = the two W stages' bytes
  p.total = p.o_pool + round_up(4 * TB * maxdir, 16);
  return p;
}

// The same search as forward_plan: the 4-tile instance at 128 columns when
// every layer's maps fit one pass of it and two blocks fit an SM; else the
// 7-tile instance at the widest column pass, then the most maps a pass,
// that fit one block's shared memory. False if nothing fits.
bool make_plan(int batch, int F, int D, const int* m, const int* direct,
               const int* next, int n_layers, Plan* out) {
  int hn = 0, maxdir = 0, mmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (l + 1 < n_layers && next[l] > hn) hn = next[l];
    if (direct[l] > maxdir) maxdir = direct[l];
    if (m[l] > mmax) mmax = m[l];
  }
  const int mtop = round_up(mmax, 16);
  for (int WN = 4; WN >= 1; WN /= 2) {
    const int NB = 32 * WN;
    const int TB = D > NB ? 1 : (batch < NB / D ? batch : NB / D);
    if (WN == 4 && mtop <= (8 / WN) * 16 * 4) {
      const Plan p = layout(F, D, hn, maxdir, 8, WN, TB, mtop, 4);
      if (p.total <= kSmemTwo) {
        *out = p;
        return true;
      }
    }
    const int most = (12 / WN) * 16 * 5;
    for (int RP = mtop < most ? mtop : most; RP >= 16; RP -= 16) {
      const Plan p = layout(F, D, hn, maxdir, 12, WN, TB, RP, 5);
      if (p.total <= kSmemMax) {
        *out = p;
        return true;
      }
    }
  }
  return false;
}

template <int WARPS, int MT, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
cin_stack_fwd_mma_kernel(const bf16* __restrict__ x0, bf16* __restrict__ out,
                         const Layers layers, const int n_layers,
                         const int batch, const int out_dim, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const xs = reinterpret_cast<bf16*>(smem);  // F x NTP
  bf16* const stages = reinterpret_cast<bf16*>(smem + p.o_region);
  float* const scr = reinterpret_cast<float*>(smem + p.o_region);  // RP x NB
  float* const pool = reinterpret_cast<float*>(smem + p.o_pool);   // TB x maxdir

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / p.WN, wn = warp - wm * p.WN;
  const int F = p.F, D = p.D, NTP = p.NTP, NB = p.NB, RP = p.RP;
  const int b0 = blockIdx.x * p.TB;
  const int nb = min(p.TB, batch - b0);
  const Geometry geo = {F, p.FC, NTP, NB, p.WN, p.WM, RP, p.KC};
  const int Fp = 16 * p.FC;
  const int stage_elems = RP * p.KC * 16;
  const ThreadPos tp = {warp, lane, g, t, wn};

  // x0[b0 + bl, f, d] -> xs[f, bl * D + d], zero past the tile's samples
  const size_t FD = (size_t)F * D;
  for (int i = tid; i < F * NTP; i += 32 * WARPS) {
    const int f = i / NTP;
    const int n = i - f * NTP;
    const int bl = n / D;
    bf16 v = __float2bfloat16_rn(0.f);
    if (bl < nb) v = x0[(size_t)(b0 + bl) * FD + (size_t)f * D + (n - bl * D)];
    xs[i] = v;
  }
  __syncthreads();

  const bf16* hid = xs;
  int H = F;
  for (int l = 0; l < n_layers; ++l) {
    const int M = layers.m[l];
    const int mp16 = round_up(M, 16);
    const int dir = layers.direct[l];
    const int nxt = layers.next[l];
    const bool last = l + 1 == n_layers;
    bf16* const hnext = reinterpret_cast<bf16*>(smem + ((l & 1) ? p.o_hid1 : p.o_hid0));
    const bf16* const W = layers.w[l];
    const float* const bias = layers.bias[l];
    const int K16 = p.FC * H;               // k16 steps of the layer
    const LayerSteps ly = {H, K16, (K16 + p.KC - 1) / p.KC, (size_t)H * Fp};

    for (int cp0 = 0; cp0 < NTP; cp0 += NB) {
      for (int m0 = 0; m0 < mp16; m0 += RP) {
        const int rows = min(RP, mp16 - m0);
        const int mt = rows / 16;
        const int mtw = (mt + p.WM - 1) / p.WM;
        const int my0 = wm * mtw;
        const int my_mt = max(0, min(mtw, mt - my0));

        float acc[MT][kNT][4];
        layer_product<WARPS, MT>(acc, xs, hid, ly, W, m0, rows, cp0, stages, geo,
                                 Fp, stage_elems, tp, my0, my_mt);

        // bias and ReLU into the pass's comps (rows past M are never read)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < my_mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int rl = (my0 + i) * 16 + g + half * 8;
              if (m0 + rl < M) {
                const float bv = __ldg(bias + m0 + rl);
#pragma unroll
                for (int j = 0; j < kNT; ++j) {
                  float2 v;
                  v.x = fmaxf(acc[i][j][2 * half] + bv, 0.f);
                  v.y = fmaxf(acc[i][j][2 * half + 1] + bv, 0.f);
                  *reinterpret_cast<float2*>(scr + (size_t)rl * NB + wn * 32 + j * 8 + 2 * t) = v;
                }
              }
            }
          }
        }
        __syncthreads();

        // the direct maps of this pass: each sample's columns in this column
        // pass summed in order, added to its pooled sum in pass order
        const int dhi = min(m0 + rows, dir);
        if (dhi > m0) {
          const int nd = dhi - m0;
          for (int i = tid; i < nb * nd; i += 32 * WARPS) {
            const int r = i / nb;  // neighbouring threads: neighbouring samples
            const int bl = i - r * nb;
            const int lo = max(bl * D, cp0);
            const int hi = min(bl * D + D, cp0 + NB);
            if (lo >= hi) continue;
            const float* src = scr + (size_t)r * NB - cp0;
            float s = 0.f;
            for (int n = lo; n < hi; ++n) s += src[n];
            float* dst = pool + bl * p.maxdir + m0 + r;
            *dst = lo == bl * D ? s : *dst + s;
          }
        }
        // the next maps, rounded to bf16: the next layer's hidden state
        if (!last) {
          const int lo = max(m0, M - nxt);
          const int hi = min(m0 + rows, M);
          for (int i = tid; i < (hi - lo) * NB; i += 32 * WARPS) {
            const int r = i / NB;
            const int n = i - r * NB;
            hnext[(size_t)(lo + r - (M - nxt)) * NTP + cp0 + n] =
                __float2bfloat16_rn(scr[(size_t)(lo - m0 + r) * NB + n]);
          }
        }
        __syncthreads();  // the region is free for the next pass's stages
      }
    }

    const int col = layers.col[l];
    for (int i = tid; i < nb * dir; i += 32 * WARPS) {
      const int bl = i / dir;
      const int m = i - bl * dir;
      out[(size_t)(b0 + bl) * out_dim + col + m] =
          __float2bfloat16_rn(pool[bl * p.maxdir + m]);
    }
    hid = hnext;
    H = nxt;
  }
}

template <int WARPS, int MT, int MINB>
cudaError_t launch(const bf16* x0, bf16* out, const Layers& layers,
                   int n_layers, int batch, int out_dim, const Plan& p,
                   cudaStream_t stream) {
  auto kernel = cin_stack_fwd_mma_kernel<WARPS, MT, MINB>;
  static int smem_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem(kernel, p.total, smem_set);
  if (err != cudaSuccess) return err;
  const int grid = (batch + p.TB - 1) / p.TB;
  kernel<<<grid, 32 * WARPS, p.total, stream>>>(x0, out, layers, n_layers,
                                                batch, out_dim, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x0 (B, F, D) and out (B,
// sum(direct)) are bf16 device pointers; weights and biases are host
// arrays of n_layers device pointers (the weights re-laid out, the biases
// f32), m, direct and next host arrays of n_layers ints. (TB, NTP, WN, RP,
// MT, smem) is the caller's plan; it must equal the plan recomputed here.
// Returns a cudaError_t: 0 on a successful launch. The kernel runs on
// `stream` and nothing here synchronises.
extern "C" int cin_stack_fwd_mma(const void* x0, void* out,
                                 const void* const* weights,
                                 const void* const* biases, const int* m,
                                 const int* direct, const int* next,
                                 int n_layers, int batch, int F, int D, int TB,
                                 int NTP, int WN, int RP, int MT, int smem,
                                 void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || F < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(batch, F, D, m, direct, next, n_layers, &p) || p.TB != TB ||
      p.NTP != NTP || p.WN != WN || p.RP != RP || p.MT != MT || p.total != smem)
    return (int)cudaErrorInvalidValue;
  Layers layers = {};
  int col = 0;
  for (int l = 0; l < n_layers; ++l) {
    layers.w[l] = static_cast<const bf16*>(weights[l]);
    layers.bias[l] = static_cast<const float*>(biases[l]);
    layers.m[l] = m[l];
    layers.direct[l] = direct[l];
    layers.next[l] = next[l];
    layers.col[l] = col;
    col += direct[l];
  }
  const bf16* x = static_cast<const bf16*>(x0);
  bf16* o = static_cast<bf16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      MT == 4 ? launch<8, 4, 2>(x, o, layers, n_layers, batch, col, p, s)
              : launch<12, 5, 1>(x, o, layers, n_layers, batch, col, p, s);
  return (int)err;
}

// Message for an error code returned by cin_stack_fwd_mma.
extern "C" const char* cin_stack_fwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
