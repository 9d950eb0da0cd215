// CIN-stack forward for Hopper (sm_90a): the whole Compressed Interaction
// Network stack of xDeepFM in one kernel, in f32.
//
// Replaces deepfm_tpu/ops/pallas/cin_stack_kernel.py ::
// make_cin_stack_pallas.forward / _stack_kernel in f32 (its bf16 operand
// mode runs on the tensor cores: csrc/cin_stack_fwd_mma.cu). For every
// layer i
//
//   comp[b,m,d] = relu(sum_{h,f} W_i[m, h*F+f] * hid[b,h,d] * x0[b,f,d] + b_i[m])
//
// followed by split-half routing (the first `direct` maps are pooled into
// the output, the last `next` maps become the next layer's hidden state)
// and a sum over d. Only x0, the weights, the biases and the pooled
// (B, sum(direct)) output touch device memory: neither the (B, H*F, D)
// outer product nor any per-layer feature map leaves the block.
//
// What bounds it on this card: operations. At the xDeepFM bench shape
// (B=16384, F=27, D=16, [128,128] split) a forward is ~165 GFLOP against
// ~41 MB of f32 input and output, far above the H100's ops:byte ridge.
// It runs on the FP32 FMA pipes (67 TFLOP/s on the data sheet): f32
// operands have no tensor-core product that keeps their bits.
//
// Design. One block owns a tile of tile_b samples (columns n = b*D + d,
// padded to nt, a multiple of 8). Shared memory holds x0 (F x nt), the
// hidden state (one buffer of max(next) x nt, two where a middle layer
// takes more than one pass, so that its output cannot overwrite its
// input), and the stage region of cin_stack.cuh's layer_product, which
// runs each layer as a GEMM over K = H*F in chunks of up to 32 rows:
// weights staged by cp.async a chunk ahead, the chunk's outer product
// formed once a block, 8 x 8 register cells, every layer's maps in one
// pass where the cells fit the block. The plan (tile, threads, K rows a
// chunk) is
// ops/kernels/cin_stack.py::fp32_forward_plan, recomputed below
// (make_plan): of the candidates whose shared memory fits, the one whose
// rounds of blocks over the card's slots cost least. Pooling sums a
// sample's d columns in order (a sample cut by column windows: window by
// window, in order), so two launches give the same bits. Ragged batch
// tiles, odd F, D and layer sizes are masked here; the wrapper pads only
// the weights (to mpad, zeros).

#include "cin_stack.cuh"

namespace {

using namespace cin;

constexpr int kMaxRegs = 128;  // launch bounds (256 threads, 2 blocks)

struct Plan {
  int tile_b, nt, threads, kc;  // the caller's plan
  int wpitch, cols, nbuf, hn, stage_floats, smem;
};

// The layout of one (tile, threads, K rows a chunk); false if it does not
// fit.
bool layout(int F, int D, const int* mpad, const int* next, int n_layers,
            int tile_b, int kc, int threads_cap, Plan* p) {
  const int nt = round_up(tile_b * D, 8);
  const int cx = nt / 8;
  int gmax = 0;
  for (int l = 0; l < n_layers; ++l) gmax = imax(gmax, mpad[l] / 8);
  const int threads = imin(threads_cap, round_up(gmax * cx, 32));
  int wgroups = 0, nbuf = n_layers > 1 ? 1 : 0, hn = 0, cols = 0;
  for (int l = 0; l < n_layers; ++l) {
    const Passes P = passes_of(mpad[l] / 8, cx, threads);
    wgroups = imax(wgroups, P.groups);
    cols = P.cols;
    if (l > 0 && l + 1 < n_layers && P.n > 1) nbuf = 2;
    if (l + 1 < n_layers) hn = imax(hn, next[l]);
  }
  const int stage = product_stage_floats(kc, 8 * wgroups, cols);
  const long long floats = (long long)F * nt + (long long)nbuf * hn * nt + stage;
  if (4 * floats > kSmemPerBlock) return false;
  *p = {tile_b, nt, threads, kc, 8 * wgroups, cols, nbuf, hn, stage, (int)(4 * floats)};
  return true;
}

// fp32_forward_plan's search: each candidate tile (tile_b samples of up
// to 128, 64, 32, 16, 8 columns, at least one), threads (the cells of the
// widest layer, at most 256, 128, 64, 32: fewer threads, smaller weight
// stages) and K rows a chunk (32, 16, 8, 4, 2, 1); the least launch_cost,
// the first on a tie. A block's work in k steps: every layer's passes x
// (K and kChunkSteps a chunk).
bool make_plan(int batch, int F, int D, const int* mpad, const int* next,
               int n_layers, int sms, Plan* out) {
  double best = -1.0;
  int last_tb = 0, gmax = 0;
  for (int l = 0; l < n_layers; ++l) gmax = imax(gmax, mpad[l] / 8);
  auto consider = [&](int tb, int kc, int cap) {
    Plan p;
    if (!layout(F, D, mpad, next, n_layers, tb, kc, cap, &p)) return;
    double work = 0.0;
    int H = F;
    for (int l = 0; l < n_layers; ++l) {
      const Passes P = passes_of(mpad[l] / 8, p.nt / 8, p.threads);
      work += (double)P.n * (H * F + ceil_div(H * F, kc) * kChunkSteps);
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
  for (int cols = 128; cols >= 8; cols /= 2) {
    const int tb = imax(1, imin(batch, cols / D));
    if (tb == last_tb) continue;
    last_tb = tb;
    // thread caps that give a different block: the widest layer's cells
    const int need = round_up(gmax * (round_up(tb * D, 8) / 8), 32);
    for (int cap = kMaxThreads, prev = 0; cap >= 32; cap /= 2) {
      if (imin(cap, need) == prev) continue;
      prev = imin(cap, need);
      for (int kc = kMaxChunk; kc >= 1; kc /= 2) consider(tb, kc, cap);
    }
  }
  return best >= 0.0;
}

__global__ void __launch_bounds__(kMaxThreads, 2)
cin_stack_fwd_kernel(const float* __restrict__ x0, float* __restrict__ out,
                     const Layers layers, const int n_layers, const int batch,
                     const int F, const int D, const Plan p, const int out_dim) {
  extern __shared__ __align__(16) float smem[];
  const int nt = p.nt;
  float* const xs = smem;                                        // F x nt
  float* const hbuf0 = xs + (size_t)F * nt;                      // hn x nt
  float* const hbuf1 = hbuf0 + (size_t)p.hn * nt;                // hn x nt
  float* const stage = hbuf0 + (size_t)p.nbuf * p.hn * nt;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * p.tile_b;
  const int nb = min(p.tile_b, batch - b0);

  stage_x0(x0, xs, b0, nb, F, D, nt);
  __syncthreads();

  const Tile t{xs, F, nt, p.kc, stage, p.stage_floats, p.wpitch};
  const float* hid = xs;
  int H = F, cur = -1;  // the buffer holding hid (-1: x0)
  const int last = n_layers - 1;
  for (int l = 0; l < n_layers; ++l) {
    const int M = layers.m[l];
    const int dir = layers.direct[l];
    const int col = layers.col[l];
    const int first_next = M - layers.next[l];
    const bool one_pass = passes_of(layers.mpad[l] / 8, nt / 8, blockDim.x).n == 1;
    const int dst = cur < 0 ? 0 : (one_pass ? cur : 1 - cur);
    float* const hout = dst == 0 ? hbuf0 : hbuf1;
    layer_product(t, hid, H, layers.w[l], layers.bias[l], M, layers.mpad[l],
                  [&](int m0, int rows, int col0, int width, const float* buf) {
      // pool the direct maps over each sample's d columns in this window
      const int nd = min(m0 + rows, dir) - m0;
      if (nd > 0) {
        const int bfirst = col0 / D;
        const int ns = min(nb, (col0 + width + D - 1) / D) - bfirst;
        for (int i = tid; i < ns * nd; i += blockDim.x) {
          const int bi = i / nd;
          const int mi = i - bi * nd;
          const int bl = bfirst + bi;
          const int lo = max(bl * D, col0);
          const int hi = min(bl * D + D, col0 + width);
          const float* src = buf + (size_t)mi * width - col0;
          float s = 0.f;
          for (int n = lo; n < hi; ++n) s += src[n];
          float* o = out + (size_t)(b0 + bl) * out_dim + col + m0 + mi;
          *o = lo == bl * D ? s : *o + s;
        }
      }
      // the last `next` maps are the next layer's hidden state
      if (l < last) {
        const int lo = max(m0, first_next);
        const int cnt = (m0 + rows - lo) * width;
        for (int i = tid; i < cnt; i += blockDim.x) {
          const int r = i / width;
          const int s = i - r * width;
          hout[(size_t)(lo - first_next + r) * nt + col0 + s] =
              buf[(size_t)(lo - m0 + r) * width + s];
        }
      }
    });
    cur = dst;
    hid = hout;
    H = layers.next[l];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// except the per-layer arrays, which are host arrays of n_layers entries.
// tile_b, nt, threads, kc and smem are the caller's plan
// (fp32_forward_plan), recomputed here for this device: a mismatch returns
// cudaErrorInvalidValue. Returns a cudaError_t: 0 on a successful launch.
// The kernel runs on `stream` and nothing here synchronises.
extern "C" int cin_stack_fwd(const void* x0, void* out,
                             const void* const* weights,
                             const void* const* biases, const int* m,
                             const int* mpad, const int* direct,
                             const int* next, int n_layers, int batch, int F,
                             int D, int tile_b, int nt, int threads, int kc,
                             int smem, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || F < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  Layers layers = {};
  int col = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (m[l] < 1 || mpad[l] != round_up(m[l], 8) || direct[l] + next[l] < m[l])
      return (int)cudaErrorInvalidValue;
    layers.w[l] = static_cast<const float*>(weights[l]);
    layers.bias[l] = static_cast<const float*>(biases[l]);
    layers.m[l] = m[l];
    layers.mpad[l] = mpad[l];
    layers.direct[l] = direct[l];
    layers.next[l] = next[l];
    layers.col[l] = col;
    col += direct[l];
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!make_plan(batch, F, D, mpad, next, n_layers, sms, &p) || p.tile_b != tile_b ||
      p.nt != nt || p.threads != threads || p.kc != kc || p.smem != smem)
    return (int)cudaErrorInvalidValue;
  static int smem_set[kMaxDevices] = {};
  err = ensure_smem(cin_stack_fwd_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + tile_b - 1) / tile_b;
  cin_stack_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<float*>(out), layers,
      n_layers, batch, F, D, p, col);
  return (int)cudaGetLastError();
}

// Message for an error code returned by cin_stack_fwd.
extern "C" const char* cin_stack_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
