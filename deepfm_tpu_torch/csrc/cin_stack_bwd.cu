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
//  1. cin_bwd_tile_kernel, one block per tile of TB samples (columns
//     n = b_local*D + d, as in the forward): recompute every layer's comp
//     in shared memory (remat, as the TPU kernel does: stashing the comps
//     from the forward would cost B*sum(M_i)*D*4 bytes, 268 MB at the bench
//     shape, and a round trip through device memory), keeping of each but
//     the last layer only its hidden rows and the sign bits of its maps
//     (the last layer's comp is recomputed when the walk starts there), then
//     walk the layers backward: dcomp in shared memory, A = W^T dcomp in
//     chunks of 4 hidden rows (4F rows of A in shared memory), dhid and the
//     dx0 contribution from each chunk in a fixed order. Two such blocks fit
//     on an SM at the bench shape (107 KB each). dx0 leaves the block once. dcomp
//     and each hidden state are written to device memory for step 2, and
//     the tile's per-map sums of dcomp (its db share) to a partial buffer.
//  2. cin_dw_kernel: each dW_i is a product over K = B*D,
//     dW[m, (h,f)] = sum_k dcomp[m, k] * hid[h, k] * x0[f, k], with the
//     outer product formed on the fly from hid and x0. The TPU sums dW in
//     one output block that its sequential grid revisits; on Hopper a
//     partial dW per sample tile would be 1.26 MB each (5.2 GB at the bench
//     shape), so instead each block owns a 128 (maps) x 64 (outer rows)
//     tile of dW over one of S fixed chunks of K (split-K), and writes its
//     partial.
//  3. sum_splits_kernel adds the S partials of each dW element in order;
//     db_reduce_kernel adds the tiles' db partials of each map in a fixed
//     tree. The partition depends only on the shapes.
//
#include "cin_stack.cuh"

namespace {

using namespace cin;

constexpr int kKC = 32;      // K (= b*D + d) columns per step of the dW product
constexpr int kDwM = 128;    // maps per dW tile
constexpr int kDwN = 64;     // outer rows (h, f) per dW tile
constexpr int kHC = 4;       // hidden rows per chunk of A
constexpr int kReduceThreads = 256;

struct BwdLayers {
  const float* wm[kMaxLayers];  // (M_i, kpad_i) m-major by chunks
  int kpad[kMaxLayers];        // ceil(H_i / kHC) * round_up(kHC * F, 8)
  int off[kMaxLayers];         // first map of layer i in the stacked maps
  int hoff[kMaxLayers];        // first row of layer i's hidden state (i > 0)
};

// A[r, n] = sum_m Wm[m, k0 + r] * dcs[m, n] for the kHC*F rows r of one
// chunk of hidden rows (rounded up to groups of 8: each chunk's columns of
// Wm are zero-padded to that, which keeps every group's 8 weights aligned
// for one vector load) and every column n; same register tiling as the
// forward.
__device__ void adjoint_chunk(const float* __restrict__ wm, int kpad, int k0,
                              int F, const float* dcs, int M, int NTP,
                              float* As) {
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int groups = (kHC * F + kTM - 1) / kTM;
  for (int rg = ty; rg < groups; rg += kTY) {
    for (int c = 0; c < NTP; c += kCW) {
      const int c0 = c + tx * 4;
      const int c1 = c0 + kCW / 2;
      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
      // unrolled so that the weight loads of later maps are in flight
      // while earlier ones are multiplied: two blocks per SM (the shared
      // memory of the tile) leave few warps to hide their latency
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        float wv[kTM];
        load_w8(wm, (size_t)m * kpad + k0 + rg * kTM, wv);
        const float4 da = *reinterpret_cast<const float4*>(dcs + (size_t)m * NTP + c0);
        const float4 db = *reinterpret_cast<const float4*>(dcs + (size_t)m * NTP + c1);
        const float dv[kTN] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(wv[i], dv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float* row = As + (size_t)(rg * kTM + i) * NTP;
        *reinterpret_cast<float4*>(row + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + c1) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
}

// The tile kernel. Shared memory (f32 rows of NTP columns unless noted):
//   xs     F rows      x0
//   hids   hsum rows   the input hidden state of each layer i > 0
//   masks  (msum - M_last) * NTP bits: comp > 0 for every layer but the last
//   dcs    mmax rows   the last layer's comp, then each layer's dcomp
//   dhid   hmax rows   dhid of the layer above, then of this layer
//   dx0s   F rows      dx0
//   As     kHC*F rows  (rounded up to 8) one chunk of A
// Only the hidden part of a comp and the sign of the rest are kept, which
// fits two blocks on an SM at bench.py's shape; the last layer's comp is
// recomputed into dcs when the walk starts there.
__global__ void __launch_bounds__(kThreads, 2)
cin_bwd_tile_kernel(const float* __restrict__ x0, const float* __restrict__ g,
                    const Layers layers, const BwdLayers bl,
                    const int n_layers, const int batch, const int F,
                    const int D, const int TB, const int NTP,
                    const int out_dim, const int mmax, const int hmax,
                    const int msum, const int hsum, float* __restrict__ dx0,
                    float* __restrict__ dcomp, float* __restrict__ hid_out,
                    float* __restrict__ db_part) {
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) float smem[];
  const int words = NTP / 32;  // mask words per map
  const int arows = (kHC * F + kTM - 1) / kTM * kTM;
  float* const xs = smem;
  float* const hids = xs + (size_t)F * NTP;
  float* const dcs = hids + (size_t)hsum * NTP;
  float* const dhid = dcs + (size_t)mmax * NTP;
  float* const dx0s = dhid + (size_t)hmax * NTP;
  float* const As = dx0s + (size_t)F * NTP;
  uint32_t* const masks = reinterpret_cast<uint32_t*>(As + (size_t)arows * NTP);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, batch - b0);
  const int ncol = nb * D;  // real columns of the tile
  const long long K = (long long)batch * D;
  const long long kcol = (long long)b0 * D;
  const int last = n_layers - 1;

  stage_x0(x0, xs, b0, nb, F, D, NTP);
  for (int i = tid; i < F * NTP; i += NT) dx0s[i] = 0.f;
  __syncthreads();

  // ---- remat of every layer but the last: its mask and hidden rows -------
  for (int l = 0; l < last; ++l) {
    const int M = layers.m[l];
    const int H = l == 0 ? F : layers.next[l - 1];
    const float* hid = l == 0 ? xs : hids + (size_t)bl.hoff[l] * NTP;
    compress_layer<4>(hid, H, xs, F, NTP, layers.w[l], layers.bias[l], M,
                      layers.mpad[l], dcs);
    __syncthreads();
    uint32_t* mk = masks + (size_t)bl.off[l] * words;
    for (int i = tid; i < M * words; i += NT) {
      const float* c = dcs + (size_t)(i / words) * NTP + (i % words) * 32;
      uint32_t bits = 0;
      for (int b = 0; b < 32; ++b) bits |= (uint32_t)(c[b] > 0.f) << b;
      mk[i] = bits;
    }
    const int nxt = layers.next[l];
    float* hnext = hids + (size_t)bl.hoff[l + 1] * NTP;
    for (int i = tid; i < nxt * NTP; i += NT) hnext[i] = dcs[(size_t)(M - nxt) * NTP + i];
    __syncthreads();
  }

  // ---- adjoints, last layer first ---------------------------------------
  for (int l = last; l >= 0; --l) {
    const int M = layers.m[l];
    const int dir = layers.direct[l];
    const int col = layers.col[l];
    const bool split = dir < M;
    const bool has_next = l < last;
    const int H = l == 0 ? F : layers.next[l - 1];
    const float* hid = l == 0 ? xs : hids + (size_t)bl.hoff[l] * NTP;
    const uint32_t* mk = masks + (size_t)bl.off[l] * words;
    float* dcomp_l = dcomp + (size_t)bl.off[l] * K;
    if (l == last) {  // its comp, into dcs
      compress_layer<4>(hid, H, xs, F, NTP, layers.w[l], layers.bias[l], M,
                        layers.mpad[l], dcs);
      __syncthreads();
    }

    // dcomp, masked by comp > 0; zero in the padding columns
    for (int i = tid; i < M * NTP; i += NT) {
      const int m = i / NTP;
      const int n = i - m * NTP;
      float v = 0.f;
      if (n < ncol) {
        const int b = b0 + n / D;
        const float gv = m < dir ? g[(size_t)b * out_dim + col + m] : 0.f;
        if (split) {
          v = m < dir ? gv : dhid[(size_t)(m - dir) * NTP + n];
        } else {
          v = has_next ? gv + dhid[(size_t)m * NTP + n] : gv;
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
      for (int i = tid; i < H * NTP; i += NT) {
        const int h = i / NTP;
        const int n = i - h * NTP;
        if (n < ncol) hid_l[(size_t)h * K + kcol + n] = hid[i];
      }
    }
    __syncthreads();

    // the tile's share of db, summed over its columns in order (f32)
    for (int m = tid; m < M; m += NT) {
      const float* row = dcs + (size_t)m * NTP;
      float s = 0.f;
      for (int n = 0; n < ncol; ++n) s += row[n];
      db_part[(size_t)blockIdx.x * msum + bl.off[l] + m] = s;
    }
    __syncthreads();

    // A = W^T dcomp by chunks of kHC hidden rows; dhid and dx0 from each
    for (int h0 = 0; h0 < H; h0 += kHC) {
      adjoint_chunk(bl.wm[l], bl.kpad[l], h0 / kHC * arows, F, dcs, M,
                          NTP, As);
      __syncthreads();
      const int hc = min(kHC, H - h0);
      for (int i = tid; i < hc * NTP; i += NT) {
        const int hl = i / NTP;
        const int n = i - hl * NTP;
        const float* a = As + (size_t)hl * F * NTP + n;
        float s = 0.f;
        for (int f = 0; f < F; ++f) s = fmaf(a[(size_t)f * NTP], xs[(size_t)f * NTP + n], s);
        dhid[(size_t)(h0 + hl) * NTP + n] = s;
      }
      for (int i = tid; i < F * NTP; i += NT) {
        const int f = i / NTP;
        const int n = i - f * NTP;
        float s = 0.f;
        for (int hl = 0; hl < hc; ++hl) {
          s = fmaf(As[((size_t)hl * F + f) * NTP + n],
                   hid[(size_t)(h0 + hl) * NTP + n], s);
        }
        dx0s[i] += s;
      }
      __syncthreads();
    }
  }
  // layer 0's hidden state is x0: fold its dhid into dx0, then store
  for (int i = tid; i < F * NTP; i += NT) {
    const int f = i / NTP;
    const int n = i - f * NTP;
    if (n < ncol) {
      const int bl_ = n / D;
      dx0[((size_t)(b0 + bl_) * F + f) * D + (n - bl_ * D)] = dx0s[i] + dhid[i];
    }
  }
}

// One split of dW for one layer: dw_part[s, m, (h,f)] = sum over the
// split's K columns of dcomp[m, k] * hid[h, k] * x0[f, k],
// hid = x0 at layer 0 (hid == nullptr). Each step stages kKC columns of
// dcomp and of the outer product in shared memory; the next step's global
// loads are issued into registers before the current step's products, so
// their latency is hidden behind them.
__global__ void __launch_bounds__(kThreads)
cin_dw_kernel(const float* __restrict__ dcomp, const float* __restrict__ hid,
              const float* __restrict__ x0, float* __restrict__ dw_part,
              const int M, const int H, const int F, const int D,
              const long long K, const long long chunk) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kRA = kDwM / kWarps;  // dcomp rows a warp stages per step
  constexpr int kRB = kDwN / kWarps;  // outer rows a warp stages per step
  __shared__ __align__(16) float dcs[kKC][kDwM + 4];
  __shared__ __align__(16) float ous[kKC][kDwN + 4];
  const int HF = H * F;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int m0 = blockIdx.y * kDwM;
  const int n0 = blockIdx.x * kDwN;
  const int s = blockIdx.z;
  const long long kb0 = (long long)s * chunk;
  const long long ke = min(K, kb0 + chunk);

  // one step's loads, lane = column k - kb: dcomp, and x0 and the hidden
  // state of the outer product's rows (zero past the split or the rows)
  float ra[kRA], rx[kRB], rh[kRB];
  auto fetch = [&](long long kb) {
    const long long k = kb + lane;
    const bool kin = k < ke;
    const long long b = kin ? k / D : 0;
    const int d = kin ? (int)(k - b * D) : 0;
#pragma unroll
    for (int r = 0; r < kRA; ++r) {
      const int i = warp + kWarps * r;
      ra[r] = kin && m0 + i < M ? dcomp[(size_t)(m0 + i) * K + k] : 0.f;
    }
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

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  if (kb0 < ke) fetch(kb0);
  for (long long kb = kb0; kb < ke; kb += kKC) {
#pragma unroll
    for (int r = 0; r < kRA; ++r) dcs[lane][warp + kWarps * r] = ra[r];
#pragma unroll
    for (int r = 0; r < kRB; ++r) ous[lane][warp + kWarps * r] = rh[r] * rx[r];
    __syncthreads();
    if (kb + kKC < ke) fetch(kb + kKC);
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 aa = *reinterpret_cast<const float4*>(&dcs[kk][ty * 4]);
      const float4 ab = *reinterpret_cast<const float4*>(&dcs[kk][kDwM / 2 + ty * 4]);
      const float4 ba = *reinterpret_cast<const float4*>(&ous[kk][tx * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&ous[kk][kDwN / 2 + tx * 4]);
      const float av[kTM] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
      const float bv[kTN] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : kDwM / 2 + ty * 4 + i - 4);
    if (m >= M) continue;
    float* row = dw_part + ((size_t)s * M + m) * HF;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : kDwN / 2 + tx * 4 + j - 4);
      if (n < HF) row[n] = acc[i][j];
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

cudaError_t launch(const float* x0, const float* g, const Layers& layers,
                   const BwdLayers& bl, int n_layers, int batch, int F, int D,
                   int TB, int NTP, int out_dim, int mmax, int hmax, int msum,
                   int hsum, float* dx0, float* dcomp, float* hid, float* db_part,
                   float* dw_part, int splits, float* const* dws, float* db,
                   cudaStream_t stream) {
  const int arows = (kHC * F + kTM - 1) / kTM * kTM;
  const int mlast = layers.m[n_layers - 1];
  const int smem = (int)(sizeof(float) *
                         ((size_t)(F + hsum + mmax + hmax + F + arows) * NTP
                          + (size_t)(msum - mlast) * (NTP / 32)));
  auto tile_kernel = cin_bwd_tile_kernel;
  static int smem_set[kMaxDevices] = {};
  cudaError_t err = ensure_smem(tile_kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int tiles = (batch + TB - 1) / TB;
  tile_kernel<<<tiles, kThreads, smem, stream>>>(
      x0, g, layers, bl, n_layers, batch, F, D, TB, NTP, out_dim, mmax, hmax,
      msum, hsum, dx0, dcomp, hid, db_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long K = (long long)batch * D;
  long long chunk = (K + splits - 1) / splits;
  chunk = (chunk + kKC - 1) / kKC * kKC;
  size_t part_off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int M = layers.m[l];
    const int H = l == 0 ? F : layers.next[l - 1];
    const int HF = H * F;
    float* part = dw_part + part_off;
    const dim3 grid((HF + kDwN - 1) / kDwN, (M + kDwM - 1) / kDwM, splits);
    cin_dw_kernel<<<grid, kThreads, 0, stream>>>(
        dcomp + (size_t)bl.off[l] * K, l == 0 ? nullptr : hid + (size_t)bl.hoff[l] * K,
        x0, part, M, H, F, D, K, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n = (long long)M * HF;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        part, dws[l], n, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    part_off += (size_t)splits * n;
  }
  db_reduce_kernel<<<msum, kReduceThreads, 0, stream>>>(db_part, db, tiles, msum);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// except the per-layer arrays, which are host arrays of n_layers entries.
//   x0 (B, F, D) f32; g (B, out_dim) f32; wt_i k-major (H_i*F, mpad_i)
//   and wm_i m-major (M_i, kpad_i) f32 weights, zero-padded; wm_i holds W_i's columns by chunks
//   of 4 hidden rows (4F columns), each chunk zero-padded to
//   round_up(4F, 8) columns; biases_i (mpad_i,) f32.
//   Outputs: dx0 (B, F, D) f32, dws_i (M_i, H_i*F) f32, db (sum M_i,) f32.
//   Workspace (f32): dcomp (sum M_i, B*D), hid (sum_{i>0} H_i, B*D),
//   db_part (tiles, sum M_i), dw_part (splits * sum_i M_i*H_i*F).
// Returns a cudaError_t: 0 on a successful launch. The kernels run on
// `stream` and nothing here synchronises.
extern "C" int cin_stack_bwd(const void* x0, const float* g,
                             const void* const* wt, const void* const* wm,
                             const void* const* biases, const int* m,
                             const int* mpad, const int* direct,
                             const int* next, const int* kpad, int n_layers,
                             int batch, int F, int D, int TB, int NTP,
                             float* dx0, float* dcomp, float* hid,
                             float* db_part, float* dw_part, int splits,
                             float* const* dws, float* db, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || splits < 1)
    return (int)cudaErrorInvalidValue;
  Layers layers = {};
  BwdLayers bl = {};
  int col = 0, mmax = 0, msum = 0, hsum = 0, hmax = F;
  for (int l = 0; l < n_layers; ++l) {
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
    if (l + 1 < n_layers && next[l] > hmax) hmax = next[l];
    col += direct[l];
    msum += m[l];
    mmax = m[l] > mmax ? m[l] : mmax;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch(static_cast<const float*>(x0), g, layers, bl, n_layers,
                     batch, F, D, TB, NTP, col, mmax, hmax, msum, hsum, dx0,
                     dcomp, hid, db_part, dw_part, splits, dws, db, s);
}

// Message for an error code returned by cin_stack_bwd.
extern "C" const char* cin_stack_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
