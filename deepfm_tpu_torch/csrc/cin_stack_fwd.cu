// CIN-stack forward for Hopper (sm_90a): the whole Compressed Interaction
// Network stack of xDeepFM in one kernel.
//
// Replaces deepfm_tpu/ops/pallas/cin_stack_kernel.py ::
// make_cin_stack_pallas.forward / _stack_kernel. For every layer i
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
// This first kernel runs on the FP32 FMA pipes (67 TFLOP/s on the data
// sheet), not the tensor cores; wgmma is later work.
//
// Design. One block owns a tile of TB samples. Its columns are
// n = b_local*D + d, padded to NTP (a multiple of the column chunk CW), so
// every layer is one GEMM in shared memory:
//
//   comp[m, n] = sum_{k=(h,f)} Wt[k, m] * (hid[h, n] * x0[f, n])
//
// with the B operand (the outer product) formed in registers on the fly.
// Shared memory holds x0 (F x NTP) and two ping-pong feature-map buffers
// (mmax x NTP): layer i writes buffer i%2 and reads its hidden state from
// the other. Each thread owns an 8 (maps) x 8 (columns) register tile;
// the columns are two groups of four, CW/2 apart, so float4 reads of
// shared memory are free of bank conflicts. Weights arrive k-major
// (K, mpad) from the wrapper and are read 8 maps at a time straight from
// global memory (L1/L2 resident: every block reads the same weights).
// Pooling sums the d columns of each direct map in a fixed order, so the
// output is deterministic. Ragged batch tiles, odd F, D and layer sizes
// are masked here; the wrapper pads only the weights (to mpad, zeros).
//
// bf16 mode follows the TPU kernel's semantics: bf16 x0 and weights, the
// outer product rounded to bf16 (a matmul operand), f32 accumulation,
// f32 bias add, ReLU and pooling, the hidden state handed to the next
// layer rounded to bf16, and the output stored as bf16.

#include "cin_stack.cuh"

namespace {

using namespace cin;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
cin_stack_fwd_kernel(const void* __restrict__ x0, void* __restrict__ out,
                     const Layers layers, const int n_layers, const int batch,
                     const int F, const int D, const int TB, const int NTP,
                     const int out_dim, const int mmax) {
  using io = Io<BF16>;
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // F x NTP
  float* const buf0 = xs + (size_t)F * NTP;           // mmax x NTP
  float* const buf1 = xs + (size_t)(F + mmax) * NTP;  // mmax x NTP

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, batch - b0);

  stage_x0<BF16>(x0, xs, b0, nb, F, D, NTP);
  __syncthreads();

  const float* hid = xs;
  int H = F;
  for (int l = 0; l < n_layers; ++l) {
    float* comp = (l & 1) ? buf1 : buf0;
    const int M = layers.m[l];
    compress_layer<BF16>(hid, H, xs, F, NTP, layers.w[l], layers.bias[l], M,
                         layers.mpad[l], comp, false);
    __syncthreads();

    // pool the direct maps over d, in order, into out[b, col + m]
    const int dir = layers.direct[l];
    const int col = layers.col[l];
    for (int i = tid; i < nb * dir; i += NT) {
      const int bl = i / dir;
      const int m = i - bl * dir;
      const float* src = comp + (size_t)m * NTP + bl * D;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += src[d];
      io::store(out, (size_t)(b0 + bl) * out_dim + col + m, s);
    }

    // the last `next` maps are the next layer's hidden state; in bf16 mode
    // they are rounded to bf16 (the TPU kernel's bf16 hidden scratch)
    const int nxt = layers.next[l];
    float* hnext = comp + (size_t)(M - nxt) * NTP;
    if (BF16 && l + 1 < n_layers) {
      __syncthreads();  // pooling above read the f32 values
      for (int i = tid; i < nxt * NTP; i += NT) hnext[i] = round_bf16(hnext[i]);
      __syncthreads();
    }
    hid = hnext;
    H = nxt;
  }
}

template <bool BF16>
cudaError_t launch(const void* x0, void* out, const Layers& layers,
                   int n_layers, int batch, int F, int D, int TB, int NTP,
                   int out_dim, int mmax, cudaStream_t stream) {
  const int smem = (int)(sizeof(float) * (size_t)(F + 2 * mmax) * NTP);
  auto kernel = cin_stack_fwd_kernel<BF16>;
  static int smem_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int grid = (batch + TB - 1) / TB;
  kernel<<<grid, kThreads, smem, stream>>>(x0, out, layers, n_layers, batch,
                                            F, D, TB, NTP, out_dim, mmax);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// except the per-layer arrays, which are host arrays of n_layers entries.
// Returns a cudaError_t: 0 on a successful launch. The kernel runs on
// `stream` and nothing here synchronises.
extern "C" int cin_stack_fwd(const void* x0, void* out,
                             const void* const* weights,
                             const void* const* biases, const int* m,
                             const int* mpad, const int* direct,
                             const int* next, int n_layers, int batch, int F,
                             int D, int TB, int NTP, int bf16,
                             void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  Layers layers = {};
  int col = 0;
  int mmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    layers.w[l] = weights[l];
    layers.bias[l] = static_cast<const float*>(biases[l]);
    layers.m[l] = m[l];
    layers.mpad[l] = mpad[l];
    layers.direct[l] = direct[l];
    layers.next[l] = next[l];
    layers.col[l] = col;
    col += direct[l];
    mmax = m[l] > mmax ? m[l] : mmax;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<true>(x0, out, layers, n_layers, batch, F, D, TB, NTP, col, mmax, s)
           : launch<false>(x0, out, layers, n_layers, batch, F, D, TB, NTP, col, mmax, s);
  return (int)err;
}

// Message for an error code returned by cin_stack_fwd.
extern "C" const char* cin_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
