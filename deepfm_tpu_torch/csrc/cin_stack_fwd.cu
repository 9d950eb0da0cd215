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

#include "cin_stack.cuh"

namespace {

using namespace cin;

__global__ void __launch_bounds__(kThreads)
cin_stack_fwd_kernel(const float* __restrict__ x0, float* __restrict__ out,
                     const Layers layers, const int n_layers, const int batch,
                     const int F, const int D, const int TB, const int NTP,
                     const int out_dim, const int mmax) {
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // F x NTP
  float* const buf0 = xs + (size_t)F * NTP;           // mmax x NTP
  float* const buf1 = xs + (size_t)(F + mmax) * NTP;  // mmax x NTP

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, batch - b0);

  stage_x0(x0, xs, b0, nb, F, D, NTP);
  __syncthreads();

  const float* hid = xs;
  int H = F;
  for (int l = 0; l < n_layers; ++l) {
    float* comp = (l & 1) ? buf1 : buf0;
    const int M = layers.m[l];
    compress_layer(hid, H, xs, F, NTP, layers.w[l], layers.bias[l], M,
                   layers.mpad[l], comp);
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
      out[(size_t)(b0 + bl) * out_dim + col + m] = s;
    }

    // the last `next` maps are the next layer's hidden state
    hid = comp + (size_t)(M - layers.next[l]) * NTP;
    H = layers.next[l];
  }
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
                             int D, int TB, int NTP, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  Layers layers = {};
  int col = 0;
  int mmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    layers.w[l] = static_cast<const float*>(weights[l]);
    layers.bias[l] = static_cast<const float*>(biases[l]);
    layers.m[l] = m[l];
    layers.mpad[l] = mpad[l];
    layers.direct[l] = direct[l];
    layers.next[l] = next[l];
    layers.col[l] = col;
    col += direct[l];
    mmax = m[l] > mmax ? m[l] : mmax;
  }
  const int smem = (int)(sizeof(float) * (size_t)(F + 2 * mmax) * NTP);
  static int smem_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem(cin_stack_fwd_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + TB - 1) / TB;
  cin_stack_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<float*>(out), layers,
      n_layers, batch, F, D, TB, NTP, col, mmax);
  return (int)cudaGetLastError();
}

// Message for an error code returned by cin_stack_fwd.
extern "C" const char* cin_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
