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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kTM = 8;   // maps per thread
constexpr int kTN = 8;   // columns per thread (two float4 groups)
constexpr int kTY = 16;  // thread rows: kTY * kTM = 128 maps per pass
constexpr int kTX = 8;   // thread columns: kTX * kTN = 64 columns per pass
constexpr int kMaxDevices = 64;

struct Layers {
  const void* w[kMaxLayers];      // (K_i, mpad_i) k-major, f32 or bf16
  const float* bias[kMaxLayers];  // (mpad_i,) f32, zero-padded
  int m[kMaxLayers];              // maps of layer i
  int mpad[kMaxLayers];           // m rounded up to a multiple of 8
  int direct[kMaxLayers];         // maps pooled into the output
  int next[kMaxLayers];           // maps handed on as the hidden state
  int col[kMaxLayers];            // first output column of layer i
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
struct Io;

template <>
struct Io<false> {
  __device__ static float load(const void* p, size_t i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
  __device__ static void store(void* p, size_t i, float v) {
    static_cast<float*>(p)[i] = v;
  }
  // eight consecutive weights w[i .. i+7], i a multiple of 8
  __device__ static void load_w8(const void* p, size_t i, float (&w)[8]) {
    const float4* q =
        reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = __ldg(q);
    const float4 b = __ldg(q + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  __device__ static float operand(float x) { return x; }
};

template <>
struct Io<true> {
  __device__ static float load(const void* p, size_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static void store(void* p, size_t i, float v) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
  __device__ static void load_w8(const void* p, size_t i, float (&w)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] = __uint_as_float(words[j] << 16);
      w[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  }
  __device__ static float operand(float x) { return round_bf16(x); }
};

template <bool BF16>
__global__ void __launch_bounds__(kTX * kTY)
cin_stack_fwd_kernel(const void* __restrict__ x0, void* __restrict__ out,
                     const Layers layers, const int n_layers, const int batch,
                     const int F, const int D, const int TB, const int NTP,
                     const int out_dim, const int mmax) {
  using io = Io<BF16>;
  constexpr int CW = kTX * kTN;  // columns per pass
  constexpr int NT = kTX * kTY;  // threads per block
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // F x NTP
  float* const buf0 = xs + (size_t)F * NTP;           // mmax x NTP
  float* const buf1 = xs + (size_t)(F + mmax) * NTP;  // mmax x NTP

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, batch - b0);
  const int FD = F * D;

  // stage the x0 tile: x0[b0+bl, f, d] -> xs[f, bl*D + d], zero padded
  for (int i = tid; i < F * NTP; i += NT) {
    const int f = i / NTP;
    const int n = i - f * NTP;
    const int bl = n / D;
    float v = 0.f;
    if (bl < nb) {
      v = io::load(x0, (size_t)(b0 + bl) * FD + (size_t)f * D + (n - bl * D));
    }
    xs[i] = v;
  }
  __syncthreads();

  const float* hid = xs;
  int H = F;
  for (int l = 0; l < n_layers; ++l) {
    float* comp = (l & 1) ? buf1 : buf0;
    const int M = layers.m[l];
    const int MP = layers.mpad[l];
    const void* w = layers.w[l];
    const float* bias = layers.bias[l];

    for (int mb = 0; mb < M; mb += kTY * kTM) {
      const int m0 = mb + ty * kTM;
      if (m0 >= M) continue;  // no barrier inside this loop
      float bv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) bv[i] = __ldg(bias + m0 + i);

      for (int c = 0; c < NTP; c += CW) {
        const int c0 = c + tx * 4;
        const int c1 = c0 + CW / 2;
        float acc[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

        for (int h = 0; h < H; ++h) {
          const float4 ha = *reinterpret_cast<const float4*>(hid + (size_t)h * NTP + c0);
          const float4 hb = *reinterpret_cast<const float4*>(hid + (size_t)h * NTP + c1);
          float hv[kTN] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
          const size_t wrow = (size_t)h * F * MP + m0;
#pragma unroll 2
          for (int f = 0; f < F; ++f) {
            const float4 xa = *reinterpret_cast<const float4*>(xs + (size_t)f * NTP + c0);
            const float4 xb = *reinterpret_cast<const float4*>(xs + (size_t)f * NTP + c1);
            const float xv[kTN] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
            float o[kTN];
#pragma unroll
            for (int j = 0; j < kTN; ++j) o[j] = io::operand(hv[j] * xv[j]);
            float wv[kTM];
            io::load_w8(w, wrow + (size_t)f * MP, wv);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(wv[i], o[j], acc[i][j]);
          }
        }

#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          if (m0 + i >= M) break;
          float* row = comp + (size_t)(m0 + i) * NTP;
          float4 ra, rb;
          ra.x = fmaxf(acc[i][0] + bv[i], 0.f);
          ra.y = fmaxf(acc[i][1] + bv[i], 0.f);
          ra.z = fmaxf(acc[i][2] + bv[i], 0.f);
          ra.w = fmaxf(acc[i][3] + bv[i], 0.f);
          rb.x = fmaxf(acc[i][4] + bv[i], 0.f);
          rb.y = fmaxf(acc[i][5] + bv[i], 0.f);
          rb.z = fmaxf(acc[i][6] + bv[i], 0.f);
          rb.w = fmaxf(acc[i][7] + bv[i], 0.f);
          *reinterpret_cast<float4*>(row + c0) = ra;
          *reinterpret_cast<float4*>(row + c1) = rb;
        }
      }
    }
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
  // The shared-memory limit is a per-device attribute of the kernel: raise
  // it only when a launch needs more than was set before on this device.
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  const int grid = (batch + TB - 1) / TB;
  kernel<<<grid, kTX * kTY, smem, stream>>>(x0, out, layers, n_layers, batch,
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
