// One CIN layer's compression for Hopper (sm_90a).
//
// Replaces deepfm_tpu/ops/pallas/cin_kernel.py :: cin_compress_pallas /
// _cin_kernel. For hidden (B, H, D), x0 (B, F, D), a weight of M maps over
// K = H*F channels and a bias,
//
//   out[b,m,d] = sum_{h,f} W[m, h*F+f] * hidden[b,h,d] * x0[b,f,d] + bias[m]
//
// pre-ReLU, in f32 throughout (the wrapper casts the inputs to f32 and the
// output back to hidden's dtype).
//
// What bounds it on this card: operations. At the xDeepFM paper's Criteo
// shape (B=4096, F=27, D=10, H=M=200) a layer is 88.7 GFLOP against 74 MB
// of f32 input and output, far above the H100's ops:byte ridge. This first
// kernel runs on the FP32 FMA pipes (67 TFLOP/s on the data sheet), not the
// tensor cores; wgmma and TMA are later work.
//
// Design. One GEMM with M rows, N = B*D columns (n = b*D + d) and K = H*F:
//
//   out[m, n] = sum_k Wt[k, m] * (hidden[b, k / F, d] * x0[b, k % F, d])
//
// A block owns a tile of kBM maps by kBN columns and walks K in chunks of
// kBK rows. Per chunk it stages the weight rows (k-major from the wrapper,
// zero-padded to MP maps, one float4 a thread) and the chunk of the outer
// product, each element formed as it is staged from one hidden and one x0
// value (both read through the read-only cache; a block's samples fit in
// L1). So the (B, K, D) outer product never exists in device memory, and
// since only one chunk of K is resident, any H, F, M and D fit: no shape is
// refused for shared memory. The next chunk's loads are issued before the
// current chunk's products (register prefetch). Each thread owns an 8
// (maps) x 8 (columns) register tile, the columns two groups of four kBN/2
// apart, so float4 reads of shared memory are free of bank conflicts. Each
// output is summed over K in one fixed order: a repeat launch gives the
// same bits. Ragged B, D, M and K are masked here.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // maps per block
constexpr int kBN = 128;  // columns per block
constexpr int kBK = 8;    // K rows per chunk
constexpr int kTM = 8;    // maps per thread
constexpr int kTN = 8;    // columns per thread (two float4 groups)
constexpr int kTX = kBN / kTN;         // 16 thread columns
constexpr int kThreads = (kBM / kTM) * kTX;  // 256
constexpr int kBRows = kBK * kBN / kThreads;  // outer-product rows a thread stages

static_assert(kBK * kBM == 4 * kThreads, "one float4 of weights per thread");
static_assert(kThreads % kBN == 0, "whole rows of the outer-product tile");

__global__ void __launch_bounds__(kThreads, 2)
cin_compress_kernel(const float* __restrict__ hid, const float* __restrict__ x0,
                    const float* __restrict__ wt, const float* __restrict__ bias,
                    float* __restrict__ out, const int N, const int H,
                    const int F, const int D, const int M, const int MP) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int K = H * F;

  // staging roles: weights row ak, maps am..am+3; outer product column bc,
  // rows br, br + kThreads/kBN, ...
  const int ak = tid / (kBM / 4);
  const int am = (tid % (kBM / 4)) * 4;
  const bool a_ok = m0 + am < MP;  // MP % 4 == 0: the whole float4
  const int bc = tid % kBN;
  const int br = tid / kBN;
  constexpr int kBStep = kThreads / kBN;
  const int n = n0 + bc;
  const bool col_ok = n < N;
  const int sb = col_ok ? n / D : 0;
  const int sd = col_ok ? n - sb * D : 0;
  const float* hcol = hid + (size_t)sb * H * D + sd;  // + h * D
  const float* xcol = x0 + (size_t)sb * F * D + sd;   // + f * D
  // (h, f) of each staged row k = k0 + br + j * kBStep, advanced by kBK
  // per chunk (no division in the loop)
  int hj[kBRows], fj[kBRows];
#pragma unroll
  for (int j = 0; j < kBRows; ++j) {
    const int k = br + j * kBStep;
    hj[j] = k / F;
    fj[j] = k - hj[j] * F;
  }

  float4 a_reg;
  float b_reg[kBRows];
  auto load = [&](int k0) {
    const int k = k0 + ak;
    a_reg = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_ok && k < K) {
      a_reg = __ldg(reinterpret_cast<const float4*>(wt + (size_t)k * MP + m0 + am));
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      float v = 0.f;
      if (col_ok && hj[j] < H) v = __ldg(hcol + hj[j] * D) * __ldg(xcol + fj[j] * D);
      b_reg[j] = v;
      fj[j] += kBK;
      while (fj[j] >= F) {
        fj[j] -= F;
        ++hj[j];
      }
    }
  };
  auto store = [&]() {
    *reinterpret_cast<float4*>(&As[ak][am]) = a_reg;
#pragma unroll
    for (int j = 0; j < kBRows; ++j) Bs[br + j * kBStep][bc] = b_reg[j];
  };

  const int tx = tid % kTX;
  const int ty = tid / kTX;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][kBN / 2 + tx * 4]);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // out[b, m, d] = acc + bias[m], for the thread's real maps and columns
  size_t col_off[kTN];
  bool col_in[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int c = n0 + (j < 4 ? tx * 4 + j : kBN / 2 + tx * 4 + (j - 4));
    col_in[j] = c < N;
    const int b = col_in[j] ? c / D : 0;
    col_off[j] = (size_t)b * M * D + (c - b * D);
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= M) break;
    const float bm = __ldg(bias + m);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (col_in[j]) out[col_off[j] + (size_t)m * D] = acc[i][j] + bm;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). hid (B, H, D), x0 (B, F, D) and
// out (B, M, D) are f32, contiguous; wt is the weight k-major, (H*F, MP) f32
// with MP a multiple of 8 and maps M..MP-1 zero; bias (M,) f32. Returns a
// cudaError_t: 0 on a successful launch. The kernel runs on `stream` and
// nothing here synchronises.
extern "C" int cin_compress(const void* hid, const void* x0, const void* wt,
                            const void* bias, void* out, int B, int H, int F,
                            int D, int M, int MP, void* stream) {
  if (B < 0 || H < 1 || F < 1 || D < 1 || M < 1 || MP < M || MP % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long N = (long long)B * D;
  if (N > INT_MAX - kBN || (long long)H * F > INT_MAX - kBK) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cin_compress_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hid), static_cast<const float*>(x0),
      static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<float*>(out), (int)N, H, F, D, M, MP);
  return (int)cudaGetLastError();
}

// Message for an error code returned by cin_compress.
extern "C" const char* cin_compress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
