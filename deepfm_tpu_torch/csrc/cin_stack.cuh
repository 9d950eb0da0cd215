// Shared by the f32 CIN-stack forward (cin_stack_fwd.cu) and backward
// (cin_stack_bwd.cu): the per-layer metadata, the weight loads, the x0
// tile staging and one layer's compression into shared memory (the bf16
// kernels share cin_stack_mma.cuh instead). Both
// kernels run one block of kTX * kTY threads per tile of TB samples whose
// columns are n = b_local * D + d, padded to NTP (a multiple of kTX * kTN).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cin {

constexpr int kMaxLayers = 8;
constexpr int kTM = 8;   // maps per thread
constexpr int kTN = 8;   // columns per thread (two float4 groups)
constexpr int kTY = 16;  // thread rows: kTY * kTM = 128 maps per pass
constexpr int kTX = 8;   // thread columns: kTX * kTN = 64 columns per pass
constexpr int kCW = kTX * kTN;  // columns per pass
constexpr int kThreads = kTX * kTY;
constexpr int kMaxDevices = 64;

struct Layers {
  const float* w[kMaxLayers];     // (K_i, mpad_i) k-major
  const float* bias[kMaxLayers];  // (mpad_i,) f32, zero-padded
  int m[kMaxLayers];              // maps of layer i
  int mpad[kMaxLayers];           // m rounded up to a multiple of 8
  int direct[kMaxLayers];         // maps pooled into the output
  int next[kMaxLayers];           // maps handed on as the hidden state
  int col[kMaxLayers];            // first output column of layer i
};

// eight consecutive f32 values p[i .. i+7], i a multiple of 8
__device__ __forceinline__ void load_w8(const float* p, size_t i, float (&w)[8]) {
  const float4* q = reinterpret_cast<const float4*>(p + i);
  const float4 a = __ldg(q);
  const float4 b = __ldg(q + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// x0[b0 + bl, f, d] -> xs[f, bl * D + d] as f32, zero beyond the nb
// samples of the tile and in the padding columns.
__device__ void stage_x0(const float* __restrict__ x0, float* xs, int b0,
                         int nb, int F, int D, int NTP) {
  const size_t FD = (size_t)F * D;
  for (int i = threadIdx.x; i < F * NTP; i += kThreads) {
    const int f = i / NTP;
    const int n = i - f * NTP;
    const int bl = n / D;
    float v = 0.f;
    if (bl < nb) {
      v = __ldg(x0 + (size_t)(b0 + bl) * FD + (size_t)f * D + (n - bl * D));
    }
    xs[i] = v;
  }
}

// One layer's feature maps of the tile, as one GEMM in shared memory:
//
//   comp[m, n] = relu(sum_{k=(h,f)} Wt[k, m] * hid[h, n] * x0[f, n] + b[m])
//
// for m < M and every column n < NTP, in f32. Each thread owns an
// 8 (maps) x 8 (columns) register tile; the columns are two groups of
// four, kCW/2 apart, so float4 reads of shared memory are free of bank
// conflicts. Weights are read 8 maps at a time from global memory (L1/L2
// resident: every block reads the same weights); UF unrolls the loop over
// f, so that many weight loads are in flight at once. No barrier inside;
// the caller synchronises before reading comp.
template <int UF = 2>
__device__ void compress_layer(const float* hid, int H, const float* xs, int F,
                               int NTP, const float* __restrict__ w,
                               const float* __restrict__ bias, int M, int MP,
                               float* comp) {
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  for (int mb = 0; mb < M; mb += kTY * kTM) {
    const int m0 = mb + ty * kTM;
    if (m0 >= M) continue;
    float bv[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) bv[i] = __ldg(bias + m0 + i);

    for (int c = 0; c < NTP; c += kCW) {
      const int c0 = c + tx * 4;
      const int c1 = c0 + kCW / 2;
      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

      for (int h = 0; h < H; ++h) {
        const float4 ha = *reinterpret_cast<const float4*>(hid + (size_t)h * NTP + c0);
        const float4 hb = *reinterpret_cast<const float4*>(hid + (size_t)h * NTP + c1);
        const float hv[kTN] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        const size_t wrow = (size_t)h * F * MP + m0;
#pragma unroll (UF)
        for (int f = 0; f < F; ++f) {
          const float4 xa = *reinterpret_cast<const float4*>(xs + (size_t)f * NTP + c0);
          const float4 xb = *reinterpret_cast<const float4*>(xs + (size_t)f * NTP + c1);
          const float xv[kTN] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
          float o[kTN];
#pragma unroll
          for (int j = 0; j < kTN; ++j) o[j] = hv[j] * xv[j];
          float wv[kTM];
          load_w8(w, wrow + (size_t)f * MP, wv);
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
}

// Raise a kernel's dynamic shared-memory limit to `smem` on the current
// device, once per device and size (a per-device attribute; `smem_set` is
// the caller's per-kernel cache).
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, int smem, int (&smem_set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace cin
