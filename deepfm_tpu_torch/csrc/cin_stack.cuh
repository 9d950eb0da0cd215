// Shared by the CIN-stack forward (cin_stack_fwd.cu) and backward
// (cin_stack_bwd.cu): the per-layer metadata, the f32/bf16 loads, the x0
// tile staging and one layer's compression into shared memory (the bf16
// forward, cin_stack_fwd_mma.cu, takes kMaxLayers and ensure_smem). Both
// kernels run one block of kTX * kTY threads per tile of TB samples whose
// columns are n = b_local * D + d, padded to NTP (a multiple of kTX * kTN).

#pragma once

#include <cuda_bf16.h>
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
  // eight consecutive values p[i .. i+7], i a multiple of 8
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

// x0[b0 + bl, f, d] -> xs[f, bl * D + d] as f32, zero beyond the nb
// samples of the tile and in the padding columns.
template <bool BF16>
__device__ void stage_x0(const void* __restrict__ x0, float* xs, int b0,
                         int nb, int F, int D, int NTP) {
  const size_t FD = (size_t)F * D;
  for (int i = threadIdx.x; i < F * NTP; i += kThreads) {
    const int f = i / NTP;
    const int n = i - f * NTP;
    const int bl = n / D;
    float v = 0.f;
    if (bl < nb) {
      v = Io<BF16>::load(x0, (size_t)(b0 + bl) * FD + (size_t)f * D + (n - bl * D));
    }
    xs[i] = v;
  }
}

// One layer's feature maps of the tile, as one GEMM in shared memory:
//
//   comp[m, n] = relu(sum_{k=(h,f)} Wt[k, m] * op(hid'[h, n] * x0[f, n]) + b[m])
//
// for m < M and every column n < NTP; op rounds to bf16 in bf16 mode (the
// outer product is a matmul operand). hid' is hid, rounded to bf16 first
// when round_hid is set (the backward keeps its comps in f32 and rounds the
// hidden state where the forward stored it rounded). Each thread owns an
// 8 (maps) x 8 (columns) register tile; the columns are two groups of
// four, kCW/2 apart, so float4 reads of shared memory are free of bank
// conflicts. Weights are read 8 maps at a time from global memory (L1/L2
// resident: every block reads the same weights); UF unrolls the loop over
// f, so that many weight loads are in flight at once. No barrier inside;
// the caller synchronises before reading comp.
template <bool BF16, int UF = 2>
__device__ void compress_layer(const float* hid, int H, const float* xs, int F,
                               int NTP, const void* __restrict__ w,
                               const float* __restrict__ bias, int M, int MP,
                               float* comp, bool round_hid) {
  using io = Io<BF16>;
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
        float hv[kTN] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        if (round_hid) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) hv[j] = round_bf16(hv[j]);
        }
        const size_t wrow = (size_t)h * F * MP + m0;
#pragma unroll (UF)
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
