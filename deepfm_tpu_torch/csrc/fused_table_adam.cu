// Fused table Adam for Hopper (sm_90a): weight decay, global-norm clip and
// Adam from a dense table gradient, in place, in optax's literal f32 order.
//
// Replaces deepfm_tpu/ops/pallas/adam_kernel.py :: fused_table_adam /
// _adam_kernel (the two-pass path: densify, then this). The update itself
// is table_update::adam_update, shared with sparse_table_adam.cu.
//
// What bounds it on this card: bytes. Per element it reads p and g (f32)
// and mu, nu, and writes p, mu, nu: 20 bytes with bf16 moments, 28 with
// f32. At bench.py's 10.4M x 17 table that is 3.54 GB, about 1.06 ms at
// 3.35 TB/s. Design: a grid-stride loop, one element per thread per step,
// consecutive threads on consecutive addresses; the buffers are updated in
// place, as the TPU kernel aliases them.

#include "table_update.cuh"

namespace {

using namespace table_update;

template <typename M>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, M* __restrict__ mu, M* __restrict__ nu,
            const float* __restrict__ g, int64_t numel,
            const float* __restrict__ scalars, Betas betas) {
  const Scalars s = load_scalars(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < numel; i += stride) {
    float m = load_moment(mu, i);
    float v = load_moment(nu, i);
    p[i] = adam_update(p[i], g[i], m, v, s, betas);
    store_moment(mu, i, m);
    store_moment(nu, i, v);
  }
}

template <typename M>
cudaError_t launch(float* p, void* mu, void* nu, const float* g, int64_t numel,
                   const float* scalars, Betas betas, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int64_t grid = (numel + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;  // 16 blocks per SM
  if (grid > cap) grid = cap;
  adam_kernel<M><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      p, static_cast<M*>(mu), static_cast<M*>(nu), g, numel, scalars, betas);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). p, g: numel f32; mu, nu: numel
// bf16 (moments_bf16 = 1) or f32; scalars: 8 f32 on the device
// [lr, wd, gnorm, clip, bc1, bc2, eps, noclip]. Updates p, mu, nu in place.
// Returns a cudaError_t (0: launched). Nothing here synchronises.
extern "C" int fused_table_adam_launch(float* p, void* mu, void* nu,
                                       int moments_bf16, const float* g,
                                       long long numel, const float* scalars,
                                       float one_m_b1, float b1,
                                       float one_m_b2, float b2,
                                       void* stream) {
  if (numel <= 0) return 0;
  const Betas betas{one_m_b1, b1, one_m_b2, b2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      moments_bf16
          ? launch<__nv_bfloat16>(p, mu, nu, g, numel, scalars, betas, s)
          : launch<float>(p, mu, nu, g, numel, scalars, betas, s);
  return (int)err;
}

extern "C" const char* fused_table_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
