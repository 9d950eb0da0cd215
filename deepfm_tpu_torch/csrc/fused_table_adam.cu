// Fused table Adam for Hopper (sm_90a): weight decay, global-norm clip and
// Adam from a dense table gradient, in place, in optax's literal f32 order.
//
// Replaces deepfm_tpu/ops/pallas/adam_kernel.py :: fused_table_adam /
// _adam_kernel (the two-pass path: densify, then this). The update itself
// is table_update::adam_update, shared with sparse_table_adam.cu, called
// element by element: p, mu and nu are the plain version's bit for bit.
//
// What bounds it on this card: bytes. Per element it reads p and g (f32)
// and mu, nu, and writes p, mu, nu: 20 bytes with bf16 moments, 28 with
// f32. At bench.py's 10.4M x 17 table that is 3.54 GB, about 1.06 ms at
// 3.35 TB/s. Design: the arrays are cut into a scalar head (up to the
// first element where all four pointers are 16-byte aligned), a body of
// 8-element vectors and a scalar tail (wrapper: ops/kernels/adam.py::
// vector_split; the launch recomputes the head and checks it). A thread
// takes one vector a step, with 16-byte accesses only: two float4 of p and
// of g, and one 16-byte word of bf16 moments (two float4 of f32 ones), so
// each thread keeps 96 bytes of loads in flight. A grid-stride loop over
// the vectors on as many blocks as the card holds at once; the head and
// tail (or every element, when the pointers cannot be aligned together)
// go one element a thread. The buffers are updated in place, as the TPU
// kernel aliases them.

#include "table_update.cuh"

namespace {

using namespace table_update;

template <typename M>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, M* __restrict__ mu, M* __restrict__ nu,
            const float* __restrict__ g, int64_t head, int64_t vectors,
            int64_t numel, const float* __restrict__ scalars, Betas betas) {
  const Scalars s = load_scalars(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t tail0 = head + kVector * vectors;
  // scalar elements: [0, head) and [tail0, numel)
  for (int64_t u = t; u < head + (numel - tail0); u += stride) {
    const int64_t i = u < head ? u : tail0 + (u - head);
    float m = load_moment(mu, i);
    float v = load_moment(nu, i);
    p[i] = adam_update(p[i], g[i], m, v, s, betas);
    store_moment(mu, i, m);
    store_moment(nu, i, v);
  }
  for (int64_t w = t; w < vectors; w += stride) {
    const int64_t i = head + kVector * w;
    float pv[kVector], gv[kVector], m[kVector], v[kVector];
    load8(p + i, pv);
    load8(g + i, gv);
    load8(mu + i, m);
    load8(nu + i, v);
#pragma unroll
    for (int e = 0; e < kVector; ++e) pv[e] = adam_update(pv[e], gv[e], m[e], v[e], s, betas);
    store8(p + i, pv);
    store8(mu + i, m);
    store8(nu + i, v);
  }
}

template <typename M>
cudaError_t launch(float* p, void* mu, void* nu, const float* g, int64_t head,
                   int64_t vectors, int64_t numel, const float* scalars,
                   Betas betas, cudaStream_t stream) {
  static int per_sm = 0;  // blocks an SM holds: the kernel's, asked once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel<M>, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  // the card's resident blocks, or fewer when there is less work
  const int64_t units = vectors > numel - kVector * vectors ? vectors : numel - kVector * vectors;
  int64_t grid = (units + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > cap) grid = cap;
  adam_kernel<M><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      p, static_cast<M*>(mu), static_cast<M*>(nu), g, head, vectors, numel,
      scalars, betas);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). p, g: numel f32; mu, nu: numel
// bf16 (moments_bf16 = 1) or f32; scalars: 8 f32 on the device
// [lr, wd, gnorm, clip, bc1, bc2, eps, noclip]. head and vectors are the
// caller's split (vector_split): elements [head, head + 8 * vectors) go in
// vectors, the rest one at a time; a split that does not match the
// pointers returns cudaErrorInvalidValue. Updates p, mu, nu in place.
// Returns a cudaError_t (0: launched). Nothing here synchronises.
extern "C" int fused_table_adam_launch(float* p, void* mu, void* nu,
                                       int moments_bf16, const float* g,
                                       long long numel, long long head,
                                       long long vectors,
                                       const float* scalars,
                                       float one_m_b1, float b1,
                                       float one_m_b2, float b2,
                                       void* stream) {
  if (numel < 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {p, g, mu, nu};
  const int msize = moments_bf16 ? 2 : 4;
  const int sizes[4] = {4, 4, msize, msize};
  const int h = aligned_head(ptrs, sizes, 4);
  const long long want_head = h < 0 || h > numel ? numel : h;
  if (head != want_head || vectors != (numel - want_head) / kVector) {
    return (int)cudaErrorInvalidValue;
  }
  if (numel == 0) return 0;
  const Betas betas{one_m_b1, b1, one_m_b2, b2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      moments_bf16
          ? launch<__nv_bfloat16>(p, mu, nu, g, head, vectors, numel, scalars, betas, s)
          : launch<float>(p, mu, nu, g, head, vectors, numel, scalars, betas, s);
  return (int)err;
}

extern "C" const char* fused_table_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
