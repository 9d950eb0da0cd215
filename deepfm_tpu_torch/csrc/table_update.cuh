// Shared pieces of the embedding-table update kernels (sm_90a):
// fused_table_adam.cu and sparse_table_adam.cu, and lower_bound, kLanes and
// add_runs for the densify kernels (densify_tile.cuh).
//
//  * adam_update: the optax-ordered table update of
//    deepfm_tpu/ops/pallas/adam_kernel.py::_adam_kernel, one element at a
//    time, in its literal f32 op order:
//      g  = g + wd*p
//      g  = noclip ? g : g/gnorm*clip
//      mu = (1-b1)*g + b1*mu
//      nu = (1-b2)*(g*g) + b2*nu
//      p' = p - lr*((mu/bc1) / (sqrt(nu/bc2) + eps))
//    Every operation is an explicitly rounded intrinsic (__fmul_rn,
//    __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an
//    FMA: the result equals the same chain of separate PyTorch elementwise
//    ops bit for bit. mu and nu are stored round-to-nearest in their own
//    type (f32 or bf16); the math is f32.
//  * 16-byte vectors of 8 elements: load8 / store8 (f32 or bf16), and
//    Vec8, the same load kept raw in registers until it is unpacked, so a
//    kernel can issue its table loads long before it reads them;
//    aligned_head, the first element at which every array of a table is
//    16-byte aligned (the start of its vectors).
//  * the packed table layout (deepfm_tpu/utils/layout.py): `pack` logical
//    rows of `dcol` columns side by side in each physical row of kLanes
//    floats, logical row r in physical row r / pack from lane
//    (r % pack) * dcol; lanes from pack * dcol on are dead and hold 0.
//    pack == 1 with a row width of dcol is the logical layout.
//  * fixed-order reductions of one float a thread (block_total) and of
//    per-block partial sums to one scalar (final_sum_kernel).
//  * the segmented row sum into a shared-memory tile (add_runs), shared by
//    the densify kernels (densify_tile.cuh) and sparse_table_adam.cu, with
//    the cp.async helpers that stage its pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace table_update {

constexpr int kThreads = 256;      // threads per block of every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;        // floats per physical row, packed layout
constexpr int kVector = 8;         // elements a 16-byte vector of p (two float4)

// Per-launch scalars, read from device memory (the trainer computes them on
// the card, so no launch waits for the host): the TPU kernel's SMEM vector
// [lr, wd, gnorm, clip, bc1, bc2, eps, noclip].
struct Scalars {
  float lr, wd, gnorm, clip, bc1, bc2, eps;
  bool noclip;
};

// Static Adam constants, rounded to f32 on the host as JAX rounds its
// Python-float constants: (1 - b1), b1, (1 - b2), b2.
struct Betas {
  float one_m_b1, b1, one_m_b2, b2;
};

__device__ __forceinline__ Scalars make_scalars(const float (&s)[8]) {
  Scalars out;
  out.lr = s[0];
  out.wd = s[1];
  out.gnorm = s[2];
  out.clip = s[3];
  out.bc1 = s[4];
  out.bc2 = s[5];
  out.eps = s[6];
  out.noclip = s[7] > 0.0f;
  return out;
}

__device__ __forceinline__ Scalars load_scalars(const float* s) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
  return make_scalars(v);
}

__device__ __forceinline__ float load_moment(const float* m, int64_t i) {
  return m[i];
}
__device__ __forceinline__ float load_moment(const __nv_bfloat16* m,
                                             int64_t i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ void store_moment(float* m, int64_t i, float v) {
  m[i] = v;
}
__device__ __forceinline__ void store_moment(__nv_bfloat16* m, int64_t i,
                                             float v) {
  m[i] = __float2bfloat16_rn(v);
}

// Eight consecutive elements from a 16-byte aligned address, kept as loaded
// (two float4 of f32, or one 16-byte word of bf16) until unpack.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* src) {
    a = reinterpret_cast<const float4*>(src)[0];
    b = reinterpret_cast<const float4*>(src)[1];
  }
  __device__ __forceinline__ void unpack(float v[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* src) {
    w = *reinterpret_cast<const uint4*>(src);
  }
  // a bf16 is the upper half of the f32 of the same value
  __device__ __forceinline__ void unpack(float v[8]) const {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// Eight consecutive elements from / to a 16-byte aligned address: two
// float4 of f32, or one 16-byte word of bf16 (stored round-to-nearest,
// as store_moment stores one).
template <typename T>
__device__ __forceinline__ void load8(const T* src, float v[8]) {
  Vec8<T> r;
  r.load(src);
  r.unpack(v);
}
__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float v[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
           static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))) << 16;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
}

// The first element h in [0, kVector) at which every array (ptrs[j], of
// elements of sizes[j] bytes) is 16-byte aligned, or -1 if there is none.
inline int aligned_head(const void* const* ptrs, const int* sizes, int count) {
  for (int h = 0; h < kVector; ++h) {
    bool ok = true;
    for (int j = 0; j < count; ++j) {
      ok = ok && (reinterpret_cast<uintptr_t>(ptrs[j]) + static_cast<uintptr_t>(h) * sizes[j]) % 16 == 0;
    }
    if (ok) return h;
  }
  return -1;
}

// One element of the update; returns p' and leaves the f32 moments in
// mu / nu (the caller stores them in their type).
__device__ __forceinline__ float adam_update(float p, float grad, float& mu,
                                             float& nu, const Scalars& s,
                                             const Betas& b) {
  float g = __fadd_rn(grad, __fmul_rn(s.wd, p));
  if (!s.noclip) g = __fmul_rn(__fdiv_rn(g, s.gnorm), s.clip);
  mu = __fadd_rn(__fmul_rn(b.one_m_b1, g), __fmul_rn(b.b1, mu));
  nu = __fadd_rn(__fmul_rn(b.one_m_b2, __fmul_rn(g, g)), __fmul_rn(b.b2, nu));
  const float mu_hat = __fdiv_rn(mu, s.bc1);
  const float nu_hat = __fdiv_rn(nu, s.bc2);
  const float step = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), s.eps));
  return __fadd_rn(p, -__fmul_rn(s.lr, step));
}

// First position in sorted ids[lo, hi) whose id is >= v.
__device__ __forceinline__ int64_t lower_bound(const int* ids, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (static_cast<int64_t>(ids[mid]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The sum of one float per thread of a kThreads block, in a fixed order
// (a shuffle tree in each warp, then the warps in order), returned to
// every thread. red: kWarps floats of shared memory. Every thread must
// call it.
__device__ __forceinline__ float block_total(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[w]);
  __syncthreads();  // red may be written again
  return s;
}

// out[0] = sum of partials[0..count), in a fixed order: thread t of a
// kThreads block sums partials t, t + kThreads, ... sequentially, then
// block_total.
__global__ void final_sum_kernel(const float* __restrict__ partials,
                                 int64_t count, float* __restrict__ out) {
  __shared__ float red[kWarps];
  float v = 0.0f;
  for (int64_t i = threadIdx.x; i < count; i += kThreads) {
    v = __fadd_rn(v, partials[i]);
  }
  const float total = block_total(v, red);
  if (threadIdx.x == 0) out[0] = total;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes; dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N committed cp.async groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Adds the runs of the staged pairs [lo, hi) (ids / vals, rows of dcol
// floats) into the tile `buf` (logical row r of the tile at
// (r / pack) * width + (r % pack) * dcol, r = id - row0), each run in
// stream order onto what its slot holds: a run starts at lo and wherever
// the id changes, so a run cut by the end of a window carries its sum in
// the tile and goes on from it in the next. Warp w of a kThreads block
// takes the runs whose first pair lies in its eighth of [lo, hi), found by
// ballots (a run it takes may reach past its eighth); its lane c adds
// column c (and c + 32, ...). No block synchronisation: two runs never
// share a slot.
__device__ __forceinline__ void add_runs(const int* ids, const float* vals,
                                         int lo, int hi, int64_t row0,
                                         int dcol, int pack, int width,
                                         float* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (hi - lo + kWarps - 1) / kWarps;
  const int p0 = lo + warp * per;
  const int p1 = p0 + per < hi ? p0 + per : hi;
  for (int base = p0; base < p1; base += 32) {
    const int i = base + lane;
    unsigned heads = __ballot_sync(
        0xffffffffu, i < p1 && (i == lo || ids[i] != ids[i - 1]));
    while (heads != 0u) {
      const int a = base + __ffs(heads) - 1;
      heads &= heads - 1u;
      int b;
      if (heads != 0u) {
        b = base + __ffs(heads) - 1;
      } else {  // the run goes on to the next change of id, maybe past p1
        b = base + 32 < p1 ? base + 32 : p1;
        while (b < hi) {
          const int j = b + lane;
          const unsigned ends =
              __ballot_sync(0xffffffffu, j >= hi || ids[j] != ids[a]);
          if (ends != 0u) {
            b += __ffs(ends) - 1;
            break;
          }
          b += 32;
        }
      }
      const int r = static_cast<int>(ids[a] - row0);
      float* dst = buf + (r / pack) * width + (r % pack) * dcol;
      for (int c = lane; c < dcol; c += 32) {
        float acc = dst[c];
        for (int k = a; k < b; ++k) acc = __fadd_rn(acc, vals[k * dcol + c]);
        dst[c] = acc;
      }
    }
  }
}

}  // namespace table_update
