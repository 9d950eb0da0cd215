// Embedding-row gather for Hopper (sm_90a): out[i] = table[ids[i]] for a
// (V, C) f32 table, the opt-in lookup of pallas.use_embedding_kernel.
//
// Replaces deepfm_tpu/ops/pallas/embedding_kernel.py :: pallas_lookup /
// _gather_kernel. The TPU kernel copies each id's aligned 512-byte line of
// a (V/g, 128) view into VMEM with a window of async DMAs and selects the
// row's lanes on the VPU; it needs C | 128, V % (128 / C) == 0 and an id
// count that is a multiple of its 1024-id tile, and otherwise falls back to
// XLA's gather (at d = 16 the table has C = 17 columns, so on the TPU the
// JAX package never engages it). None of that is a constraint here: any
// (V, C), any count. An id outside [0, V) reads nothing and yields a zero
// row, so the kernel never reads outside the table.
//
// What bounds it on this card: bytes. Each gathered row is read once and
// written once (2 * n * C * 4 bytes) and the ids once (8 bytes each): 61 MB
// at bench.py's 425,984 ids x 17 columns, about 0.018 ms at 3.35 TB/s.
// Design: one thread per output element, consecutive threads on
// consecutive output addresses (so neighbouring threads also read
// neighbouring columns of one row), a grid-stride loop; 32-bit index
// arithmetic when n * C fits in it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ table, int64_t V, int C,
                  const int64_t* __restrict__ ids, I total,
                  float* __restrict__ out) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  const I cols = static_cast<I>(C);
  for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const I r = i / cols;
    const I c = i - r * cols;
    const int64_t id = ids[r];
    out[i] = (id >= 0 && id < V) ? table[id * C + c] : 0.0f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). table (V, C) f32, ids (n,)
// int64, out (n, C) f32. Returns a cudaError_t (0: launched). Nothing here
// synchronises.
extern "C" int row_gather_launch(const float* table, long long V, int C,
                                 const long long* ids, long long n, float* out,
                                 void* stream) {
  if (C < 1 || V < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(n) * C;
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t grid = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;  // 16 blocks per SM
  if (grid > cap) grid = cap;
  const int64_t* id64 = reinterpret_cast<const int64_t*>(ids);
  if (total <= INT32_MAX) {
    row_gather_kernel<uint32_t><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        table, V, C, id64, static_cast<uint32_t>(total), out);
  } else {
    row_gather_kernel<int64_t><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        table, V, C, id64, total, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* row_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
