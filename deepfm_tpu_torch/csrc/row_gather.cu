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
// Design: one warp owns 32 consecutive rows of the output. Each lane loads
// one id (one coalesced 256-byte read a warp) and turns it into a row offset
// (-1 outside the table). The warp's output span, 32 * C floats, starts on a
// 128-byte boundary, so it is written in 16-byte stores: a lane's float4
// covers four consecutive elements, whose row offsets come from the owning
// lanes by shuffle, with one division by C per float4 (none per element).
// The table reads stay 4-byte: at C = 17 a row is 68 bytes at any 4-byte
// alignment, but consecutive lanes read consecutive floats of the same or
// the next row, so a warp's loads coalesce into the rows' sectors. The grid
// covers the rows (no grid-stride loop, no device query at launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The four elements of the span starting at element e, from row r, column c.
__device__ __forceinline__ float4 gather4(const float* __restrict__ table,
                                          long long off, int e, int C) {
  int r = e / C;
  int c = e - r * C;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long o = __shfl_sync(kFull, off, r & 31);
    v[k] = o >= 0 ? __ldg(table + o + c) : 0.0f;
    if (++c == C) {
      c = 0;
      ++r;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ table, long long V, int C,
                  const long long* __restrict__ ids, long long n,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (row0 >= n) return;  // whole warps leave together
  const int nr = n - row0 < 32 ? (int)(n - row0) : 32;
  long long off = -1;
  if (lane < nr) {
    const long long id = ids[row0 + lane];
    if (id >= 0 && id < V) off = id * C;
  }
  float* dst = out + row0 * C;  // 128-byte aligned: row0 is a multiple of 32
  const int total = nr * C;
  const int nq = total >> 2;
  // every lane runs every iteration (the shuffles need the whole warp);
  // unrolled so that several float4s' loads are in flight at once
#pragma unroll 4
  for (int base = 0; base < nq; base += 32) {
    const int q = base + lane;
    const float4 v = gather4(table, off, (q < nq ? q : 0) * 4, C);
    if (q < nq) reinterpret_cast<float4*>(dst)[q] = v;
  }
  const int rem = total - nq * 4;  // only the last, partial warp has one
  if (rem) {
    const int e = nq * 4 + (lane < rem ? lane : 0);
    const int r = e / C;
    const long long o = __shfl_sync(kFull, off, r);
    if (lane < rem) dst[e] = o >= 0 ? __ldg(table + o + (e - r * C)) : 0.0f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). table (V, C) f32, ids (n,)
// int64, out (n, C) f32, all on CUDA device `device`, out from a fresh
// allocation (16-byte aligned). Launches on `stream`, switching the
// current device only if it differs. Returns a cudaError_t (0: launched).
// Nothing here synchronises.
extern "C" int row_gather_launch(const float* table, long long V, int C,
                                 const long long* ids, long long n, float* out,
                                 int device, void* stream) {
  if (C < 1 || C > (1 << 25) || V < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const long long warps = (n + 31) / 32;
  const long long grid = (warps + kWarps - 1) / kWarps;
  row_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      table, V, C, reinterpret_cast<const long long*>(ids), n, out);
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return (int)err;
}

extern "C" const char* row_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
