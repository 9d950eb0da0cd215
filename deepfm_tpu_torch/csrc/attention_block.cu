// Field self-attention block of AttentionDeepFM for Hopper (sm_90a): the
// forward. (The backward is csrc/attention_bwd.cu.)
//
// Replaces deepfm_tpu/ops/pallas/attention_fmajor_kernel.py ::
// make_attention_block_fmajor.forward / _attn_fwd_kernel. Per sample, with
// x (F, d):
//
//   qkv = x . [wq|wk|wv] + [bq|bk|bv]                       (F, 3a), f32
//   s_ij = (q_i . k_j) * hd^-1/2 per head; w = softmax_j(s)  f32, expf
//   ctx_i = sum_j w_ij v_j                                   (F, a), f32
//   out = op(ctx) . wo + bo;  with residual: LayerNorm(out + x) * ls + lb
//
// op casts to the compute type (x's: bf16 or f32); the weights arrive in
// that type, the biases and LayerNorm parameters in f32, q/k/v, scores,
// softmax and context stay f32, every product accumulates in f32, and the
// output leaves in x's type. This is the TPU kernel's rounding, not
// block_oracle's (which computes everything in bf16).
//
// What bounds it on this card: bytes at bench.py's shape (B=16384, F=27,
// d=16, a=64, H=4): ~6.7 GFLOP against ~28 MB of x and out in bf16. Here
// the work is tiny per sample and latency-bound: one block walks a fixed
// share of the samples (grid-stride), keeps the weights and every
// per-sample tensor in shared memory, and runs each stage with one thread
// per output element (FP32 FMA pipes, no tensor cores), the attention core
// included: one thread per score, per softmax row and per context element,
// not one per (query, head). Shared-memory reads are kept off bank
// conflicts: qkv and score rows have odd strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kLnEps = 1e-5f;

template <bool BF16>
struct Io;

template <>
struct Io<false> {
  __device__ static float load(const void* p, size_t i) {
    return static_cast<const float*>(p)[i];
  }
  __device__ static void store(void* p, size_t i, float v) {
    static_cast<float*>(p)[i] = v;
  }
  __device__ static float op(float x) { return x; }
};

template <>
struct Io<true> {
  __device__ static float load(const void* p, size_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static void store(void* p, size_t i, float v) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
  __device__ static float op(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

struct Shape {
  int B, F, d, a, H, hd;
  // Row strides of the score rows (F) and of qkv (3a), each rounded up to
  // an odd number, so that threads reading down a column of either touch
  // distinct shared-memory banks.
  int FS, QS;
  float scale;
  int residual;
};

// qkv[f, j] = sum_c x[f, c] * wqkv[c, j] + bqkv[j], row stride QS
__device__ void project_qkv(const float* xs, const float* wqkv,
                            const float* bqkv, float* qkv, const Shape& s,
                            int nt) {
  const int a3 = 3 * s.a;
  for (int i = threadIdx.x; i < s.F * a3; i += nt) {
    const int f = i / a3;
    const int j = i - f * a3;
    float acc = 0.f;
    for (int c = 0; c < s.d; ++c) acc = fmaf(xs[f * s.d + c], wqkv[c * a3 + j], acc);
    qkv[f * s.QS + j] = acc + bqkv[j];
  }
}

// The attention core in stages of one thread per output element, so that
// each stage has thousands of independent sums (not one per query and
// head); a head's slice of a row of a, b or out starts at h * hd.
//
// out[(i*H + h)*FS + j] = scale * sum_e a[i, h, e] * b[j, h, e], each sum
// in order of e: the scores of every query, head and key.
__device__ void head_dots(const float* a, int astride, const float* b,
                          int bstride, float scale, float* out, const Shape& s,
                          int nt) {
  for (int t = threadIdx.x; t < s.F * s.H * s.F; t += nt) {
    const int ih = t / s.F;
    const int j = t - ih * s.F;
    const int i = ih / s.H;
    const int h = ih - i * s.H;
    const float* ar = a + i * astride + h * s.hd;
    const float* br = b + j * bstride + h * s.hd;
    float dot = 0.f;
    for (int e = 0; e < s.hd; ++e) dot = fmaf(ar[e], br[e], dot);
    out[ih * s.FS + j] = dot * scale;
  }
}

// w[(i*H + h)*FS + j] over j: the softmax of each row, in place, with its
// maximum subtracted, one thread per row.
__device__ void softmax_rows(float* w, const Shape& s, int nt) {
  for (int t = threadIdx.x; t < s.F * s.H; t += nt) {
    float* row = w + t * s.FS;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < s.F; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < s.F; ++j) {
      const float ex = expf(row[j] - mx);
      row[j] = ex;
      sum += ex;
    }
    for (int j = 0; j < s.F; ++j) row[j] = row[j] / sum;
  }
}

// out[i, c] = sum_j w[(i*H + h)*FS + j] * b[j, c] for every query i and
// column c = h*hd + e, each sum in order of j.
__device__ void head_mix(const float* w, const float* b, int bstride,
                         float* out, int ostride, const Shape& s, int nt) {
  for (int t = threadIdx.x; t < s.F * s.a; t += nt) {
    const int r = t / s.a;
    const int c = t - r * s.a;
    const int h = c / s.hd;
    float acc = 0.f;
    const float* row = w + (r * s.H + h) * s.FS;
    for (int j = 0; j < s.F; ++j) acc = fmaf(row[j], b[j * bstride + c], acc);
    out[r * ostride + c] = acc;
  }
}

// The forward's attention: the softmax weights into w and the context into
// ctx (F x a). Ends with the caller's barrier.
__device__ void attend(const float* qkv, float* w, float* ctx, const Shape& s,
                       int nt) {
  head_dots(qkv, s.QS, qkv + s.a, s.QS, s.scale, w, s, nt);
  __syncthreads();
  softmax_rows(w, s, nt);
  __syncthreads();
  head_mix(w, qkv + 2 * s.a, s.QS, ctx, s.a, s, nt);
}

// y[f, c] = sum_j op(ctx[f, j]) * wo[j, c] + bo[c] (+ x[f, c])
template <bool BF16>
__device__ void project_out(const float* ctx, const float* wo, const float* bo,
                            const float* xs, float* y, const Shape& s, int nt) {
  for (int i = threadIdx.x; i < s.F * s.d; i += nt) {
    const int f = i / s.d;
    const int c = i - f * s.d;
    float acc = 0.f;
    for (int j = 0; j < s.a; ++j) {
      acc = fmaf(Io<BF16>::op(ctx[f * s.a + j]), wo[j * s.d + c], acc);
    }
    float v = acc + bo[c];
    if (s.residual) v += xs[i];
    y[i] = v;
  }
}

// Weights in shared memory: wqkv (d, 3a) and wo (a, d) in the compute type
// (loaded as f32 values), bqkv, bo, ls, lb in f32.
template <bool BF16>
__device__ void load_weights(const void* wqkv_g, const float* bqkv_g,
                             const void* wo_g, const float* bo_g,
                             const float* ls_g, const float* lb_g, float* wqkv,
                             float* bqkv, float* wo, float* bo, float* ls,
                             float* lb, const Shape& s, int nt) {
  for (int i = threadIdx.x; i < s.d * 3 * s.a; i += nt) wqkv[i] = Io<BF16>::load(wqkv_g, i);
  for (int i = threadIdx.x; i < s.a * s.d; i += nt) wo[i] = Io<BF16>::load(wo_g, i);
  for (int i = threadIdx.x; i < 3 * s.a; i += nt) bqkv[i] = bqkv_g[i];
  for (int i = threadIdx.x; i < s.d; i += nt) {
    bo[i] = bo_g[i];
    ls[i] = ls_g[i];
    lb[i] = lb_g[i];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kFwdThreads)
attn_fwd_kernel(const void* __restrict__ x, const void* __restrict__ wqkv_g,
                const float* __restrict__ bqkv_g, const void* __restrict__ wo_g,
                const float* __restrict__ bo_g, const float* __restrict__ ls_g,
                const float* __restrict__ lb_g, void* __restrict__ out,
                const Shape s) {
  using io = Io<BF16>;
  constexpr int NT = kFwdThreads;
  extern __shared__ float smem[];
  const int Fd = s.F * s.d;
  float* wqkv = smem;                       // d x 3a
  float* wo = wqkv + s.d * 3 * s.a;         // a x d
  float* bqkv = wo + s.a * s.d;             // 3a
  float* bo = bqkv + 3 * s.a;               // d
  float* ls = bo + s.d;                     // d
  float* lb = ls + s.d;                     // d
  float* xs = lb + s.d;                     // F x d
  float* qkv = xs + Fd;                     // F x QS
  float* w = qkv + s.F * s.QS;              // F x H x FS
  float* ctx = w + s.F * s.H * s.FS;        // F x a
  float* y = ctx + s.F * s.a;               // F x d

  load_weights<BF16>(wqkv_g, bqkv_g, wo_g, bo_g, ls_g, lb_g, wqkv, bqkv, wo,
                     bo, ls, lb, s, NT);
  for (int b = blockIdx.x; b < s.B; b += gridDim.x) {
    __syncthreads();  // the previous sample is done with the buffers
    for (int i = threadIdx.x; i < Fd; i += NT) xs[i] = io::load(x, (size_t)b * Fd + i);
    __syncthreads();
    project_qkv(xs, wqkv, bqkv, qkv, s, NT);
    __syncthreads();
    attend(qkv, w, ctx, s, NT);
    __syncthreads();
    project_out<BF16>(ctx, wo, bo, xs, y, s, NT);
    __syncthreads();
    if (s.residual) {
      for (int f = threadIdx.x; f < s.F; f += NT) {
        const float* r = y + f * s.d;
        float mean = 0.f;
        for (int c = 0; c < s.d; ++c) mean += r[c];
        mean /= s.d;
        float var = 0.f;
        for (int c = 0; c < s.d; ++c) var += (r[c] - mean) * (r[c] - mean);
        var /= s.d;
        const float inv = rsqrtf(var + kLnEps);
        for (int c = 0; c < s.d; ++c) {
          io::store(out, (size_t)b * Fd + f * s.d + c,
                    (r[c] - mean) * inv * ls[c] + lb[c]);
        }
      }
    } else {
      for (int i = threadIdx.x; i < Fd; i += NT) io::store(out, (size_t)b * Fd + i, y[i]);
    }
  }
}

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

Shape make_shape(int B, int F, int d, int a, int H, float scale, int residual) {
  Shape s;
  s.B = B; s.F = F; s.d = d; s.a = a; s.H = H; s.hd = a / H;
  s.FS = F | 1;
  s.QS = (3 * a) | 1;
  s.scale = scale; s.residual = residual;
  return s;
}

template <bool BF16>
cudaError_t fwd(const void* x, const void* wqkv, const float* bqkv,
                const void* wo, const float* bo, const float* ls,
                const float* lb, void* out, const Shape& s, int grid, int smem,
                cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem(attn_fwd_kernel<BF16>, smem, smem_set);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<BF16><<<grid, kFwdThreads, smem, stream>>>(
      x, wqkv, bqkv, wo, bo, ls, lb, out, s);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); every pointer is a device
// pointer. x and out (B, F, d), wqkv (d, 3a) and wo (a, d) in the compute
// type (bf16 selects bf16); bqkv (3a,), bo, ls, lb (d,) f32. `grid` blocks
// walk the batch; `smem` is the dynamic shared memory of one block (the
// wrapper's plan). Returns a cudaError_t, 0 on a successful launch; the
// kernel runs on `stream` and nothing here synchronises.
extern "C" int attention_block_fwd(const void* x, const void* wqkv,
                                   const float* bqkv, const void* wo,
                                   const float* bo, const float* ls,
                                   const float* lb, void* out, int B, int F,
                                   int d, int a, int H, float scale,
                                   int residual, int bf16, int grid, int smem,
                                   void* stream) {
  if (H < 1 || a % H != 0) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(B, F, d, a, H, scale, residual);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? fwd<true>(x, wqkv, bqkv, wo, bo, ls, lb, out, s, grid, smem, st)
           : fwd<false>(x, wqkv, bqkv, wo, bo, ls, lb, out, s, grid, smem, st);
  return (int)err;
}

// Message for an error code returned by the entry point.
extern "C" const char* attention_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
