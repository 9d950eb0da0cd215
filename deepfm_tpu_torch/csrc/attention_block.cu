// Field self-attention block of AttentionDeepFM for Hopper (sm_90a):
// forward and backward, two entry points in one source.
//
// Replaces deepfm_tpu/ops/pallas/attention_fmajor_kernel.py ::
// make_attention_block_fmajor.forward / _attn_fwd_kernel and
// .backward / _attn_bwd_kernel. Per sample, with x (F, d):
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
// The backward recomputes the forward per sample (as the TPU kernel does:
// the softmax weights of a batch would be B*H*F*F*4 bytes in device
// memory), then: the LayerNorm/residual adjoint; dbo, dWo = op(ctx)^T
// op(dout), dctx = op(dout) . op(wo)^T; per query the softmax adjoint
// ds = w * (dw - sum(dw * w)) * scale with dq, dk, dv; dall = [dq|dk|dv];
// dWqkv = op(dall)^T x, dbqkv = sum dall (f32), dx = dy + op(dall) . Wqkv^T.
//
// What bounds it on this card: bytes at bench.py's shape (B=16384, F=27,
// d=16, a=64, H=4): the forward is ~6.7 GFLOP against ~28 MB of x and
// out in bf16, the backward ~20 GFLOP against ~57 MB. Here the work is
// tiny per sample and latency-bound: one block walks a fixed share of the
// samples (grid-stride), keeps the weights and every per-sample tensor in
// shared memory, and runs each stage with one thread per output element
// (FP32 FMA pipes, no tensor cores), the attention core included: one
// thread per score, per softmax row and per context element, not one per
// (query, head). Shared-memory reads are kept off bank conflicts: qkv and
// score rows have odd strides, and the backward reads transposed copies of
// wqkv and wo.
//
// Cross-sample sums (every parameter gradient, ~4.3k floats at the bench
// shape) accumulate in shared memory per block in sample order, each
// element owned by one thread; each block writes its partials and
// attn_reduce_kernel adds them in block order. No float atomics: two
// launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
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
// in order of e: the scores (or their adjoints) of every query, head and
// key.
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
// column c = h*hd + e (by keys), or, with `by_query`, out[j, c] =
// sum_i w[(i*H + h)*FS + j] * b[i, c] for every key j; each sum in order.
__device__ void head_mix(const float* w, const float* b, int bstride,
                         float* out, int ostride, bool by_query,
                         const Shape& s, int nt) {
  for (int t = threadIdx.x; t < s.F * s.a; t += nt) {
    const int r = t / s.a;
    const int c = t - r * s.a;
    const int h = c / s.hd;
    float acc = 0.f;
    if (by_query) {
      for (int i = 0; i < s.F; ++i) {
        acc = fmaf(w[(i * s.H + h) * s.FS + r], b[i * bstride + c], acc);
      }
    } else {
      const float* row = w + (r * s.H + h) * s.FS;
      for (int j = 0; j < s.F; ++j) acc = fmaf(row[j], b[j * bstride + c], acc);
    }
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
  head_mix(w, qkv + 2 * s.a, s.QS, ctx, s.a, false, s, nt);
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

// Gradient partial layout per block: dwqkv (d, 3a) | dbqkv (3a) | dwo (a, d)
// | dbo (d) | dls (d) | dlb (d).
template <bool BF16>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_kernel(const void* __restrict__ x, const float* __restrict__ g,
                const void* __restrict__ wqkv_g, const float* __restrict__ bqkv_g,
                const void* __restrict__ wo_g, const float* __restrict__ bo_g,
                const float* __restrict__ ls_g, void* __restrict__ dx,
                float* __restrict__ part, const int n_part, const Shape s) {
  using io = Io<BF16>;
  constexpr int NT = kBwdThreads;
  extern __shared__ float smem[];
  const int Fd = s.F * s.d;
  const int a3 = 3 * s.a;
  const int FHF = s.F * s.H * s.FS;
  float* wqkv = smem;                 // d x 3a
  float* wo = wqkv + s.d * a3;        // a x d
  float* bqkv = wo + s.a * s.d;       // 3a
  float* bo = bqkv + a3;              // d
  float* ls = bo + s.d;               // d
  float* acc = ls + s.d;              // n_part: the gradient partials
  float* dwqkv = acc;                 // d x 3a
  float* dbqkv = dwqkv + s.d * a3;    // 3a
  float* dwo = dbqkv + a3;            // a x d
  float* dbo = dwo + s.a * s.d;       // d
  float* dls = dbo + s.d;             // d
  float* dlb = dls + s.d;             // d
  float* wqkvt = acc + n_part;        // 3a x d: wqkv transposed
  float* wot = wqkvt + a3 * s.d;      // d x a: wo transposed
  float* xs = wot + s.d * s.a;        // F x d
  float* gb = xs + Fd;                // F x d: the sample's cotangent, f32
  float* yn = gb + Fd;                // F x d: y, then the normalised y
  float* dout = yn + Fd;              // F x d: dout (= dx through the residual)
  float* qkv = dout + Fd;             // F x QS
  float* dall = qkv + s.F * s.QS;     // F x 3a: [dq | dk | dv]
  float* w = dall + s.F * a3;         // F x H x FS softmax weights
  float* ds = w + FHF;                // F x H x FS softmax adjoint
  float* ctx = ds + FHF;              // F x a
  float* dctx = ctx + s.F * s.a;      // F x a

  // (the LayerNorm bias has no part in the backward: ls stands in for it)
  load_weights<BF16>(wqkv_g, bqkv_g, wo_g, bo_g, ls_g, ls_g, wqkv, bqkv, wo,
                     bo, ls, ls, s, NT);
  // the transposed copies keep the dctx and dx products' weight reads on
  // consecutive banks
  for (int i = threadIdx.x; i < s.d * a3; i += NT) {
    const int c = i / a3;
    const int j = i - c * a3;
    wqkvt[j * s.d + c] = io::load(wqkv_g, i);
  }
  for (int i = threadIdx.x; i < s.a * s.d; i += NT) {
    const int j = i / s.d;
    const int c = i - j * s.d;
    wot[c * s.a + j] = io::load(wo_g, i);
  }
  for (int i = threadIdx.x; i < n_part; i += NT) acc[i] = 0.f;

  for (int b = blockIdx.x; b < s.B; b += gridDim.x) {
    __syncthreads();
    for (int i = threadIdx.x; i < Fd; i += NT) {
      xs[i] = io::load(x, (size_t)b * Fd + i);
      gb[i] = g[(size_t)b * Fd + i];
    }
    __syncthreads();
    // ---- forward recompute
    project_qkv(xs, wqkv, bqkv, qkv, s, NT);
    __syncthreads();
    attend(qkv, w, ctx, s, NT);
    __syncthreads();
    // ---- LayerNorm / residual adjoint
    if (s.residual) {
      project_out<BF16>(ctx, wo, bo, xs, yn, s, NT);
      __syncthreads();
      for (int f = threadIdx.x; f < s.F; f += NT) {
        float* r = yn + f * s.d;
        const float* gr = gb + f * s.d;
        float mean = 0.f;
        for (int c = 0; c < s.d; ++c) mean += r[c];
        mean /= s.d;
        float var = 0.f;
        for (int c = 0; c < s.d; ++c) var += (r[c] - mean) * (r[c] - mean);
        var /= s.d;
        const float inv = rsqrtf(var + kLnEps);
        float m1 = 0.f, m2 = 0.f;
        for (int c = 0; c < s.d; ++c) {
          r[c] = (r[c] - mean) * inv;
          const float dyn = gr[c] * ls[c];
          m1 += dyn;
          m2 += dyn * r[c];
        }
        m1 /= s.d;
        m2 /= s.d;
        for (int c = 0; c < s.d; ++c) {
          dout[f * s.d + c] = inv * (gr[c] * ls[c] - m1 - r[c] * m2);
        }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < s.d; c += NT) {
        float sl = 0.f, sb = 0.f;
        for (int f = 0; f < s.F; ++f) {
          sl += gb[f * s.d + c] * yn[f * s.d + c];
          sb += gb[f * s.d + c];
        }
        dls[c] += sl;
        dlb[c] += sb;
      }
    } else {
      for (int i = threadIdx.x; i < Fd; i += NT) dout[i] = gb[i];
      __syncthreads();
    }
    // ---- output projection adjoint
    for (int c = threadIdx.x; c < s.d; c += NT) {
      float sb = 0.f;
      for (int f = 0; f < s.F; ++f) sb += dout[f * s.d + c];
      dbo[c] += sb;
    }
    for (int i = threadIdx.x; i < s.a * s.d; i += NT) {
      const int j = i / s.d;
      const int c = i - j * s.d;
      float v = 0.f;
      for (int f = 0; f < s.F; ++f) {
        v = fmaf(io::op(ctx[f * s.a + j]), io::op(dout[f * s.d + c]), v);
      }
      dwo[i] += v;
    }
    for (int i = threadIdx.x; i < s.F * s.a; i += NT) {
      const int f = i / s.a;
      const int j = i - f * s.a;
      float v = 0.f;
      for (int c = 0; c < s.d; ++c) v = fmaf(io::op(dout[f * s.d + c]), wot[c * s.a + j], v);
      dctx[i] = v;
    }
    __syncthreads();
    // ---- attention core adjoint: dw = dctx . v, the softmax adjoint ds,
    // then dq = ds . k, dk = ds^T . q and dv = w^T . dctx
    head_dots(dctx, s.a, qkv + 2 * s.a, s.QS, 1.f, ds, s, NT);
    __syncthreads();
    for (int t = threadIdx.x; t < s.F * s.H; t += NT) {
      const float* wr = w + t * s.FS;
      float* dr = ds + t * s.FS;
      float sdot = 0.f;
      for (int j = 0; j < s.F; ++j) sdot += dr[j] * wr[j];
      for (int j = 0; j < s.F; ++j) dr[j] = wr[j] * (dr[j] - sdot) * s.scale;
    }
    __syncthreads();
    head_mix(ds, qkv + s.a, s.QS, dall, a3, false, s, NT);
    head_mix(ds, qkv, s.QS, dall + s.a, a3, true, s, NT);
    head_mix(w, dctx, s.a, dall + 2 * s.a, a3, true, s, NT);
    __syncthreads();
    // ---- projection adjoints and dx
    for (int i = threadIdx.x; i < s.d * a3; i += NT) {
      const int c = i / a3;
      const int j = i - c * a3;
      float v = 0.f;
      for (int f = 0; f < s.F; ++f) v = fmaf(io::op(dall[f * a3 + j]), xs[f * s.d + c], v);
      dwqkv[i] += v;
    }
    for (int j = threadIdx.x; j < a3; j += NT) {
      float v = 0.f;
      for (int f = 0; f < s.F; ++f) v += dall[f * a3 + j];
      dbqkv[j] += v;
    }
    for (int i = threadIdx.x; i < Fd; i += NT) {
      const int f = i / s.d;
      const int c = i - f * s.d;
      float v = 0.f;
      for (int j = 0; j < a3; ++j) v = fmaf(io::op(dall[f * a3 + j]), wqkvt[j * s.d + c], v);
      io::store(dx, (size_t)b * Fd + i, (s.residual ? dout[i] : 0.f) + v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_part; i += NT) part[(size_t)blockIdx.x * n_part + i] = acc[i];
}

// out[i] = sum over blocks of part[blk, i], in block order.
__global__ void attn_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, const int n,
                                   const int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int t = 0; t < blocks; ++t) v += part[(size_t)t * n + i];
  out[i] = v;
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

template <bool BF16>
cudaError_t bwd(const void* x, const float* g, const void* wqkv,
                const float* bqkv, const void* wo, const float* bo,
                const float* ls, void* dx, float* part, float* grads,
                int n_part, const Shape& s, int grid, int smem,
                cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  cudaError_t err = ensure_smem(attn_bwd_kernel<BF16>, smem, smem_set);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<BF16><<<grid, kBwdThreads, smem, stream>>>(
      x, g, wqkv, bqkv, wo, bo, ls, dx, part, n_part, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_reduce_kernel<<<(n_part + 255) / 256, 256, 0, stream>>>(part, grads,
                                                                n_part, grid);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes); every pointer is a device
// pointer. x and out (B, F, d), wqkv (d, 3a) and wo (a, d) in the compute
// type (bf16 selects bf16); bqkv (3a,), bo, ls, lb (d,) f32. `grid` blocks
// walk the batch; `smem` is the dynamic shared memory of one block (the
// wrapper's plan). Each returns a cudaError_t, 0 on a successful launch;
// the kernels run on `stream` and nothing here synchronises.
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

// g (B, F, d) f32; dx (B, F, d) in the compute type; part (grid, n_part)
// f32 workspace; grads (n_part,) f32 in the partial layout above.
extern "C" int attention_block_bwd(const void* x, const float* g,
                                   const void* wqkv, const float* bqkv,
                                   const void* wo, const float* bo,
                                   const float* ls, void* dx, float* part,
                                   float* grads, int n_part, int B, int F,
                                   int d, int a, int H, float scale,
                                   int residual, int bf16, int grid, int smem,
                                   void* stream) {
  if (H < 1 || a % H != 0) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(B, F, d, a, H, scale, residual);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? bwd<true>(x, g, wqkv, bqkv, wo, bo, ls, dx, part, grads, n_part, s,
                       grid, smem, st)
           : bwd<false>(x, g, wqkv, bqkv, wo, bo, ls, dx, part, grads, n_part,
                        s, grid, smem, st);
  return (int)err;
}

// Message for an error code returned by the entry points.
extern "C" const char* attention_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
