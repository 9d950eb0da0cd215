// Shared by the bf16 CIN-stack forward (cin_stack_fwd_mma.cu) and the
// bf16 CIN-stack backward (cin_stack_bwd_mma.cu): the mma.sync m16n8k16
// primitives, the weight stages and the per-layer product of the
// forward, whose comps the backward's remat repeats bit for bit.
//
// The layer product (see cin_stack_fwd_mma.cu for its design):
//
//   acc[m, n] = sum over k16 steps (f-chunk outer, h inner) of the step's
//               16 products, each step from a zero accumulator, added to
//               the f32 sums by round-to-nearest adds,
//
// with A = W re-laid out as (round_up(M, 16), H * Fp) bf16 (column
// h * Fp + f), streamed through shared memory, and B = op(hid[h, n] *
// x0[f, n]) formed in registers as bf16x2 products. Every element's sum
// depends only on that step order, not on the warps, passes or chunks
// that computed it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cinmma {

using bf16 = __nv_bfloat16;

constexpr int kNT = 4;  // n8 tiles a warp in the layer product: 32 columns
constexpr int kMaxLayers = 8;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// The same four 8x8 matrices, each transposed on the way in.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// d = A B on the tensor cores, from a zero accumulator
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// acc += A B, each of the step's products from a zero accumulator
template <int N>
__device__ __forceinline__ void mma_add(float (&acc)[N], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  static_assert(N == 4, "one m16n8 tile");
  float dd[4];
  mma_bf16_zero(dd, a, b0, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += dd[q];
}

// Offset in bf16 elements of (step s, row r, 16-byte half q) in a W stage
// of RP rows a step: 32 bytes a row, the halves swapped on every other
// group of four rows.
__device__ __forceinline__ int stage_off(int s, int r, int q, int RP) {
  return ((s * RP + r) * 2 + (q ^ ((r >> 2) & 1))) * 8;
}

// A hidden-state element as a bf16 operand: the forward keeps the hidden
// state in bf16, the backward in f32 (rounded here, to the same value).
__device__ __forceinline__ bf16 as_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 as_bf16(float v) { return __float2bfloat16_rn(v); }

// The geometry of one layer product: F fields in FC chunks of 16, columns
// padded to NTP and taken NB at a time by WN groups of warps, RP maps a
// pass by WM groups, the weights staged KC k16 steps a chunk.
struct Geometry {
  int F, FC, NTP, NB, WN, WM, RP, KC;
};

// The per-layer constants of the product (H hidden rows, K16 k16 steps in
// nchunks chunks, weight rows wrow long) and the thread's place, computed
// once by the caller.
struct LayerSteps {
  int H, K16, nchunks;
  size_t wrow;
};
struct ThreadPos {
  int warp, lane, g, t, wn;
};

// One pass of the layer product: maps m0 .. m0 + rows of the column pass
// at cp0, into this warp's acc (its m16 tiles my0 .. my0 + my_mt of the
// pass, its 4 n8 tiles). hid has H rows of NTP columns; W is the re-laid
// weight, its rows H * Fp long; a W stage holds stage_elems bf16. Every
// warp of the block calls it (it has barriers); the last barrier leaves
// the stages free.
template <int WARPS, int MT, typename HidT>
__device__ __forceinline__ void layer_product(
    float (&acc)[MT][kNT][4], const bf16* xs, const HidT* hid,
    const LayerSteps& ly, const bf16* __restrict__ W, int m0, int rows,
    int cp0, bf16* stages, const Geometry& p, int Fp, int stage_elems,
    const ThreadPos& tp, int my0, int my_mt) {
  const int warp = tp.warp, lane = tp.lane, g = tp.g, t = tp.t, wn = tp.wn;
  const int F = p.F, NTP = p.NTP, RP = p.RP, KC = p.KC;
  const int H = ly.H, K16 = ly.K16, nchunks = ly.nchunks;
  const size_t wrow = ly.wrow;

  // chunk c's weights (KC steps x rows) into stage c & 1: a thread
  // loads one step's rows, 16 rows (two 16-byte halves each) per
  // group of 32 lanes, its step moving on by KC a chunk
  const int wps = WARPS > KC ? WARPS / KC : 1;  // warps a step
  const int ls = warp / wps;  // this thread's step in a chunk (none if >= KC)
  const int r_first = (warp - ls * wps) * 16 + (lane >> 1);
  const int lq = lane & 1;
  int l_fc = ls / H, l_h = ls - l_fc * H;  // of chunk 0's step (H >= 1)
  auto issue = [&](int c) {
    const int step = c * KC + ls;
    if (ls < KC && step < K16) {
      bf16* st = stages + (c & 1) * stage_elems;
      const bf16* src = W + (size_t)(m0 + r_first) * wrow + (size_t)l_h * Fp +
                        l_fc * 16 + lq * 8;
      for (int r = r_first; r < rows; r += 16 * wps) {
        cp_async16(st + stage_off(ls, r, lq, RP), src);
        src += (size_t)16 * wps * wrow;
      }
    }
    cp_async_commit();
    l_h += KC;
    while (l_h >= H) {
      l_h -= H;
      ++l_fc;
    }
  };

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  __nv_bfloat162 xr[kNT][2];  // x0[f, n], x0[f + 1, n] for f = 2t, 2t + 8
  int cur_fc = -1;
  const int ncol = cp0 + wn * 32 + g;  // the lane's column in n8 tile 0

  issue(0);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; every warp is done with c - 1
    if (c + 1 < nchunks) issue(c + 1);
    if (my_mt == 0) continue;
    const bf16* st = stages + (c & 1) * stage_elems;
    const int s0 = c * KC;
    const int ns = min(KC, K16 - s0);
    int fc = s0 / H;
    int h = s0 - fc * H;
#pragma unroll 2
    for (int s = 0; s < ns; ++s) {
      if (fc != cur_fc) {  // this lane's x0 values of f-chunk fc
        cur_fc = fc;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int f = fc * 16 + 2 * t + q * 8;
            const bf16 z = __float2bfloat16_rn(0.f);
            xr[j][q].x = f < F ? xs[(size_t)f * NTP + ncol + j * 8] : z;
            xr[j][q].y = f + 1 < F ? xs[(size_t)(f + 1) * NTP + ncol + j * 8] : z;
          }
      }
      // the step's A fragments first, so their loads are in flight
      // together
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < my_mt) {
          const int r = (my0 + i) * 16 + (lane & 15);
          ldmatrix_x4(a[i], st + stage_off(s, r, lane >> 4, RP));
        }
      }
      // B fragments: op(hid[h, n] * x0[f, n]) for k = 2t, 2t+1 and
      // 2t+8, 2t+9 of the step, n the lane's column of each n8 tile
      uint32_t bfr[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const __nv_bfloat162 hv =
            __bfloat162bfloat162(as_bf16(hid[(size_t)h * NTP + ncol + j * 8]));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const __nv_bfloat162 prod = __hmul2_rn(hv, xr[j][q]);
          bfr[j][q] = *reinterpret_cast<const uint32_t*>(&prod);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < my_mt) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_add(acc[i][j], a[i], bfr[j][0], bfr[j][1]);
        }
      }
      if (++h == H) {
        h = 0;
        ++fc;
      }
    }
  }
  __syncthreads();  // every warp is done with the stages
}

// Raise a kernel's dynamic shared-memory limit to `smem` on the current
// device, once per device and size (`smem_set` is the caller's per-kernel
// cache).
constexpr int kMaxDevices = 64;

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

}  // namespace cinmma
