// Fused PVQ matmuls against int8 pulse planes, rho applied once per group.
//
// Replaces:
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul_q (kernel v3: _kernel_q /
//     _kernel_q_bias with _contract_int8_q and _q_epilogue), and through it
//     the TPU-only DMA variant _kernel_q_dma, which computes the same
//     function;
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul (kernel v2: _kernel /
//     _kernel_bias with _accumulate_int8).
//
//   v3:  y = act(a (.) sum_g rho[g, :] * int32(x_q[:, gG:(g+1)G] @ W[gG:(g+1)G, :]) + bias)
//   v2:  y = act(sum_g rho[g, :] * (x[:, gG:(g+1)G] @ W[gG:(g+1)G, :]) + bias)
//
// What bounds it: at decode shapes (m = batch rows) the pulse plane is read
// once and each byte feeds only m multiply-adds, so it is bound by the
// bytes of W (k * n int8).  At prefill shapes (m = 512) it is bound by the
// integer multiply-adds.  This first version is simple: a CTA owns 32
// output columns (one per lane) and 8 output rows; its 8 warps split the
// contraction of each group in 4-row chunks (int8 x int8 through __dp4a on
// the v3 path, f32 FMAs on the v2 path).  The per-warp int32 partials of a
// group are summed exactly in shared memory BEFORE the group's single rho
// multiply, so a group is never split across two rho products.  No tensor
// cores, no TMA, no pipelining yet: W is read straight from global memory
// with one byte per lane per k row (32-byte coalesced rows).  On the v3
// path every float multiply and add after the integer contraction is a
// separately rounded __fmul_rn / __fadd_rn, in the plain version's order, so
// the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // contraction split inside a CTA
constexpr int kRows = 8;    // output rows per CTA (= kWarps: one output per thread)
constexpr int kCols = 32;   // output columns per CTA (one per lane)

enum Act { kNone = 0, kRelu = 1, kRelu2 = 2, kGelu = 3, kSilu = 4 };
enum AMode { kPerRow = 0, kScalar = 1, kPerTile = 2, kNoScale = 3 };

__device__ __forceinline__ float activation(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kRelu2: { const float r = fmaxf(v, 0.f); return r * r; }
    case kGelu: {  // tanh approximation, as jax.nn.gelu(approximate=True)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
    }
    case kSilu: return v / (1.f + expf(-v));
    default: return v;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ int pack_w4(const int8_t* wp, size_t n) {
  const uint32_t b0 = (uint8_t)wp[0], b1 = (uint8_t)wp[n];
  const uint32_t b2 = (uint8_t)wp[2 * n], b3 = (uint8_t)wp[3 * n];
  return (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

// Epilogue shared by both kernels: per-row act scale, bias, activation.
template <typename OutT>
__device__ __forceinline__ void epilogue(float acc, int orow, int col, int n,
                                         const float* a, int a_mode,
                                         const float* bias, int act, OutT* out) {
  float y = acc;
  if (a_mode == kPerRow) y = __fmul_rn(y, a[orow]);
  else if (a_mode == kScalar) y = __fmul_rn(y, a[0]);
  if (bias) y = __fadd_rn(y, bias[col]);
  store(out + (size_t)orow * n + col, activation(y, act));
}

// ---------------------------------------------------------------- v3 (int8 x)
template <bool kDp4a, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
pvq_matmul_q_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ rho, const float* __restrict__ a,
                    int a_mode, const float* __restrict__ bias, int act,
                    OutT* __restrict__ out, int m, int k, int n, int G) {
  __shared__ int red[kWarps][kRows][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRows;
  const int orow = row0 + warp;
  const bool colok = col < n;
  const int rows = min(kRows, m - row0);
  const int ng = k / G;
  float acc = 0.f;
  for (int g = 0; g < ng; ++g) {
    int part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0;
    const int kbeg = g * G;
    if (kDp4a) {
#pragma unroll 4
      for (int c = warp; c < G / 4; c += kWarps) {
        const int kk = kbeg + 4 * c;
        const int wv = colok ? pack_w4(w + (size_t)kk * n + col, (size_t)n) : 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const int xv = *reinterpret_cast<const int*>(x + (size_t)(row0 + r) * k + kk);
            part[r] = __dp4a(xv, wv, part[r]);
          }
        }
      }
    } else {
      for (int kk = kbeg + warp; kk < kbeg + G; kk += kWarps) {
        const int wv = colok ? (int)w[(size_t)kk * n + col] : 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows) part[r] += (int)x[(size_t)(row0 + r) * k + kk] * wv;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[warp][r][lane] = part[r];
    __syncthreads();
    if (orow < m && colok) {
      int s = 0;  // exact int32 sum of the group before its one rho multiply
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) s += red[ww][warp][lane];
      float pf = __fmul_rn((float)s, rho[(size_t)g * n + col]);
      if (a_mode == kPerTile) pf = __fmul_rn(pf, a[(size_t)orow * ng + g]);
      acc = __fadd_rn(acc, pf);
    }
    __syncthreads();
  }
  if (orow < m && colok) epilogue(acc, orow, col, n, a, a_mode, bias, act, out);
}

// ------------------------------------------------------------- v2 (float x)
template <bool kVec4, typename XT>
__global__ void __launch_bounds__(kWarps * 32)
pvq_matmul_f_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ rho, const float* __restrict__ bias,
                    int act, XT* __restrict__ out, int m, int k, int n, int G) {
  __shared__ float red[kWarps][kRows][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRows;
  const int orow = row0 + warp;
  const bool colok = col < n;
  const int rows = min(kRows, m - row0);
  const int ng = k / G;
  float acc = 0.f;
  for (int g = 0; g < ng; ++g) {
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.f;
    const int kbeg = g * G;
    if (kVec4) {
#pragma unroll 4
      for (int c = warp; c < G / 4; c += kWarps) {
        const int kk = kbeg + 4 * c;
        float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f;
        if (colok) {
          const int8_t* wp = w + (size_t)kk * n + col;
          w0 = (float)wp[0];
          w1 = (float)wp[(size_t)n];
          w2 = (float)wp[2 * (size_t)n];
          w3 = (float)wp[3 * (size_t)n];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const XT* xp = x + (size_t)(row0 + r) * k + kk;
            float p = part[r];
            p = fmaf(load_x(xp), w0, p);
            p = fmaf(load_x(xp + 1), w1, p);
            p = fmaf(load_x(xp + 2), w2, p);
            p = fmaf(load_x(xp + 3), w3, p);
            part[r] = p;
          }
        }
      }
    } else {
      for (int kk = kbeg + warp; kk < kbeg + G; kk += kWarps) {
        const float wv = colok ? (float)w[(size_t)kk * n + col] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows) part[r] = fmaf(load_x(x + (size_t)(row0 + r) * k + kk), wv, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[warp][r][lane] = part[r];
    __syncthreads();
    if (orow < m && colok) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) s += red[ww][warp][lane];
      acc = acc + s * rho[(size_t)g * n + col];
    }
    __syncthreads();
  }
  if (orow < m && colok) epilogue(acc, orow, col, n, nullptr, kNoScale, bias, act, out);
}

dim3 grid_for(int m, int n) {
  return dim3((n + kCols - 1) / kCols, (m + kRows - 1) / kRows);
}

}  // namespace

// out_bf16: 0 -> f32 output, 1 -> bf16 output.
extern "C" int pvq_matmul_q_launch(const int8_t* x, const int8_t* w,
                                   const float* rho, const float* a, int a_mode,
                                   const float* bias, int act, void* out,
                                   int out_bf16, int m, int k, int n, int G,
                                   void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (G <= 0 || k % G) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(m, n), block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const bool dp4a = (G % 4) == 0;
  if (out_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (dp4a) pvq_matmul_q_kernel<true><<<grid, block, 0, s>>>(x, w, rho, a, a_mode, bias, act, o, m, k, n, G);
    else pvq_matmul_q_kernel<false><<<grid, block, 0, s>>>(x, w, rho, a, a_mode, bias, act, o, m, k, n, G);
  } else {
    auto* o = static_cast<float*>(out);
    if (dp4a) pvq_matmul_q_kernel<true><<<grid, block, 0, s>>>(x, w, rho, a, a_mode, bias, act, o, m, k, n, G);
    else pvq_matmul_q_kernel<false><<<grid, block, 0, s>>>(x, w, rho, a, a_mode, bias, act, o, m, k, n, G);
  }
  return (int)cudaGetLastError();
}

// x_bf16: 0 -> x and out are f32, 1 -> x and out are bf16.
extern "C" int pvq_matmul_launch(const void* x, const int8_t* w, const float* rho,
                                 const float* bias, int act, void* out,
                                 int x_bf16, int m, int k, int n, int G,
                                 void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (G <= 0 || k % G) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(m, n), block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = (G % 4) == 0;
  if (x_bf16) {
    auto* xp = static_cast<const __nv_bfloat16*>(x);
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (vec4) pvq_matmul_f_kernel<true><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G);
    else pvq_matmul_f_kernel<false><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G);
  } else {
    auto* xp = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    if (vec4) pvq_matmul_f_kernel<true><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G);
    else pvq_matmul_f_kernel<false><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G);
  }
  return (int)cudaGetLastError();
}
