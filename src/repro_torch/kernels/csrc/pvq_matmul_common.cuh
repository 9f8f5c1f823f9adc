// Device code shared by pvq_matmul.cu (2-D kernels v2 and v3) and
// pvq_matmul_batched.cu (the same contractions over a leading expert axis):
// the CTA shape, the fused epilogue and the direct bodies of kernels v2
// (float activations) and v3 (int8), whose grid's z axis walks a stack of
// matrices (gridDim.z = 1 for one).
//
// A CTA owns 32 output columns (one per lane) and 8 output rows; its 8
// warps split the contraction of each group in 4-row chunks.  The per-warp
// partials of a group are summed in shared memory BEFORE the group's single
// rho multiply, so a group is never split across two rho products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pvq {

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

// Four consecutive k rows of one pulse column, packed for __dp4a.
__device__ __forceinline__ int pack_w4(const int8_t* wp, size_t n) {
  const uint32_t b0 = (uint8_t)wp[0], b1 = (uint8_t)wp[n];
  const uint32_t b2 = (uint8_t)wp[2 * n], b3 = (uint8_t)wp[3 * n];
  return (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

// The epilogue on loaded values: act scale (a_row: per row or scalar),
// bias (when has_bias), activation, store.
template <typename OutT>
__device__ __forceinline__ void finish(float acc, float a_row, int a_mode, bool has_bias,
                                       float b, int act, OutT* p) {
  float y = acc;
  if (a_mode == kPerRow || a_mode == kScalar) y = __fmul_rn(y, a_row);
  if (has_bias) y = __fadd_rn(y, b);
  store(p, activation(y, act));
}

// Epilogue: act scale (per row or scalar), bias, activation, store.
template <typename OutT>
__device__ __forceinline__ void epilogue(float acc, int orow, int col, int n,
                                         const float* a, int a_mode,
                                         const float* bias, int act, OutT* out) {
  const float a_row = a_mode == kPerRow ? a[orow] : a_mode == kScalar ? a[0] : 1.f;
  finish(acc, a_row, a_mode, bias != nullptr, bias ? bias[col] : 0.f, act,
         out + (size_t)orow * n + col);
}

// Kernel v2 (float x).  Matrix blockIdx.z of a stack starts sx / sw / ss /
// so elements after the previous one in x / w / rho / out.
//
// A group's dot accumulates in f64: every product of an f32 x and an int8
// pulse is exact there, and the sum rounds far below f32's precision, so
// the group's one rounding to f32 (then __fmul_rn by rho, __fadd_rn into
// the f32 accumulator, in the plain version's order) gives the plain
// version's f32 value whatever the order of the sum (unless the f64 sum
// lies within its own rounding error of an f32 rounding boundary).  With
// f32 sums the order showed: at bf16 a last-bit difference rounds a
// residual element the other way, and a MoE router amplifies that into
// other experts.  The wrapper (kernels/pvq_matmul.py:_v2_body) takes this
// body for the ragged shapes that the splitk body (m <= 8,
// pvq_matmul_f_splitk.cuh) and the f64 tensor-core body (m > 8,
// pvq_matmul_f_mma.cuh) do not take.  The Route tag only names the
// instance (see pvq_matmul_splitk.cuh).
template <class Route, bool kVec4, typename XT>
__global__ void __launch_bounds__(kWarps * 32)
pvq_matmul_f_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ rho, const float* __restrict__ bias,
                    int act, XT* __restrict__ out, int m, int k, int n, int G,
                    size_t sx, size_t sw, size_t ss, size_t so) {
  __shared__ double red[kWarps][kRows][kCols];
  const size_t e = blockIdx.z;
  x += e * sx;
  w += e * sw;
  rho += e * ss;
  out += e * so;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRows;
  const int orow = row0 + warp;
  const bool colok = col < n;
  const int rows = min(kRows, m - row0);
  const int ng = k / G;
  float acc = 0.f;
  for (int g = 0; g < ng; ++g) {
    double part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.0;
    const int kbeg = g * G;
    if (kVec4) {
#pragma unroll 4
      for (int c = warp; c < G / 4; c += kWarps) {
        const int kk = kbeg + 4 * c;
        double w0 = 0.0, w1 = 0.0, w2 = 0.0, w3 = 0.0;
        if (colok) {
          const int8_t* wp = w + (size_t)kk * n + col;
          w0 = (double)wp[0];
          w1 = (double)wp[(size_t)n];
          w2 = (double)wp[2 * (size_t)n];
          w3 = (double)wp[3 * (size_t)n];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const XT* xp = x + (size_t)(row0 + r) * k + kk;
            double p = part[r];
            p = fma((double)load_x(xp), w0, p);
            p = fma((double)load_x(xp + 1), w1, p);
            p = fma((double)load_x(xp + 2), w2, p);
            p = fma((double)load_x(xp + 3), w3, p);
            part[r] = p;
          }
        }
      }
    } else {
      for (int kk = kbeg + warp; kk < kbeg + G; kk += kWarps) {
        const double wv = colok ? (double)w[(size_t)kk * n + col] : 0.0;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows) part[r] = fma((double)load_x(x + (size_t)(row0 + r) * k + kk), wv, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[warp][r][lane] = part[r];
    __syncthreads();
    if (orow < m && colok) {
      double s = 0.0;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) s += red[ww][warp][lane];
      acc = __fadd_rn(acc, __fmul_rn(__double2float_rn(s), rho[(size_t)g * n + col]));
    }
    __syncthreads();
  }
  if (orow < m && colok) epilogue(acc, orow, col, n, nullptr, kNoScale, bias, act, out);
}

inline dim3 grid_for(int m, int n, int stack = 1) {
  return dim3((n + kCols - 1) / kCols, (m + kRows - 1) / kRows, stack);
}

// Launch kernel v2's direct body over `stack` matrices of (m, k) x (k, n),
// packed one after another; x and out are f32 (x_bf16 = 0) or bf16
// (x_bf16 = 1).
template <class Route>
int launch_f(const void* x, const int8_t* w, const float* rho, const float* bias, int act,
             void* out, int x_bf16, int stack, int m, int k, int n, int G, cudaStream_t s) {
  if (m <= 0 || n <= 0 || stack <= 0) return 0;
  if (G <= 0 || k % G) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(m, n, stack), block(kWarps * 32);
  const size_t sx = (size_t)m * k, sw = (size_t)k * n, ss = (size_t)(k / G) * n, so = (size_t)m * n;
  const bool vec4 = (G % 4) == 0;
  if (x_bf16) {
    auto* xp = static_cast<const __nv_bfloat16*>(x);
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (vec4) pvq_matmul_f_kernel<Route, true><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G, sx, sw, ss, so);
    else pvq_matmul_f_kernel<Route, false><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G, sx, sw, ss, so);
  } else {
    auto* xp = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    if (vec4) pvq_matmul_f_kernel<Route, true><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G, sx, sw, ss, so);
    else pvq_matmul_f_kernel<Route, false><<<grid, block, 0, s>>>(xp, w, rho, bias, act, o, m, k, n, G, sx, sw, ss, so);
  }
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ v3 (int8 x)
//
// Kernel v3's direct body, for one matrix (gridDim.z = 1) or a stack of
// expert matrices (blockIdx.z is the matrix; its base pointers come from
// the strides).  A CTA owns 32 columns (one per lane) and 8 rows; its 8
// warps split each group's k range in 4-row __dp4a chunks, each lane
// reading its column's pulse bytes straight from global memory (32-byte
// coalesced rows), and their int32 partials are summed exactly in shared
// memory before the group's one __fmul_rn by rho; every float step is a
// separately rounded __fmul_rn / __fadd_rn in the plain version's order, so
// the result is bit-identical to the plain version.  A group not divisible
// by 4 contracts one k row at a time.  The wrapper
// (kernels/pvq_matmul.py:_v3_body) takes it for the ragged shapes the
// splitk body (m <= 8, pvq_matmul_splitk.cuh) and the tensor-core body
// (m > 8, pvq_matmul_mma.cuh) do not take.  The Route tag only names the
// instance (see pvq_matmul_splitk.cuh).

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// w[r] holds k row r of 4 adjacent columns (byte j = column j); o[j] gets
// column j of the 4 rows (byte r = k row r): a 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// 5 CTAs an SM (<= 51 registers): left free it took 64 and ran 17% slower
// (PERF.md).
template <class Route, bool kDp4a, typename OutT>
__global__ void __launch_bounds__(kWarps * 32, 5)
pvq_matmul_q_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ rho, const float* __restrict__ a,
                    int a_mode, const float* __restrict__ bias, int act,
                    OutT* __restrict__ out, int m, int k, int n, int G) {
  __shared__ int red[kWarps][kRows][kCols];
  const int ng = k / G;
  const size_t e = blockIdx.z;
  x += e * m * k;
  w += e * k * n;
  rho += e * ng * n;
  a += a_mode == kPerTile ? e * m * ng : a_mode == kPerRow ? e * m : 0;
  out += e * m * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRows;
  const int orow = row0 + warp;
  const bool colok = col < n;
  const int rows = min(kRows, m - row0);

  float acc = 0.f;
  for (int g = 0; g < ng; ++g) {
    int part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0;
    const int kbeg = g * G;
    if (kDp4a) {
#pragma unroll 4
      for (int c = warp; c < G / 4; c += kWarps) {
        const int wv = colok ? pack_w4(w + (size_t)(kbeg + 4 * c) * n + col, (size_t)n) : 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const int xv = *reinterpret_cast<const int*>(x + (size_t)(row0 + r) * k + kbeg + 4 * c);
            part[r] = __dp4a(xv, wv, part[r]);
          }
        }
      }
    } else {
      for (int kk = warp; kk < G; kk += kWarps) {
        const int wv = colok ? (int)w[(size_t)(kbeg + kk) * n + col] : 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows) part[r] += (int)x[(size_t)(row0 + r) * k + kbeg + kk] * wv;
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

template <class Route, typename OutT>
int launch_q_direct(const int8_t* x, const int8_t* w, const float* rho, const float* a,
                    int a_mode, const float* bias, int act, OutT* out, int e, int m, int k,
                    int n, int G, cudaStream_t s) {
  const dim3 grid = grid_for(m, n, e), block(kWarps * 32);
  if (G % 4 == 0)
    pvq_matmul_q_kernel<Route, true><<<grid, block, 0, s>>>(x, w, rho, a, a_mode, bias, act, out,
                                                            m, k, n, G);
  else
    pvq_matmul_q_kernel<Route, false><<<grid, block, 0, s>>>(x, w, rho, a, a_mode, bias, act, out,
                                                             m, k, n, G);
  return (int)cudaGetLastError();
}

}  // namespace pvq
