// Kernel v2's f64 tensor-core body for m > 8 (the f32 leg's prefill), shared
// by the 2-D route (pvq_matmul.cu, gridDim.z = 1) and the expert-batched
// route (pvq_matmul_batched.cu, blockIdx.z is the expert); the launcher that
// picks between v2's three bodies is in pvq_matmul_f_splitk.cuh.
//
// Replaces src/repro/kernels/pvq_matmul.py:_accumulate_int8 as pvq_matmul
// (:229) and pvq_matmul_batched (:250) reach it: each group of G k rows of
// float x against int8 pulses, multiplied by rho once.  Here each group is
// contracted with mma.sync m16n8k4 .f64 on the tensor cores, accumulated in
// f64 over the group's k steps, and rounded to f32 once at its end:
// acc = __fadd_rn(acc, __fmul_rn(__double2float_rn(s), rho[g, col])), then
// bias and activation through the shared epilogue(), in the plain version's
// order.  Every product of an f32 or bf16 x and an int8 pulse is exact in
// f64 and the f64 sum rounds far below f32's precision, so the group's one
// rounding gives the plain version's f32 value whatever order the tensor
// core sums in (the argument of pvq_matmul_common.cuh's CUDA-core body).
//
// What bounds it: the operations.  At m 512, k 1024, n 2560 the call does
// 2.7 GFLOP, 40 us at the f64 tensor cores' 67 TFLOP/s, against 3.7 us of
// bytes; one MoE layer's banks at m 60 do 68.5 GFLOP (1.02 ms) against
// 570 MB of pulses (0.17 ms).  The CUDA-core body ran 9-11x slower than a
// torch.matmul of the dequantized weights: f64 FMAs on the CUDA cores (half
// the tensor cores' f64 rate), one f32/bf16 -> f64 conversion per FMA (the
// conversion unit runs 16 a clock per SM against 64 f64 FMAs), each pulse
// byte read from device memory by every 8-row block, and an f64
// shared-memory reduction with two barriers per group.
//
// Design: a CTA owns 64 rows x 64 columns (at m 60 one row block holds an
// expert's every dispatch row, so each pulse byte leaves device memory
// once); 4 warps of 32 x 32 outputs each (2 m16 x 4 n8 tiles, 32 f64 group
// sums and 32 f32 running sums a thread).  x (f32 or bf16, as given) and
// the int8 pulse tile stream through a 4-stage cp.async.cg ring, kBK k rows
// a stage (32 when G % 32 == 0, else 16, so a stage never straddles a
// group); rows past m and columns past n are zero-filled (src-size 0) and
// never stored.
//
// Conversions: each staged element is converted to f64 in registers by
// each warp that uses it, once per use, never once per mma: a k step's
// 4-element A column (2 m16 tiles x 2 rows) and one 32-bit pulse word (4
// n8 tiles) feed 8 mma, so a warp converts 1 element per 16 FMAs, and the
// conversion unit works at most half the time the tensor cores do.
// Staging f64 tiles in shared memory would cut that to 1 in 32 but add a
// conversion pass and barrier per stage and ~3x the shared memory per
// stage; building the f64 from bits would trade one conversion for 3-5
// integer and f64 ops.  Neither is needed while the tensor cores set the
// pace.
//
// Layout: the pulses stay k-major as packed.  In n8 tile j, B slot gid
// stands for column 4 gid + j of the warp's 32 (the column freedom of
// pvq_matmul_mma.cuh), so one 32-bit load of k row r at byte column 4 gid
// feeds all four n tiles; C slot 2 tig (+1) of tile j is then column
// 8 tig + j (+4), 8 adjacent columns per thread.  The staged pulse rows are
// 64 bytes with the 16-byte chunk c of row r stored at c ^ (((r >> 1) & 1)
// << 1): a k step's four rows (tig) fall in four distinct bank groups.  x
// rows are staged kBK elements + 16 bytes apart, so a k step's 8 rows (gid)
// x 4 k columns (tig) hit distinct banks.

#pragma once

#include "pvq_matmul_common.cuh"

namespace pvq {

constexpr int kFBM = 64;      // output rows per CTA
constexpr int kFBN = 64;      // output columns per CTA (staged pulse row, bytes)
constexpr int kFWarps = 4;    // 2 (rows) x 2 (columns), 32 x 32 outputs each
constexpr int kFStages = 4;   // cp.async ring depth
constexpr int kFXPad = 16;    // bytes after each staged x row

// c (16 x 8) += a (16 x 4, row) * b (4 x 8, col) in f64: a0 is row gid and
// a1 row gid + 8 of k column tig, b0 k row tig of column gid; c0, c1 are
// row gid, columns 2 tig, 2 tig + 1, and c2, c3 the same of row gid + 8.
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1, double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

__device__ __forceinline__ double to_f64(float v) { return (double)v; }
__device__ __forceinline__ double to_f64(__nv_bfloat16 v) { return (double)__bfloat162float(v); }

// 16-byte chunk slot of chunk c in staged pulse row r (64-byte rows)
__device__ __forceinline__ int f_pulse_chunk(int r, int c) { return c ^ (((r >> 1) & 1) << 1); }

// The Route tag only names the instance (see pvq_matmul_splitk.cuh).
template <class Route, int kBK, typename XT>
__global__ void __launch_bounds__(kFWarps * 32, 3)
pvq_matmul_f_mma_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ rho, const float* __restrict__ bias,
                        int act, XT* __restrict__ out, int m, int k, int n, int G) {
  constexpr int kES = (int)sizeof(XT);
  constexpr int kXS = kBK * kES + kFXPad;  // staged x row, bytes
  constexpr int kXTile = kFBM * kXS;
  constexpr int kStage = kXTile + kBK * kFBN;
  constexpr int kThreads = kFWarps * 32;
  constexpr int kXRowChunks = kBK * kES / 16;
  constexpr int kXChunks = kFBM * kXRowChunks, kWChunks = kBK * kFBN / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ng = k / G;
  const size_t e = blockIdx.z;
  x += e * m * k;
  w += e * k * n;
  rho += e * ng * n;
  out += e * m * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kFBM, col0 = blockIdx.x * kFBN;
  const int nk = k / kBK;

  // stage kt (x rows [row0, row0+64), pulse columns [col0, col0+64), k rows
  // [kt kBK, (kt+1) kBK)) into its ring slot, as one cp.async group
  auto stage = [&](int kt) {
    unsigned char* xs = smem + (kt % kFStages) * kStage;
    unsigned char* ws = xs + kXTile;
    const int kb = kt * kBK;
#pragma unroll
    for (int it = 0; it < (kXChunks + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      if (kXChunks % kThreads == 0 || i < kXChunks) {
        const int r = i / kXRowChunks, c = i % kXRowChunks;
        const bool live = row0 + r < m;
        const XT* src = live ? x + (size_t)(row0 + r) * k + kb + c * (16 / kES) : x;
        cp_async16(xs + r * kXS + 16 * c, src, live ? 16 : 0);
      }
    }
#pragma unroll
    for (int it = 0; it < (kWChunks + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      if (kWChunks % kThreads == 0 || i < kWChunks) {
        const int r = i >> 2, c = i & 3;
        const bool live = col0 + 16 * c < n;
        cp_async16(ws + r * kFBN + 16 * f_pulse_chunk(r, c),
                   live ? w + (size_t)(kb + r) * n + col0 + 16 * c : w, live ? 16 : 0);
      }
    }
  };

  double acc[2][4][4];
  float facc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0.0;
        facc[i][j][q] = 0.f;
      }
  // this thread's 8 adjacent output columns (all in or all out: n % 16 == 0)
  const int cb = col0 + wn * 32 + 8 * tig;
  const bool colok = cb < n;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kFStages - 2>();  // stage kt landed
    __syncthreads();                 // ... for every thread; slot kt - 1 is free
    if (kt + kFStages - 1 < nk) stage(kt + kFStages - 1);
    cp_async_commit();
    const unsigned char* xs = smem + (kt % kFStages) * kStage;
    const unsigned char* ws = xs + kXTile;
#pragma unroll
    for (int q = 0; q < kBK / 4; ++q) {
      const int r = 4 * q + tig;  // this lane's k row of the step
      const uint32_t wv = *reinterpret_cast<const uint32_t*>(
          ws + r * kFBN + 16 * f_pulse_chunk(r, 2 * wn + (gid >> 2)) + 4 * (gid & 3));
      double b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = (double)(int)(int8_t)(wv >> (8 * j));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* xr = xs + (wm * 32 + 16 * i + gid) * kXS + r * kES;
        const double a0 = to_f64(*reinterpret_cast<const XT*>(xr));
        const double a1 = to_f64(*reinterpret_cast<const XT*>(xr + 8 * kXS));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], a0, a1, b[j]);
      }
    }

    if (((kt + 1) * kBK) % G == 0) {  // group g ends: its f64 sum rounded once, times rho
      const int g = (kt + 1) * kBK / G - 1;
      float rv[8];
      if (colok) {
        const float4* rp = reinterpret_cast<const float4*>(rho + (size_t)g * n + cb);
        const float4 r0 = __ldg(rp), r1 = __ldg(rp + 1);
        rv[0] = r0.x; rv[1] = r0.y; rv[2] = r0.z; rv[3] = r0.w;
        rv[4] = r1.x; rv[5] = r1.y; rv[6] = r1.z; rv[7] = r1.w;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) rv[c] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            facc[i][j][q] = __fadd_rn(facc[i][j][q],
                                      __fmul_rn(__double2float_rn(acc[i][j][q]), rv[4 * (q & 1) + j]));
            acc[i][j][q] = 0.0;
          }
    }
  }
  cp_async_wait<0>();

  if (!colok) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + wm * 32 + 16 * i + gid + 8 * hh;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          epilogue(facc[i][j][2 * hh + p], row, cb + 4 * p + j, n, nullptr, kNoScale, bias, act,
                   out);
    }
}

template <class Route, int kBK, typename XT>
int launch_f_mma(const XT* x, const int8_t* w, const float* rho, const float* bias, int act,
                 XT* out, int e, int m, int k, int n, int G, cudaStream_t s) {
  constexpr size_t smem =
      (size_t)kFStages * (kFBM * (kBK * sizeof(XT) + kFXPad) + kBK * kFBN);
  auto* fn = pvq_matmul_f_mma_kernel<Route, kBK, XT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kFBN - 1) / kFBN, (m + kFBM - 1) / kFBM, e);
  fn<<<grid, kFWarps * 32, smem, s>>>(x, w, rho, bias, act, out, m, k, n, G);
  return (int)cudaGetLastError();
}

}  // namespace pvq
