// Kernel v3's tensor-core body for m > 8 (prefill), shared by the 2-D route
// (pvq_matmul.cu, gridDim.z = 1) and the expert-batched route
// (pvq_matmul_batched.cu, blockIdx.z is the expert), and the launcher that
// picks among v3's three bodies.
//
// Replaces src/repro/kernels/pvq_matmul.py:_contract_int8_q as pvq_matmul_q
// (:596) and pvq_matmul_q_batched (:619) reach it: each group of G k rows is
// one int8 x int8 contraction into int32 on the matrix unit, multiplied by
// rho once.  Here that contraction is mma.sync m16n8k32 s8.s8.s32 on the
// tensor cores, accumulated in int32 over the G / 32 k steps of a group.
//
// What bounds it: at the main path's prefill shapes the bytes.  A 2-D call
// at m 512, k 1024, n 2560 moves 8.4 MB (mostly its f32 output) in 2.5 us
// and needs 1.4 us of int8 tensor-core operations; the expert banks at
// m 60 read 184-201 MB of pulses against 15-16 us of operations.  The
// dp4a body ("direct") ran 100-250x above those bounds: CUDA-core
// multiply-adds, a 4-byte gather of one column from 4 rows n bytes apart
// for every __dp4a, and 8-row CTAs, so each pulse byte was read from
// device memory by every 8-row block.
//
// Design: a CTA owns 64 rows x 128 columns (at m 60 one row block holds an
// expert's every dispatch row, so each pulse byte leaves device memory
// once); 8 warps of 32 x 32 outputs each (2 m16 x 4 n8 tiles).  x and the
// pulse tile stream through a 4-stage cp.async.cg ring, kBK k rows a stage
// (64 when G % 64 == 0, else 32, so a stage never straddles a group); rows
// past m and columns past n are zero-filled (src-size 0) and never stored.
//
// The pulses stay k-major, exactly as packed, but the mma wants B with k
// contiguous per column, and ldmatrix.trans moves only 16-bit elements.  So
// the kernel uses its freedom over which column an mma output slot stands
// for: lane (gid = lane >> 2, tig = lane & 3) reads four 32-bit words, k
// rows 4 tig .. 4 tig + 3 at byte column 4 gid of its warp's 32 columns
// (and again 16 rows on), and eight __byte_perm transpose that 4 x 4 byte
// block into the B registers of four n8 tiles: in n tile j, slot gid is
// column 4 gid + j.  The C fragment's slot 2 tig (+1) of tile j is then
// column 8 tig + j (+4), so each thread ends with 8 adjacent columns.  The
// staged pulse rows are 128 bytes with the 16-byte chunk c of row r stored
// at c ^ (((r >> 2) & 3) << 1): the four k-row quads a load touches fall
// in four distinct bank groups, and each chunk keeps cp.async's alignment.
// x rows are staged kBK + 16 bytes apart for conflict-free ldmatrix.
//
// Identity with the plain version: the int32 group sum is exact in any k
// order, so it equals __dp4a's and the plain int_dot's; at each group's
// end pf = __fmul_rn((float)s, rho[g, col]), with per-tile scales
// pf = __fmul_rn(pf, a[row, g]), acc = __fadd_rn(acc, pf), in the plain
// version's order; after the last group the shared epilogue() applies.

#pragma once

#include "pvq_matmul_splitk.cuh"

namespace pvq {

constexpr int kMmaBM = 64;      // output rows per CTA
constexpr int kMmaBN = 128;     // output columns per CTA (staged pulse row, bytes)
constexpr int kMmaWarps = 8;    // 2 (rows) x 4 (columns), 32 x 32 outputs each
constexpr int kMmaStages = 4;   // cp.async ring depth
constexpr int kMmaXPad = 16;    // bytes after each staged x row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate (exact)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte chunk slot of chunk c in staged pulse row r
__device__ __forceinline__ int pulse_chunk(int r, int c) { return c ^ (((r >> 2) & 3) << 1); }

template <class Route, int kBK, typename OutT>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
pvq_matmul_q_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ rho, const float* __restrict__ a,
                        int a_mode, const float* __restrict__ bias, int act,
                        OutT* __restrict__ out, int m, int k, int n, int G) {
  constexpr int kXS = kBK + kMmaXPad;          // staged x row, bytes
  constexpr int kXTile = kMmaBM * kXS;
  constexpr int kStage = kXTile + kBK * kMmaBN;
  constexpr int kThreads = kMmaWarps * 32;
  static_assert(kBK * kMmaBN / 16 % kThreads == 0, "whole pulse-tile chunks per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ng = k / G;
  const size_t e = blockIdx.z;
  x += e * m * k;
  w += e * k * n;
  rho += e * ng * n;
  a += a_mode == kPerTile ? e * m * ng : a_mode == kPerRow ? e * m : 0;
  out += e * m * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kMmaBM, col0 = blockIdx.x * kMmaBN;
  const int nk = k / kBK;

  // stage kt (x rows [row0, row0+64), pulse columns [col0, col0+128), k rows
  // [kt kBK, (kt+1) kBK)) into its ring slot, as one cp.async group
  auto stage = [&](int kt) {
    unsigned char* xs = smem + (kt % kMmaStages) * kStage;
    unsigned char* ws = xs + kXTile;
    const int kb = kt * kBK;
    constexpr int kXChunks = kMmaBM * kBK / 16, kWChunks = kBK * kMmaBN / 16;
#pragma unroll
    for (int it = 0; it < (kXChunks + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      if (kXChunks % kThreads == 0 || i < kXChunks) {
        const int r = i / (kBK / 16), c = i % (kBK / 16);
        const bool live = row0 + r < m;
        cp_async16(xs + r * kXS + 16 * c, live ? x + (size_t)(row0 + r) * k + kb + 16 * c : x,
                   live ? 16 : 0);
      }
    }
#pragma unroll
    for (int it = 0; it < kWChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i >> 3, c = i & 7;
      const bool live = col0 + 16 * c < n;
      cp_async16(ws + r * kMmaBN + 16 * pulse_chunk(r, c),
                 live ? w + (size_t)(kb + r) * n + col0 + 16 * c : w, live ? 16 : 0);
    }
  };

  int acc[2][4][4];
  float facc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0;
        facc[i][j][q] = 0.f;
      }
  // this thread's 8 adjacent output columns (all in or all out: n % 16 == 0)
  const int cb = col0 + wn * 32 + 8 * tig;
  const bool colok = cb < n;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kMmaStages - 2>();  // stage kt landed
    __syncthreads();                   // ... for every thread; slot kt - 1 is free
    if (kt + kMmaStages - 1 < nk) stage(kt + kMmaStages - 1);
    cp_async_commit();
    const unsigned char* xs = smem + (kt % kMmaStages) * kStage;
    const unsigned char* ws = xs + kXTile;
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + 16 * i + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[i], xs + r * kXS + 32 * s + (lane >> 4) * 16);
      }
      uint32_t bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t rw[4], o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 32 * s + 16 * h + 4 * tig + q;
          rw[q] = *reinterpret_cast<const uint32_t*>(
              ws + r * kMmaBN + 16 * pulse_chunk(r, 2 * wn + (gid >> 2)) + 4 * (gid & 3));
        }
        transpose4x4(rw, o);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j][h] = o[j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }

    if (((kt + 1) * kBK) % G == 0) {  // group g ends: one rho multiply of its int32 sum
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
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + wm * 32 + 16 * i + gid + 8 * hh;
          const float at = a_mode == kPerTile && row < m ? a[(size_t)row * ng + g] : 1.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const int q = 2 * hh + p;
              float pf = __fmul_rn((float)acc[i][j][q], rv[4 * p + j]);
              if (a_mode == kPerTile) pf = __fmul_rn(pf, at);
              facc[i][j][q] = __fadd_rn(facc[i][j][q], pf);
              acc[i][j][q] = 0;
            }
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
          epilogue(facc[i][j][2 * hh + p], row, cb + 4 * p + j, n, a, a_mode, bias, act, out);
    }
}

template <class Route, int kBK, typename OutT>
int launch_q_mma(const int8_t* x, const int8_t* w, const float* rho, const float* a, int a_mode,
                 const float* bias, int act, OutT* out, int e, int m, int k, int n, int G,
                 cudaStream_t s) {
  constexpr size_t smem = (size_t)kMmaStages * (kMmaBM * (kBK + kMmaXPad) + kBK * kMmaBN);
  auto* fn = pvq_matmul_q_mma_kernel<Route, kBK, OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kMmaBN - 1) / kMmaBN, (m + kMmaBM - 1) / kMmaBM, e);
  fn<<<grid, kMmaWarps * 32, smem, s>>>(x, w, rho, a, a_mode, bias, act, out, m, k, n, G);
  return (int)cudaGetLastError();
}

// Kernel v3's bodies; the caller picks one (kernels/pvq_matmul.py:_v3_body).
enum Body { kBodySplitK = 0, kBodyDirect = 1, kBodyMma = 2 };

// Launch kernel v3 over `stack` matrices of (m, k) x (k, n), packed one
// after another, with the given body: a is per row (a_mode 0, m values per
// matrix), per tile (a_mode 2, m * k/G per matrix) or one scalar shared by
// all (a_mode 1); bias (n) is shared; out is f32 (out_bf16 = 0) or bf16
// (out_bf16 = 1).  The mma body needs G % 32 == 0, n % 16 == 0 and 16-byte
// aligned x, w and rho; the splitk body takes the plan (cols, chunk,
// splits), its int32 scratch and counters (launch_q_splitk says what it
// needs); the launch fails otherwise.  Route names the instances.
template <class Route>
int launch_q_stack(const int8_t* x, const int8_t* w, const float* rho, const float* a,
                   int a_mode, const float* bias, int act, void* out, int out_bf16, int stack,
                   int m, int k, int n, int G, int body, int cols, int chunk, int splits,
                   int* part, unsigned* counters, cudaStream_t s) {
  if (stack <= 0 || m <= 0 || n <= 0) return 0;
  if (G <= 0 || k % G || (a_mode != kPerRow && a_mode != kScalar && a_mode != kPerTile))
    return (int)cudaErrorInvalidValue;
  if (body == kBodyMma) {
    if (G % 32 || n % 16 || (((uintptr_t)x | (uintptr_t)w | (uintptr_t)rho) & 15))
      return (int)cudaErrorInvalidValue;
#define PVQ_LAUNCH_MMA(OutT)                                                                \
  return G % 64 == 0                                                                       \
             ? launch_q_mma<Route, 64>(x, w, rho, a, a_mode, bias, act,                    \
                                       static_cast<OutT*>(out), stack, m, k, n, G, s)      \
             : launch_q_mma<Route, 32>(x, w, rho, a, a_mode, bias, act,                    \
                                       static_cast<OutT*>(out), stack, m, k, n, G, s)
    if (out_bf16) PVQ_LAUNCH_MMA(__nv_bfloat16);
    PVQ_LAUNCH_MMA(float);
#undef PVQ_LAUNCH_MMA
  }
  if (body == kBodySplitK) {
    if (out_bf16)
      return launch_q_splitk<Route>(x, w, rho, a, a_mode, bias, act,
                                    static_cast<__nv_bfloat16*>(out), stack, m, k, n, G, cols,
                                    chunk, splits, part, counters, s);
    return launch_q_splitk<Route>(x, w, rho, a, a_mode, bias, act, static_cast<float*>(out),
                                  stack, m, k, n, G, cols, chunk, splits, part, counters, s);
  }
  if (body != kBodyDirect) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_q_direct<Route>(x, w, rho, a, a_mode, bias, act,
                                  static_cast<__nv_bfloat16*>(out), stack, m, k, n, G, s);
  return launch_q_direct<Route>(x, w, rho, a, a_mode, bias, act, static_cast<float*>(out), stack,
                                m, k, n, G, s);
}

}  // namespace pvq
