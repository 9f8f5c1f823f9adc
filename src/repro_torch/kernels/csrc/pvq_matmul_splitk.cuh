// Kernel v3's body for m <= 8 rows (decode), shared by the 2-D route
// (pvq_matmul.cu, one matrix) and the expert-batched route
// (pvq_matmul_batched.cu, blockIdx.z is the expert): "splitk".
//
// Replaces src/repro/kernels/pvq_matmul.py:_contract_int8_q as pvq_matmul_q
// (:596) and pvq_matmul_q_batched (:619) reach it at decode, and the pulse
// streaming of its DMA body _kernel_q_dma (:555): there the pulse operand
// stays in HBM and moves through a 2-slot VMEM ring; here every 16-byte
// piece of a CTA's pulse tile is requested up front with cp.async.cg (a
// 3-slot ring only when a CTA walks more than 3 stages).
//
// What bounds it: the bytes of the pulse plane.  At decode each pulse byte
// feeds m <= 8 multiply-adds: one smollm layer's 7 matmuls read 9.98 MB
// (3.0 us at 3.35 TB/s), a MoE layer's banks 580 MB (0.17 ms).  A decode
// matmul is also too small to fill 132 SMs with whole columns: n / 64
// column blocks are 5-40 CTAs on smollm.
//
// Design:
//   * The contraction is split over CTAs.  The grid is (column block of 64,
//     k chunk, expert); pvq_matmul._v3_decode_plan picks the chunk (a
//     divisor of the group, a multiple of 4) so that a call launches about
//     two CTAs an SM, or no split where the column blocks already do.  A
//     group's int32 sum is exact in any order and any cut along k, so each
//     CTA writes the int32 partial of its (chunk, rows, columns) to scratch,
//     and the last CTA of a column block to arrive (one arrival counter per
//     column block and expert, reset to 0 by that CTA, so the buffer is zero
//     between calls) sums the partials of each group, multiplies by rho
//     (and the per-tile scale) and adds over g = 0..ng-1, the plain
//     version's float order, then runs the shared epilogue().  Unsplit, a
//     CTA does the same fold itself at each group's end.  One launch a call.
//   * A stage is srows k rows (<= 256, inside one group) of 64 pulse bytes
//     a row (4 cp.async.cg of 16 bytes, rows padded to 80 bytes) and the m x
//     srows slice of x (cp.async.ca of 4 bytes).  A thread owns a column
//     quad and a k slice: four 32-bit words (k rows 4q..4q+3 x 4 columns)
//     become the four columns' __dp4a operands by a 4 x 4 byte transpose
//     (__byte_perm, as pvq_matmul_mma.cuh builds its B fragments), each
//     multiplied by the m live rows of x (kM is a template parameter).  The
//     two k slices of a warp sit 320 bytes apart, so its 32 loads hit 32
//     banks.
//   * At a group's (or the chunk's) end the 16 k slices' int32 sums meet
//     through one shuffle and an 8-way sum in shared memory.
//
// The Route tag (OneMatrix / ExpertStack) changes nothing but the kernel's
// name, so a profile can tell the 2-D route from the batched one.

#pragma once

#include "pvq_matmul_common.cuh"

namespace pvq {

struct OneMatrix {};    // the 2-D route: one matrix, gridDim.z = 1
struct ExpertStack {};  // the batched route: blockIdx.z is the expert

constexpr int kSplitCols = 64;                             // output columns per CTA
constexpr int kSplitThreads = 256;
constexpr int kSplitQuads = kSplitCols / 4;                // column quads: 16
constexpr int kSplitSlices = kSplitThreads / kSplitQuads;  // k slices: 16
constexpr int kSplitRow = kSplitCols + 16;                 // staged pulse row, bytes
constexpr int kSplitSlots = 3;                             // stage slots in shared memory
constexpr int kSplitMaxStage = 256;                        // k rows a stage at most

// kBytes (4, 8 or 16) from global to shared memory, through L1
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(gmem), "n"(kBytes) : "memory");
}

// One stage slot: srows pulse rows of kSplitRow bytes, then x's kM x srows slice.
__host__ __device__ inline int splitk_slot_bytes(int m, int srows) {
  return (srows * kSplitRow + m * srows + 15) & ~15;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

__device__ __forceinline__ float fold_group(float acc, int s, float rv, float av, int a_mode) {
  float pf = __fmul_rn((float)s, rv);
  if (a_mode == kPerTile) pf = __fmul_rn(pf, av);
  return __fadd_rn(acc, pf);
}

// x (E, kM, k) int8, w (E, k, n) int8 (16-byte aligned, n % 16 == 0), rho
// (E, k/G, n); grid (ceil(n/64), splits, E).  A CTA contracts k rows
// [split * chunk, (split + 1) * chunk) in stages of srows; with splits > 1
// the chunk lies inside one group and part holds (E, splits, kM, n) int32
// partials, counters one zeroed counter per (expert, column block).
template <class Route, int kM, typename OutT>
__global__ void __launch_bounds__(kSplitThreads, kM > 4 ? 2 : 3)
pvq_matmul_q_splitk_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ rho, const float* __restrict__ a,
                           int a_mode, const float* __restrict__ bias, int act,
                           OutT* __restrict__ out, int k, int n, int G, int chunk, int srows,
                           int* __restrict__ part, unsigned* __restrict__ counters) {
  constexpr int kOwn = (kM * kSplitCols + kSplitThreads - 1) / kSplitThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kSplitThreads / 32][kM][4][kSplitQuads];
  __shared__ bool last;
  const int ng = k / G, splits = gridDim.y;
  const int e = blockIdx.z, split = blockIdx.y;
  const int col0 = blockIdx.x * kSplitCols;
  x += (size_t)e * kM * k;
  w += (size_t)e * k * n;
  rho += (size_t)e * ng * n;
  a += a_mode == kPerTile ? (size_t)e * kM * ng : a_mode == kPerRow ? (size_t)e * kM : 0;
  out += (size_t)e * kM * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = tid % kSplitQuads, slice = tid / kSplitQuads;
  const int k0 = split * chunk, nst = chunk / srows;
  const int slot = splitk_slot_bytes(kM, srows);

  // stage st: pulse rows [k0 + st srows, +srows) x columns [col0, col0 + 64)
  // (a 16-byte piece past n is zero-filled: src-size 0) and x's slice of
  // the same k rows, as one cp.async group
  auto stage = [&](int st) {
    unsigned char* ws = smem + (st % kSplitSlots) * slot;
    unsigned char* xs = ws + srows * kSplitRow;
    const int kb = k0 + st * srows;
    for (int i = tid; i < srows * (kSplitCols / 16); i += kSplitThreads) {
      const int r = i / (kSplitCols / 16), h = i % (kSplitCols / 16);
      const bool live = col0 + 16 * h < n;
      cp_async16(ws + r * kSplitRow + 16 * h,
                 live ? w + (size_t)(kb + r) * n + col0 + 16 * h : w, live ? 16 : 0);
    }
    for (int i = tid; i < kM * srows / 4; i += kSplitThreads) {
      const int r = i / (srows / 4), c = i % (srows / 4);
      cp_async_ca<4>(xs + 4 * i, x + (size_t)r * k + kb + 4 * c);
    }
  };

#pragma unroll
  for (int s = 0; s < kSplitSlots; ++s) {
    if (s < nst) stage(s);
    cp_async_commit();
  }

  int acc[kM][4];
#pragma unroll
  for (int r = 0; r < kM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0;
  // this thread's outputs (row r = o / 64, column col0 + o % 64), o = tid +
  // i * 256; their epilogue scale and bias are read now, off the tail
  float facc[kOwn], rv[kOwn], av[kOwn], ea[kOwn], eb[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    facc[i] = rv[i] = av[i] = ea[i] = eb[i] = 0.f;
    const int o = tid + i * kSplitThreads, r = o / kSplitCols, col = col0 + o % kSplitCols;
    if (o < kM * kSplitCols && col < n) {
      if (a_mode == kPerRow) ea[i] = __ldg(a + r);
      else if (a_mode == kScalar) ea[i] = __ldg(a);
      if (bias) eb[i] = __ldg(bias + col);
    }
  }
  // split: the last CTA of the column block reads this group's rho (and
  // per-tile scales) after a dependent wait; bring them into L2 now
  if (splits > 1) {
    const int g = k0 / G;
    if (tid < kSplitCols / 32 && col0 + 32 * tid < n) prefetch_l2(rho + (size_t)g * n + col0 + 32 * tid);
    if (a_mode == kPerTile && tid >= 32 && tid < 32 + kM) prefetch_l2(a + (size_t)(tid - 32) * ng + g);
  }

  for (int st = 0; st < nst; ++st) {
    const int kb = k0 + st * srows;
    if (splits == 1 && kb % G == 0) {  // a group starts: fetch its rho (used at its end)
      const int g = kb / G;
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        const int o = tid + i * kSplitThreads, r = o / kSplitCols, col = col0 + o % kSplitCols;
        if (o < kM * kSplitCols && col < n) {
          rv[i] = __ldg(rho + (size_t)g * n + col);
          if (a_mode == kPerTile) av[i] = __ldg(a + (size_t)r * ng + g);
        }
      }
    }
    cp_async_wait<kSplitSlots - 1>();  // stage st landed (one group is committed a stage)
    __syncthreads();                    // ... for every thread
    const unsigned char* ws = smem + (st % kSplitSlots) * slot;
    const unsigned char* xs = ws + srows * kSplitRow;
    for (int kq = slice; kq < srows / 4; kq += kSplitSlices) {
      uint32_t rw[4], tw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rw[q] = *reinterpret_cast<const uint32_t*>(ws + (4 * kq + q) * kSplitRow + 4 * quad);
      transpose4x4(rw, tw);  // tw[j]: column 4 quad + j, k rows 4 kq .. 4 kq + 3
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        const int xv = *reinterpret_cast<const int*>(xs + r * srows + 4 * kq);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(xv, (int)tw[j], acc[r][j]);
      }
    }
    __syncthreads();  // every thread is done with this slot
    if (st + kSplitSlots < nst) stage(st + kSplitSlots);
    cp_async_commit();

    const int kend = kb + srows;
    if (kend % G != 0 && st != nst - 1) continue;
    // a group (or this CTA's piece of one) ends: sum the 16 k slices exactly
#pragma unroll
    for (int r = 0; r < kM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = acc[r][j] + __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
        if (lane < 16) red[warp][r][j][quad] = v;
        acc[r][j] = 0;
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int o = tid + i * kSplitThreads, r = o / kSplitCols, c = o % kSplitCols;
      if (o >= kM * kSplitCols || col0 + c >= n) continue;
      int s = 0;
#pragma unroll
      for (int ww = 0; ww < kSplitThreads / 32; ++ww) s += red[ww][r][c & 3][c >> 2];
      if (splits == 1) facc[i] = fold_group(facc[i], s, rv[i], av[i], a_mode);
      else part[(((size_t)e * splits + split) * kM + r) * n + col0 + c] = s;
    }
    // red is written again only after the next stage's barrier
  }
  cp_async_wait<0>();

  if (splits > 1) {
    __threadfence();  // this CTA's partials are visible before its arrival counts
    __syncthreads();
    if (tid == 0) {
      const unsigned tile = (unsigned)e * gridDim.x + blockIdx.x;
      last = atomicAdd(counters + tile, 1u) == (unsigned)splits - 1;
      if (last) counters[tile] = 0;  // every CTA of the tile has arrived: zero for the next call
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the last CTA folds every group's partials in the plain version's
    // order; the loads of 8 splits at a time (partials, rho, scales) are
    // independent of the fold, so they are in flight together
    const int per_group = G / chunk;
    const size_t step = (size_t)kM * n;
#pragma unroll 1
    for (int i = 0; i < kOwn; ++i) {
      const int o = tid + i * kSplitThreads, r = o / kSplitCols, col = col0 + o % kSplitCols;
      if (o >= kM * kSplitCols || col >= n) continue;
      const int* pp = part + ((size_t)e * splits * kM + r) * n + col;
      float f = 0.f;
      int s = 0, g = 0, j = 0;
#pragma unroll 8
      for (int sp = 0; sp < splits; ++sp) {
        const float rg = __ldg(rho + (size_t)g * n + col);
        const float ag = a_mode == kPerTile ? __ldg(a + (size_t)r * ng + g) : 0.f;
        s += __ldcg(pp + (size_t)sp * step);
        if (++j == per_group) {
          f = fold_group(f, s, rg, ag, a_mode);
          s = j = 0;
          ++g;
        }
      }
      facc[i] = f;
    }
  }
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int o = tid + i * kSplitThreads, r = o / kSplitCols, col = col0 + o % kSplitCols;
    if (o < kM * kSplitCols && col < n)
      finish(facc[i], ea[i], a_mode, bias != nullptr, eb[i], act, out + (size_t)r * n + col);
  }
}

// k rows a stage: the largest multiple of 4 up to max_rows that divides
// the piece a CTA walks inside one group (the group unsplit, else the
// chunk).
inline int splitk_stage_rows(int G, int chunk, int splits, int max_rows = kSplitMaxStage) {
  const int piece = splits == 1 ? G : chunk;
  for (int d = max_rows; d > 4; d -= 4)
    if (piece % d == 0) return d;
  return 4;
}

template <class Route, int kM, typename OutT>
int launch_q_splitk_m(const int8_t* x, const int8_t* w, const float* rho, const float* a,
                      int a_mode, const float* bias, int act, OutT* out, int e, int k, int n,
                      int G, int chunk, int splits, int* part, unsigned* counters,
                      cudaStream_t s) {
  auto* fn = pvq_matmul_q_splitk_kernel<Route, kM, OutT>;
  // the most dynamic shared memory any call asks for, set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSplitSlots * splitk_slot_bytes(kM, kSplitMaxStage));
  if (attr != cudaSuccess) return (int)attr;
  const int srows = splitk_stage_rows(G, chunk, splits);
  const int nst = chunk / srows;
  const size_t smem = (size_t)(nst < kSplitSlots ? nst : kSplitSlots) * splitk_slot_bytes(kM, srows);
  const dim3 grid((n + kSplitCols - 1) / kSplitCols, splits, e);
  fn<<<grid, kSplitThreads, smem, s>>>(x, w, rho, a, a_mode, bias, act, out, k, n, G, chunk,
                                       srows, part, counters);
  return (int)cudaGetLastError();
}

// The splitk body over e matrices of (m, k) x (k, n) with the plan
// (cols, chunk, splits) of pvq_matmul._v3_decode_plan.  Needs m <= 8,
// cols == 64, G % 4 == 0, n % 16 == 0, a 16-byte aligned w and a 4-byte
// aligned x; chunk == k unsplit, else chunk * splits == k with chunk a
// multiple of 4 dividing G, and then part ((e, splits, m, n) int32) and
// counters (e * ceil(n / 64) zeros).  The launch fails otherwise.
template <class Route, typename OutT>
int launch_q_splitk(const int8_t* x, const int8_t* w, const float* rho, const float* a,
                    int a_mode, const float* bias, int act, OutT* out, int e, int m, int k,
                    int n, int G, int cols, int chunk, int splits, int* part,
                    unsigned* counters, cudaStream_t s) {
  const bool split_ok = splits == 1 ? chunk == k
                                    : splits > 1 && chunk > 0 && chunk % 4 == 0 &&
                                          G % chunk == 0 && (long long)chunk * splits == k &&
                                          part && counters;
  if (m > 8 || cols != kSplitCols || G % 4 || n % 16 || ((uintptr_t)w & 15) ||
      ((uintptr_t)x & 3) || !split_ok)
    return (int)cudaErrorInvalidValue;
  switch (m) {
#define PVQ_SPLITK_M(M) \
  case M: return launch_q_splitk_m<Route, M>(x, w, rho, a, a_mode, bias, act, out, e, k, n, G, chunk, splits, part, counters, s)
    PVQ_SPLITK_M(1); PVQ_SPLITK_M(2); PVQ_SPLITK_M(3); PVQ_SPLITK_M(4);
    PVQ_SPLITK_M(5); PVQ_SPLITK_M(6); PVQ_SPLITK_M(7); PVQ_SPLITK_M(8);
#undef PVQ_SPLITK_M
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pvq
