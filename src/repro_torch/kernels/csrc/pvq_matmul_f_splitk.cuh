// Kernel v2's body for m <= 8 rows (decode: the f32 leg of --agreement-min),
// shared by the 2-D route (pvq_matmul.cu, one matrix) and the expert-batched
// route (pvq_matmul_batched.cu, blockIdx.z is the expert): "splitk", and the
// launcher that picks between v2's three bodies.
//
// Replaces src/repro/kernels/pvq_matmul.py:_accumulate_int8 as pvq_matmul
// (:229) and pvq_matmul_batched (:250) reach it at decode: each group of G
// k rows of float x against int8 pulses, multiplied by rho once.
//
// What bounds it: the bytes of the pulse plane, with the f64 pipe close
// behind.  Each pulse byte feeds m <= 8 multiply-adds: one smollm layer's 7
// matmuls read 10.3 M pulses (3.1 us at 3.35 TB/s), a MoE layer's banks
// 580 MB (0.17 ms).  Every product of an f32 or bf16 x and an int8 pulse is
// exact in f64, and the group's sum is taken there (pvq_matmul_common.cuh
// says why), so a pulse costs m f64 FMAs plus its conversion: at m 4 five
// f64 operations, 3.1 us for the smollm layer on the 64-a-clock f64 pipe.
// The direct body (pvq_matmul_common.cuh) launched n / 32 CTAs that each
// walked all of k, read one byte per lane per k row, and converted every
// pulse byte to f64 on the 16-a-clock conversion unit.
//
// Design (the shape of v3's splitk body, pvq_matmul_splitk.cuh, whose plan,
// staging, counters and helpers it shares):
//   * The contraction is split over CTAs.  The grid is (column block of 64,
//     k chunk, expert) with pvq_matmul._v3_decode_plan's chunk.  A group's
//     f64 sum of exact products may be cut anywhere along k and added in
//     any order: that changes only the order of the f64 sum, which rounds
//     far below f32's precision.  Each CTA writes the f64 partial of its
//     (chunk, rows, columns) to scratch; the last CTA of a column block to
//     arrive (one arrival counter per column block and expert, reset to 0
//     by that CTA) sums each group's pieces in f64, rounds the sum once
//     (__double2float_rn), multiplies by rho (__fmul_rn) and adds over g =
//     0..ng-1 (__fadd_rn), the plain version's f32 order, then runs the
//     shared epilogue.  Unsplit, a CTA does the same fold itself at each
//     group's end.  One launch a call.
//   * A stage is srows k rows (inside one group; <= 256 at one row, else
//     <= 128, so three CTAs an SM fit the shared memory) of 64 pulse bytes a
//     row (4 cp.async.cg of 16 bytes, rows padded to 80 bytes) and the m x
//     srows slice of x in its own dtype (cp.async.ca of 4 elements), in a
//     ring of 3 slots, two stages in flight while one is contracted.  Once
//     a stage lands, x's slice is converted to f64 in one pass (each x
//     element feeds 64 columns, so it is converted once, not once per use).
//   * A thread owns a column quad and a k slice.  Each 32-bit pulse word (4
//     columns of one k row) is biased by 0x80808080 once; byte j becomes
//     the exact f64 pulse as (2^52 + w + 128) from its bits
//     (__byte_perm, __hiloint2double) less 2^52 + 128: one integer permute
//     and one f64 add, off the 16-a-clock conversion unit.  The f64 pulse
//     then feeds the m live rows (kM is a template parameter).  The two k
//     slices of a warp read pulse rows 320 bytes apart: 32 banks.
//   * At a group's (or the chunk's) end the 16 k slices' f64 sums meet
//     through one shuffle and an 8-way sum in shared memory, in a fixed
//     order, so a call (and a CUDA graph's replay) is deterministic.
//
// The Route tag (OneMatrix / ExpertStack) changes nothing but the kernel's
// name, so a profile can tell the 2-D route from the batched one.

#pragma once

#include "pvq_matmul_f_mma.cuh"
#include "pvq_matmul_splitk.cuh"

namespace pvq {

constexpr int kFSplitSlots = 3;  // stage slots in shared memory

// k rows a stage at most: at one row 256 (a slot of 21.5 KB), else 128
__host__ __device__ constexpr int f_splitk_max_stage(int m) { return m == 1 ? 256 : 128; }

// One stage slot: srows pulse rows of kSplitRow bytes, then x's m x srows
// slice in its dtype (xsize bytes an element).
__host__ __device__ inline int f_splitk_slot_bytes(int m, int srows, int xsize) {
  return (srows * kSplitRow + m * srows * xsize + 15) & ~15;
}

// Dynamic shared memory of a CTA: x's f64 slice, then `slots` stage slots.
__host__ __device__ inline int f_splitk_smem_bytes(int m, int srows, int xsize, int slots) {
  return m * srows * 8 + slots * f_splitk_slot_bytes(m, srows, xsize);
}

// Byte j of a pulse word biased by 0x80808080 (the pulse w + 128, 0..255),
// as the exact f64 w: the double 2^52 + (w + 128) built from its bits, less
// 2^52 + 128.
__device__ __forceinline__ double biased_pulse(uint32_t biased, int j) {
  const uint32_t u = __byte_perm(biased, 0u, 0x4440u | (unsigned)j);
  return __hiloint2double(0x43300000, (int)u) - 4503599627370624.0;
}

// A group's f64 sum rounded to f32 once, times rho, into the f32
// accumulator: the plain version's order.
__device__ __forceinline__ float fold_group_f64(float acc, double s, float rv) {
  return __fadd_rn(acc, __fmul_rn(__double2float_rn(s), rv));
}

// x (E, kM, k) f32 or bf16 (aligned to 4 elements), w (E, k, n) int8
// (16-byte aligned, n % 16 == 0), rho (E, k/G, n), out (E, kM, n) in x's
// dtype; grid (ceil(n/64), splits, E).  A CTA contracts k rows
// [split * chunk, (split + 1) * chunk) in stages of srows; with splits > 1
// the chunk lies inside one group and part holds (E, splits, kM, n) f64
// partials, counters one zeroed counter per (expert, column block).
template <class Route, int kM, typename XT>
__global__ void __launch_bounds__(kSplitThreads, kM > 4 ? 2 : 3)
pvq_matmul_f_splitk_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ rho, const float* __restrict__ bias,
                           int act, XT* __restrict__ out, int k, int n, int G, int chunk,
                           int srows, double* __restrict__ part,
                           unsigned* __restrict__ counters) {
  constexpr int kOwn = (kM * kSplitCols + kSplitThreads - 1) / kSplitThreads;
  constexpr int kXS = (int)sizeof(XT);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) double red[kSplitThreads / 32][kM][kSplitCols];
  __shared__ bool last;
  const int ng = k / G, splits = gridDim.y;
  const int e = blockIdx.z, split = blockIdx.y;
  const int col0 = blockIdx.x * kSplitCols;
  x += (size_t)e * kM * k;
  w += (size_t)e * k * n;
  rho += (size_t)e * ng * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = tid % kSplitQuads, slice = tid / kSplitQuads;
  const int k0 = split * chunk, nst = chunk / srows;
  const int slot = f_splitk_slot_bytes(kM, srows, kXS);
  double* x64 = reinterpret_cast<double*>(smem);  // kM x srows: this stage's x in f64
  unsigned char* slots = smem + kM * srows * 8;

  // stage st: pulse rows [k0 + st srows, +srows) x columns [col0, col0 + 64)
  // (a 16-byte piece past n is zero-filled: src-size 0) and x's slice of
  // the same k rows, 4 elements a copy, as one cp.async group
  auto stage = [&](int st) {
    unsigned char* ws = slots + (st % kFSplitSlots) * slot;
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
      cp_async_ca<4 * kXS>(xs + 4 * kXS * i, x + (size_t)r * k + kb + 4 * c);
    }
  };

#pragma unroll
  for (int s = 0; s < kFSplitSlots - 1; ++s) {
    if (s < nst) stage(s);
    cp_async_commit();
  }

  double acc[kM][4];
#pragma unroll
  for (int r = 0; r < kM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0;
  // this thread's outputs (row r = o / 64, column col0 + o % 64), o = tid +
  // i * 256; their bias is read only at the end (held from the start, it
  // spilled at kM 4 under the 80-register cap of 3 CTAs an SM)
  float facc[kOwn], rv[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) facc[i] = rv[i] = 0.f;
  // split: the last CTA of the column block reads this group's rho after a
  // dependent wait; bring it into L2 now
  if (splits > 1 && tid < kSplitCols / 32 && col0 + 32 * tid < n)
    prefetch_l2(rho + (size_t)(k0 / G) * n + col0 + 32 * tid);

  for (int st = 0; st < nst; ++st) {
    const int kb = k0 + st * srows;
    if (splits == 1 && kb % G == 0) {  // a group starts: fetch its rho (used at its end)
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        const int o = tid + i * kSplitThreads, col = col0 + o % kSplitCols;
        if (o < kM * kSplitCols && col < n) rv[i] = __ldg(rho + (size_t)(kb / G) * n + col);
      }
    }
    cp_async_wait<kFSplitSlots - 2>();  // stage st landed (one group is committed a stage)
    __syncthreads();  // ... for every thread; stage st - 1's slot and x64 are free
    if (st + kFSplitSlots - 1 < nst) stage(st + kFSplitSlots - 1);
    cp_async_commit();
    const unsigned char* ws = slots + (st % kFSplitSlots) * slot;
    const XT* xs = reinterpret_cast<const XT*>(ws + srows * kSplitRow);
    for (int i = tid; i < kM * srows; i += kSplitThreads) x64[i] = to_f64(xs[i]);
    __syncthreads();
    // k row kr of columns 4 quad .. 4 quad + 3 (its pulse word biased)
    auto contract_row = [&](uint32_t biased, int kr) {
      double p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = biased_pulse(biased, j);
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        const double xv = x64[r * srows + kr];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fma(xv, p[j], acc[r][j]);
      }
    };
    auto pulse_word = [&](int kr) {
      return *reinterpret_cast<const uint32_t*>(ws + kr * kSplitRow + 4 * quad) ^ 0x80808080u;
    };
    // k rows 4 kq .. 4 kq + 3: up to two rows, their four words at once;
    // above, one k row at a time (unrolled, the loads and conversions of all
    // four rows were hoisted and spilled from kM 3 on)
    if constexpr (kM <= 2) {
      for (int kq = slice; kq < srows / 4; kq += kSplitSlices) {
        uint32_t rw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) rw[q] = pulse_word(4 * kq + q);
#pragma unroll
        for (int q = 0; q < 4; ++q) contract_row(rw[q], 4 * kq + q);
      }
    } else {
#pragma unroll 1
      for (int kq = slice; kq < srows / 4; kq += kSplitSlices) {
#pragma unroll 1
        for (int kr = 4 * kq; kr < 4 * kq + 4; ++kr) contract_row(pulse_word(kr), kr);
      }
    }

    const int kend = kb + srows;
    if (kend % G != 0 && st != nst - 1) continue;
    // a group (or this CTA's piece of one) ends: sum the 16 k slices
#pragma unroll
    for (int r = 0; r < kM; ++r) {
      double v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[r][j] + __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
        acc[r][j] = 0.0;
      }
      if (lane < 16) {
        double2* dst = reinterpret_cast<double2*>(&red[warp][r][4 * quad]);
        dst[0] = make_double2(v[0], v[1]);
        dst[1] = make_double2(v[2], v[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int o = tid + i * kSplitThreads, r = o / kSplitCols, c = o % kSplitCols;
      if (o >= kM * kSplitCols || col0 + c >= n) continue;
      double s = 0.0;
#pragma unroll
      for (int ww = 0; ww < kSplitThreads / 32; ++ww) s += red[ww][r][c];
      if (splits == 1) facc[i] = fold_group_f64(facc[i], s, rv[i]);
      else part[(((size_t)e * splits + split) * kM + r) * n + col0 + c] = s;
    }
    // red is written again only after the next stage's barriers
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
    // the last CTA sums each group's f64 pieces and folds the groups in the
    // plain version's order; the loads of 8 splits at a time are
    // independent of the fold, so they are in flight together
    const int per_group = G / chunk;
    const size_t step = (size_t)kM * n;
#pragma unroll 1
    for (int i = 0; i < kOwn; ++i) {
      const int o = tid + i * kSplitThreads, r = o / kSplitCols, col = col0 + o % kSplitCols;
      if (o >= kM * kSplitCols || col >= n) continue;
      const double* pp = part + ((size_t)e * splits * kM + r) * n + col;
      float f = 0.f;
      double s = 0.0;
      int g = 0, j = 0;
#pragma unroll 8
      for (int sp = 0; sp < splits; ++sp) {
        const float rg = __ldg(rho + (size_t)g * n + col);
        s += __ldcg(pp + (size_t)sp * step);
        if (++j == per_group) {
          f = fold_group_f64(f, s, rg);
          s = 0.0;
          j = 0;
          ++g;
        }
      }
      facc[i] = f;
    }
  }
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int o = tid + i * kSplitThreads, r = o / kSplitCols, col = col0 + o % kSplitCols;
    if (o < kM * kSplitCols && col < n)  // out is offset only here: a register pair saved
      finish(facc[i], 1.f, kNoScale, bias != nullptr, bias ? __ldg(bias + col) : 0.f, act,
             out + ((size_t)e * kM + r) * n + col);
  }
}

template <class Route, int kM, typename XT>
int launch_f_splitk_m(const XT* x, const int8_t* w, const float* rho, const float* bias, int act,
                      XT* out, int e, int k, int n, int G, int chunk, int splits, double* part,
                      unsigned* counters, cudaStream_t s) {
  auto* fn = pvq_matmul_f_splitk_kernel<Route, kM, XT>;
  constexpr int kMaxStage = f_splitk_max_stage(kM);
  // the most dynamic shared memory any call asks for, set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      f_splitk_smem_bytes(kM, kMaxStage, (int)sizeof(XT), kFSplitSlots));
  if (attr != cudaSuccess) return (int)attr;
  const int srows = splitk_stage_rows(G, chunk, splits, kMaxStage);
  const int nst = chunk / srows;
  const size_t smem = (size_t)f_splitk_smem_bytes(kM, srows, (int)sizeof(XT),
                                                  nst < kFSplitSlots ? nst : kFSplitSlots);
  const dim3 grid((n + kSplitCols - 1) / kSplitCols, splits, e);
  fn<<<grid, kSplitThreads, smem, s>>>(x, w, rho, bias, act, out, k, n, G, chunk, srows, part,
                                       counters);
  return (int)cudaGetLastError();
}

// The splitk body over e matrices of (m, k) x (k, n) with the plan (cols,
// chunk, splits) of pvq_matmul._v3_decode_plan.  Needs m <= 8, cols == 64,
// G % 4 == 0, n % 16 == 0, a 16-byte aligned w and an x aligned to 4
// elements; chunk == k unsplit, else chunk * splits == k with chunk a
// multiple of 4 dividing G, and then part ((e, splits, m, n) f64) and
// counters (e * ceil(n / 64) zeros).  The launch fails otherwise.
template <class Route, typename XT>
int launch_f_splitk(const XT* x, const int8_t* w, const float* rho, const float* bias, int act,
                    XT* out, int e, int m, int k, int n, int G, int cols, int chunk, int splits,
                    double* part, unsigned* counters, cudaStream_t s) {
  const bool split_ok = splits == 1 ? chunk == k
                                    : splits > 1 && chunk > 0 && chunk % 4 == 0 &&
                                          G % chunk == 0 && (long long)chunk * splits == k &&
                                          part && counters;
  if (m > 8 || cols != kSplitCols || G % 4 || n % 16 || ((uintptr_t)w & 15) ||
      ((uintptr_t)x % (4 * sizeof(XT))) || !split_ok)
    return (int)cudaErrorInvalidValue;
  switch (m) {
#define PVQ_F_SPLITK_M(M) \
  case M: return launch_f_splitk_m<Route, M>(x, w, rho, bias, act, out, e, k, n, G, chunk, splits, part, counters, s)
    PVQ_F_SPLITK_M(1); PVQ_F_SPLITK_M(2); PVQ_F_SPLITK_M(3); PVQ_F_SPLITK_M(4);
    PVQ_F_SPLITK_M(5); PVQ_F_SPLITK_M(6); PVQ_F_SPLITK_M(7); PVQ_F_SPLITK_M(8);
#undef PVQ_F_SPLITK_M
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel v2's bodies; the caller picks one (kernels/pvq_matmul.py:_v2_body).
enum FBody { kFBodyDirect = 0, kFBodyMma = 1, kFBodySplitK = 2 };

// Launch kernel v2 over `stack` matrices of (m, k) x (k, n), packed one
// after another, with the given body; x and out are f32 (x_bf16 = 0) or
// bf16 (x_bf16 = 1), bias (n) is shared.  The mma body needs G % 16 == 0,
// n % 16 == 0 and 16-byte aligned x, w and rho; the splitk body takes the
// plan (cols, chunk, splits), its f64 scratch and the arrival counters
// (ignored by the others) and needs what launch_f_splitk lists.  The launch
// fails otherwise.
template <class Route>
int launch_f_stack(const void* x, const int8_t* w, const float* rho, const float* bias, int act,
                   void* out, int x_bf16, int stack, int m, int k, int n, int G, int body,
                   int cols, int chunk, int splits, double* part, unsigned* counters,
                   cudaStream_t s) {
  if (body == kFBodyDirect)
    return launch_f<Route>(x, w, rho, bias, act, out, x_bf16, stack, m, k, n, G, s);
  if (stack <= 0 || m <= 0 || n <= 0) return 0;
  if (G <= 0 || k % G) return (int)cudaErrorInvalidValue;
  if (body == kFBodySplitK) {
    if (x_bf16)
      return launch_f_splitk<Route>(static_cast<const __nv_bfloat16*>(x), w, rho, bias, act,
                                    static_cast<__nv_bfloat16*>(out), stack, m, k, n, G, cols,
                                    chunk, splits, part, counters, s);
    return launch_f_splitk<Route>(static_cast<const float*>(x), w, rho, bias, act,
                                  static_cast<float*>(out), stack, m, k, n, G, cols, chunk,
                                  splits, part, counters, s);
  }
  if (body != kFBodyMma) return (int)cudaErrorInvalidValue;
  if (G % 16 || n % 16 || (((uintptr_t)x | (uintptr_t)w | (uintptr_t)rho) & 15))
    return (int)cudaErrorInvalidValue;
#define PVQ_LAUNCH_F_MMA(XT)                                                                  \
  return G % 32 == 0                                                                         \
             ? launch_f_mma<Route, 32>(static_cast<const XT*>(x), w, rho, bias, act,         \
                                       static_cast<XT*>(out), stack, m, k, n, G, s)          \
             : launch_f_mma<Route, 16>(static_cast<const XT*>(x), w, rho, bias, act,         \
                                       static_cast<XT*>(out), stack, m, k, n, G, s)
  if (x_bf16) PVQ_LAUNCH_F_MMA(__nv_bfloat16);
  PVQ_LAUNCH_F_MMA(float);
#undef PVQ_LAUNCH_F_MMA
}

}  // namespace pvq
