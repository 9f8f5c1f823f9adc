// Fused PVQ matmuls against int8 pulse planes, rho applied once per group.
//
// Replaces:
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul_q (kernel v3: _kernel_q /
//     _kernel_q_bias with _contract_int8_q and _q_epilogue).  Its TPU-only
//     DMA body _kernel_q_dma streams the pulse operand through a 2-slot
//     VMEM ring; the decode body v3 shares with the batched v3
//     (pvq_matmul_splitk.cuh) requests each CTA's pulse tile up front with
//     cp.async, so the 2-D route streams its pulses too;
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul (kernel v2: _kernel /
//     _kernel_bias with _accumulate_int8); its body is shared with the
//     batched v2 in pvq_matmul_common.cuh.
//
//   v3:  y = act(a (.) sum_g rho[g, :] * int32(x_q[:, gG:(g+1)G] @ W[gG:(g+1)G, :]) + bias)
//   v2:  y = act(sum_g rho[g, :] * (x[:, gG:(g+1)G] @ W[gG:(g+1)G, :]) + bias)
//
// What bounds it: at decode shapes (m = batch rows) the pulse plane is read
// once and each byte feeds only m multiply-adds, so it is bound by the
// bytes of W (k * n int8).  At the prefill shapes it still is: at m 512,
// k 1024, n 2560 the call moves 8.4 MB, mostly its f32 output (2.5 us at
// the card's memory rate), against 1.4 us of int8 tensor-core operations.
// v3 has three bodies, all exact in their int32 group sums, chosen per call
// by the wrapper (kernels/pvq_matmul.py:_v3_body): at m <= 8 the splitk
// body (pvq_matmul_splitk.cuh: the contraction split over CTAs of 64
// columns x a k chunk, int32 partials summed by the last CTA of each column
// block, __dp4a on operands transposed in registers) when G % 4 == 0,
// n % 16 == 0 and the pulses are 16-byte aligned; at m > 8 the int8
// tensor-core body (pvq_matmul_mma.cuh: mma.sync m16n8k32 on 64 x 128
// tiles) when G % 32 == 0, n % 16 == 0 and the rows are 16-byte aligned;
// the direct body (pvq_matmul_common.cuh: 8 rows x 32 columns a CTA, 8
// warps splitting each group in 4-row __dp4a chunks, W read straight from
// global memory) otherwise.
// v2 has three bodies, chosen per call by the wrapper (kernels/pvq_matmul.py:
// _v2_body): at m <= 8 the splitk body (pvq_matmul_f_splitk.cuh: v3's
// split of the contraction over CTAs and its cp.async pulse stream, with
// f64 partials and f64 FMAs of exact products) when G % 4 == 0, n % 16 == 0,
// the pulses are 16-byte aligned and x is aligned to 4 elements; at m > 8
// the f64 tensor-core body (pvq_matmul_f_mma.cuh: mma.sync m16n8k4 .f64 on
// 64 x 64 tiles) when G % 16 == 0, n % 16 == 0 and the rows are 16-byte
// aligned; the direct body (pvq_matmul_common.cuh: 8 x 32 CTAs, W read
// from global memory) otherwise.  The partials of a group are summed exactly
// (int32; on v2 in f64, rounded to f32 once) BEFORE the group's single rho
// multiply, so a group is never split across two rho products.  Every float
// multiply and add after a group's contraction is a separately rounded
// __fmul_rn / __fadd_rn in the plain version's order, so v3 agrees with it
// bit for bit and v2 does too unless a group's f64 sum lies within its own
// rounding error of an f32 rounding boundary.

#include "pvq_matmul_f_splitk.cuh"
#include "pvq_matmul_mma.cuh"

using namespace pvq;

// out_bf16: 0 -> f32 output, 1 -> bf16 output.
// body: 0 -> splitk, 1 -> direct, 2 -> mma (pvq_matmul_mma.cuh, Body);
// cols, chunk, splits, part and counters: the splitk body's plan, int32
// scratch and arrival counters (ignored by the others).
extern "C" int pvq_matmul_q_launch(const int8_t* x, const int8_t* w,
                                   const float* rho, const float* a, int a_mode,
                                   const float* bias, int act, void* out,
                                   int out_bf16, int m, int k, int n, int G,
                                   int body, int cols, int chunk, int splits, int* part,
                                   unsigned* counters, void* stream) {
  return launch_q_stack<OneMatrix>(x, w, rho, a, a_mode, bias, act, out, out_bf16, 1, m, k, n,
                                   G, body, cols, chunk, splits, part, counters,
                                   (cudaStream_t)stream);
}

// x_bf16: 0 -> x and out are f32, 1 -> x and out are bf16.
// body: 0 -> direct, 1 -> mma, 2 -> splitk (pvq_matmul_f_splitk.cuh, FBody);
// cols, chunk, splits, part and counters: the splitk body's plan, f64
// scratch and arrival counters (ignored by the others).
extern "C" int pvq_matmul_launch(const void* x, const int8_t* w, const float* rho,
                                 const float* bias, int act, void* out,
                                 int x_bf16, int m, int k, int n, int G,
                                 int body, int cols, int chunk, int splits, double* part,
                                 unsigned* counters, void* stream) {
  return launch_f_stack<OneMatrix>(x, w, rho, bias, act, out, x_bf16, 1, m, k, n, G, body, cols,
                                   chunk, splits, part, counters, (cudaStream_t)stream);
}
