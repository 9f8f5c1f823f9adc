// Fused PVQ matmuls against int8 pulse planes, rho applied once per group.
//
// Replaces:
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul_q (kernel v3: _kernel_q /
//     _kernel_q_bias with _contract_int8_q and _q_epilogue).  Its TPU-only
//     DMA body _kernel_q_dma streams the pulse operand through a 2-slot
//     VMEM ring; the body v3 shares with the batched v3
//     (pvq_matmul_common.cuh, pvq_matmul_q_kernel) carries that streaming
//     as a 2-stage cp.async ring, so the 2-D route streams its pulses too;
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul (kernel v2: _kernel /
//     _kernel_bias with _accumulate_int8); its body is shared with the
//     batched v2 in pvq_matmul_common.cuh.
//
//   v3:  y = act(a (.) sum_g rho[g, :] * int32(x_q[:, gG:(g+1)G] @ W[gG:(g+1)G, :]) + bias)
//   v2:  y = act(sum_g rho[g, :] * (x[:, gG:(g+1)G] @ W[gG:(g+1)G, :]) + bias)
//
// What bounds it: at decode shapes (m = batch rows) the pulse plane is read
// once and each byte feeds only m multiply-adds, so it is bound by the
// bytes of W (k * n int8).  At prefill shapes (m = 512) it is bound by the
// integer multiply-adds.  This first version is simple (both bodies, the
// CTA shape and the epilogue are in pvq_matmul_common.cuh): a CTA owns 32
// output columns (one per lane) and 8 output rows; its 8 warps split the
// contraction of each group in 4-row chunks (int8 x int8 through __dp4a on
// the v3 path, f64 FMAs of exact products on the v2 path).  The per-warp
// partials of a group are summed exactly (int32; on v2 in f64, rounded to
// f32 once) in shared memory BEFORE the group's single rho multiply, so a
// group is never split across two rho products.  No tensor cores or TMA
// yet; v2 reads W straight from global memory with one byte per lane per
// k row (32-byte coalesced rows).  Every float multiply and add after a
// group's contraction is a separately rounded __fmul_rn / __fadd_rn in the
// plain version's order, so v3 agrees with it bit for bit and v2 does too
// unless a group's f64 sum lies within its own rounding error of an f32
// rounding boundary.

#include "pvq_matmul_common.cuh"

using namespace pvq;

// out_bf16: 0 -> f32 output, 1 -> bf16 output.
extern "C" int pvq_matmul_q_launch(const int8_t* x, const int8_t* w,
                                   const float* rho, const float* a, int a_mode,
                                   const float* bias, int act, void* out,
                                   int out_bf16, int m, int k, int n, int G,
                                   void* stream) {
  return launch_q_stack(x, w, rho, a, a_mode, bias, act, out, out_bf16, 1, m, k, n, G,
                        (cudaStream_t)stream);
}

// x_bf16: 0 -> x and out are f32, 1 -> x and out are bf16.
extern "C" int pvq_matmul_launch(const void* x, const int8_t* w, const float* rho,
                                 const float* bias, int act, void* out,
                                 int x_bf16, int m, int k, int n, int G,
                                 void* stream) {
  return launch_f(x, w, rho, bias, act, out, x_bf16, 1, m, k, n, G, (cudaStream_t)stream);
}
