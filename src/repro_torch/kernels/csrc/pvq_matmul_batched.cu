// PVQ matmuls over a stack of expert matrices: the MoE expert-bank
// contraction, one launch for every expert.
//
// Replaces:
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul_q_batched (a lax.scan of
//     kernel v3 over the expert axis) together with the DMA body it reaches
//     for big tiles, _kernel_q_dma, which keeps the pulse operand in HBM and
//     streams it in bk-row chunks through a 2-slot VMEM ring
//     (make_async_copy + semaphores) while the previous chunk contracts;
//   * src/repro/kernels/pvq_matmul.py:pvq_matmul_batched (a lax.scan of
//     kernel v2 over the expert axis).
//
//   v3:  y[e] = act(a[e] (.) sum_g rho[e, g, :] * int32(x_q[e][:, gG:(g+1)G] @ W[e][gG:(g+1)G, :]))
//   v2:  y[e] = act(sum_g rho[e, g, :] * (x[e][:, gG:(g+1)G] @ W[e][gG:(g+1)G, :]))
//
// What bounds it: at decode the dispatch GEMM has m = groups x capacity = 1
// row per expert, so every pulse byte feeds one multiply-add: the kernel is
// bound by the bytes of the pulse planes (E * k * n int8 plus the rho
// planes).  At prefill (m = 60) it still is: 2 * 60 multiply-adds per
// pulse byte is far below the card's int8 ops-to-bytes ratio.
//
// Design: the scan over experts becomes the grid's z axis (blockIdx.z is
// the expert; its base pointers come from the strides), so one launch
// covers every expert.  Both kernels are the 2-D ones, launched over the
// stack.  v3 takes the body the wrapper picks (kernels/pvq_matmul.py:
// _v3_body): at decode (m <= 8) the splitk body (pvq_matmul_splitk.cuh),
// whose up-front cp.async requests of each CTA's pulse tile stand in for
// the DMA body's streaming (at 64 experts the column blocks fill the card,
// so the plan does not split k); at prefill the
// int8 tensor-core body (pvq_matmul_mma.cuh), whose 64-row tiles hold an
// expert's 60 dispatch rows in one row block, so each pulse byte is read
// from device memory once.  Every body is bit-identical to
// pvq_matmul_q_batched_plain.  v2 takes the body the wrapper picks
// (kernels/pvq_matmul.py:_v2_body): at prefill the f64 tensor-core body
// (pvq_matmul_f_mma.cuh), whose 64-row tiles likewise hold an expert's 60
// rows, at decode the splitk body (pvq_matmul_f_splitk.cuh: unsplit at 64
// experts, each CTA's pulse tile streamed through a cp.async ring).

#include "pvq_matmul_f_splitk.cuh"
#include "pvq_matmul_mma.cuh"

using namespace pvq;

// Batched kernel v3 over E experts: x (E, m, k) int8, w (E, k, n) int8,
// rho (E, k/G, n) f32, a (E, m, 1) per row (a_mode 0) or (E, m, k/G) per
// tile (a_mode 2, applied beside rho); out (E, m, n) f32 (out_bf16 = 0) or
// bf16 (out_bf16 = 1).
extern "C" int pvq_matmul_q_batched_launch(const int8_t* x, const int8_t* w, const float* rho,
                                           const float* a, int a_mode, int act, void* out,
                                           int out_bf16, int e, int m, int k, int n, int G,
                                           int body, int cols, int chunk, int splits, int* part,
                                           unsigned* counters, void* stream) {
  if (a_mode != kPerRow && a_mode != kPerTile) return (int)cudaErrorInvalidValue;
  return launch_q_stack<ExpertStack>(x, w, rho, a, a_mode, nullptr, act, out, out_bf16, e, m, k,
                                     n, G, body, cols, chunk, splits, part, counters,
                                     (cudaStream_t)stream);
}

// Batched kernel v2 over E experts: x and out (E, m, k) / (E, m, n), f32
// (x_bf16 = 0) or bf16 (x_bf16 = 1), with the given body (0 direct, 1 mma,
// 2 splitk with its plan, f64 scratch and counters).
extern "C" int pvq_matmul_batched_launch(const void* x, const int8_t* w, const float* rho,
                                         int act, void* out, int x_bf16, int e, int m, int k,
                                         int n, int G, int body, int cols, int chunk, int splits,
                                         double* part, unsigned* counters, void* stream) {
  return launch_f_stack<ExpertStack>(x, w, rho, nullptr, act, out, x_bf16, e, m, k, n, G, body,
                                     cols, chunk, splits, part, counters, (cudaStream_t)stream);
}
