// Packed-KV flash decode: int8 queries against PVQ int8 K/V pulse planes.
//
// Replaces: src/repro/kernels/pvq_matmul.py:pvq_attn_q (kernel v4,
// _attn_kernel_q).  The TPU grid (BH, S/bs) walks the sequence axis in
// order on one core.  Per 128-column block and query row it computes
//
//   scores = (sum_g int32(q_g . K_g^T) * krho_g) * a * sm_scale, masked to
//            -1e30 at columns >= kv_len;
//   online softmax (running max m, denominator l);
//   per group: p * vrho_g requantized to int8 per row (max|.|/127, round
//            half to even, clip +-127), acc = acc * alpha + int32(p_q @ V_g) * s_p,
//
// and returns the UNNORMALIZED (acc, m, l); rows with kv_len == 0 keep
// m = -1e30 and l = 0.  The blocks keep the reference's 128-column
// partition, which matters: the probabilities are requantized per block.
//
// Design (body in pvq_attn_decode.cuh; plan in pvq_matmul.py:_v4_plan):
//   * grid (b * n_kv rows) x (tiles of kM <= 8 query rows): a CTA stages its
//     row's K/V planes once for every query row of its tile, and shared
//     memory does not grow with m;
//   * kM x W warps a CTA, warp w on the pair (query row w % kM, block
//     w / kM): a pass takes W blocks at once, and a row longer than W
//     blocks makes passes, carrying (acc, m, l) from one to the next;
//   * lane l holds columns l, l+32, l+64, l+96: the block's probability sum
//     is (c0 + c2) + (c1 + c3) in registers, then __shfl_down at 16 ... 1,
//     the plain version's pairwise tree over the block zero-padded to 128
//     (the adds of 0 are exact); maxima are shuffles (order-free);
//   * the score and P @ V dots are int32 __dp4a sums (exact in any order);
//     P @ V packs the requantized probabilities 4 columns a word and
//     transposes V's bytes in registers (__byte_perm), so all 32 lanes work;
//   * K/V and their scales come in by cp.async (16-byte pieces when hd %
//     16 == 0, else 4-byte or byte pieces), V's issued before the score work
//     so they land under it.  Positions past kv_len are zeros and blocks past
//     it are not read.
//
// Why the split over blocks is exact.  Block b depends on the blocks
// before it only through the running max entering it,
// m_b = max(m_{b-1}, blockmax_b): a prefix max of the block maxima, which
// any order gives exactly.  Given it, the block's p, its tree sum, each
// group's s_p, the requantization and the int32 P @ V are the plain
// version's values, so the warps compute them side by side; what is left
// sequential is the fold l = l * alpha_b + psum_b, acc = acc * alpha_b +
// o_b * s_p_b with alpha_b = exp_nonpos(m_{b-1} - m_b), which one thread
// per output element runs in block order with the plain version's roundings.
// A block wholly past kv_len leaves (acc, m, l) unchanged in the plain
// version (alpha 1, p 0), so skipping it changes nothing.  Every float
// multiply and add is a separately rounded __fmul_rn / __fadd_rn (this file
// builds without -fmad=false) and exp is exp_nonpos, the plain version's
// own sequence of operations (pvq_matmul.py:exp_nonpos): the kernel agrees
// bit for bit with its plain version.
//
// The K/V planes are read where the packed cache keeps them, in its
// (b, S, n_kv, X) layout: row bh is batch bh / n_kv, kv head bh % n_kv, and
// sequence position s sits n_kv * X elements after s - 1.
//
// What bounds it: the bytes of the packed K/V planes (hd + 4 * hd / G bytes
// per token per plane).  At decode (BH = batch * n_kv rows, m = 3 query
// rows, S = 160) a call moves ~0.5 MB, a fraction of a microsecond at the
// HBM's rate: it is a latency chain (launch, one DRAM round trip, a few
// shuffles and barriers), which the warps over blocks and query rows keep
// short.

#include "pvq_attn_decode.cuh"

using namespace pvq;

namespace {

template <int kPiece>
int launch(const int8_t* q, const float* a, const int8_t* kp, const float* ks,
           const int8_t* vp, const float* vs, const int* kv_len, int bh, int n_kv, int m,
           int S, int hd, int G, float sm_scale, int km, int w, float* acc,
           float* m_out, float* l_out, cudaStream_t stream) {
  static bool configured = false;  // once per instance: the attribute outlives the call
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        pvq_attn_q_kernel<kPiece>, cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnSmemMax);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = attn_layout(km, w, hd, G).total;
  const dim3 grid(bh, (m + km - 1) / km);
  pvq_attn_q_kernel<kPiece><<<grid, 32 * km * w, smem, stream>>>(
      q, a, kp, ks, vp, vs, kv_len, n_kv, m, S, hd, G, sm_scale, km, w, acc, m_out, l_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t pvq_attn_q_smem_bytes(int km, int w, int hd, int G) {
  return attn_layout(km, w, hd, G).total;
}

extern "C" int pvq_attn_q_launch(const int8_t* q, const float* a,
                                 const int8_t* kp, const float* ks,
                                 const int8_t* vp, const float* vs,
                                 const int* kv_len, int bh, int n_kv, int m, int S,
                                 int hd, int G, float sm_scale, int km, int w,
                                 float* acc, float* m_out, float* l_out, void* stream) {
  if (bh <= 0 || m <= 0) return 0;
  if (G <= 0 || hd % G || n_kv <= 0 || bh % n_kv) return (int)cudaErrorInvalidValue;
  if (km < 1 || km > kAttnMaxRows || w < 1 || km * w > kAttnMaxWarps ||
      (m + km - 1) / km > 65535 || attn_layout(km, w, hd, G).total > (size_t)kAttnSmemMax)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd % 16 == 0)
    return launch<16>(q, a, kp, ks, vp, vs, kv_len, bh, n_kv, m, S, hd, G, sm_scale, km, w,
                      acc, m_out, l_out, st);
  if (hd % 4 == 0)
    return launch<4>(q, a, kp, ks, vp, vs, kv_len, bh, n_kv, m, S, hd, G, sm_scale, km, w,
                     acc, m_out, l_out, st);
  return launch<1>(q, a, kp, ks, vp, vs, kv_len, bh, n_kv, m, S, hd, G, sm_scale, km, w,
                   acc, m_out, l_out, st);
}
