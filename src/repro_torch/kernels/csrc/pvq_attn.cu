// Packed-KV flash decode: int8 queries against PVQ int8 K/V pulse planes.
//
// Replaces: src/repro/kernels/pvq_matmul.py:pvq_attn_q (kernel v4,
// _attn_kernel_q).  The TPU grid (BH, S/bs) walks the sequence axis in
// order on one core; here one CTA owns one (batch x kv-head) row and loops
// over 128-column sequence blocks itself (blocks run in the same order and
// with the same 128-column partition as the reference, which matters: the
// probabilities are requantized per block).  Per block and query row:
//
//   scores = (sum_g int32(q_g . K_g^T) * krho_g) * a * sm_scale, masked to
//            -1e30 at columns >= kv_len;
//   online softmax (running max m, denominator l);
//   per group: p * vrho_g requantized to int8 per row (max|.|/127, round
//            half to even, clip +-127), acc = acc * alpha + int32(p_q @ V_g) * s_p.
//
// It returns the UNNORMALIZED (acc, m, l); rows with kv_len == 0 keep
// m = -1e30 and l = 0.  Blocks that lie wholly past kv_len are skipped: in
// the reference they leave (acc, m, l) unchanged exactly.
//
// The K/V planes are read where the packed cache keeps them, in its
// (b, S, n_kv, X) layout: row bh is batch bh / n_kv, kv head bh % n_kv, and
// sequence position s sits n_kv * X elements after s - 1.  Every float multiply and add is a separately rounded
// __fmul_rn / __fadd_rn (no FMA contraction), the block sums are a pairwise
// tree, and exp is exp_nonpos below, the plain version's own sequence of
// operations (pvq_matmul.py:exp_nonpos), so the kernel agrees bit for bit
// with its plain version.
//
// What bounds it: the bytes of the packed K/V planes (hd + 4 * hd / G bytes
// per token per plane).  At decode shapes (BH = batch * n_kv rows, m = 3
// query rows, S = 160) the whole call moves ~0.5 MB and is bound by launch
// and reduction latency instead: this first version is simple, one thread
// per sequence column for the scores and one per head-dim lane for P @ V,
// with block-wide shared-memory reductions in between.  Any group width
// works (the reduced model's head dim 16 gives group 16, narrower than an
// int8 MMA k-step), because the int8 dot products are plain integer loops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBS = 128;  // sequence columns per block = threads per CTA
constexpr float kNegInf = -1e30f;

// exp(x) for x <= 0: Cody-Waite reduction x = n ln2 + r, the Cephes expf
// polynomial on r, then times 2^n built from its bits; 0 below -87.  Every
// step is the one pvq_matmul.py:exp_nonpos takes, rounded the same way.
__device__ __forceinline__ float exp_nonpos(float x) {
  if (x < -87.f) return 0.f;
  const float n = rintf(__fmul_rn(x, 1.44269504088896341f));
  const float r = __fsub_rn(__fsub_rn(x, __fmul_rn(n, 0.693359375f)),
                            __fmul_rn(n, -2.12194440e-4f));
  const float z = __fmul_rn(r, r);
  float y = __fadd_rn(__fmul_rn(r, 1.9875691500e-4f), 1.3981999507e-3f);
  y = __fadd_rn(__fmul_rn(y, r), 8.3334519073e-3f);
  y = __fadd_rn(__fmul_rn(y, r), 4.1665795894e-2f);
  y = __fadd_rn(__fmul_rn(y, r), 1.6666665459e-1f);
  y = __fadd_rn(__fmul_rn(y, r), 5.0000001201e-1f);
  y = __fadd_rn(__fadd_rn(__fmul_rn(y, z), r), 1.f);
  return __fmul_rn(y, __int_as_float(((int)n + 127) << 23));
}

__device__ float block_reduce(float v, float* sh, bool take_max) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int h = kBS / 2; h >= 1; h >>= 1) {
    if (t < h) sh[t] = take_max ? fmaxf(sh[t], sh[t + h]) : sh[t] + sh[t + h];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kBS)
pvq_attn_q_kernel(const int8_t* __restrict__ q, const float* __restrict__ a,
                  const int8_t* __restrict__ kp, const float* __restrict__ ks,
                  const int8_t* __restrict__ vp, const float* __restrict__ vs,
                  const int* __restrict__ kv_len, int n_kv, int m, int S,
                  int hd, int G, float sm_scale, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out) {
  extern __shared__ float smem[];
  const int ng = hd / G;
  float* acc = smem;                       // m * hd
  float* mrun = acc + m * hd;              // m
  float* lrun = mrun + m;                  // m
  float* ksb = lrun + m;                   // kBS * ng
  float* vsb = ksb + kBS * ng;             // kBS * ng
  float* red = vsb + kBS * ng;             // kBS
  int* pq = reinterpret_cast<int*>(red + kBS);          // kBS
  int8_t* qs = reinterpret_cast<int8_t*>(pq + kBS);     // m * hd
  int8_t* kb = qs + m * hd;                // kBS * hd
  int8_t* vb = kb + kBS * hd;              // kBS * hd

  const int t = threadIdx.x;
  const size_t bh = blockIdx.x;
  const int len = kv_len[bh];
  // entry (row bh, position s) of a plane is X-wide entry row0 + s * n_kv
  const size_t row0 = (bh / n_kv) * (size_t)S * n_kv + bh % n_kv;

  for (int i = t; i < m * hd; i += kBS) {
    qs[i] = q[bh * m * hd + i];
    acc[i] = 0.f;
  }
  for (int r = t; r < m; r += kBS) {
    mrun[r] = kNegInf;
    lrun[r] = 0.f;
  }
  __syncthreads();

  const int nblk = (len + kBS - 1) / kBS;
  for (int blk = 0; blk < nblk; ++blk) {
    const int base = blk * kBS;
    for (int i = t; i < kBS * hd; i += kBS) {
      const int j = i / hd;
      const bool in = base + j < S;
      const size_t src = (row0 + (size_t)(base + j) * n_kv) * hd + i % hd;
      kb[i] = in ? kp[src] : 0;
      vb[i] = in ? vp[src] : 0;
    }
    for (int i = t; i < kBS * ng; i += kBS) {
      const int j = i / ng;
      const bool in = base + j < S;
      const size_t src = (row0 + (size_t)(base + j) * n_kv) * ng + i % ng;
      ksb[i] = in ? ks[src] : 0.f;
      vsb[i] = in ? vs[src] : 0.f;
    }
    __syncthreads();
    const bool valid = base + t < len;

    for (int r = 0; r < m; ++r) {
      // ---- scores for column t: int8 dot per group, krho once per group
      float sc = 0.f;
      for (int g = 0; g < ng; ++g) {
        int dot = 0;
        const int8_t* qr = qs + r * hd + g * G;
        const int8_t* kr = kb + t * hd + g * G;
        for (int d = 0; d < G; ++d) dot += (int)qr[d] * (int)kr[d];
        sc = __fadd_rn(sc, __fmul_rn((float)dot, ksb[t * ng + g]));
      }
      sc = __fmul_rn(__fmul_rn(sc, a[bh * m + r]), sm_scale);
      if (!valid) sc = kNegInf;

      // ---- online softmax
      const float m_prev = mrun[r];
      const float m_new = fmaxf(m_prev, block_reduce(sc, red, true));
      const float p = valid ? exp_nonpos(__fsub_rn(sc, m_new)) : 0.f;
      const float alpha = exp_nonpos(__fsub_rn(m_prev, m_new));
      const float psum = block_reduce(p, red, false);
      if (t == 0) {
        lrun[r] = __fadd_rn(__fmul_rn(lrun[r], alpha), psum);
        mrun[r] = m_new;
      }

      // ---- per group: fold vrho, requantize p to int8, int32 P @ V
      for (int g = 0; g < ng; ++g) {
        const float pg = __fmul_rn(p, vsb[t * ng + g]);
        const float s_p = block_reduce(fabsf(pg), red, true) / 127.f;
        const float inv = s_p > 0.f ? 1.f / fmaxf(s_p, 1e-30f) : 0.f;
        pq[t] = (int)fminf(fmaxf(rintf(__fmul_rn(pg, inv)), -127.f), 127.f);
        __syncthreads();
        for (int d = t; d < G; d += kBS) {
          int o = 0;
          for (int j = 0; j < kBS; ++j) o += pq[j] * (int)vb[j * hd + g * G + d];
          float* ar = acc + r * hd + g * G + d;
          *ar = __fadd_rn(__fmul_rn(*ar, alpha), __fmul_rn((float)o, s_p));
        }
        __syncthreads();
      }
    }
  }

  for (int i = t; i < m * hd; i += kBS) acc_out[bh * m * hd + i] = acc[i];
  for (int r = t; r < m; r += kBS) {
    m_out[bh * m + r] = mrun[r];
    l_out[bh * m + r] = lrun[r];
  }
}

}  // namespace

extern "C" size_t pvq_attn_q_smem_bytes(int m, int hd, int G) {
  const int ng = hd / G;
  return sizeof(float) * ((size_t)m * hd + 2 * m + 2 * kBS * ng + kBS) +
         sizeof(int) * kBS + (size_t)m * hd + 2 * (size_t)kBS * hd;
}

extern "C" int pvq_attn_q_launch(const int8_t* q, const float* a,
                                 const int8_t* kp, const float* ks,
                                 const int8_t* vp, const float* vs,
                                 const int* kv_len, int bh, int n_kv, int m, int S,
                                 int hd, int G, float sm_scale, float* acc,
                                 float* m_out, float* l_out, void* stream) {
  if (bh <= 0) return 0;
  if (G <= 0 || hd % G || n_kv <= 0 || bh % n_kv) return (int)cudaErrorInvalidValue;
  const size_t smem = pvq_attn_q_smem_bytes(m, hd, G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pvq_attn_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pvq_attn_q_kernel<<<bh, kBS, smem, (cudaStream_t)stream>>>(
      q, a, kp, ks, vp, vs, kv_len, n_kv, m, S, hd, G, sm_scale, acc, m_out, l_out);
  return (int)cudaGetLastError();
}
