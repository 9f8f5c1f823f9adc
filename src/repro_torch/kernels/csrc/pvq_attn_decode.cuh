// Kernel v4's body: packed-KV flash decode with the query rows tiled over
// the grid and the sequence blocks over the warps of a CTA (see pvq_attn.cu
// for the design and why it is exact).
//
// CTA (row bh, tile of kM query rows), kM x W warps; warp w owns the pair
// (query row w % kM, block w / kM of the pass).  A pass stages W 128-column
// blocks of the row's K and V planes (and their scales) into shared memory.

#pragma once

#include "pvq_matmul_common.cuh"

namespace pvq {

constexpr int kAttnBS = 128;          // sequence columns per block (the plain version's)
constexpr int kAttnMaxRows = 8;       // query rows a CTA at most (kM)
constexpr int kAttnMaxWarps = 16;     // kM x W at most
constexpr int kAttnSmemMax = 232448;  // 227 KB: the H100's shared memory a CTA
constexpr float kAttnNegInf = -1e30f;

__host__ __device__ inline int attn_next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Head-dim quads (4 dims) the P @ V lanes take: below 32 rounded up to a
// power of two so the lanes split the columns evenly.
__host__ __device__ inline int attn_quads(int hd) {
  const int nq = (hd + 3) / 4;
  return nq >= 32 ? nq : attn_next_pow2(nq);
}

// A staged K or V position, in bytes: at least hd rounded up to 16 and the
// quads' reach, then padded to 16 mod 32 bytes (4 mod 8 words), so that 16-byte
// loads of 8 consecutive positions (the score lanes) and the P @ V lanes'
// words at hd 64 fall in distinct banks.
__host__ __device__ inline int attn_row_bytes(int hd) {
  int words = (hd + 15) / 16 * 4;
  if (words < attn_quads(hd)) words = attn_quads(hd);
  return 4 * (words + (12 - words % 8) % 8);
}

struct AttnLayout {
  size_t k_tile;  // bytes of one K (or V) tile: W * 128 rows; then the V tile,
                  // K scales and V scales
  size_t q_off, pq_off, f_off, total;
  int row, qrow;
};

__host__ __device__ inline AttnLayout attn_layout(int km, int w, int hd, int G) {
  AttnLayout L;
  const int ng = hd / G;
  L.row = attn_row_bytes(hd);
  L.qrow = (hd + 15) / 16 * 16;
  L.k_tile = (size_t)w * kAttnBS * L.row;
  L.q_off = 2 * L.k_tile + 2 * (size_t)w * kAttnBS * ng * sizeof(float);
  L.pq_off = L.q_off + (size_t)km * L.qrow;
  L.f_off = L.pq_off + (size_t)km * w * ng * kAttnBS;
  // floats: block outputs (W x kM x hd), acc (kM x hd), s_p per pair and
  // group, then per pair block max, alpha, block's running max, p sum, then
  // per row running max, running sum and activation scale
  const size_t floats = (size_t)w * km * hd + (size_t)km * hd + (size_t)km * w * ng +
                        4 * (size_t)km * w + 3 * (size_t)km;
  L.total = L.f_off + floats * sizeof(float);
  return L;
}

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

__device__ __forceinline__ float attn_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 bytes global -> shared through L1; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// kPiece bytes global -> shared (16 and 4 by cp.async, 1 by a plain load);
// zeros where !in
template <int kPiece>
__device__ __forceinline__ void attn_piece(int8_t* s, const int8_t* g, bool in) {
  if constexpr (kPiece == 16) {
    cp_async16(s, g, in ? 16 : 0);
  } else if constexpr (kPiece == 4) {
    cp_async4(s, g, in ? 4 : 0);
  } else {
    *s = in ? *g : 0;
  }
}

// f(c, piece) for each of per pieces of cols positions, over nt threads:
// where per divides nt (every plan at hd 64) a thread keeps one piece and
// steps over positions, with no division in the loop.
template <class F>
__device__ __forceinline__ void attn_for_pieces(int cols, int per, int t, int nt, F&& f) {
  if (nt % per == 0) {
    const int piece = t % per, step = nt / per;
    for (int c = t / per; c < cols; c += step) f(c, piece);
  } else {
    for (int i = t; i < cols * per; i += nt) {
      const int c = i / per;
      f(c, i - c * per);
    }
  }
}

// One plane's positions [pos0, pos0 + cols) of row row0 into its tile: pulses
// in kPiece-byte pieces, scales in 4-byte pieces; positions at or past len
// are zeros.
template <int kPiece>
__device__ __forceinline__ void attn_stage_plane(int8_t* dst, float* dst_s, const int8_t* src,
                                                 const float* src_s, size_t row0, int n_kv,
                                                 int hd, int ng, int row, int pos0, int cols,
                                                 int len, int t, int nt) {
  attn_for_pieces(cols, hd / kPiece, t, nt, [&](int c, int piece) {
    const int pos = pos0 + c;
    const bool in = pos < len;
    attn_piece<kPiece>(dst + c * row + piece * kPiece,
                       in ? src + (row0 + (size_t)pos * n_kv) * hd + piece * kPiece : src, in);
  });
  attn_for_pieces(cols, ng, t, nt, [&](int c, int g) {
    const int pos = pos0 + c;
    const bool in = pos < len;
    cp_async4(dst_s + c * ng + g, in ? src_s + (row0 + (size_t)pos * n_kv) * ng + g : src_s,
              in ? 4 : 0);
  });
}

// Scores of one (query row, block) pair at the lane's columns lane + 32 i:
// per group the exact int32 dot, then sc += dot * krho_g in group order.
__device__ __forceinline__ void attn_scores(const int8_t* qr, const int8_t* kt, const float* kst,
                                            int row, int hd, int G, int ng, int lane,
                                            float (&sc)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[i] = 0.f;
  int dot[4] = {0, 0, 0, 0};
  if (G % 16 == 0) {  // 16-byte chunks, none straddling a group
    const int per_group = G / 16;
    for (int ch = 0, g = 0, n = 0; ch < hd / 16; ++ch) {
      const int4 qq = *reinterpret_cast<const int4*>(qr + 16 * ch);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int4 kk = *reinterpret_cast<const int4*>(kt + (lane + 32 * i) * row + 16 * ch);
        dot[i] = __dp4a(qq.x, kk.x, dot[i]);
        dot[i] = __dp4a(qq.y, kk.y, dot[i]);
        dot[i] = __dp4a(qq.z, kk.z, dot[i]);
        dot[i] = __dp4a(qq.w, kk.w, dot[i]);
      }
      if (++n == per_group) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[i] = __fadd_rn(sc[i], __fmul_rn((float)dot[i], kst[(lane + 32 * i) * ng + g]));
          dot[i] = 0;
        }
        n = 0;
        ++g;
      }
    }
  } else if (G % 4 == 0) {  // 4-byte words
    const int per_group = G / 4;
    for (int wd = 0, g = 0, n = 0; wd < hd / 4; ++wd) {
      const int qq = *reinterpret_cast<const int*>(qr + 4 * wd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dot[i] = __dp4a(qq, *reinterpret_cast<const int*>(kt + (lane + 32 * i) * row + 4 * wd),
                        dot[i]);
      if (++n == per_group) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[i] = __fadd_rn(sc[i], __fmul_rn((float)dot[i], kst[(lane + 32 * i) * ng + g]));
          dot[i] = 0;
        }
        n = 0;
        ++g;
      }
    }
  } else {  // bytes
    for (int g = 0; g < ng; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* kr = kt + (lane + 32 * i) * row + g * G;
        int d4 = 0;
        for (int d = 0; d < G; ++d) d4 += (int)qr[g * G + d] * (int)kr[d];
        sc[i] = __fadd_rn(sc[i], __fmul_rn((float)d4, kst[(lane + 32 * i) * ng + g]));
      }
    }
  }
}

// int32 P @ V of one pair for head-dim quad dq over the column quads
// cq = s, s + step, ...: V's 4 x 4 bytes transposed in registers, each
// dim's word against the packed probabilities of its group.
__device__ __forceinline__ void attn_pv_quad(const int8_t* vt, const int8_t* pw, int row,
                                             int G, int ng, int dq, int s, int step,
                                             int (&o)[4]) {
  int ge[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ge[e] = min((4 * dq + e) / G, ng - 1);
  for (int cq = s; cq < kAttnBS / 4; cq += step) {
    uint32_t w[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(vt + (4 * cq + i) * row + 4 * dq);
    transpose4x4(w, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = reinterpret_cast<const int*>(pw + ge[e] * kAttnBS)[cq];
      o[e] = __dp4a(p, (int)v[e], o[e]);
    }
  }
}

template <int kPiece>
__global__ void __launch_bounds__(32 * kAttnMaxWarps)
pvq_attn_q_kernel(const int8_t* __restrict__ q, const float* __restrict__ a,
                  const int8_t* __restrict__ kp, const float* __restrict__ ks,
                  const int8_t* __restrict__ vp, const float* __restrict__ vs,
                  const int* __restrict__ kv_len, int n_kv, int m, int S, int hd, int G,
                  float sm_scale, int km, int w, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnLayout L = attn_layout(km, w, hd, G);
  const int ng = hd / G;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5;
  const size_t bh = blockIdx.x;
  const int r0 = blockIdx.y * km;
  const int rows = min(km, m - r0);
  const int len = max(0, min(kv_len[bh], S));
  // entry (row bh, position s) of a plane is X-wide entry row0 + s * n_kv
  const size_t row0 = (bh / n_kv) * (size_t)S * n_kv + bh % n_kv;

  int8_t* qs = reinterpret_cast<int8_t*>(smem + L.q_off);
  int8_t* pqs = reinterpret_cast<int8_t*>(smem + L.pq_off);
  float* obuf = reinterpret_cast<float*>(smem + L.f_off);  // [W][kM][hd]: pair w * hd
  float* accs = obuf + (size_t)w * km * hd;                 // [kM][hd]
  float* sps = accs + (size_t)km * hd;                      // [pair][ng]
  float* bmax = sps + (size_t)km * w * ng;                  // [pair]
  float* alph = bmax + km * w;
  float* mnew = alph + km * w;
  float* lsum = mnew + km * w;
  float* mrun = lsum + km * w;                              // [kM]
  float* lrun = mrun + km;
  float* arow = lrun + km;

  for (int i = t; i < rows * hd; i += nt) {
    const int r = i / hd;
    qs[r * L.qrow + i - r * hd] = q[(bh * m + r0) * hd + i];
    accs[i] = 0.f;
  }
  for (int r = t; r < rows; r += nt) {
    mrun[r] = kAttnNegInf;
    lrun[r] = 0.f;
    arow[r] = a[bh * m + r0 + r];
  }

  const int nblk = (len + kAttnBS - 1) / kAttnBS;
  const int passes = (nblk + w - 1) / w;
  int8_t* ktile = reinterpret_cast<int8_t*>(smem);
  float* kscales = reinterpret_cast<float*>(smem + 2 * L.k_tile);
  const int r = warp % km, j = warp / km;
  const int nq = (hd + 3) / 4, quads = attn_quads(hd);
  for (int p = 0; p < passes; ++p) {
    // K and its scales as one cp.async group, then V and its scales, which
    // land under the score work; the tiles' last reads (the previous pass's
    // P @ V) ended before its last barrier
    const int nv = min(w, nblk - p * w);
    const int pos0 = p * w * kAttnBS;
    attn_stage_plane<kPiece>(ktile, kscales, kp, ks, row0, n_kv, hd, ng, L.row, pos0,
                             nv * kAttnBS, len, t, nt);
    cp_async_commit();
    attn_stage_plane<kPiece>(ktile + L.k_tile, kscales + (size_t)w * kAttnBS * ng, vp, vs, row0,
                             n_kv, hd, ng, L.row, pos0, nv * kAttnBS, len, t, nt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // pass p's K landed for every thread

    const bool live = r < rows && j < nv;
    const int8_t* kt = ktile + (size_t)j * kAttnBS * L.row;
    const int8_t* vt = kt + L.k_tile;
    const float* kst = kscales + j * kAttnBS * ng;
    const float* vst = kst + (size_t)w * kAttnBS * ng;
    const int base = (p * w + j) * kAttnBS;

    // ---- scores of pair (r, j), masked past kv_len, and the block max
    float sc[4];
    if (live) {
      attn_scores(qs + r * L.qrow, kt, kst, L.row, hd, G, ng, lane, sc);
      float bm = kAttnNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[i] = base + lane + 32 * i < len
                    ? __fmul_rn(__fmul_rn(sc[i], arow[r]), sm_scale) : kAttnNegInf;
        bm = fmaxf(bm, sc[i]);
      }
      bm = attn_warp_max(bm);
      if (lane == 0) bmax[warp] = bm;
    }
    cp_async_wait<0>();
    __syncthreads();  // block maxima written, pass p's V landed

    if (live) {
      // ---- the running max entering block j (a prefix max: order-free)
      float m_prev = mrun[r];
      for (int jj = 0; jj < j; ++jj) m_prev = fmaxf(m_prev, bmax[jj * km + r]);
      const float m_new = fmaxf(m_prev, bmax[warp]);
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = base + lane + 32 * i < len ? exp_nonpos(__fsub_rn(sc[i], m_new)) : 0.f;
      // the plain version's pairwise tree over 128 columns (zero-padded)
      float ps = __fadd_rn(__fadd_rn(pr[0], pr[2]), __fadd_rn(pr[1], pr[3]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps = __fadd_rn(ps, __shfl_down_sync(0xffffffffu, ps, o));
      if (lane == 0) {
        alph[warp] = exp_nonpos(__fsub_rn(m_prev, m_new));
        mnew[warp] = m_new;
        lsum[warp] = ps;
      }

      // ---- per group: fold vrho, requantize p to int8 per row
      int8_t* pw = pqs + (size_t)warp * ng * kAttnBS;
      for (int g = 0; g < ng; ++g) {
        float pg[4], amax = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pg[i] = __fmul_rn(pr[i], vst[(lane + 32 * i) * ng + g]);
          amax = fmaxf(amax, fabsf(pg[i]));
        }
        amax = attn_warp_max(amax);
        const float s_p = amax / 127.f;
        const float inv = s_p > 0.f ? 1.f / fmaxf(s_p, 1e-30f) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[g * kAttnBS + lane + 32 * i] =
              (int8_t)(int)fminf(fmaxf(rintf(__fmul_rn(pg[i], inv)), -127.f), 127.f);
        if (lane == 0) sps[warp * ng + g] = s_p;
      }
      __syncwarp();

      // ---- int32 P @ V, every lane on a (head-dim quad, column share)
      float* ob = obuf + (size_t)warp * hd;
      const float* sp = sps + warp * ng;
      if (quads >= 32) {
        for (int dq = lane; dq < nq; dq += 32) {
          int o[4] = {0, 0, 0, 0};
          attn_pv_quad(vt, pw, L.row, G, ng, dq, 0, 1, o);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * dq + e;
            if (d < hd) ob[d] = __fmul_rn((float)o[e], sp[d / G]);
          }
        }
      } else {
        const int dq = lane & (quads - 1), s = lane / quads;
        int o[4] = {0, 0, 0, 0};
        attn_pv_quad(vt, pw, L.row, G, ng, dq, s, 32 / quads, o);
        for (int off = quads; off < 32; off <<= 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] += __shfl_xor_sync(0xffffffffu, o[e], off);
        }
        if (s == 0 && dq < nq) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * dq + e;
            if (d < hd) ob[d] = __fmul_rn((float)o[e], sp[d / G]);
          }
        }
      }
    }
    __syncthreads();  // every pair's block output written

    // ---- the in-order fold over the pass's blocks (the plain recurrence)
    for (int i = t; i < rows * hd; i += nt) {
      const int rr = i / hd;
      float x = accs[i];
      for (int jj = 0; jj < nv; ++jj)
        x = __fadd_rn(__fmul_rn(x, alph[jj * km + rr]), obuf[(size_t)(jj * km + rr) * hd + i - rr * hd]);
      accs[i] = x;
    }
    for (int rr = t; rr < rows; rr += nt) {
      float l = lrun[rr];
      for (int jj = 0; jj < nv; ++jj) l = __fadd_rn(__fmul_rn(l, alph[jj * km + rr]), lsum[jj * km + rr]);
      lrun[rr] = l;
      mrun[rr] = mnew[(nv - 1) * km + rr];
    }
    // the next pass's first barrier orders this fold before its reads
  }
  __syncthreads();

  for (int i = t; i < rows * hd; i += nt) acc_out[(bh * m + r0) * hd + i] = accs[i];
  for (int rr = t; rr < rows; rr += nt) {
    m_out[bh * m + r0 + rr] = mrun[rr];
    l_out[bh * m + r0 + rr] = lrun[rr];
  }
}

}  // namespace pvq
