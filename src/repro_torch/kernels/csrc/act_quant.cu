// Per-row symmetric int8 quantization of activations, fused with the cast
// to f32 and the zero pad to k_pad: the int8 boundary in front of kernel v3
// (every packed dense, the tied head, the MoE dispatch buffers) and of
// kernel v4 (its query).
//
// Replaces no TPU kernel: the reference quantizes in jnp
// (src/repro/core/quantize.py:quantize_activations), which XLA fuses with
// its neighbours.  The port's plain chain (a cast, F.pad, abs, amax, div,
// gt, clamp, reciprocal, mul, zeros_like, where, mul, round, clamp, to int8)
// is one PyTorch kernel an op, ~15 launches per packed dense; this is one.
//
// Bit-identical to pvq_matmul.act_quant_rows_plain (F.pad of x, then
// core/quantize.py:quantize_activations per row) run on the card, for every
// finite input:
//   amax  = max |x| over the row (pad zeros included; NaN propagates, as
//           torch.amax);
//   scale = amax * fl(1/127): ATen divides a CUDA tensor by a host scalar
//           as a product with the scalar's f32 reciprocal (one rounding
//           each), which can differ from amax / 127 in the last bit (the
//           CPU divides);
//   inv   = scale > 0 ? 1 / max(scale, 1e-30) : 0, a correctly rounded
//           reciprocal (__frcp_rn; torch computes 1.0 / t as reciprocal(t));
//   q     = clamp(rint(x * inv), -127, 127): one rounded product
//           (__fmul_rn, never contracted), round half to even.
// A NaN product (a NaN or infinite input) writes 0, as the plain chain's
// float -> int8 cast gives on the card.  No fast-math anywhere.
//
// What bounds it: bytes, at every shape the cells run (2 + 1 bytes an
// element of bf16 in and int8 out, a handful of operations).  At decode
// (32-64 rows of 960-2,560) the 60-330 KB are a few microseconds of launch
// and one round trip to memory, so the design is about latency: one read of
// x, all loads of a thread issued before any is used, the absmax reduced in
// registers, one write of q.
//
// - A row is split over 32 * W threads (W warps, 1 to 8), R rows a CTA
//   (R * W <= 8 warps).  Thread t of a row owns the 16-byte chunks t, t + 32W,
//   ... (8 bf16 or 4 f32 values each), V of them, held as raw bits in
//   registers: V * 4 registers whatever the dtype.  The host picks the
//   smallest W that keeps V <= 8, so a row is read by as few warps as fit
//   and the shuffle butterfly is the whole reduction where W = 1; W > 1 adds
//   one exchange through 8 floats of shared memory.
// - Rows wider than 32 * 8 * 8 chunks (16,384 bf16, 8,192 f32 values)
//   take the streaming instance (V = 0): the same loops with one chunk live
//   a thread, x read twice (the second time from L2).
// - The 16-byte path needs x, its row stride and q aligned (d_in and k_pad
//   multiples of the chunk's values); anything else takes the scalar
//   instance, which loads and stores element by element in the same order.
// - R = 1 while the grid would not fill the card twice over, so that decode
//   spreads its few rows over many SMs; prefill takes 8 / W rows a CTA.
// - Graph-safe: the launch reads no device state on the host, allocates
//   nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;      // bytes of x a thread loads at once
constexpr int kMaxWarps = 8;    // warps a CTA
constexpr int kMaxV = 8;        // chunks a thread holds in registers
constexpr int kSMs = 132;       // H100 SXM
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvQmax = 1.0f / 127.0f;  // rounded to f32, as ATen's host reciprocal

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max(m, |v|) that keeps a NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float m, float a) { return (a > m || a != a) ? a : m; }

// Chunk c of a row (values c * N .. c * N + N - 1), zero past d_in.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_chunk(const T* xr, int c, int d_in) {
  constexpr int N = kChunk / sizeof(T);
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kVec) {
    if (c * N < d_in) raw = __ldg(reinterpret_cast<const uint4*>(xr) + c);
  } else {
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c * N + i < d_in) v[i] = xr[c * N + i];
  }
  return raw;
}

template <typename T>
__device__ __forceinline__ float chunk_absmax(const uint4& raw, float m) {
  constexpr int N = kChunk / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) m = nan_max(m, fabsf(to_f32(v[i])));
  return m;
}

__device__ __forceinline__ int8_t quant(float x, float inv) {
  const float p = __fmul_rn(x, inv);
  if (p != p) return 0;
  return (int8_t)(int)fminf(fmaxf(rintf(p), -127.f), 127.f);
}

// Chunk c's N int8 values into the row qr (k_pad of them).
template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(const uint4& raw, float inv, int8_t* qr, int c,
                                            int k_pad) {
  constexpr int N = kChunk / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
  if constexpr (kVec) {
    uint32_t word[N / 4] = {};  // N int8 values, little-endian
#pragma unroll
    for (int i = 0; i < N; ++i)
      word[i / 4] |= (uint32_t)(uint8_t)quant(to_f32(v[i]), inv) << (8 * (i % 4));
    if constexpr (N == 8) {
      reinterpret_cast<uint2*>(qr)[c] = make_uint2(word[0], word[1]);
    } else {
      reinterpret_cast<uint32_t*>(qr)[c] = word[0];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c * N + i < k_pad) qr[c * N + i] = quant(to_f32(v[i]), inv);
  }
}

// One row per group of 32 * w threads; V chunks a thread in registers, or
// (V = 0) streamed twice.
template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(32 * kMaxWarps)
act_quant_rows_kernel(const T* __restrict__ x, long long ld, int rows, int d_in, int k_pad,
                      int w, int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int N = kChunk / sizeof(T);
  __shared__ float red[kMaxWarps];
  const int tpr = 32 * w;
  const int t = threadIdx.x % tpr;
  const long long r = (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = r < rows;
  const T* xr = x + (live ? r : 0) * ld;
  int8_t* qr = q + (live ? r : 0) * (long long)k_pad;
  const int n_in = (d_in + N - 1) / N;
  const int n_out = (k_pad + N - 1) / N;

  uint4 raw[V > 0 ? V : 1];
  float m = 0.f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      raw[j] = live ? load_chunk<T, kVec>(xr, t + j * tpr, d_in) : make_uint4(0u, 0u, 0u, 0u);
      m = chunk_absmax<T>(raw[j], m);
    }
  } else if (live) {
    for (int c = t; c < n_in; c += tpr) m = chunk_absmax<T>(load_chunk<T, kVec>(xr, c, d_in), m);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, o));
  if (w > 1) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) red[warp] = m;
    __syncthreads();
    const int first = warp - warp % w;
    for (int i = 0; i < w; ++i) m = nan_max(m, red[first + i]);
  }
  if (!live) return;

  const float s = __fmul_rn(m, kInvQmax);
  const float inv = s > 0.f ? __frcp_rn(fmaxf(s, 1e-30f)) : 0.f;
  if (t == 0) scale[r] = s;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = t + j * tpr;
      if (c < n_out) store_chunk<T, kVec>(raw[j], inv, qr, c, k_pad);
    }
  } else {
    for (int c = t; c < n_out; c += tpr)
      store_chunk<T, kVec>(load_chunk<T, kVec>(xr, c, d_in), inv, qr, c, k_pad);
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, long long ld, int rows, int d_in, int k_pad, int w, bool vec,
                   int8_t* q, float* scale, cudaStream_t s) {
  // R rows a CTA: one while fewer than two CTAs an SM would be launched
  int per_cta = kMaxWarps / w;
  if ((long long)rows < 2LL * kSMs * per_cta) per_cta = 1;
  const unsigned blocks = (unsigned)((rows + per_cta - 1) / per_cta);
  const unsigned threads = (unsigned)(32 * w * per_cta);
  const T* xp = static_cast<const T*>(x);
  if (vec)
    act_quant_rows_kernel<T, V, true><<<blocks, threads, 0, s>>>(xp, ld, rows, d_in, k_pad, w,
                                                                  q, scale);
  else
    act_quant_rows_kernel<T, V, false><<<blocks, threads, 0, s>>>(xp, ld, rows, d_in, k_pad, w,
                                                                   q, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, long long ld, int rows, int d_in, int k_pad, int8_t* q,
                     float* scale, cudaStream_t s) {
  constexpr int N = kChunk / sizeof(T);
  const int n_out = (k_pad + N - 1) / N;
  const bool vec = (uintptr_t)x % kChunk == 0 && (ld * (long long)sizeof(T)) % kChunk == 0 &&
                   d_in % N == 0 && k_pad % N == 0 && (uintptr_t)q % kChunk == 0;
  int w = 1;
  while (w < kMaxWarps && n_out > 32 * w * kMaxV) w *= 2;
  const int per = (n_out + 32 * w - 1) / (32 * w);
  if (per <= 1) return launch<T, 1>(x, ld, rows, d_in, k_pad, w, vec, q, scale, s);
  if (per <= 2) return launch<T, 2>(x, ld, rows, d_in, k_pad, w, vec, q, scale, s);
  if (per <= 4) return launch<T, 4>(x, ld, rows, d_in, k_pad, w, vec, q, scale, s);
  if (per <= kMaxV) return launch<T, kMaxV>(x, ld, rows, d_in, k_pad, w, vec, q, scale, s);
  return launch<T, 0>(x, ld, rows, d_in, k_pad, w, vec, q, scale, s);
}

}  // namespace

// x (rows, d_in) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), rows ld values
// apart; q (rows, k_pad) int8, zero past d_in; scale (rows) f32.
extern "C" int act_quant_rows_launch(const void* x, long long ld, int x_bf16, int rows,
                                     int d_in, int k_pad, int8_t* q, float* scale,
                                     void* stream) {
  if (rows <= 0) return 0;
  if (d_in < 0 || k_pad < d_in || k_pad < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) return (int)dispatch<__nv_bfloat16>(x, ld, rows, d_in, k_pad, q, scale, s);
  return (int)dispatch<float>(x, ld, rows, d_in, k_pad, q, scale, s);
}
