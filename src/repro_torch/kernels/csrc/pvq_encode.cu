// Batched PVQ projection onto the pyramid P(n, K), one CTA per group row.
//
// Replaces: src/repro/kernels/pvq_encode.py:_kernel (pvq_encode_batch), with
// the bulk mask of _bulk_mask_bisect (32 bisection rounds over the IEEE bit
// patterns of the fractional parts, then an equal-rank prefix count; no sort).
//
// What bounds it: neither bytes nor arithmetic.  The work per row is a chain
// of block-wide reductions (3 float sums, 32 + 1 integer counts, one prefix
// scan, then up to delta_max argmax reductions), so the time is the latency
// of ~70 __syncthreads-separated steps per row.  The design keeps one row per
// CTA with one thread per lane (n <= 1024), so rows run in parallel across
// the SMs and every reduction stays in shared memory; the weight is read once
// and the pulses written once.
//
// Numerics: every float sum is the same fixed pairwise tree that the plain
// PyTorch version (repro_torch.core.pvq.tree_sum) computes with elementwise
// adds, and this file is built with -fmad=false, so pulses and rho match the
// plain version bit for bit.  Ties in the greedy argmax go to the lower lane.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Pairwise tree over P lanes (P = blockDim.x, a power of two): lane i adds
// lane i + h for h = P/2 .. 1.  Lanes >= n hold 0.
__device__ float tree_sum(float v, float* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int h = blockDim.x / 2; h >= 1; h >>= 1) {
    if (tid < h) sh[tid] = sh[tid] + sh[tid + h];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

__global__ void pvq_encode_kernel(const float* __restrict__ w, int n, int K,
                                  int delta_max, int* __restrict__ pulses,
                                  float* __restrict__ rho) {
  extern __shared__ float smem[];
  float* shf = smem;                               // P floats
  int* shi = reinterpret_cast<int*>(smem + blockDim.x);  // P ints
  __shared__ float bcast[2];

  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const size_t row = blockIdx.x;
  const bool lane = tid < n;

  const float wv = lane ? w[row * n + tid] : 0.f;
  const float absw = fabsf(wv);

  // ---- floor allocation
  const float l1 = tree_sum(absw, shf);
  const float safe = l1 > 0.f ? l1 : 1.f;
  const float target = absw * ((float)K / safe);
  float y = l1 > 0.f ? floorf(target) : 0.f;
  const int remaining0 = K - (int)tree_sum(y, shf);
  const int bulk = max(remaining0 - delta_max, 0);

  // ---- largest-remainder bulk allocation by bisection over bit patterns
  const float frac = target - y;
  const int fb = __float_as_int(frac);
  int lo = -1, hi = 0x7F7FFFFF;
  for (int it = 0; it < 32; ++it) {
    const int mid = lo + (hi - lo) / 2;  // hi - lo >= 0: division floors
    const int cnt = __syncthreads_count(lane && fb > mid);
    if (cnt <= bulk) hi = mid; else lo = mid;
  }
  const bool gt = lane && fb > hi;
  const int extra = bulk - __syncthreads_count(gt);
  const bool eq = lane && fb == hi;
  shi[tid] = eq ? 1 : 0;  // inclusive prefix count of eq (Hillis-Steele)
  __syncthreads();
  for (int off = 1; off < P; off <<= 1) {
    const int v = tid >= off ? shi[tid - off] : 0;
    __syncthreads();
    shi[tid] += v;
    __syncthreads();
  }
  const int eq_rank = shi[tid];
  __syncthreads();
  if (l1 > 0.f && (gt || (eq && eq_rank <= extra))) y += 1.f;

  // ---- bounded exact greedy correction
  float corr = tree_sum(absw * y, shf);
  float energy = tree_sum(y * y, shf);
  int rem = min(K - (int)tree_sum(y, shf), delta_max);
  const int steps = min(delta_max, K);
  for (int it = 0; it < steps && rem > 0; ++it) {  // rem is block-uniform
    const float c = corr + absw;
    const float num = c * c;
    const float den = energy + 2.f * y + 1.f;
    shf[tid] = lane ? num / den : -INFINITY;
    shi[tid] = tid;
    __syncthreads();
    for (int h = P / 2; h >= 1; h >>= 1) {
      if (tid < h) {
        const float a = shf[tid], b = shf[tid + h];
        const int ib = shi[tid + h];
        if (b > a || (b == a && ib < shi[tid])) {
          shf[tid] = b;
          shi[tid] = ib;
        }
      }
      __syncthreads();
    }
    const int j = shi[0];
    __syncthreads();
    if (tid == j) {
      y += 1.f;
      bcast[0] = absw;
      bcast[1] = y;
    }
    __syncthreads();
    corr = corr + bcast[0];
    energy = energy + (2.f * bcast[1] - 1.f);
    rem -= 1;
    __syncthreads();
  }

  // ---- sign and least-squares rho
  const float sgn = wv > 0.f ? 1.f : (wv < 0.f ? -1.f : 0.f);
  const float pv = sgn * y;
  if (lane) pulses[row * n + tid] = (int)pv;
  const float yn2 = tree_sum(pv * pv, shf);
  const float dot = tree_sum(wv * pv, shf);
  if (tid == 0) {
    const float r = dot / (yn2 > 0.f ? yn2 : 1.f);
    rho[row] = yn2 > 0.f ? fmaxf(r, 0.f) : 0.f;
  }
}

}  // namespace

extern "C" int pvq_encode_launch(const float* w, int g, int n, int k,
                                 int delta_max, int* pulses, float* rho,
                                 void* stream) {
  if (g <= 0) return 0;
  if (n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  int P = 32;
  while (P < n) P <<= 1;
  pvq_encode_kernel<<<g, P, 2 * P * sizeof(float), (cudaStream_t)stream>>>(
      w, n, k, delta_max, pulses, rho);
  return (int)cudaGetLastError();
}
