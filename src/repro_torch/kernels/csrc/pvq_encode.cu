// Batched PVQ projection onto the pyramid P(n, K): one warp per group row.
//
// Replaces: src/repro/kernels/pvq_encode.py:_kernel (pvq_encode_batch), with
// the bulk mask of _bulk_mask_bisect (32 bisection rounds over the IEEE bit
// patterns of the fractional parts, then an equal-rank prefix count; no sort).
// Bit-identical to the plain version, pvq_encode.pvq_encode_batch_plain
// (core/pvq.py: pvq_quantize_direction_fast, then _scales(..., "ls")).
//
// What bounds it: instruction issue.  A row's bytes are tiny (n floats in, n
// ints and one float out) and its arithmetic is a short list per column, but
// every step of a row is a reduction over the row: 7 float sums, 32 + 1
// integer counts, the equal-rank prefix count, then up to delta_max greedy
// argmax steps, each one division per column and an argmax.  So the design
// keeps a row inside one warp and every reduction in registers:
//
// - One warp per group row, kWarps rows per CTA, no shared memory and no
//   __syncthreads on a row's path; a warp past the last row leaves at once.
//   Lane l holds columns l + 32 i, i < S = P / 32, in registers (P = the
//   next power of two >= max(n, 32); one template instance per S in 1, 2, 4,
//   8, 16, 32, so n runs from 1 to 1024).  Columns >= n are pad: weight 0,
//   pulses 0, fractional pattern kPad, never a greedy candidate.
// - Float sums (row_sum) take core/pvq.py:tree_sum's order: zero-pad to P,
//   then add the upper half onto the lower half.  The levels of width >= 32
//   pair slot i with slot i + h / 32 of the same lane, in registers; the last
//   five pair lane l with lane l ^ h through __shfl_xor_sync.  Lane 0 then
//   holds exactly the plain tree's sum, and every other lane the same value:
//   at each level both lanes of a pair add the same two floats (a + b == b + a
//   in IEEE arithmetic), so the butterfly is the tree, already broadcast.
//   Pad slots add exact zeros, and every summand here is +0 or positive, so
//   the extra levels of a P > n tree (P >= 32 > n) change no sum.  The file
//   is built with -fmad=false (kernels/build.py): no multiply and add are
//   contracted into an FMA, so each float operation rounds as the plain
//   version's elementwise ops do; the division stays correctly rounded.
// - Bisection: a round's count is a warp sum (__reduce_add_sync) of each
//   lane's count over its slots: integers, so any order is exact.  The rounds
//   are skipped when bulk == 0 (warp-uniform: it comes from a butterfly sum).
//   Proof that the skip is exact: with r = bulk = 0, hi moves (to mid) only
//   in a round where no pattern exceeds mid, so after the rounds either hi is
//   still kTop, or no pattern exceeds hi and then none exceeds kTop >= hi
//   either; both ways gt = {fb > hi} = {fb > kTop}.  Then extra = 0 - |gt|
//   <= 0 while every equal-rank is >= 1, so the mask is gt alone: what the
//   rest of the code computes from hi = kTop without the rounds.  (For
//   finite weights gt is empty: a fractional part is < 1.)
// - Equal-ranks in column order from ballots: slot i's equal columns come
//   after those of slots < i, so a column's inclusive rank is the popcounts
//   of the lower slots' ballots plus __popc(ballot_i & lanemask_le).
// - Greedy steps: each lane takes the argmax of its own slots in ascending
//   column order with a strict >, comparing the scores' bit patterns as ints
//   (a score num / den is +0 or positive, and such floats order like their
//   patterns); __reduce_max_sync gives the top pattern and __reduce_min_sync
//   the lowest column holding it, so ties go to the lower column, as
//   torch.argmax does.  The winner lane bumps its y; corr and energy take the
//   winner's |w| and new y from two shuffles, in the plain order.
// - Graph-safe: the launch reads no device state on the host, allocates
//   nothing and does not synchronise.
//
// An SM holds as many rows at once as its registers hold warps, up to 64
// (the block-per-row body it replaces held 8 at n 256 and 32 at n <= 64).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // group rows per CTA, one warp each
constexpr int kTop = 0x7F7FFFFF;   // the bisection's upper end (FLT_MAX's pattern)
constexpr int kPad = INT_MIN;      // a pad column's pattern: never > mid >= -1, never == hi

// Slot i += slot i + H, for H = H0, H0 / 2, .. 1: the tree's levels >= 32.
template <int H, int S>
__device__ __forceinline__ void fold_slots(float (&t)[S]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int i = 0; i < H; ++i) t[i] = t[i] + t[i + H];
    fold_slots<H / 2>(t);
  }
}

// The plain pairwise tree sum of f(i) over the row's slots, in every lane.
template <int S, class F>
__device__ __forceinline__ float row_sum(F f) {
  float t[S];
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = f(i);
  fold_slots<S / 2>(t);
  float s = t[0];
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) s = s + __shfl_xor_sync(kFull, s, h);
  return s;
}

template <int S>
__global__ void __launch_bounds__(32 * kWarps)
pvq_encode_warp(const float* __restrict__ w, int g, int n, int K, int delta_max,
                int* __restrict__ pulses, float* __restrict__ rho) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= g) return;  // the whole warp leaves
  const float* wr = w + (size_t)row * n;

  float wv[S], y[S];
#pragma unroll
  for (int i = 0; i < S; ++i) wv[i] = lane + 32 * i < n ? wr[lane + 32 * i] : 0.f;

  // ---- floor allocation
  const float l1 = row_sum<S>([&](int i) { return fabsf(wv[i]); });
  const float kq = (float)K / (l1 > 0.f ? l1 : 1.f);
  int fb[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float target = fabsf(wv[i]) * kq;
    const bool live = lane + 32 * i < n;
    y[i] = live && l1 > 0.f ? floorf(target) : 0.f;
    fb[i] = live ? __float_as_int(target - y[i]) : kPad;
  }
  const int bulk = max(K - (int)row_sum<S>([&](int i) { return y[i]; }) - delta_max, 0);

  // ---- largest-remainder bulk allocation: bisection over bit patterns
  int hi = kTop;
  if (bulk > 0) {
    int lo = -1;
    for (int it = 0; it < 32; ++it) {
      const int mid = lo + (hi - lo) / 2;  // hi - lo >= 0: the division floors
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < S; ++i) cnt += fb[i] > mid;
      if (__reduce_add_sync(kFull, cnt) <= bulk) hi = mid; else lo = mid;
    }
  }
  int ngt = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) ngt += fb[i] > hi;
  const int extra = bulk - __reduce_add_sync(kFull, ngt);
  const unsigned le = (2u << lane) - 1u;  // lanes <= this one (lane 31: all)
  int below = 0;                          // equal columns in the lower slots
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const unsigned eq = __ballot_sync(kFull, fb[i] == hi);
    const bool bump = fb[i] > hi || (fb[i] == hi && below + __popc(eq & le) <= extra);
    below += __popc(eq);
    if (l1 > 0.f && bump) y[i] = y[i] + 1.f;
  }

  // ---- bounded exact greedy correction
  float corr = row_sum<S>([&](int i) { return fabsf(wv[i]) * y[i]; });
  float energy = row_sum<S>([&](int i) { return y[i] * y[i]; });
  int rem = min(K - (int)row_sum<S>([&](int i) { return y[i]; }), delta_max);
  const int steps = min(delta_max, K);
  for (int it = 0; it < steps && rem > 0; ++it, --rem) {  // rem is warp-uniform
    int best = -1, col = INT_MAX;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float c = corr + fabsf(wv[i]);
      const float num = c * c;
      const float den = energy + 2.f * y[i] + 1.f;
      const int score = __float_as_int(num / den);
      if (lane + 32 * i < n && score > best) {
        best = score;
        col = lane + 32 * i;
      }
    }
    const int top = __reduce_max_sync(kFull, best);
    const int j = __reduce_min_sync(kFull, best == top ? col : INT_MAX);
    float aj = 0.f, yj = 0.f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (lane + 32 * i == j) {
        y[i] = y[i] + 1.f;
        aj = fabsf(wv[i]);
        yj = y[i];
      }
    }
    aj = __shfl_sync(kFull, aj, j & 31);
    yj = __shfl_sync(kFull, yj, j & 31);
    corr = corr + aj;
    energy = energy + (2.f * yj - 1.f);
  }

  // ---- sign and least-squares rho
  float pv[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float sgn = wv[i] > 0.f ? 1.f : (wv[i] < 0.f ? -1.f : 0.f);
    pv[i] = sgn * y[i];
    if (lane + 32 * i < n) pulses[(size_t)row * n + lane + 32 * i] = (int)pv[i];
  }
  const float yn2 = row_sum<S>([&](int i) { return pv[i] * pv[i]; });
  const float dot = row_sum<S>([&](int i) { return wv[i] * pv[i]; });
  if (lane == 0) {
    const float r = dot / (yn2 > 0.f ? yn2 : 1.f);
    rho[row] = yn2 > 0.f ? fmaxf(r, 0.f) : 0.f;
  }
}

template <int S>
cudaError_t launch(const float* w, int g, int n, int k, int delta_max, int* pulses,
                   float* rho, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((g + kWarps - 1) / kWarps);
  pvq_encode_warp<S><<<blocks, 32 * kWarps, 0, stream>>>(w, g, n, k, delta_max, pulses, rho);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pvq_encode_launch(const float* w, int g, int n, int k, int delta_max,
                                 int* pulses, float* rho, void* stream) {
  if (g <= 0) return 0;
  if (n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 32) return (int)launch<1>(w, g, n, k, delta_max, pulses, rho, s);
  if (n <= 64) return (int)launch<2>(w, g, n, k, delta_max, pulses, rho, s);
  if (n <= 128) return (int)launch<4>(w, g, n, k, delta_max, pulses, rho, s);
  if (n <= 256) return (int)launch<8>(w, g, n, k, delta_max, pulses, rho, s);
  if (n <= 512) return (int)launch<16>(w, g, n, k, delta_max, pulses, rho, s);
  return (int)launch<32>(w, g, n, k, delta_max, pulses, rho, s);
}
