// Device-side closed-form inverse CDFs shared by the fused-step kernels.
//
// Each function evaluates exactly the float32 expression of the JAX
// reference (core/samplers.py, index_uniform / index_linear /
// index_exponential) in the same order, one correctly rounded operation
// at a time: __fmul_rn / __fadd_rn / __fsqrt_rn are never contracted into
// a fused multiply-add, so the picks are bit-identical to the plain
// PyTorch version and to the reference.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kBiasUniform = 0;
constexpr int kBiasLinear = 1;
constexpr float kExpExactMaxN = 80.0f;   // e^n fits float32 below ~88

// clip(i, 0, max(n - 1, 0))
__device__ __forceinline__ int clip_pick(int i, int n) {
  const int hi = n - 1 > 0 ? n - 1 : 0;
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// i = floor(u * n)
__device__ __forceinline__ int index_uniform(float u, int n) {
  const float nf = __int2float_rn(n);
  return clip_pick(static_cast<int>(floorf(__fmul_rn(u, nf))), n);
}

// i = floor((-1 + sqrt(1 + 4·u·n·(n+1))) / 2), then the one-step
// correction of samplers.index_linear.
__device__ __forceinline__ int index_linear(float u, int n) {
  const float nf = __int2float_rn(n);
  const float np1 = __fadd_rn(nf, 1.0f);
  const float q = __fmul_rn(__fmul_rn(__fmul_rn(4.0f, u), nf), np1);
  const float r = __fsqrt_rn(__fadd_rn(1.0f, q));
  int i = static_cast<int>(floorf(__fdiv_rn(__fadd_rn(-1.0f, r), 2.0f)));
  const float target = __fmul_rn(__fmul_rn(u, nf), np1);
  const float f = __int2float_rn(i);
  if (__fmul_rn(f, __fadd_rn(f, 1.0f)) >= target) i -= 1;
  const float f2 = __int2float_rn(i);
  if (__fmul_rn(__fadd_rn(f2, 1.0f), __fadd_rn(f2, 2.0f)) < target) i += 1;
  return clip_pick(i, n);
}

// exact: ceil(log(u·expm1(n) + 1)) − 1 for n <= 80, else the log-domain
// asymptotic ceil(n + log u) − 1.
__device__ __forceinline__ int index_exponential(float u, int n) {
  const float nf = __int2float_rn(n);
  const float uc = fminf(fmaxf(u, 1e-30f), 1.0f);
  const float exact =
      __fsub_rn(ceilf(logf(__fadd_rn(__fmul_rn(uc, expm1f(nf)), 1.0f))), 1.0f);
  const float asym = __fsub_rn(ceilf(__fadd_rn(nf, logf(uc))), 1.0f);
  return clip_pick(static_cast<int>(nf <= kExpExactMaxN ? exact : asym), n);
}

// samplers.index_pick_lanes: code 0 uniform, 1 linear, anything else exp.
__device__ __forceinline__ int index_pick(int code, float u, int n) {
  if (code == kBiasUniform) return index_uniform(u, n);
  if (code == kBiasLinear) return index_linear(u, n);
  return index_exponential(u, n);
}

// Weight-mode pick over positions [c, hi) of a node region, given the
// exclusive prefix rows pe / pl (pe[j] = P(j)) and the edge timestamps,
// all indexed in the same coordinates. Mirrors kernels/ref.py
// fused_step_ref: exponential counts P(j+1) < target, linear counts
// S(j) < u·total with S(j) = (PL(j+1) − PL(c)) − (j+1−c)·δ; both fall
// back to the uniform pick when the mass is not positive, and the result
// is clipped into [c, max(hi−1, c)]. With kSearchExp the exponential count
// is a lower-bound binary search, which equals the count whenever pe is
// non-decreasing (true of any prefix of non-negative weights built by
// this package's weight_prefix kernel). The linear S(j) is not provably
// monotone after float32 rounding, so its count stays a loop.
template <bool kSearchExp>
__device__ __forceinline__ int weight_pick(const float* pe, const float* pl,
                                           const int* ts, int c, int hi, int n,
                                           float u, int code, int tbase) {
  if (n <= 0) return c;   // masked by the caller
  const int fb = c + index_uniform(u, n);
  int k = fb;
  if (code == kBiasLinear) {
    const float delta = __int2float_rn(ts[c] - tbase);
    const float pl_c = pl[c];
    const float total =
        __fsub_rn(__fsub_rn(pl[hi], pl_c), __fmul_rn(__int2float_rn(n), delta));
    if (total > 0.0f) {
      const float r = __fmul_rn(u, total);
      int cnt = 0;
      for (int j = c; j < hi; ++j) {
        const float s = __fsub_rn(__fsub_rn(pl[j + 1], pl_c),
                                  __fmul_rn(__int2float_rn(j + 1 - c), delta));
        cnt += s < r;
      }
      k = c + cnt;
    }
  } else if (code != kBiasUniform) {
    const float pe_c = pe[c];
    const float total = __fsub_rn(pe[hi], pe_c);
    if (total > 0.0f) {
      const float target = __fadd_rn(pe_c, __fmul_rn(u, total));
      int cnt = 0;
      if (kSearchExp) {
        int lo = c, h = hi;
        while (lo < h) {
          const int mid = lo + ((h - lo) >> 1);
          if (pe[mid + 1] >= target) h = mid; else lo = mid + 1;
        }
        cnt = lo - c;
      } else {
        for (int j = c; j < hi; ++j) cnt += pe[j + 1] < target;
      }
      k = c + cnt;
    }
  }
  const int kmax = hi - 1 > c ? hi - 1 : c;
  return k < c ? c : (k > kmax ? kmax : k);
}

// First position in [lo, hi) whose timestamp is > t (hi if none): the
// temporal cutoff. Timestamps are ascending inside a node region, so this
// equals lo + #{ts <= t} over the region, the reference's dense count.
__device__ __forceinline__ int upper_bound(const int* ts, int lo, int hi,
                                           int t) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ts[mid] > t) hi = mid; else lo = mid + 1;
  }
  return lo;
}

}  // namespace repro
