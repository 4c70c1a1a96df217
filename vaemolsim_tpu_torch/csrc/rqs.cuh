// Monotone rational-quadratic spline of one scalar against one row of
// bin parameters: the device bodies shared by the RQS kernel (rqs.cu),
// the whole-proposal kernel (vae_proposal.cu) and, for rqs_apply, the
// MAF-block kernel (maf_block.cu).
//
// Semantics are those of vaemolsim_tpu/ops/rqs.py (Durkan et al. 2019):
// widths w and heights h (K each) start at range_min, the K-1 interior
// knot slopes s sit between boundary slopes of 1, and outside
// [range_min, range_min + sum] the map is the identity with log-det 0.
// Knots are range_min + running sum, compared with the input itself, as
// the XLA path does (ops/rqs.py:43-65).
#pragma once

#include <cuda_runtime.h>

// The rational-quadratic map of v inside its bin: lower knot (xk, yk),
// width wk, height hk, knot slopes dk (left) and dk1 (right); identity
// with log-det 0 outside [range_min, total] (total: the last knot of
// the input's axis).
template <bool kInverse>
__device__ __forceinline__ void rqs_apply(float v, float xk, float yk,
                                          float wk, float hk, float dk,
                                          float dk1, float range_min,
                                          float total, float& out,
                                          float& ldj) {
  const bool inside = v >= range_min && v <= total;
  const float sl = hk / wk;
  float res, lg;
  if (!kInverse) {
    const float xi = (v - xk) / wk;
    const float xi1m = 1.f - xi;
    const float num = hk * (sl * xi * xi + dk * xi * xi1m);
    const float den = sl + (dk1 + dk - 2.f * sl) * xi * xi1m;
    res = yk + num / den;
    const float deriv = (sl * sl) *
                        (dk1 * xi * xi + 2.f * sl * xi * xi1m +
                         dk * xi1m * xi1m) /
                        (den * den);
    lg = logf(deriv);
  } else {
    const float t = v - yk;
    const float dsum = dk1 + dk - 2.f * sl;
    const float a = hk * (sl - dk) + t * dsum;
    const float b = hk * dk - t * dsum;
    const float c = -sl * t;
    const float disc = fmaxf(b * b - 4.f * a * c, 0.f);
    // Stable root in [0, 1]: xi = 2c / (-b - sqrt(b^2 - 4ac)).
    float xi = (2.f * c) / (-b - sqrtf(disc));
    xi = fminf(fmaxf(xi, 0.f), 1.f);
    res = xk + xi * wk;
    const float xi1m = 1.f - xi;
    const float den = sl + dsum * xi * xi1m;
    const float deriv = (sl * sl) *
                        (dk1 * xi * xi + 2.f * sl * xi * xi1m +
                         dk * xi1m * xi1m) /
                        (den * den);
    lg = -logf(deriv);
  }
  out = inside ? res : v;
  ldj = inside ? lg : 0.f;
}

template <bool kInverse>
__device__ __forceinline__ void rqs_eval(float v, const float* __restrict__ w,
                                         const float* __restrict__ h,
                                         const float* __restrict__ s, int K,
                                         float range_min, float& out,
                                         float& ldj) {
  // One walk over the bins with the running knot sums in registers; the
  // bin holding v is the last one whose lower knot is <= v.  (The TPU
  // kernel's triangular matmul and one-hot selects, rqs_pallas.py:60-102,
  // were workarounds for the missing cumsum and gather on that core.)
  float cw = 0.f, ch = 0.f;
  float xk = range_min, yk = range_min;
  float wk = w[0], hk = h[0];
  float dk = 1.f, dk1 = K > 1 ? s[0] : 1.f;
  for (int k = 1; k < K; ++k) {
    cw += w[k - 1];
    ch += h[k - 1];
    const float kx = range_min + cw, ky = range_min + ch;
    if (v >= (kInverse ? ky : kx)) {
      xk = kx;
      yk = ky;
      wk = w[k];
      hk = h[k];
      dk = s[k - 1];
      dk1 = k < K - 1 ? s[k] : 1.f;
    }
  }
  const float total =
      range_min + (kInverse ? ch + h[K - 1] : cw + w[K - 1]);
  rqs_apply<kInverse>(v, xk, yk, wk, hk, dk, dk1, range_min, total, out,
                      ldj);
}

// A knot table: one row's knots and bin records, built once and then
// searched by every input that uses the row (the broadcast row of
// rqs.cu, the prior's blocks in vae_proposal.cu).  Floats, from a
// 16-byte aligned base:
//   [0, kp)           x-knots kx[0..K]: kx[0] = range_min, kx[k] =
//                     range_min + (w[0] + ... + w[k-1]) added left to
//                     right as rqs_eval adds them, kx[K] the upper edge
//                     (rqs_eval's `total`);
//   [kp, 2 kp)        the y-knots, the same over h;
//   [2 kp, 2 kp + 8K) bin k: (xk, yk, wk, hk, dk, dk1, 0, 0), two float4.
// kp is K + 1 rounded up to a multiple of 4.
__host__ __device__ inline int rqs_knot_stride(int K) { return (K + 4) & ~3; }
__host__ __device__ inline int rqs_table_floats(int K) {
  return 2 * rqs_knot_stride(K) + 8 * K;
}

// Knot k (0..K) of a table and, for k < K, bin record k, from the row
// (w, h, s) staged in shared memory.  Each knot is one thread's own
// left-to-right sum, so the K + 1 knots of a row come from K + 1
// threads at once and each equals rqs_eval's running sum bit for bit (a
// scan would reorder the adds).
__device__ inline void rqs_table_knot(const float* __restrict__ w,
                                      const float* __restrict__ h,
                                      const float* __restrict__ s, int K,
                                      float range_min, int k,
                                      float* __restrict__ tab) {
  const int kp = rqs_knot_stride(K);
  float cw = 0.f, ch = 0.f;
#pragma unroll 8
  for (int j = 0; j < k; ++j) {
    cw += w[j];
    ch += h[j];
  }
  const float xk = k == 0 ? range_min : range_min + cw;
  const float yk = k == 0 ? range_min : range_min + ch;
  tab[k] = xk;
  tab[kp + k] = yk;
  if (k < K) {
    float4* bin = reinterpret_cast<float4*>(tab + 2 * kp) + 2 * k;
    bin[0] = make_float4(xk, yk, w[k], h[k]);
    bin[1] = make_float4(k > 0 ? s[k - 1] : 1.f, k < K - 1 ? s[k] : 1.f, 0.f,
                         0.f);
  }
}

// The bin of v on one knot axis: how many interior knots knots[1..K-1]
// are <= v.  Knots are running sums of non-negative widths, so they do
// not decrease, and that count is the last k whose knot is <= v: the
// bin rqs_eval's walk takes, the last of a run of equal knots, and 0 for
// NaN (every comparison false).  A branchless binary search of
// floor(log2(K-1)) + 1 steps.
__device__ __forceinline__ int rqs_bin(const float* knots, int K, float v) {
  int k = 0;
  for (int step = K > 1 ? 1 << (31 - __clz(K - 1)) : 0; step > 0;
       step >>= 1)
    if (k + step < K && knots[k + step] <= v) k += step;
  return k;
}

// rqs_eval against a knot table: the same bin, the same knots, the same
// upper edge, so the same result.
template <bool kInverse>
__device__ __forceinline__ void rqs_eval_table(float v,
                                               const float* __restrict__ tab,
                                               int K, float range_min,
                                               float& out, float& ldj) {
  const int kp = rqs_knot_stride(K);
  const float* knots = tab + (kInverse ? kp : 0);
  const float4* bin =
      reinterpret_cast<const float4*>(tab + 2 * kp) + 2 * rqs_bin(knots, K, v);
  const float4 a = bin[0], b = bin[1];
  rqs_apply<kInverse>(v, a.x, a.y, a.z, a.w, b.x, b.y, range_min, knots[K],
                      out, ldj);
}
