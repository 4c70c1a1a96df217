// Monotone rational-quadratic spline of one scalar against one row of
// bin parameters: the device body shared by the RQS kernel (rqs.cu) and
// the whole-proposal kernel (vae_proposal.cu).
//
// Semantics are those of vaemolsim_tpu/ops/rqs.py (Durkan et al. 2019):
// widths w and heights h (K each) start at range_min, the K-1 interior
// knot slopes s sit between boundary slopes of 1, and outside
// [range_min, range_min + sum] the map is the identity with log-det 0.
// Knots are range_min + running sum, compared with the input itself, as
// the XLA path does (ops/rqs.py:43-65).
#pragma once

#include <cuda_runtime.h>

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
