// RQS spline kernel: y, log|dy/dx| (or the inverse) for N scalars.
//
// Replaces vaemolsim_tpu/ops/rqs_pallas.py `_rqs_kernel` (reached from
// rqs_forward_pallas / rqs_inverse_pallas).
//
// Bound on the H100: memory.  Per element it reads one scalar and, with
// per-element parameters, a row of 3K-1 floats, and does O(K) flops, so
// it sits far below the card's ops-per-byte line.  Design: one thread
// per element walks the K bins once with the knot sums in registers
// (no cumsum matmul, no one-hot selects); parameters are read with a row
// period, so the constant-spline tables (one row, period 1) serve every
// element from L1 instead of being expanded to (N, K) copies as the TPU
// wrapper did; the ragged edge is masked, not padded.
#include "common.cuh"
#include "rqs.cuh"

template <bool kInverse>
__global__ void rqs_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ h,
                           const float* __restrict__ s, float* __restrict__ y,
                           float* __restrict__ ldj, long long n, int K,
                           long long p_rows, float range_min) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long r = p_rows == 1 ? 0 : i % p_rows;
  rqs_eval<kInverse>(x[i], w + r * K, h + r * K, s + r * (K - 1), K,
                     range_min, y[i], ldj[i]);
}

// x, y, ldj: n floats.  w, h: (p_rows, K); s: (p_rows, K-1); element i
// uses parameter row i % p_rows.
extern "C" int rqs_launch(const float* x, const float* w, const float* h,
                          const float* s, float* y, float* ldj, long long n,
                          int K, long long p_rows, float range_min,
                          int inverse, cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (inverse)
    rqs_kernel<true><<<blocks, kThreads, 0, stream>>>(x, w, h, s, y, ldj, n,
                                                      K, p_rows, range_min);
  else
    rqs_kernel<false><<<blocks, kThreads, 0, stream>>>(x, w, h, s, y, ldj, n,
                                                       K, p_rows, range_min);
  return static_cast<int>(cudaGetLastError());
}
