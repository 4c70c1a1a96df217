// RQS spline kernel: y, log|dy/dx| (or the inverse) for N scalars.
//
// Replaces vaemolsim_tpu/ops/rqs_pallas.py `_rqs_kernel` (reached from
// rqs_forward_pallas / rqs_inverse_pallas).
//
// Bound on the H100: memory by count (one scalar in, two out, O(K)
// flops), but at the main path's sizes (one broadcast row, N = 10k-50k:
// under a microsecond of traffic) the time is one thread's latency
// chain plus the launch.  Two kernels, by the parameters' layout:
// - One broadcast row whose table fits shared memory (p_rows == 1, smem
//   given; the constant-spline prior): each
//   block stages the row into shared memory and builds its knot table
//   there, thread k summing knot k left to right as rqs_eval does
//   (rqs.cuh); each thread then finds its element's bin by binary
//   search (about log2 K dependent shared loads instead of a K-step
//   walk) and applies the unchanged rqs_apply.  The input load is issued
//   before the table is built, so its latency overlaps it.  A thread an
//   element: runs of 2 or 4 elements a thread with 8- and 16-byte loads
//   were slower on the H100 at 10k and 50k.  Threads a block are the
//   plan's (ops/rqs.py `kernel_plan`).
// - A row per element (p_rows > 1), or one broadcast row of more bins
//   than a table in shared memory holds (K > 4469, no smem given): one
//   thread per element walks its row with the knot sums in registers
//   (rqs_eval); element i reads row i % p_rows; the ragged edge is
//   masked, not padded.
#include "common.cuh"
#include "rqs.cuh"

namespace {

constexpr int kMaxThreads = 256;

// Shared bytes of the broadcast kernel: the knot table and the row.
inline size_t row_smem(int K) {
  return sizeof(float) * static_cast<size_t>(rqs_table_floats(K) + 3 * K);
}

template <bool kInverse>
__global__ void __launch_bounds__(kMaxThreads)
    rqs_row_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ h, const float* __restrict__ s,
                   float* __restrict__ y, float* __restrict__ ldj,
                   long long n, int K, float range_min) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  float* raw = tab + rqs_table_floats(K);  // w (K), h (K), s (K-1)
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const float v = i < n ? x[i] : 0.f;
  for (int t = threadIdx.x; t < 3 * K - 1; t += blockDim.x)
    raw[t] = t < K ? w[t] : t < 2 * K ? h[t - K] : s[t - 2 * K];
  __syncthreads();
  for (int k = threadIdx.x; k <= K; k += blockDim.x)
    rqs_table_knot(raw, raw + K, raw + 2 * K, K, range_min, k, tab);
  __syncthreads();
  if (i < n) rqs_eval_table<kInverse>(v, tab, K, range_min, y[i], ldj[i]);
}

template <bool kInverse>
__global__ void __launch_bounds__(kMaxThreads)
    rqs_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ h, const float* __restrict__ s,
               float* __restrict__ y, float* __restrict__ ldj, long long n,
               int K, long long p_rows, float range_min) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long r = i % p_rows;
  rqs_eval<kInverse>(x[i], w + r * K, h + r * K, s + r * (K - 1), K,
                     range_min, y[i], ldj[i]);
}

}  // namespace

// x, y, ldj: n floats.  w, h: (p_rows, K); s: (p_rows, K-1); element i
// uses parameter row i % p_rows.  The launch plan (threads a block,
// blocks, dynamic shared bytes) comes from ops/rqs.py `kernel_plan`; it
// is only checked here: threads a multiple of 32 in [32, 256], a thread
// an element; the shared bytes the row's table needs with one row and a
// table (smem > 0), 0 for the walk.
extern "C" int rqs_launch(const float* x, const float* w, const float* h,
                          const float* s, float* y, float* ldj, long long n,
                          int K, long long p_rows, float range_min,
                          int inverse, int threads, long long blocks,
                          long long smem, cudaStream_t stream) {
  const bool row = p_rows == 1 && smem != 0;
  const size_t want_smem = row ? row_smem(K) : 0;
  if (K < 1 || p_rows < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks != (n + threads - 1) / threads ||
      smem != static_cast<long long>(want_smem) ||
      want_smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (row) {
    cudaError_t err = inverse ? allow_smem(rqs_row_kernel<true>, want_smem)
                              : allow_smem(rqs_row_kernel<false>, want_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (inverse)
      rqs_row_kernel<true><<<grid, threads, want_smem, stream>>>(
          x, w, h, s, y, ldj, n, K, range_min);
    else
      rqs_row_kernel<false><<<grid, threads, want_smem, stream>>>(
          x, w, h, s, y, ldj, n, K, range_min);
  } else if (inverse) {
    rqs_kernel<true><<<grid, threads, 0, stream>>>(x, w, h, s, y, ldj, n, K,
                                                   p_rows, range_min);
  } else {
    rqs_kernel<false><<<grid, threads, 0, stream>>>(x, w, h, s, y, ldj, n,
                                                    K, p_rows, range_min);
  }
  return static_cast<int>(cudaGetLastError());
}
