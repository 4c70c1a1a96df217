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
//
// A member axis (M splines of one shape, each with its own parameters,
// in one launch: the counterpart of fit_ensemble's vmap over the Pallas
// kernel) puts the members' elements and rows one after another: member
// m's n elements read member m's p_rows rows.  With one broadcast row a
// member, the grid's y dimension is the member (block y stages row y);
// the walk folds the members into its elements (element i of member m
// reads row m * p_rows + i % p_rows, which for a row per element is the
// element's own).
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
  // Member blockIdx.y: its elements and its row.
  const long long m = blockIdx.y;
  x += m * n;
  y += m * n;
  ldj += m * n;
  w += m * K;
  h += m * K;
  s += m * (K - 1);
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
               long long total, int K, long long p_rows, float range_min) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const long long m = i / n;  // the member: n elements, p_rows rows each
  const long long r = m * p_rows + (i - m * n) % p_rows;
  rqs_eval<kInverse>(x[i], w + r * K, h + r * K, s + r * (K - 1), K,
                     range_min, y[i], ldj[i]);
}

}  // namespace

// x, y, ldj: members x n floats.  w, h: (members x p_rows, K); s:
// (members x p_rows, K-1); element i of member m uses parameter row
// m * p_rows + i % p_rows.  The launch plan (threads a block, blocks,
// dynamic shared bytes) comes from ops/rqs.py `kernel_plan`; it is only
// checked here: threads a multiple of 32 in [32, 256], a thread an
// element; the shared bytes the row's table needs with one row and a
// table (smem > 0; blocks over one member's n, members in grid y, at
// most 65535), 0 for the walk (blocks over all members x n).
extern "C" int rqs_members_launch(const float* x, const float* w,
                                  const float* h, const float* s, float* y,
                                  float* ldj, long long n, int K,
                                  long long p_rows, float range_min,
                                  int inverse, int threads, long long blocks,
                                  long long smem, int members,
                                  cudaStream_t stream) {
  const bool row = p_rows == 1 && smem != 0;
  const size_t want_smem = row ? row_smem(K) : 0;
  const long long total = n * members;
  const long long elems = row ? n : total;
  if (K < 1 || p_rows < 1 || members < 1 || (row && members > 65535) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      blocks != (elems + threads - 1) / threads ||
      smem != static_cast<long long>(want_smem) ||
      want_smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (row) {
    const dim3 grid(nb, members);
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
    rqs_kernel<true><<<nb, threads, 0, stream>>>(x, w, h, s, y, ldj, n,
                                                 total, K, p_rows, range_min);
  } else {
    rqs_kernel<false><<<nb, threads, 0, stream>>>(x, w, h, s, y, ldj, n,
                                                  total, K, p_rows, range_min);
  }
  return static_cast<int>(cudaGetLastError());
}
