// Dense-stack kernel: a whole MLP, h = act(h @ W_i + b_i (+ c @ C_i)),
// with every intermediate kept on chip.
//
// Replaces vaemolsim_tpu/ops/fused_mlp.py `_stack_kernel` (reached from
// fused_dense_stack).
//
// Bound on the H100: at the flagship's shapes (2->200->2, 1->200->4,
// and the one-row conditioner 1->600->95) the contractions are 1 to 600
// deep and the head widths 2 to 95, far too thin for tensor cores, and
// the unfused stack's cost is moving each (rows, hidden) intermediate
// through device memory.  Design: one block owns ROWS rows; the current
// activation tile sits in shared memory, double-buffered across layers
// and sized from the widest layer at launch (dynamic shared memory,
// above 48 KB through cudaFuncSetAttribute); each thread accumulates
// RPT rows of one output column in FP32 FMA, so every weight it reads
// through the read-only cache serves RPT rows.  No TF32: the products
// are f32 throughout, like the JAX kernel's.  Only the input and output
// tiles touch device memory.
#include "common.cuh"

namespace {

constexpr int kRows = 32;     // rows per block
constexpr int kRpt = 4;       // rows accumulated by one thread
constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;

enum Act { kLinear = 0, kTanh = 1, kRelu = 2 };

struct Stack {
  const float* W[kMaxLayers];  // (dims[l], dims[l+1]) row-major
  const float* b[kMaxLayers];  // (dims[l+1],)
  const float* C[kMaxLayers];  // (dc, dims[l+1]) or null
  int dims[kMaxLayers + 1];
  int act[kMaxLayers];
  int n_layers;
  int dc;  // conditional input width, 0 without one
  int ld;  // shared-memory row stride: widest layer, rounded up to odd
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kTanh) return tanhf(v);
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    dense_stack_kernel(const float* __restrict__ x,
                       const float* __restrict__ c, float* __restrict__ out,
                       long long n, Stack p) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + kRows * p.ld;
  float* ctile = smem + 2 * kRows * p.ld;
  const long long row0 = blockIdx.x * static_cast<long long>(kRows);

  const int din = p.dims[0];
  for (int i = threadIdx.x; i < kRows * din; i += blockDim.x) {
    const int r = i / din, k = i % din;
    cur[r * p.ld + k] = row0 + r < n ? x[(row0 + r) * din + k] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * p.dc; i += blockDim.x) {
    const int r = i / p.dc, k = i % p.dc;
    ctile[r * p.dc + k] = row0 + r < n ? c[(row0 + r) * p.dc + k] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const int d_in = p.dims[l], d_out = p.dims[l + 1];
    const float* __restrict__ W = p.W[l];
    const float* __restrict__ C = p.C[l];
    const bool last = l == p.n_layers - 1;
    for (int it = threadIdx.x; it < (kRows / kRpt) * d_out;
         it += blockDim.x) {
      const int r0 = (it / d_out) * kRpt, j = it % d_out;
      float acc[kRpt];
#pragma unroll
      for (int q = 0; q < kRpt; ++q) acc[q] = 0.f;
      for (int k = 0; k < d_in; ++k) {
        const float wkj = __ldg(W + k * d_out + j);
#pragma unroll
        for (int q = 0; q < kRpt; ++q)
          acc[q] = fmaf(cur[(r0 + q) * p.ld + k], wkj, acc[q]);
      }
      const float bj = __ldg(p.b[l] + j);
#pragma unroll
      for (int q = 0; q < kRpt; ++q) acc[q] += bj;
      if (C != nullptr) {
        float cacc[kRpt];
#pragma unroll
        for (int q = 0; q < kRpt; ++q) cacc[q] = 0.f;
        for (int k = 0; k < p.dc; ++k) {
          const float ckj = __ldg(C + k * d_out + j);
#pragma unroll
          for (int q = 0; q < kRpt; ++q)
            cacc[q] = fmaf(ctile[(r0 + q) * p.dc + k], ckj, cacc[q]);
        }
#pragma unroll
        for (int q = 0; q < kRpt; ++q) acc[q] += cacc[q];
      }
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        const float v = activate(acc[q], p.act[l]);
        if (last) {
          if (row0 + r0 + q < n) out[(row0 + r0 + q) * d_out + j] = v;
        } else {
          nxt[(r0 + q) * p.ld + j] = v;
        }
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

// x: (n, dims[0]); c: (n, dc) or null; out: (n, dims[n_layers]).
// W, b, C: arrays of n_layers device pointers (C entries null without a
// conditional input).  Returns cudaErrorInvalidValue for a stack the
// kernel does not take (too many layers, or a tile that does not fit).
extern "C" int dense_stack_launch(const float* x, const float* c, float* out,
                                  long long n, int n_layers,
                                  const int* dims, const int* acts,
                                  const float* const* W,
                                  const float* const* b,
                                  const float* const* C, int dc,
                                  cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  Stack p{};
  int widest = 0;
  for (int l = 0; l <= n_layers; ++l) {
    p.dims[l] = dims[l];
    if (dims[l] > widest) widest = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    p.W[l] = W[l];
    p.b[l] = b[l];
    p.C[l] = c != nullptr ? C[l] : nullptr;
    p.act[l] = acts[l];
  }
  p.n_layers = n_layers;
  p.dc = c != nullptr ? dc : 0;
  p.ld = widest | 1;  // odd stride: row groups land in distinct banks
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(kRows) * p.ld +
                                       static_cast<size_t>(kRows) * p.dc);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = allow_smem(dense_stack_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  dense_stack_kernel<<<blocks, kThreads, smem, stream>>>(x, c, out, n, p);
  return static_cast<int>(cudaGetLastError());
}
