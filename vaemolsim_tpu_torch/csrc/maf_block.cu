// MAF-block kernel: one masked-autoregressive RQS block, the merged
// three-net MADE, the spline activations and the per-DOF spline, in one
// pass over a tile of rows.
//
// Replaces vaemolsim_tpu/ops/maf_fused.py `_maf_kernel` (reached from
// maf_block_inverse_fused / maf_block_forward_fused).  For (N, D) rows:
//     h   = tanh(y @ K1 [+ ctx @ C1] + b1)        K1 (D, 3H)
//     out = h @ K2 [+ ctx @ C2] + b2              K2 (3H, D(3K-1))
// K2 is block-diagonal over the width, height and slope nets; the
// columns of out are [D*K widths | D*K heights | D*(K-1) slopes], each
// row-major over (dof, param).  Widths and heights are softmax * span +
// 1e-2, slopes softplus + 1e-2, then the RQS of each DOF (rqs.cuh),
// identity outside the bins.  The inverse is one pass; the forward is
// the D-pass fixed point (D-1 refinements of the conditioner input, then
// a last pass that also gives the log-det).  Outputs x (N, D) and the
// log-det summed over DOFs (N,).  Float32 throughout, no TF32.
//
// Bound on the H100: float32 arithmetic.  At D=8, H=200, K=32 a pass
// does 2*(D*3H + H*D*(3K-1)) = 314k flops per row against 4*(2D+1)
// bytes of rows and 0.6 MB of weights for all N, far above the card's
// ops-per-byte line outside the tensor cores.  Design (simple first):
// one block of 256 threads owns a tile of T = 16 rows (8 or 4 where the
// tile would not fit shared memory); the tile's hidden activations
// (T, 3H) stay in shared memory, stored transposed so that 4 rows of
// one hidden unit are one 16-byte load; each thread accumulates 4 rows
// of one output column, and each head reads only its own H-wide slice
// of h, skipping K2's zero blocks (a third of the dense product's
// work; the k order within the slice is the dense product's, and the
// skipped terms are exact zeros, so no sum changes).  The raw spline
// parameters of the tile stay in shared memory for the spline phase,
// and in the forward pass the conditioner input `cur` stays there
// across the D passes, as the TPU kernel kept it in VMEM.  Weights are
// read through L1/L2 (K2 is 1.8 MB at these widths, well inside the
// 50 MB L2).  Neither wgmma, TMA nor TF32 is used.
#include "common.cuh"
#include "rqs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRpt = 4;  // rows accumulated by one thread
constexpr int kTileRows[] = {16, 8, 4};

struct Block {
  const float* y;    // (n, D)
  const float* ctx;  // (n, C) or null
  const float* k1;   // (D, 3H)
  const float* b1;   // (3H,)
  const float* k2;   // (3H, P), P = D(3K-1)
  const float* b2;   // (P,)
  const float* c1;   // (C, 3H) or null
  const float* c2;   // (C, P) or null
  float* x;          // (n, D)
  float* ldj;        // (n,)
  long long n;
  int D, H, K, C, T;
  float bin_min, span;
};

// Floats of dynamic shared memory for a tile of `rows`: y, cur and the
// per-DOF log-dets (rows x D each), the context (rows x C), h transposed
// (3H x rows) and the raw spline parameters (rows x P).
__host__ __device__ inline size_t smem_floats(int rows, int D, int H, int K,
                                              int C) {
  return static_cast<size_t>(rows) *
         (3 * D + C + 3 * H + static_cast<size_t>(D) * (3 * K - 1));
}

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus with its threshold of 20.
  return v > 20.f ? v : log1pf(expf(v));
}

// p[0..m) <- softmax(p) * span + 1e-2, in place.
__device__ __forceinline__ void softmax_floor(float* p, int m, float span) {
  float mx = p[0];
  for (int k = 1; k < m; ++k) mx = fmaxf(mx, p[k]);
  float sum = 0.f;
  for (int k = 0; k < m; ++k) sum += expf(p[k] - mx);
  for (int k = 0; k < m; ++k) p[k] = expf(p[k] - mx) / sum * span + 1e-2f;
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads) maf_block_kernel(Block p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, H = p.H, K = p.K, C = p.C, T = p.T;
  const int H3 = 3 * H;
  const int P = D * (3 * K - 1);
  float* yt = smem;             // (T, D)
  float* cur = yt + T * D;      // (T, D) conditioner input
  float* lt = cur + T * D;      // (T, D) per-DOF log-dets
  float* ct = lt + T * D;       // (T, C)
  float* hT = ct + T * C;       // (3H, T); T*(3D+C) is a multiple of 4
  float* raw = hT + H3 * T;     // (T, P)
  const long long row0 = blockIdx.x * static_cast<long long>(T);

  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    const int r = i / D;
    const float v = row0 + r < p.n ? p.y[row0 * D + i] : 0.f;
    yt[i] = v;
    cur[i] = v;
  }
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
    const int r = i / C;
    ct[i] = row0 + r < p.n ? p.ctx[row0 * C + i] : 0.f;
  }

  const int passes = kInverse ? 1 : D;
  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();
    // Hidden layer: h = tanh(cur @ K1 [+ ctx @ C1] + b1), kept transposed.
    for (int it = threadIdx.x; it < (T / kRpt) * H3; it += blockDim.x) {
      const int r0 = (it / H3) * kRpt, j = it % H3;
      float acc[kRpt];
#pragma unroll
      for (int q = 0; q < kRpt; ++q) acc[q] = 0.f;
      for (int k = 0; k < D; ++k) {
        const float w = __ldg(p.k1 + k * H3 + j);
#pragma unroll
        for (int q = 0; q < kRpt; ++q)
          acc[q] = fmaf(cur[(r0 + q) * D + k], w, acc[q]);
      }
      if (C > 0) {
        float cacc[kRpt];
#pragma unroll
        for (int q = 0; q < kRpt; ++q) cacc[q] = 0.f;
        for (int c = 0; c < C; ++c) {
          const float w = __ldg(p.c1 + c * H3 + j);
#pragma unroll
          for (int q = 0; q < kRpt; ++q)
            cacc[q] = fmaf(ct[(r0 + q) * C + c], w, cacc[q]);
        }
#pragma unroll
        for (int q = 0; q < kRpt; ++q) acc[q] += cacc[q];
      }
      const float bj = __ldg(p.b1 + j);
#pragma unroll
      for (int q = 0; q < kRpt; ++q) hT[j * T + r0 + q] = tanhf(acc[q] + bj);
    }
    __syncthreads();
    // Heads: out = h[:, head] @ K2[head, :] [+ ctx @ C2] + b2.
    for (int it = threadIdx.x; it < (T / kRpt) * P; it += blockDim.x) {
      const int r0 = (it / P) * kRpt, j = it % P;
      const int head = j < D * K ? 0 : (j < 2 * D * K ? 1 : 2);
      const float* __restrict__ w2 = p.k2 + static_cast<size_t>(head) * H * P;
      const float* hs = hT + head * H * T + r0;
      float acc[kRpt];
#pragma unroll
      for (int q = 0; q < kRpt; ++q) acc[q] = 0.f;
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(w2 + static_cast<size_t>(k) * P + j);
        const float4 hv = *reinterpret_cast<const float4*>(hs + k * T);
        acc[0] = fmaf(hv.x, w, acc[0]);
        acc[1] = fmaf(hv.y, w, acc[1]);
        acc[2] = fmaf(hv.z, w, acc[2]);
        acc[3] = fmaf(hv.w, w, acc[3]);
      }
      if (C > 0) {
        float cacc[kRpt];
#pragma unroll
        for (int q = 0; q < kRpt; ++q) cacc[q] = 0.f;
        for (int c = 0; c < C; ++c) {
          const float w = __ldg(p.c2 + static_cast<size_t>(c) * P + j);
#pragma unroll
          for (int q = 0; q < kRpt; ++q)
            cacc[q] = fmaf(ct[(r0 + q) * C + c], w, cacc[q]);
        }
#pragma unroll
        for (int q = 0; q < kRpt; ++q) acc[q] += cacc[q];
      }
      const float bj = __ldg(p.b2 + j);
#pragma unroll
      for (int q = 0; q < kRpt; ++q) raw[(r0 + q) * P + j] = acc[q] + bj;
    }
    __syncthreads();
    // Spline activations and the RQS of each (row, DOF) at y.
    for (int it = threadIdx.x; it < T * D; it += blockDim.x) {
      const int r = it / D, d = it % D;
      float* w = raw + r * P + d * K;
      float* h = raw + r * P + D * K + d * K;
      float* s = raw + r * P + 2 * D * K + d * (K - 1);
      softmax_floor(w, K, p.span);
      softmax_floor(h, K, p.span);
      for (int k = 0; k < K - 1; ++k) s[k] = softplus(s[k]) + 1e-2f;
      float out, l;
      rqs_eval<kInverse>(yt[it], w, h, s, K, p.bin_min, out, l);
      cur[it] = out;
      lt[it] = l;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    if (row0 + i / D < p.n) p.x[row0 * D + i] = cur[i];
  }
  for (int r = threadIdx.x; r < T; r += blockDim.x) {
    if (row0 + r < p.n) {
      float sum = 0.f;
      for (int d = 0; d < D; ++d) sum += lt[r * D + d];
      p.ldj[row0 + r] = sum;
    }
  }
}

}  // namespace

// y, x: (n, D); ctx: (n, C) or null with C = 0; ldj: (n,).  k1, b1, k2,
// b2 (and c1, c2 with a context) in MaskedSplineConditioner
// .merged_params()'s layout.  span = bin_max - bin_min - K*1e-2.
// Returns cudaErrorInvalidValue for a block the kernel does not take
// (bad sizes, or a 4-row tile that does not fit shared memory).
extern "C" int maf_block_launch(const float* y, const float* ctx,
                                const float* k1, const float* b1,
                                const float* k2, const float* b2,
                                const float* c1, const float* c2, float* x,
                                float* ldj, long long n, int D, int H, int K,
                                int C, float bin_min, float span, int inverse,
                                cudaStream_t stream) {
  if (D < 1 || H < 1 || K < 2 || C < 0 || (C > 0) != (ctx != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int T = 0;
  size_t smem = 0;
  for (int rows : kTileRows) {
    smem = sizeof(float) * smem_floats(rows, D, H, K, C);
    if (smem <= static_cast<size_t>(kMaxDynamicSmem)) {
      T = rows;
      break;
    }
  }
  if (T == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  Block p{y, ctx, k1, b1, k2, b2, c1, c2, x, ldj, n, D, H, K, C, T,
          bin_min, span};
  const unsigned blocks = static_cast<unsigned>((n + T - 1) / T);
  cudaError_t err;
  if (inverse) {
    err = allow_smem(maf_block_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    maf_block_kernel<true><<<blocks, kThreads, smem, stream>>>(p);
  } else {
    err = allow_smem(maf_block_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    maf_block_kernel<false><<<blocks, kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
