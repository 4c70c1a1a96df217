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
// identity outside the bins.  Outputs x (N, D) and the log-det summed
// over DOFs (N,).  Float32 throughout, no TF32; or, in bf16 mode (the
// JAX kernel's compute_dtype=bfloat16), the conditioner's operands y or
// the context, K1, C1, the tanh output h, K2 and C2 each rounded to
// bfloat16 (round to nearest even, as torch's .to(torch.bfloat16)) where
// they are read, their products accumulated in float32, and the biases,
// the tanh and the spline in float32.  The outputs are float32 in both
// modes.
//
// The MADE's structure does the pruning.  Hidden unit j of each net has
// degree j % (D-1) + 1 (0 when D = 1); DOF d has the input degree deg[d];
// an output of DOF d reads only hidden units of degree < deg[d], and a
// hidden unit of degree g only inputs of degree <= g (the masks zero the
// rest of K1 and K2 exactly).  The kernel keeps each net's hidden units
// sorted by degree (start[g] units have degree < g), so DOF d's heads
// contract over the prefix [0, start[deg[d]]) only: half of the block-
// diagonal product at D = 8, and every skipped term an exact zero of the
// plain version.  The forward (sampling) pass, the D-pass fixed point,
// runs D passes in order of degree: pass p computes the hidden units of
// degree p - 1 (their inputs are final from pass p - 1 on), then the
// heads and the spline of the DOF of degree p only, whose value is final
// from then on.  So the forward costs one conditioner and D narrow
// spline phases, not D conditioners.
//
// Bound on the H100: float32 arithmetic.  At D=8, H=200, K=32 the masked
// product is ~157k flops per row against 4*(2D+1) bytes of rows and
// 0.6 MB of weights for all N, far above the card's ops-per-byte line
// outside the tensor cores.  Design: one block of 256 threads owns T = 32
// rows (16, 8 or 4 where a tile would not fit two blocks on an SM); the
// tile's hidden activations sit in shared memory transposed, (3H sorted
// units, T rows), so that 4 rows of a unit are one 16-byte load.  A DOF's
// three K2 column blocks stream through shared memory in chunks of 16
// sorted rows, a ring of three stages filled by cp.async two chunks
// ahead of the one in use, each head's columns padded to a multiple of
// 4; each thread owns a 4-row x 4-column register micro-tile of one
// head, so two 16-byte shared loads serve 16 FMAs.  Then the DOF's
// spline, eight threads per row sharing partial maxima, sums and knot
// totals through shared memory, so that every warp works (one thread per
// row left seven of eight warps idle through D spline phases of ~1500
// dependent instructions each).  CUDA-core FMAs; neither wgmma, TMA nor
// TF32 is used.  Measured on an H100: removing the staging saves a
// third of the time at D = 8, the FMAs a quarter, the splines a fifth.
// The bf16 mode is the same kernel with its operands rounded as they are
// read (a template flag, so the float32 mode is untouched): each product
// of two bfloat16 numbers is exact in float32, so the FMAs sum exactly
// the products the plain version's float32 matmul of the rounded
// operands sums, in another order.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include "common.cuh"
#include "rqs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDofs = 64;
constexpr int kChunk = 16;  // sorted K2 rows per pipeline stage
constexpr int kStages = 3;  // stages in the ring: two in flight
constexpr int kLanes = 8;   // threads per row in the spline phase
constexpr int kTileRows[] = {32, 16, 8, 4};
constexpr int kT = 32;      // the largest tile
static_assert(kT * kLanes == kThreads, "a full tile's spline fills the block");
// Shared memory that leaves room for two blocks on one SM.
constexpr int kTwoPerSm = 113 * 1024;

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
  int deg[kMaxDofs];        // input degree of DOF d, a permutation of 1..D
  int start[kMaxDofs + 1];  // sorted hidden units of degree < g
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// Bytes of dynamic shared memory for a tile of T rows: y, cur and the
// per-DOF log-dets (D x T each) and the context (C x T), padded to 16
// bytes; h (3H x T); the K2 stages (kStages x kChunk x 3 round4(K)),
// which the spline phase reuses for its partials (3 x kT x kLanes); one
// DOF's raw spline parameters (T x (3K-1)); the sorted unit order (H
// ints).
__host__ __device__ inline int stage_floats(int K) {
  return max(kStages * kChunk * 3 * round4(K), 3 * kT * kLanes);
}

__host__ inline size_t smem_bytes(int T, int D, int H, int K, int C) {
  const size_t floats = round4(T * (3 * D + C)) +
                        static_cast<size_t>(3) * H * T + stage_floats(K) +
                        static_cast<size_t>(T) * (3 * K - 1);
  return sizeof(float) * floats + sizeof(int) * H;
}

// An operand of the conditioner's products: itself in float32 mode,
// rounded to the nearest bfloat16 (ties to even) in bf16 mode.
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus with its threshold of 20.
  return v > 20.f ? v : log1pf(expf(v));
}

// Every per-row array is stored transposed, (width, T), so that the
// lanes of a warp, on consecutive rows, hit distinct banks and four rows
// are one 16-byte load.
struct Tile {
  float* yT;    // (D, T)
  float* curT;  // (D, T) conditioner input, then the output
  float* lT;    // (D, T) per-DOF log-dets
  float* ctT;   // (C, T)
  float* hT;    // (3H, T): unit k (sorted) of head hd at (hd*H + k)*T
  float* ws;    // (kStages, kChunk, 3 round4(K)): K2 stages
  float* raw;   // (T, 3K-1): one DOF's raw spline parameters
  float* red;   // (3, kT, kLanes): the spline phase's partials (in ws)
  int* unit;    // (H,): sorted position -> hidden unit index
};

// h for sorted units [k_lo, k_hi) of all three nets:
// tanh(cur @ K1 [+ ctx @ C1] + b1), four rows per work item.  In bf16
// mode the context is rounded already (at staging) and h is stored
// rounded, as the K2 products read it.
template <bool kBf16>
__device__ void hidden_units(const Block& p, const Tile& t, int k_lo,
                             int k_hi) {
  const int D = p.D, H = p.H, C = p.C, T = p.T, H3 = 3 * H;
  const int nk = k_hi - k_lo, rqs = T / 4, lg = __ffs(rqs) - 1;
  const int items = 3 * nk * rqs;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int rq = it & (rqs - 1), unit_hd = it >> lg;  // T: a power of 2
    const int hd = unit_hd / nk, k = k_lo + unit_hd - hd * nk;
    const int col = hd * H + t.unit[k];
    const int r0 = 4 * rq;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int i = 0; i < D; ++i) {
      const float w = operand<kBf16>(__ldg(p.k1 + i * H3 + col));
      const float4 a = *reinterpret_cast<const float4*>(t.curT + i * T + r0);
      acc[0] = fmaf(operand<kBf16>(a.x), w, acc[0]);
      acc[1] = fmaf(operand<kBf16>(a.y), w, acc[1]);
      acc[2] = fmaf(operand<kBf16>(a.z), w, acc[2]);
      acc[3] = fmaf(operand<kBf16>(a.w), w, acc[3]);
    }
    if (C > 0) {
      float cacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float w = operand<kBf16>(__ldg(p.c1 + c * H3 + col));
        const float4 a = *reinterpret_cast<const float4*>(t.ctT + c * T + r0);
        cacc[0] = fmaf(a.x, w, cacc[0]);
        cacc[1] = fmaf(a.y, w, cacc[1]);
        cacc[2] = fmaf(a.z, w, cacc[2]);
        cacc[3] = fmaf(a.w, w, cacc[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += cacc[q];
    }
    const float bj = __ldg(p.b1 + col);
    *reinterpret_cast<float4*>(t.hT + (hd * H + k) * T + r0) =
        make_float4(operand<kBf16>(tanhf(acc[0] + bj)),
                    operand<kBf16>(tanhf(acc[1] + bj)),
                    operand<kBf16>(tanhf(acc[2] + bj)),
                    operand<kBf16>(tanhf(acc[3] + bj)));
  }
}

// Start copying sorted rows [k0, k0 + rows) of DOF d's three K2 column
// blocks into stage `ws` (cp.async, 4 bytes each: the slope head's
// columns are not 16-byte aligned).  A warp takes one (row, head)
// segment at a time, a lane one column, so that the addresses cost one
// lookup per segment.
__device__ __forceinline__ void stage_k2(const Block& p, const Tile& t, int d,
                                         int k0, int rows, float* ws) {
  const int D = p.D, H = p.H, K = p.K, KP = round4(K);
  const int P = D * (3 * K - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int seg = warp; seg < 3 * rows; seg += kThreads / 32) {
    const int kk = seg / 3, hd = seg - 3 * kk;
    const int kh = hd < 2 ? K : K - 1;
    const float* src = p.k2 +
                       static_cast<size_t>(hd * H + t.unit[k0 + kk]) * P +
                       hd * D * K + d * kh;
    float* dst = ws + kk * 3 * KP + hd * KP;
    for (int c = lane; c < kh; c += 32)
      __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
  }
}

// DOF d's raw spline parameters into t.raw: its three heads over its
// unmasked prefix of sorted hidden units, [+ ctx @ C2] + b2.  In bf16
// mode the staged K2 entries and C2 are rounded as they are read (h and
// the context are rounded already).
template <bool kBf16>
__device__ void dof_heads(const Block& p, const Tile& t, int d) {
  const int D = p.D, H = p.H, K = p.K, C = p.C, T = p.T;
  const int P = D * (3 * K - 1), Q = 3 * K - 1, KP = round4(K);
  const int lk = p.start[p.deg[d]];
  const int n_chunks = (lk + kChunk - 1) / kChunk;
  // Work item: (column quad, row quad, head), column quads fastest, so
  // that a warp shares one head's activations and one row of the stage.
  const int cqs = KP / 4, rqs = T / 4;
  const int items = 3 * rqs * cqs;
  for (int base = 0; base < items; base += kThreads) {
    const int it = base + threadIdx.x;
    const int cq = it % cqs, rq = (it / cqs) % rqs, hd = it / (cqs * rqs);
    const int kh = hd < 2 ? K : K - 1;
    const int col0 = 4 * cq, nq = min(4, kh - col0);
    const bool mine = it < items && nq > 0;
    const int r0 = 4 * rq;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    // A ring of kStages stages, kStages - 1 chunks in flight ahead of the
    // one in use; the group of chunk c is the c-th committed.
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks)
        stage_k2(p, t, d, c * kChunk, min(kChunk, lk - c * kChunk),
                 t.ws + c * kChunk * 3 * KP);
      __pipeline_commit();
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * kChunk, ahead = ch + kStages - 1;
      if (ahead < n_chunks)
        stage_k2(p, t, d, ahead * kChunk, min(kChunk, lk - ahead * kChunk),
                 t.ws + (ahead % kStages) * kChunk * 3 * KP);
      __pipeline_commit();
      __pipeline_wait_prior(kStages - 1);
      __syncthreads();
      if (mine) {
        const float* w =
            t.ws + (ch % kStages) * kChunk * 3 * KP + hd * KP + col0;
        const float* hs = t.hT + (hd * H + k0) * T + r0;
        const int rows = min(kChunk, lk - k0);
#pragma unroll 4
        for (int kk = 0; kk < rows; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(hs + kk * T);
          const float4 b =
              *reinterpret_cast<const float4*>(w + kk * 3 * KP);
          const float wq[4] = {operand<kBf16>(b.x), operand<kBf16>(b.y),
                               operand<kBf16>(b.z), operand<kBf16>(b.w)};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[0][q] = fmaf(a.x, wq[q], acc[0][q]);
            acc[1][q] = fmaf(a.y, wq[q], acc[1][q]);
            acc[2][q] = fmaf(a.z, wq[q], acc[2][q]);
            acc[3][q] = fmaf(a.w, wq[q], acc[3][q]);
          }
        }
      }
      __syncthreads();  // the stage is read before it is refilled
    }
    if (!mine) continue;
    const int gcol = hd * D * K + d * kh + col0;  // column in K2, b2, C2
    if (C > 0) {
      float cacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) cacc[i][q] = 0.f;
      for (int cc = 0; cc < C; ++cc) {
        const float4 a =
            *reinterpret_cast<const float4*>(t.ctT + cc * T + r0);
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = q < nq ? operand<kBf16>(__ldg(
                              p.c2 + static_cast<size_t>(cc) * P + gcol + q))
                        : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cacc[0][q] = fmaf(a.x, w[q], cacc[0][q]);
          cacc[1][q] = fmaf(a.y, w[q], cacc[1][q]);
          cacc[2][q] = fmaf(a.z, w[q], cacc[2][q]);
          cacc[3][q] = fmaf(a.w, w[q], cacc[3][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += cacc[i][q];
    }
    float* dst = t.raw + r0 * Q + hd * K + col0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= nq) break;
      const float bj = __ldg(p.b2 + gcol + q);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i * Q + q] = acc[i][q] + bj;
    }
  }
}

// DOF d's spline activations and its RQS at y.  kLanes threads share a
// row (kT rows x kLanes = the block): each takes a contiguous run of
// ceil(K / kLanes) bins for the softmax, the softplus and the knot sums,
// and they combine their partial maxima, sums and run totals, and the
// bin each finds, through the shared scratch `red` between block
// barriers (every thread of the block is in this phase).  rqs.cuh's
// one-thread walk would leave seven of eight warps idle here.
template <bool kInverse>
__device__ void dof_spline(const Block& p, const Tile& t, int d) {
  const int K = p.K, T = p.T, Q = 3 * K - 1;
  const int r = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const bool active = r < T;
  float* w = t.raw + r * Q;
  float* h = w + K;
  float* s = w + 2 * K;
  float* ra = t.red + r * kLanes;  // this row's kLanes slots, three sets
  float* rb = ra + kT * kLanes;
  float* rc = rb + kT * kLanes;
  const int run = (K + kLanes - 1) / kLanes;
  const int k_lo = active ? min(K, lane * run) : 0;
  const int k_hi = active ? min(K, k_lo + run) : 0;

  float mw = -INFINITY, mh = -INFINITY;
  for (int k = k_lo; k < k_hi; ++k) {
    mw = fmaxf(mw, w[k]);
    mh = fmaxf(mh, h[k]);
  }
  if (active) {
    ra[lane] = mw;
    rb[lane] = mh;
  }
  __syncthreads();
  if (active) {
    for (int q = 0; q < kLanes; ++q) {
      mw = fmaxf(mw, ra[q]);
      mh = fmaxf(mh, rb[q]);
    }
  }
  __syncthreads();
  float sw = 0.f, sh = 0.f;
  for (int k = k_lo; k < k_hi; ++k) {
    sw += expf(w[k] - mw);
    sh += expf(h[k] - mh);
  }
  if (active) {
    ra[lane] = sw;
    rb[lane] = sh;
  }
  __syncthreads();
  sw = sh = 0.f;
  if (active) {
    for (int q = 0; q < kLanes; ++q) {
      sw += ra[q];
      sh += rb[q];
    }
  }
  __syncthreads();
  float tw = 0.f, th = 0.f;
  for (int k = k_lo; k < k_hi; ++k) {
    w[k] = expf(w[k] - mw) / sw * p.span + 1e-2f;
    h[k] = expf(h[k] - mh) / sh * p.span + 1e-2f;
    tw += w[k];
    th += h[k];
  }
  for (int k = k_lo; k < min(k_hi, K - 1); ++k) s[k] = softplus(s[k]) + 1e-2f;
  if (active) {
    ra[lane] = tw;
    rb[lane] = th;
  }
  __syncthreads();
  // Sums of the bins before this run, and of all of them.
  float cw = 0.f, ch = 0.f, total_w = 0.f, total_h = 0.f;
  if (active) {
    for (int q = 0; q < kLanes; ++q) {
      if (q == lane) {
        cw = total_w;
        ch = total_h;
      }
      total_w += ra[q];
      total_h += rb[q];
    }
  }
  __syncthreads();
  // Knot k sits at range_min + sum_{i<k} of the widths (heights); the bin
  // is the last k >= 1 whose knot is <= v, or 0.
  const float v = active ? t.yT[d * T + r] : 0.f;
  int bin = 0;
  float xk = p.bin_min, yk = p.bin_min;
  for (int k = k_lo; k < k_hi; ++k) {
    if (k >= 1) {
      const float kx = p.bin_min + cw, ky = p.bin_min + ch;
      if (v >= (kInverse ? ky : kx)) {
        bin = k;
        xk = kx;
        yk = ky;
      }
    }
    cw += w[k];
    ch += h[k];
  }
  if (active) {
    ra[lane] = static_cast<float>(bin);
    rb[lane] = xk;
    rc[lane] = yk;
  }
  __syncthreads();
  if (active && lane == 0) {
    int owner = 0;
    for (int q = 1; q < kLanes; ++q)
      if (ra[q] > ra[owner]) owner = q;
    bin = static_cast<int>(ra[owner]);
    const float total = p.bin_min + (kInverse ? total_h : total_w);
    float out, l;
    rqs_apply<kInverse>(v, rb[owner], rc[owner], w[bin], h[bin],
                        bin > 0 ? s[bin - 1] : 1.f,
                        bin < K - 1 ? s[bin] : 1.f, p.bin_min, total, out, l);
    t.curT[d * T + r] = out;
    t.lT[d * T + r] = l;
  }
}

template <bool kInverse, bool kBf16>
__global__ void __launch_bounds__(kThreads) maf_block_kernel(Block p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, H = p.H, K = p.K, C = p.C, T = p.T;
  Tile t;
  t.yT = smem;
  t.curT = t.yT + D * T;
  t.lT = t.curT + D * T;
  t.ctT = t.lT + D * T;
  t.hT = smem + round4(T * (3 * D + C));
  t.ws = t.hT + 3 * H * T;
  t.red = t.ws;  // the heads phase is done with the stages by then
  t.raw = t.ws + stage_floats(K);
  t.unit = reinterpret_cast<int*>(t.raw + T * (3 * K - 1));
  const long long row0 = blockIdx.x * static_cast<long long>(T);

  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float v = row0 + r < p.n ? p.y[row0 * D + i] : 0.f;
    t.yT[d * T + r] = v;
    t.curT[d * T + r] = v;
  }
  for (int i = threadIdx.x; i < T * C; i += kThreads) {
    const int r = i / C, c = i % C;
    t.ctT[c * T + r] =
        row0 + r < p.n ? operand<kBf16>(p.ctx[(row0 + r) * C + c]) : 0.f;
  }
  // Sorted position -> hidden unit: group g holds the units of degree g
  // in increasing order, j = g - 1 + m (D - 1) (j = m when D = 1).
  for (int k = threadIdx.x; k < H; k += kThreads) {
    int g = 0;
    while (p.start[g + 1] <= k) ++g;
    const int m = k - p.start[g];
    t.unit[k] = D > 1 ? g - 1 + m * (D - 1) : m;
  }
  __syncthreads();

  if (kInverse) {
    hidden_units<kBf16>(p, t, 0, H);
    __syncthreads();
    for (int d = 0; d < D; ++d) {
      dof_heads<kBf16>(p, t, d);  // synchronises before its first read
      __syncthreads();
      dof_spline<true>(p, t, d);
      __syncthreads();
    }
  } else {
    __shared__ int dof_of[kMaxDofs + 1];  // degree -> DOF
    for (int d = threadIdx.x; d < D; d += kThreads) dof_of[p.deg[d]] = d;
    for (int pass = 1; pass <= D; ++pass) {
      // Units of degree pass - 1: their inputs are final now.
      if (p.start[pass] > p.start[pass - 1])
        hidden_units<kBf16>(p, t, p.start[pass - 1], p.start[pass]);
      __syncthreads();
      const int d = dof_of[pass];
      dof_heads<kBf16>(p, t, d);
      __syncthreads();
      dof_spline<false>(p, t, d);
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < p.n) p.x[row0 * D + i] = t.curT[d * T + r];
  }
  for (int r = threadIdx.x; r < T; r += kThreads) {
    if (row0 + r < p.n) {
      float sum = 0.f;
      for (int d = 0; d < D; ++d) sum += t.lT[d * T + r];
      p.ldj[row0 + r] = sum;
    }
  }
}

template <bool kInverse, bool kBf16>
cudaError_t launch(const Block& p, unsigned blocks, size_t smem,
                   cudaStream_t stream) {
  auto kernel = maf_block_kernel<kInverse, kBf16>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// y, x: (n, D); ctx: (n, C) or null with C = 0; ldj: (n,).  k1, b1, k2,
// b2 (and c1, c2 with a context) in MaskedSplineConditioner
// .merged_params()'s layout, MADE-masked for the input degrees `deg`
// (D ints, a permutation of 1..D); `start` (D + 1 ints): start[g] hidden
// units of each net have degree < g (ops/maf_fused.py
// `hidden_degree_starts`).  span = bin_max - bin_min - K*1e-2.  bf16: 1
// for the bf16 mode (see the top of this file), 0 for float32.  Returns
// cudaErrorInvalidValue for a block the kernel does not take (bad sizes,
// D > 64, or a 4-row tile that does not fit shared memory).
extern "C" int maf_block_launch(const float* y, const float* ctx,
                                const float* k1, const float* b1,
                                const float* k2, const float* b2,
                                const float* c1, const float* c2, float* x,
                                float* ldj, long long n, int D, int H, int K,
                                int C, float bin_min, float span, int inverse,
                                int bf16, const int* deg, const int* start,
                                cudaStream_t stream) {
  if (D < 1 || D > kMaxDofs || H < 1 || K < 2 || C < 0 ||
      (C > 0) != (ctx != nullptr) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Block p{y, ctx, k1, b1, k2, b2, c1, c2, x, ldj, n, D, H, K, C, 0,
          bin_min, span};
  for (int d = 0; d < D; ++d) {
    if (deg[d] < 1 || deg[d] > D)
      return static_cast<int>(cudaErrorInvalidValue);
    p.deg[d] = deg[d];
  }
  for (int d = 0; d < D; ++d)
    for (int e = d + 1; e < D; ++e)
      if (deg[d] == deg[e]) return static_cast<int>(cudaErrorInvalidValue);
  for (int g = 0; g <= D; ++g) {
    p.start[g] = start[g];
    if (start[g] < 0 || start[g] > H || (g > 0 && start[g] < start[g - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (start[D] != H) return static_cast<int>(cudaErrorInvalidValue);
  // The largest tile that leaves two blocks per SM, else the largest
  // that fits at all.
  size_t smem = 0;
  for (int pass = 0; pass < 2 && p.T == 0; ++pass) {
    const size_t limit = pass == 0 ? kTwoPerSm : kMaxDynamicSmem;
    for (int rows : kTileRows) {
      smem = smem_bytes(rows, D, H, K, C);
      if (smem <= limit) {
        p.T = rows;
        break;
      }
    }
  }
  if (p.T == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((n + p.T - 1) / p.T);
  cudaError_t err;
  if (inverse)
    err = bf16 ? launch<true, true>(p, blocks, smem, stream)
               : launch<true, false>(p, blocks, smem, stream);
  else
    err = bf16 ? launch<false, true>(p, blocks, smem, stream)
               : launch<false, false>(p, blocks, smem, stream);
  return static_cast<int>(err);
}
