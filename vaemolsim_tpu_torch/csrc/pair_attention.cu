// Pair-attention kernel: one geometric-algebra attention layer's whole
// (N, N) pair grid, per frame, in shared memory.
//
// Replaces vaemolsim_tpu/ops/attention_pallas.py `_kernel` / `_one_frame`
// (reached from fused_pair_attention, called by nn/attention.py
// `_va_fused_impl`).  Per frame, with the invariants q_ij = [r_i.r_j,
// |r_i x r_j|, |r_i|^2, |r_j|^2] computed here from the coordinates:
//     h_s  = act(ni_s[i] + nj_s[j] + b1_s + sum_m q_ijm wq_s[m])
//     s_ij = h_s . w2_s + b2_s                  (-1e9 where m_i m_j = 0)
//     h_v  = ni_v[i] + nj_v[j] + b1_v + sum_m q_ijm wq_v[m]
//     v_ij = act(LayerNorm(h_v)) @ w2_v + b2_v
//     e = exp(s - max) m_i m_j,  alpha = e / max(sum e, 1e-30)
// with the max and the sum per row i (out (B, N, Fo) = sum_j alpha v)
// or over the whole grid (reduce: out (B, Fo)).  Float32, no TF32.
// The value head is linear, so it is folded through the contraction:
//     out_i = (sum_j alpha_ij act(LN(h_v,ij))) @ w2_v + b2_v sum_j alpha_ij,
// the same function with the sums taken in another order, and the 2 H Fo
// head products per pair move to once per row.
//
// Bound on the H100: at the notebook shape the bytes of the inputs (four
// (B, N, H) node projections) and the float32 operations of the pair grid
// (~32 H per pair) take about the same least time, 4.4 and 3.9 µs at
// B = 2000 (chip_smoke.py's count).  The first design evaluated each value
// trunk three times per (pair, hidden unit) (twice for the LayerNorm's two
// passes, once more for the accumulation), loaded about a dozen
// shared-memory words per (pair, unit) that are the same for every pair,
// split its work into four phases of uneven width between block barriers,
// and fitted two blocks of 84 KB on an SM: at B = 2000 a second wave of 22
// blocks.
//
// Three regimes, chosen by the caller from the shapes (ops/attention.py
// `kernel_plan`, which also picks the lanes, units, frames per block and
// shared memory that this file's launch only validates):
//
// Rows (H <= 256, all but the largest frames): a group of L lanes owns a
// row i of a frame; lane b of the group owns the hidden units k = b + L m,
// m < U (L U >= H, U in {2, 4, 5, 8}: 8 lanes of 5 units at H = 40), and
// keeps their weights and the row's node projections in registers while
// it walks over j.
// - Scores: per pair, each lane's U units of the score trunk, a sum over
//   the group (shuffles), then the row's softmax by the same group.  With
//   reduce, the softmax over the frame's grid waits for a block barrier
//   and is shared by the block's warps (8 / T a frame).
// - Values: per pair of non-zero weight, each lane evaluates its units of
//   the value trunk once and keeps them in registers; the LayerNorm's
//   mean and variance are two group sums over them (two passes, as the
//   plain version takes them); act(LN) is applied once and accumulated
//   with alpha_ij in registers.  The score and value loops run one after
//   the other over a group's rows, so that the two trunks' weights are
//   never held in registers at once.
// - Occupancy: a block of 256 threads holds 256 / L groups and T frames
//   (T N rows <= groups where N allows), staged by cp.async with the
//   invariants (34 KB at the notebook shape, 80 registers a thread: 3
//   blocks an SM).  The value head runs once per row after the only other
//   block barrier.
// Measured on the H100 at the notebook shape (N = 10, H = 40, B = 2000):
// staging a fifth of the time, the score loop a fifth, the value loop
// (two dependent group sums, a square root and the LayerNorm per pair) two
// fifths.  The loops are bound by latency: each pair waits on its group's
// shuffles, and the registers that hold a row's weights limit a block to
// 3 an SM.
//
// Grid (the first design's arithmetic; H > 256, and large frames of wide
// layers): a block owns T frames (about 512 pairs; T = 1 at N = 50),
// staged by cp.async.  Phase A, a thread per pair: the invariants, the
// score, and the value trunk's LayerNorm mean and 1/std (two passes over
// H, recomputing h_v).  Phase B, a warp per row (per frame with reduce):
// the softmax.  Phase C, a thread per (row, hidden unit): A[i][k] = sum_j
// alpha_ij act(LN(h_v,ijk)).  Phase D, a thread per output: the value
// head.  Its frames are large, so an SM holds one block: the launch
// bounds say so, and the registers they free took 7% off the first
// design's time at N = 50, H = 64 (B = 1000: 0.90 against 0.97 ms on the
// H100, chip_turns.py).  The choice between the regimes (chip_turns.py's
// sweep over N = 6 to 64, H = 16 to 200, both modes) is the faster one, or
// one within 4% of it, at every shape: the grid wins where an SM holds
// only one rows block and that block only 16 or 8 lane groups, as at N =
// 50, H = 64 (0.90 against 1.21 ms).
//
// Stream (H <= 512, frames whose pair grid fits neither regime: N = 100
// at H = 40 needs 282 KB in the rows regime, H = 300 at N = 400 is beyond
// the grid regime): a block owns one frame and holds nothing of size N.
// Its lane groups own rows as in the rows regime (up to 16 units a lane),
// with the same per-pair arithmetic, but read the coordinates, mask and
// node projections from global memory (L1) and compute the invariants per
// pair; a group walks its row's keys in chunks of kChunk and keeps one
// chunk's scores and one row's accumulators (H floats) in shared memory:
// 22 KB at H = 40 (32 groups of 8 lanes), whatever N.  Without reduce a
// row's softmax is online: per chunk its scores, the chunk's maximum, the
// running sum and accumulators rescaled by exp(old max - new max), then
// the chunk's values; the row's head once at the end.  With reduce the
// grid's softmax takes two passes: the first computes each chunk's
// scores, its maximum and its sum of exponentials, merged per group chunk
// by chunk and then over the block (in group order); the second computes
// the scores again (the same bits) and accumulates alpha act(LN(h_v))
// over the group's rows, and the block adds the groups' accumulators in
// group order before the head.
//
// No atomics in any regime: every sum has one order.  Neither wgmma,
// TMA nor TF32 is used.
#include <cuda_pipeline.h>

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFrames = 8;
static_assert(kMaxFrames <= kWarps, "the reduce softmax takes a warp a frame");
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e9f;
constexpr int kChunk = 128;  // keys a stream-regime chunk holds

enum Act { kLinear = 0, kRelu = 1, kTanh = 2 };

template <int A>
__device__ __forceinline__ float activate(float v) {
  if (A == kRelu) return fmaxf(v, 0.f);
  if (A == kTanh) return tanhf(v);
  return v;
}

struct Args {
  const float* coords;  // (B, N, 3)
  const float* ni_s;    // (B, N, H) node projections, bias excluded
  const float* nj_s;
  const float* ni_v;
  const float* nj_v;
  const float* mask;    // (B, N), 0 or 1
  const float* wq_s;    // (4, H)
  const float* b1_s;    // (H,)
  const float* w2_s;    // (H,)
  const float* b2_s;    // (1,)
  const float* wq_v;    // (4, H)
  const float* b1_v;    // (H,)
  const float* ln_g;    // (H,)
  const float* ln_b;    // (H,)
  const float* w2_v;    // (H, Fo)
  const float* b2_v;    // (Fo,)
  float* out;           // (B, N, Fo), or (B, Fo) with reduce
  long long B;
  int N, H, Fo, T, L, ld;  // L: lanes per row (rows); ld: row stride (grid)
  float eps;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Rows regime: the value head's weights and biases, and a partial per
// warp for the reduce softmax; per frame, the invariants (float4 per
// pair), four node projections, scores-then-alpha, the row accumulators,
// coordinates, mask, row sums.
__host__ __device__ inline int weight_floats(int H, int Fo) {
  return round4(H * Fo + Fo) + kWarps;
}

__host__ __device__ inline int frame_floats(int N, int H) {
  return round4(4 * N * N + 4 * N * H + N * N + N * H + 3 * N + N + N);
}

// Grid regime: all weights; per frame, coordinates, mask, four node
// projections (row stride ld = H | 1, so that the rows of one column fall
// in distinct banks), the invariants (4 planes), score-then-alpha, LN
// mean, LN 1/std, the row accumulators and the row sums.
__host__ __device__ inline int grid_weight_floats(int H, int Fo) {
  return 13 * H + H * Fo + Fo + 1;
}

__host__ __device__ inline int grid_frame_floats(int N, int H, int ld) {
  return 4 * N + 4 * N * ld + 7 * N * N + N * H + N;
}

// Stream regime: the value head's weights and biases; per lane group, a
// chunk's scores and a row's accumulators; three partials per group (the
// reduce softmax's maximum and sum, the sum of alpha).  Independent of N.
__host__ __device__ inline int stream_floats(int H, int Fo, int G) {
  return round4(H * Fo + Fo) + G * (kChunk + round4(H)) + 3 * G;
}

// Sums and maxima over a group of L lanes (unrolled, the steps past the
// group's width predicated off).
__device__ __forceinline__ float group_sum(float v, unsigned mask, int L) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < L) v += __shfl_xor_sync(mask, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v, unsigned mask, int L) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < L) v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

template <int A, bool kReduce, int U>
__global__ void __launch_bounds__(kThreads, 2) pair_attention_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, H = p.H, Fo = p.Fo, T = p.T, L = p.L;
  const int NN = N * N;
  float* w2v = smem;
  float* b2v = w2v + H * Fo;
  float* frames = smem + weight_floats(H, Fo);
  float* part = frames - kWarps;  // the reduce softmax's partials
  const int per_frame = frame_floats(N, H);
  const long long b0 = blockIdx.x * static_cast<long long>(T);

  auto Q = [&](int f) {
    return reinterpret_cast<float4*>(frames + f * per_frame);
  };
  auto proj = [&](int f, int which) {
    return frames + f * per_frame + 4 * NN + which * N * H;
  };
  auto S = [&](int f) { return proj(f, 4); };     // (N, N)
  auto Acc = [&](int f) { return S(f) + NN; };    // (N, H)
  auto xyz = [&](int f) { return Acc(f) + N * H; };
  auto msk = [&](int f) { return xyz(f) + 3 * N; };
  auto rsum = [&](int f) { return msk(f) + N; };

  // Staging by asynchronous copies (cp.async), all in flight at once; a
  // frame past B is zero-filled (its mask masks every pair).
  const int tid = threadIdx.x;
  for (int t = tid; t < H * Fo; t += kThreads)
    __pipeline_memcpy_async(w2v + t, p.w2_v + t, sizeof(float));
  for (int t = tid; t < Fo; t += kThreads)
    __pipeline_memcpy_async(b2v + t, p.b2_v + t, sizeof(float));
  const float* src[4] = {p.ni_s, p.nj_s, p.ni_v, p.nj_v};
  for (int f = 0; f < T; ++f) {
    const long long b = b0 + f;
    if (b >= p.B) {
      for (int t = tid; t < 3 * N; t += kThreads) xyz(f)[t] = 0.f;
      for (int t = tid; t < N; t += kThreads) msk(f)[t] = 0.f;
      for (int t = tid; t < 4 * N * H; t += kThreads) proj(f, 0)[t] = 0.f;
      continue;
    }
    for (int t = tid; t < 3 * N; t += kThreads)
      __pipeline_memcpy_async(xyz(f) + t, p.coords + b * 3 * N + t,
                              sizeof(float));
    for (int t = tid; t < N; t += kThreads)
      __pipeline_memcpy_async(msk(f) + t, p.mask + b * N + t, sizeof(float));
    // The four projections, 16 bytes a copy where a frame's N H floats
    // allow it.
    const int step = N * H % 4 == 0 ? 4 : 1;
    for (int w = 0; w < 4; ++w) {
      float* dst = proj(f, w);
      const float* s = src[w] + b * static_cast<long long>(N) * H;
      for (int t = step * tid; t < N * H; t += step * kThreads) {
        if (step == 4)
          __pipeline_memcpy_async(dst + t, s + t, 16);
        else
          __pipeline_memcpy_async(dst + t, s + t, 4);
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // The invariants, a thread per pair.
  for (int it = tid; it < T * NN; it += kThreads) {
    const int f = it / NN, pr = it - f * NN, i = pr / N, j = pr - i * N;
    const float* x = xyz(f);
    const float xi = x[3 * i], yi = x[3 * i + 1], zi = x[3 * i + 2];
    const float xj = x[3 * j], yj = x[3 * j + 1], zj = x[3 * j + 2];
    const float cx = yi * zj - zi * yj, cy = zi * xj - xi * zj,
                cz = xi * yj - yi * xj;
    Q(f)[pr] = make_float4(xi * xj + yi * yj + zi * zj,
                           sqrtf(cx * cx + cy * cy + cz * cz + 1e-12f),
                           xi * xi + yi * yi + zi * zi,
                           xj * xj + yj * yj + zj * zj);
  }
  __syncthreads();

  // Lane groups: group g owns rows g, g + G, ...; lane b of it the hidden
  // units b + L m.
  const int G = kThreads / L;
  const int grp = tid / L, b = tid - grp * L, lane = tid & 31;
  const unsigned gmask =
      L == 32 ? kFull : (((1u << L) - 1u) << (lane & ~(L - 1)));
  const int R = T * N;
  const float inv_h = 1.f / H;

  // Scores of row i of frame f into S; padding units have zero weights.
  auto scores = [&](int f, int i) {
    float wq[4][U], w2[U], a[U];
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int k = b + L * m;
#pragma unroll
      for (int c = 0; c < 4; ++c) wq[c][m] = k < H ? p.wq_s[c * H + k] : 0.f;
      w2[m] = k < H ? p.w2_s[k] : 0.f;
      a[m] = k < H ? proj(f, 0)[i * H + k] + p.b1_s[k] : 0.f;
    }
    const float b2 = p.b2_s[0];
    const float mi = msk(f)[i];
    const float* njs = proj(f, 1);
    const float4* q = Q(f) + i * N;
    float* s_row = S(f) + i * N;
    for (int j = 0; j < N; ++j) {
      float s = kNegInf;
      if (mi * msk(f)[j] > 0.5f) {
        const float4 qq = q[j];
        float part = 0.f;
#pragma unroll
        for (int m = 0; m < U; ++m) {
          const int k = b + L * m;
          float h = a[m] + (k < H ? njs[j * H + k] : 0.f);
          h = fmaf(qq.x, wq[0][m], h);
          h = fmaf(qq.y, wq[1][m], h);
          h = fmaf(qq.z, wq[2][m], h);
          h = fmaf(qq.w, wq[3][m], h);
          part = fmaf(activate<A>(h), w2[m], part);
        }
        s = group_sum(part, gmask, L) + b2;
      }
      if (b == 0) s_row[j] = s;
    }
  };

  // Softmax weights over n scores s[0..n) with pair masks pm(t), in place,
  // by the lanes of one group; returns sum alpha.
  auto softmax = [&](float* s, int n, unsigned mask, int width, int lid,
                     auto pm) {
    float mx = -FLT_MAX;
    for (int t = lid; t < n; t += width) mx = fmaxf(mx, s[t]);
    mx = group_max(mx, mask, width);
    float sum = 0.f;
    for (int t = lid; t < n; t += width) {
      const float e = expf(s[t] - mx) * pm(t);
      s[t] = e;
      sum += e;
    }
    const float inv = 1.f / fmaxf(group_sum(sum, mask, width), 1e-30f);
    float asum = 0.f;
    for (int t = lid; t < n; t += width) {
      const float a = s[t] * inv;
      s[t] = a;
      asum += a;
    }
    return group_sum(asum, mask, width);
  };

  // Row i of frame f's accumulators, sum_j alpha_ij act(LN(h_v,ij)).
  auto values = [&](int f, int i) {
    float wq[4][U], g[U], beta[U], a[U], acc[U];
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int k = b + L * m;
#pragma unroll
      for (int c = 0; c < 4; ++c) wq[c][m] = k < H ? p.wq_v[c * H + k] : 0.f;
      g[m] = k < H ? p.ln_g[k] : 0.f;
      beta[m] = k < H ? p.ln_b[k] : 0.f;
      a[m] = k < H ? proj(f, 2)[i * H + k] + p.b1_v[k] : 0.f;
      acc[m] = 0.f;
    }
    const float* njv = proj(f, 3);
    const float4* q = Q(f) + i * N;
    const float* a_row = S(f) + i * N;
    for (int j = 0; j < N; ++j) {
      const float alpha = a_row[j];
      if (alpha == 0.f) continue;
      const float4 qq = q[j];
      float h[U];
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < U; ++m) {
        const int k = b + L * m;
        float v = a[m] + (k < H ? njv[j * H + k] : 0.f);
        v = fmaf(qq.x, wq[0][m], v);
        v = fmaf(qq.y, wq[1][m], v);
        v = fmaf(qq.z, wq[2][m], v);
        h[m] = fmaf(qq.w, wq[3][m], v);
        sum += h[m];  // padding units hold exactly 0
      }
      const float mu = group_sum(sum, gmask, L) * inv_h;
      float var = 0.f;
#pragma unroll
      for (int m = 0; m < U; ++m) {
        h[m] -= mu;
        if (b + L * m < H) var = fmaf(h[m], h[m], var);
      }
      const float rs = rsqrtf(fmaf(group_sum(var, gmask, L), inv_h, p.eps));
#pragma unroll
      for (int m = 0; m < U; ++m)
        acc[m] = fmaf(alpha, activate<A>(fmaf(h[m] * rs, g[m], beta[m])),
                      acc[m]);
    }
    float* out = Acc(f) + i * H;
#pragma unroll
    for (int m = 0; m < U; ++m)
      if (b + L * m < H) out[b + L * m] = acc[m];
  };

  if (kReduce) {
    for (int r = grp; r < R; r += G) scores(r / N, r % N);
    __syncthreads();
    // The softmax over each frame's grid by W = kWarps / T warps: each
    // takes a strided share of the N^2 scores, and their partial maxima
    // and sums meet in `part` in warp order.
    const int warp = tid >> 5, W = kWarps / T;
    const int f = warp / W, w = warp - f * W;
    const bool live = f < T;
    float* s = live ? S(f) : nullptr;
    const float* m = live ? msk(f) : nullptr;
    auto combine = [&](float v, bool is_max) {
      if (lane == 0) part[warp] = v;
      __syncthreads();
      float tot = live ? part[f * W] : 0.f;
      for (int u = 1; live && u < W; ++u)
        tot = is_max ? fmaxf(tot, part[f * W + u]) : tot + part[f * W + u];
      __syncthreads();  // part is written again by the next step
      return tot;
    };
    float mx = -FLT_MAX;
    for (int t = w * 32 + lane; live && t < NN; t += W * 32)
      mx = fmaxf(mx, s[t]);
    mx = combine(group_max(mx, kFull, 32), true);
    float sum = 0.f;
    for (int t = w * 32 + lane; live && t < NN; t += W * 32) {
      const float e = expf(s[t] - mx) * (m[t / N] * m[t % N]);
      s[t] = e;
      sum += e;
    }
    const float inv = 1.f / fmaxf(combine(group_sum(sum, kFull, 32), false),
                                  1e-30f);
    float asum = 0.f;
    for (int t = w * 32 + lane; live && t < NN; t += W * 32) {
      const float a = s[t] * inv;
      s[t] = a;
      asum += a;
    }
    asum = combine(group_sum(asum, kFull, 32), false);
    if (live && w == 0 && lane == 0) rsum(f)[0] = asum;
    for (int r = grp; r < R; r += G) values(r / N, r % N);
  } else {
    // Two loops over the group's rows, so that the score trunk's weights
    // and the value trunk's are never held in registers at once.
    for (int r = grp; r < R; r += G) {
      const int f = r / N, i = r - f * N;
      scores(f, i);
      __syncwarp(gmask);
      const float* m = msk(f);
      const float mi = m[i];
      const float asum = softmax(S(f) + i * N, N, gmask, L, b,
                                 [&](int t) { return mi * m[t]; });
      if (b == 0) rsum(f)[i] = asum;
    }
    __syncwarp(gmask);
    for (int r = grp; r < R; r += G) values(r / N, r % N);
  }
  __syncthreads();

  // The value head, once per row (or once per frame).
  if (kReduce) {
    for (int it = tid; it < T * H; it += kThreads) {
      const int f = it / H, k = it - f * H;
      float* acc = Acc(f);
      float v = 0.f;
      for (int i = 0; i < N; ++i) v += acc[i * H + k];
      acc[k] = v;
    }
    __syncthreads();
    for (int it = tid; it < T * Fo; it += kThreads) {
      const int f = it / Fo, o = it - f * Fo;
      if (b0 + f >= p.B) continue;
      const float* acc = Acc(f);
      float v = 0.f;
      for (int k = 0; k < H; ++k) v = fmaf(acc[k], w2v[k * Fo + o], v);
      p.out[(b0 + f) * Fo + o] = fmaf(b2v[o], rsum(f)[0], v);
    }
  } else {
    for (int it = tid; it < T * N * Fo; it += kThreads) {
      const int f = it / (N * Fo), r = it - f * N * Fo, i = r / Fo,
                o = r - i * Fo;
      if (b0 + f >= p.B) continue;
      const float* acc = Acc(f) + i * H;
      float v = 0.f;
      for (int k = 0; k < H; ++k) v = fmaf(acc[k], w2v[k * Fo + o], v);
      p.out[((b0 + f) * N + i) * Fo + o] = fmaf(b2v[o], rsum(f)[i], v);
    }
  }
}

// Grid regime: h = ni + nj + b1 + sum_m q_m w_m, in one fixed order
// wherever it is evaluated, so that phase C sees the h_v whose statistics
// phase A took.
__device__ __forceinline__ float trunk(float ni, float nj, float b1,
                                       const float q[4], const float* wq,
                                       int H, int k) {
  float h = (ni + nj) + b1;
  h = fmaf(q[0], wq[k], h);
  h = fmaf(q[1], wq[H + k], h);
  h = fmaf(q[2], wq[2 * H + k], h);
  return fmaf(q[3], wq[3 * H + k], h);
}

// Softmax weights over n entries s[0..n) with pair masks pm(idx), in
// place (s becomes alpha); returns sum alpha.  Called by a whole warp.
template <typename PM>
__device__ __forceinline__ float warp_softmax(float* s, int n, PM pm) {
  const int lane = threadIdx.x & 31;
  float mx = -FLT_MAX;
  for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[t]);
  mx = group_max(mx, kFull, 32);
  float sum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float e = expf(s[t] - mx) * pm(t);
    s[t] = e;
    sum += e;
  }
  const float denom = fmaxf(group_sum(sum, kFull, 32), 1e-30f);
  float asum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float a = s[t] / denom;
    s[t] = a;
    asum += a;
  }
  return group_sum(asum, kFull, 32);
}

template <int A, bool kReduce>
__global__ void __launch_bounds__(kThreads, 1) pair_attention_kernel_grid(
    Args p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, H = p.H, Fo = p.Fo, T = p.T, ld = p.ld;
  const int NN = N * N;
  float* wqs = smem;
  float* b1s = wqs + 4 * H;
  float* w2s = b1s + H;
  float* wqv = w2s + H;
  float* b1v = wqv + 4 * H;
  float* lng = b1v + H;
  float* lnb = lng + H;
  float* w2v = lnb + H;
  float* b2v = w2v + H * Fo;
  float* b2s = b2v + Fo;
  float* frames = smem + grid_weight_floats(H, Fo);
  const int per_frame = grid_frame_floats(N, H, ld);
  const long long b0 = blockIdx.x * static_cast<long long>(T);

  auto xyz = [&](int f) { return frames + f * per_frame; };
  auto msk = [&](int f) { return xyz(f) + 3 * N; };
  auto proj = [&](int f, int which) { return msk(f) + N + which * N * ld; };
  auto qpl = [&](int f) { return proj(f, 4); };  // 4 planes of NN
  auto S = [&](int f) { return qpl(f) + 4 * NN; };
  auto MU = [&](int f) { return S(f) + NN; };
  auto RS = [&](int f) { return MU(f) + NN; };
  auto Acc = [&](int f) { return RS(f) + NN; };  // (N, H)
  auto RSUM = [&](int f) { return Acc(f) + N * H; };

  // Staging by cp.async; a frame past B is zero-filled (its mask masks
  // every pair).
  const int tid = threadIdx.x;
  auto copy = [](float* dst, const float* src) {
    __pipeline_memcpy_async(dst, src, sizeof(float));
  };
  for (int t = tid; t < 4 * H; t += kThreads) {
    copy(wqs + t, p.wq_s + t);
    copy(wqv + t, p.wq_v + t);
  }
  for (int t = tid; t < H; t += kThreads) {
    copy(b1s + t, p.b1_s + t);
    copy(w2s + t, p.w2_s + t);
    copy(b1v + t, p.b1_v + t);
    copy(lng + t, p.ln_g + t);
    copy(lnb + t, p.ln_b + t);
  }
  for (int t = tid; t < H * Fo; t += kThreads) copy(w2v + t, p.w2_v + t);
  for (int t = tid; t < Fo; t += kThreads) copy(b2v + t, p.b2_v + t);
  if (tid == 0) copy(b2s, p.b2_s);
  const float* src[4] = {p.ni_s, p.nj_s, p.ni_v, p.nj_v};
  for (int f = 0; f < T; ++f) {
    const long long b = b0 + f;
    if (b >= p.B) {
      for (int t = tid; t < 3 * N; t += kThreads) xyz(f)[t] = 0.f;
      for (int t = tid; t < N; t += kThreads) msk(f)[t] = 0.f;
      for (int t = tid; t < 4 * N * ld; t += kThreads) proj(f, 0)[t] = 0.f;
      continue;
    }
    for (int t = tid; t < 3 * N; t += kThreads)
      copy(xyz(f) + t, p.coords + b * 3 * N + t);
    for (int t = tid; t < N; t += kThreads) copy(msk(f) + t, p.mask + b * N + t);
    for (int w = 0; w < 4; ++w) {
      float* dst = proj(f, w);
      const float* sw = src[w] + b * static_cast<long long>(N) * H;
      for (int t = tid; t < N * H; t += kThreads)
        copy(dst + (t / H) * ld + t % H, sw + t);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Phase A: a thread per pair.
  for (int it = tid; it < T * NN; it += kThreads) {
    const int f = it / NN, pr = it % NN, i = pr / N, j = pr % N;
    const float* x = xyz(f);
    const float xi = x[3 * i], yi = x[3 * i + 1], zi = x[3 * i + 2];
    const float xj = x[3 * j], yj = x[3 * j + 1], zj = x[3 * j + 2];
    const float cx = yi * zj - zi * yj, cy = zi * xj - xi * zj,
                cz = xi * yj - yi * xj;
    float q[4];
    q[0] = xi * xj + yi * yj + zi * zj;
    q[1] = sqrtf(cx * cx + cy * cy + cz * cz + 1e-12f);
    q[2] = xi * xi + yi * yi + zi * zi;
    q[3] = xj * xj + yj * yj + zj * zj;
    float* qp = qpl(f);
#pragma unroll
    for (int m = 0; m < 4; ++m) qp[m * NN + pr] = q[m];
    const float pm = msk(f)[i] * msk(f)[j];
    float s = kNegInf, mu = 0.f, rs = 0.f;
    if (pm > 0.5f) {
      const float* nis = proj(f, 0) + i * ld;
      const float* njs = proj(f, 1) + j * ld;
      const float* niv = proj(f, 2) + i * ld;
      const float* njv = proj(f, 3) + j * ld;
      s = 0.f;
      float sum = 0.f;
      for (int k = 0; k < H; ++k) {
        s = fmaf(activate<A>(trunk(nis[k], njs[k], b1s[k], q, wqs, H, k)),
                 w2s[k], s);
        sum += trunk(niv[k], njv[k], b1v[k], q, wqv, H, k);
      }
      s += b2s[0];
      mu = sum / H;
      float var = 0.f;
      for (int k = 0; k < H; ++k) {
        const float d = trunk(niv[k], njv[k], b1v[k], q, wqv, H, k) - mu;
        var = fmaf(d, d, var);
      }
      rs = 1.f / sqrtf(var / H + p.eps);
    }
    S(f)[pr] = s;
    MU(f)[pr] = mu;
    RS(f)[pr] = rs;
  }
  __syncthreads();

  // Phase B: softmax weights, a warp per row (per frame with reduce).
  const int warp = tid >> 5, lane = tid & 31;
  if (kReduce) {
    for (int f = warp; f < T; f += kWarps) {
      const float* m = msk(f);
      const float asum = warp_softmax(S(f), NN, [&](int t) {
        return m[t / N] * m[t % N];
      });
      if (lane == 0) RSUM(f)[0] = asum;
    }
  } else {
    for (int r = warp; r < T * N; r += kWarps) {
      const int f = r / N, i = r % N;
      const float* m = msk(f);
      const float mi = m[i];
      const float asum = warp_softmax(S(f) + i * N, N, [&](int t) {
        return mi * m[t];
      });
      if (lane == 0) RSUM(f)[i] = asum;
    }
  }
  __syncthreads();

  // Phase C: A[i][k] = sum_j alpha_ij act(LN(h_v)), a thread per (i, k).
  for (int it = tid; it < T * N * H; it += kThreads) {
    const int f = it / (N * H), r = it % (N * H), i = r / H, k = r % H;
    const float* qp = qpl(f);
    const float* a_row = S(f) + i * N;
    const float* mu_row = MU(f) + i * N;
    const float* rs_row = RS(f) + i * N;
    const float* njv = proj(f, 3);
    const float niv = proj(f, 2)[i * ld + k];
    const float b1 = b1v[k], g = lng[k], beta = lnb[k];
    float acc = 0.f;
    for (int j = 0; j < N; ++j) {
      const float a = a_row[j];
      if (a == 0.f) continue;
      const int pr = i * N + j;
      const float q[4] = {qp[pr], qp[NN + pr], qp[2 * NN + pr],
                          qp[3 * NN + pr]};
      const float h = trunk(niv, njv[j * ld + k], b1, q, wqv, H, k);
      acc = fmaf(a, activate<A>(fmaf((h - mu_row[j]) * rs_row[j], g, beta)),
                 acc);
    }
    Acc(f)[i * H + k] = acc;
  }
  __syncthreads();

  // Phase D: the value head, once per row (or once per frame).
  if (kReduce) {
    for (int it = tid; it < T * H; it += kThreads) {
      const int f = it / H, k = it % H;
      float* acc = Acc(f);
      float v = 0.f;
      for (int i = 0; i < N; ++i) v += acc[i * H + k];
      acc[k] = v;
    }
    __syncthreads();
    for (int it = tid; it < T * Fo; it += kThreads) {
      const int f = it / Fo, o = it % Fo;
      if (b0 + f >= p.B) continue;
      const float* acc = Acc(f);
      float v = 0.f;
      for (int k = 0; k < H; ++k) v = fmaf(acc[k], w2v[k * Fo + o], v);
      p.out[(b0 + f) * Fo + o] = fmaf(b2v[o], RSUM(f)[0], v);
    }
  } else {
    for (int it = tid; it < T * N * Fo; it += kThreads) {
      const int f = it / (N * Fo), r = it % (N * Fo), i = r / Fo, o = r % Fo;
      if (b0 + f >= p.B) continue;
      const float* acc = Acc(f) + i * H;
      float v = 0.f;
      for (int k = 0; k < H; ++k) v = fmaf(acc[k], w2v[k * Fo + o], v);
      p.out[((b0 + f) * N + i) * Fo + o] = fmaf(b2v[o], RSUM(f)[i], v);
    }
  }
}

template <int A, bool kReduce, int U>
__global__ void __launch_bounds__(kThreads, U > 8 ? 1 : 2)
    pair_attention_kernel_stream(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, H = p.H, Fo = p.Fo, L = p.L;
  const int G = kThreads / L;
  float* w2v = smem;
  float* b2v = w2v + H * Fo;
  float* chunks = smem + round4(H * Fo + Fo);
  float* accs = chunks + G * kChunk;
  float* part = accs + G * round4(H);  // max (G), sum (G), sum alpha (G)
  const long long fb = blockIdx.x;
  const int tid = threadIdx.x;
  for (int t = tid; t < H * Fo; t += kThreads) w2v[t] = p.w2_v[t];
  for (int t = tid; t < Fo; t += kThreads) b2v[t] = p.b2_v[t];
  __syncthreads();

  const int grp = tid / L, b = tid - grp * L, lane = tid & 31;
  const unsigned gmask =
      L == 32 ? kFull : (((1u << L) - 1u) << (lane & ~(L - 1)));
  const float inv_h = 1.f / H;
  const long long off = fb * static_cast<long long>(N) * H;
  const float* __restrict__ xyz = p.coords + fb * 3 * N;
  const float* __restrict__ msk = p.mask + fb * N;
  const float* __restrict__ nis = p.ni_s + off;
  const float* __restrict__ njs = p.nj_s + off;
  const float* __restrict__ niv = p.ni_v + off;
  const float* __restrict__ njv = p.nj_v + off;
  float* s_chunk = chunks + grp * kChunk;
  float* a_out = accs + grp * round4(H);

  // The invariants of pair (i, j), as the rows regime stages them.
  auto invariants = [&](int i, int j) {
    const float xi = xyz[3 * i], yi = xyz[3 * i + 1], zi = xyz[3 * i + 2];
    const float xj = xyz[3 * j], yj = xyz[3 * j + 1], zj = xyz[3 * j + 2];
    const float cx = yi * zj - zi * yj, cy = zi * xj - xi * zj,
                cz = xi * yj - yi * xj;
    return make_float4(xi * xj + yi * yj + zi * zj,
                       sqrtf(cx * cx + cy * cy + cz * cz + 1e-12f),
                       xi * xi + yi * yi + zi * zi,
                       xj * xj + yj * yj + zj * zj);
  };

  // Scores of keys j0 .. j0 + n - 1 of row i into s_chunk (the rows
  // regime's arithmetic; both reduce passes call it, so they see the same
  // bits).
  auto scores = [&](int i, int j0, int n) {
    float wq[4][U], w2[U], a[U];
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int k = b + L * m;
#pragma unroll
      for (int c = 0; c < 4; ++c) wq[c][m] = k < H ? p.wq_s[c * H + k] : 0.f;
      w2[m] = k < H ? p.w2_s[k] : 0.f;
      a[m] = k < H ? nis[i * H + k] + p.b1_s[k] : 0.f;
    }
    const float b2 = p.b2_s[0];
    const float mi = msk[i];
    for (int t = 0; t < n; ++t) {
      const int j = j0 + t;
      float s = kNegInf;
      if (mi * msk[j] > 0.5f) {
        const float4 qq = invariants(i, j);
        float part_s = 0.f;
#pragma unroll
        for (int m = 0; m < U; ++m) {
          const int k = b + L * m;
          float h = a[m] + (k < H ? njs[j * H + k] : 0.f);
          h = fmaf(qq.x, wq[0][m], h);
          h = fmaf(qq.y, wq[1][m], h);
          h = fmaf(qq.z, wq[2][m], h);
          h = fmaf(qq.w, wq[3][m], h);
          part_s = fmaf(activate<A>(h), w2[m], part_s);
        }
        s = group_sum(part_s, gmask, L) + b2;
      }
      if (b == 0) s_chunk[t] = s;
    }
    __syncwarp(gmask);
  };

  // The chunk's largest score, over the group.
  auto chunk_max = [&](int n) {
    float mx = -FLT_MAX;
    for (int t = b; t < n; t += L) mx = fmaxf(mx, s_chunk[t]);
    return group_max(mx, gmask, L);
  };

  // acc += sum_j w_ij act(LN(h_v,ij)) over the chunk's keys, w_ij =
  // wt(j, s_ij); returns sum_j w_ij.
  auto values = [&](int i, int j0, int n, float (&acc)[U], auto wt) {
    float wq[4][U], g[U], beta[U], a[U];
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int k = b + L * m;
#pragma unroll
      for (int c = 0; c < 4; ++c) wq[c][m] = k < H ? p.wq_v[c * H + k] : 0.f;
      g[m] = k < H ? p.ln_g[k] : 0.f;
      beta[m] = k < H ? p.ln_b[k] : 0.f;
      a[m] = k < H ? niv[i * H + k] + p.b1_v[k] : 0.f;
    }
    float wsum = 0.f;
    for (int t = 0; t < n; ++t) {
      const int j = j0 + t;
      const float alpha = wt(j, s_chunk[t]);
      wsum += alpha;
      if (alpha == 0.f) continue;
      const float4 qq = invariants(i, j);
      float h[U];
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < U; ++m) {
        const int k = b + L * m;
        float v = a[m] + (k < H ? njv[j * H + k] : 0.f);
        v = fmaf(qq.x, wq[0][m], v);
        v = fmaf(qq.y, wq[1][m], v);
        v = fmaf(qq.z, wq[2][m], v);
        h[m] = fmaf(qq.w, wq[3][m], v);
        sum += h[m];  // padding units hold exactly 0
      }
      const float mu = group_sum(sum, gmask, L) * inv_h;
      float var = 0.f;
#pragma unroll
      for (int m = 0; m < U; ++m) {
        h[m] -= mu;
        if (b + L * m < H) var = fmaf(h[m], h[m], var);
      }
      const float rs = rsqrtf(fmaf(group_sum(var, gmask, L), inv_h, p.eps));
#pragma unroll
      for (int m = 0; m < U; ++m)
        acc[m] = fmaf(alpha, activate<A>(fmaf(h[m] * rs, g[m], beta[m])),
                      acc[m]);
    }
    return wsum;
  };

  auto store = [&](float* dst, const float (&acc)[U]) {
#pragma unroll
    for (int m = 0; m < U; ++m)
      if (b + L * m < H) dst[b + L * m] = acc[m];
  };

  if (!kReduce) {
    for (int i = grp; i < N; i += G) {
      // The row's softmax online over key chunks: a running maximum, and
      // a running sum and accumulators rescaled whenever it rises.
      const float mi = msk[i];
      float acc[U];
#pragma unroll
      for (int m = 0; m < U; ++m) acc[m] = 0.f;
      float run_max = -FLT_MAX, run_sum = 0.f;
      for (int j0 = 0; j0 < N; j0 += kChunk) {
        const int n = min(kChunk, N - j0);
        scores(i, j0, n);
        const float top = fmaxf(run_max, chunk_max(n));
        const float scale = expf(run_max - top);  // 0 on the first chunk
        run_sum *= scale;
#pragma unroll
        for (int m = 0; m < U; ++m) acc[m] *= scale;
        run_max = top;
        run_sum += values(i, j0, n, acc, [&](int j, float s) {
          return expf(s - top) * (mi * msk[j]);
        });
        __syncwarp(gmask);  // s_chunk is the next chunk's
      }
      const float inv = 1.f / fmaxf(run_sum, 1e-30f);
#pragma unroll
      for (int m = 0; m < U; ++m) acc[m] *= inv;
      store(a_out, acc);
      __syncwarp(gmask);
      const float asum = run_sum * inv;
      for (int o = b; o < Fo; o += L) {
        float v = 0.f;
        for (int k = 0; k < H; ++k) v = fmaf(a_out[k], w2v[k * Fo + o], v);
        p.out[(fb * N + i) * Fo + o] = fmaf(b2v[o], asum, v);
      }
      __syncwarp(gmask);  // a_out is the next row's
    }
    return;
  }

  // Pass 1: each group's running maximum and sum of exp(s - max) m_i m_j,
  // merged chunk by chunk.
  float gmax = -FLT_MAX, gsum = 0.f;
  for (int i = grp; i < N; i += G) {
    const float mi = msk[i];
    for (int j0 = 0; j0 < N; j0 += kChunk) {
      const int n = min(kChunk, N - j0);
      scores(i, j0, n);
      const float mx = chunk_max(n);
      float sum = 0.f;
      for (int t = b; t < n; t += L)
        sum += expf(s_chunk[t] - mx) * (mi * msk[j0 + t]);
      sum = group_sum(sum, gmask, L);
      const float top = fmaxf(gmax, mx);
      gsum = gsum * expf(gmax - top) + sum * expf(mx - top);
      gmax = top;
      __syncwarp(gmask);  // s_chunk is the next chunk's
    }
  }
  if (b == 0) {
    part[grp] = gmax;
    part[G + grp] = gsum;
  }
  __syncthreads();
  float top = -FLT_MAX;
  for (int u = 0; u < G; ++u) top = fmaxf(top, part[u]);
  float tot = 0.f;
  for (int u = 0; u < G; ++u) tot += part[G + u] * expf(part[u] - top);
  const float inv = 1.f / fmaxf(tot, 1e-30f);

  // Pass 2: the scores again, alpha = exp(s - max) m_i m_j / sum.  Each
  // row sums into its own accumulators, added to the group's once the row
  // is done: a group's sequential sums stay a row long (N terms), not N^2
  // / G (float32 rounding at N = 4096 otherwise reaches 1e-4).
  float acc[U];
#pragma unroll
  for (int m = 0; m < U; ++m) acc[m] = 0.f;
  float asum = 0.f;
  for (int i = grp; i < N; i += G) {
    const float mi = msk[i];
    float racc[U];
#pragma unroll
    for (int m = 0; m < U; ++m) racc[m] = 0.f;
    float rsum = 0.f;
    for (int j0 = 0; j0 < N; j0 += kChunk) {
      const int n = min(kChunk, N - j0);
      scores(i, j0, n);
      rsum += values(i, j0, n, racc, [&](int j, float s) {
        return (expf(s - top) * (mi * msk[j])) * inv;
      });
      __syncwarp(gmask);
    }
#pragma unroll
    for (int m = 0; m < U; ++m) acc[m] += racc[m];
    asum += rsum;
  }
  store(a_out, acc);
  if (b == 0) part[2 * G + grp] = asum;
  __syncthreads();
  for (int k = tid; k < H; k += kThreads) {
    float v = 0.f;
    for (int u = 0; u < G; ++u) v += accs[u * round4(H) + k];
    accs[k] = v;  // column k is this thread's alone
  }
  float atot = 0.f;
  for (int u = 0; u < G; ++u) atot += part[2 * G + u];
  __syncthreads();
  for (int o = tid; o < Fo; o += kThreads) {
    float v = 0.f;
    for (int k = 0; k < H; ++k) v = fmaf(accs[k], w2v[k * Fo + o], v);
    p.out[fb * Fo + o] = fmaf(b2v[o], atot, v);
  }
}

template <typename K>
cudaError_t launch(K kernel, const Args& p, unsigned blocks, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Regime { kRows = 0, kGrid = 1, kStream = 2 };

template <int A, bool kReduce, int U>
cudaError_t launch_units(int regime, const Args& p, unsigned blocks,
                         size_t smem, cudaStream_t stream) {
  if (regime == kStream)
    return launch(pair_attention_kernel_stream<A, kReduce, U>, p, blocks,
                  smem, stream);
  return launch(pair_attention_kernel<A, kReduce, U>, p, blocks, smem,
                stream);
}

// Units a lane: 2, 4, 5 or 8 in the rows and stream regimes, 12 or 16 in
// the stream regime alone.
template <int A, bool kReduce>
cudaError_t launch_regime(int regime, int units, const Args& p,
                          unsigned blocks, size_t smem, cudaStream_t stream) {
  if (regime == kGrid)
    return launch(pair_attention_kernel_grid<A, kReduce>, p, blocks, smem,
                  stream);
  if (units == 2)
    return launch_units<A, kReduce, 2>(regime, p, blocks, smem, stream);
  if (units == 4)
    return launch_units<A, kReduce, 4>(regime, p, blocks, smem, stream);
  if (units == 5)
    return launch_units<A, kReduce, 5>(regime, p, blocks, smem, stream);
  if (units == 8)
    return launch_units<A, kReduce, 8>(regime, p, blocks, smem, stream);
  if (units == 12)
    return launch(pair_attention_kernel_stream<A, kReduce, 12>, p, blocks,
                  smem, stream);
  return launch(pair_attention_kernel_stream<A, kReduce, 16>, p, blocks,
                smem, stream);
}

template <bool kReduce>
cudaError_t launch_act(int act, int regime, int units, const Args& p,
                       unsigned blocks, size_t smem, cudaStream_t stream) {
  if (act == kRelu)
    return launch_regime<kRelu, kReduce>(regime, units, p, blocks, smem,
                                         stream);
  if (act == kTanh)
    return launch_regime<kTanh, kReduce>(regime, units, p, blocks, smem,
                                         stream);
  return launch_regime<kLinear, kReduce>(regime, units, p, blocks, smem,
                                         stream);
}

}  // namespace

// coords (B, N, 3); ni_s, nj_s, ni_v, nj_v (B, N, H); mask (B, N);
// wq_s, wq_v (4, H); b1_s, w2_s, b1_v, ln_g, ln_b (H,); b2_s (1,);
// w2_v (H, Fo); b2_v (Fo,); out (B, N, Fo), or (B, Fo) with reduce.
// act: 0 linear, 1 relu, 2 tanh.  The plan is the caller's: regime (0
// rows, 1 grid, 2 stream), lanes per row and units per lane (rows,
// stream), frames per block (1 in the stream regime) and the dynamic
// shared memory in bytes.  Returns cudaErrorInvalidValue for bad sizes
// and for a plan that the kernel cannot run: lanes not a power of two up
// to 32, units not compiled for the regime (2, 4, 5, 8; 12 and 16 in the
// stream regime) or lanes x units < H, frames outside [1, 8]
// (or not 1 in the stream regime), or shared memory short of the plan's
// need or above the card's limit.
extern "C" int pair_attention_launch(
    const float* coords, const float* ni_s, const float* nj_s,
    const float* ni_v, const float* nj_v, const float* mask,
    const float* wq_s, const float* b1_s, const float* w2_s,
    const float* b2_s, const float* wq_v, const float* b1_v,
    const float* ln_g, const float* ln_b, const float* w2_v,
    const float* b2_v, float* out, long long B, int N, int H, int Fo,
    int act, int reduce, float eps, int regime, int lanes, int units,
    int frames, long long smem, cudaStream_t stream) {
  if (B < 0 || N < 1 || H < 1 || Fo < 1 || act < kLinear || act > kTanh ||
      regime < kRows || regime > kStream || frames < 1 ||
      frames > kMaxFrames || (regime == kStream && frames != 1) ||
      smem < 0 || smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool grid = regime == kGrid;
  const int ld = H | 1;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool units_ok = units == 2 || units == 4 || units == 5 ||
                        units == 8 ||
                        (regime == kStream && (units == 12 || units == 16));
  if (!grid && (!lanes_ok || !units_ok || lanes * units < H))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need =
      grid ? 4LL * (grid_weight_floats(H, Fo) +
                    static_cast<long long>(frames) * grid_frame_floats(N, H, ld))
      : regime == kStream
          ? 4LL * stream_floats(H, Fo, kThreads / lanes)
          : 4LL * (weight_floats(H, Fo) +
                   static_cast<long long>(frames) * frame_floats(N, H));
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Args p{coords, ni_s, nj_s, ni_v, nj_v, mask, wq_s, b1_s, w2_s, b2_s,
         wq_v, b1_v, ln_g, ln_b, w2_v, b2_v, out, B, N, H, Fo, frames,
         grid ? 32 : lanes, ld, eps};
  const unsigned blocks = static_cast<unsigned>((B + frames - 1) / frames);
  const size_t bytes = static_cast<size_t>(smem);
  const cudaError_t err =
      reduce ? launch_act<true>(act, regime, units, p, blocks, bytes, stream)
             : launch_act<false>(act, regime, units, p, blocks, bytes, stream);
  return static_cast<int>(err);
}
