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
//
// Bound on the H100: float32 arithmetic.  The grid's work is ~30 H
// operations per pair against 4 N (3 + 1 + 4 H) bytes of inputs per
// frame, so at N = 10, H = 40 about 12k operations per 6.6 KB: far
// above the card's ops-per-byte line outside the tensor cores.  The
// value head is linear, so it is folded through the contraction:
//     out_i = (sum_j alpha_ij act(LN(h_v,ij))) @ w2_v + b2_v sum_j alpha_ij,
// which is the same function (the sums taken in another order) and
// moves the 2 H Fo head products per pair to once per row.  Design
// (simple first): a block of 256 threads owns T frames (enough for about
// 512 pairs; T = 1 at N = 50); weights, coordinates, mask and the four
// node projections (row stride H | 1, so that the rows of one column
// fall in distinct banks) are staged in dynamic shared memory, opted in
// above 48 KB.  Phase A, a thread per pair: the invariants, the score,
// and the value trunk's LayerNorm mean and 1/std (two passes over H,
// recomputing h_v).  Phase B, a warp per row (per frame with reduce):
// max, exp, sum and alpha with shuffles.  Phase C, a thread per (row,
// hidden unit): A[i][k] = sum_j alpha_ij act(LN(h_v,ijk)), skipping
// pairs of zero weight (masked ones).  Phase D, a thread per output:
// A @ w2_v + b2_v sum alpha.  No atomics: every sum has one order.
// Neither wgmma, TMA nor TF32 is used.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFrames = 8;
constexpr int kPairsPerBlock = 512;
constexpr int kMinBlocks = 264;  // two per SM of the H100's 132
constexpr float kNegInf = -1e9f;

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
  int N, H, Fo, T, ld;
  float eps;
};

__host__ __device__ inline int weight_floats(int H, int Fo) {
  return 13 * H + H * Fo + Fo + 1;
}

// Per frame: coordinates, mask, four node projections, the invariants
// (4 planes), score-then-alpha, LN mean, LN 1/std, A and the row sums.
__host__ __device__ inline int frame_floats(int N, int H, int ld) {
  return 4 * N + 4 * N * ld + 7 * N * N + N * H + N;
}

// h = ni + nj + b1 + sum_m q_m w_m, in one fixed order wherever it is
// evaluated, so that phase C sees the h_v whose statistics phase A took.
__device__ __forceinline__ float trunk(float ni, float nj, float b1,
                                       const float q[4], const float* wq,
                                       int H, int k) {
  float h = (ni + nj) + b1;
  h = fmaf(q[0], wq[k], h);
  h = fmaf(q[1], wq[H + k], h);
  h = fmaf(q[2], wq[2 * H + k], h);
  return fmaf(q[3], wq[3 * H + k], h);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Softmax weights over n entries s[0..n) with pair masks pm(idx), in
// place (s becomes alpha); returns sum alpha.  Called by a whole warp.
template <typename PM>
__device__ __forceinline__ float warp_softmax(float* s, int n, PM pm) {
  const int lane = threadIdx.x & 31;
  float mx = -FLT_MAX;
  for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[t]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float e = expf(s[t] - mx) * pm(t);
    s[t] = e;
    sum += e;
  }
  const float denom = fmaxf(warp_sum(sum), 1e-30f);
  float asum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float a = s[t] / denom;
    s[t] = a;
    asum += a;
  }
  return warp_sum(asum);
}

template <int A, bool kReduce>
__global__ void __launch_bounds__(kThreads) pair_attention_kernel(Args p) {
  extern __shared__ float smem[];
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
  float* frames = smem + weight_floats(H, Fo);
  const int per_frame = frame_floats(N, H, ld);
  const long long b0 = blockIdx.x * static_cast<long long>(T);

  // Per-frame regions.
  auto xyz = [&](int f) { return frames + f * per_frame; };
  auto msk = [&](int f) { return xyz(f) + 3 * N; };
  auto proj = [&](int f, int which) { return msk(f) + N + which * N * ld; };
  auto qpl = [&](int f) { return proj(f, 4); };  // 4 planes of NN
  auto S = [&](int f) { return qpl(f) + 4 * NN; };
  auto MU = [&](int f) { return S(f) + NN; };
  auto RS = [&](int f) { return MU(f) + NN; };
  auto Acc = [&](int f) { return RS(f) + NN; };  // (N, H)
  auto RSUM = [&](int f) { return Acc(f) + N * H; };

  const int tid = threadIdx.x;
  for (int t = tid; t < 4 * H; t += kThreads) {
    wqs[t] = p.wq_s[t];
    wqv[t] = p.wq_v[t];
  }
  for (int t = tid; t < H; t += kThreads) {
    b1s[t] = p.b1_s[t];
    w2s[t] = p.w2_s[t];
    b1v[t] = p.b1_v[t];
    lng[t] = p.ln_g[t];
    lnb[t] = p.ln_b[t];
  }
  for (int t = tid; t < H * Fo; t += kThreads) w2v[t] = p.w2_v[t];
  for (int t = tid; t < Fo; t += kThreads) b2v[t] = p.b2_v[t];
  if (tid == 0) b2s[0] = p.b2_s[0];

  const float* src[4] = {p.ni_s, p.nj_s, p.ni_v, p.nj_v};
  for (int f = 0; f < T; ++f) {
    const long long b = b0 + f;
    const bool live = b < p.B;
    for (int t = tid; t < 3 * N; t += kThreads)
      xyz(f)[t] = live ? p.coords[b * 3 * N + t] : 0.f;
    for (int t = tid; t < N; t += kThreads)
      msk(f)[t] = live ? p.mask[b * N + t] : 0.f;
    for (int w = 0; w < 4; ++w) {
      float* dst = proj(f, w);
      for (int t = tid; t < N * H; t += kThreads)
        dst[(t / H) * ld + t % H] =
            live ? src[w][b * static_cast<long long>(N) * H + t] : 0.f;
    }
  }
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

template <int A, bool kReduce>
cudaError_t launch(const Args& p, unsigned blocks, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(pair_attention_kernel<A, kReduce>, smem);
  if (err != cudaSuccess) return err;
  pair_attention_kernel<A, kReduce><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kReduce>
cudaError_t launch_act(int act, const Args& p, unsigned blocks, size_t smem,
                       cudaStream_t stream) {
  if (act == kRelu) return launch<kRelu, kReduce>(p, blocks, smem, stream);
  if (act == kTanh) return launch<kTanh, kReduce>(p, blocks, smem, stream);
  return launch<kLinear, kReduce>(p, blocks, smem, stream);
}

}  // namespace

// coords (B, N, 3); ni_s, nj_s, ni_v, nj_v (B, N, H); mask (B, N);
// wq_s, wq_v (4, H); b1_s, w2_s, b1_v, ln_g, ln_b (H,); b2_s (1,);
// w2_v (H, Fo); b2_v (Fo,); out (B, N, Fo), or (B, Fo) with reduce.
// act: 0 linear, 1 relu, 2 tanh.  Returns cudaErrorInvalidValue for a
// shape the kernel does not take (bad sizes, or one frame that does not
// fit shared memory).
extern "C" int pair_attention_launch(
    const float* coords, const float* ni_s, const float* nj_s,
    const float* ni_v, const float* nj_v, const float* mask,
    const float* wq_s, const float* b1_s, const float* w2_s,
    const float* b2_s, const float* wq_v, const float* b1_v,
    const float* ln_g, const float* ln_b, const float* w2_v,
    const float* b2_v, float* out, long long B, int N, int H, int Fo,
    int act, int reduce, float eps, cudaStream_t stream) {
  if (B < 0 || N < 1 || H < 1 || Fo < 1 || act < kLinear || act > kTanh)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = H | 1;
  auto bytes = [&](int frames) {
    return sizeof(float) *
           (static_cast<size_t>(weight_floats(H, Fo)) +
            static_cast<size_t>(frames) * frame_floats(N, H, ld));
  };
  int T = (kPairsPerBlock + N * N - 1) / (N * N);
  if (T > kMaxFrames) T = kMaxFrames;
  // Fewer frames per block where B is small, to keep kMinBlocks blocks.
  const long long spread = B / kMinBlocks;
  if (spread < T) T = spread > 1 ? static_cast<int>(spread) : 1;
  while (T > 1 && bytes(T) > static_cast<size_t>(kMaxDynamicSmem)) --T;
  const size_t smem = bytes(T);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Args p{coords, ni_s, nj_s, ni_v, nj_v, mask, wq_s, b1_s, w2_s, b2_s,
         wq_v, b1_v, ln_g, ln_b, w2_v, b2_v, out, B, N, H, Fo, T, ld, eps};
  const unsigned blocks = static_cast<unsigned>((B + T - 1) / T);
  const cudaError_t err =
      reduce ? launch_act<true>(act, p, blocks, smem, stream)
             : launch_act<false>(act, p, blocks, smem, stream);
  return static_cast<int>(err);
}
