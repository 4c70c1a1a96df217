// Whole VAE-proposal kernel: one MC proposal per chain, in one pass.
//
// Replaces vaemolsim_tpu/mcmc/fused.py `_proposal_kernel` (reached from
// fused_vae_proposal / make_fused_vae_step).  For the flagship family
// (1-hidden-layer FCDeepNN normal encoder and decoder, 1-D latent,
// constant-spline MAF prior over a diagonal-normal base) it draws
//     z1 ~ q(.|x1),  z2 ~ p by the forward spline chain,  x2 ~ q(.|z2)
// and returns x2, the forward and reverse log-densities
//     fwd = log q(z1|x1) + log p(z2) + log q(x2|z2)
//     rev = log q(z2|x2) + log p(z1) + log q(x1|z1)
// and z1, z2.  Metropolis accept/reject stays outside.
//
// Bound on the H100: float32 FMAs (four MLP evaluations over H hidden
// units a chain; a chain moves only d_x + 4 floats of its own).  A design that
// streams each unit's weights from shared memory as separate 32-bit
// loads for one chain is bound by load issue instead, about one load
// per FMA.  Design:
// - Unit records.  Staging packs each hidden unit's weights into one
//   16-byte aligned record: encoder (b1, w1[0..d_x), w2[u][0..1]),
//   decoder (b1, w1, w2[u][0..2 d_x)), zero-padded to a multiple of 4
//   floats, so a unit costs 2 (encoder) and 2 (decoder) LDS.128 at
//   d_x = 2.  Units H..Hp-1 are zero records: act(0) = 0 adds nothing.
// - Register blocking over chains, lane groups over units.  A group of
//   R lanes carries R chains (chain i on thread i, so Philox keeps its
//   counter (chain, call)); lane g takes units g, g + R, ... for all R
//   chains, so each loaded weight feeds R FMAs, and the group's 2 or
//   2 d_x head sums are reduced by a shuffle butterfly (the same sum,
//   bit for bit, in every lane).  Inputs reach the group by shuffle.
//   (Groups of 2R lanes for R chains gained little at 10k chains on
//   the H100 and lost at 50k.)
// - Three passes, not four: q(.|z2) and q(.|z1) need only z2 and z1, so
//   one decoder pass takes both (2R rows on each record load), and the
//   forward and inverse spline chains between them run interleaved.
// - Per-chain scalar work (Philox, Box-Muller, softplus, splines,
//   log-densities) runs one chain a lane.  No lane returns early: lanes
//   past n compute on zeros and store nothing.
// - Spline tables once per block: the prior's B rows become knot tables
//   (rqs.cuh), a thread a knot, after staging; each of the 2B walks a
//   chain is a binary search and the unchanged rqs_apply.
// - The chain's input loads are issued before the staging's, and the
//   Philox draw runs before the staging barrier.  (Staging the records
//   by 4-byte cp.async was slower on the H100 than plain loads and
//   float4 stores.)
// The plan (R, threads a block, blocks, shared bytes) comes from
// mcmc/fused.py `kernel_plan`; the launch only checks it.
// Normals: Philox4x32-10 (key = the two seed words, counter = (chain,
// draw, 0, 0)) through Box-Muller on the top 24 bits mapped into (0, 1),
// so log never sees 0.
#include <cuda_pipeline.h>

#include <cstdint>

#include "common.cuh"
#include "rqs.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr float kF32Eps = 1.1920928955078125e-07f;

enum Act { kTanh = 1, kRelu = 2 };

struct Proposal {
  const float* x1;     // (n, d_x)
  const int* seed;     // (2,) Philox key words
  const float* noise;  // (n, 2 + d_x) standard normals, or null
  const float* ew1; const float* eb1; const float* ew2; const float* eb2;
  const float* dw1; const float* db1; const float* dw2; const float* db2;
  const float* sw; const float* sh; const float* ss;  // (B,K),(B,K),(B,K-1)
  const float* base;   // (2,) loc, scale
  float* x2; float* fwd; float* rev; float* z1; float* z2;
  long long n;
  int H, Hp, B, K, enc_act, dec_act;
  float range_min;
};

// Compile-time shape of one d_x: R chains a lane group, record widths
// in floats.
template <int DX>
struct Shape {
  static constexpr int R = DX <= 4 ? 4 : 2;
  static constexpr int kEnc = (3 + DX + 3) & ~3;
  static constexpr int kDec = (2 + 2 * DX + 3) & ~3;
};

// Hidden units padded to a multiple of 2R (a lane's last step takes two).
__host__ __device__ inline int padded_units(int H, int R) {
  return (H + 2 * R - 1) / (2 * R) * (2 * R);
}

// Shared floats: unit records, knot tables, raw spline rows, biases.
template <int DX>
__host__ __device__ inline long long smem_floats(int H, int B, int K) {
  using S = Shape<DX>;
  return static_cast<long long>(padded_units(H, S::R)) * (S::kEnc + S::kDec) +
         static_cast<long long>(B) * (rqs_table_floats(K) + 3 * K - 1) + 2 +
         2 * DX;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  // Top 24 bits -> u in [2^-25, 1 - 2^-25].
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f +
         2.98023223876953125e-08f;
}

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float normal_lp(float v, float loc, float scale) {
  const float z = (v - loc) / scale;
  return -0.5f * z * z - logf(scale) - kHalfLog2Pi;
}

// Chain i's N standard normals.  Word w of its stream is lane w % 4 of
// Philox call (i, w / 4); u1 of pair j is word j, u2 is word P + j.
template <int N>
__device__ __forceinline__ void draw_normals(long long i, const int* seed,
                                             float (&eps)[N]) {
  constexpr int P = (N + 1) / 2;
  constexpr int kCalls = (2 * P + 3) / 4;
  uint32_t words[4 * kCalls];
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
#pragma unroll
  for (int c = 0; c < kCalls; ++c) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(c), 0u,
                   0u), k0, k1);
    words[4 * c] = r.x;
    words[4 * c + 1] = r.y;
    words[4 * c + 2] = r.z;
    words[4 * c + 3] = r.w;
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float rad = sqrtf(-2.f * logf(to_unit(words[j])));
    const float theta = kTwoPi * to_unit(words[P + j]);
    eps[j] = rad * cosf(theta);
    if (P + j < N) eps[P + j] = rad * sinf(theta);
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float a) {
  return ACT == kRelu ? fmaxf(a, 0.f) : tanhf(a);
}

// U hidden units u, u + R, ..., u + (U-1) R into M rows' head sums (a
// row: one chain's input; rows share the records): all U records are
// loaded first, then each unit's terms are added in order.
template <int U, int M, int NIN, int NOUT, int REC, int R, int ACT>
__device__ __forceinline__ void units(const float (&in)[M][NIN],
                                      const float* __restrict__ recs, int u,
                                      float (&acc)[M][NOUT]) {
  float wv[U][REC];
#pragma unroll
  for (int m = 0; m < U; ++m) {
    const float4* rec =
        reinterpret_cast<const float4*>(recs + (u + m * R) * REC);
#pragma unroll
    for (int q = 0; q < REC / 4; ++q) {
      const float4 v = rec[q];
      wv[m][4 * q] = v.x;
      wv[m][4 * q + 1] = v.y;
      wv[m][4 * q + 2] = v.z;
      wv[m][4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int m = 0; m < U; ++m) {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      float a = wv[m][0];
#pragma unroll
      for (int i = 0; i < NIN; ++i) a = fmaf(in[r][i], wv[m][1 + i], a);
      a = activate<ACT>(a);
#pragma unroll
      for (int j = 0; j < NOUT; ++j)
        acc[r][j] = fmaf(a, wv[m][1 + NIN + j], acc[r][j]);
    }
  }
}

// Units a lane takes at a step: as many records as keep the registers
// free of spills at every d_x.
template <int REC>
__host__ __device__ constexpr int step_units() {
  return REC <= 8 ? 8 : REC <= 12 ? 4 : 2;
}

// One hidden layer + linear head over M rows of this lane's group (R
// chains, each with one or more inputs): in[m] is row m's input, recs
// the unit records (REC floats each, Hp units, Hp a multiple of 2R).
// Lane g of the group's R sums units g, g + R, ... in order, step_units
// at a step and 2 in the tail; the butterfly over the R lanes adds their
// partial sums, the same way in every lane; out[m][j] = sum + b2[j].
template <int M, int NIN, int NOUT, int REC, int R, int ACT>
__device__ __forceinline__ void mlp_pass(const float (&in)[M][NIN],
                                         const float* __restrict__ recs,
                                         int Hp, const float* b2,
                                         float (&out)[M][NOUT]) {
  static_assert(1 + NIN + NOUT <= REC, "record too narrow");
  constexpr int U = step_units<REC>();
  float acc[M][NOUT];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int j = 0; j < NOUT; ++j) acc[r][j] = 0.f;
  int u = threadIdx.x % R;
  for (; u + (U - 1) * R < Hp; u += U * R)
    units<U, M, NIN, NOUT, REC, R, ACT>(in, recs, u, acc);
  for (; u < Hp; u += 2 * R)
    units<2, M, NIN, NOUT, REC, R, ACT>(in, recs, u, acc);
#pragma unroll
  for (int off = R / 2; off >= 1; off /= 2)
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int j = 0; j < NOUT; ++j)
        acc[r][j] += __shfl_xor_sync(kFull, acc[r][j], off);
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int j = 0; j < NOUT; ++j) out[r][j] = acc[r][j] + b2[j];
}

template <int M, int NIN, int NOUT, int REC, int R>
__device__ __forceinline__ void mlp(const float (&in)[M][NIN],
                                    const float* recs, int Hp, int act,
                                    const float* b2, float (&out)[M][NOUT]) {
  if (act == kRelu)
    mlp_pass<M, NIN, NOUT, REC, R, kRelu>(in, recs, Hp, b2, out);
  else
    mlp_pass<M, NIN, NOUT, REC, R, kTanh>(in, recs, Hp, b2, out);
}

// Rows SET * R + r = chain r's v (this group's lanes r = 0..R-1).
template <int SET, int R, int N, int M>
__device__ __forceinline__ void gather(const float (&v)[N],
                                       float (&in)[M][N]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < N; ++i)
      in[SET * R + r][i] = __shfl_sync(kFull, v[i], r, R);
}

// This lane's chain's row of set SET of a group result.
template <int SET, int R, int N, int M>
__device__ __forceinline__ void mine(const float (&all)[M][N],
                                     float (&v)[N]) {
  const int g = threadIdx.x % R;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j] = all[SET * R][j];
#pragma unroll
    for (int r = 1; r < R; ++r) v[j] = g == r ? all[SET * R + r][j] : v[j];
  }
}

// The block's shared operands.  The B raw spline rows and the head
// biases go by cp.async; the unit records by plain loads, S units a
// thread at a time (thread t takes units t, t + T, ...; the loads of
// one source array are coalesced), all of a step's loads issued before
// its float4 stores, so that one round trip to L2 covers them.
template <int DX>
__device__ __forceinline__ void stage(const Proposal& p, float* enc,
                                      float* dec, float* raw, float* bias) {
  using S = Shape<DX>;
  constexpr int kSteps = 64 / (S::kEnc + S::kDec) > 1
                             ? 64 / (S::kEnc + S::kDec) : 1;
  const int H = p.H, Hp = p.Hp, B = p.B, K = p.K;
  const int t = threadIdx.x, T = blockDim.x;
  const int row = 3 * K - 1;
  for (int q = t; q < B * row; q += T) {
    const int b = q / row, c = q - b * row;
    __pipeline_memcpy_async(raw + q,
                            c < K       ? p.sw + b * K + c
                            : c < 2 * K ? p.sh + b * K + (c - K)
                                        : p.ss + b * (K - 1) + (c - 2 * K),
                            sizeof(float));
  }
  for (int q = t; q < 2 + 2 * DX; q += T)
    __pipeline_memcpy_async(bias + q, q < 2 ? p.eb2 + q : p.db2 + (q - 2),
                            sizeof(float));
  __pipeline_commit();
  for (int u0 = t; u0 < Hp; u0 += kSteps * T) {
    float e[kSteps][S::kEnc], d[kSteps][S::kDec];
#pragma unroll
    for (int m = 0; m < kSteps; ++m) {
      const int u = u0 + m * T;
#pragma unroll
      for (int c = 0; c < S::kEnc; ++c) e[m][c] = 0.f;
#pragma unroll
      for (int c = 0; c < S::kDec; ++c) d[m][c] = 0.f;
      if (u < H) {
        e[m][0] = __ldg(p.eb1 + u);
#pragma unroll
        for (int i = 0; i < DX; ++i) e[m][1 + i] = __ldg(p.ew1 + i * H + u);
        e[m][1 + DX] = __ldg(p.ew2 + 2 * u);
        e[m][2 + DX] = __ldg(p.ew2 + 2 * u + 1);
        d[m][0] = __ldg(p.db1 + u);
        d[m][1] = __ldg(p.dw1 + u);
#pragma unroll
        for (int j = 0; j < 2 * DX; ++j)
          d[m][2 + j] = __ldg(p.dw2 + 2 * DX * u + j);
      }
    }
#pragma unroll
    for (int m = 0; m < kSteps; ++m) {
      const int u = u0 + m * T;
      if (u >= Hp) break;
#pragma unroll
      for (int q = 0; q < S::kEnc / 4; ++q)
        reinterpret_cast<float4*>(enc + u * S::kEnc)[q] = make_float4(
            e[m][4 * q], e[m][4 * q + 1], e[m][4 * q + 2], e[m][4 * q + 3]);
#pragma unroll
      for (int q = 0; q < S::kDec / 4; ++q)
        reinterpret_cast<float4*>(dec + u * S::kDec)[q] = make_float4(
            d[m][4 * q], d[m][4 * q + 1], d[m][4 * q + 2], d[m][4 * q + 3]);
    }
  }
}

template <int DX>
__global__ void __launch_bounds__(kMaxThreads)
    vae_proposal_kernel(Proposal p) {
  using S = Shape<DX>;
  constexpr int R = S::R;
  constexpr int kNoise = 2 + DX;  // z1, base u, x2
  extern __shared__ float4 smem4[];
  const int Hp = p.Hp, B = p.B, K = p.K;
  const int TF = rqs_table_floats(K);
  float* enc = reinterpret_cast<float*>(smem4);  // Hp x kEnc
  float* dec = enc + Hp * S::kEnc;               // Hp x kDec
  float* tabs = dec + Hp * S::kDec;              // B x TF
  float* raw = tabs + B * TF;                    // B x (3K-1): w, h, s
  float* bias = raw + B * (3 * K - 1);           // eb2 (2), db2 (2 DX)

  // This chain's inputs first, so their loads overlap the staging's.
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const bool live = i < p.n;
  float x1[DX], eps[kNoise];
#pragma unroll
  for (int j = 0; j < DX; ++j) x1[j] = live ? p.x1[i * DX + j] : 0.f;
  if (p.noise != nullptr) {
#pragma unroll
    for (int j = 0; j < kNoise; ++j)
      eps[j] = live ? p.noise[i * kNoise + j] : 0.f;
  }
  const float base_loc = p.base[0], base_scale = p.base[1];
  stage<DX>(p, enc, dec, raw, bias);
  if (p.noise == nullptr) draw_normals<kNoise>(i, p.seed, eps);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int q = threadIdx.x; q < B * (K + 1); q += blockDim.x) {
    const int b = q / (K + 1);
    const float* row = raw + b * (3 * K - 1);
    rqs_table_knot(row, row + K, row + 2 * K, K, p.range_min, q - b * (K + 1),
                   tabs + b * TF);
  }

  // z1 ~ q(.|x1).
  float xin[R][DX], head_e[R][2], e[2];
  gather<0, R>(x1, xin);
  mlp<R, DX, 2, S::kEnc, R>(xin, enc, Hp, p.enc_act, bias, head_e);
  mine<0, R>(head_e, e);
  const float mu = e[0], sig = softplus(e[1]) + kF32Eps;
  const float z1 = mu + sig * eps[0];
  const float log_z1_x1 = normal_lp(z1, mu, sig);
  __syncthreads();  // the knot tables

  // z2 ~ p: the base draw pushed forward through blocks 0..B-1; and z1
  // pulled back through blocks B-1..0 for log p(z1).  The two chains of
  // spline walks are independent and run interleaved.
  const float u = base_loc + base_scale * eps[1];
  float zf = u, zi = z1, fldj = 0.f, ildj = 0.f;
  for (int b = 0; b < B; ++b) {
    float lf, li;
    rqs_eval_table<false>(zf, tabs + b * TF, K, p.range_min, zf, lf);
    rqs_eval_table<true>(zi, tabs + (B - 1 - b) * TF, K, p.range_min, zi, li);
    fldj += lf;
    ildj += li;
  }
  const float z2 = zf;
  const float log_z2 = normal_lp(u, base_loc, base_scale) - fldj;
  const float log_z1 = normal_lp(zi, base_loc, base_scale) + ildj;

  // x2 ~ q(.|z2) and log q(x1|z1): one decoder pass, rows r for z2 and
  // R + r for z1, sharing each record load.
  float zv[1] = {z2}, zin[2 * R][1], head_d[2 * R][2 * DX], d[2 * DX];
  gather<0, R>(zv, zin);
  zv[0] = z1;
  gather<1, R>(zv, zin);
  mlp<2 * R, 1, 2 * DX, S::kDec, R>(zin, dec, Hp, p.dec_act, bias + 2,
                                    head_d);
  mine<0, R>(head_d, d);
  float x2[DX];
  float log_x2_z2 = 0.f;
#pragma unroll
  for (int j = 0; j < DX; ++j) {
    const float m = d[2 * j], s = softplus(d[2 * j + 1]) + kF32Eps;
    x2[j] = m + s * eps[2 + j];
    log_x2_z2 += normal_lp(x2[j], m, s);
  }
  mine<1, R>(head_d, d);
  float log_x1_z1 = 0.f;
#pragma unroll
  for (int j = 0; j < DX; ++j)
    log_x1_z1 += normal_lp(x1[j], d[2 * j], softplus(d[2 * j + 1]) + kF32Eps);

  // log q(z2|x2).
  gather<0, R>(x2, xin);
  mlp<R, DX, 2, S::kEnc, R>(xin, enc, Hp, p.enc_act, bias, head_e);
  mine<0, R>(head_e, e);
  const float log_z2_x2 = normal_lp(z2, e[0], softplus(e[1]) + kF32Eps);

  if (live) {
#pragma unroll
    for (int j = 0; j < DX; ++j) p.x2[i * DX + j] = x2[j];
    p.fwd[i] = log_z1_x1 + log_z2 + log_x2_z2;
    p.rev[i] = log_z2_x2 + log_z1 + log_x1_z1;
    p.z1[i] = z1;
    p.z2[i] = z2;
  }
}

template <int DX>
int launch(Proposal p, int R, int threads, long long blocks, long long smem,
           cudaStream_t stream) {
  using S = Shape<DX>;
  const long long want = sizeof(float) * smem_floats<DX>(p.H, p.B, p.K);
  if (R != S::R || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks != (p.n + threads - 1) / threads ||
      smem != want || want > kMaxDynamicSmem || p.H < 1 || p.B < 0 ||
      p.K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  p.Hp = padded_units(p.H, S::R);
  if (p.n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = allow_smem(vae_proposal_kernel<DX>, want);
  if (err != cudaSuccess) return static_cast<int>(err);
  vae_proposal_kernel<DX><<<static_cast<unsigned>(blocks), threads, want,
                            stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d_z is 1 and d_x is 1..8 (the instantiations below; the Python
// wrapper's MAX_DX).  Weights in (in, out) layout: ew1 (d_x, H), ew2 (H, 2),
// dw1 (1, H), dw2 (H, 2 d_x); raw head outputs interleave (loc,
// raw_scale) per DOF.  noise may be null (in-kernel Philox).  Activation
// codes: 1 tanh, 2 relu.  The plan (mcmc/fused.py `kernel_plan`) is
// checked, not chosen: R chains and lanes a group, 4 for d_x <= 4 and 2
// above; threads a multiple of 32 in [32, 256]; blocks covering n a
// chain a thread; the shared bytes this shape needs.
extern "C" int vae_proposal_launch(
    const float* x1, const int* seed, const float* noise, const float* ew1,
    const float* eb1, const float* ew2, const float* eb2, const float* dw1,
    const float* db1, const float* dw2, const float* db2, const float* sw,
    const float* sh, const float* ss, const float* base, float* x2,
    float* fwd, float* rev, float* z1, float* z2, long long n, int d_x,
    int H, int B, int K, int enc_act, int dec_act, float range_min, int R,
    int threads, long long blocks, long long smem, cudaStream_t stream) {
  const Proposal p{x1,  seed, noise, ew1, eb1, ew2, eb2, dw1,     db1,
                   dw2, db2,  sw,    sh,  ss,  base, x2, fwd,     rev,
                   z1,  z2,   n,     H,   0,   B,    K,  enc_act, dec_act,
                   range_min};
  switch (d_x) {
    case 1: return launch<1>(p, R, threads, blocks, smem, stream);
    case 2: return launch<2>(p, R, threads, blocks, smem, stream);
    case 3: return launch<3>(p, R, threads, blocks, smem, stream);
    case 4: return launch<4>(p, R, threads, blocks, smem, stream);
    case 5: return launch<5>(p, R, threads, blocks, smem, stream);
    case 6: return launch<6>(p, R, threads, blocks, smem, stream);
    case 7: return launch<7>(p, R, threads, blocks, smem, stream);
    case 8: return launch<8>(p, R, threads, blocks, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
