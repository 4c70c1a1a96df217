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
// Bound on the H100: arithmetic and launch count, not memory.  A chain
// reads d_x floats and writes d_x + 4; its work is four MLP passes over
// H hidden units plus 2B spline walks.  Design: one thread per chain;
// the encoder and decoder weights (~2.4k floats at H = 200) and the
// B x (3K-1) spline tables are staged into shared memory once per block
// and read as warp-wide broadcasts; each MLP pass streams over the H
// hidden units and accumulates its 2 or 2*d_x head outputs in
// registers, so the hidden vector is never stored; splines use rqs.cuh.
// Normals come from Philox4x32-10 written into the kernel (key = the two
// seed words, counter = (chain, draw, 0, 0)) through Box-Muller on the
// top 24 bits mapped into (0, 1), so log never sees 0.
#include <cstdint>

#include "common.cuh"
#include "rqs.cuh"

namespace {

constexpr int kThreads = 128;
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
  int H, B, K, enc_act, dec_act;
  float range_min;
};

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

// One-hidden-layer trunk + linear head, hidden units streamed.
template <int NIN, int NOUT>
__device__ __forceinline__ void mlp(const float (&in)[NIN],
                                    const float* w1, const float* b1,
                                    const float* w2, const float* b2, int H,
                                    int act, float (&out)[NOUT]) {
  float acc[NOUT];
#pragma unroll
  for (int j = 0; j < NOUT; ++j) acc[j] = 0.f;
  for (int u = 0; u < H; ++u) {
    float a = b1[u];
#pragma unroll
    for (int i = 0; i < NIN; ++i) a += in[i] * w1[i * H + u];
    a = act == kRelu ? fmaxf(a, 0.f) : tanhf(a);
#pragma unroll
    for (int j = 0; j < NOUT; ++j) acc[j] = fmaf(a, w2[u * NOUT + j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < NOUT; ++j) out[j] = acc[j] + b2[j];
}

template <int DX>
__global__ void __launch_bounds__(kThreads)
    vae_proposal_kernel(Proposal p) {
  constexpr int kNoise = 2 + DX;              // z1, base u, x2
  constexpr int kPairs = (kNoise + 1) / 2;
  extern __shared__ float smem[];
  const int H = p.H, B = p.B, K = p.K;
  float* ew1 = smem;                 // (DX, H)
  float* eb1 = ew1 + DX * H;         // (H)
  float* ew2 = eb1 + H;              // (H, 2)
  float* eb2 = ew2 + 2 * H;          // (2)
  float* dw1 = eb2 + 2;              // (1, H)
  float* db1 = dw1 + H;              // (H)
  float* dw2 = db1 + H;              // (H, 2 DX)
  float* db2 = dw2 + 2 * DX * H;     // (2 DX)
  float* sw = db2 + 2 * DX;          // (B, K)
  float* sh = sw + B * K;            // (B, K)
  float* ss = sh + B * K;            // (B, K-1)
  struct Seg { const float* src; float* dst; int len; };
  const Seg segs[] = {{p.ew1, ew1, DX * H}, {p.eb1, eb1, H},
                      {p.ew2, ew2, 2 * H},  {p.eb2, eb2, 2},
                      {p.dw1, dw1, H},      {p.db1, db1, H},
                      {p.dw2, dw2, 2 * DX * H}, {p.db2, db2, 2 * DX},
                      {p.sw, sw, B * K},    {p.sh, sh, B * K},
                      {p.ss, ss, B * (K - 1)}};
  for (const Seg& s : segs)
    for (int i = threadIdx.x; i < s.len; i += blockDim.x) s.dst[i] = s.src[i];
  __syncthreads();

  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= p.n) return;

  float eps[kNoise];
  if (p.noise != nullptr) {
#pragma unroll
    for (int j = 0; j < kNoise; ++j) eps[j] = p.noise[i * kNoise + j];
  } else {
    // Word w of this chain's stream: Philox call w / 4, lane w % 4;
    // u1 of pair j is word j, u2 is word kPairs + j.
    constexpr int kCalls = (2 * kPairs + 3) / 4;
    uint32_t words[4 * kCalls];
    const uint32_t k0 = static_cast<uint32_t>(p.seed[0]);
    const uint32_t k1 = static_cast<uint32_t>(p.seed[1]);
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
    for (int j = 0; j < kPairs; ++j) {
      const float rad = sqrtf(-2.f * logf(to_unit(words[j])));
      const float theta = kTwoPi * to_unit(words[kPairs + j]);
      eps[j] = rad * cosf(theta);
      if (kPairs + j < kNoise) eps[kPairs + j] = rad * sinf(theta);
    }
  }

  float x1[DX];
#pragma unroll
  for (int j = 0; j < DX; ++j) x1[j] = p.x1[i * DX + j];
  const float base_loc = p.base[0], base_scale = p.base[1];

  // z1 ~ q(.|x1).
  float raw_e[2];
  mlp<DX, 2>(x1, ew1, eb1, ew2, eb2, H, p.enc_act, raw_e);
  const float mu = raw_e[0], sig = softplus(raw_e[1]) + kF32Eps;
  const float z1 = mu + sig * eps[0];
  const float log_z1_x1 = normal_lp(z1, mu, sig);

  // z2 ~ p: base draw pushed forward through blocks 0..B-1.
  const float u = base_loc + base_scale * eps[1];
  float cur = u, fldj = 0.f;
  for (int b = 0; b < B; ++b) {
    float l;
    rqs_eval<false>(cur, sw + b * K, sh + b * K, ss + b * (K - 1), K,
                    p.range_min, cur, l);
    fldj += l;
  }
  const float z2 = cur;
  const float log_z2 = normal_lp(u, base_loc, base_scale) - fldj;

  // x2 ~ q(.|z2).
  float zin[1] = {z2};
  float raw_d[2 * DX];
  mlp<1, 2 * DX>(zin, dw1, db1, dw2, db2, H, p.dec_act, raw_d);
  float x2[DX];
  float log_x2_z2 = 0.f;
#pragma unroll
  for (int j = 0; j < DX; ++j) {
    const float m = raw_d[2 * j], s = softplus(raw_d[2 * j + 1]) + kF32Eps;
    x2[j] = m + s * eps[2 + j];
    log_x2_z2 += normal_lp(x2[j], m, s);
  }

  // Reverse: log q(z2|x2), log p(z1), log q(x1|z1).
  mlp<DX, 2>(x2, ew1, eb1, ew2, eb2, H, p.enc_act, raw_e);
  const float log_z2_x2 =
      normal_lp(z2, raw_e[0], softplus(raw_e[1]) + kF32Eps);

  cur = z1;
  float ildj = 0.f;
  for (int b = B - 1; b >= 0; --b) {
    float l;
    rqs_eval<true>(cur, sw + b * K, sh + b * K, ss + b * (K - 1), K,
                   p.range_min, cur, l);
    ildj += l;
  }
  const float log_z1 = normal_lp(cur, base_loc, base_scale) + ildj;

  zin[0] = z1;
  mlp<1, 2 * DX>(zin, dw1, db1, dw2, db2, H, p.dec_act, raw_d);
  float log_x1_z1 = 0.f;
#pragma unroll
  for (int j = 0; j < DX; ++j)
    log_x1_z1 += normal_lp(x1[j], raw_d[2 * j],
                           softplus(raw_d[2 * j + 1]) + kF32Eps);

#pragma unroll
  for (int j = 0; j < DX; ++j) p.x2[i * DX + j] = x2[j];
  p.fwd[i] = log_z1_x1 + log_z2 + log_x2_z2;
  p.rev[i] = log_z2_x2 + log_z1 + log_x1_z1;
  p.z1[i] = z1;
  p.z2[i] = z2;
}

template <int DX>
int launch(const Proposal& p, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(DX) * p.H + p.H + 2 * p.H + 2 +
                        p.H + p.H + 2 * DX * p.H + 2 * DX +
                        static_cast<size_t>(p.B) * (3 * p.K - 1);
  const size_t smem = floats * sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = allow_smem(vae_proposal_kernel<DX>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((p.n + kThreads - 1) / kThreads);
  vae_proposal_kernel<DX><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d_z is 1 and d_x is 1..8 (the instantiations below; the Python
// wrapper's MAX_DX).  Weights in (in, out) layout: ew1 (d_x, H), ew2 (H, 2),
// dw1 (1, H), dw2 (H, 2 d_x); raw head outputs interleave (loc,
// raw_scale) per DOF.  noise may be null (in-kernel Philox).  Activation
// codes: 1 tanh, 2 relu.
extern "C" int vae_proposal_launch(
    const float* x1, const int* seed, const float* noise, const float* ew1,
    const float* eb1, const float* ew2, const float* eb2, const float* dw1,
    const float* db1, const float* dw2, const float* db2, const float* sw,
    const float* sh, const float* ss, const float* base, float* x2,
    float* fwd, float* rev, float* z1, float* z2, long long n, int d_x,
    int H, int B, int K, int enc_act, int dec_act, float range_min,
    cudaStream_t stream) {
  const Proposal p{x1,  seed, noise, ew1, eb1, ew2, eb2, dw1,     db1,
                   dw2, db2,  sw,    sh,  ss,  base, x2, fwd,     rev,
                   z1,  z2,   n,     H,   B,   K,    enc_act, dec_act,
                   range_min};
  switch (d_x) {
    case 1: return launch<1>(p, stream);
    case 2: return launch<2>(p, stream);
    case 3: return launch<3>(p, stream);
    case 4: return launch<4>(p, stream);
    case 5: return launch<5>(p, stream);
    case 6: return launch<6>(p, stream);
    case 7: return launch<7>(p, stream);
    case 8: return launch<8>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
