// Cell-pair kernel: cell-list Lennard-Jones (with an optional Ewald
// real-space term, per-slot species and bonded exclusions), energy and
// gradient in one pass over each cell's (C, 27 C) pair block.
//
// Replaces vaemolsim_tpu/ops/cell_lj_pallas.py `_make_kernel` (launched by
// cell_pair_energy_force, called by potentials.lennard_jones_cell_neighbor).
// Per cell, for centre slot i and neighbour slot j (positions cxt / nxt,
// ids cid / nid, n_atoms = padding):
//     d     = x_i - x_j, wrapped once per axis: d -= L rint(d / L)
//     mask  = i < n && j < n && i != j && r^2 < rc^2 && j not excluded
//     r2s   = max(r^2, 1e-12); irr = 1 / max(r2s, 0.09 sigma^2)
//     u     = 4 eps (ir6^2 - ir6) [- the same at rc], w = du/dr / r
//     below 0.3 sigma: u += slope (r - 0.3 sigma), w = slope / r
//     charges: u += qq erfc(alpha r) / r,
//              w -= qq (erfc(alpha r) / r
//                       + 2 alpha / sqrt(pi) e^{-(alpha r)^2}) / r^2
// with sigma = (s_i + s_j) / 2, eps = se_i se_j for species.  Outputs: the
// cell's half-energy 0.5 sum u, and grad[i] = sum_j w d (cell layout).
// d and r^2 are rounded after every operation (no FMA contraction), as the
// plain PyTorch version rounds them, so both take the same pairs.
//
// Bound on the H100: float32 arithmetic.  Each cell reads ~7 words per
// neighbour slot (about 54 KB at C = 72 with every branch on) and does
// ~20 operations on each of its C * 27 C slots (wrap, r^2, mask) and ~40
// more (~70 with charges) on each pair inside the cutoff: ~30 M slots for
// 12 MB at the molecular shape, far above the card's ops-per-byte line.
// Design (simple first): one block of 12 warps per cell; the cell's 27 C
// neighbour positions, ids, sigma / sqrt(eps), charges and the centre
// slots' exclusion lists are staged in dynamic shared memory (opted in
// above 48 KB); a warp takes one centre slot at a time (C = 48 and 72 are
// multiples of 12) and its lanes stride over the 27 C neighbours, reducing
// the force with shuffles; the energy is reduced per warp, then per block
// in a fixed order.  No atomics.  Neither tensor cores nor TMA are used.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

struct Args {
  const float* cxt;  // (n_cells, 3, C)
  const float* nxt;  // (n_cells, 3, K)
  const int* cid;    // (n_cells, 1, C)
  const int* nid;    // (n_cells, 1, K)
  const float* csig;  // species: (n_cells, 1, C) / (n_cells, 1, K)
  const float* nsig;
  const float* cse;
  const float* nse;
  const float* cq;  // charges: (n_cells, 1, C) / (n_cells, 1, K)
  const float* nq;
  const int* excl;  // (n_cells, D, C), -1 padding
  float* e;         // (n_cells, 1, 1)
  float* grad;      // (n_cells, 3, C)
  int C, K, n_atoms, D, shift;
  float sigma, epsilon, rc2, inv_cut6, slope, slope_f, alpha;
  float box[3], inv_box[3];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One axis of the minimum-image displacement, rounded as the plain version
// rounds it: (c - n) - L * rint((c - n) * (1 / L)).
__device__ __forceinline__ float wrap(float c, float n, float L, float iL) {
  const float d = __fsub_rn(c, n);
  return __fsub_rn(d, __fmul_rn(L, rintf(__fmul_rn(d, iL))));
}

template <bool kSpecies, bool kCoulomb, bool kExcl>
__global__ void __launch_bounds__(kThreads) cell_lj_kernel(Args p) {
  extern __shared__ float smem[];
  const int C = p.C, K = p.K, D = kExcl ? p.D : 0;
  const long long cell = blockIdx.x;
  float* nx = smem;
  float* ny = nx + K;
  float* nz = ny + K;
  int* ids = reinterpret_cast<int*>(nz + K);
  float* nsig = reinterpret_cast<float*>(ids + K);
  float* nse = nsig + (kSpecies ? K : 0);
  float* nq = nse + (kSpecies ? K : 0);
  int* ex = reinterpret_cast<int*>(nq + (kCoulomb ? K : 0));
  float* red = reinterpret_cast<float*>(ex + D * C);

  const int tid = threadIdx.x;
  const float* gx = p.nxt + cell * 3 * K;
  for (int t = tid; t < K; t += kThreads) {
    nx[t] = gx[t];
    ny[t] = gx[K + t];
    nz[t] = gx[2 * K + t];
    ids[t] = p.nid[cell * K + t];
    if (kSpecies) {
      nsig[t] = p.nsig[cell * K + t];
      nse[t] = p.nse[cell * K + t];
    }
    if (kCoulomb) nq[t] = p.nq[cell * K + t];
  }
  if (kExcl)
    for (int t = tid; t < D * C; t += kThreads)
      ex[t] = p.excl[cell * D * C + t];
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int n = p.n_atoms;
  const float rc2 = p.rc2;
  const float L0 = p.box[0], L1 = p.box[1], L2 = p.box[2];
  const float i0 = p.inv_box[0], i1 = p.inv_box[1], i2 = p.inv_box[2];
  float e_acc = 0.f;
  for (int i = warp; i < C; i += kWarps) {
    const long long ci_at = cell * C + i;
    const int ci = p.cid[ci_at];
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (ci < n) {
      const float* cx = p.cxt + cell * 3 * C;
      const float x0 = cx[i], x1 = cx[C + i], x2 = cx[2 * C + i];
      const float csig = kSpecies ? p.csig[ci_at] : 0.f;
      const float cse = kSpecies ? p.cse[ci_at] : 0.f;
      const float cq = kCoulomb ? p.cq[ci_at] : 0.f;
      for (int j = lane; j < K; j += 32) {
        const int nj = ids[j];
        const float d0 = wrap(x0, nx[j], L0, i0);
        const float d1 = wrap(x1, ny[j], L1, i1);
        const float d2 = wrap(x2, nz[j], L2, i2);
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0),
                                             __fmul_rn(d1, d1)),
                                   __fmul_rn(d2, d2));
        bool m = nj < n && nj != ci && r2 < rc2;
        if (kExcl)
          for (int k = 0; k < D; ++k) m = m && ex[k * C + i] != nj;
        if (!m) continue;
        float sg, ep, slope;
        if (kSpecies) {
          sg = 0.5f * (csig + nsig[j]);
          ep = cse * nse[j];
        } else {
          sg = p.sigma;
          ep = p.epsilon;
        }
        const float sig2 = sg * sg;
        const float r2s = fmaxf(r2, 1e-12f);
        const float rcore2 = 0.09f * sig2;
        const float irr = 1.f / fmaxf(r2s, rcore2);
        const float ir2 = sig2 * irr;
        const float ir6 = ir2 * ir2 * ir2;
        float u = 4.f * ep * (ir6 * ir6 - ir6);
        if (p.shift) {
          const float s6 = sig2 * sig2 * sig2 * p.inv_cut6;
          u -= 4.f * ep * (s6 * s6 - s6);
        }
        float w = 24.f * ep * (ir6 - 2.f * ir6 * ir6) * irr;
        const float rs = rsqrtf(r2s);
        if (r2s < rcore2) {
          slope = kSpecies ? p.slope_f * ep * rsqrtf(sig2) : p.slope;
          u += slope * (r2s * rs - 0.3f * sg);
          w = slope * rs;
        }
        if (kCoulomb) {
          const float qq = cq * nq[j];
          const float ar = p.alpha * r2s * rs;
          const float erfc_t = erfcf(ar);
          const float exp_t = expf(-ar * ar);
          u += qq * erfc_t * rs;
          w -= qq * (erfc_t * rs + kTwoOverSqrtPi * p.alpha * exp_t) * rs * rs;
        }
        e_acc += u;
        g0 = fmaf(w, d0, g0);
        g1 = fmaf(w, d1, g1);
        g2 = fmaf(w, d2, g2);
      }
    }
    g0 = warp_sum(g0);
    g1 = warp_sum(g1);
    g2 = warp_sum(g2);
    if (lane == 0) {
      float* g = p.grad + cell * 3 * C;
      g[i] = g0;
      g[C + i] = g1;
      g[2 * C + i] = g2;
    }
  }
  e_acc = warp_sum(e_acc);
  if (lane == 0) red[warp] = e_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    p.e[cell] = 0.5f * s;
  }
}

template <bool kSpecies, bool kCoulomb, bool kExcl>
cudaError_t launch(const Args& p, unsigned blocks, cudaStream_t stream) {
  const size_t words = static_cast<size_t>(p.K) *
                           (4 + (kSpecies ? 2 : 0) + (kCoulomb ? 1 : 0)) +
                       (kExcl ? static_cast<size_t>(p.D) * p.C : 0) + kWarps;
  const size_t smem = 4 * words;
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(cell_lj_kernel<kSpecies, kCoulomb, kExcl>, smem);
  if (err != cudaSuccess) return err;
  cell_lj_kernel<kSpecies, kCoulomb, kExcl>
      <<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kSpecies, bool kCoulomb>
cudaError_t launch_excl(bool excl, const Args& p, unsigned blocks,
                        cudaStream_t stream) {
  return excl ? launch<kSpecies, kCoulomb, true>(p, blocks, stream)
              : launch<kSpecies, kCoulomb, false>(p, blocks, stream);
}

}  // namespace

// cxt (n_cells, 3, C), nxt (n_cells, 3, K) float32; cid (n_cells, 1, C),
// nid (n_cells, 1, K) int32 (n_atoms = padding); species blocks csig, cse
// (n_cells, 1, C) and nsig, nse (n_cells, 1, K), all null or none; charge
// blocks cq (n_cells, 1, C) and nq (n_cells, 1, K), both null or neither;
// excl (n_cells, D, C) int32 or null.  Outputs e (n_cells, 1, 1) and grad
// (n_cells, 3, C).  slope: the linear core's slope for the scalar
// sigma / epsilon; slope_f: its factor for species (slope_f eps / sigma).
// Returns cudaErrorInvalidValue for sizes the kernel does not take.
extern "C" int cell_lj_launch(
    const float* cxt, const float* nxt, const int* cid, const int* nid,
    const float* csig, const float* nsig, const float* cse, const float* nse,
    const float* cq, const float* nq, const int* excl, float* e, float* grad,
    long long n_cells, int C, int K, int n_atoms, int D, int shift,
    float sigma, float epsilon, float rc2, float inv_cut6, float slope,
    float slope_f, float alpha, float bx, float by, float bz, float ibx,
    float iby, float ibz, cudaStream_t stream) {
  const bool species = csig != nullptr;
  const bool coulomb = cq != nullptr;
  const bool ex = excl != nullptr && D > 0;
  if (n_cells < 0 || n_cells > 0x7fffffffLL || C < 1 || K < 1 || D < 0 ||
      species != (nsig != nullptr && cse != nullptr && nse != nullptr) ||
      coulomb != (nq != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  Args p{cxt, nxt, cid, nid, csig, nsig, cse, nse, cq, nq, excl, e, grad,
         C, K, n_atoms, D, shift, sigma, epsilon, rc2, inv_cut6, slope,
         slope_f, alpha, {bx, by, bz}, {ibx, iby, ibz}};
  const unsigned blocks = static_cast<unsigned>(n_cells);
  cudaError_t err;
  if (species)
    err = coulomb ? launch_excl<true, true>(ex, p, blocks, stream)
                  : launch_excl<true, false>(ex, p, blocks, stream);
  else
    err = coulomb ? launch_excl<false, true>(ex, p, blocks, stream)
                  : launch_excl<false, false>(ex, p, blocks, stream);
  return static_cast<int>(err);
}
