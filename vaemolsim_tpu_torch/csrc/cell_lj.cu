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
// Bound on the H100: the least float32 work (a cheap test on every
// occupied (centre, neighbour) slot: wrap, r^2, cutoff, ids, exclusions;
// an expensive one on each pair inside the cutoff: LJ, core, and with
// charges erfcf and expf) and the bytes of the gathered blocks take about
// the same least time, 4.1 and 2.7 µs at the molecular shape, 2.0 and 2.3
// for the LJ liquid (chip_smoke.py's count).  What the card spends is
// issued instructions: ~30 a slot tested, ~110 a pair.  Only about a
// tenth of the occupied slots lie inside the cutoff, and about half of the
// C x 27 C slots are padding.  The first design ran the expensive branch
// for a whole warp whenever one lane's slot passed (one or two lanes
// busy), scanned the padding, and ran one block per cell: 216 blocks on
// 132 SMs.
//
// Design:
// - Occupied slots only.  A block compacts the cell's real neighbour slots
//   (id < n) into shared memory, in slot order (a ballot count per chunk of
//   32 slots, a scan, then cp.async copies, all in flight at once), as one
//   float4 (x, y, z, id) per slot, and lists its real centre slots the
//   same way.  Padding is never visited, wherever the build put it.
// - Chunks pruned by distance.  Each chunk of 32 compacted slots gets its
//   bounding box; a centre's lanes test 32 boxes at once and the warp walks
//   only the chunks whose box lies within the cutoff plus a margin (1e-3
//   of it and 1e-4 of the widest box edge), far above the float rounding
//   of a pair's r^2, so no pair the plain version takes is skipped.
// - No divergence on the expensive branch.  A warp takes one centre at a
//   time; its lanes test the 32 slots of a chunk at once and append the
//   passing ones to a per-warp queue in shared memory (ballot + popc, lane
//   order, so the order is fixed).  Whenever 32 are queued, all 32 lanes
//   evaluate one pair each; the rest are evaluated at the end of the centre.
// - Work in flight.  A cell's centres are split over a cluster of S blocks
//   (S chosen by the caller, ops/cell_lj.py `cluster_split`, from the mean
//   occupancy; at most 8), 8 warps each; every block
//   stages the cell's neighbours.  Each block sums its warps' energies in
//   warp order, and block 0 sums the cluster's partials in rank order
//   through distributed shared memory.  No atomics: every sum has one
//   order.  Neither tensor cores nor TMA are used.
// Measured on the H100 at the molecular path's shape (216 cells of 72
// slots, 3 blocks a cell, 42 KB of shared memory and 48 registers a
// thread, 5 blocks an SM; chip_turns.py's phase split): staging, the
// chunk boxes and the cluster sums a third of the time, the cheap pass
// about half, the expensive branch a fifth.  What bounds it now is issue
// rate at low efficiency: short phases between barriers, and warps of a
// block left with one centre while others have two.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// A warp's queue: up to 31 carried over plus 32 new entries.
constexpr int kQueue = 64;
constexpr int kMaxSplit = 8;        // the portable cluster size
constexpr int kUnroll = 8;          // slot loads in flight per thread
constexpr int kMaxK = 64 * kThreads;  // occupancy bits per thread: 64
constexpr unsigned kFull = 0xffffffffu;
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
  int C, K, n_atoms, D, shift, split;  // split: blocks per cell
  float sigma, epsilon, rc2, inv_cut6, slope, slope_f, alpha;
  float box[3], inv_box[3];
};

// Offsets (in 4-byte words) of the dynamic shared memory's regions.
struct Layout {
  int nsig, nse, nq, ex, cen, cnt, box, queue, red, words;
};

__host__ __device__ inline Layout layout(int K, int C, int D, bool species,
                                         bool coulomb) {
  Layout l;
  int o = 4 * K;  // (x, y, z, id) per slot
  l.nsig = o;
  o += species ? K : 0;
  l.nse = o;
  o += species ? K : 0;
  l.nq = o;
  o += coulomb ? K : 0;
  l.ex = o;
  o += D * C;
  l.cen = o;
  o += C;
  l.cnt = o;  // per-chunk counts / offsets, then M and the centre count
  o += kWarps * ((K + kThreads - 1) / kThreads) + 2;
  o = (o + 3) & ~3;  // float4-aligned
  l.box = o;  // per chunk of 32 compacted slots: centre, half-extent
  o += 8 * ((K + 31) / 32);
  l.queue = o;
  o += kWarps * kQueue;
  l.red = o;  // per-warp energies, then the block's
  o += kWarps + 1;
  l.words = o;
  return l;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.split;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long cell = blockIdx.x / S;
  const int C = p.C, K = p.K, D = kExcl ? p.D : 0, n = p.n_atoms;
  const Layout lay = layout(K, C, D, kSpecies, kCoulomb);
  float4* pos = reinterpret_cast<float4*>(smem);  // id in .w, as bits
  float* nsig = smem + lay.nsig;
  float* nse = smem + lay.nse;
  float* nq = smem + lay.nq;
  int* ex = reinterpret_cast<int*>(smem + lay.ex);
  int* cen = reinterpret_cast<int*>(smem + lay.cen);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);
  float4* box = reinterpret_cast<float4*>(smem + lay.box);
  int* queue = reinterpret_cast<int*>(smem + lay.queue);
  float* red = smem + lay.red;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int* gid = p.nid + cell * K;
  const int* gcid = p.cid + cell * C;

  // Count the occupied neighbour slots of each chunk of 32 (thread tid
  // reads slots tid + kThreads r, chunk warp + kWarps r, its loads issued
  // kUnroll at a time and its occupancy kept as bits); list the occupied
  // centre slots in slot order; stage the exclusion lists.
  const int R = (K + kThreads - 1) / kThreads;
  const int nch = kWarps * R;  // chunks of 32 slots, the last ones empty
  unsigned long long real_bits = 0ull;
  for (int r0 = 0; r0 < R; r0 += kUnroll) {
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = tid + kThreads * (r0 + u);
      id[u] = r0 + u < R && t < K ? gid[t] : n;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + u < R) {
        const unsigned b = __ballot_sync(kFull, id[u] < n);
        if (id[u] < n) real_bits |= 1ull << (r0 + u);
        if (lane == 0) cnt[warp + kWarps * (r0 + u)] = __popc(b);
      }
    }
  }
  if (warp == kWarps - 1) {
    int base = 0;
    for (int i0 = 0; i0 < C; i0 += 32) {
      const int i = i0 + lane;
      const bool real = i < C && gcid[i] < n;
      const unsigned b = __ballot_sync(kFull, real);
      if (real) cen[base + __popc(b & lt)] = i;
      base += __popc(b);
    }
    if (lane == 0) cnt[nch + 1] = base;
  }
  if (kExcl)
    for (int t = tid; t < D * C; t += kThreads)
      __pipeline_memcpy_async(ex + t, p.excl + cell * D * C + t, sizeof(int));

  if (rank == 0) {  // padding centres: zero gradient
    float* g = p.grad + cell * 3 * C;
    for (int t = tid; t < C; t += kThreads)
      if (gcid[t] >= n) g[t] = g[C + t] = g[2 * C + t] = 0.f;
  }
  __syncthreads();

  // Exclusive scan of the chunk counts (one warp); M = their total.
  if (warp == 0) {
    int carry = 0;
    for (int c0 = 0; c0 < nch; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < nch ? cnt[c] : 0;
      int s = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      if (c < nch) cnt[c] = carry + s - v;
      carry += __shfl_sync(kFull, s, 31);
    }
    if (lane == 0) cnt[nch] = carry;
  }
  __syncthreads();

  // Copy the occupied neighbour slots, compacted, in slot order, by
  // asynchronous copies (cp.async), all in flight at once.
  const float* gx = p.nxt + cell * 3 * K;
  auto copy = [](void* dst, const void* src) {
    __pipeline_memcpy_async(dst, src, sizeof(float));
  };
  for (int r = 0; r < R; ++r) {
    const bool real = (real_bits >> r) & 1ull;
    const unsigned b = __ballot_sync(kFull, real);
    if (real) {
      const int t = tid + kThreads * r;
      const int dst = cnt[warp + kWarps * r] + __popc(b & lt);
      copy(&pos[dst].x, gx + t);
      copy(&pos[dst].y, gx + K + t);
      copy(&pos[dst].z, gx + 2 * K + t);
      copy(&pos[dst].w, gid + t);
      if (kSpecies) {
        copy(nsig + dst, p.nsig + cell * K + t);
        copy(nse + dst, p.nse + cell * K + t);
      }
      if (kCoulomb) copy(nq + dst, p.nq + cell * K + t);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int M = cnt[nch], ncen = cnt[nch + 1];
  const float rc2 = p.rc2;
  const float L0 = p.box[0], L1 = p.box[1], L2 = p.box[2];
  const float i0 = p.inv_box[0], i1 = p.inv_box[1], i2 = p.inv_box[2];

  // Each chunk of 32 compacted slots: the centre and half-extent of its
  // bounding box (a warp's min / max).  A centre skips a chunk whose box
  // lies beyond the cutoff by a margin (1e-3 of it plus 1e-4 of the
  // widest box edge) far above float rounding of a pair's wrap and r^2,
  // so that no pair the plain version takes is skipped.
  const int nbox = (M + 31) >> 5;
  for (int cc = warp; cc < nbox; cc += kWarps) {
    const int j = (cc << 5) + lane;
    const float4 pj = pos[j < M ? j : M - 1];
    float lo[3] = {pj.x, pj.y, pj.z}, hi[3] = {pj.x, pj.y, pj.z};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int o = 16; o > 0; o >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], o));
      }
    if (lane == 0) {
      box[2 * cc] = make_float4(0.5f * (lo[0] + hi[0]), 0.5f * (lo[1] + hi[1]),
                                0.5f * (lo[2] + hi[2]), 0.f);
      box[2 * cc + 1] = make_float4(0.5f * (hi[0] - lo[0]),
                                    0.5f * (hi[1] - lo[1]),
                                    0.5f * (hi[2] - lo[2]), 0.f);
    }
  }
  __syncthreads();
  const float rcs = sqrtf(rc2) * 1.001f + 1e-4f * fmaxf(L0, fmaxf(L1, L2));
  const float rcs2 = rcs * rcs;
  int* q = queue + warp * kQueue;
  float e_acc = 0.f;
  for (int c = rank * kWarps + warp; c < ncen; c += S * kWarps) {
    const int i = cen[c];
    const long long at = cell * C + i;
    const int ci = gcid[i];
    const float* cx = p.cxt + cell * 3 * C;
    const float x0 = cx[i], x1 = cx[C + i], x2 = cx[2 * C + i];
    const float csig = kSpecies ? p.csig[at] : 0.f;
    const float cse = kSpecies ? p.cse[at] : 0.f;
    const float cq = kCoulomb ? p.cq[at] : 0.f;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;

    // The expensive branch, for one queued neighbour.
    auto pair = [&](int j) {
      const float4 pj = pos[j];
      const float d0 = wrap(x0, pj.x, L0, i0);
      const float d1 = wrap(x1, pj.y, L1, i1);
      const float d2 = wrap(x2, pj.z, L2, i2);
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0),
                                           __fmul_rn(d1, d1)),
                                 __fmul_rn(d2, d2));
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
    };

    // The cheap pass: the lanes first test 32 chunks' boxes at a time,
    // then walk the kept chunks, 32 neighbours at a time, queueing the
    // passing ones.
    int qn = 0;
    for (int cb0 = 0; cb0 < nbox; cb0 += 32) {
      bool hit = false;
      if (cb0 + lane < nbox) {
        const float4 bc = box[2 * (cb0 + lane)];
        const float4 be = box[2 * (cb0 + lane) + 1];
        float gap = fmaxf(
            fabsf(x0 - bc.x - L0 * rintf((x0 - bc.x) * i0)) - be.x, 0.f);
        float gap2 = gap * gap;
        gap = fmaxf(fabsf(x1 - bc.y - L1 * rintf((x1 - bc.y) * i1)) - be.y,
                    0.f);
        gap2 += gap * gap;
        gap = fmaxf(fabsf(x2 - bc.z - L2 * rintf((x2 - bc.z) * i2)) - be.z,
                    0.f);
        gap2 += gap * gap;
        hit = gap2 <= rcs2;
      }
      for (unsigned keep = __ballot_sync(kFull, hit); keep;
           keep &= keep - 1) {
        const int j = ((cb0 + __ffs(keep) - 1) << 5) + lane;
        bool m = false;
        if (j < M) {
          const float4 pj = pos[j];
          const int nj = __float_as_int(pj.w);
          const float d0 = wrap(x0, pj.x, L0, i0);
          const float d1 = wrap(x1, pj.y, L1, i1);
          const float d2 = wrap(x2, pj.z, L2, i2);
          const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0),
                                               __fmul_rn(d1, d1)),
                                     __fmul_rn(d2, d2));
          m = nj != ci && r2 < rc2;
          if (kExcl)
            for (int k = 0; k < D; ++k) m = m && ex[k * C + i] != nj;
        }
        const unsigned b = __ballot_sync(kFull, m);
        if (m) q[qn + __popc(b & lt)] = j;
        qn += __popc(b);
        if (qn >= 32) {
          __syncwarp();
          pair(q[lane]);
          __syncwarp();  // every lane has read its entry before the shift
          if (lane < qn - 32) q[lane] = q[lane + 32];
          qn -= 32;
          __syncwarp();
        }
      }
    }
    __syncwarp();
    if (lane < qn) pair(q[lane]);
    __syncwarp();  // the queue is refilled by the next centre

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

  // Energies: lanes, then warps in order, then the cluster's blocks in
  // rank order (block 0 reads the others' partials).
  e_acc = warp_sum(e_acc);
  if (lane == 0) red[warp] = e_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float s = 0.f;
    for (int r = 0; r < S; ++r) s += cluster.map_shared_rank(red, r)[kWarps];
    p.e[cell] = 0.5f * s;
  }
  cluster.sync();  // keep every block's partial alive until it is read
}

template <bool kSpecies, bool kCoulomb, bool kExcl>
cudaError_t launch(const Args& p, unsigned cells, cudaStream_t stream) {
  const Layout l = layout(p.K, p.C, kExcl ? p.D : 0, kSpecies, kCoulomb);
  const size_t smem = 4 * static_cast<size_t>(l.words);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return cudaErrorInvalidValue;
  auto kernel = cell_lj_kernel<kSpecies, kCoulomb, kExcl>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cells * static_cast<unsigned>(p.split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kSpecies, bool kCoulomb>
cudaError_t launch_excl(bool excl, const Args& p, unsigned cells,
                        cudaStream_t stream) {
  return excl ? launch<kSpecies, kCoulomb, true>(p, cells, stream)
              : launch<kSpecies, kCoulomb, false>(p, cells, stream);
}

}  // namespace

// The most neighbour slots one launch takes at C centre slots, D
// exclusions a centre, with species and charges or without: a multiple of
// 32 up to 16384 whose block fits shared memory, 0 where none does.  The
// caller spreads a larger neighbour block over launches of at most this
// many slots each (ops/cell_lj.py `neighbour_runs`).
extern "C" int cell_lj_max_slots(int C, int D, int species, int coulomb) {
  if (C < 1 || D < 0) return 0;
  for (int K = kMaxK; K >= 32; K -= 32)
    if (4LL * layout(K, C, D, species != 0, coulomb != 0).words <=
        kMaxDynamicSmem)
      return K;
  return 0;
}

// cxt (n_cells, 3, C), nxt (n_cells, 3, K) float32; cid (n_cells, 1, C),
// nid (n_cells, 1, K) int32 (n_atoms = padding, anywhere in a block);
// species blocks csig, cse (n_cells, 1, C) and nsig, nse (n_cells, 1, K),
// all null or none; charge blocks cq (n_cells, 1, C) and nq (n_cells, 1,
// K), both null or neither; excl (n_cells, D, C) int32 or null.  Outputs e
// (n_cells, 1, 1) and grad (n_cells, 3, C).  slope: the linear core's
// slope for the scalar sigma / epsilon; slope_f: its factor for species
// (slope_f eps / sigma).  split: the caller's blocks per cell, 1 to 8.
// Returns cudaErrorInvalidValue for sizes the kernel does not take (K
// above 16384, blocks that do not fit shared memory, a split outside
// [1, 8]).
extern "C" int cell_lj_launch(
    const float* cxt, const float* nxt, const int* cid, const int* nid,
    const float* csig, const float* nsig, const float* cse, const float* nse,
    const float* cq, const float* nq, const int* excl, float* e, float* grad,
    long long n_cells, int C, int K, int n_atoms, int D, int shift,
    float sigma, float epsilon, float rc2, float inv_cut6, float slope,
    float slope_f, float alpha, float bx, float by, float bz, float ibx,
    float iby, float ibz, int split, cudaStream_t stream) {
  const bool species = csig != nullptr;
  const bool coulomb = cq != nullptr;
  const bool ex = excl != nullptr && D > 0;
  if (n_cells < 0 || C < 1 || K < 1 || K > kMaxK || D < 0 || n_atoms < 0 ||
      split < 1 || split > kMaxSplit ||
      species != (nsig != nullptr && cse != nullptr && nse != nullptr) ||
      coulomb != (nq != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cells * split > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  Args p{cxt, nxt, cid, nid, csig, nsig, cse, nse, cq, nq, excl, e, grad,
         C, K, n_atoms, D, shift, split, sigma, epsilon, rc2, inv_cut6,
         slope, slope_f, alpha, {bx, by, bz}, {ibx, iby, ibz}};
  const unsigned cells = static_cast<unsigned>(n_cells);
  cudaError_t err;
  if (species)
    err = coulomb ? launch_excl<true, true>(ex, p, cells, stream)
                  : launch_excl<true, false>(ex, p, cells, stream);
  else
    err = coulomb ? launch_excl<false, true>(ex, p, cells, stream)
                  : launch_excl<false, false>(ex, p, cells, stream);
  return static_cast<int>(err);
}
