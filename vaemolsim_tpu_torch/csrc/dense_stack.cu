// Dense-stack kernel: a whole MLP, h = act(h @ W_i + b_i (+ c @ C_i)),
// with every intermediate kept on chip.  act is linear, tanh, relu or
// gelu in its tanh form (jax.nn.gelu's default).
//
// Replaces vaemolsim_tpu/ops/fused_mlp.py `_stack_kernel` (reached from
// fused_dense_stack).
//
// Bound on the H100: at the paths' shapes the contractions are 1 to 600
// deep and the outputs 2 to 95 wide, far too thin for tensor cores.  The
// unfused stack's cost is moving each (rows, hidden) intermediate through
// device memory; the fused one's least time is its float32 FMAs (many
// rows) or one read of its weights (one row).  No single layout serves
// both ends, so the launcher picks one of four regimes from the shapes
// (ops/fused_mlp.py `stack_regime` mirrors the choice and the limits):
//
// * small N (n <= kSmallRows): one row cannot fill a 32-row tile on one
//   SM.  A cluster of kCluster blocks spreads every layer's output units
//   over kCluster SMs (each block its slice, all rows), gathering the
//   full activation through distributed shared memory between layers.
//   The last layer is split over its depth instead: each block
//   multiplies its own slice of the last hidden layer by the matching
//   rows of W, one contiguous run that it copies into shared memory
//   (cp.async) while the earlier layers run, and the partials are summed
//   across the cluster through distributed shared memory.  No padding
//   rows; the weights pass once through kCluster SMs' load paths.
// * streaming (two layers, din + dc + 1 <= 8, dout <= 8): one thread
//   owns a row and streams over the hidden units, h_j = act(x.W1[:, j] +
//   b1_j (+ c.C1[:, j])), accumulating h_j W2[j, :] in registers; the
//   hidden layer is never materialised.  The weights are staged once per
//   block into shared memory as one 16-byte-aligned record per hidden
//   unit and read as broadcasts.  (Wider inputs or outputs pay more in
//   staging and padding than one thread per row saves: at 20->40->9 and
//   10k rows the tiled regime took 10.3 us against 15.0 us streaming on
//   an H100.)
// * tiled (everything else): 32 rows per block, activations transposed in
//   shared memory (double-buffered across layers, stride 36 so that
//   depth-split lanes hit distinct banks); each thread owns a 4-row x
//   4-column register micro-tile (a float4 of activations and four
//   weights serve 16 FMAs).  A layer too narrow to occupy the block
//   splits its depth over S lanes and reduces with shuffles.
// * wide (one layer too wide for the tiled regime's shared memory: a
//   width of 808 or more): an ordinary tiled matrix product with the bias
//   and the activation in its epilogue.  A block owns a 64-row x 64-column
//   output tile and walks the depth (the input, then the conditional
//   input) in steps of 16, staging a 64 x 16 tile of activations
//   (transposed) and a 16 x 64 tile of weights in shared memory; each
//   thread keeps a 4 x 4 micro-tile in registers.  The layer's input and
//   output pass through device memory, so a deep stack of wide layers is
//   split into one launch a layer (ops/fused_mlp.py `stack_runs`).
//
// FP32 FMA throughout, no TF32, like the JAX kernel's HIGHEST precision.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kSmallRows = 16;  // small-N regime: 1 <= n <= kSmallRows
constexpr int kCluster = 8;     // blocks of the small-N cluster (portable)
constexpr int kStreamThreads = 128;
constexpr int kTileRows = 32;
constexpr int kTileStride = kTileRows + 4;

enum Act { kLinear = 0, kTanh = 1, kRelu = 2, kGelu = 3 };
enum Regime { kRefused = 0, kSmall = 1, kStream = 2, kTiled = 3,
              kWide = 4 };
constexpr int kWideTile = 64;   // wide regime: output rows and columns
constexpr int kWideDepth = 16;  // wide regime: depth per shared stage

struct Stack {
  const float* W[kMaxLayers];  // (dims[l], dims[l+1]) row-major
  const float* b[kMaxLayers];  // (dims[l+1],)
  const float* C[kMaxLayers];  // (dc, dims[l+1]) or null
  int dims[kMaxLayers + 1];
  int act[kMaxLayers];
  int n_layers;
  int dc;     // conditional input width, 0 without one
  int ld;     // widest layer
  int slice;  // small N: widest per-block slice of a split layer's outputs
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kTanh) return tanhf(v);
  // Not fmaxf, which returns 0 for a NaN: a NaN goes on, as in torch.relu.
  if (act == kRelu) return v < 0.f ? 0.f : v;
  if (act == kGelu)  // 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3)))
    return 0.5f * v *
           (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

__host__ __device__ __forceinline__ int cluster_chunk(int width) {
  return (width + kCluster - 1) / kCluster;
}

// Lanes that share one work item: the largest power of two (at most 32)
// with items * lanes <= threads, at least 1.
__device__ __forceinline__ int lanes_for(int items, int threads) {
  int s = 1;
  while (s < 32 && items * (2 * s) <= threads) s *= 2;
  return s;
}

__device__ __forceinline__ float lane_sum(float v, int lanes) {
  for (int off = lanes / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Small N: one cluster, output units split over its blocks.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    dense_small_kernel(const float* __restrict__ x,
                       const float* __restrict__ c, float* __restrict__ out,
                       int n, Stack p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = p.n_layers, dc = p.dc, d_last = p.dims[L];
  extern __shared__ __align__(16) float smem[];
  float* full = smem;                  // (n, ld): the layer's whole input
  float* own = full + n * p.ld;        // (n, slice): this block's outputs
  float* part = own + n * p.slice;     // (n, d_last): split-depth partials
  float* ctile = part + n * d_last;    // (n, dc)
  float* slab = ctile + n * dc;        // (slice of dims[L-1], d_last)
  const int tid = threadIdx.x;

  // The last layer's rows for this block's hidden slice are one
  // contiguous run of W: start copying it now, behind the other layers.
  if (L > 1) {
    const int cw = cluster_chunk(p.dims[L - 1]), lo = rank * cw;
    const int ns = max(0, min(p.dims[L - 1], lo + cw) - lo);
    const float* src = p.W[L - 1] + static_cast<size_t>(lo) * d_last;
    for (int i = tid; i < ns * d_last; i += kThreads)
      __pipeline_memcpy_async(slab + i, src + i, sizeof(float));
  }
  __pipeline_commit();

  for (int i = tid; i < n * p.dims[0]; i += kThreads) {
    const int r = i / p.dims[0], k = i % p.dims[0];
    full[r * p.ld + k] = x[i];
  }
  for (int i = tid; i < n * dc; i += kThreads) ctile[i] = c[i];
  __syncthreads();

  // Every layer but the last (or a single layer): this block's slice of
  // the output units, for all rows, the depth split over S lanes.
  const int n_split = L == 1 ? 1 : L - 1;
  for (int l = 0; l < n_split; ++l) {
    const int d_in = p.dims[l], d_out = p.dims[l + 1];
    const float* __restrict__ W = p.W[l];
    const float* __restrict__ C = p.C[l];
    const int cw = cluster_chunk(d_out), lo = rank * cw;
    const int ns = max(0, min(d_out, lo + cw) - lo);
    const int items = n * ns;
    const int S = lanes_for(items, kThreads), groups = kThreads / S;
    const int rounds = (items + groups - 1) / groups;
    const int s = tid % S;
    for (int round = 0; round < rounds; ++round) {
      const int it = round * groups + tid / S;
      const bool valid = it < items;
      const int r = valid ? it / ns : 0, j = valid ? lo + it % ns : 0;
      float acc = 0.f;
      if (valid) {
#pragma unroll 8
        for (int k = s; k < d_in; k += S)
          acc = fmaf(full[r * p.ld + k], __ldg(W + k * d_out + j), acc);
        if (C != nullptr)
          for (int k = s; k < dc; k += S)
            acc = fmaf(ctile[r * dc + k], __ldg(C + k * d_out + j), acc);
      }
      acc = lane_sum(acc, S);
      if (valid && s == 0) {
        const float v = activate(acc + __ldg(p.b[l] + j), p.act[l]);
        if (L == 1)
          out[r * d_out + j] = v;
        else
          own[r * p.slice + (j - lo)] = v;
      }
    }
    if (L == 1) return;  // no block reads another's shared memory
    if (l < L - 2) {
      // Gather the whole activation for the next split layer.
      cluster.sync();
      for (int i = tid; i < n * d_out; i += kThreads) {
        const int r = i / d_out, j = i % d_out, q = j / cw;
        const float* src = cluster.map_shared_rank(own, q);
        full[r * p.ld + j] = src[r * p.slice + (j - q * cw)];
      }
      cluster.sync();  // every block has read `own` before it is rewritten
    } else {
      __syncthreads();
    }
  }

  // The last layer, split over its depth: this block's hidden slice
  // times the matching rows of W, then a sum over the cluster.
  {
    __pipeline_wait_prior(0);
    __syncthreads();  // the slab is in
    const int d_in = p.dims[L - 1], d_out = d_last;
    const int cw = cluster_chunk(d_in), lo = rank * cw;
    const int ns = max(0, min(d_in, lo + cw) - lo);
    const int items = n * d_out;
    const int S = lanes_for(items, kThreads), groups = kThreads / S;
    const int rounds = (items + groups - 1) / groups;
    const int s = tid % S;
    for (int round = 0; round < rounds; ++round) {
      const int it = round * groups + tid / S;
      const bool valid = it < items;
      const int r = valid ? it / d_out : 0, o = valid ? it % d_out : 0;
      float acc = 0.f;
      if (valid)
        for (int k = s; k < ns; k += S)
          acc = fmaf(own[r * p.slice + k], slab[k * d_out + o], acc);
      acc = lane_sum(acc, S);
      if (valid && s == 0) part[r * d_out + o] = acc;
    }
    cluster.sync();
    const float* __restrict__ C = p.C[L - 1];
    const int co = cluster_chunk(d_out), olo = rank * co;
    const int no = max(0, min(d_out, olo + co) - olo);
    for (int i = tid; i < n * no; i += kThreads) {
      const int r = i / no, o = olo + i % no;
      float pv[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        pv[q] = cluster.map_shared_rank(part, q)[r * d_out + o];
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) v += pv[q];
      v += __ldg(p.b[L - 1] + o);
      if (C != nullptr) {
        float cv = 0.f;
        for (int k = 0; k < dc; ++k)
          cv = fmaf(ctile[r * dc + k], __ldg(C + k * d_out + o), cv);
        v += cv;
      }
      out[r * d_out + o] = activate(v, p.act[L - 1]);
    }
    cluster.sync();  // keep `part` alive until every block has read it
  }
}

// ---------------------------------------------------------------------------
// Streaming: two layers, narrow input and output, one thread per row.
// ---------------------------------------------------------------------------

// Record of hidden unit j in shared memory, kIn + kOut floats:
// [W1[:, j], C1[:, j], b1_j, 0... | W2[j, :], 0...].
template <int kIn, int kOut, int kAct0>
__global__ void __launch_bounds__(kStreamThreads)
    dense_stream_kernel(const float* __restrict__ x,
                        const float* __restrict__ c,
                        float* __restrict__ out, long long n, Stack p) {
  constexpr int kRec = kIn + kOut;
  extern __shared__ __align__(16) float smem[];
  const int din = p.dims[0], H = p.dims[1], dout = p.dims[2], dc = p.dc;
  // The source of each record entry first, then four loads in flight.
#pragma unroll 4
  for (int i = threadIdx.x; i < H * kRec; i += kStreamThreads) {
    const int j = i / kRec, q = i % kRec;
    const float* src = nullptr;
    if (q < din)
      src = p.W[0] + q * H + j;
    else if (q < din + dc)
      src = p.C[0] + (q - din) * H + j;
    else if (q == din + dc)
      src = p.b[0] + j;
    else if (q >= kIn && q - kIn < dout)
      src = p.W[1] + j * dout + (q - kIn);
    smem[i] = src != nullptr ? __ldg(src) : 0.f;
  }
  __syncthreads();
  const long long row =
      blockIdx.x * static_cast<long long>(kStreamThreads) + threadIdx.x;
  if (row >= n) return;

  float in[kIn];
#pragma unroll
  for (int i = 0; i < kIn; ++i) {
    float v = 0.f;
    if (i < din)
      v = x[row * din + i];
    else if (i < din + dc)
      v = c[row * dc + (i - din)];
    else if (i == din + dc)
      v = 1.f;  // carries b1
    in[i] = v;
  }
  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.f;
  // Eight hidden units in flight: their dot products are independent.
#pragma unroll 8
  for (int j = 0; j < H; ++j) {
    const float4* rec = reinterpret_cast<const float4*>(smem + j * kRec);
    float h = 0.f;
#pragma unroll
    for (int q = 0; q < kIn / 4; ++q) {
      const float4 w = rec[q];
      h = fmaf(in[4 * q], w.x, h);
      h = fmaf(in[4 * q + 1], w.y, h);
      h = fmaf(in[4 * q + 2], w.z, h);
      h = fmaf(in[4 * q + 3], w.w, h);
    }
    h = activate(h, kAct0);  // a constant: no branch in the loop
#pragma unroll
    for (int q = 0; q < kOut / 4; ++q) {
      const float4 w = rec[kIn / 4 + q];
      acc[4 * q] = fmaf(h, w.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(h, w.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(h, w.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(h, w.w, acc[4 * q + 3]);
    }
  }
  const float* __restrict__ C1 = p.C[1];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    if (o < dout) {
      float v = acc[o] + __ldg(p.b[1] + o);
      if (C1 != nullptr) {
        float cv = 0.f;
        for (int k = 0; k < dc; ++k)  // c from memory: `in` stays in registers
          cv = fmaf(c[row * dc + k], __ldg(C1 + k * dout + o), cv);
        v += cv;
      }
      out[row * dout + o] = activate(v, p.act[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tiled: 32 rows per block, 4 x 4 register micro-tiles.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    dense_tiled_kernel(const float* __restrict__ x,
                       const float* __restrict__ c,
                       float* __restrict__ out, long long n, Stack p) {
  constexpr int T = kTileRows, TS = kTileStride;
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;             // (ld, TS): activation k of row r at k*TS+r
  float* nxt = smem + p.ld * TS;
  float* ct = smem + 2 * p.ld * TS;  // (dc, TS)
  const long long row0 = blockIdx.x * static_cast<long long>(T);
  const int tid = threadIdx.x, dc = p.dc;

  const int din = p.dims[0];
  for (int i = tid; i < T * din; i += kThreads) {
    const int r = i / din, k = i % din;
    cur[k * TS + r] = row0 + r < n ? x[(row0 + r) * din + k] : 0.f;
  }
  for (int i = tid; i < T * dc; i += kThreads) {
    const int r = i / dc, k = i % dc;
    ct[k * TS + r] = row0 + r < n ? c[(row0 + r) * dc + k] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const int d_in = p.dims[l], d_out = p.dims[l + 1];
    const float* __restrict__ W = p.W[l];
    const float* __restrict__ C = p.C[l];
    const bool last = l == p.n_layers - 1;
    const int cgs = (d_out + 3) / 4;
    const int items = (T / 4) * cgs;
    const int S = lanes_for(items, kThreads), groups = kThreads / S;
    const int rounds = (items + groups - 1) / groups;
    const int s = tid % S;
    for (int round = 0; round < rounds; ++round) {
      const int it = round * groups + tid / S;
      const bool valid = it < items;
      const int col0 = valid ? 4 * (it % cgs) : 0;
      const int r0 = valid ? 4 * (it / cgs) : 0;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      if (valid) {
        const int nq = min(4, d_out - col0);
#pragma unroll 4
        for (int k = s; k < d_in; k += S) {
          const float4 a = *reinterpret_cast<const float4*>(cur + k * TS + r0);
          float w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = q < nq ? __ldg(W + k * d_out + col0 + q) : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[0][q] = fmaf(a.x, w[q], acc[0][q]);
            acc[1][q] = fmaf(a.y, w[q], acc[1][q]);
            acc[2][q] = fmaf(a.z, w[q], acc[2][q]);
            acc[3][q] = fmaf(a.w, w[q], acc[3][q]);
          }
        }
        if (C != nullptr) {
          for (int k = s; k < dc; k += S) {
            const float4 a =
                *reinterpret_cast<const float4*>(ct + k * TS + r0);
            float w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              w[q] = q < nq ? __ldg(C + k * d_out + col0 + q) : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[0][q] = fmaf(a.x, w[q], acc[0][q]);
              acc[1][q] = fmaf(a.y, w[q], acc[1][q]);
              acc[2][q] = fmaf(a.z, w[q], acc[2][q]);
              acc[3][q] = fmaf(a.w, w[q], acc[3][q]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = lane_sum(acc[i][q], S);
      if (valid && s == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = col0 + q;
          if (col >= d_out) break;
          const float bj = __ldg(p.b[l] + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = activate(acc[i][q] + bj, p.act[l]);
            const long long row = row0 + r0 + i;
            if (last) {
              if (row < n) out[row * d_out + col] = v;
            } else {
              nxt[col * TS + r0 + i] = v;
            }
          }
        }
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---------------------------------------------------------------------------
// Wide: one layer as a tiled matrix product, bias and activation after.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    dense_wide_kernel(const float* __restrict__ x,
                      const float* __restrict__ c, float* __restrict__ out,
                      long long n, Stack p) {
  __shared__ __align__(16) float as[kWideDepth][kWideTile];  // (k, row)
  __shared__ __align__(16) float ws[kWideDepth][kWideTile];  // (k, col)
  const int d_in = p.dims[0], d_out = p.dims[1], dc = p.dc;
  const int depth = d_in + dc;
  const float* W = p.W[0];
  const float* C = p.C[0];
  const long long row0 = static_cast<long long>(blockIdx.x) * kWideTile;
  const int col0 = blockIdx.y * kWideTile;
  const int tid = threadIdx.x;
  // Loads: a thread takes 4 consecutive depths of one row of the
  // activations, and 4 consecutive columns of one depth of the weights.
  const int a_row = tid / 4, a_k = 4 * (tid % 4);
  const int w_k = tid / 16, w_col = 4 * (tid % 16);
  // The micro-tile: rows 4 ty .. 4 ty + 3, columns 4 tx .. 4 tx + 3.
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < depth; k0 += kWideDepth) {
    const long long row = row0 + a_row;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + a_k + q;
      float v = 0.f;
      if (row < n && k < depth)
        v = k < d_in ? x[row * d_in + k] : c[row * dc + (k - d_in)];
      as[a_k + q][a_row] = v;
    }
    const int kw = k0 + w_k;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + w_col + q;
      float v = 0.f;
      if (kw < depth && col < d_out)
        v = kw < d_in ? __ldg(W + static_cast<size_t>(kw) * d_out + col)
                      : __ldg(C + static_cast<size_t>(kw - d_in) * d_out +
                              col);
      ws[w_k][w_col + q] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWideDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + 4 * ty + i;
    if (row >= n) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + 4 * tx + q;
      if (col < d_out)
        out[row * d_out + col] = activate(acc[i][q] + __ldg(p.b[0] + col),
                                          p.act[0]);
    }
  }
}

// ---------------------------------------------------------------------------
// Regime choice (mirrored by ops/fused_mlp.py `stack_regime`).
// ---------------------------------------------------------------------------

struct Plan {
  Regime regime;
  size_t smem;  // dynamic shared-memory bytes
  int in_bucket, out_bucket;  // streaming record widths
};

constexpr int kBuckets[][2] = {{4, 4}, {8, 8}};

Plan plan_for(long long n, const Stack& p) {
  const int L = p.n_layers, dc = p.dc;
  if (n <= kSmallRows) {
    const size_t slab =
        L > 1 ? static_cast<size_t>(cluster_chunk(p.dims[L - 1])) * p.dims[L]
              : 0;
    const size_t floats = static_cast<size_t>(n) *
                          (p.ld + p.slice + p.dims[L] + dc) + slab;
    if (floats * sizeof(float) <= static_cast<size_t>(kMaxDynamicSmem))
      return {kSmall, floats * sizeof(float), 0, 0};
  }
  if (L == 2) {
    for (const auto& bk : kBuckets) {
      if (p.dims[0] + dc + 1 <= bk[0] && p.dims[2] <= bk[1]) {
        const size_t bytes =
            sizeof(float) * static_cast<size_t>(p.dims[1]) * (bk[0] + bk[1]);
        if (bytes <= static_cast<size_t>(kMaxDynamicSmem))
          return {kStream, bytes, bk[0], bk[1]};
        break;
      }
    }
  }
  const size_t bytes = sizeof(float) * static_cast<size_t>(kTileStride) *
                       (2 * static_cast<size_t>(p.ld) + dc);
  if (bytes <= static_cast<size_t>(kMaxDynamicSmem))
    return {kTiled, bytes, 0, 0};
  if (L == 1) return {kWide, 0, 0, 0};
  return {kRefused, bytes, 0, 0};
}

template <int kIn, int kOut, int kAct0>
cudaError_t launch_stream(const float* x, const float* c, float* out,
                          long long n, const Stack& p, size_t smem,
                          cudaStream_t stream) {
  cudaError_t err = allow_smem(dense_stream_kernel<kIn, kOut, kAct0>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((n + kStreamThreads - 1) / kStreamThreads);
  dense_stream_kernel<kIn, kOut, kAct0>
      <<<blocks, kStreamThreads, smem, stream>>>(x, c, out, n, p);
  return cudaGetLastError();
}

template <int kIn, int kOut>
cudaError_t launch_stream(const float* x, const float* c, float* out,
                          long long n, const Stack& p, size_t smem,
                          cudaStream_t stream) {
  if (p.act[0] == kTanh)
    return launch_stream<kIn, kOut, kTanh>(x, c, out, n, p, smem, stream);
  if (p.act[0] == kRelu)
    return launch_stream<kIn, kOut, kRelu>(x, c, out, n, p, smem, stream);
  if (p.act[0] == kGelu)
    return launch_stream<kIn, kOut, kGelu>(x, c, out, n, p, smem, stream);
  return launch_stream<kIn, kOut, kLinear>(x, c, out, n, p, smem, stream);
}

}  // namespace

// x: (n, dims[0]); c: (n, dc) or null; out: (n, dims[n_layers]).
// W, b, C: arrays of n_layers device pointers (C entries null without a
// conditional input).  Returns cudaErrorInvalidValue for a stack the
// kernel does not take (too many layers, or a stack of two or more layers
// with no regime whose shared memory fits at this n; a single layer
// always has the wide regime).
extern "C" int dense_stack_launch(const float* x, const float* c, float* out,
                                  long long n, int n_layers,
                                  const int* dims, const int* acts,
                                  const float* const* W,
                                  const float* const* b,
                                  const float* const* C, int dc,
                                  cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Stack p{};
  int widest = 0;
  for (int l = 0; l <= n_layers; ++l) {
    p.dims[l] = dims[l];
    if (dims[l] > widest) widest = dims[l];
  }
  p.slice = 0;
  if (n_layers > 1)
    for (int l = 0; l < n_layers - 1; ++l)
      p.slice = max(p.slice, cluster_chunk(dims[l + 1]));
  for (int l = 0; l < n_layers; ++l) {
    p.W[l] = W[l];
    p.b[l] = b[l];
    p.C[l] = c != nullptr ? C[l] : nullptr;
    p.act[l] = acts[l];
  }
  p.n_layers = n_layers;
  p.dc = c != nullptr ? dc : 0;
  p.ld = widest;
  const Plan plan = plan_for(n, p);
  if (plan.regime == kRefused) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSuccess;
  if (plan.regime == kSmall) {
    err = allow_smem(dense_small_kernel, plan.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dense_small_kernel, x, c, out,
                             static_cast<int>(n), p);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (plan.regime == kStream) {
    switch (plan.in_bucket) {
      case 4: err = launch_stream<4, 4>(x, c, out, n, p, plan.smem, stream);
        break;
      default: err = launch_stream<8, 8>(x, c, out, n, p, plan.smem, stream);
    }
    return static_cast<int>(err);
  }
  if (plan.regime == kWide) {
    const long long row_tiles = (n + kWideTile - 1) / kWideTile;
    if (row_tiles > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(row_tiles),
                    static_cast<unsigned>((p.dims[1] + kWideTile - 1) /
                                          kWideTile));
    dense_wide_kernel<<<grid, kThreads, 0, stream>>>(x, c, out, n, p);
    return static_cast<int>(cudaGetLastError());
  }
  err = allow_smem(dense_tiled_kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((n + kTileRows - 1) / kTileRows);
  dense_tiled_kernel<<<blocks, kThreads, plan.smem, stream>>>(x, c, out, n,
                                                              p);
  return static_cast<int>(cudaGetLastError());
}
