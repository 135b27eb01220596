// G23 scatter_ids — combine N lanes of values into G rows by a group id
// a lane: the batch libraries' grouped reduce and scatter.
//
// Replaces (flink_tpu, the JAX reference): ops/segment.py:183
// grouped_reduce (kernel K3: count, sum, min, max and avg over dictionary-
// encoded group ids, each a jnp ``zeros(G).at[gid].add / min / max``) and
// the scatters of the batch libraries (kernel K23): gelly/graph.py's
// degrees (:113, :117), the Sum phase of scatter_gather (:141-150, with its
// has_msg ``set``), page_rank's out-degree and contribution sums (:193,
// :198), hits' two scatters an iteration (:260, :262), community
// detection's dense score mass over dst * V + label (:290-293),
// _neighbor_reduce (:413) and _sym_adjacency's max of 1.0 (:477); and
// ml/pipeline.py KMeans' per-center sums and counts (:241-242).
//
// Contract: target [G, W] float32 comes in holding the neutral of ``op``
// (0 for add, +inf for min, -inf for max; the wrapper fills it). Each lane
// i whose id idx[i] lies in [0, G) combines vals[i, :] into row idx[i] by
// add, min or max (common.cuh combine_op: jnp's NaN and signed-zero order
// for min and max), adds 1 to counts[idx[i]] when counts is given, and
// sets has[idx[i]] when has is given. Lanes outside [0, G) are dropped
// (the reference's mode="drop"). vals may be null (a count alone).
//
// Bound: bytes. Per lane it reads the id (4 or 8 B) and W values (4 B
// each); each row of the target, counts and has is written once: at TPC-H
// Q1's 6,001,215 lineitem rows into 4 groups 48 MB (14.3 us at 3.35
// TB/s), at KMeans' 2^20 points of D = 16 68 MB.
//
// Design: the reference's shapes range from 4 groups (Q1) to 2^24 cells
// (community detection at V = 4,096); three paths by the size of the
// target. A target of at most kRegCells value cells and as many groups
// (Q1's 4 groups: SUM, AVG, MIN, MAX) is combined in registers: each
// thread folds its lanes into its own copy (a select a cell, no atomic),
// kUnroll lanes' loads in flight, then the warps fold their copies by a
// shuffle tree. A target whose copy fits a warp (G (W + 1) cells of 4 B,
// at most kSharedCells: KMeans' 64 x 17) takes the shared path: each warp
// combines its lanes into its own copy in shared memory, reading the
// values coalesced: with W a multiple of 4 and the values 16-byte aligned
// a lane takes a float4 of a row (at W = 16 a warp reads 8 rows of 16
// columns with one instruction), otherwise one float (W = 3, an offset
// view), or one id when there are no values. No atomic there either: the
// lanes of a warp instruction that hit one cell (the same row and
// columns: a lane compares its row with the lanes W / 4, 2 W / 4, ...
// before it by shuffles) take turns in lane order, the others go
// together. Both paths then fold their warps' copies in warp order into
// the block's partial, stored with plain stores, and a second small
// kernel folds the partials in block order into the target, the counts
// and the touched flags (kFoldCells cells a block, kFoldSlices slices of
// the blocks each, the slices folded in order). No global atomic touches
// the target, and every value is combined in an order fixed by the shapes,
// so the result does not depend on scheduling, float sums included. Both
// paths need the blocks' partials to cost fewer reads than the lanes.
// Otherwise (Q18's 1.5M orders, the community cells, Gelly's vertices) one
// thread a lane combines straight into the target with global atomics
// (common.cuh atomic_combine). Float sums land in another order than
// XLA's, as in G3: exact for integer-valued data whose sums stay under
// 2^24.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// cells (4 B) a warp's copy may hold: kWarps copies in 192 KB of the 227 KB
// a block may have; ops/cuda.py SCATTER_SHARED_CELLS
constexpr int kSharedCells = 3072;
// value cells (G W) and groups a thread's registers hold
constexpr int kRegCells = 8;
// the fold of the partials: cells a block and slices of the blocks a cell
constexpr int kFoldCells = 32;
constexpr int kFoldSlices = 16;

enum Path { kGlobal, kShared, kRegs };

struct Plan {
  Path path;
  int blocks;
  int cells;  // the partial a block stores: G cols value cells, G counts
  int Q;      // elements a row: W / 4 float4s, W floats, or 1 id
  bool vec;
};

Plan plan(long long N, const float* vals, int W, long long G) {
  Plan p{kGlobal, 0, 0, 1, false};
  const long long cols = vals != nullptr ? W : 0;
  const long long cells = G * (cols + 1);
  if (cells > kSharedCells || N <= 0) return p;
  const bool regs = G <= kRegCells && G * cols <= kRegCells;
  p.vec = !regs && vals != nullptr && W % 4 == 0 &&
          reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  p.Q = vals == nullptr ? 1 : (p.vec ? W / 4 : W);
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long n_el = N * p.Q;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (n_el + per_block - 1) / per_block;
  // as many blocks as a multiprocessor holds at once, to keep loads in
  // flight: two of kThreads threads (at most 64 registers a thread), or
  // fewer where the shared path's copies fill its 227 KB
  const long long smem = regs ? 0 : kWarps * ((cells + 3) & ~3LL) * 4;
  long long per_sm = 2;
  if (smem > 0 && (227LL << 10) / smem < per_sm) {
    per_sm = (227LL << 10) / smem;
  }
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  if (blocks * cells > n_el) return p;
  p.path = regs ? kRegs : kShared;
  p.blocks = static_cast<int>(blocks);
  p.cells = static_cast<int>(cells);
  return p;
}

// The partials (nb blocks of GW value cells, then G counts) folded in
// block order into the target, the counts and the touched flags: a block
// takes kFoldCells cells, each thread a slice of the blocks for one cell,
// and the slices fold in order.
__global__ void __launch_bounds__(kFoldCells * kFoldSlices) scatter_ids_fold(
    const float* __restrict__ part, int nb, int GW, int cells, int op,
    float neutral, float* __restrict__ target, int32_t* __restrict__ counts,
    uint8_t* __restrict__ has) {
  __shared__ float s_val[kFoldSlices][kFoldCells];
  __shared__ int32_t s_cnt[kFoldSlices][kFoldCells];
  const int cl = threadIdx.x % kFoldCells;
  const int sl = threadIdx.x / kFoldCells;
  const int c = blockIdx.x * kFoldCells + cl;
  const int b0 = static_cast<int>(static_cast<long long>(nb) * sl /
                                  kFoldSlices);
  const int b1 = static_cast<int>(static_cast<long long>(nb) * (sl + 1) /
                                  kFoldSlices);
  const int32_t* pc = reinterpret_cast<const int32_t*>(part);
  float r = neutral;
  int32_t n = 0;
  if (c < cells) {
    if (c < GW) {
      for (int b = b0; b < b1; ++b) {
        r = combine_op(op, r, part[static_cast<size_t>(b) * cells + c]);
      }
    } else {
      for (int b = b0; b < b1; ++b) n += pc[static_cast<size_t>(b) * cells + c];
    }
  }
  s_val[sl][cl] = r;
  s_cnt[sl][cl] = n;
  __syncthreads();
  if (sl != 0 || c >= cells) return;
  for (int k = 1; k < kFoldSlices; ++k) {
    r = combine_op(op, r, s_val[k][cl]);
    n += s_cnt[k][cl];
  }
  if (c < GW) {
    target[c] = r;
  } else {
    if (counts != nullptr) counts[c - GW] = n;
    if (has != nullptr) has[c - GW] = n > 0;
  }
}

template <typename I, bool kVec>
__global__ void __launch_bounds__(kThreads) scatter_ids_shared(
    const I* __restrict__ idx, long long N, const float* __restrict__ vals,
    int W, int G, int Q, int op, float neutral, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int GW = vals != nullptr ? G * W : 0;
  const int cells = GW + G;
  const int pitch = (cells + 3) & ~3;  // float4-aligned copies
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* copy = smem + warp * pitch;
  int32_t* cnt = reinterpret_cast<int32_t*>(copy + GW);
  for (int j = lane; j < GW; j += 32) copy[j] = neutral;
  for (int g = lane; g < G; g += 32) cnt[g] = 0;
  __syncwarp();
  const long long n_el = N * Q;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  for (long long chunk = first; chunk * 32 < n_el;
       chunk += n_warps * kUnroll) {
    int g[kUnroll];
    int q[kUnroll];
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the chunks first
      const long long e = (chunk + u * n_warps) * 32 + lane;
      g[u] = -1;
      q[u] = 0;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < n_el) {
        const long long i = Q == 1 ? e : e / Q;
        const long long gi = static_cast<long long>(idx[i]);
        q[u] = static_cast<int>(e - i * Q);
        if (gi >= 0 && gi < G) g[u] = static_cast<int>(gi);
        if (vals != nullptr) {
          if (kVec) {
            v[u] = reinterpret_cast<const float4*>(vals)[e];
          } else {
            v[u].x = vals[e];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = g[u] >= 0;
      // the lanes before this one on the same columns are Q, 2 Q, ...
      // lanes back; those on the same row come first
      int turn = 0;
      for (int d = Q; d < 32; d += Q) {
        const int other = __shfl_up_sync(0xffffffffu, g[u], d);
        turn += lane >= d && other == g[u] ? 1 : 0;
      }
      const int turns = __reduce_max_sync(0xffffffffu, ok ? turn + 1 : 0);
      for (int t = 0; t < turns; ++t) {
        if (ok && turn == t) {
          if (vals != nullptr) {
            if (kVec) {
              float4* c = reinterpret_cast<float4*>(copy + g[u] * W) + q[u];
              float4 a = *c;
              a.x = combine_op(op, a.x, v[u].x);
              a.y = combine_op(op, a.y, v[u].y);
              a.z = combine_op(op, a.z, v[u].z);
              a.w = combine_op(op, a.w, v[u].w);
              *c = a;
            } else {
              float* c = copy + g[u] * W + q[u];
              *c = combine_op(op, *c, v[u].x);
            }
          }
          if (q[u] == 0) cnt[g[u]] += 1;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // the block's partial: its warps' copies folded in warp order
  float* mine = part + static_cast<size_t>(blockIdx.x) * cells;
  const int32_t* scnt = reinterpret_cast<const int32_t*>(smem);
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    if (c < GW) {
      float r = neutral;
      for (int w = 0; w < kWarps; ++w) {
        r = combine_op(op, r, smem[w * pitch + c]);
      }
      mine[c] = r;
    } else {
      int32_t n = 0;
      for (int w = 0; w < kWarps; ++w) n += scnt[w * pitch + c];
      reinterpret_cast<int32_t*>(mine)[c] = n;
    }
  }
}

template <typename I, int kOp>
__global__ void __launch_bounds__(kThreads) scatter_ids_regs(
    const I* __restrict__ idx, long long N, const float* __restrict__ vals,
    int W, int G, int Q, float neutral, float* __restrict__ part) {
  __shared__ float s_val[kWarps][kRegCells];
  __shared__ int32_t s_cnt[kWarps][kRegCells];
  const int cols = vals != nullptr ? W : 0;
  float acc[kRegCells];
  int32_t cnt[kRegCells];
#pragma unroll
  for (int j = 0; j < kRegCells; ++j) {
    acc[j] = neutral;
    cnt[j] = 0;
  }
  const long long n_el = N * Q;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e0 = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
       e0 < n_el; e0 += stride * kUnroll) {
    int cell[kUnroll];
    int grp[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load first
      const long long e = e0 + u * stride;
      cell[u] = -1;
      grp[u] = -1;
      v[u] = 0.f;
      if (e < n_el) {
        const long long i = Q == 1 ? e : e / Q;
        const long long gi = static_cast<long long>(idx[i]);
        const int q = static_cast<int>(e - i * Q);
        if (gi >= 0 && gi < G) {
          cell[u] = static_cast<int>(gi) * cols + q;
          grp[u] = q == 0 ? static_cast<int>(gi) : -1;
          if (vals != nullptr) v[u] = vals[e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kRegCells; ++j) {
        if (vals != nullptr && cell[u] == j) {
          acc[j] = combine_op(kOp, acc[j], v[u]);
        }
        cnt[j] += grp[u] == j ? 1 : 0;
      }
    }
  }
  // the warp's copy by a shuffle tree, then the block's partial in warp
  // order
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kRegCells; ++j) {
    for (int off = 16; off > 0; off >>= 1) {
      acc[j] = combine_op(kOp, acc[j],
                          __shfl_down_sync(0xffffffffu, acc[j], off));
      cnt[j] += __shfl_down_sync(0xffffffffu, cnt[j], off);
    }
    if (lane == 0) {
      s_val[warp][j] = acc[j];
      s_cnt[warp][j] = cnt[j];
    }
  }
  __syncthreads();
  const int GW = G * cols;
  const int cells = GW + G;
  float* mine = part + static_cast<size_t>(blockIdx.x) * cells;
  if (threadIdx.x < cells) {
    const int c = threadIdx.x;
    if (c < GW) {
      float r = neutral;
      for (int w = 0; w < kWarps; ++w) r = combine_op(kOp, r, s_val[w][c]);
      mine[c] = r;
    } else {
      int32_t n = 0;
      for (int w = 0; w < kWarps; ++w) n += s_cnt[w][c - GW];
      reinterpret_cast<int32_t*>(mine)[c] = n;
    }
  }
}

template <typename I>
__global__ void scatter_ids_global(
    const I* __restrict__ idx, long long N, const float* __restrict__ vals,
    int W, long long G, int op, float* __restrict__ target,
    int32_t* __restrict__ counts, uint8_t* __restrict__ has) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long g = static_cast<long long>(idx[i]);
  if (g < 0 || g >= G) return;
  if (vals != nullptr) {
    const float* v = vals + i * W;
    float* t = target + g * W;
    for (int w = 0; w < W; ++w) atomic_combine(t + w, v[w], op);
  }
  if (counts != nullptr) atomicAdd(&counts[g], 1);
  if (has != nullptr && has[g] == 0) has[g] = 1;
}

template <typename I>
cudaError_t launch(const I* idx, long long N, const float* vals, int W,
                   long long G, int op, float neutral, float* target,
                   int32_t* counts, uint8_t* has, float* part,
                   cudaStream_t st) {
  const Plan p = plan(N, vals, W, G);
  if (p.path != kGlobal && part == nullptr) return cudaErrorInvalidValue;
  const int g = static_cast<int>(G);
  if (p.path == kRegs) {
    auto kernel = op == 0 ? scatter_ids_regs<I, 0>
                          : (op == 1 ? scatter_ids_regs<I, 1>
                                     : scatter_ids_regs<I, 2>);
    kernel<<<p.blocks, kThreads, 0, st>>>(idx, N, vals, W, g, p.Q, neutral,
                                          part);
  } else if (p.path == kShared) {
    const size_t smem = static_cast<size_t>(kWarps) * ((p.cells + 3) & ~3) * 4;
    auto kernel = p.vec ? scatter_ids_shared<I, true>
                        : scatter_ids_shared<I, false>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<p.blocks, kThreads, smem, st>>>(idx, N, vals, W, g, p.Q, op,
                                             neutral, part);
  } else {
    const int threads = 256;
    const long long blocks = (N + threads - 1) / threads;
    scatter_ids_global<I><<<static_cast<unsigned int>(blocks), threads, 0,
                            st>>>(idx, N, vals, W, G, op, target, counts,
                                  has);
    return cudaGetLastError();
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int GW = vals != nullptr ? g * W : 0;
  scatter_ids_fold<<<(p.cells + kFoldCells - 1) / kFoldCells,
                     kFoldCells * kFoldSlices, 0, st>>>(
      part, p.blocks, GW, p.cells, op, neutral, target, counts, has);
  return cudaGetLastError();
}

}  // namespace

// The block paths' scratch, in 4-byte words (their blocks' partial
// copies), for these shapes and this values pointer; 0 when they take the
// global path.
extern "C" long long scatter_ids_scratch(long long N, const void* vals, int W,
                                         long long G) {
  const Plan p = plan(N, static_cast<const float*>(vals), W, G);
  return p.path == kGlobal ? 0 : static_cast<long long>(p.blocks) * p.cells;
}

// idx_bytes 4 (int32 ids) or 8 (int64); vals, counts and has may be null
// (target too when vals is); op 0 add, 1 min, 2 max. part (the words
// scatter_ids_scratch asks for) is the block paths' scratch.
extern "C" int scatter_ids(const void* idx, int idx_bytes, long long N,
                           const void* vals, int W, long long G, int op,
                           float neutral, void* target, void* counts,
                           void* has, void* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  const float* v = static_cast<const float*>(vals);
  float* t = static_cast<float*>(target);
  int32_t* c = static_cast<int32_t*>(counts);
  uint8_t* h = static_cast<uint8_t*>(has);
  float* pw = static_cast<float*>(part);
  cudaError_t e =
      idx_bytes == 8
          ? launch(static_cast<const long long*>(idx), N, v, W, G, op,
                   neutral, t, c, h, pw, st)
          : launch(static_cast<const int32_t*>(idx), N, v, W, G, op,
                   neutral, t, c, h, pw, st);
  return static_cast<int>(e);
}
