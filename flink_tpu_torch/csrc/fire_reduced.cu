// G4 fire_reduced — evaluate the due windows for every key and reduce each
// fire lane to (emitted keys, value sum) on the device.
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// _eval_fire_lanes (:1203) plus the per-lane reduction of
// advance_and_fire_resident with reduced=True (:1507-1520), which equals
// reduce_fires (:1068) over the lane set (kernel K5), for the builtin
// reduces on packed planes: sum and count (add), min and max, with W >= 1
// value columns (kernel K7: mean's [sum, count] is W = 2); and, with a
// fresh plane, the allowed-lateness re-fire lanes of advance_and_fire
// (:1309-1423, kernel K11), lanes f >= n_ontime, which emit the slots
// whose fresh flag is set (fire_eval.cuh). The scalar fire plan (_fire_plan,
// _purge_plan, the late lanes' selection) runs before this kernel as small
// torch ops on the device, and hands it the per-lane window-end pane
// p_f[F] and the lane_ok[F] flags without a host round trip.
//
// Semantics (fire_eval.cuh PlaneSrc): a key is emitted when any of its k
// rows counts (on-time lanes) or is fresh (re-fire lanes); its value
// combines the touched rows from the neutral, in pane order. A lane's value
// sum adds every value column of every emitted key, as reduce_fires does.
// The kernel writes every lane of counts and vsums, 0 for a lane not due.
//
// Bound: bytes. A due lane reads its present rows of the packed plane,
// 4 (W+1) bytes x C each (plus C fresh bytes each for a re-fire lane):
// 8 MB per lane at C = 1M, k = 1, W = 1, about 2.4 us at 3.35 TB/s. A lane
// that is not due reads nothing. (chip_smoke.py times one Tensor.sum over
// the same rows beside the kernel: on the H100 a read of these sizes stays
// well under 3.35 TB/s.)
//
// Design: one launch a call, no fill. The grid is kBlocksPerSM blocks a
// multiprocessor, fewer when a lane has fewer tiles. Every block first
// tests lane_ok[F]: on a quiet call (no lane due) block 0 writes the
// zeros and every block exits, one short launch. Otherwise a block walks
// the due lanes in order; for each it resolves the lane's k pane rows once
// into shared memory (fire_eval.cuh window_rows) and takes the lane's
// tiles t = blockIdx.x, + gridDim.x, ...; a thread keeps several 16-byte
// loads in flight:
//   * VEC (W = 1): two cells a float4, 8 rounds of a warp's 64 cells, the
//     loads of two panes issued before any is combined (16 in flight a
//     thread for k > 1), the panes then combined in pane order; a re-fire
//     lane reads its fresh bytes four a word (each lane of a warp one word
//     for two rounds) and hands them round by warp shuffles. G6's reader
//     (fire_eval.cuh eval_rounds: a pane's loads at a time, two fresh
//     bytes a load) measured 5 % slower at k = 1 and 1.4-1.6x slower at
//     k = 5 and on re-fire lanes (PERF.md §6). An odd C or an unaligned
//     plane (or fresh plane) takes the CELL path: one float2 a cell, 4
//     rounds (eval_rounds).
//   * VEC3 (W = 2, mean's [sum, count]): four 12-byte cells three float4, 4
//     rounds of a warp's 128 cells, fresh bytes a word a round; a C that is
//     not a multiple of 4 takes the STAGED path.
//   * STAGED (other W): the block copies a tile of each pane into shared
//     memory with 16-byte loads (4-byte loads when the rows are not
//     16-byte aligned), the loads of up to Stage::kPanes panes in flight in
//     registers, and each thread then evaluates its cells from shared
//     memory; fresh bytes come four a word into shared memory too.
// Each block reduces its (count, sum) for each due lane and stores them, in
// two 64-bit words tagged with the call's tag, in its slot of a scratch
// cached per device and stream (ops/cuda.py _stream_scratch); it then
// takes a ticket. The block that draws the last ticket folds each due
// lane's slots in block order (each thread a stride of blocks, then
// block_sum's fixed tree), reading each word until it carries the call's
// tag (no fence, as G1's fold), writes counts and vsums, resets the ticket
// and advances the count of calls that makes the next call's tag. Float
// sums therefore add in the same order on every run of the same input and
// grid. The tag lives on the device: no epoch comes from the host.

#include "fire_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
// VEC (W = 1): two cells a float4, kVecRounds rounds of a warp's 64
// cells, the loads of kVecPanes panes in flight (a one-pane window's 8, a
// longer one's 16); CELL: a float2 a cell, kCellRounds rounds
constexpr int kVecRounds = 8;
constexpr int kVecPanes = 2;
constexpr int kCellRounds = 4;
// VEC3 (W = 2): four 12-byte cells three float4, kVec3Rounds rounds of a
// warp's 128 cells, a pane at a time
constexpr int kVec3Rounds = 4;

enum Path { kVec = 0, kVec3 = 1, kCell = 2, kStaged = 3 };

constexpr int kVecTile = kThreads * 2 * kVecRounds;    // 4,096 cells
constexpr int kCellTile = kThreads * kCellRounds;      // 1,024 cells
constexpr int kVec3Tile = kThreads * 4 * kVec3Rounds;  // 4,096 cells

// STAGED: cells a tile, float4 loads a thread and a pane, panes in flight
template <int kW>
struct Stage {
  static constexpr int kTile = kW == 2 ? 1024 : 256;
  static constexpr int kCellsPerThread = kTile / kThreads;
  static constexpr int kFloats = kTile * ((kW ? kW : kMaxW) + 1);
  static constexpr int kVecs = (kFloats / 4 + kThreads - 1) / kThreads;
  static constexpr int kPanes = kW == 2 ? 4 : 2;
};

// The scratch: the ticket and the count of calls, then [F][gridDim.x]
// count words and [F][gridDim.x] sum words, each tag << 32 | 32 bits.
struct Fold {
  unsigned int* ticket;
  unsigned int* calls;
  unsigned long long* cnt;
  unsigned long long* sum;
};

__device__ __forceinline__ unsigned long long tagged(unsigned int tag,
                                                     uint32_t bits) {
  return static_cast<unsigned long long>(tag) << 32 | bits;
}

// ---------------------------------------------------------------- VEC

template <int kOp>
__device__ __forceinline__ void vec_tile(const PlaneSrc<1, kOp>& src,
                                         bool late, const int32_t* rows,
                                         int tile, int32_t& n, float& sum) {
  constexpr int kR = kVecRounds, kP = kVecPanes;
  static_assert(kR % 2 == 0, "fresh words cover two rounds");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = src.C;
  const float nt = src.neutral;
  // the warp's cells: kR rounds of 64; the thread's two a round
  const int wbase = tile * kVecTile + warp * 64 * kR;
  const int c0 = wbase + 2 * lane;
  float v[kR][2];
  unsigned bits[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    v[r][0] = v[r][1] = nt;
    bits[r] = 0u;
  }
  for (int j0 = 0; j0 < src.k; j0 += kP) {
    float4 a[kP][kR];
    uint32_t fw[kP][kR / 2];
    // every pane's loads first
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int j = j0 + p;
      const int32_t row = j < src.k ? rows[j] : -1;
      const size_t rb = static_cast<size_t>(row < 0 ? 0 : row) * C;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int c = c0 + r * 64;
        a[p][r] = row >= 0 && c < C
                      ? *reinterpret_cast<const float4*>(src.acc +
                                                         (rb + c) * 2)
                      : make_float4(nt, nt, nt, nt);
      }
#pragma unroll
      for (int h = 0; h < kR / 2; ++h) {
        const int c = wbase + 128 * h + 4 * lane;
        fw[p][h] = late && row >= 0 && c < C
                       ? *reinterpret_cast<const uint32_t*>(src.fresh + rb +
                                                            c)
                       : 0u;
      }
    }
    // then the combine, in pane order
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int j = j0 + p;
      if (j >= src.k || rows[j] < 0) continue;  // uniform per block
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 q = a[p][r];
        if (q.y != nt) v[r][0] = combine_op(kOp, v[r][0], q.x);
        if (q.w != nt) v[r][1] = combine_op(kOp, v[r][1], q.z);
        if (late) {
          // round r's two fresh bytes: word (r & 1) * 16 + lane / 2 of the
          // round pair, bytes 2 (lane & 1) and 2 (lane & 1) + 1
          const uint32_t w = __shfl_sync(0xffffffffu, fw[p][r / 2],
                                         (r & 1) * 16 + (lane >> 1));
          const uint32_t two = w >> (16 * (lane & 1));
          bits[r] |= ((two & 0xffu) != 0u ? 1u : 0u) |
                     ((two & 0xff00u) != 0u ? 2u : 0u);
        } else {
          bits[r] |= (q.y != nt ? 1u : 0u) | (q.w != nt ? 2u : 0u);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if ((bits[r] >> s) & 1u) {
        ++n;
        sum += v[r][s];
      }
    }
  }
}

// --------------------------------------------------------------- VEC3

template <int kOp>
__device__ __forceinline__ void vec3_tile(const PlaneSrc<2, kOp>& src,
                                          bool late, const int32_t* rows,
                                          int tile, int32_t& n, float& sum) {
  constexpr int kR = kVec3Rounds;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = src.C;
  const float nt = src.neutral;
  // the thread's four cells a round: c0 + 128 r .. + 3
  const int c0 = tile * kVec3Tile + warp * 128 * kR + 4 * lane;
  float v[kR][4][2];
  unsigned bits[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    bits[r] = 0u;
#pragma unroll
    for (int s = 0; s < 4; ++s) v[r][s][0] = v[r][s][1] = nt;
  }
  for (int j = 0; j < src.k; ++j) {
    const int32_t row = rows[j];
    if (row < 0) continue;  // uniform per block
    const size_t rb = static_cast<size_t>(row) * C;
    float4 a[kR][3];
    uint32_t fw[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int c = c0 + 128 * r;
      const float4* q = reinterpret_cast<const float4*>(src.acc +
                                                        (rb + c) * 3);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        a[r][e] = c < C ? q[e] : make_float4(nt, nt, nt, nt);
      }
      fw[r] = late && c < C
                  ? *reinterpret_cast<const uint32_t*>(src.fresh + rb + c)
                  : 0u;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      // cell s: (sum, count, touch) at floats 3 s .. 3 s + 2 of the twelve
      const float f[12] = {a[r][0].x, a[r][0].y, a[r][0].z, a[r][0].w,
                           a[r][1].x, a[r][1].y, a[r][1].z, a[r][1].w,
                           a[r][2].x, a[r][2].y, a[r][2].z, a[r][2].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bool t = f[3 * s + 2] != nt;
        if (t) {
          v[r][s][0] = combine_op(kOp, v[r][s][0], f[3 * s]);
          v[r][s][1] = combine_op(kOp, v[r][s][1], f[3 * s + 1]);
        }
        const bool e = late ? ((fw[r] >> (8 * s)) & 0xffu) != 0u : t;
        bits[r] |= e ? 1u << s : 0u;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if ((bits[r] >> s) & 1u) {
        ++n;
        sum += v[r][s][0];
        sum += v[r][s][1];
      }
    }
  }
}

// ---------------------------------------------------------------- CELL

template <int kOp>
__device__ __forceinline__ void cell_tile(const PlaneSrc<1, kOp>& src, int f,
                                          const int32_t* rows, int tile,
                                          int32_t& n, float& sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = tile * kCellTile + warp * 32 * kCellRounds + lane;
  float v[kCellRounds][1][1];
  unsigned bits[kCellRounds];
  src.template eval_rounds<1, kCellRounds, 1>(f, rows, c0, 32, v, bits);
#pragma unroll
  for (int r = 0; r < kCellRounds; ++r) {
    if (bits[r]) {
      ++n;
      sum += v[r][0][0];
    }
  }
}

// -------------------------------------------------------------- STAGED

template <int kW, int kOp>
__device__ __forceinline__ void staged_tile(const PlaneSrc<kW, kOp>& src,
                                            bool late, bool vec4, bool fw4,
                                            const int32_t* rows, int tile,
                                            float* s_buf, uint32_t* s_fresh,
                                            int32_t& n, float& sum) {
  using S = Stage<kW>;
  constexpr int kNV = kW ? kW : kMaxW;
  const int nw = src.W();
  const int Wc = nw + 1;
  const int C = src.C;
  const float nt = src.neutral;
  const int c0 = tile * S::kTile;
  const int cells = min(S::kTile, C - c0);
  const int nfl = cells * Wc;  // floats of the tile in a row
  float v[S::kCellsPerThread][kNV];
  bool emit[S::kCellsPerThread];
#pragma unroll
  for (int m = 0; m < S::kCellsPerThread; ++m) {
    emit[m] = false;
#pragma unroll
    for (int w = 0; w < kNV; ++w) v[m][w] = nt;
  }
  for (int j0 = 0; j0 < src.k; j0 += S::kPanes) {
    float4 q[S::kPanes][S::kVecs];
    uint32_t fq[S::kPanes];
    // every pane's loads first: the tile's floats as float4 i = tid + 256 e
#pragma unroll
    for (int p = 0; p < S::kPanes; ++p) {
      const int j = j0 + p;
      const int32_t row = j < src.k ? rows[j] : -1;
      const size_t rc = static_cast<size_t>(row < 0 ? 0 : row) * C + c0;
      const float* base = src.acc + rc * Wc;
#pragma unroll
      for (int e = 0; e < S::kVecs; ++e) {
        const int i = threadIdx.x + kThreads * e;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row >= 0 && 4 * i < nfl) {
          if (vec4 && 4 * i + 4 <= nfl) {
            x = *reinterpret_cast<const float4*>(base + 4 * i);
          } else {
            x.x = base[4 * i];
            if (4 * i + 1 < nfl) x.y = base[4 * i + 1];
            if (4 * i + 2 < nfl) x.z = base[4 * i + 2];
            if (4 * i + 3 < nfl) x.w = base[4 * i + 3];
          }
        }
        q[p][e] = x;
      }
      fq[p] = 0u;
      const int b = 4 * static_cast<int>(threadIdx.x);
      if (late && row >= 0 && b < cells) {
        const uint8_t* fr = src.fresh + rc + b;
        if (fw4 && b + 4 <= cells) {
          fq[p] = *reinterpret_cast<const uint32_t*>(fr);
        } else {
          for (int u = 0; u < 4 && b + u < cells; ++u) {
            fq[p] |= static_cast<uint32_t>(fr[u]) << (8 * u);
          }
        }
      }
    }
    // then pane by pane, in pane order, through shared memory
#pragma unroll
    for (int p = 0; p < S::kPanes; ++p) {
      const int j = j0 + p;
      if (j >= src.k || rows[j] < 0) continue;  // uniform per block
#pragma unroll
      for (int e = 0; e < S::kVecs; ++e) {
        const int i = threadIdx.x + kThreads * e;
        if (4 * i < S::kFloats) reinterpret_cast<float4*>(s_buf)[i] = q[p][e];
      }
      if (late && 4 * static_cast<int>(threadIdx.x) < S::kTile) {
        s_fresh[threadIdx.x] = fq[p];
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < S::kCellsPerThread; ++m) {
        const int c = threadIdx.x + kThreads * m;
        if (c >= cells) continue;
        const float* cell = s_buf + c * Wc;
        const float t = cell[nw];
        if (t != nt) {
#pragma unroll
          for (int w = 0; w < kNV; ++w) {
            if (w < nw) v[m][w] = combine_op(kOp, v[m][w], cell[w]);
          }
        }
        emit[m] |= late ? reinterpret_cast<const uint8_t*>(s_fresh)[c] != 0
                        : t != nt;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int m = 0; m < S::kCellsPerThread; ++m) {
    if (!emit[m]) continue;
    ++n;
#pragma unroll
    for (int w = 0; w < kNV; ++w) {
      if (w < nw) sum += v[m][w];
    }
  }
}

// -------------------------------------------------------------- kernel

template <class Src, int kPath>
__global__ void __launch_bounds__(kThreads)
    fire_reduced_kernel(Src src, const uint8_t* __restrict__ lane_ok, int F,
                        int n_tiles, bool vec4, bool fw4,
                        int32_t* __restrict__ counts,
                        float* __restrict__ vsums, Fold fd) {
  constexpr int kW = Src::kWidth;
  using S = Stage<kW>;
  // STAGED: a pane's tile of cells and its fresh bytes
  constexpr int kBufFloats = kPath == kStaged ? S::kFloats : 4;
  constexpr int kFreshWords = kPath == kStaged ? S::kTile / 4 : 1;
  __shared__ __align__(16) float s_buf[kBufFloats];
  __shared__ uint32_t s_fresh[kFreshWords];
  __shared__ int32_t s_row[kMaxPanes];
  __shared__ bool s_last;
  // a quiet call: block 0 writes the zeros, every block exits
  int any = 0;
  for (int f = threadIdx.x; f < F; f += kThreads) any |= lane_ok[f];
  if (!__syncthreads_or(any)) {
    if (blockIdx.x == 0) {
      for (int f = threadIdx.x; f < F; f += kThreads) {
        counts[f] = 0;
        vsums[f] = 0.0f;
      }
    }
    return;
  }
  // this call's tag: never 0, so the zeroed scratch holds no call's word
  unsigned int tag = __ldcg(fd.calls) + 1u;
  tag += tag == 0u;
  const int G = gridDim.x;
  for (int f = 0; f < F; ++f) {
    if (!lane_ok[f]) continue;  // uniform per block
    src.prepare(f, s_row);
    const bool late = src.fresh != nullptr && f >= src.n_ontime;
    int32_t n = 0;
    float sum = 0.0f;
    for (int t = blockIdx.x; t < n_tiles; t += G) {
      if constexpr (kPath == kVec) {
        vec_tile(src, late, s_row, t, n, sum);
      } else if constexpr (kPath == kVec3) {
        vec3_tile(src, late, s_row, t, n, sum);
      } else if constexpr (kPath == kCell) {
        cell_tile(src, f, s_row, t, n, sum);
      } else {
        staged_tile(src, late, vec4, fw4, s_row, t, s_buf, s_fresh, n, sum);
      }
    }
    n = block_sum(n);  // syncs: s_row is free for the next lane after it
    sum = block_sum(sum);
    if (threadIdx.x == 0) {
      const size_t at = static_cast<size_t>(f) * G + blockIdx.x;
      reinterpret_cast<volatile unsigned long long*>(fd.cnt)[at] =
          tagged(tag, static_cast<uint32_t>(n));
      reinterpret_cast<volatile unsigned long long*>(fd.sum)[at] =
          tagged(tag, __float_as_uint(sum));
    }
  }
  if (threadIdx.x == 0) s_last = atomicAdd(fd.ticket, 1u) == G - 1;
  __syncthreads();
  if (!s_last) return;
  // The last block: every block has stored its words, maybe not yet where
  // this block reads them; each is read until it carries the call's tag.
  // Each thread a stride of blocks in order, then block_sum's fixed tree:
  // the same order on every run.
  for (int f = 0; f < F; ++f) {
    if (!lane_ok[f]) {  // uniform per block
      if (threadIdx.x == 0) {
        counts[f] = 0;
        vsums[f] = 0.0f;
      }
      continue;
    }
    int32_t n = 0;
    float sum = 0.0f;
    const volatile unsigned long long* pc = fd.cnt + static_cast<size_t>(f) * G;
    const volatile unsigned long long* ps = fd.sum + static_cast<size_t>(f) * G;
    for (int b = threadIdx.x; b < G; b += kThreads) {
      unsigned long long wc, ws;
      do {
        wc = pc[b];
        ws = ps[b];
      } while (static_cast<unsigned int>(wc >> 32) != tag ||
               static_cast<unsigned int>(ws >> 32) != tag);
      n += static_cast<int32_t>(static_cast<uint32_t>(wc));
      sum += __uint_as_float(static_cast<uint32_t>(ws));
    }
    n = block_sum(n);
    sum = block_sum(sum);
    if (threadIdx.x == 0) {
      counts[f] = n;
      vsums[f] = sum;
    }
  }
  if (threadIdx.x == 0) {
    *fd.ticket = 0u;  // for the next call on this scratch
    *fd.calls = tag;  // the next call's tag is one more
  }
}

int blocks_cap() { return kBlocksPerSM * sm_count(); }

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// The read path and tile a call takes, from its width, C and alignments:
// VEC for W = 1 where the rows keep a float4's alignment (and a fresh
// plane's word), else CELL; VEC3 for W = 2 where they keep it for
// four cells (and a fresh plane's word), else STAGED, as any other W.
struct Pick {
  Path path;
  int tile;
};

template <int kW>
Pick pick(int C, bool acc16, bool has_fresh, bool fresh4) {
  if (kW == 1) {
    if (C % 2 == 0 && acc16 && (!has_fresh || fresh4)) {
      return {kVec, kVecTile};
    }
    return {kCell, kCellTile};
  }
  if (kW == 2 && C % 4 == 0 && acc16 && (!has_fresh || fresh4)) {
    return {kVec3, kVec3Tile};
  }
  return {kStaged, Stage<kW>::kTile};
}

struct Launch {
  const uint8_t* lane_ok;
  int F;
  int32_t* counts;
  float* vsums;
  Fold fd;
  cudaStream_t s;

  template <class Src, int kPath>
  void go(const Src& src, int tile, bool vec4, bool fw4) const {
    const int n_tiles = (src.C + tile - 1) / tile;
    int grid = n_tiles < blocks_cap() ? n_tiles : blocks_cap();
    if (grid < 1) grid = 1;
    fire_reduced_kernel<Src, kPath><<<grid, kThreads, 0, s>>>(
        src, lane_ok, F, n_tiles, vec4, fw4, counts, vsums, fd);
  }

  template <class Src>
  void operator()(const Src& src) const {
    constexpr int kW = Src::kWidth;
    const bool has_fresh = src.fresh != nullptr;
    const bool fw4 = !has_fresh || (src.C % 4 == 0 && aligned(src.fresh, 4));
    const Pick p = pick<kW>(src.C, aligned(src.acc, 16), has_fresh, fw4);
    if constexpr (kW == 1) {
      if (p.path == kVec) {
        go<Src, kVec>(src, p.tile, true, true);
      } else {
        go<Src, kCell>(src, p.tile, false, false);
      }
    } else {
      if constexpr (kW == 2) {
        if (p.path == kVec3) {
          go<Src, kVec3>(src, p.tile, true, true);
          return;
        }
      }
      // (W_rt: the host's W; PlaneSrc::W() is the device's)
      const bool vec4 = aligned(src.acc, 16) &&
                        (static_cast<long long>(src.C) * (src.W_rt + 1)) %
                                4 == 0;
      go<Src, kStaged>(src, p.tile, vec4, fw4);
    }
  }
};

}  // namespace

// The cells a tile of the read path that a call of width W over C slots
// takes, its planes 16-byte aligned (what the tests build their tile edges
// from).
extern "C" int fire_reduced_tile(int W, int C, int has_fresh) {
  const bool f = has_fresh != 0;
  if (W == 1) return pick<1>(C, true, f, true).tile;
  if (W == 2) return pick<2>(C, true, f, true).tile;
  return pick<0>(C, true, f, true).tile;
}

// The scratch a call over F lanes needs, in int64 words: the ticket and the
// count of calls, then two words a (lane, block) for the largest grid.
extern "C" long long fire_reduced_scratch_words(int F) {
  return 2 + 2LL * (F > 0 ? F : 0) * blocks_cap();
}

// scratch: fire_reduced_scratch_words(F) int64 words, zeroed before the
// first call on its stream; the kernel leaves it ready for the next.
extern "C" int fire_reduced(const void* acc, int W, int op, float neutral,
                            const void* fresh, int n_ontime,
                            const void* pane_ids, const void* p_f,
                            const void* lane_ok, int C, int R, int k, int F,
                            void* counts, void* vsums, void* scratch,
                            long long scratch_words, void* stream) {
  if (k < 1 || k > kMaxPanes || W < 1 || W > kMaxW || op < 0 || op > 2 ||
      C < 0 || scratch_words < fire_reduced_scratch_words(F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F <= 0) return static_cast<int>(cudaGetLastError());
  const PlaneArgs args{static_cast<const float*>(acc),
                       static_cast<const uint8_t*>(fresh),
                       static_cast<const int32_t*>(pane_ids),
                       static_cast<const int32_t*>(p_f), n_ontime, W, neutral,
                       C, R, k};
  auto* words = static_cast<unsigned long long*>(scratch);
  const long long per = static_cast<long long>(F) * blocks_cap();
  const Fold fd{reinterpret_cast<unsigned int*>(words),
                reinterpret_cast<unsigned int*>(words) + 1, words + 2,
                words + 2 + per};
  with_plane(args, op,
             Launch{static_cast<const uint8_t*>(lane_ok), F,
                    static_cast<int32_t*>(counts), static_cast<float*>(vsums),
                    fd, static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
