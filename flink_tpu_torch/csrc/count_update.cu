// G12 count_update — per-key tumbling windows of N elements for one
// micro-batch, over the lanes in G10's slot order.
//
// Replaces (flink_tpu, the JAX reference): ops/count_windows.py update
// (:57, kernel K17) after its upsert and sort: each lane's 1-based position
// within its key (a segmented count), its absolute index a = old_count +
// pos and window w = (a - 1) // N, the segmented reduce over (slot, w), the
// key's carried partial folded into its first window (:98-106), the
// complete windows (a a multiple of N) as fire rows, and the tail partial,
// the count and `touched` written back (:116-124).
//
// Inputs: key_s (uint64 [B], the slot or C), seg_start (uint8 [B]), order
// (int32 [B]) from G10; hi, lo, vals (lane order); the state count (int32
// [C]), acc (float32 [C]) and touched (uint8 [C]), written in place.
// Outputs: the fire rows (key hi, key lo, window ordinal, value) at rows 0,
// 1, ... in sorted-lane order, as the reference's mask over its sorted
// lanes orders them, and their count n_rows, which the kernel writes. Every
// fire fits in the B rows.
//
// Bound: bytes. Per lane: key (8 B), flag (1 B), order (4 B) and value
// (4 B); per fire: hi and lo through the order (8 B) and the row (16 B);
// per key of the batch count, acc and touched read and written (9 B
// each). About 6.5 MB at the windowcount batch: 2 us at 3.35 TB/s. A call
// pays for its dependent steps (launch, loads, gathers, look-backs) more
// than for its bytes.
//
// Design: one launch a call, no fill and no allocation (the parent took
// ten kernels and two fills: three scan passes for the position, three
// for the window reduce, ring.cuh's three for the rows, a write-back). A
// block a tile of kTile sorted lanes (kLanes a thread), tiles in block
// order. Each thread loads its lanes' keys, flags and orders and gathers
// their values; the lane that heads a key's run in the tile (a segment
// start, or the tile's first lane) gathers the key's count, acc and
// touched into shared memory for the run. Three device-tagged decoupled
// look-backs (lookback.cuh's status words, tagged with the call; a tile
// waits only on tiles before it) carry what crosses tiles:
//   1. START (a max-scan of segment-start indices): a tile publishes the
//      last segment start it holds (inclusive), or that it holds none (an
//      aggregate), once its state reads are in. Only a tile whose first
//      lane continues a segment looks back, to the nearest inclusive word.
//      The position is then i - start + 1, a wraps as int32 (add_wrap),
//      and the window flags (a segment start, or (a - 1) mod N == 0) and
//      the fires (a mod N == 0) are known lane by lane.
//   2. SUM (a segmented sum of (window flag, value)): a tile holding a
//      window start publishes its tail sum as inclusive, else its whole
//      sum as an aggregate; only a tile whose first lane continues a window
//      looks back, summing aggregates back to the nearest inclusive word.
//      This holds for every N >= 1 (a window of N above the tile crosses
//      tiles that hold no window start).
//   3. FIRE (a count look-back from base 0): each fire's row is the tile's
//      offset plus its rank in the tile; the last tile writes n_rows and
//      advances the count of calls (the tag's source).
// A look-back is one warp's: rows of 32 consecutive status words, kBack
// rows loaded at once. Warp 0 runs SUM's and warp 1 FIRE's at once; the hi
// and lo of the fired lanes are loaded while they wait. The write-back
// stores only the words that change (count always; acc and touched when
// their bits do).
//
// The write-back hazard. A key's lanes may span many tiles (a hot word,
// one key in every lane). The tile holding a key's last lane writes its
// count, acc and touched; every tile holding an earlier lane of the key
// reads the old values. A tile's state reads come before the barrier
// after which its thread 0 fences (acq_rel, the card's scope) and
// publishes START. A tile whose first lane continues a key looks back on
// START to a word of a tile that holds the key's start, or of a tile whose
// own look-back reached one and which fenced before it published, so it
// has seen every tile between publish; it fences after its look-back, and
// only then (past a barrier) do its threads write state. A key wholly
// inside one tile is read and written by that tile's block, around its
// barriers.
//
// Fire rows, n_rows, count, acc and touched are bit-equal to the plain
// version on integer-valued data; float sums add in another association
// than the plain scan's (rtol 1e-6). The status words hold values below
// 2^30: the wrapper refuses B > 2^30 - kTile. Scratch (ops/cuda.py
// _stream_scratch("count_update"), per device and stream, zeroed once):
// the count of calls, then four status words a tile (START, SUM inclusive,
// SUM aggregate, FIRE).

#include "lookback.cuh"
#include "segscan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;                      // lanes a thread
constexpr int kTile = kThreads * kLanes;       // 1,024; ops/cuda.py COUNT_TILE

struct Args {
  const unsigned long long* key_s;
  const uint8_t* seg_start;
  const int32_t* order;
  const uint32_t* hi;
  const uint32_t* lo;
  const float* vals;
  int B, C, N;
  DivMagic dm;        // division by N
  bool vec;           // key_s and order 16-byte, seg_start 4-byte aligned
  int32_t* count;
  float* acc;
  uint8_t* touched;
  uint32_t* r_hi;
  uint32_t* r_lo;
  int32_t* r_w;
  float* r_val;
  int32_t* n_rows;
  uint32_t* calls;                 // the count of calls (the tag)
  unsigned long long* start_st;    // [tiles] START
  unsigned long long* inc_st;      // [tiles] SUM's inclusive sums
  unsigned long long* agg_st;      // [tiles] SUM's aggregates
  unsigned long long* fire_st;     // [tiles] FIRE
};

struct SumOp {  // segscan.cuh's block scan of (window flag, value)
  using V = float;
  __device__ static float op(float a, float b) { return a + b; }
};

__device__ __forceinline__ int32_t mod_n(int32_t a, int32_t q, int N) {
  // a - q N for q = floor(a / N), wrapping (the true value is in [0, N))
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(q) *
                                  static_cast<uint32_t>(N));
}

// A release (before a publish) or acquire (after a look-back) fence at
// the card's scope: lighter than __threadfence's sequentially consistent
// one, and all these orderings need.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void publish_float(unsigned long long* p,
                                              uint32_t tag, float v) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
}

// A tile's START or FIRE word (lookback.cuh's format): value and flag.
struct CountWord {
  const volatile unsigned long long* st;
  uint32_t tag;
  using Raw = unsigned long long;
  using T = int32_t;
  __device__ Raw load(int idx) const { return st[idx]; }
  __device__ bool ready(Raw w) const {
    return static_cast<uint32_t>(w >> 32) == tag;
  }
  __device__ bool inclusive(Raw w) const {
    return (w & kLbFlags) == kLbInclusive;
  }
  __device__ T value(Raw w) const {
    return static_cast<int32_t>(w & kLbCountMask);
  }
};

// A tile's SUM words: its inclusive sum, else its aggregate, each tagged
// alone (a reader takes the inclusive one when both are published).
struct SumWord {
  const volatile unsigned long long* inc;
  const volatile unsigned long long* agg;
  uint32_t tag;
  struct Raw {
    unsigned long long i, a;
  };
  using T = float;
  __device__ Raw load(int idx) const { return Raw{inc[idx], agg[idx]}; }
  __device__ bool ready(const Raw& w) const {
    return static_cast<uint32_t>(w.i >> 32) == tag ||
           static_cast<uint32_t>(w.a >> 32) == tag;
  }
  __device__ bool inclusive(const Raw& w) const {
    return static_cast<uint32_t>(w.i >> 32) == tag;
  }
  __device__ T value(const Raw& w) const {
    return __uint_as_float(static_cast<uint32_t>(inclusive(w) ? w.i : w.a));
  }
};

// One warp: the sum of the tiles' values from the nearest inclusive word
// before `tile` (its value included) up to the tile; before tile 0 an
// inclusive 0. Lane l reads the words at distance l + 1, l + 33, ... (kBack
// rows of 32 consecutive words, loaded at once); row by row, the words not
// yet published up to the row's nearest inclusive word are reloaded
// together until they are, and the first row that holds an inclusive word
// ends the look-back. Every tile publishes
// its aggregate (START: 0 when it holds no segment start) before it looks
// back, so a row waits on no other tile's look-back.
constexpr int kBack = 8;

template <class W>
__device__ typename W::T look_back(const W& words, int tile) {
  using T = typename W::T;
  const int lane = threadIdx.x & 31;
  T run = T(0);
  for (int pred = tile - 1; pred >= 0; pred -= 32 * kBack) {
    typename W::Raw r[kBack];
#pragma unroll
    for (int j = 0; j < kBack; ++j) {
      const int idx = pred - 32 * j - lane;
      if (idx >= 0) r[j] = words.load(idx);
    }
#pragma unroll
    for (int j = 0; j < kBack; ++j) {
      const int idx = pred - 32 * j - lane;
      while (true) {
        const bool rdy = idx < 0 || words.ready(r[j]);
        const unsigned ready = __ballot_sync(0xffffffffu, rdy);
        const unsigned inc = __ballot_sync(
            0xffffffffu, idx < 0 || (rdy && words.inclusive(r[j])));
        const int stop = inc ? __ffs(inc) - 1 : 31;
        const unsigned need = stop == 31 ? 0xffffffffu : (2u << stop) - 1u;
        if ((ready & need) == need) {  // the words up to the nearest
          const T v = idx >= 0 && lane <= stop ? words.value(r[j]) : T(0);
          run += warp_sum(v);          // lane 0's is the sum
          run = __shfl_sync(0xffffffffu, run, 0);
          if (inc) return run;
          break;                       // 32 aggregates: the next row
        }
        if (!rdy && lane <= stop) r[j] = words.load(idx);
      }
    }
  }
  return run;
}

__global__ void __launch_bounds__(kThreads) count_update_kernel(Args a) {
  __shared__ uint32_t s_tag;
  __shared__ uint8_t s_ss[kThreads + 1];  // each thread's start bits, and
                                          // the next tile's first lane's
  __shared__ int32_t s_wmax[kWarps];
  __shared__ SegPair<float> s_pair[kThreads];
  __shared__ bool s_wcont;      // the tile's first lane continues a window
  __shared__ int32_t s_start;   // START's carry into the tile
  __shared__ float s_sum;       // SUM's carry into the tile
  __shared__ uint32_t s_row0;   // the tile's first fire row
  __shared__ int32_t s_cnt[kTile];  // the keys' state, at their heads
  __shared__ float s_acc[kTile];
  __shared__ uint8_t s_tou[kTile];
  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int B = a.B, C = a.C, N = a.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = t0 + kLanes * tid;   // the thread's first lane
  // the count of calls (the tag) and whether the next tile's first lane
  // starts a segment: read by thread 0 beside the lanes' loads
  uint32_t calls = 0u, next_start = 1u;
  if (tid == 0) {
    calls = __ldcg(a.calls);
    if (t0 + kTile < B) next_start = a.seg_start[t0 + kTile] ? 1u : 0u;
  }

  // 1. the lanes' keys, start flags and orders; lanes past B are dead and
  // start segments
  unsigned long long key[kLanes];
  uint32_t ss = 0u;  // bit q: lane q starts a segment
  int32_t ord[kLanes];
  if (a.vec && first + kLanes <= B) {
    const ulonglong2 k01 =
        *reinterpret_cast<const ulonglong2*>(a.key_s + first);
    const ulonglong2 k23 =
        *reinterpret_cast<const ulonglong2*>(a.key_s + first + 2);
    const uint32_t f =
        *reinterpret_cast<const uint32_t*>(a.seg_start + first);
    const int4 o = *reinterpret_cast<const int4*>(a.order + first);
    key[0] = k01.x, key[1] = k01.y, key[2] = k23.x, key[3] = k23.y;
    ss = (f & 0xffu ? 1u : 0u) | (f & 0xff00u ? 2u : 0u) |
         (f & 0xff0000u ? 4u : 0u) | (f & 0xff000000u ? 8u : 0u);
    ord[0] = o.x, ord[1] = o.y, ord[2] = o.z, ord[3] = o.w;
  } else {
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      const int i = first + q;
      const bool in = i < B;
      key[q] = in ? a.key_s[i] : static_cast<unsigned long long>(C);
      ss |= !in || a.seg_start[i] ? 1u << q : 0u;
      ord[q] = in ? a.order[i] : 0;
    }
  }
  if (first == 0) ss |= 1u;  // lane 0 starts a segment
  s_ss[tid] = static_cast<uint8_t>(ss);
  if (tid == 0) {
    s_ss[kThreads] = static_cast<uint8_t>(next_start);
    s_tag = lb_tag_of(calls);
  }
  // the values, in flight over START's scan
  bool live[kLanes];
  float val[kLanes];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    live[q] = key[q] < static_cast<unsigned long long>(C);
    val[q] = live[q] ? a.vals[ord[q]] : 0.0f;
  }

  // 2. START: the last segment start at or before each lane, in the tile
  int32_t m = -1;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) m = (ss >> q) & 1u ? first + q : m;
  int32_t incl = m;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = max(incl, y);
  }
  int32_t before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = -1;
  if (lane == 31) s_wmax[warp] = incl;
  __syncthreads();
  const uint32_t tag = s_tag;
  int32_t tile_max = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int32_t v = s_wmax[w];
    if (w < warp) before = max(before, v);
    tile_max = max(tile_max, v);
  }
  // each key's state (count, acc, touched), read once a tile by the lane
  // that heads its run in the tile (a start, or the tile's first lane)
  // into shared memory; every such read comes before the barrier after
  // which thread 0 fences and publishes START (the write-back hazard)
  int32_t head[kLanes];  // the lane's head, in the tile
  {
    int32_t h = before >= t0 ? before - t0 : 0;
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      const int j = kLanes * tid + q;
      if ((ss >> q) & 1u) h = j;
      head[q] = h;
      if (h == j && live[q]) {
        const int s = static_cast<int>(key[q]);
        s_cnt[j] = a.count[s];
        s_acc[j] = a.acc[s];
        s_tou[j] = a.touched[s];
      }
    }
  }
  __syncthreads();
  const bool cont = (s_ss[0] & 1u) == 0u;  // the first lane continues a key
  if (tid == 0) {
    fence_acq_rel();  // the block's state reads, before any tile sees this
    lb_publish(a.start_st + tile, tag,
               tile_max >= 0 ? kLbInclusive : kLbAggregate,
               static_cast<uint32_t>(max(tile_max, 0)));
  }
  if (cont && warp == 0) {
    const int32_t x = look_back(CountWord{a.start_st, tag}, tile);
    fence_acq_rel();  // what the look-back saw, before this tile's writes
    if (lane == 0) {
      if (tile_max < 0) {
        lb_publish(a.start_st + tile, tag, kLbInclusive,
                   static_cast<uint32_t>(x));
      }
      s_start = x;
    }
  }
  __syncthreads();
  if (cont) before = max(before, s_start);
  int32_t o_cnt[kLanes];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) o_cnt[q] = live[q] ? s_cnt[head[q]] : 0;

  // 3. each lane's position, index, window, and flags
  int32_t av[kLanes], wv[kLanes];
  uint32_t wf = 0u, fire = 0u, fold = 0u, tail = 0u;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const int i = first + q;
    if ((ss >> q) & 1u) before = i;
    const int32_t x = add_wrap(o_cnt[q], i - before + 1);
    const int32_t x1 = sub_wrap(x, 1);
    const int32_t w = floor_div(x1, a.dm);
    const int32_t qx = floor_div(x, a.dm);
    const int32_t qo = floor_div(o_cnt[q], a.dm);
    av[q] = x;
    wv[q] = w;
    wf |= ((ss >> q) & 1u) || mod_n(x1, w, N) == 0 ? 1u << q : 0u;
    const bool whole = mod_n(x, qx, N) == 0;
    fire |= live[q] && whole ? 1u << q : 0u;
    tail |= whole ? 0u : 1u << q;
    fold |= live[q] && w == qo && s_tou[head[q]] &&
                    mod_n(o_cnt[q], qo, N) != 0
                ? 1u << q : 0u;
  }
  if (tid == 0) s_wcont = (wf & 1u) == 0u;
  // SUM in the tile: the thread's (any window start, sum since the last)
  SegPair<float> x{static_cast<int32_t>(wf & 1u), val[0]};
#pragma unroll
  for (int q = 1; q < kLanes; ++q) {
    x = seg_combine<SumOp>(x, SegPair<float>{
                                  static_cast<int32_t>((wf >> q) & 1u),
                                  val[q]});
  }
  SegPair<float> total;
  const SegPair<float> xi = block_seg_scan<SumOp>(x, &total);  // syncs
  s_pair[tid] = xi;
  // FIRE in the tile: each fire's rank
  int32_t tile_n;
  const int32_t rank = block_exclusive_scan(__popc(fire), &tile_n);  // syncs
  if (tid == 0) {
    if (total.f) {
      publish_float(a.inc_st + tile, tag, total.v);
    } else {
      publish_float(a.agg_st + tile, tag, total.v);
    }
    lb_publish(a.fire_st + tile, tag, tile == 0 ? kLbInclusive : kLbAggregate,
               static_cast<uint32_t>(tile_n));
  }
  // the fired lanes' key halves, in flight over the look-backs
  uint32_t f_hi[kLanes], f_lo[kLanes];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    f_hi[q] = (fire >> q) & 1u ? a.hi[ord[q]] : 0u;
    f_lo[q] = (fire >> q) & 1u ? a.lo[ord[q]] : 0u;
  }
  // 4. SUM's carry (warp 0) and FIRE's offset (warp 1), at once
  if (warp == 0) {
    float c = 0.0f;
    if (s_wcont) {
      c = look_back(SumWord{a.inc_st, a.agg_st, tag}, tile);
      if (lane == 0 && !total.f) {
        publish_float(a.inc_st + tile, tag, c + total.v);
      }
    }
    if (lane == 0) s_sum = c;
  } else if (warp == 1) {
    const uint32_t e = static_cast<uint32_t>(
        look_back(CountWord{a.fire_st, tag}, tile));
    if (lane == 0) {
      if (tile > 0) {
        lb_publish(a.fire_st + tile, tag, kLbInclusive,
                   e + static_cast<uint32_t>(tile_n));
      }
      s_row0 = e;
      if (tile == static_cast<int>(gridDim.x) - 1) {
        *a.n_rows = static_cast<int32_t>(e) + tile_n;
        *a.calls = tag;  // every tile has read it: the next call's is one more
      }
    }
  }
  __syncthreads();

  // 5. each lane's window sum, its fire row and its key's write-back
  SegPair<float> run{0, s_sum};
  if (tid > 0) run = seg_combine<SumOp>(run, s_pair[tid - 1]);
  int32_t row = static_cast<int32_t>(s_row0) + rank;
  const uint32_t next = (ss >> 1) | ((s_ss[tid + 1] & 1u) << (kLanes - 1));
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    run = seg_combine<SumOp>(run, SegPair<float>{
                                      static_cast<int32_t>((wf >> q) & 1u),
                                      val[q]});
    const float rolled = (fold >> q) & 1u ? s_acc[head[q]] + run.v : run.v;
    if ((fire >> q) & 1u) {
      a.r_hi[row] = f_hi[q];
      a.r_lo[row] = f_lo[q];
      a.r_w[row] = wv[q];
      a.r_val[row] = rolled;
      ++row;
    }
    if (live[q] && ((next >> q) & 1u)) {  // the words that change only
      const int s = static_cast<int>(key[q]);
      const bool t = (tail >> q) & 1u;
      const float v = t ? rolled : 0.0f;
      a.count[s] = av[q];
      if (__float_as_uint(v) != __float_as_uint(s_acc[head[q]])) a.acc[s] = v;
      if (t != (s_tou[head[q]] != 0)) a.touched[s] = t ? 1 : 0;
    }
  }
}

}  // namespace

// scratch: int64 words, the count of calls, then four status words a tile
// (ops/cuda.py _stream_scratch("count_update")), zeroed once.
extern "C" int count_update(const void* key_s, const void* seg_start,
                            const void* order, const void* hi, const void* lo,
                            const void* vals, int B, int C, int N,
                            void* count, void* acc, void* touched,
                            void* row_hi, void* row_lo, void* row_w,
                            void* row_val, void* n_rows, void* scratch,
                            void* stream) {
  if (N < 1 || B < 0 || B > (1 << 30) - kTile || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = B > 0 ? (B + kTile - 1) / kTile : 1;
  auto* st = static_cast<unsigned long long*>(scratch);
  const auto at = [](const void* p, uintptr_t k) {
    return reinterpret_cast<uintptr_t>(p) % k == 0;
  };
  Args a{static_cast<const unsigned long long*>(key_s),
         static_cast<const uint8_t*>(seg_start),
         static_cast<const int32_t*>(order),
         static_cast<const uint32_t*>(hi),
         static_cast<const uint32_t*>(lo),
         static_cast<const float*>(vals),
         B, C, N, div_magic(N),
         at(key_s, 16) && at(order, 16) && at(seg_start, 4),
         static_cast<int32_t*>(count), static_cast<float*>(acc),
         static_cast<uint8_t*>(touched),
         static_cast<uint32_t*>(row_hi), static_cast<uint32_t*>(row_lo),
         static_cast<int32_t*>(row_w), static_cast<float*>(row_val),
         static_cast<int32_t*>(n_rows),
         static_cast<uint32_t*>(scratch),
         st + 1, st + 1 + tiles, st + 1 + 2 * tiles, st + 1 + 3 * tiles};
  count_update_kernel<<<tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
