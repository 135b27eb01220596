// G6 fire_compact — evaluate the due windows for every slot and compact the
// emitted ones into per-lane (key_hi, key_lo, value) prefixes on the device;
// and fire_pack, the same compaction of a dense fire result computed
// elsewhere.
//
// Replaces (flink_tpu, the JAX reference): the compact branch of
// ops/window_kernels.py advance_and_fire_resident (:1490-1496, kernel K5):
// _eval_fire_lanes (:1203) followed by _pack_fire_lanes (:1079, kernel K11),
// the cumsum + searchsorted stream compaction that compact_fires (:1116)
// also uses — for the builtin reduces on packed planes (sum, count, min,
// max; W >= 1 value columns, kernel K7) and, with a fresh plane, the
// allowed-lateness re-fire lanes of advance_and_fire (:1309-1423, kernel
// K11) that compact_fires packs after it. Lane f's emitted slots land, in
// slot order, in the prefix [0, counts[f]) of its rows, with the slot's key
// identity read from the table (direct layout: the identity rows (0, slot);
// hash layout: the placed keys) and its W value columns. value_sums[f] is
// the lane's sum of every emitted value column. The scalar fire plan runs
// before this kernel as device torch ops and hands it p_f[F] and
// lane_ok[F]. fire_pack takes the emitted mask [F, C] and values [F, C, W]
// of a generic reduce's fire, whose combine is the user's torch function
// and runs as torch ops before it (ops/window_kernels.py). Nothing is
// zeroed: only [0, counts[f]) of a lane's rows is meaningful. Without
// output rows (fire_pack for a device-reduce sink) it counts and sums only.
//
// Semantics of a slot: fire_eval.cuh, as in G4 fire_reduced.
//
// Bound: bytes. A due lane reads its present rows of the packed plane once
// (4 (W+1) B x C each: 84 MB for k = 5, W = 1 at C = 2^21, about 25 us at
// 3.35 TB/s), the key word of each emitted slot (8 B) and writes
// 8 + 4 W B per emitted row; fire_pack reads a due lane's mask (C B) and
// the values of its emitted slots.
//
// Design: one launch a call, a single-pass stream compaction with
// decoupled look-back (Merrill and Garland). A block owns a tile of
// contiguous slots of one lane: each warp a run of kRounds x 32 x kSpt
// slots, each round one coalesced load a thread (a float4 of two W = 1
// cells, or of four dense values behind one 4-byte mask word, where the
// shapes allow). It evaluates its slots once, keeps their values in
// registers, ranks the emitting ones in slot order with warp ballots and
// __popc and a sum over its warps, publishes its count in a status word
// (its aggregate, then its inclusive prefix), stages its rows in shared
// memory at their ranks while warp 0 finds the tile's offset by looking
// back over the status words of the tiles before it, 32 at a time, and
// then writes the rows out contiguously (coalesced stores). A tile waits
// only on tiles of lower block index, which the card starts first. The
// status words carry the call's epoch, which the wrapper increments, so
// the scratch is allocated once and never cleared: a word of an earlier
// call reads as not yet published. The lane
// sums do not ride the look-back (its order varies from run to run): each
// tile publishes its partial sum in a word of its own, tagged with the
// epoch too, and the lane's last tile waits for every word and adds them
// in a fixed order (each thread a stride of tiles, then a block tree), so
// the sums do not depend on scheduling. counts[f] is the last tile's
// inclusive prefix. A lane that is not due writes counts 0 and sum 0 in
// the same launch and its blocks exit.

#include "fire_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the smallest tile of any instance below (kRounds = 2, kSpt = 1): it sizes
// the wrapper's scratch through fire_compact_tiles
constexpr int kMinTile = kThreads * 2;

// a status word: epoch << 32 | flag << 30 | count
constexpr unsigned long long kAggregate = 1ull << 30;
constexpr unsigned long long kInclusive = 2ull << 30;
constexpr unsigned long long kFlags = 3ull << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1u;

struct Scratch {
  unsigned long long* status;  // [F, stride]
  unsigned long long* sums;    // [F, stride]: epoch << 32 | float bits
  int stride;
  uint32_t epoch;
  int32_t* counts;
  float* vsums;
};

__device__ __forceinline__ void publish(unsigned long long* p, uint32_t epoch,
                                        unsigned long long flag, uint32_t n) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(epoch) << 32) | flag | n;
}

// Warp 0: the exclusive prefix of `tile` from the status words before it,
// 32 at a time, stopping at the nearest inclusive prefix.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* st,
                                              int tile, uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  uint32_t excl = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;
    // before the first tile: an inclusive 0
    unsigned long long w = (static_cast<unsigned long long>(epoch) << 32) |
                           kInclusive;
    if (idx >= 0) {
      const volatile unsigned long long* p = st + idx;
      do {
        w = *p;
      } while (static_cast<uint32_t>(w >> 32) != epoch);
    }
    const unsigned incl =
        __ballot_sync(0xffffffffu, (w & kFlags) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    const uint32_t n =
        lane <= stop ? static_cast<uint32_t>(w) & kCountMask : 0u;
    excl += __reduce_add_sync(0xffffffffu, n);
    if (incl) return excl;
  }
}

template <class Src, int kSpt, int kRounds>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Src src, const uint8_t* __restrict__ lane_ok,
                   const unsigned long long* __restrict__ table,
                   uint32_t* __restrict__ key_hi,
                   uint32_t* __restrict__ key_lo, float* __restrict__ values,
                   Scratch sc) {
  constexpr int kNV = Src::kWidth ? Src::kWidth : kMaxW;
  constexpr int kWarpSlots = 32 * kSpt * kRounds;
  constexpr int kTile = kWarps * kWarpSlots;
  const int f = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  if (!lane_ok[f]) {  // uniform per block
    if (tile == 0 && threadIdx.x == 0) {
      sc.counts[f] = 0;
      sc.vsums[f] = 0.0f;
    }
    return;
  }
  __shared__ int32_t s_row[kMaxPanes];
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_base;
  src.prepare(f, s_row);
  const int C = src.C;
  const int nw = src.W();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = tile * kTile + warp * kWarpSlots + lane * kSpt;

  float v[kRounds][kSpt][kNV];
  unsigned bits[kRounds];
  src.template eval_rounds<kSpt, kRounds, kNV>(f, s_row, c0, 32 * kSpt, v,
                                               bits);
  // the emitting slots' key words, in flight while the tile ranks them
  unsigned long long word[kRounds][kSpt];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int s = 0; s < kSpt; ++s) {
      word[r][s] = key_hi != nullptr && ((bits[r] >> s) & 1u)
                       ? table[c0 + r * 32 * kSpt + s]
                       : 0ull;
    }
  }

  // ranks within the warp in slot order (round, lane, slot of the lane)
  const unsigned lt = (1u << lane) - 1u;
  uint32_t rank[kRounds];
  uint32_t warp_n = 0;
  float sum = 0.0f;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    uint32_t below = 0;
    uint32_t total = 0;
#pragma unroll
    for (int s = 0; s < kSpt; ++s) {
      const bool e = (bits[r] >> s) & 1u;
      const unsigned b = __ballot_sync(0xffffffffu, e);
      below += __popc(b & lt);
      total += __popc(b);
      if (e) {
#pragma unroll
        for (int w = 0; w < kNV; ++w) {
          if (w < nw) sum += v[r][s][w];
        }
      }
    }
    rank[r] = warp_n + below;
    warp_n += total;
  }
  if (lane == 0) s_warp[warp] = warp_n;
  __syncthreads();
  uint32_t warp_base = 0;
  uint32_t tile_n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t n = s_warp[w];
    warp_base += w < warp ? n : 0u;
    tile_n += n;
  }
  unsigned long long* st = sc.status + static_cast<size_t>(f) * sc.stride;
  if (threadIdx.x == 0) {  // the aggregate first, for the tiles behind
    publish(st + tile, sc.epoch, tile == 0 ? kInclusive : kAggregate, tile_n);
  }

  // the tile's rows staged in shared memory at their ranks while warp 0
  // looks back, then written out contiguously
  __shared__ uint32_t s_hi[kTile];
  __shared__ uint32_t s_lo[kTile];
  __shared__ float s_val[kTile * kNV];
  if (key_hi != nullptr) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int s = 0; s < kSpt; ++s) {
        if (!((bits[r] >> s) & 1u)) continue;
        const uint32_t at =
            warp_base + rank[r] + __popc(bits[r] & ((1u << s) - 1u));
        s_hi[at] = static_cast<uint32_t>(word[r][s] >> 32);
        s_lo[at] = static_cast<uint32_t>(word[r][s]);
#pragma unroll
        for (int w = 0; w < kNV; ++w) {
          if (w < nw) s_val[at * nw + w] = v[r][s][w];
        }
      }
    }
  }
  if (warp == 0) {
    const uint32_t excl = tile == 0 ? 0u : look_back(st, tile, sc.epoch);
    if (lane == 0) {
      if (tile > 0) publish(st + tile, sc.epoch, kInclusive, excl + tile_n);
      s_base = excl;
      if (tile == n_tiles - 1) {
        sc.counts[f] = static_cast<int32_t>(excl + tile_n);
      }
    }
  }
  __syncthreads();
  if (key_hi != nullptr) {
    const size_t out0 = static_cast<size_t>(f) * C + s_base;
    for (uint32_t i = threadIdx.x; i < tile_n; i += kThreads) {
      key_hi[out0 + i] = s_hi[i];
      key_lo[out0 + i] = s_lo[i];
    }
    const uint32_t n_vals = tile_n * nw;
    for (uint32_t i = threadIdx.x; i < n_vals; i += kThreads) {
      values[out0 * nw + i] = s_val[i];
    }
  }

  // the lane's sum: the tiles' partials, added in a fixed order by the
  // lane's last tile once every one is published
  sum = block_sum(sum);
  unsigned long long* part = sc.sums + static_cast<size_t>(f) * sc.stride;
  const unsigned long long tag = static_cast<unsigned long long>(sc.epoch)
                                 << 32;
  if (threadIdx.x == 0) {
    *reinterpret_cast<volatile unsigned long long*>(part + tile) =
        tag | __float_as_uint(sum);
  }
  if (tile == n_tiles - 1) {  // uniform per block
    float t = 0.0f;
    for (int b = threadIdx.x; b < n_tiles; b += kThreads) {
      const volatile unsigned long long* p = part + b;
      unsigned long long w;
      do {
        w = *p;
      } while ((w >> 32) != sc.epoch);
      t += __uint_as_float(static_cast<uint32_t>(w));
    }
    t = block_sum(t);
    if (threadIdx.x == 0) sc.vsums[f] = t;
  }
}

template <class Src, int kSpt, int kRounds>
void launch(const Src& src, const uint8_t* lane_ok, int F,
            const unsigned long long* table, uint32_t* key_hi,
            uint32_t* key_lo, float* values, const Scratch& sc,
            cudaStream_t s) {
  constexpr int kTile = kThreads * kSpt * kRounds;
  static_assert(kTile % kMinTile == 0, "kMinTile is the smallest tile");
  const int n_tiles = (src.C + kTile - 1) / kTile;
  compact_kernel<Src, kSpt, kRounds><<<dim3(n_tiles, F), kThreads, 0, s>>>(
      src, lane_ok, table, key_hi, key_lo, values, sc);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Launch {
  const uint8_t* lane_ok;
  int F;
  const unsigned long long* table;
  uint32_t* key_hi;
  uint32_t* key_lo;
  float* values;
  Scratch sc;
  cudaStream_t s;

  template <class Src>
  void operator()(const Src& src) const {
    if constexpr (Src::kWidth == 1) {
      // two cells a float4 where the plane's rows keep the alignment
      if (src.C % 2 == 0 && aligned(src.acc, 16) &&
          (src.fresh == nullptr || aligned(src.fresh, 2))) {
        launch<Src, 2, 4>(src, lane_ok, F, table, key_hi, key_lo, values, sc,
                          s);
      } else {
        launch<Src, 1, 8>(src, lane_ok, F, table, key_hi, key_lo, values, sc,
                          s);
      }
    } else if constexpr (Src::kWidth == 2) {
      launch<Src, 1, 8>(src, lane_ok, F, table, key_hi, key_lo, values, sc,
                        s);
    } else {  // up to kMaxW columns held in registers: a smaller tile
      launch<Src, 1, 2>(src, lane_ok, F, table, key_hi, key_lo, values, sc,
                        s);
    }
  }
};

int check_sizes(int C, int stride) {
  // counts ride 30 bits of a status word; the scratch holds every tile
  if (C >= (1 << 30) || stride < (C + kMinTile - 1) / kMinTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Tiles a lane of C slots may take: the scratch's row length.
extern "C" int fire_compact_tiles(int C) {
  return (C + kMinTile - 1) / kMinTile;
}

extern "C" int fire_compact(const void* acc, int W, int op, float neutral,
                            const void* fresh, int n_ontime,
                            const void* pane_ids, const void* p_f,
                            const void* lane_ok, const void* table, int C,
                            int R, int k, int F, void* status,
                            void* sums, int stride, unsigned int epoch,
                            void* key_hi, void* key_lo,
                            void* values, void* counts, void* vsums,
                            void* stream) {
  if (k < 1 || k > kMaxPanes || W < 1 || W > kMaxW || op < 0 || op > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (const int e = check_sizes(C, stride)) return e;
  const PlaneArgs args{static_cast<const float*>(acc),
                       static_cast<const uint8_t*>(fresh),
                       static_cast<const int32_t*>(pane_ids),
                       static_cast<const int32_t*>(p_f), n_ontime, W, neutral,
                       C, R, k};
  const Scratch sc{static_cast<unsigned long long*>(status),
                   static_cast<unsigned long long*>(sums), stride, epoch,
                   static_cast<int32_t*>(counts), static_cast<float*>(vsums)};
  with_plane(args, op,
             Launch{static_cast<const uint8_t*>(lane_ok), F,
                    static_cast<const unsigned long long*>(table),
                    static_cast<uint32_t*>(key_hi),
                    static_cast<uint32_t*>(key_lo),
                    static_cast<float*>(values), sc,
                    static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fire_pack(const void* mask, const void* values_in, int W,
                         const void* lane_ok, const void* table, int C, int F,
                         void* status, void* sums, int stride,
                         unsigned int epoch, void* key_hi,
                         void* key_lo, void* values, void* counts,
                         void* vsums, void* stream) {
  if (W < 1 || W > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (const int e = check_sizes(C, stride)) return e;
  const Scratch sc{static_cast<unsigned long long*>(status),
                   static_cast<unsigned long long*>(sums), stride, epoch,
                   static_cast<int32_t*>(counts), static_cast<float*>(vsums)};
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* vin = static_cast<const float*>(values_in);
  const auto* ok = static_cast<const uint8_t*>(lane_ok);
  const auto* tab = static_cast<const unsigned long long*>(table);
  auto* hi = static_cast<uint32_t*>(key_hi);
  auto* lo = static_cast<uint32_t*>(key_lo);
  auto* out = static_cast<float*>(values);
  const auto s = static_cast<cudaStream_t>(stream);
  if (W == 1) {
    const DenseSrc<1> src{m, vin, 1, C};
    // four mask bytes a word and four values a float4 where rows align
    if (C % 4 == 0 && aligned(m, 4) && aligned(vin, 16)) {
      launch<DenseSrc<1>, 4, 2>(src, ok, F, tab, hi, lo, out, sc, s);
    } else {
      launch<DenseSrc<1>, 1, 8>(src, ok, F, tab, hi, lo, out, sc, s);
    }
  } else {
    launch<DenseSrc<0>, 1, 2>(DenseSrc<0>{m, vin, W, C}, ok, F, tab, hi, lo,
                              out, sc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
