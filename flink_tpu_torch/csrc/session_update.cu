// G11 session_update — event-time session windows for one micro-batch and
// watermark advance, over the lanes in G10's (slot, ts) order.
//
// Replaces (flink_tpu, the JAX reference): ops/session_windows.py
// update_and_fire (:85, kernel K16) after its late filter, upsert and
// lexsort (:140-200): the session cuts (a slot change, or a gap > G between
// consecutive ticks), each session's aggregate, first and last tick; the
// merge of each key's first batch session with its open session (:155-170);
// the superseded fires — the open session a key's first batch session does
// not merge with (old) and every batch session but a key's last (mid), one
// lane carrying both (:172-178); the write-back of each key's last session
// as its open one (:180-186); and the watermark close over all C slots
// (:188-200), which fires and clears every open session with last + G <=
// watermark.
//
// Inputs: key_s (uint64 [B]: (slot << 32) | (ts ^ 0x80000000), or C << 32
// for a lane with no slot), order (int32 [B]) from G10; hi, lo, vals (lane
// order); the state start, last (int32 [C]), acc (float32 [C]), active
// (uint8 [C]) and table (uint64 [C] key words), written in place; wm
// (int32 0-d on the card, the watermark after the batch). Outputs: the
// fire rows (key hi, key lo, start, end = last + G, value), old fires then
// mid fires in sorted-lane order, then the close fires in slot order — the
// reference's emission order — at rows 0, 1, ..., and their count n_rows,
// which the kernel writes. ``marks`` (int32 [2] on the card, or null) gets
// the row count after the old fires and after the mid fires, so that a
// caller merging several shards' rows can order them by kind, as the
// reference's host loop does. The rows cannot overflow: 2B + C hold every
// fire. The reference instead returns [B]- and [C]-sized masks that the host
// reads whole each step.
//
// Bound: bytes. Per lane: key (8 B), order (4 B), value (4 B); per session
// end the open session read (13 B) and the merged one written (13 B); per
// fire row 20 B, and hi and lo (8 B) of each lane that fires; the close
// sweep reads active of every slot (C B: 4 MB at C = 2^22) and last of each
// open slot, and start, acc and the key word of each slot it closes. The
// open sessions are read and written at random slots: each 4-byte access
// moves a 32-byte sector, which the byte count leaves out.
//
// Design: two launches a call, no copy and no fill.
//   1. SCAN (a block a tile of 1,024 sorted lanes, 4 a thread). Each lane
//      knows from its neighbours whether it starts a session, ends one,
//      ends its key's lanes; a session end loads its key's open session at
//      once, in flight over the rest. A segmented scan of (sum, first tick,
//      first lane's slot change) per session runs in the tile; a tile whose
//      first lane starts a session (nearly all) publishes its inclusive
//      prefix at once, and only a tile whose first lane continues a session
//      looks back (warp 0, 32 tiles a round) to the nearest tile that is
//      inclusive or starts a session; the words (three 64-bit words a
//      value, each tagged, so read with no fence) carry the call's tag. The
//      mid fires, known lane by lane, get their ranks by a count look-back
//      (lookback.cuh) published before the scan. At each session's last
//      lane the tile merges with the open session and leaves the merged
//      session, the fire flags and the mid rank in scratch; a key with one
//      session in the batch (nearly all) is written back by the thread that
//      read it, the words that change only, while its sectors are in L2.
//      Whether a key's first session supersedes its open one depends on the
//      scan, so the old fires take a second count look-back, and the tile
//      writes its old rows: they are the first rows. The last tile leaves
//      the totals of old and mid fires; every lane leaves where each sweep
//      tile's slots begin among the sorted lanes.
//   2. SWEEP (a block a tile of 4,096 slots, 16 a thread), launched while
//      the scan runs (programmatic dependent launch): before it waits for
//      the scan it reads active 16 slots a 16-byte load and last of the
//      open slots, neither of which the scan needs (a slot the scan writes
//      back is a write-back the sweep overrides). Then it takes the lanes
//      of its slots (the sorted lanes of a slot range are one run): it
//      writes back the keys with several sessions, notes every written-back
//      slot's close by its new last, compacts the closes in slot order with
//      a count look-back from the base old total + mid total, clears what
//      it emits, and the last tile writes n_rows and advances the count of
//      calls; then it writes its lanes' mid rows at old total + their
//      ranks. Block 0 writes marks.
// The scan's tiles run at once where the card holds them (a larger batch
// takes an instance held to fewer registers). The tag comes from a count
// of calls kept in the scratch (ops/cuda.py _session_scratch, cached per
// device and stream): no epoch from the host. Float sums of a session add
// in another association than the reference's scan (exact for
// integer-valued data). int32 tick arithmetic wraps as the reference's
// does.

#include "lookback.cuh"
#include "segscan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;                        // lanes a thread of the scan
constexpr int kScanTile = kThreads * kLanes;     // 1,024 lanes
constexpr int kSlots = 16;                       // slots a thread of the sweep
static_assert(kSlots % 16 == 0 && kSlots <= 32, "16-byte loads, 32-bit masks");
constexpr int kSweepShift = 12;
constexpr int kSweepTile = 1 << kSweepShift;     // 4,096 slots
static_assert(kSweepTile == kThreads * kSlots, "a sweep tile");

__device__ __forceinline__ int key_slot(unsigned long long k) {
  return static_cast<int>(k >> 32);
}

__device__ __forceinline__ int32_t key_ts(unsigned long long k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k) ^ 0x80000000u);
}

// The scan's running value over a span of sorted lanes.
struct SP {
  float agg;      // the current session's sum so far
  int32_t smin;   // its first tick
  uint32_t bits;  // 1: a session starts in the span; 2: the current
                  // session's first lane starts its key's lanes
};

// (a then b): b's session when one starts in b, else a's grown by b
__device__ __forceinline__ SP sp_op(SP a, SP b) {
  return (b.bits & 1u) ? b : SP{a.agg + b.agg, a.smin, a.bits};
}

__device__ __forceinline__ SP shfl_up_sp(SP x, int off) {
  x.agg = __shfl_up_sync(0xffffffffu, x.agg, off);
  x.smin = __shfl_up_sync(0xffffffffu, x.smin, off);
  x.bits = __shfl_up_sync(0xffffffffu, x.bits, off);
  return x;
}

__device__ __forceinline__ SP shfl_down_sp(SP x, int off) {
  x.agg = __shfl_down_sync(0xffffffffu, x.agg, off);
  x.smin = __shfl_down_sync(0xffffffffu, x.smin, off);
  x.bits = __shfl_down_sync(0xffffffffu, x.bits, off);
  return x;
}

// Inclusive scan of one SP a thread in thread order; *total gets the
// block's. Every thread of the block calls it.
__device__ SP block_scan_sp(SP x, SP* total) {
  __shared__ SP warp_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const SP y = shfl_up_sp(x, off);
    if (lane >= off) x = sp_op(y, x);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    // lanes at or past kWarps hold stale values; they feed no lane below
    SP t = warp_tot[lane < kWarps ? lane : 0];
    for (int off = 1; off < kWarps; off <<= 1) {
      const SP y = shfl_up_sp(t, off);
      if (lane >= off) t = sp_op(y, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  *total = warp_tot[kWarps - 1];
  if (warp > 0) x = sp_op(warp_tot[warp - 1], x);
  return x;
}

// A tile's SP as three tagged words (each readable alone, so no fence
// orders them).
__device__ __forceinline__ void sp_publish(unsigned long long* w, uint32_t tag,
                                           SP x) {
  const unsigned long long t = static_cast<unsigned long long>(tag) << 32;
  volatile unsigned long long* v = w;
  v[0] = t | __float_as_uint(x.agg);
  v[1] = t | static_cast<uint32_t>(x.smin);
  v[2] = t | x.bits;
}

__device__ __forceinline__ bool sp_read(const unsigned long long* w,
                                        uint32_t tag, SP* x) {
  const volatile unsigned long long* v = w;
  const unsigned long long a = v[0], b = v[1], c = v[2];
  if (static_cast<uint32_t>(a >> 32) != tag ||
      static_cast<uint32_t>(b >> 32) != tag ||
      static_cast<uint32_t>(c >> 32) != tag) {
    return false;
  }
  x->agg = __uint_as_float(static_cast<uint32_t>(a));
  x->smin = static_cast<int32_t>(static_cast<uint32_t>(b));
  x->bits = static_cast<uint32_t>(c);
  return true;
}

struct SessScratch {
  uint32_t* calls;                  // the count of calls (the tag)
  int32_t* totals;                  // [2]: old fires, mid fires
  unsigned long long* agg_words;    // [tiles][3] a tile's aggregate
  unsigned long long* inc_words;    // [tiles][3] its inclusive prefix
  unsigned long long* mid_status;   // [tiles] mid fires (lookback.cuh)
  unsigned long long* old_status;   // [tiles] old fires (lookback.cuh)
  unsigned long long* close_status; // [sweep tiles] closes (lookback.cuh)
  int32_t* bstart;                  // [sweep tiles + 1] first lane of each
  uint8_t* fl;                      // [B] 1: mid fire, 2: write-back,
                                    // 4: written back by the scan
  int32_t* m_start;                 // [B] the merged session at its end
  int32_t* m_last;
  float* m_acc;
  int32_t* m_pos;                   // [B] a mid fire's rank
};

struct SessOut {
  uint32_t* hi;
  uint32_t* lo;
  int32_t* start;
  int32_t* end;
  float* val;
};

struct Args {
  const unsigned long long* key_s;
  const int32_t* order;
  const uint32_t* hi;
  const uint32_t* lo;
  const float* vals;
  int32_t* start;
  int32_t* last;
  float* acc;
  uint8_t* active;
  const unsigned long long* table;
  const int32_t* wm;
  int B, C, n_sweep;
  int32_t G;
  bool vec;  // active 16-byte aligned
  SessOut out;
  int32_t* n_rows;
  int32_t* marks;
  SessScratch sc;
};

// Warp 0 of tile `tile` > 0 whose first lane continues a session: the SP
// of every lane before the tile, from the tiles' words, 32 at a time back
// to the nearest tile that is inclusive or starts a session (whose
// aggregate then fixes the carry).
__device__ SP sp_look_back(const SessScratch& sc, int tile, uint32_t tag) {
  const int lane = threadIdx.x & 31;
  SP run{0.0f, 0, 0u};
  bool have = false;
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;
    SP x{0.0f, 0, 1u};  // before the first tile: an inclusive nothing
    bool stop_here = true;
    if (idx >= 0) {
      while (true) {
        if (sp_read(sc.inc_words + 3 * static_cast<size_t>(idx), tag, &x)) {
          break;
        }
        if (sp_read(sc.agg_words + 3 * static_cast<size_t>(idx), tag, &x)) {
          stop_here = (x.bits & 1u) != 0u;
          break;
        }
      }
    }
    const unsigned found = __ballot_sync(0xffffffffu, stop_here);
    const int stop = found ? __ffs(found) - 1 : 31;
    // lanes stop .. 0 in tile order (a higher lane is an earlier tile)
    for (int off = 1; off < 32; off <<= 1) {
      const SP y = shfl_down_sp(x, off);
      if ((lane & (2 * off - 1)) == 0 && lane + off <= stop) x = sp_op(y, x);
    }
    SP w;
    w.agg = __shfl_sync(0xffffffffu, x.agg, 0);
    w.smin = __shfl_sync(0xffffffffu, x.smin, 0);
    w.bits = __shfl_sync(0xffffffffu, x.bits, 0);
    run = have ? sp_op(w, run) : w;
    have = true;
    if (found) return run;
  }
}

// One lane of the scan, from the sorted keys around it; at a session's last
// lane, its key's open session, loaded before the scan needs it (whether
// the session is its key's first is known only after it).
struct Lane {
  int slot;
  int32_t ts;
  uint32_t f;     // 1 live, 2 end of a session, 4 last of its slot
  SP p;
  bool o_active;  // the open session (read at a session's last lane)
  int32_t o_start, o_last;
  float o_acc;
};

// kMinBlocks: 1, or 4 for a batch whose tiles fit the card at once only
// with fewer registers a thread (launch_scan)
template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sess_scan_kernel(Args a) {
  // the sweep may start now: before its wait it reads only active and
  // last, and overrides every slot this kernel writes
  cudaTriggerProgrammaticLaunchCompletion();
  __shared__ unsigned long long s_key[kScanTile + 2];
  __shared__ int32_t s_ord[kScanTile];
  __shared__ SP s_incl[kThreads];
  __shared__ SP s_x;
  const int tile = blockIdx.x;
  const int base = tile * kScanTile;
  const uint32_t tag = lb_tag(a.sc.calls);
  const int B = a.B, C = a.C;
  const int32_t G = a.G;
  // the tile's keys (and one each side) and orders, coalesced
  for (int j = threadIdx.x; j < kScanTile; j += kThreads) {
    const int i = base + j;
    s_key[j + 1] = i < B ? a.key_s[i] : 0ull;
    s_ord[j] = i < B ? a.order[i] : 0;
  }
  if (threadIdx.x == 0) s_key[0] = base > 0 ? a.key_s[base - 1] : 0ull;
  if (threadIdx.x == 1) {
    s_key[kScanTile + 1] =
        base + kScanTile < B ? a.key_s[base + kScanTile] : 0ull;
  }
  __syncthreads();

  Lane L[kLanes];
  int n_mid = 0;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const int j = kLanes * threadIdx.x + q;
    const int i = base + j;
    Lane& l = L[q];
    const unsigned long long k = s_key[j + 1];
    l.slot = key_slot(k);
    l.ts = key_ts(k);
    const bool live = i < B && l.slot < C;
    bool flag = true, slot_change = true;
    if (i < B && i > 0) {
      const unsigned long long pk = s_key[j];
      slot_change = key_slot(pk) != l.slot;
      flag = slot_change || sub_wrap(l.ts, key_ts(pk)) > G;
    }
    bool next_flag = true, next_slot = true;
    if (i + 1 < B) {
      const unsigned long long nk = s_key[j + 2];
      next_slot = key_slot(nk) != l.slot;
      next_flag = next_slot || sub_wrap(key_ts(nk), l.ts) > G;
    }
    const bool end = live && next_flag;
    l.f = (live ? 1u : 0u) | (end ? 2u : 0u) | (live && next_slot ? 4u : 0u);
    n_mid += end && !next_slot ? 1 : 0;
    l.p = SP{live ? a.vals[s_ord[j]] : 0.0f, l.ts,
             (flag ? 1u : 0u) | (slot_change ? 2u : 0u)};
    l.o_active = false;
    l.o_start = l.o_last = 0;
    l.o_acc = 0.0f;
    if (end) {  // in flight over the scan and its look-backs
      l.o_active = a.active[l.slot] != 0;
      l.o_start = a.start[l.slot];
      l.o_last = a.last[l.slot];
      l.o_acc = a.acc[l.slot];
    }
  }
  // the mid fires' ranks: each lane knows from its neighbours whether it
  // ends a session that is not its key's last, so the tiles' counts are
  // published at once
  int32_t tile_mid;
  const int32_t mid_rank = block_exclusive_scan(n_mid, &tile_mid);
  const uint32_t mid_excl = lb_tile_offset(a.sc.mid_status, tile, tag,
                                           static_cast<uint32_t>(tile_mid));

  // the carry into the tile: none when its first lane starts a session
  // (the tile's inclusive prefix is then its total), else by look-back
  __shared__ bool s_starts;
  if (threadIdx.x == 0) s_starts = (L[0].p.bits & 1u) != 0u;
  SP agg = L[0].p;
#pragma unroll
  for (int q = 1; q < kLanes; ++q) agg = sp_op(agg, L[q].p);
  SP total;
  const SP incl_t = block_scan_sp(agg, &total);  // syncs: s_starts
  s_incl[threadIdx.x] = incl_t;
  unsigned long long* iw = a.sc.inc_words + 3 * static_cast<size_t>(tile);
  const bool starts = s_starts;
  if (threadIdx.x < 32) {
    SP x{0.0f, 0, 1u};
    if (starts) {
      if (threadIdx.x == 0) sp_publish(iw, tag, total);
    } else {
      if (threadIdx.x == 0) {
        sp_publish(a.sc.agg_words + 3 * static_cast<size_t>(tile), tag,
                   total);
      }
      x = sp_look_back(a.sc, tile, tag);
      if (threadIdx.x == 0) sp_publish(iw, tag, sp_op(x, total));
    }
    if (threadIdx.x == 0) s_x = x;
  }
  __syncthreads();
  const SP X = s_x;
  SP run = threadIdx.x == 0 ? X : sp_op(X, s_incl[threadIdx.x - 1]);

  // each lane's session and, at a session's last lane, its merge
  int n_old = 0;
  int32_t mid_pos = static_cast<int32_t>(mid_excl) + mid_rank;
  uint32_t fl_word = 0;
  uint32_t old_mask = 0;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const Lane& l = L[q];
    const int i = base + kLanes * threadIdx.x + q;
    run = sp_op(run, l.p);
    if (!(l.f & 2u)) continue;
    const bool last_of_slot = (l.f & 4u) != 0u;
    const int32_t smax = l.ts;
    const int32_t smin = run.smin;
    // the open session counts only for the key's first session
    const bool o_active = (run.bits & 2u) && l.o_active;
    const int32_t os = l.o_start, ol = l.o_last;
    const float oa = l.o_acc;
    const bool merges = o_active && smin <= add_wrap(ol, G) &&
                        add_wrap(smax, G) >= os;
    const int32_t ms = merges ? min(os, smin) : smin;
    const int32_t ml = merges ? max(ol, smax) : smax;
    const float mv = merges ? oa + run.agg : run.agg;
    a.sc.m_start[i] = ms;
    a.sc.m_last[i] = ml;
    a.sc.m_acc[i] = mv;
    if (!last_of_slot) a.sc.m_pos[i] = mid_pos++;
    // a key with one session in the batch: this thread alone reads and
    // writes its slot, so it writes the session back now, while the
    // slot's sectors are in L2, and only the words that change
    const bool now = last_of_slot && (run.bits & 2u);
    if (now) {
      if (!l.o_active || ms != os) a.start[l.slot] = ms;
      if (!l.o_active || ml != ol) a.last[l.slot] = ml;
      if (!l.o_active || __float_as_uint(mv) != __float_as_uint(oa)) {
        a.acc[l.slot] = mv;
      }
      if (!l.o_active) a.active[l.slot] = 1;
    }
    fl_word |= static_cast<uint32_t>((last_of_slot ? 0u : 1u) |
                                     (last_of_slot ? 2u : 0u) |
                                     (now ? 4u : 0u))
               << (8 * q);
    if (o_active && !merges) {
      old_mask |= 1u << q;
      ++n_old;
    }
  }
  {
    const int i0 = base + kLanes * threadIdx.x;
    if (i0 + kLanes <= B) {
      *reinterpret_cast<uint32_t*>(a.sc.fl + i0) = fl_word;
    } else {
      for (int q = 0; q < kLanes && i0 + q < B; ++q) {
        a.sc.fl[i0 + q] = static_cast<uint8_t>(fl_word >> (8 * q));
      }
    }
  }

  // where each sweep tile's slots begin among the sorted lanes
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const int j = kLanes * threadIdx.x + q;
    const int i = base + j;
    if (i >= B) continue;
    const int b = min(L[q].slot >> kSweepShift, a.n_sweep);
    int b0 = -1;
    if (i > 0) b0 = min(key_slot(s_key[j]) >> kSweepShift, a.n_sweep);
    for (int t = b0 + 1; t <= b; ++t) a.sc.bstart[t] = i;
    if (i == B - 1) {
      for (int t = b + 1; t <= a.n_sweep; ++t) a.sc.bstart[t] = B;
    }
  }

  // the old fires: their ranks, then the tile's offset by a second
  // look-back; they are the call's first rows
  int32_t tile_old;
  const int32_t rank = block_exclusive_scan(n_old, &tile_old);
  const uint32_t excl = lb_tile_offset(a.sc.old_status, tile, tag,
                                       static_cast<uint32_t>(tile_old));
  int32_t pos = static_cast<int32_t>(excl) + rank;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    if (!((old_mask >> q) & 1u)) continue;
    const Lane& l = L[q];
    const int32_t o = s_ord[kLanes * threadIdx.x + q];
    a.out.hi[pos] = a.hi[o];
    a.out.lo[pos] = a.lo[o];
    a.out.start[pos] = l.o_start;
    a.out.end[pos] = add_wrap(l.o_last, G);
    a.out.val[pos] = l.o_acc;
    ++pos;
  }
  if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0) {
    a.sc.totals[0] = static_cast<int32_t>(excl) + tile_old;
    a.sc.totals[1] = static_cast<int32_t>(mid_excl) + tile_mid;
  }
}

__global__ void __launch_bounds__(kThreads, 8) sess_sweep_kernel(Args a) {
  // a written-back slot of the tile: 1 it closes, 2 it stays open
  __shared__ __align__(16) uint8_t s_wb[kSweepTile];
  const int tile = blockIdx.x;
  const int C = a.C;
  const int32_t G = a.G;
  const int32_t wm = *a.wm;
  // 1. the closes among the slots open before the batch: active 16 slots a
  // load, last of the open ones. The scan writes neither, so this runs
  // while it finishes (programmatic dependent launch).
  const int c0 = tile * kSweepTile + kSlots * threadIdx.x;
  uint32_t open = 0u;
  if (a.vec && c0 + kSlots <= C) {
#pragma unroll
    for (int h = 0; h < kSlots / 16; ++h) {
      const uint4 w = *reinterpret_cast<const uint4*>(a.active + c0 + 16 * h);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        open |= ((ws[s >> 2] >> (8 * (s & 3))) & 0xffu) != 0u
                    ? 1u << (16 * h + s)
                    : 0u;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      open |= c0 + s < C && a.active[c0 + s] ? 1u << s : 0u;
    }
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if ((open >> s) & 1u) {
      bits |= add_wrap(a.last[c0 + s], G) <= wm ? 1u << s : 0u;
    }
  }
  cudaGridDependencySynchronize();  // the scan's outputs from here on
  const uint32_t tag = lb_tag(a.sc.calls);
  const int32_t old_total = a.B > 0 ? a.sc.totals[0] : 0;
  const int32_t base = a.B > 0 ? old_total + a.sc.totals[1] : 0;
  if (tile == 0 && threadIdx.x == 0 && a.marks != nullptr) {
    a.marks[0] = old_total;
    a.marks[1] = base;
  }
  // 2. the write-backs of the lanes of this tile's slots (one run of the
  // sorted lanes), each noted in s_wb: a written-back slot closes by its
  // new last
  if (a.B > 0) {
    for (int q = threadIdx.x; q < kSweepTile / 16; q += kThreads) {
      reinterpret_cast<uint4*>(s_wb)[q] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    const int i1 = a.sc.bstart[tile + 1];
    for (int i = a.sc.bstart[tile] + threadIdx.x; i < i1; i += kThreads) {
      const uint8_t f = a.sc.fl[i];
      if (!(f & 2u)) continue;
      const int s = key_slot(a.key_s[i]);
      const int32_t ml = a.sc.m_last[i];
      if (!(f & 4u)) {  // not yet written back by the scan
        a.start[s] = a.sc.m_start[i];
        a.last[s] = ml;
        a.acc[s] = a.sc.m_acc[i];
        a.active[s] = 1;
      }
      s_wb[s - tile * kSweepTile] = add_wrap(ml, G) <= wm ? 1 : 2;
    }
    __syncthreads();  // the block's write-backs before it reads them
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const uint8_t wb = s_wb[kSlots * threadIdx.x + s];
      if (wb) bits = (bits & ~(1u << s)) | (wb == 1 ? 1u << s : 0u);
    }
  }
  // 3. the closes in slot order, at their offset by decoupled look-back
  int32_t tile_n;
  const int32_t rank = block_exclusive_scan(__popc(bits), &tile_n);
  const uint32_t excl = lb_tile_offset(a.sc.close_status, tile, tag,
                                       static_cast<uint32_t>(tile_n));
  int32_t pos = base + static_cast<int32_t>(excl) + rank;
  while (bits) {
    const int s = __ffs(bits) - 1;
    bits &= bits - 1u;
    const int c = c0 + s;
    const unsigned long long w = a.table[c];
    a.out.hi[pos] = static_cast<uint32_t>(w >> 32);
    a.out.lo[pos] = static_cast<uint32_t>(w);
    a.out.start[pos] = a.start[c];
    a.out.end[pos] = add_wrap(a.last[c], G);
    a.out.val[pos] = a.acc[c];
    a.acc[c] = 0.0f;
    a.active[c] = 0;
    ++pos;
  }
  if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0) {
    *a.n_rows = base + static_cast<int32_t>(excl) + tile_n;
    *a.sc.calls = tag;  // every block has read it: the next call's is one more
  }
  // 4. the mid fires of the tile's lanes, at old total + their rank (after
  // the tile's offset is published: no tile waits on them)
  if (a.B > 0) {
    const int i1 = a.sc.bstart[tile + 1];
    for (int i = a.sc.bstart[tile] + threadIdx.x; i < i1; i += kThreads) {
      if (!(a.sc.fl[i] & 1u)) continue;
      const int32_t o = a.order[i];
      const int32_t p = old_total + a.sc.m_pos[i];
      a.out.hi[p] = a.hi[o];
      a.out.lo[p] = a.lo[o];
      a.out.start[p] = a.sc.m_start[i];
      a.out.end[p] = add_wrap(a.sc.m_last[i], G);
      a.out.val[p] = a.sc.m_acc[i];
    }
  }
}

// The scan, its tiles resident at once where the card holds them: the
// look-backs then never wait on a tile that has not started. A batch with
// more tiles than the plain instance keeps resident takes the instance
// held to fewer registers (which spills a little).
cudaError_t launch_scan(const Args& a, int tiles, cudaStream_t s) {
  static int resident[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (resident[dev] == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  sess_scan_kernel<1>,
                                                  kThreads, 0);
    resident[dev] = per_sm > 0 ? per_sm * sm_count() : 1;
  }
  if (tiles <= resident[dev]) {
    sess_scan_kernel<1><<<tiles, kThreads, 0, s>>>(a);
  } else {
    sess_scan_kernel<4><<<tiles, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

// the sweep's tiles: at least one, which writes n_rows
int sweep_tiles(int C) {
  const int t = (C + kSweepTile - 1) / kSweepTile;
  return t > 0 ? t : 1;
}

}  // namespace

// The scratch's size for up to B lanes and C slots, in bytes: the count of
// calls and the two totals (16 B), then per scan tile 8 words, per sweep
// tile a word and an int, and per lane 17 B. The layout follows these
// capacities, not a call's B and C, so a status word always sits where
// status words of earlier calls on the scratch sat.
extern "C" long long session_scratch_bytes(int B, int C) {
  const long long t1 = (B + kScanTile - 1) / kScanTile;
  const long long t3 = sweep_tiles(C);
  const long long b16 = (static_cast<long long>(B) + 15) / 16 * 16;
  return 16 + t1 * 8 * 8 + t3 * 8 + (t3 + 1 + 3) / 4 * 16 + b16 * 17;
}

// scratch: session_scratch_bytes(B_cap, C_cap) bytes for B <= B_cap lanes
// and C <= C_cap slots, 16-byte aligned, zeroed before the first call on
// its stream; each call leaves it ready for the next. The rows hold
// 2B + C.
extern "C" int session_update(const void* key_s, const void* order,
                              const void* hi, const void* lo, const void* vals,
                              int B, int C, int G, void* start, void* last,
                              void* acc, void* active, const void* table,
                              const void* wm, void* row_hi, void* row_lo,
                              void* row_start, void* row_end, void* row_val,
                              void* n_rows, void* marks, void* scratch,
                              int B_cap, int C_cap, void* stream) {
  if (G < 0 || B < 0 || C < 0 || B > B_cap || C > C_cap ||
      (reinterpret_cast<uintptr_t>(scratch) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t1 = (B + kScanTile - 1) / kScanTile;
  const int t3 = sweep_tiles(C);
  // the layout, by the capacities
  const int c1 = (B_cap + kScanTile - 1) / kScanTile;
  const int c3 = sweep_tiles(C_cap);
  auto* p = static_cast<uint8_t*>(scratch);
  SessScratch sc;
  sc.calls = reinterpret_cast<uint32_t*>(p);
  sc.totals = reinterpret_cast<int32_t*>(p + 4);
  p += 16;
  sc.agg_words = reinterpret_cast<unsigned long long*>(p);
  p += static_cast<size_t>(c1) * 3 * 8;
  sc.inc_words = reinterpret_cast<unsigned long long*>(p);
  p += static_cast<size_t>(c1) * 3 * 8;
  sc.mid_status = reinterpret_cast<unsigned long long*>(p);
  p += static_cast<size_t>(c1) * 8;
  sc.old_status = reinterpret_cast<unsigned long long*>(p);
  p += static_cast<size_t>(c1) * 8;
  sc.close_status = reinterpret_cast<unsigned long long*>(p);
  p += static_cast<size_t>(c3) * 8;
  sc.bstart = reinterpret_cast<int32_t*>(p);
  p += static_cast<size_t>(c3 + 1 + 3) / 4 * 16;
  const size_t b16 = (static_cast<size_t>(B_cap) + 15) / 16 * 16;
  sc.m_start = reinterpret_cast<int32_t*>(p);
  p += b16 * 4;
  sc.m_last = reinterpret_cast<int32_t*>(p);
  p += b16 * 4;
  sc.m_acc = reinterpret_cast<float*>(p);
  p += b16 * 4;
  sc.m_pos = reinterpret_cast<int32_t*>(p);
  p += b16 * 4;
  sc.fl = p;
  Args a;
  a.key_s = static_cast<const unsigned long long*>(key_s);
  a.order = static_cast<const int32_t*>(order);
  a.hi = static_cast<const uint32_t*>(hi);
  a.lo = static_cast<const uint32_t*>(lo);
  a.vals = static_cast<const float*>(vals);
  a.start = static_cast<int32_t*>(start);
  a.last = static_cast<int32_t*>(last);
  a.acc = static_cast<float*>(acc);
  a.active = static_cast<uint8_t*>(active);
  a.table = static_cast<const unsigned long long*>(table);
  a.wm = static_cast<const int32_t*>(wm);
  a.B = B;
  a.C = C;
  a.n_sweep = t3;
  a.G = G;
  a.vec = (reinterpret_cast<uintptr_t>(active) & 15u) == 0;
  a.out = SessOut{static_cast<uint32_t*>(row_hi),
                  static_cast<uint32_t*>(row_lo),
                  static_cast<int32_t*>(row_start),
                  static_cast<int32_t*>(row_end), static_cast<float*>(row_val)};
  a.n_rows = static_cast<int32_t*>(n_rows);
  a.marks = static_cast<int32_t*>(marks);
  a.sc = sc;
  if (B == 0) {
    sess_sweep_kernel<<<t3, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t rc = launch_scan(a, t1, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // the sweep launches while the scan runs and waits for it where it
  // needs its outputs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(t3);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, sess_sweep_kernel, a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
