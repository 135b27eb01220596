// G11 session_update — event-time session windows for one micro-batch and
// watermark advance, over the lanes in G10's (slot, ts) order.
//
// Replaces (flink_tpu, the JAX reference): ops/session_windows.py
// update_and_fire (:85, kernel K16) after its late filter, upsert and
// lexsort: the session cuts (a slot change, or a gap > G between
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
// reference's emission order — at row positions n_rows, n_rows + 1, ...;
// n_rows advances. ``marks`` (int32 [2] on the card, or null) gets the
// row count after the old fires and after the mid fires, so that a caller
// merging several shards' rows can order them by kind, as the reference's
// host loop does. The reference instead returns [B]- and [C]-sized masks
// that the host reads whole each step.
//
// Design: one segmented scan (segscan.cuh) of (sum, first tick, first
// lane's slot change) per session; within a key the ticks ascend, so a
// session's last tick is its last lane's. The store pass, at each
// session's last lane, merges with the open session and leaves the lane's
// fire flags and merged session in scratch. ring.cuh compacts the old
// fires (their values read from the state, not yet written), then the mid
// fires, stably; a launch writes each key's last session back; a last
// compaction over the C slots emits and clears the watermark closes. int32
// tick arithmetic wraps as the reference's does.
//
// Bound: bytes. Per lane: key (8 B), order (4 B), value (4 B); per session
// end the open session read (13 B) and the merged one written (13 B); per
// fire row 20 B, and hi and lo (8 B) of each lane that fires; the close
// sweep reads active and last of every slot (5 B x C: 21 MB at C = 2^22),
// and start, acc and the key word of each slot it closes. Most of it is
// the sweep.

#include "ring.cuh"
#include "segscan.cuh"

namespace {

struct SessV {
  float agg;      // the session's sum so far
  int32_t smin;   // the session's first tick
  int32_t fos;    // the session's first lane starts its key's lanes
};

__device__ __forceinline__ int key_slot(unsigned long long k) {
  return static_cast<int>(k >> 32);
}

__device__ __forceinline__ int32_t key_ts(unsigned long long k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k) ^ 0x80000000u);
}

struct SessScratch {
  uint8_t* fl;     // bit 0: old fire, bit 1: mid fire, bit 2: write-back
  int32_t* start;  // the merged session
  int32_t* last;
  float* acc;
};

struct SessSrc {
  using V = SessV;
  const unsigned long long* key_s;
  const int32_t* order;
  const float* vals;
  const int32_t* start;
  const int32_t* last;
  const float* acc;
  const uint8_t* active;
  SessScratch out;
  int n;
  int C;
  int32_t G;

  __device__ static SessV op(SessV a, SessV b) {
    return {a.agg + b.agg, a.smin, a.fos};
  }
  __device__ bool slot_change(int i) const {
    return i == 0 || key_slot(key_s[i]) != key_slot(key_s[i - 1]);
  }
  __device__ int32_t flag(int i) const {
    return slot_change(i) ||
           sub_wrap(key_ts(key_s[i]), key_ts(key_s[i - 1])) > G;
  }
  __device__ SessV value(int i) const {
    const unsigned long long k = key_s[i];
    return {key_slot(k) < C ? vals[order[i]] : 0.0f, key_ts(k),
            static_cast<int32_t>(slot_change(i))};
  }
  __device__ void store(int i, int32_t, SessV incl) const {
    const unsigned long long k = key_s[i];
    const int s = key_slot(k);
    uint8_t fl = 0;
    if (s < C && (i == n - 1 || flag(i + 1))) {
      const bool last_of_slot = i == n - 1 || key_slot(key_s[i + 1]) != s;
      const int32_t smax = key_ts(k);
      bool merges = false, o_active = false;
      int32_t o_start = 0, o_last = 0;
      if (incl.fos) {
        o_active = active[s] != 0;
        if (o_active) {
          o_start = start[s];
          o_last = last[s];
          merges = incl.smin <= add_wrap(o_last, G) &&
                   add_wrap(smax, G) >= o_start;
        }
      }
      out.start[i] = merges ? min(o_start, incl.smin) : incl.smin;
      out.last[i] = merges ? max(o_last, smax) : smax;
      out.acc[i] = merges ? acc[s] + incl.agg : incl.agg;
      fl = (incl.fos && o_active && !merges ? 1 : 0) |
           (last_of_slot ? 4 : 2);
    }
    out.fl[i] = fl;
  }
};

struct SessOut {
  uint32_t* hi;
  uint32_t* lo;
  int32_t* start;
  int32_t* end;
  float* val;
};

// the open sessions the first batch session of their key superseded
struct OldFireSrc {
  const uint8_t* fl;
  const unsigned long long* key_s;
  const int32_t* order;
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* start;
  const int32_t* last;
  const float* acc;
  int32_t G;

  __device__ bool take(int i) const { return (fl[i] & 1) != 0; }
  __device__ void lane(int i, SessOut out, int32_t pos) const {
    const int s = key_slot(key_s[i]);
    const int32_t j = order[i];
    out.hi[pos] = hi[j];
    out.lo[pos] = lo[j];
    out.start[pos] = start[s];
    out.end[pos] = add_wrap(last[s], G);
    out.val[pos] = acc[s];
  }
};

// every batch session but its key's last
struct MidFireSrc {
  const uint8_t* fl;
  const int32_t* order;
  const uint32_t* hi;
  const uint32_t* lo;
  SessScratch m;
  int32_t G;

  __device__ bool take(int i) const { return (fl[i] & 2) != 0; }
  __device__ void lane(int i, SessOut out, int32_t pos) const {
    const int32_t j = order[i];
    out.hi[pos] = hi[j];
    out.lo[pos] = lo[j];
    out.start[pos] = m.start[i];
    out.end[pos] = add_wrap(m.last[i], G);
    out.val[pos] = m.acc[i];
  }
};

// the watermark close over all slots: emits and clears
struct CloseSrc {
  const unsigned long long* table;
  const int32_t* start;
  const int32_t* last;
  float* acc;
  uint8_t* active;
  const int32_t* wm;
  int32_t G;

  __device__ bool take(int c) const {
    return active[c] && add_wrap(last[c], G) <= *wm;
  }
  __device__ void lane(int c, SessOut out, int32_t pos) const {
    const unsigned long long w = table[c];
    out.hi[pos] = static_cast<uint32_t>(w >> 32);
    out.lo[pos] = static_cast<uint32_t>(w);
    out.start[pos] = start[c];
    out.end[pos] = add_wrap(last[c], G);
    out.val[pos] = acc[c];
    acc[c] = 0.0f;
    active[c] = 0;
  }
};

__global__ void sess_writeback_kernel(const unsigned long long* __restrict__ key_s,
                                      SessScratch m, int n,
                                      int32_t* __restrict__ start,
                                      int32_t* __restrict__ last,
                                      float* __restrict__ acc,
                                      uint8_t* __restrict__ active) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(m.fl[i] & 4)) return;
  const int s = key_slot(key_s[i]);
  start[s] = m.start[i];
  last[s] = m.last[i];
  acc[s] = m.acc[i];
  active[s] = 1;
}

}  // namespace

// scratch: fl uint8 [B]; m_start, m_last int32 [B]; m_acc float32 [B]; blk
// (scan pairs); blk_count, blk_off int32 [ceil(max(B, C) / kRingChunk)];
// lost int32 0-d. O >= 2B + C row positions past n_rows. marks: see above.
extern "C" int session_update(const void* key_s, const void* order,
                              const void* hi, const void* lo, const void* vals,
                              int B, int C, int G, void* start, void* last,
                              void* acc, void* active, const void* table,
                              const void* wm, int O, void* row_hi,
                              void* row_lo, void* row_start, void* row_end,
                              void* row_val, void* n_rows, void* fl,
                              void* m_start, void* m_last, void* m_acc,
                              void* blk, void* blk_count, void* blk_off,
                              void* lost, void* marks, void* stream) {
  if (G < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ks = static_cast<const unsigned long long*>(key_s);
  const auto* ord = static_cast<const int32_t*>(order);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* l = static_cast<const uint32_t*>(lo);
  auto* st = static_cast<int32_t*>(start);
  auto* la = static_cast<int32_t*>(last);
  auto* ac = static_cast<float*>(acc);
  auto* act = static_cast<uint8_t*>(active);
  const SessScratch m{static_cast<uint8_t*>(fl), static_cast<int32_t*>(m_start),
                      static_cast<int32_t*>(m_last), static_cast<float*>(m_acc)};
  const SessOut out{static_cast<uint32_t*>(row_hi), static_cast<uint32_t*>(row_lo),
                    static_cast<int32_t*>(row_start),
                    static_cast<int32_t*>(row_end), static_cast<float*>(row_val)};
  auto* nr = static_cast<int32_t*>(n_rows);
  auto* lo_t = static_cast<int32_t*>(lost);
  auto* bc = static_cast<int32_t*>(blk_count);
  auto* bo = static_cast<int32_t*>(blk_off);
  auto* mk = static_cast<int32_t*>(marks);
  int rc;
  if (B > 0) {
    const SessSrc src{ks, ord, static_cast<const float*>(vals), st, la, ac,
                      act, m, B, C, G};
    rc = seg_scan_launch(src, B, blk, s);
    if (rc) return rc;
    const OldFireSrc old_f{m.fl, ks, ord, h, l, st, la, ac, G};
    rc = ring_append_launch(old_f, B, O, out, nr, lo_t, bc, bo, s);
    if (rc) return rc;
    if (mk) {
      rc = static_cast<int>(cudaMemcpyAsync(mk, nr, sizeof(int32_t),
                                            cudaMemcpyDeviceToDevice, s));
      if (rc) return rc;
    }
    const MidFireSrc mid_f{m.fl, ord, h, l, m, G};
    rc = ring_append_launch(mid_f, B, O, out, nr, lo_t, bc, bo, s);
    if (rc) return rc;
    sess_writeback_kernel<<<(B + 255) / 256, 256, 0, s>>>(ks, m, B, st, la, ac,
                                                          act);
  }
  if (mk) {
    if (B == 0) {
      rc = static_cast<int>(cudaMemcpyAsync(mk, nr, sizeof(int32_t),
                                            cudaMemcpyDeviceToDevice, s));
      if (rc) return rc;
    }
    rc = static_cast<int>(cudaMemcpyAsync(mk + 1, nr, sizeof(int32_t),
                                          cudaMemcpyDeviceToDevice, s));
    if (rc) return rc;
  }
  const CloseSrc close_f{static_cast<const unsigned long long*>(table), st, la,
                         ac, act, static_cast<const int32_t*>(wm), G};
  rc = ring_append_launch(close_f, C, O, out, nr, lo_t, bc, bo, s);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
