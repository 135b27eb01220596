// G19 cep_scan and G20 cep_expire — the count NFA of device CEP.
//
// Replaces (flink_tpu, the JAX reference): cep/device.py event_matrices
// (:109), _seg_matmul (:156) and the body of advance (:199, kernel K20)
// after its upsert and sort: the per-lane transition T(e) built from the
// stage bits, the segmented associative matrix-product scan over the
// slot-sorted lanes, v = P @ carry[seg] clamped at INT_MAX, each lane's
// match delta M_i - M_{i-1} in the original lane order, the carry write
// of each segment's last lane with M reset to 0, and row C set to the
// neutral vector (:245-288) — G19; and the within() ring rotation that
// zeroes the stale bucket columns s*Q + q (s < S-1) of every carry row
// (:228-243) — G20.
//
// The state vector of a key is v = [c_{0,0} .. c_{S-2,Q-1}, M, 1] (D =
// (S-1)*Q + 2): c_{s,q} counts the key's live partials whose last matched
// stage is s and whose first event fell in ring pane q. One event with
// stage bits m_0..m_{S-1} maps it by
//
//   M'        = M + m_{S-1} * sum_q c_{S-2,q}
//   c_{s,q}'  = keep_s * c_{s,q} + m_s * c_{s-1,q}          (s > 0)
//   c_{0,q}'  = keep_0 * c_{0,q} + [q == q_t] * m_0 * 1
//
// (keep_s = 1 iff stage s+1 is relaxed; a lane with no slot is the
// identity). Every bucket q moves under the same (S-1) x (S-1) lower-
// bidiagonal map L(e) (keep_s on the diagonal, m_s below it); only bucket
// q_t, one slot for the whole batch, takes the injection m_0 * 1; and M
// reads the buckets only through their sum sigma = sum_q c_q, which moves
// like one bucket that takes the injection. So the product of a run of
// lanes is, in block form, one shared matrix A (S-1 x S-1), an injection
// vector b, a linear form f for M and a constant g:
//
//   c_q' = A c_q + [q == q_t] b * 1,   M' = M + f . sigma + g * 1,
//
// S^2 numbers (9 for cep-within's S = 3, Q = 9, D = 20), not D^2.
// Composing two runs, x then y: A = A_y A_x, b = A_y b_x + b_y, f = f_x +
// f_y A_x, g = g_x + f_y . b_x + g_y. Applying each key's transitions in
// lane order to its carried vector gives the same integers as the
// reference's product while every count stays below 2^24, where float32 is
// exact: deltas and carry are bit-equal to the reference's below 2^24.
//
// Design: one launch a call. Lanes arrive sorted by slot (G10), so a key's
// events are one run of lanes; a tile is 64 to kCepTile lanes (tile_lanes:
// small batches take small tiles, to spread over the SMs), and blocks take
// tiles in order from an atomic counter, so a tile waits only on tiles
// that running blocks hold. A segment that crosses tiles (a hot key; the
// whole batch of a non-keyed stream) is carried by decoupled look-back
// (Merrill and Garland): a tile publishes, in a status word, its map
// (aggregate) as soon as it has it, or the state at its end (inclusive);
// a tile whose first lane continues a segment looks back to the nearest
// inclusive tile and applies the maps in between. The status words carry
// the call's epoch, which the wrapper increments, so the scratch (status
// words, maps, end states, the tile counter) is allocated once per device
// and stream and never cleared: a word of an earlier call reads as not
// yet published. A block publishes before it looks back.
//   * S <= 3 and D <= kFastMaxDim (the cep and cep-within jobs): a thread
//     a lane, all in registers. Each lane's one-step map (9 floats) goes
//     through a segmented scan (warp shuffles, then the warps' totals), so
//     every lane holds the map from its piece's first lane to itself. A
//     segment's first lane copies its carry row into shared memory
//     (cp.async, in flight over the stage-bit gather and the scan); a
//     lane's M is then M0 + f . sigma0 + g from its piece's first state,
//     and a segment's last lane writes its new carry row, its map applied
//     to the first row. The look-back reads a block's worth of status
//     words at a time and composes the aggregates behind the nearest
//     inclusive one by warp shuffles.
//   * Any other shape: a thread a piece walks it with the key's vector in
//     an array of kCepMaxDim floats (local memory); a tile with no segment
//     start pushes its S map columns through its lanes; the look-back
//     applies the maps one by one, staged a window at a time.
// D above kCepMaxDim is refused by the wrapper (ops/cuda.py
// CEP_MAX_DIM). Row C (the lanes with no slot) is set to the neutral
// vector by the block that starts the dead lanes' segment, after it has
// read it, or by the last tile's block when no lane is dead.
//
// Bound: bytes. Per lane it reads the stage bits (S B), order (4 B), the
// sorted key (8 B) and flag (1 B), and writes its delta (4 B); per key of
// the batch it reads and writes a carry row (4 D B each way). The cep job's
// batch (16,384 lanes of 1,000 keys, D = 3): ~0.32 MB, 0.1 us; the
// cep-within job's (8,192 lanes, ~7,900 keys, D = 20): ~1.5 MB, 0.44 us.
// Latency bounds these shapes: a launch, the lanes' loads, the gathers of
// the stage bits and of the carry rows, the scan's barriers, and, where a
// segment crosses tiles, a look-back.
//
// G20 (redesigned for the card; its parent took a thread per carry
// element over all [C+1, D], a 64-bit division each, and wrote the few in
// stale columns): the host turns the stale columns into a row's list of
// stores (expire_items), and one launch writes only those, a thread a
// store: zeros of 4, 8 or 16 bytes where the stale columns fill them,
// consecutive threads over one row's stores and then the next row's (one
// stale bucket of cep-within's [2^22 + 1, 20] carry: two 4-byte stores a
// row, 36 bytes apart). 32-bit offsets where rows x D < 2^31 - 256 (every
// shape the jobs run), a grid that covers the stores; 64-bit ones above,
// a grid-stride loop. Row C is zeroed like every other row.
// Bound: bytes, (C + 1) * (S-1) * n_stale * 4 B, the zeros written (one
// stale bucket at the main shape: 33.6 MB, 0.010 ms at 3.35 TB/s); but a
// store of part of a 32-byte sector makes the card read the sector first
// (measured: chip_smoke.py --stress's sector probe), so the floor is the
// touched sectors read and written: 2^23 sectors, 0.160 ms, for one stale
// bucket at the main shape. Writing fewer sectors would need the zeroing
// deferred or the unoccupied slots skipped, which changes what the state
// holds.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kCepTile = 256;     // the largest tile; ops/cuda.py CEP_TILE
constexpr int kThreads = 256;     // threads a block: a lane, or a piece
constexpr int kWarps = kThreads / 32;
constexpr int kCepMaxDim = 128;   // the largest D; ops/cuda.py CEP_MAX_DIM
constexpr int kFastMaxDim = 64;   // the largest D of the register path
constexpr int kMapFloats = 9;     // a map of the register path (S <= 3)
constexpr int kWindowFloats = 4096;  // the other path's map window (16 KB)
constexpr int kMaxWindow = 32;       // maps a window, at most
constexpr float kIntMax = 2147483647.0f;  // device.py INT_MAX (2^31)

// a status word: epoch << 32 | flag
constexpr unsigned long long kAggregate = 1ull;  // the tile's map
constexpr unsigned long long kInclusive = 2ull;  // the state at its end

struct CepArgs {
  const int32_t* order;         // [B] sorted position -> original lane
  const long long* key_s;       // [B] sorted slot keys (C: no slot)
  const uint8_t* seg_start;     // [B]
  const uint8_t* masks;         // [B, S] stage bits, original lane order
  unsigned long long relaxed_lo, relaxed_hi;  // bit s: stage s relaxed
  int B, C, S, Q, D, q_t;
  float* carry;                 // [C+1, D]
  float* delta;                 // [B]
  unsigned long long* status;   // [tiles] scratch
  float* maps;                  // [tiles, max(S*S, kMapFloats)] scratch
  float* states;                // [tiles, D] scratch
  unsigned int* counter;        // the tile counter
  unsigned int base;            // its value when this call starts
  unsigned int epoch;
  int window;                   // maps a look-back window (0: from global)
};

__device__ __forceinline__ bool stage_bit(const uint4& m, int s) {
  const uint32_t w = s < 32 ? m.x : s < 64 ? m.y : s < 96 ? m.z : m.w;
  return (w >> (s & 31)) & 1u;
}

// keep_s: stage s + 1 is relaxed
__device__ __forceinline__ bool keep(const CepArgs& a, int s) {
  const int b = s + 1;
  return ((b < 64 ? a.relaxed_lo >> b : a.relaxed_hi >> (b - 64)) & 1ull) !=
         0;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned epoch,
                                        unsigned long long flag) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(epoch) << 32) | flag;
}

// Spin until tile idx's status word carries this call's epoch; its flag.
__device__ __forceinline__ unsigned long long await_status(const CepArgs& a,
                                                           int idx) {
  const volatile unsigned long long* p = a.status + idx;
  unsigned long long x;
  do {
    x = *p;
  } while (static_cast<unsigned>(x >> 32) != a.epoch);
  return x & 3ull;
}

// A lane of a claimed tile: its key, order, segment start (the batch's
// first lane always starts one) and stage bits.
struct Lane {
  long long key;
  int order;
  bool start, live;
  uint4 bits;
};

__device__ __forceinline__ void load_bits(const CepArgs& a, Lane& l) {
  l.bits = make_uint4(0u, 0u, 0u, 0u);
  const uint8_t* mk = a.masks + static_cast<size_t>(l.order) * a.S;
  if (a.S <= 3) {  // every load in flight before the first is used
    const uint8_t b0 = mk[0], b1 = a.S > 1 ? mk[1] : 0, b2 = a.S > 2 ? mk[2] : 0;
    l.bits.x = (b0 ? 1u : 0u) | (b1 ? 2u : 0u) | (b2 ? 4u : 0u);
    return;
  }
  for (int s = 0; s < a.S; ++s) {
    const uint32_t b = (mk[s] ? 1u : 0u) << (s & 31);
    if (s < 32) {
      l.bits.x |= b;
    } else if (s < 64) {
      l.bits.y |= b;
    } else if (s < 96) {
      l.bits.z |= b;
    } else {
      l.bits.w |= b;
    }
  }
}

// key, order and segment start only (the stage bits: load_bits)
__device__ __forceinline__ Lane load_key(const CepArgs& a, int i) {
  Lane l;
  l.key = a.key_s[i];
  l.order = a.order[i];
  l.start = i == 0 || a.seg_start[i] != 0;
  l.live = l.key < a.C;
  return l;
}

__device__ __forceinline__ Lane load_lane(const CepArgs& a, int i) {
  Lane l = load_key(a, i);
  load_bits(a, l);
  return l;
}

// ------------------------------------------- the register path (S <= 3)

// A run's map for S <= 3: A = [[a00, a01], [a10, a11]], b, f, g; with one
// stage row the second row and column are the identity's and b1 = f1 = 0;
// with none, only g.
struct Map {
  float a00, a01, a10, a11, b0, b1, f0, f1, g;
};

__device__ __forceinline__ Map identity_map() {
  return Map{1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// x, then y
__device__ __forceinline__ Map then(const Map& x, const Map& y) {
  Map r;
  r.a00 = y.a00 * x.a00 + y.a01 * x.a10;
  r.a01 = y.a00 * x.a01 + y.a01 * x.a11;
  r.a10 = y.a10 * x.a00 + y.a11 * x.a10;
  r.a11 = y.a10 * x.a01 + y.a11 * x.a11;
  r.b0 = y.a00 * x.b0 + y.a01 * x.b1 + y.b0;
  r.b1 = y.a10 * x.b0 + y.a11 * x.b1 + y.b1;
  r.f0 = x.f0 + y.f0 * x.a00 + y.f1 * x.a10;
  r.f1 = x.f1 + y.f0 * x.a01 + y.f1 * x.a11;
  r.g = x.g + y.f0 * x.b0 + y.f1 * x.b1 + y.g;
  return r;
}

// A bucket (c0, c1) through the map, taking `inj` times the injection;
// returns what M gains (from the bucket before the map).
__device__ __forceinline__ float apply(const Map& m, float& c0, float& c1,
                                       float inj) {
  const float dm = m.f0 * c0 + m.f1 * c1 + m.g * inj;
  const float n0 = m.a00 * c0 + m.a01 * c1 + m.b0 * inj;
  const float n1 = m.a10 * c0 + m.a11 * c1 + m.b1 * inj;
  c0 = n0;
  c1 = n1;
  return dm;
}

__device__ __forceinline__ Map lane_map(const CepArgs& a, const Lane& l) {
  Map m = identity_map();
  if (!l.live) return m;
  const int ns = a.S - 1;
  const float m0 = (l.bits.x & 1u) ? 1.0f : 0.0f;
  const float m1 = (l.bits.x & 2u) ? 1.0f : 0.0f;
  const float m2 = (l.bits.x & 4u) ? 1.0f : 0.0f;
  if (ns == 0) {
    m.g = m0;
  } else if (ns == 1) {
    m.a00 = keep(a, 0) ? 1.0f : 0.0f;
    m.b0 = m0;
    m.f0 = m1;
  } else {
    m.a00 = keep(a, 0) ? 1.0f : 0.0f;
    m.a10 = m1;
    m.a11 = keep(a, 1) ? 1.0f : 0.0f;
    m.b0 = m0;
    m.f1 = m2;
  }
  return m;
}

__device__ __forceinline__ float shfl(float x, int off, bool up) {
  return up ? __shfl_up_sync(0xffffffffu, x, off)
            : __shfl_down_sync(0xffffffffu, x, off);
}

__device__ __forceinline__ Map shfl_map(const Map& m, int off, bool up) {
  return Map{shfl(m.a00, off, up), shfl(m.a01, off, up),
             shfl(m.a10, off, up), shfl(m.a11, off, up),
             shfl(m.b0, off, up),  shfl(m.b1, off, up),
             shfl(m.f0, off, up),  shfl(m.f1, off, up),
             shfl(m.g, off, up)};
}

// a map in the scratch: kMapFloats floats in Map's order
__device__ __forceinline__ Map load_map(const float* p) {
  return Map{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3),
             __ldcg(p + 4), __ldcg(p + 5), __ldcg(p + 6), __ldcg(p + 7),
             __ldcg(p + 8)};
}

__device__ __forceinline__ void store_map(float* p, const Map& m) {
  p[0] = m.a00;
  p[1] = m.a01;
  p[2] = m.a10;
  p[3] = m.a11;
  p[4] = m.b0;
  p[5] = m.b1;
  p[6] = m.f0;
  p[7] = m.f1;
  p[8] = m.g;
}

// A state (carry-row layout, D floats at v) through the map into out (may
// be v): threads q < nb a bucket each, thread nb sigma and M. Returns
// nothing; the caller syncs.
__device__ __forceinline__ void apply_state(const CepArgs& a, const Map& m,
                                            const float* v, const float* sig,
                                            float* out, float* row) {
  const int ns = a.S - 1, Q = a.Q, D = a.D;
  const int nb = ns > 0 ? Q : 0;
  const int tid = threadIdx.x;
  const float u1 = v[D - 1];
  if (tid < nb) {
    float c0 = v[tid], c1 = ns == 2 ? v[Q + tid] : 0.0f;
    apply(m, c0, c1, tid == a.q_t ? u1 : 0.0f);
    out[tid] = c0;
    if (ns == 2) out[Q + tid] = c1;
    if (row != nullptr) {
      row[tid] = fminf(c0, kIntMax);
      if (ns == 2) row[Q + tid] = fminf(c1, kIntMax);
    }
  } else if (tid == nb) {
    float s0 = sig[0], s1 = sig[1];
    const float M = v[D - 2] + apply(m, s0, s1, u1);
    out[D - 2] = M;
    out[D - 1] = u1;
    if (row != nullptr) {
      row[D - 2] = 0.0f;
      row[D - 1] = fminf(u1, kIntMax);
    }
  }
}

// sigma of a state in carry-row layout: sum_q c_{s,q}, s < S-1
__device__ __forceinline__ float state_sigma(const CepArgs& a, const float* v,
                                             int s) {
  float x = 0.0f;
  for (int q = 0; q < a.Q; ++q) x += v[s * a.Q + q];
  return x;
}

// The state at the end of tile t - 1 into s_prev (D floats) and its sigma
// into s_sig: a block's worth of status words at a time back to the
// nearest inclusive one; the aggregates behind it composed by warp shuffles (a lower thread
// holds a later tile), the windows in order; then applied to that tile's
// end state. Every thread of the block calls it.
__device__ void look_back_fast(const CepArgs& a, int t, float* s_prev,
                               float* s_sig, Map* s_warp, Map* s_acc,
                               int* s_found) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nw = T >> 5;
  Map acc = identity_map();  // the tiles after this window, in thread 0
  int k = -1;
  // the common case first: the tile before has its end state
  if (tid == 0) {
    *s_found = await_status(a, t - 1) == kInclusive ? t - 1 : -1;
    __threadfence();
  }
  __syncthreads();
  if (*s_found >= 0) k = t - 1;
  __syncthreads();
  for (int pred = t - 1; k < 0; pred -= T) {
    const int idx = pred - tid;
    const bool incl = idx >= 0 && await_status(a, idx) == kInclusive;
    __threadfence();
    if (tid == 0) *s_found = T;
    __syncthreads();
    if (incl) atomicMin(s_found, tid);
    __syncthreads();
    const int stop = *s_found;  // the nearest inclusive tile's thread
    Map m = tid < stop && idx >= 0
                ? load_map(a.maps + static_cast<size_t>(idx) * kMapFloats)
                : identity_map();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Map o = shfl_map(m, off, false);  // an earlier tile
      if (lane + off < 32) m = then(o, m);
    }
    if (lane == 0) s_warp[warp] = m;
    __syncthreads();
    if (tid == 0) {
      Map w = s_warp[nw - 1];
      for (int i = nw - 2; i >= 0; --i) w = then(w, s_warp[i]);
      acc = then(w, acc);
    }
    if (stop < T) k = pred - stop;  // uniform
    __syncthreads();
  }
  if (tid == 0) *s_acc = acc;
  __syncthreads();
  const float* e = a.states + static_cast<size_t>(k) * a.D;
  for (int d = tid; d < a.D; d += T) s_prev[d] = __ldcg(e + d);
  __syncthreads();
  const int ns = a.S - 1;
  float sig[2] = {0.0f, 0.0f};
  for (int s = 0; s < ns; ++s) sig[s] = state_sigma(a, s_prev, s);
  const Map m = *s_acc;
  __syncthreads();  // every thread has read s_prev before it is rewritten
  apply_state(a, m, s_prev, sig, s_prev, nullptr);
  __syncthreads();
  if (tid < 2) s_sig[tid] = tid < ns ? state_sigma(a, s_prev, tid) : 0.0f;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) cep_fast_kernel(CepArgs a) {
  __shared__ uint32_t s_ball[kWarps];
  __shared__ float s_sig[kCepTile + 1][2];  // a piece's first sigma
  __shared__ float s_M[kCepTile];
  __shared__ __align__(16) float s_prev[kFastMaxDim];
  __shared__ Map s_wtot[kWarps], s_wexcl[kWarps], s_tail, s_acc;
  __shared__ uint8_t s_wflag[kWarps];
  __shared__ int s_tile, s_found;
  extern __shared__ __align__(16) float s_row[];  // [pieces starting here, D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nw = T >> 5;  // a tile's lanes: a thread each
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(a.counter, 1u) - a.base);
  __syncthreads();
  const int t = s_tile;
  const int t0 = t * T;
  const int n = a.B > t0 ? min(T, a.B - t0) : 0;
  const int ns = a.S - 1, Q = a.Q, D = a.D;
  const int nb = ns > 0 ? Q : 0;
  const bool last_tile = t0 + n >= a.B;
  const bool ends_here = last_tile || a.seg_start[t0 + n] != 0;

  Lane l{};
  if (tid < n) l = load_key(a, t0 + tid);
  const bool start = tid < n && l.start;
  // pieces: each segment start, numbered in lane order; a first piece that
  // continues the tile before is number n_starts
  const uint32_t ball = __ballot_sync(0xffffffffu, start);
  if (lane == 0) s_ball[warp] = ball;
  __syncthreads();
  int n_starts = 0, before = 0;
  for (int w = 0; w < nw; ++w) {
    const int c = __popc(s_ball[w]);
    n_starts += c;
    before += w < warp ? c : 0;
  }
  const uint32_t upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
  const int incl = before + __popc(ball & upto);
  const int piece = incl > 0 ? incl - 1 : n_starts;
  const bool cont = n > 0 && !(s_ball[0] & 1u);
  const bool dead_start = start && !l.live;
  // a segment's first lane copies its carry row into shared memory, in
  // flight (cp.async: no register waits for it) over the stage-bit gather
  // and the scan
  if (start) {
    const float* src = a.carry + l.key * D;
    float* dst = s_row + piece * D;
    if (D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.carry) & 15) == 0) {
      for (int i = 0; i < D; i += 4) __pipeline_memcpy_async(dst + i, src + i, 16);
    } else {
      for (int i = 0; i < D; ++i) __pipeline_memcpy_async(dst + i, src + i, 4);
    }
  }
  __pipeline_commit();
  if (tid < n) load_bits(a, l);
  // the next lane starts a segment (lane n - 1: the tile after does)
  const bool next_start = lane < 31 ? ((ball >> (lane + 1)) & 1u) != 0
                                    : warp + 1 < nw && (s_ball[warp + 1] & 1u);
  // each lane's map from its piece's first lane to itself
  Map m = identity_map();
  if (tid < n) m = lane_map(a, l);
  bool f = start;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Map pm = shfl_map(m, off, true);
    const bool pf = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off && !f) {
      m = then(pm, m);
      f = pf;
    }
  }
  if (lane == 31) {
    s_wtot[warp] = m;
    s_wflag[warp] = f;
  }
  __syncthreads();
  if (tid == 0) {
    Map e = identity_map();
    for (int w = 0; w < nw; ++w) {
      s_wexcl[w] = e;
      e = s_wflag[w] ? s_wtot[w] : then(e, s_wtot[w]);
    }
  }
  __syncthreads();
  if (!f) m = then(s_wexcl[warp], m);
  if (tid == n - 1) s_tail = m;
  // a segment's last lane here: its piece's carry row is written (below)
  const bool end = tid < n && (tid == n - 1 ? ends_here : next_start);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (start) {
    for (int s = 0; s < 2; ++s) {
      s_sig[piece][s] = s < ns ? state_sigma(a, s_row + piece * D, s) : 0.0f;
    }
  }
  __syncthreads();
  float* out = a.states + static_cast<size_t>(t) * D;
  if (n > 0 && n_starts > 0) {
    // the last piece starts here: the tile's end state, published now
    const int p = n_starts - 1;
    apply_state(a, s_tail, s_row + p * D, s_sig[p], out, nullptr);
    __threadfence();
    __syncthreads();
    if (tid == 0) publish(a.status + t, a.epoch, kInclusive);
  } else if (n > 0) {
    if (tid == 0) {
      store_map(a.maps + static_cast<size_t>(t) * kMapFloats, s_tail);
      __threadfence();
      publish(a.status + t, a.epoch, kAggregate);
    }
  }
  if (cont) {  // uniform
    look_back_fast(a, t, s_prev, s_sig[n_starts], s_wtot, &s_acc, &s_found);
    if (n_starts == 0) {
      apply_state(a, s_tail, s_prev, s_sig[n_starts], out, nullptr);
      __threadfence();
      __syncthreads();
      if (tid == 0) publish(a.status + t, a.epoch, kInclusive);
    }
  }
  // each lane's M and delta from its piece's first state
  float M = 0.0f, M0 = 0.0f;
  if (tid < n) {
    const float* st = piece < n_starts ? s_row + piece * D : s_prev;
    M0 = st[D - 2];
    float s0 = s_sig[piece][0], s1 = s_sig[piece][1];
    M = M0 + apply(m, s0, s1, st[D - 1]);
    s_M[tid] = M;
  }
  __syncthreads();
  if (tid < n) {
    const float prev = start ? M0 : fminf(tid == 0 ? M0 : s_M[tid - 1], kIntMax);
    a.delta[l.order] = fminf(M, kIntMax) - prev;
  }
  // each segment's last lane writes its new carry row: its map from the
  // piece's first state, a bucket at a time, built in place in shared
  // memory (no other lane reads that row now), then stored 16 bytes at a
  // time where the rows allow
  if (end && l.live) {
    float* w = piece < n_starts ? s_row + piece * D : s_prev;
    const float u1 = w[D - 1];
    for (int q = 0; q < nb; ++q) {
      float c0 = w[q], c1 = ns == 2 ? w[Q + q] : 0.0f;
      apply(m, c0, c1, q == a.q_t ? u1 : 0.0f);
      w[q] = fminf(c0, kIntMax);
      if (ns == 2) w[Q + q] = fminf(c1, kIntMax);
    }
    w[D - 2] = 0.0f;
    w[D - 1] = fminf(u1, kIntMax);
    float* row = a.carry + l.key * D;
    if (D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.carry) & 15) == 0) {
      for (int i = 0; i < D; i += 4) {
        *reinterpret_cast<float4*>(row + i) = *reinterpret_cast<const float4*>(w + i);
      }
    } else {
      for (int i = 0; i < D; ++i) row[i] = w[i];
    }
  }
  const bool resets_c = __syncthreads_or(dead_start) != 0 ||
                        (last_tile && (a.B == 0 || a.key_s[a.B - 1] < a.C));
  if (resets_c) {  // uniform: after every read of row C in this block
    for (int d = tid; d < D; d += T) {
      a.carry[static_cast<size_t>(a.C) * D + d] = d == D - 1 ? 1.0f : 0.0f;
    }
  }
}

// ------------------------------------------------- the path for any shape

// One live lane on an (S-1)-vector c (a bucket, sigma, or a map column)
// and M: M += m_{S-1} c_{S-2}, then the stages from S-2 down, then the
// injection `inj` into stage 0 on m_0 (with S = 1: M += m_0 * inj).
__device__ __forceinline__ void vec_step(const CepArgs& a, float* c, float& M,
                                         const uint4& m, float inj) {
  const int ns = a.S - 1;
  if (ns == 0) {
    if (stage_bit(m, 0)) M += inj;
    return;
  }
  if (stage_bit(m, ns)) M += c[ns - 1];
  for (int s = ns - 1; s >= 1; --s) {
    c[s] = (keep(a, s) ? c[s] : 0.0f) + (stage_bit(m, s) ? c[s - 1] : 0.0f);
  }
  c[0] = (keep(a, 0) ? c[0] : 0.0f) + (stage_bit(m, 0) ? inj : 0.0f);
}

// One live lane on a key's whole vector c[s * Q + q], M, the constant u1.
__device__ __forceinline__ void key_step(const CepArgs& a, float* c, float& M,
                                         const uint4& m, float u1) {
  const int ns = a.S - 1, Q = a.Q;
  if (ns == 0) {
    if (stage_bit(m, 0)) M += u1;
    return;
  }
  if (stage_bit(m, ns)) {
    float add = 0.0f;
    for (int q = 0; q < Q; ++q) add += c[(ns - 1) * Q + q];
    M += add;
  }
  for (int s = ns - 1; s >= 1; --s) {
    const bool k = keep(a, s), take = stage_bit(m, s);
    for (int q = 0; q < Q; ++q) {
      c[s * Q + q] = (k ? c[s * Q + q] : 0.0f) + (take ? c[(s - 1) * Q + q] : 0.0f);
    }
  }
  const bool m0 = stage_bit(m, 0), k0 = keep(a, 0);
  for (int q = 0; q < Q; ++q) {
    c[q] = (k0 ? c[q] : 0.0f) + (m0 && q == a.q_t ? u1 : 0.0f);
  }
}

// Apply a map (S columns of S floats at mp: column k < S-1 what the run
// makes of the unit partial e_k, then f_k; column S-1 what it makes of the
// constant, b then g; in shared memory, or in global memory when
// `global`) to an (S-1)-vector c that takes the injection `inj`: c := A c
// + inj b; returns f . c + inj g (c before).
__device__ __forceinline__ float apply_map(const CepArgs& a, const float* mp,
                                           bool global, float* c, float inj) {
  const int ns = a.S - 1, w = a.S;
  auto ld = [&](int i) { return global ? __ldcg(mp + i) : mp[i]; };
  float out[kCepMaxDim];
  float dm = inj * ld(ns * w + ns);
  for (int r = 0; r < ns; ++r) out[r] = inj * ld(ns * w + r);
  for (int k = 0; k < ns; ++k) {
    for (int r = 0; r < ns; ++r) out[r] += ld(k * w + r) * c[k];
    dm += ld(k * w + ns) * c[k];
  }
  for (int r = 0; r < ns; ++r) c[r] = out[r];
  return dm;
}

// Walk lanes [j0, j1) of the tile for one piece of a key's segment from
// the vector at `from` (a carry row, or the previous tile's end state in
// shared memory): each lane's delta; at the end, the carry row `row`
// (where the segment ends here and has a slot; else null) and the end
// state `out` (or null). `first_real`: j0 starts the segment, so its delta
// is taken from the unclamped M it starts from, as the reference does.
__device__ void walk_key(const CepArgs& a, const uint4* s_bits,
                         const uint8_t* s_live, const int32_t* s_order,
                         int j0, int j1, const float* from, bool first_real,
                         float* row, float* out) {
  const int n = (a.S - 1) * a.Q, D = a.D;
  float c[kCepMaxDim];
  for (int i = 0; i < n; ++i) c[i] = from[i];
  float M = from[D - 2];
  const float u1 = from[D - 1];
  float prev = first_real ? M : fminf(M, kIntMax);
  for (int j = j0; j < j1; ++j) {
    if (s_live[j]) key_step(a, c, M, s_bits[j], u1);
    const float mc = fminf(M, kIntMax);
    a.delta[s_order[j]] = mc - prev;
    prev = mc;
  }
  if (row != nullptr) {
    for (int i = 0; i < n; ++i) row[i] = fminf(c[i], kIntMax);
    row[D - 2] = 0.0f;
    row[D - 1] = fminf(u1, kIntMax);
  }
  if (out != nullptr) {
    for (int i = 0; i < n; ++i) out[i] = c[i];
    out[D - 2] = M;
    out[D - 1] = u1;
  }
}

// The state at the end of tile t - 1 into s_prev (D floats): warp 0 finds
// the nearest tile before t with an end state; the block applies the maps
// of the tiles after it, in order, a thread a bucket (threads q < nb) and
// one for sigma and M (thread nb). Every thread of the block calls it.
__device__ void look_back(const CepArgs& a, int t, float* s_prev,
                          float* s_maps, int* s_found) {
  const int ns = a.S - 1, Q = a.Q, D = a.D, w = a.S * a.S;
  const int nb = ns > 0 ? Q : 0;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int pred = t - 1;; pred -= 32) {
      const int idx = pred - lane;
      const bool incl = idx >= 0 && await_status(a, idx) == kInclusive;
      const unsigned hit = __ballot_sync(0xffffffffu, incl);
      if (hit) {  // tile 0 starts a segment, so some window has one
        if (lane == 0) *s_found = pred - (__ffs(hit) - 1);
        break;
      }
    }
    __threadfence();
  }
  __syncthreads();
  const int k = *s_found;
  const int tid = threadIdx.x;
  const bool walker = tid <= nb;
  const float* e = a.states + static_cast<size_t>(k) * D;
  float c[kCepMaxDim];
  float M = 0.0f;
  const float u1 = __ldcg(e + D - 1);
  if (walker) {
    for (int s = 0; s < ns; ++s) {
      c[s] = 0.0f;
      if (tid < nb) {
        c[s] = __ldcg(e + s * Q + tid);
      } else {
        for (int q = 0; q < Q; ++q) c[s] += __ldcg(e + s * Q + q);
      }
    }
    M = __ldcg(e + D - 2);
  }
  const float inj = tid == nb ? u1 : (tid == a.q_t ? u1 : 0.0f);
  for (int t1 = k + 1; t1 < t; t1 += (a.window > 0 ? a.window : 1)) {
    const int cnt = a.window > 0 ? min(a.window, t - t1) : 1;
    const float* src = a.maps + static_cast<size_t>(t1) * w;
    if (a.window > 0) {
      __syncthreads();
      for (int i = tid; i < cnt * w; i += kThreads) s_maps[i] = __ldcg(src + i);
      __syncthreads();
    }
    if (walker) {
      for (int i = 0; i < cnt; ++i) {
        const float dm = a.window > 0
                             ? apply_map(a, s_maps + i * w, false, c, inj)
                             : apply_map(a, src, true, c, inj);
        if (tid == nb) M += dm;
      }
    }
  }
  if (walker) {
    if (tid < nb) {
      for (int s = 0; s < ns; ++s) s_prev[s * Q + tid] = c[s];
    } else {
      s_prev[D - 2] = M;
      s_prev[D - 1] = u1;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) cep_any_kernel(CepArgs a) {
  __shared__ uint4 s_bits[kCepTile];
  __shared__ int32_t s_order[kCepTile];
  __shared__ uint8_t s_live[kCepTile];
  __shared__ int32_t s_piece[kCepTile + 1];
  __shared__ float s_prev[kCepMaxDim];
  __shared__ int s_tile, s_found;
  extern __shared__ float s_maps[];
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(a.counter, 1u) - a.base);
  __syncthreads();
  const int t = s_tile;
  const int t0 = t * kCepTile;
  const int n = a.B > t0 ? min(kCepTile, a.B - t0) : 0;
  const int ns = a.S - 1, Q = a.Q, D = a.D;
  const int nb = ns > 0 ? Q : 0;

  bool start = false, dead_start = false;
  if (tid < n) {
    const Lane l = load_lane(a, t0 + tid);
    start = l.start;
    s_bits[tid] = l.bits;
    s_order[tid] = l.order;
    s_live[tid] = l.live;
    dead_start = start && !l.live;
  }
  // pieces: the tile's first lane and every segment start
  const bool pstart = tid < n && (tid == 0 || start);
  int32_t n_pieces = 0;
  const int32_t rank = block_exclusive_scan(pstart ? 1 : 0, &n_pieces);
  if (pstart) s_piece[rank] = tid;
  if (tid == 0) s_piece[n_pieces] = n;
  const bool has_start = __syncthreads_or(start) != 0;
  const bool last_tile = t0 + n >= a.B;
  const bool resets_c = __syncthreads_or(dead_start) != 0 ||
                        (last_tile && (a.B == 0 || a.key_s[a.B - 1] < a.C));
  if (n > 0) {
    // the first piece continues the tile before
    const bool cont = t0 > 0 && a.seg_start[t0] == 0;
    const bool ends_here = last_tile || a.seg_start[t0 + n] != 0;
    auto row_of = [&](int j) {  // the carry row of the lane's key, or null
      const long long key = a.key_s[t0 + j];
      return key < a.C ? a.carry + key * D : nullptr;
    };
    if (has_start) {
      // a thread a piece that starts here; the last piece's end state is
      // this tile's inclusive status, published as soon as it is walked
      const int p = tid;
      if (p < n_pieces && !(p == 0 && cont)) {
        const int j0 = s_piece[p];
        const bool last = p == n_pieces - 1;
        walk_key(a, s_bits, s_live, s_order, j0, s_piece[p + 1],
                 a.carry + a.key_s[t0 + j0] * D, true,
                 last && !ends_here ? nullptr : row_of(j0),
                 last ? a.states + static_cast<size_t>(t) * D : nullptr);
        if (last) {
          __threadfence();
          publish(a.status + t, a.epoch, kInclusive);
        }
      }
      if (cont) {  // uniform; the piece ends here, at the next start
        // every publish of this block first: a warp that spins in the
        // look-back could otherwise hold back a publisher it shares
        __syncthreads();
        look_back(a, t, s_prev, s_maps, &s_found);
        if (tid == 0) {
          walk_key(a, s_bits, s_live, s_order, 0, s_piece[1], s_prev, false,
                   row_of(0), nullptr);
        }
      }
    } else {
      // one piece continues through the whole tile: its map first, the S
      // columns pushed through the lanes by S threads
      float* mp = a.maps + static_cast<size_t>(t) * a.S * a.S;
      if (tid <= ns) {
        float c[kCepMaxDim];
        for (int s = 0; s < ns; ++s) c[s] = s == tid ? 1.0f : 0.0f;
        float M = 0.0f;
        const float inj = tid == ns ? 1.0f : 0.0f;
        for (int j = 0; j < n; ++j) {
          if (s_live[j]) vec_step(a, c, M, s_bits[j], inj);
        }
        for (int s = 0; s < ns; ++s) mp[tid * a.S + s] = c[s];
        mp[tid * a.S + ns] = M;
        __threadfence();
      }
      __syncthreads();
      if (tid == 0) publish(a.status + t, a.epoch, kAggregate);
      look_back(a, t, s_prev, s_maps, &s_found);
      // this tile's end state: the map applied to the previous tile's
      float* out = a.states + static_cast<size_t>(t) * D;
      float* row = ends_here ? row_of(0) : nullptr;
      const float u1 = s_prev[D - 1];
      if (tid <= nb) {
        float c[kCepMaxDim];
        for (int s = 0; s < ns; ++s) {
          c[s] = tid < nb ? s_prev[s * Q + tid] : state_sigma(a, s_prev, s);
        }
        const float inj = tid == nb || tid == a.q_t ? u1 : 0.0f;
        const float dm = apply_map(a, mp, false, c, inj);
        if (tid < nb) {
          for (int s = 0; s < ns; ++s) {
            out[s * Q + tid] = c[s];
            if (row != nullptr) row[s * Q + tid] = fminf(c[s], kIntMax);
          }
        } else {
          out[D - 2] = s_prev[D - 2] + dm;
          out[D - 1] = u1;
          if (row != nullptr) {
            row[D - 2] = 0.0f;
            row[D - 1] = fminf(u1, kIntMax);
          }
        }
        __threadfence();
      } else if (tid == kThreads - 1) {
        // the deltas: sigma and M through the tile's lanes
        float c[kCepMaxDim];
        for (int s = 0; s < ns; ++s) c[s] = state_sigma(a, s_prev, s);
        float M = s_prev[D - 2];
        float prev = fminf(M, kIntMax);
        for (int j = 0; j < n; ++j) {
          if (s_live[j]) vec_step(a, c, M, s_bits[j], u1);
          const float mc = fminf(M, kIntMax);
          a.delta[s_order[j]] = mc - prev;
          prev = mc;
        }
      }
      __syncthreads();
      if (tid == 0) publish(a.status + t, a.epoch, kInclusive);
    }
  }
  if (resets_c) {  // uniform: after every read of row C in this block
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      a.carry[static_cast<size_t>(a.C) * D + d] = d == D - 1 ? 1.0f : 0.0f;
    }
  }
}

// G20's stores into one carry row: (offset, width) items in floats, each
// width 1, 2 or 4 at an offset that is a multiple of it (built on the
// host from the stale columns, expire_items).
constexpr int kExpireItems = kCepMaxDim;
struct ExpireItems {
  uint8_t off[kExpireItems];
  uint8_t width[kExpireItems];
  int n;
};

// One item's store: zeros of width 1, 2 or 4 floats.
__device__ __forceinline__ void expire_item(float* p, int width) {
  if (width == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else if (width == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(0.0f, 0.0f);
  } else {
    *p = 0.0f;
  }
}

// G20 over `rows` rows, a thread an item: consecutive threads over a
// row's items, then the next row's, so a warp's stores cover neighbouring
// rows. With 32-bit offsets the grid covers the items, one a thread (an
// item's row by a multiply and a shift, dm dividing by it.n; measured
// faster than a grid-stride loop over 32 blocks an SM); with 64-bit ones
// the loop steps by the grid, adding its stride in rows and items. The
// items sit in shared memory, for indexing by a thread's item.
template <typename Idx>
__global__ void __launch_bounds__(256)
    cep_expire_kernel(float* __restrict__ carry, Idx rows, int D,
                      ExpireItems it, DivMagic dm) {
  __shared__ uint8_t s_off[kExpireItems], s_w[kExpireItems];
  for (int k = threadIdx.x; k < it.n; k += blockDim.x) {
    s_off[k] = it.off[k];
    s_w[k] = it.width[k];
  }
  __syncthreads();
  const Idx g = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (sizeof(Idx) == 4) {
    const int32_t r = floor_div(static_cast<int32_t>(g), dm);
    const int k = static_cast<int>(g) - r * it.n;
    if (r < rows) expire_item(carry + r * D + s_off[k], s_w[k]);
    return;
  }
  const int n = it.n;
  const Idx step = static_cast<Idx>(gridDim.x) * blockDim.x;
  const Idx step_r = step / n;
  const int step_k = static_cast<int>(step - step_r * n);
  Idx r = g / n;
  int k = static_cast<int>(g - r * n);
  while (r < rows) {
    expire_item(carry + r * D + s_off[k], s_w[k]);
    r += step_r;
    k += step_k;
    if (k >= n) {
      k -= n;
      ++r;
    }
  }
}

template <typename Idx>
void launch_expire(float* c, long long rows, int D, const ExpireItems& it,
                   cudaStream_t s) {
  const long long want = (rows * it.n + 255) / 256;
  const long long most = sizeof(Idx) == 4 ? want : 32LL * sm_count();
  cep_expire_kernel<Idx>
      <<<static_cast<int>(want < most ? want : most), 256, 0, s>>>(
          c, static_cast<Idx>(rows), D, it, div_magic(it.n));
}

// The items of the stale columns (bit c of col_lo / col_hi). g is the
// widest store the rows allow (4 when D % 4 == 0 and the carry is 16-byte
// aligned, 2 when D is even and it is 8-byte aligned, else 1).
ExpireItems expire_items(unsigned long long col_lo, unsigned long long col_hi,
                         int D, int g) {
  auto stale = [&](int c) {
    return ((c < 64 ? col_lo >> c : col_hi >> (c - 64)) & 1ull) != 0ull;
  };
  ExpireItems it{};
  for (int c = 0; c < D;) {
    int w = 0;
    for (int cand = g; cand >= 1 && w == 0; cand >>= 1) {
      bool all = c % cand == 0 && c + cand <= D;
      for (int j = 0; all && j < cand; ++j) all = stale(c + j);
      if (all) w = cand;
    }
    if (w) {
      it.off[it.n] = static_cast<uint8_t>(c);
      it.width[it.n++] = static_cast<uint8_t>(w);
      c += w;
    } else {
      ++c;
    }
  }
  return it;
}

// A tile's lanes: the register path takes 64 or 128 for a batch too small
// to give the card two tiles an SM at 256 (each SM's outstanding loads of
// random carry rows bound a tile's time), the other path 256.
int tile_lanes(int B, int S, int D) {
  if (S > 3 || D > kFastMaxDim) return kCepTile;
  constexpr int kSpread = 2 * 132;  // tiles wanted: two an SM
  if (B >= kCepTile * kSpread) return kCepTile;
  return B >= (kCepTile / 2) * kSpread ? kCepTile / 2 : kCepTile / 4;
}

}  // namespace

// G19's tiles for B lanes (at least one): blocks a call launches, and the
// rows of the scratch it uses.
extern "C" int cep_scan_tiles(int B, int S, int D) {
  const int T = tile_lanes(B, S, D);
  return B > 0 ? (B + T - 1) / T : 1;
}

// G19. order int32 [B], key_s int64 [B], seg_start uint8 [B] from G10 on
// the slot key (C for a lane with no slot); masks uint8 [B, S] in lane
// order; the stages' relaxed flags as a 128-bit mask (S <= 127, since D <=
// kCepMaxDim); carry float32 [C+1, D], updated in place; delta float32 [B]
// (lane order). Scratch, kept by the caller across calls: status uint64
// [tiles] (zeroed once), maps float32 [tiles, max(S*S, 9)], states float32
// [tiles, D], the tile counter (zeroed once) with its value `base` when
// this call starts; tiles = cep_scan_tiles(B, S, D), one block each;
// `epoch` this call's, never 0 and never an earlier call's on this scratch.
extern "C" int cep_scan(const void* order, const void* key_s, const void* seg_start,
                        const void* masks, unsigned long long relaxed_lo,
                        unsigned long long relaxed_hi, int B, int C, int S,
                        int Q, int D, int q_t, void* carry, void* delta,
                        void* status, void* maps, void* states, void* counter,
                        unsigned int base, unsigned int epoch, void* stream) {
  if (S < 1 || D > kCepMaxDim || D != (S - 1) * Q + 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = S * S;
  const int window = w <= kWindowFloats ? min(kMaxWindow, kWindowFloats / w) : 0;
  CepArgs a{static_cast<const int32_t*>(order),
            static_cast<const long long*>(key_s),
            static_cast<const uint8_t*>(seg_start),
            static_cast<const uint8_t*>(masks),
            relaxed_lo, relaxed_hi, B, C, S, Q, D, q_t,
            static_cast<float*>(carry), static_cast<float*>(delta),
            static_cast<unsigned long long*>(status),
            static_cast<float*>(maps), static_cast<float*>(states),
            static_cast<unsigned int*>(counter), base, epoch, window};
  const int T = tile_lanes(B, S, D);
  const int tiles = B > 0 ? (B + T - 1) / T : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 3 && D <= kFastMaxDim) {
    const size_t smem = static_cast<size_t>(T) * D * sizeof(float);
    static bool opened[64] = {};  // shared memory above 48 KB, per device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64 || !opened[dev]) {
      const cudaError_t rc = cudaFuncSetAttribute(
          cep_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kCepTile * kFastMaxDim * sizeof(float)));
      if (rc != cudaSuccess) return static_cast<int>(rc);
      if (dev >= 0 && dev < 64) opened[dev] = true;
    }
    cep_fast_kernel<<<tiles, T, smem, s>>>(a);
  } else {
    const size_t smem = static_cast<size_t>(window) * w * sizeof(float);
    cep_any_kernel<<<tiles, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// G20. carry float32 [C+1, D] in place; the stale ring slots as a 128-bit
// mask (Q <= 126, since D <= kCepMaxDim). Launches nothing when no column
// is stale.
extern "C" int cep_expire(void* carry, long long rows, int D, int S, int Q,
                          unsigned long long stale_lo,
                          unsigned long long stale_hi, void* stream) {
  if (S < 1 || Q < 1 || D != (S - 1) * Q + 2 || D > kCepMaxDim || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long col[2] = {0ull, 0ull};
  for (int c = 0; c < (S - 1) * Q; ++c) {
    const int q = c % Q;
    if ((q < 64 ? stale_lo >> q : stale_hi >> (q - 64)) & 1ull) {
      col[c >> 6] |= 1ull << (c & 63);
    }
  }
  const uintptr_t at = reinterpret_cast<uintptr_t>(carry);
  const int g = D % 4 == 0 && at % 16 == 0 ? 4
                : D % 2 == 0 && at % 8 == 0 ? 2 : 1;
  const ExpireItems it = expire_items(col[0], col[1], D, g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (it.n == 0 || rows == 0) return static_cast<int>(cudaGetLastError());
  float* c = static_cast<float*>(carry);
  constexpr long long kNarrow = (1LL << 31) - 256;  // 32-bit offsets
  if (rows * D < kNarrow && rows * it.n < kNarrow) {
    launch_expire<int>(c, rows, D, it, s);
  } else {
    launch_expire<long long>(c, rows, D, it, s);
  }
  return static_cast<int>(cudaGetLastError());
}
