// G15 sketch_fire — evaluate the due windows of a sketch stage for every
// slot: combine each slot's pane registers, finalize them, and compact the
// emitted slots into per-lane (key_hi, key_lo, value) prefixes, or reduce
// each lane to (emitted slots, value sum).
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// _eval_fire_lanes (:1203) on split planes with a vector combine and the
// finalize hook (:1238), kernel K5; ops/sketches.py CountMinSketch.finalize
// (:131) and HyperLogLog.finalize (:206), kernel K19; then _pack_fire_lanes
// (:1079, kernel K11) for a row sink, or the per-lane reduction of
// advance_and_fire_resident(reduced=True) (:1507-1520, = reduce_fires
// :1068) for a device-reduce sink. The scalar fire plan runs before this
// kernel as device torch ops and hands it p_f[F] and lane_ok[F].
//
// Semantics, the reference's: pane q of the window ending at pane p
// (q = p-k+1 .. p) lives in ring row q mod R and counts for a slot where
// pane_ids[row] == q and the slot's touched byte in that row is set; a slot
// is emitted when any of its k panes counts. Its registers combine those
// panes elementwise from the neutral 0, in pane order: + for Count-Min, max
// for HyperLogLog. Then the finalize:
//   raw (no finalize): the W combined registers;
//   query (Count-Min with a query list): for each query item q the min
//     over the D rows of the register at column qcol[d, q] = d * width +
//     qpos[d, q]; only those D x Q registers of each pane are read;
//   hll: z = sum of 2^(base - r) over the M registers as an int64 (base =
//     33 - p bounds every register, so every term is an integer and the
//     sum is exact and order-free), zeros = registers equal to 0; the
//     estimate alpha m^2 / (z / 2^base) = scale / z, or linear counting
//     m (log m - log zeros) when that is <= 2.5 m and zeros > 0, taken in
//     double and rounded to float. The plain version computes the same
//     doubles; only log may round differently.
// value_sums[f] adds the elements of the emitted values in double (exact
// for Count-Min's integers) and rounds to float.
//
// Bound: bytes. A due lane reads the touched bytes of its present rows
// (C each) and, for each emitted slot, its present panes' registers: all W
// of them (16 KB a pane at p = 12) for raw and hll, D x Q for a query.
// The nexmark q16 window (k = 5 panes, 10,004 channels) reads 820 MB a
// lane, about 245 us at 3.35 TB/s; a Count-Min query lane (k = 2, D = 4,
// Q = 3) under 1 MB. It writes 8 B of key and the value per emitted row.
//
// Design: five launches, every one of which exits at once for a lane that
// is not due. (1) count: blocks own chunks of kChunk slots and count the
// emitted ones (k touched bytes a slot). (2) scan: one block a lane turns
// the counts into exclusive offsets and writes counts[f]. (3) rank (row
// sinks only): each block ranks the emitted slots of its chunk with a
// block scan, writes each slot's output row (or -1) to pos and the slot's
// key word to that row — the stable slot order of G6 fire_compact.
// (4) eval: one warp a slot; its lanes stride over the W registers
// (coalesced 128-byte loads per pane row), combine the present panes, and
// reduce in the warp (the hll sums, the raw value sum), or give one query
// item each; lane 0 writes the value and the slot's value-sum term to a
// dense [F, C] double scratch (0 where not emitted). (5) sum: one block a
// lane adds that scratch in a fixed order, so the value sums do not depend
// on scheduling.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// slots per block of (1) and (3), one tile of the block: the sketch
// stages' tables are small (2^14 slots is 64 blocks), where G6's 4,096-slot
// chunks would leave 4 blocks walking 16 tiles each; ops/cuda.py SKETCH_CHUNK
constexpr int kChunk = kThreads;
constexpr int kMaxPanes = 64;  // k <= ring - 1; the presence mask is 64 bits

enum Final { kRaw = 0, kQuery = 1, kHll = 2 };

// rows[j] = ring row of pane j of the window ending at p, -1 if absent
__device__ __forceinline__ void window_rows(const int32_t* pane_ids, int32_t p,
                                            int R, int k, int32_t* rows) {
  if (static_cast<int>(threadIdx.x) < k) {
    const int32_t q = p - (k - 1) + static_cast<int32_t>(threadIdx.x);
    const int32_t row = floor_mod(q, R);
    rows[threadIdx.x] = pane_ids[row] == q ? row : -1;
  }
  __syncthreads();
}

// bit j set where pane j of the window is present and touched for slot c
__device__ __forceinline__ uint64_t slot_panes(const uint8_t* __restrict__ touched,
                                               const int32_t* rows, int k, int C,
                                               int c) {
  uint64_t m = 0;
  for (int j = 0; j < k; ++j) {
    const int32_t row = rows[j];
    if (row >= 0 && touched[static_cast<size_t>(row) * C + c]) m |= 1ull << j;
  }
  return m;
}

// the slot's registers at column i, combined over the present panes
__device__ __forceinline__ int32_t combine_at(const int32_t* __restrict__ acc,
                                              const int32_t* rows, uint64_t panes,
                                              int k, int C, int W, int c, int op,
                                              int i) {
  int32_t v = 0;  // the sketch neutral
  for (int j = 0; j < k; ++j) {
    if (!((panes >> j) & 1ull)) continue;
    const int32_t x =
        acc[(static_cast<size_t>(rows[j]) * C + c) * static_cast<size_t>(W) + i];
    v = op ? max(v, x) : v + x;
  }
  return v;
}

__global__ void fire_count_kernel(const uint8_t* __restrict__ touched,
                                  const int32_t* __restrict__ pane_ids,
                                  const int32_t* __restrict__ p_f,
                                  const uint8_t* __restrict__ lane_ok, int C,
                                  int R, int k, int32_t* __restrict__ blk_count) {
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  window_rows(pane_ids, p_f[f], R, k, s_row);
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, C);
  int32_t n = 0;
  for (int c = start + threadIdx.x; c < end; c += blockDim.x)
    n += slot_panes(touched, s_row, k, C, c) != 0 ? 1 : 0;
  n = block_sum(n);
  if (threadIdx.x == 0) blk_count[f * gridDim.x + blockIdx.x] = n;
}

__global__ void fire_scan_kernel(const uint8_t* __restrict__ lane_ok, int n_blk,
                                 const int32_t* __restrict__ blk_count,
                                 int32_t* __restrict__ blk_off,
                                 int32_t* __restrict__ counts) {
  const int f = blockIdx.x;
  if (!lane_ok[f]) {
    if (threadIdx.x == 0) counts[f] = 0;
    return;
  }
  int32_t carry = 0;
  for (int b0 = 0; b0 < n_blk; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int32_t v = b < n_blk ? blk_count[f * n_blk + b] : 0;
    int32_t tile_total;
    const int32_t ex = block_exclusive_scan(v, &tile_total);
    if (b < n_blk) blk_off[f * n_blk + b] = carry + ex;
    carry += tile_total;
  }
  if (threadIdx.x == 0) counts[f] = carry;
}

__global__ void fire_rank_kernel(const uint8_t* __restrict__ touched,
                                 const int32_t* __restrict__ pane_ids,
                                 const int32_t* __restrict__ p_f,
                                 const uint8_t* __restrict__ lane_ok,
                                 const unsigned long long* __restrict__ table,
                                 int C, int R, int k,
                                 const int32_t* __restrict__ blk_off,
                                 int32_t* __restrict__ pos,
                                 uint32_t* __restrict__ key_hi,
                                 uint32_t* __restrict__ key_lo) {
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  window_rows(pane_ids, p_f[f], R, k, s_row);
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, C);
  int32_t out = blk_off[f * gridDim.x + blockIdx.x];
  const size_t lane_base = static_cast<size_t>(f) * C;
  for (int c0 = start; c0 < end; c0 += blockDim.x) {  // uniform trip count
    const int c = c0 + threadIdx.x;
    const bool emit = c < end && slot_panes(touched, s_row, k, C, c) != 0;
    int32_t tile_total;
    const int32_t rank = block_exclusive_scan(emit ? 1 : 0, &tile_total);
    if (c < end) pos[lane_base + c] = emit ? out + rank : -1;
    if (emit) {
      const unsigned long long w = table[c];
      const size_t o = lane_base + static_cast<size_t>(out + rank);
      key_hi[o] = static_cast<uint32_t>(w >> 32);
      key_lo[o] = static_cast<uint32_t>(w);
    }
    out += tile_total;
  }
}

struct EvalArgs {
  const int32_t* acc;
  const uint8_t* touched;
  const int32_t* pane_ids;
  const int32_t* p_f;
  const uint8_t* lane_ok;
  const int32_t* qcol;   // [D, Q] (query only)
  const int32_t* pos;    // [F, C] output rows (row sinks), else null
  void* values;          // [F, C, out_w] int32 or float (row sinks), else null
  double* contrib;       // [F, C] value-sum terms
  int C, R, k, W, op, final_mode, D, Q, base, m;
  double scale, log_m;
};

__global__ void fire_eval_kernel(EvalArgs a) {
  const int f = blockIdx.y;
  if (!a.lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  window_rows(a.pane_ids, a.p_f[f], a.R, a.k, s_row);
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= a.C) return;  // uniform per warp; no barrier follows
  const size_t at = static_cast<size_t>(f) * a.C + c;
  const uint64_t panes = slot_panes(a.touched, s_row, a.k, a.C, c);
  if (panes == 0) {
    if (lane == 0) a.contrib[at] = 0.0;
    return;
  }
  const bool rows_out = a.pos != nullptr;
  const size_t row = rows_out ? static_cast<size_t>(f) * a.C + a.pos[at] : 0;
  if (a.final_mode == kHll) {
    long long z = 0;
    int32_t zeros = 0;
    for (int i = lane; i < a.W; i += 32) {
      const int32_t v = combine_at(a.acc, s_row, panes, a.k, a.C, a.W, c, a.op, i);
      const int32_t r = min(max(v, 0), a.base);
      z += 1ll << (a.base - r);
      zeros += v == 0 ? 1 : 0;
    }
    z = warp_sum(z);
    zeros = warp_sum(zeros);
    if (lane == 0) {
      const double e = a.scale / static_cast<double>(z);
      const double lin = a.m * (a.log_m - log(static_cast<double>(max(zeros, 1))));
      const float est = (e <= 2.5 * a.m && zeros > 0) ? static_cast<float>(lin)
                                                      : static_cast<float>(e);
      if (rows_out) static_cast<float*>(a.values)[row] = est;
      a.contrib[at] = est;
    }
    return;
  }
  long long s = 0;
  if (a.final_mode == kQuery) {
    for (int q = lane; q < a.Q; q += 32) {
      int32_t est = 0;
      for (int d = 0; d < a.D; ++d) {
        const int32_t v = combine_at(a.acc, s_row, panes, a.k, a.C, a.W, c, a.op,
                                     a.qcol[d * a.Q + q]);
        est = d == 0 ? v : min(est, v);
      }
      if (rows_out) static_cast<int32_t*>(a.values)[row * a.Q + q] = est;
      s += est;
    }
  } else {  // raw registers
    for (int i = lane; i < a.W; i += 32) {
      const int32_t v = combine_at(a.acc, s_row, panes, a.k, a.C, a.W, c, a.op, i);
      if (rows_out) static_cast<int32_t*>(a.values)[row * a.W + i] = v;
      s += v;
    }
  }
  s = warp_sum(s);
  if (lane == 0) a.contrib[at] = static_cast<double>(s);
}

__global__ void fire_sum_kernel(const uint8_t* __restrict__ lane_ok, int C,
                                const double* __restrict__ contrib,
                                float* __restrict__ vsums) {
  const int f = blockIdx.x;
  if (!lane_ok[f]) {
    if (threadIdx.x == 0) vsums[f] = 0.0f;
    return;
  }
  double s = 0.0;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    s += contrib[static_cast<size_t>(f) * C + c];
  s = block_sum(s);
  if (threadIdx.x == 0) vsums[f] = static_cast<float>(s);
}

}  // namespace

extern "C" int sketch_fire(const void* acc, const void* touched,
                           const void* pane_ids, const void* p_f,
                           const void* lane_ok, const void* table, int C, int R,
                           int k, int F, int W, int op, int final_mode,
                           const void* qcol, int D, int Q, int base,
                           double scale, double log_m, int m, void* blk_count,
                           void* blk_off, void* pos, void* contrib,
                           void* key_hi, void* key_lo, void* values,
                           void* counts, void* vsums, void* stream) {
  if (k < 1 || k > kMaxPanes || W < 1 || final_mode < kRaw ||
      final_mode > kHll || (final_mode == kHll && (base < 1 || base > 29)) ||
      (final_mode == kQuery && (qcol == nullptr || D < 1 || Q < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blk = (C + kChunk - 1) / kChunk;
  const dim3 grid(n_blk, F);
  const uint8_t* ok = static_cast<const uint8_t*>(lane_ok);
  const uint8_t* tch = static_cast<const uint8_t*>(touched);
  const int32_t* pids = static_cast<const int32_t*>(pane_ids);
  const int32_t* pf = static_cast<const int32_t*>(p_f);
  fire_count_kernel<<<grid, kThreads, 0, s>>>(tch, pids, pf, ok, C, R, k,
                                              static_cast<int32_t*>(blk_count));
  fire_scan_kernel<<<F, 1024, 0, s>>>(ok, n_blk,
                                      static_cast<const int32_t*>(blk_count),
                                      static_cast<int32_t*>(blk_off),
                                      static_cast<int32_t*>(counts));
  const bool rows_out = key_hi != nullptr;
  if (rows_out) {
    fire_rank_kernel<<<grid, kThreads, 0, s>>>(
        tch, pids, pf, ok, static_cast<const unsigned long long*>(table), C, R,
        k, static_cast<const int32_t*>(blk_off), static_cast<int32_t*>(pos),
        static_cast<uint32_t*>(key_hi), static_cast<uint32_t*>(key_lo));
  }
  EvalArgs a;
  a.acc = static_cast<const int32_t*>(acc);
  a.touched = tch;
  a.pane_ids = pids;
  a.p_f = pf;
  a.lane_ok = ok;
  a.qcol = static_cast<const int32_t*>(qcol);
  a.pos = rows_out ? static_cast<const int32_t*>(pos) : nullptr;
  a.values = rows_out ? values : nullptr;
  a.contrib = static_cast<double*>(contrib);
  a.C = C;
  a.R = R;
  a.k = k;
  a.W = W;
  a.op = op;
  a.final_mode = final_mode;
  a.D = D;
  a.Q = Q;
  a.base = base;
  a.m = m;
  a.scale = scale;
  a.log_m = log_m;
  const dim3 egrid((C + kWarps - 1) / kWarps, F);
  fire_eval_kernel<<<egrid, kThreads, 0, s>>>(a);
  fire_sum_kernel<<<F, kThreads, 0, s>>>(ok, C, static_cast<const double*>(contrib),
                                         static_cast<float*>(vsums));
  return static_cast<int>(cudaGetLastError());
}
