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
// identity). The kernel applies T(e) to vectors in place, in that order
// (M first, then the stages from S-2 down), and never builds a [D, D]
// matrix per lane: the reference's T is sparse (at most two non-zeros a
// stage row, Q + 1 in the M row).
//
// Design: lanes arrive sorted by slot (G10), so a key's events are one run
// of lanes in arrival order. Applying each key's transitions in lane order
// to its carried vector gives the same integers as the reference's
// product while every count stays below 2^24, where float32 is exact:
// deltas and carry are bit-equal to the reference's below 2^24. No thread
// walks more than one tile of kCepTile lanes; a segment that crosses tiles
// (a hot key; the whole batch of a non-keyed stream) is composed across
// tiles in the three-pass structure of segscan.cuh:
//   (1) cep_tile_kernel, a block per tile: if a segment starts in the
//       tile, one thread walks the tile's last piece from its key's carry
//       row and keeps the start vector (Sv) and the end vector (W);
//       otherwise the whole tile continues one segment, and D threads
//       each push one column of the identity through the tile's lanes,
//       giving the tile's D x D product A_t;
//   (2) cep_carry_kernel, one block: in tile order, W_t = A_t @ W_{t-1}
//       for each tile with no segment start (the only sequential step: a
//       matrix-vector product per such tile), and row C := neutral;
//   (3) cep_apply_kernel, a block per tile, a thread per piece: the
//       piece's start vector is W_{t-1} (it continues the tile before),
//       Sv_t (the tile's last piece) or its key's carry row (a segment
//       wholly inside the tile, read and written by the same thread); the
//       thread walks the piece, writes each lane's delta and, at the
//       segment's last lane, the new carry row (M = 0). A carry row read
//       in pass 3 belongs to a segment only that thread writes, and the
//       rows of segments that cross tiles were read in pass 1: no race.
// Per-thread vectors are local arrays of kCepMaxDim floats (L1-resident);
// D above kCepMaxDim is refused by the wrapper (ops/cuda.py CEP_MAX_DIM).
//
// Bound: bytes. Per lane it reads the stage bits (S B), order (4 B), the
// sorted key (8 B) and flag (1 B), and writes its delta (4 B); per key of
// the batch it reads and writes a carry row (4 D B each way). The cep job's
// batch (16,384 lanes of 1,000 keys, D = 3): ~0.32 MB, 0.1 us; the
// cep-within job's (262,144 lanes, ~230,000 keys, D = 20): ~42 MB, 12.5 us.
// The sequential matrix-vector chain of pass 2 runs only on tiles with no
// segment start, and one thread walks each piece: a hot key's lanes run at
// one thread's speed per tile, and the one-segment batch at one
// matrix-vector product per tile in pass 2 — latency, not bytes, bounds
// those shapes.
//
// G20: a thread per carry element over [C+1, D]; it writes 0 where the
// column is a stale bucket of a stage row. Bound: the stale columns, read
// and written: (C + 1) * (S-1) * n_stale * 8 B.

#include "common.cuh"

namespace {

constexpr int kCepTile = 256;     // lanes per tile; ops/cuda.py CEP_TILE
constexpr int kCepMaxDim = 128;   // the largest D; ops/cuda.py CEP_MAX_DIM
constexpr int kCarryChunk = 1024; // pass 2's tile flags read at a time
constexpr float kIntMax = 2147483647.0f;  // device.py INT_MAX (2^31)

// v := T(e) v in place for one live lane; m the lane's S stage bits, keep
// the S-1 keep bits (keep[s] = relaxed[s + 1]).
__device__ __forceinline__ void cep_step(float* u, const uint8_t* __restrict__ m,
                                         const uint8_t* keep, int S, int Q,
                                         int D, int q_t) {
  const int kM = D - 2, kOne = D - 1;
  if (S == 1) {  // a single stage completes on its own event
    if (m[0]) u[kM] += u[kOne];
    return;
  }
  if (m[S - 1]) {
    float add = 0.0f;
    for (int q = 0; q < Q; ++q) add += u[(S - 2) * Q + q];
    u[kM] += add;
  }
  for (int s = S - 2; s >= 1; --s) {
    const bool k = keep[s], take = m[s] != 0;
    float* c = u + s * Q;
    const float* prev = u + (s - 1) * Q;
    for (int q = 0; q < Q; ++q) c[q] = (k ? c[q] : 0.0f) + (take ? prev[q] : 0.0f);
  }
  if (!keep[0]) {
    for (int q = 0; q < Q; ++q) u[q] = 0.0f;
  }
  if (m[0]) u[q_t] += u[kOne];
}

struct CepArgs {
  const int32_t* order;         // [B] sorted position -> original lane
  const long long* key_s;       // [B] sorted slot keys (C: no slot)
  const uint8_t* seg_start;     // [B]
  const uint8_t* masks;         // [B, S] stage bits, original lane order
  unsigned long long relaxed_lo, relaxed_hi;  // bit s: stage s relaxed
  int B, C, S, Q, D, q_t;
};

__device__ void load_keep(const CepArgs& a, uint8_t* keep) {
  for (int s = threadIdx.x; s < a.S - 1; s += blockDim.x) {
    const int b = s + 1;
    keep[s] = static_cast<uint8_t>((b < 64 ? a.relaxed_lo >> b : a.relaxed_hi >> (b - 64)) & 1ull);
  }
}

// The tile's last lane with a segment start, or -1.
__device__ int last_start_of(const CepArgs& a, int t0, int t1, int* shared_slot) {
  if (threadIdx.x == 0) *shared_slot = -1;
  __syncthreads();
  for (int i = t0 + threadIdx.x; i < t1; i += blockDim.x) {
    if (a.seg_start[i]) atomicMax(shared_slot, i);
  }
  __syncthreads();
  return *shared_slot;
}

__device__ __forceinline__ void walk(const CepArgs& a, const uint8_t* keep, float* u,
                                     int j0, int j1) {
  for (int j = j0; j < j1; ++j) {
    if (a.key_s[j] < a.C) {
      cep_step(u, a.masks + static_cast<size_t>(a.order[j]) * a.S, keep, a.S, a.Q,
               a.D, a.q_t);
    }
  }
}

__global__ void cep_tile_kernel(CepArgs a, const float* __restrict__ carry,
                                int32_t* __restrict__ reset, float* __restrict__ W,
                                float* __restrict__ Sv, float* __restrict__ A) {
  __shared__ uint8_t keep[kCepMaxDim];
  __shared__ int last;
  const int t = blockIdx.x;
  const int t0 = t * kCepTile, t1 = min(t0 + kCepTile, a.B);
  const int D = a.D;
  load_keep(a, keep);
  const int p = last_start_of(a, t0, t1, &last);  // syncs after keep too
  if (p >= 0) {
    if (threadIdx.x != 0) return;
    float u[kCepMaxDim];
    const float* row = carry + a.key_s[p] * D;
    for (int d = 0; d < D; ++d) {
      u[d] = row[d];
      Sv[static_cast<size_t>(t) * D + d] = u[d];
    }
    walk(a, keep, u, p, t1);
    for (int d = 0; d < D; ++d) W[static_cast<size_t>(t) * D + d] = u[d];
    reset[t] = 1;
    return;
  }
  for (int col = threadIdx.x; col < D; col += blockDim.x) {
    float u[kCepMaxDim];
    for (int d = 0; d < D; ++d) u[d] = d == col ? 1.0f : 0.0f;
    walk(a, keep, u, t0, t1);
    float* out = A + (static_cast<size_t>(t) * D + col) * D;  // column col
    for (int d = 0; d < D; ++d) out[d] = u[d];
  }
  if (threadIdx.x == 0) reset[t] = 0;
}

__global__ void cep_carry_kernel(const int32_t* __restrict__ reset, int n_tiles, int D,
                                 const float* __restrict__ A, float* __restrict__ W,
                                 float* __restrict__ carry_row_c) {
  __shared__ float w[kCepMaxDim];
  __shared__ int32_t flags[kCarryChunk];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    carry_row_c[d] = d == D - 1 ? 1.0f : 0.0f;
  }
  for (int c0 = 1; c0 < n_tiles; c0 += kCarryChunk) {
    const int c1 = min(c0 + kCarryChunk, n_tiles);
    __syncthreads();
    for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) flags[i - c0] = reset[i];
    __syncthreads();
    for (int t = c0; t < c1; ++t) {
      if (flags[t - c0]) continue;  // uniform across the block
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        w[d] = W[static_cast<size_t>(t - 1) * D + d];
      }
      __syncthreads();
      const float* At = A + static_cast<size_t>(t) * D * D;
      for (int r = threadIdx.x; r < D; r += blockDim.x) {
        float acc = 0.0f;
        for (int j = 0; j < D; ++j) acc = fmaf(At[static_cast<size_t>(j) * D + r], w[j], acc);
        W[static_cast<size_t>(t) * D + r] = acc;
      }
      __syncthreads();
    }
  }
}

__global__ void cep_apply_kernel(CepArgs a, float* __restrict__ carry,
                                 const float* __restrict__ W, const float* __restrict__ Sv,
                                 float* __restrict__ delta) {
  __shared__ uint8_t keep[kCepMaxDim];
  __shared__ int last;
  const int t = blockIdx.x;
  const int t0 = t * kCepTile, t1 = min(t0 + kCepTile, a.B);
  const int D = a.D;
  load_keep(a, keep);
  const int p = last_start_of(a, t0, t1, &last);
  const int i = t0 + threadIdx.x;
  if (i >= t1) return;
  const bool start = a.seg_start[i] != 0;
  if (!start && i != t0) return;
  const long long seg = a.key_s[i];
  const float* from = !start ? W + static_cast<size_t>(t - 1) * D
                     : (i == p ? Sv + static_cast<size_t>(t) * D : carry + seg * D);
  float u[kCepMaxDim];
  for (int d = 0; d < D; ++d) u[d] = from[d];
  const bool live = seg < a.C;
  float m_prev = fminf(u[D - 2], kIntMax);
  for (int j = i; j < t1; ++j) {
    if (j > i && a.seg_start[j]) break;
    const int lane = a.order[j];
    if (live) {
      cep_step(u, a.masks + static_cast<size_t>(lane) * a.S, keep, a.S, a.Q, D, a.q_t);
    }
    const float m = fminf(u[D - 2], kIntMax);
    delta[lane] = m - m_prev;
    m_prev = m;
    if (live && (j == a.B - 1 || a.seg_start[j + 1])) {
      float* row = carry + seg * D;
      for (int d = 0; d < D; ++d) row[d] = d == D - 2 ? 0.0f : fminf(u[d], kIntMax);
    }
  }
}

__global__ void cep_expire_kernel(float* __restrict__ carry, long long n, int D, int S,
                                  int Q, unsigned long long stale_lo,
                                  unsigned long long stale_hi) {
  const int n_cols = (S - 1) * Q;
  for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       k < n; k += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(k % D);
    if (col >= n_cols) continue;
    const int q = col % Q;
    const unsigned long long bit = q < 64 ? (stale_lo >> q) : (stale_hi >> (q - 64));
    if (bit & 1ull) carry[k] = 0.0f;
  }
}

}  // namespace

// G19. order int32 [B], key_s int64 [B], seg_start uint8 [B] from G10 on
// the slot key (C for a lane with no slot); masks uint8 [B, S] in lane
// order; the stages' relaxed flags as a 128-bit mask (S <= 127, since D <=
// kCepMaxDim); carry float32 [C+1, D], updated in place;
// delta float32 [B] (lane order). Scratch: reset int32 [n_tiles], W and Sv
// float32 [n_tiles, D], A float32 [n_tiles, D, D], n_tiles =
// ceil(B / kCepTile).
extern "C" int cep_scan(const void* order, const void* key_s, const void* seg_start,
                        const void* masks, unsigned long long relaxed_lo,
                        unsigned long long relaxed_hi, int B, int C, int S,
                        int Q, int D, int q_t, void* carry, void* delta, void* reset,
                        void* W, void* Sv, void* A, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* carry_f = static_cast<float*>(carry);
  const CepArgs a{static_cast<const int32_t*>(order),
                  static_cast<const long long*>(key_s),
                  static_cast<const uint8_t*>(seg_start),
                  static_cast<const uint8_t*>(masks),
                  relaxed_lo, relaxed_hi, B, C, S, Q, D, q_t};
  const int n_tiles = (B + kCepTile - 1) / kCepTile;
  float* Wf = static_cast<float*>(W);
  float* Svf = static_cast<float*>(Sv);
  if (n_tiles > 0) {
    cep_tile_kernel<<<n_tiles, 128, 0, s>>>(a, carry_f, static_cast<int32_t*>(reset),
                                            Wf, Svf, static_cast<float*>(A));
  }
  cep_carry_kernel<<<1, 128, 0, s>>>(static_cast<const int32_t*>(reset), n_tiles, D,
                                     static_cast<const float*>(A), Wf,
                                     carry_f + static_cast<size_t>(C) * D);
  if (n_tiles > 0) {
    cep_apply_kernel<<<n_tiles, kCepTile, 0, s>>>(a, carry_f, Wf, Svf,
                                                  static_cast<float*>(delta));
  }
  return static_cast<int>(cudaGetLastError());
}

// G20. carry float32 [C+1, D] in place; the stale ring slots as a 128-bit
// mask (Q <= 126, since D <= kCepMaxDim).
extern "C" int cep_expire(void* carry, long long rows, int D, int S, int Q,
                          unsigned long long stale_lo, unsigned long long stale_hi,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = rows * D;
  if (n > 0) {
    const long long want = (n + 255) / 256;
    const long long blocks = want < 132LL * 32 ? want : 132LL * 32;
    cep_expire_kernel<<<static_cast<int>(blocks), 256, 0, s>>>(
        static_cast<float*>(carry), n, D, S, Q, stale_lo, stale_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
