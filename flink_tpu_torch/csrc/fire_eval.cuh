// What G4 fire_reduced and G6 fire_compact evaluate for one (fire lane,
// slot): whether the slot is emitted and its window value.
//
// PlaneSrc<kW, kOp> reads the packed pane plane [R*C, W+1] of a builtin
// reduce
// (ops/window_kernels.py _eval_fire_lanes, :1203): the window ending at
// pane p combines panes q = p-k+1 .. p; pane q lives in ring row q mod R
// and counts where pane_ids[row] == q and the row's touch column differs
// from the neutral. The value starts at the neutral and combines every
// counting pane in pane order (add, min or max, common.cuh combine_op).
// The emission mask is the touch column for an on-time lane (f <
// n_ontime) and the fresh plane for a re-fire lane, the allowed-lateness
// pass of advance_and_fire (:1340-1390): a re-fire emits only the slots a
// late record reached, with their corrected full value. kW is the number
// of value columns when known at compile time (1: a scalar, its cell one
// float2 load; 2: mean's [sum, count]), 0 for a runtime W <= kMaxW; kOp
// the combine (0 add, 1 min, 2 max). ``with_plane`` picks them from the
// runtime arguments.
//
// DenseSrc<kW> reads a dense fire result computed elsewhere: mask [F, C]
// bytes and values [F, C, W] (the generic reduce's fire, whose combine is
// the user's torch function), for the compaction alone.
//
// eval_rounds (G6's single pass, G4's path for an odd C or an unaligned
// plane) evaluates one thread's slots of a tile:
// kRounds rounds of kSpt neighbouring slots, c0 + r * step + s, with the
// pane loop outside the rounds so that a thread keeps kRounds loads in
// flight. kSpt = 2 reads a W = 1 plane's two cells as one float4 (C even,
// the plane 16-byte aligned); a dense source's kSpt = 4 reads four mask
// bytes as one word and, where one of them is set, four W = 1 values as
// one float4 (C a multiple of 4, both aligned). Slots at or past C emit
// nothing.

#pragma once

#include "common.cuh"

constexpr int kMaxPanes = 64;  // k <= ring - 1; the wrappers enforce it
constexpr int kMaxW = 16;      // value columns of a packed plane

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

// A packed plane's fire arguments (the kernels' runtime view of it).
struct PlaneArgs {
  const float* acc;         // [R*C, W+1]
  const uint8_t* fresh;     // [R*C], or null: no re-fire lanes
  const int32_t* pane_ids;  // [R]
  const int32_t* p_f;       // [F] window-end pane per lane
  int n_ontime;             // lanes f >= n_ontime emit by the fresh plane
  int W_rt;                 // W when kWidth == 0
  float neutral;
  int C, R, k;
};

template <int kW, int kOp>
struct PlaneSrc : PlaneArgs {
  static constexpr int kWidth = kW;

  __device__ __forceinline__ int W() const { return kW ? kW : W_rt; }

  // every thread of the block calls it (it syncs)
  __device__ __forceinline__ void prepare(int f, int32_t* rows) const {
    window_rows(pane_ids, p_f[f], R, k, rows);
  }

  template <int kSpt, int kRounds, int kNV>
  __device__ __forceinline__ void eval_rounds(
      int f, const int32_t* rows, int c0, int step,
      float (&v)[kRounds][kSpt][kNV], unsigned (&bits)[kRounds]) const {
    static_assert(kSpt == 1 || (kSpt == 2 && kW == 1), "float4 cells: W = 1");
    const int nw = W();
    const bool late = fresh != nullptr && f >= n_ontime;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      bits[r] = 0u;
#pragma unroll
      for (int s = 0; s < kSpt; ++s) {
#pragma unroll
        for (int w = 0; w < kNV; ++w) v[r][s][w] = neutral;
      }
    }
    for (int j = 0; j < k; ++j) {
      const int32_t row = rows[j];
      if (row < 0) continue;
      const size_t base = static_cast<size_t>(row) * C;
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int c = c0 + r * step;
        if (c >= C) continue;
        const size_t cell = base + c;
        if constexpr (kSpt == 2) {
          const float4 a = *reinterpret_cast<const float4*>(acc + cell * 2);
          if (a.y != neutral) v[r][0][0] = combine_op(kOp, v[r][0][0], a.x);
          if (a.w != neutral) v[r][1][0] = combine_op(kOp, v[r][1][0], a.z);
          if (late) {
            const uchar2 fr = *reinterpret_cast<const uchar2*>(fresh + cell);
            bits[r] |= (fr.x != 0 ? 1u : 0u) | (fr.y != 0 ? 2u : 0u);
          } else {
            bits[r] |= (a.y != neutral ? 1u : 0u) | (a.w != neutral ? 2u : 0u);
          }
        } else if constexpr (kW == 1) {
          const float2 a = reinterpret_cast<const float2*>(acc)[cell];
          if (a.y != neutral) v[r][0][0] = combine_op(kOp, v[r][0][0], a.x);
          bits[r] |= (late ? fresh[cell] != 0 : a.y != neutral) ? 1u : 0u;
        } else {
          const float* a = acc + cell * (nw + 1);
          const float t = a[nw];
          if (t != neutral) {
#pragma unroll
            for (int w = 0; w < kNV; ++w) {
              if (w < nw) v[r][0][w] = combine_op(kOp, v[r][0][w], a[w]);
            }
          }
          bits[r] |= (late ? fresh[cell] != 0 : t != neutral) ? 1u : 0u;
        }
      }
    }
  }
};

template <int kW, class Fn>
void with_op(const PlaneArgs& a, int op, Fn& fn) {
  if (op == 0) {
    fn(PlaneSrc<kW, 0>{a});
  } else if (op == 1) {
    fn(PlaneSrc<kW, 1>{a});
  } else {
    fn(PlaneSrc<kW, 2>{a});
  }
}

// fn(PlaneSrc<kW, kOp>) with the width and the combine fixed at compile
// time (W = 1, 2 or any up to kMaxW; op 0 add, 1 min, 2 max): the inner
// loop carries no branch on either.
template <class Fn>
void with_plane(const PlaneArgs& a, int op, Fn fn) {
  if (a.W_rt == 1) {
    with_op<1>(a, op, fn);
  } else if (a.W_rt == 2) {
    with_op<2>(a, op, fn);
  } else {
    with_op<0>(a, op, fn);
  }
}

template <int kW>
struct DenseSrc {
  static constexpr int kWidth = kW;
  const uint8_t* mask;   // [F, C]
  const float* values;   // [F, C, W]
  int W_rt;
  int C;

  __device__ __forceinline__ int W() const { return kW ? kW : W_rt; }
  __device__ __forceinline__ void prepare(int, int32_t*) const {}

  template <int kSpt, int kRounds, int kNV>
  __device__ __forceinline__ void eval_rounds(
      int f, const int32_t*, int c0, int step,
      float (&v)[kRounds][kSpt][kNV], unsigned (&bits)[kRounds]) const {
    static_assert(kSpt == 1 || (kSpt == 4 && kW == 1), "float4 values: W = 1");
    const int nw = W();
    const size_t lane = static_cast<size_t>(f) * C;
    // the mask words of every round first, then the values they select
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int c = c0 + r * step;
      bits[r] = 0u;
      if (c >= C) continue;
      if constexpr (kSpt == 4) {
        const uchar4 m = *reinterpret_cast<const uchar4*>(mask + lane + c);
        bits[r] = (m.x ? 1u : 0u) | (m.y ? 2u : 0u) | (m.z ? 4u : 0u) |
                  (m.w ? 8u : 0u);
      } else {
        bits[r] = mask[lane + c] ? 1u : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const size_t at = lane + c0 + r * step;
      if constexpr (kSpt == 4) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (bits[r]) q = *reinterpret_cast<const float4*>(values + at);
        v[r][0][0] = q.x;
        v[r][1][0] = q.y;
        v[r][2][0] = q.z;
        v[r][3][0] = q.w;
      } else {
#pragma unroll
        for (int w = 0; w < kNV; ++w) v[r][0][w] = 0.f;
        if (bits[r]) {
#pragma unroll
          for (int w = 0; w < kNV; ++w) {
            if (w < nw) v[r][0][w] = values[at * nw + w];
          }
        }
      }
    }
  }
};
