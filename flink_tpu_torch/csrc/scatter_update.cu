// G3 scatter_update — accumulate one micro-batch into the packed pane plane
// of the state backend: one launch a call, a grid sized to the card, four
// lanes a thread.
//
// Replaces (flink_tpu, the JAX reference): the accumulate phase of
// ops/window_kernels.py update (window_kernels.py:735-916) with packed
// planes — the too-old drop against the new max_pane, the changelog bits
// kg_dirty, and the scatter of the value columns and the touch marker at
// the lane's slot, for the builtin reduces sum and count (add), min and
// max (:850-915; ops/segment.py scatter_combine, :150, kernel K3, on float
// state) — and the allowed-lateness `fresh` marking (:936-945): a lane
// that lands in a pane at or before fired_through sets the cell's fresh
// flag and adds one to n_fresh, so the windows holding it re-fire. The
// slot comes in as an operand: in the direct layout where(hi == 0 and
// lo < C, lo, C), in the hash layout what G5 hash_upsert placed or G8
// hash_lookup found. A live lane with slot C has no slot ("nofit"): with
// the overflow ring on, G7 ring_append has already taken it to the ring
// and it is skipped here (count_nofit = 0); without the ring it counts
// into dropped_capacity. On this path it also carries the role of
// ops/segment.py segment_sort / reduce_sorted (kernel K3): the reference
// sorts the batch by accumulator index and pre-combines duplicates because
// duplicate scatter indices serialize on a TPU.
//
// Plane: acc [C*R, W+1] float32, pane-major; columns 0..W-1 hold the
// value (W = 1 for a scalar, 2 for mean's [sum, count]), column W the
// touch marker. Its neutral (the reduce's: 0 for add, +FLT_MAX for min,
// -FLT_MAX for max) means untouched; add scatters 1.0 into it, min and max
// scatter 0.0, which min/max-combines with the neutral to 0.0 and stays.
//
// Bound: bytes. Per lane it reads pane, kg, slot (4 B each), live (1 B)
// and W values (4 B each); each touched cell of the plane is read and
// written once ((W+1) x 4 B each way). A 262,144-lane north-star batch
// moves about 8.6 MB, 2.6 us at 3.35 TB/s. In practice the scattered
// updates land in random 32-byte sectors, so the plane traffic is
// sector-bound, not byte-bound, and each update is one operation of the
// L2's atomic units.
//
// Design: no sort. Hopper's L2 atomic units resolve duplicate addresses in
// hardware. The grid is a few blocks a multiprocessor (kBlocksPerSM, fewer
// for a small batch); each thread walks a grid-stride loop over groups of 4
// lanes with 16-byte loads of pane, kg and slot, a 4-byte load of live and
// the group's 4 W values as W 16-byte loads, so its four updates issue
// back to back. A batch whose length is not a multiple of 4 takes its tail
// a lane a thread, and a call with any lane pointer off that alignment
// takes every lane that way, in the same kernel. Add is one vector
// reduction a lane over the values and the touch marker where the cell's
// alignment allows (Hopper's red.global.add.v2 / v4.f32, CUDA's
// atomicAdd(float2 *) / (float4 *)): W = 1 one v2 on its 8-byte cell, W = 3
// one v4 on its 16-byte cell, W = 2 a v2 and a scalar split by the
// 12-byte cell's 8-byte phase; any other W, or a plane off that alignment,
// a scalar atomic a column. Count (values null) adds 1 to every column.
// Min and max read the lane's cell once (one 8- or 16-byte load for W = 1
// or 3), then loop on a 32-bit atomicCAS a value column from the word read
// (common.cuh atomic_combine) with the reference's NaN and signed-zero
// order, leaving at once when the cell already holds the result, so a hot
// key's repeated lanes mostly cost one load; their touch marker is a plain
// store of 0.0 (every writer stores the same word), made only where the
// marker read is not 0.0 already: on the H100 an unconditional store
// there cost more than the rest of the lane. The resulting plane equals
// the reference's with precombine on and off: exactly for min and max, up
// to float summation order for add, which is exact for integer-valued
// data. kg_dirty is a byte flag, stored only where it still reads 0 (max
// parallelism is 128, so without the read nearly every lane would store to
// the same few bytes), and marked for a thread's four lanes after their
// combines; its races are benign, every writer stores 1. fresh
// flags race the same benign way. Dropped and fresh lanes count by a warp
// reduction and land with one atomic a warp, only where the count is not
// zero: no barrier in the kernel.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;

struct UpdateArgs {
  float* acc;
  int W, op;
  uint8_t* kg_dirty;
  int32_t* dropped_capacity;
  const int32_t* pane;
  const int32_t* kg;
  const uint8_t* live;
  const int32_t* slot;
  const float* values;
  const int32_t* max_pane;
  int B, C, R, count_nofit;
  uint8_t* fresh;
  const int32_t* fired_through;
  int32_t* n_fresh;
  bool vec;    // every lane pointer aligned for the 4-lane loads
  bool cells;  // the plane aligned for the vector reductions
};

// Add a lane's values v (KW of them; KW = 0: W read from vp, or 1.0 each
// when vp is null) and the marker 1.0 into its cell.
template <int KW>
__device__ __forceinline__ void add_cell(float* cell, size_t flat,
                                         const float* v, const float* vp,
                                         int W, bool cells) {
  if (KW == 1 && cells) {
    atomicAdd(reinterpret_cast<float2*>(cell), make_float2(v[0], 1.0f));
  } else if (KW == 3 && cells) {
    atomicAdd(reinterpret_cast<float4*>(cell),
              make_float4(v[0], v[1], v[2], 1.0f));
  } else if (KW == 2 && cells) {
    // a 12-byte cell: an even cell starts 8-byte aligned, an odd one at
    // its second word
    if ((flat & 1) == 0) {
      atomicAdd(reinterpret_cast<float2*>(cell), make_float2(v[0], v[1]));
      atomicAdd(cell + 2, 1.0f);
    } else {
      atomicAdd(cell, v[0]);
      atomicAdd(reinterpret_cast<float2*>(cell + 1), make_float2(v[1], 1.0f));
    }
  } else if (KW > 0) {
#pragma unroll
    for (int w = 0; w < KW; ++w) atomicAdd(cell + w, v[w]);
    atomicAdd(cell + KW, 1.0f);
  } else {
    for (int w = 0; w < W; ++w) atomicAdd(cell + w, vp ? vp[w] : 1.0f);
    atomicAdd(cell + W, 1.0f);
  }
}

// Min or max of a lane's values into its cell: the cell read once (one 8-
// or 16-byte load for W = 1 or 3 where aligned, else a word at a time),
// each value column combined from its word, and the touch marker stored
// only where it is not already 0.0 (a touched cell's, which the combine
// would leave as it is).
template <int KW>
__device__ __forceinline__ void minmax_cell(float* cell, const float* v,
                                            const float* vp, int W, int op,
                                            bool cells) {
  if constexpr (KW == 0) {
    for (int w = 0; w < W; ++w) {
      atomic_combine(cell + w, vp ? vp[w] : 1.0f, op);
    }
    if (__float_as_uint(__ldcg(cell + W)) != 0u) cell[W] = 0.0f;
  } else {
    unsigned int cur[KW + 1];
    bool read = false;
    if constexpr (KW == 1) {
      if (cells) {
        const uint2 x = __ldcg(reinterpret_cast<const uint2*>(cell));
        cur[0] = x.x;
        cur[1] = x.y;
        read = true;
      }
    } else if constexpr (KW == 3) {
      if (cells) {
        const uint4 x = __ldcg(reinterpret_cast<const uint4*>(cell));
        cur[0] = x.x;
        cur[1] = x.y;
        cur[2] = x.z;
        cur[3] = x.w;
        read = true;
      }
    }
    if (!read) {
#pragma unroll
      for (int w = 0; w <= KW; ++w) {
        cur[w] = __ldcg(reinterpret_cast<const unsigned int*>(cell) + w);
      }
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) combine_from(cell + w, cur[w], v[w], op);
    if (cur[KW] != 0u) cell[KW] = 0.0f;  // touch marker
  }
}

template <int KW>
struct Update {
  const UpdateArgs& a;
  int32_t oldest;     // the ring horizon (:736)
  int32_t oldest_row; // oldest's ring row
  int32_t fired;
  int32_t dropped, marked;
  // the key group of each lane of a group that sets kg_dirty (-1: none),
  // marked after the group's combines
  int32_t dirty[4];

  // Lane j of a group. v: its KW values (1.0 for count); vp: its W values
  // in memory, read when KW is 0.
  __device__ __forceinline__ void operator()(int j, int32_t p, int32_t g,
                                             bool lv, int32_t s,
                                             const float* v,
                                             const float* vp) {
    dirty[j] = -1;
    if (!lv) return;
    if (p < oldest) {
      ++dropped;  // too old
      return;
    }
    dirty[j] = g;
    if (static_cast<uint32_t>(s) >= static_cast<uint32_t>(a.C)) {
      dropped += a.count_nofit;  // nofit: no slot, and no overflow ring
      return;
    }
    // the ring row p mod R, from oldest's row when p is within R of it
    const long long d = static_cast<long long>(p) - oldest;
    int32_t row;
    if (d < a.R) {
      row = oldest_row + static_cast<int32_t>(d);
      row -= row >= a.R ? a.R : 0;
    } else {
      row = floor_mod(p, a.R);
    }
    const size_t flat = static_cast<size_t>(row) * a.C + s;  // pane-major
    float* cell = a.acc + flat * (a.W + 1);
    if (a.op == 0) {
      add_cell<KW>(cell, flat, v, vp, a.W, a.cells);
    } else {
      minmax_cell<KW>(cell, v, vp, a.W, a.op, a.cells);
    }
    if (a.fresh != nullptr && p <= fired) {
      a.fresh[flat] = 1;  // a late lane of an already fired window
      ++marked;
    }
  }

  // kg_dirty for the group's first N lanes, after their combines (the
  // flag bytes may alias the plane for the compiler, so a read before a
  // lane's reductions would hold them back by its round trip). A set-only
  // flag, read first, so the lanes of a key group after its first do not
  // all store to the same byte.
  template <int N>
  __device__ __forceinline__ void mark_dirty() {
    if (a.kg_dirty == nullptr) return;
    uint8_t f[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      f[j] = dirty[j] >= 0 ? a.kg_dirty[dirty[j]] : 1;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (f[j] == 0) a.kg_dirty[dirty[j]] = 1;
    }
  }
};

template <int KW>
__global__ void __launch_bounds__(kThreads)
    scatter_update_kernel(const UpdateArgs a) {
  const int32_t oldest = *a.max_pane - (a.R - 1);
  Update<KW> up{a, oldest, floor_mod(oldest, a.R),
                a.fresh != nullptr ? *a.fired_through : 0, 0, 0};
  constexpr int NV = KW > 0 ? KW : 1;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int tail = 0;
  if (a.vec) {
    const int groups = a.B >> 2;
    for (int gi = first; gi < groups; gi += stride) {
      const uint32_t lv = reinterpret_cast<const uint32_t*>(a.live)[gi];
      const int4 p = reinterpret_cast<const int4*>(a.pane)[gi];
      const int4 s = reinterpret_cast<const int4*>(a.slot)[gi];
      const int4 g = a.kg_dirty != nullptr
                         ? reinterpret_cast<const int4*>(a.kg)[gi]
                         : make_int4(0, 0, 0, 0);
      // the group's 4 x KW values, lane-major
      float v[4 * NV];
      const float* vp[4] = {nullptr, nullptr, nullptr, nullptr};
      if (KW > 0 && a.values != nullptr) {
        const float4* v4 = reinterpret_cast<const float4*>(a.values) +
                           static_cast<size_t>(gi) * NV;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 x = v4[j];
          v[4 * j] = x.x;
          v[4 * j + 1] = x.y;
          v[4 * j + 2] = x.z;
          v[4 * j + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4 * NV; ++j) v[j] = 1.0f;
        if (KW == 0 && a.values != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            vp[j] = a.values + (4 * static_cast<size_t>(gi) + j) * a.W;
          }
        }
      }
      up(0, p.x, g.x, lv & 0xffu, s.x, v, vp[0]);
      up(1, p.y, g.y, (lv >> 8) & 0xffu, s.y, v + NV, vp[1]);
      up(2, p.z, g.z, (lv >> 16) & 0xffu, s.z, v + 2 * NV, vp[2]);
      up(3, p.w, g.w, lv >> 24, s.w, v + 3 * NV, vp[3]);
      up.template mark_dirty<4>();
    }
    tail = groups << 2;
  }
  for (int i = tail + first; i < a.B; i += stride) {
    if (!a.live[i]) continue;
    float v[NV];
    const float* vp = nullptr;
    if (a.values != nullptr) {
      vp = a.values + static_cast<size_t>(i) * a.W;
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = KW > 0 ? vp[j] : 1.0f;
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = 1.0f;
    }
    up(0, a.pane[i], a.kg_dirty != nullptr ? a.kg[i] : 0, true, a.slot[i],
       v, vp);
    up.template mark_dirty<1>();
  }
  // one atomic a warp, only for a count that is not zero
  const int32_t dropped = __reduce_add_sync(0xffffffffu, up.dropped);
  if ((threadIdx.x & 31) == 0 && dropped) {
    atomicAdd(a.dropped_capacity, dropped);
  }
  if (a.fresh != nullptr) {  // uniform per launch
    const int32_t marked = __reduce_add_sync(0xffffffffu, up.marked);
    if ((threadIdx.x & 31) == 0 && marked) atomicAdd(a.n_fresh, marked);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

extern "C" int scatter_update(void* acc, int W, int op, void* kg_dirty,
                              void* dropped_capacity, const void* pane,
                              const void* kg, const void* live,
                              const void* slot, const void* values,
                              const void* max_pane, int B, int C, int R,
                              int count_nofit, void* fresh,
                              const void* fired_through, void* n_fresh,
                              void* stream) {
  if (W < 1 || op < 0 || op > 2 || B < 0 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  UpdateArgs a;
  a.acc = static_cast<float*>(acc);
  a.W = W;
  a.op = op;
  a.kg_dirty = static_cast<uint8_t*>(kg_dirty);
  a.dropped_capacity = static_cast<int32_t*>(dropped_capacity);
  a.pane = static_cast<const int32_t*>(pane);
  a.kg = static_cast<const int32_t*>(kg);
  a.live = static_cast<const uint8_t*>(live);
  a.slot = static_cast<const int32_t*>(slot);
  a.values = static_cast<const float*>(values);
  a.max_pane = static_cast<const int32_t*>(max_pane);
  a.B = B;
  a.C = C;
  a.R = R;
  a.count_nofit = count_nofit;
  a.fresh = static_cast<uint8_t*>(fresh);
  a.fired_through = static_cast<const int32_t*>(fired_through);
  a.n_fresh = static_cast<int32_t*>(n_fresh);
  a.vec = aligned(pane, 16) && aligned(kg, 16) && aligned(slot, 16) &&
          aligned(live, 4) && (values == nullptr || aligned(values, 16));
  a.cells = aligned(acc, W == 3 ? 16 : 8);
  // a group of 4 lanes a thread
  const long long items = (static_cast<long long>(B) + 3) / 4;
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSM;
  blocks = blocks < cap ? blocks : cap;
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned n = static_cast<unsigned>(blocks);
    switch (W) {
      case 1:
        scatter_update_kernel<1><<<n, kThreads, 0, s>>>(a);
        break;
      case 2:
        scatter_update_kernel<2><<<n, kThreads, 0, s>>>(a);
        break;
      case 3:
        scatter_update_kernel<3><<<n, kThreads, 0, s>>>(a);
        break;
      default:
        scatter_update_kernel<0><<<n, kThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
