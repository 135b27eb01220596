// G17 kg_occupancy — live keys per key group of one shard's window state.
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// kg_occupancy (kernel K11) and its step wrapper runtime/step.py
// build_kg_occupancy_step: a slot is alive when any of its R pane cells is
// touched or fresh (a pending re-fire), and the result bincounts the key
// group (route_hash, murmur3_32, mod maxp: common.cuh key_group, the hash
// G1 routes with) of every alive slot's key into an int32 [maxp] vector.
// The table's int64 key words hold the identity rows (0, slot) in the
// direct layout and the keys in the hash layout, so one kernel serves both;
// an empty hash slot is never touched, so it is never alive.
//
// Where the touch lives: the packed plane's last column against the
// reduce's neutral (acc [C*R, Wc] float32, the test G9's alive pass makes),
// or the split planes' ``touched`` bool [C*R]; with allowed lateness also
// the ``fresh`` bool [C*R] plane. All planes are pane-major: cell (r, s) at
// r * C + s.
//
// Bound: bytes. Per slot it reads its key (8 B) and R touch cells (4 B
// each in a packed plane — the marker column; 1 B in a split plane), plus
// R fresh flags with lateness, and writes 4 maxp bytes in all: about 40 MB
// (12 us at 3.35 TB/s) at the north-star job's C = 1M, R = 8. In a packed
// plane the marker column is strided by the row's Wc floats, so the sectors
// fetched also carry the value columns: twice the bound's touch bytes at
// Wc = 2.
//
// Design: one thread a slot, so neighbouring threads read neighbouring
// keys and, for each pane row r, neighbouring cells of that row — the
// pane-major order keeps each row's reads for a warp within a few sectors.
// A thread stops reading rows at its first touched cell. Alive slots count
// into a block histogram in shared memory that is flushed with one global
// atomic a non-zero bin (common.cuh kg_hist_*), with the grid-stride loop
// and the opt-in shared memory G1's fill uses; the result is zeroed by the
// caller. It only reads the state.

#include "common.cuh"

namespace {

__global__ void kg_occupancy_kernel(
    const long long* __restrict__ keys, int C, int R,
    const float* __restrict__ acc, int Wc, float neutral,
    const uint8_t* __restrict__ touched, const uint8_t* __restrict__ fresh,
    int maxp, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  kg_hist_zero(hist, maxp);
  const int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < C; s += stride) {
    bool alive = false;
    for (int r = 0; r < R && !alive; ++r) {
      const long long cell = static_cast<long long>(r) * C + s;
      alive = acc != nullptr ? acc[cell * Wc + (Wc - 1)] != neutral
                             : touched[cell] != 0;
      if (!alive && fresh != nullptr) alive = fresh[cell] != 0;
    }
    if (alive) {
      const unsigned long long w = static_cast<unsigned long long>(keys[s]);
      const int32_t g = key_group(static_cast<uint32_t>(w >> 32),
                                  static_cast<uint32_t>(w), maxp);
      atomicAdd(&hist[g], 1);
    }
  }
  kg_hist_flush(hist, maxp, out);
}

}  // namespace

// Exactly one of ``acc`` (packed plane, touch column against ``neutral``)
// and ``touched`` (split planes) is given; ``fresh`` may be null.
extern "C" int kg_occupancy(const void* keys, int C, int R, const void* acc,
                            int Wc, float neutral, const void* touched,
                            const void* fresh, int maxp, void* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = kg_hist_smem(kg_occupancy_kernel, maxp);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = 256;
  const int blocks = kg_hist_blocks(C, maxp, threads);
  kg_occupancy_kernel<<<blocks, threads, maxp * sizeof(int32_t), st>>>(
      static_cast<const long long*>(keys), C, R,
      static_cast<const float*>(acc), Wc, neutral,
      static_cast<const uint8_t*>(touched),
      static_cast<const uint8_t*>(fresh), maxp,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
