// Runs of equal keys across the lanes of one warp, and their sums: the
// merge that kernels P (probe_accum.cu, F with its clip rule) and U
// (tensovm_encode.cu, the tri-plane's table gradient) make before their
// atomics. An update is held by kLanes adjacent lanes (1 for U and for P's
// vector forms, one lane a column of the row for P's scalar form), all with
// the same key, the row it adds to (a negative key: no update). The
// updates whose key equals the previous update's (kLanes lanes down)
// continue its run; one ballot tells whether the warp holds a run at all.
// Where it does, each run is summed by a segmented log-step shuffle sum
// (Hillis-Steele, toward the run's first update, kLanes lanes a step), and
// only the run's first update adds: one row of atomics a run where every
// update added one. Same-address atomics from one warp instruction are
// serialised in L2, so the samples of one ray that share a coarse cell
// cost one atomic where they cost up to 32.

#pragma once

#include <cuda_runtime.h>

namespace warp_runs {

constexpr unsigned kFull = 0xffffffffu;

// Warp-collective (all 32 lanes call it with their key); kLanes divides
// 32, and the kLanes lanes of an update hold the same key.
template <int kLanes = 1>
struct Run {
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0,
                "an update's lanes must tile the warp");
  // Bits 0, kLanes, 2 kLanes, ...: the first lane of every update.
  static constexpr unsigned kFirstLanes =
      kLanes == 32 ? 1u : kFull / ((1u << kLanes) - 1u);

  bool adds;    // the lane holds an update that heads its run
  int end;      // the lane's column in the last update of its run
  int longest;  // the longest run of the warp in updates (1: no run)

  __device__ __forceinline__ explicit Run(int key) {
    const int lane = threadIdx.x & 31;
    const int prev = __shfl_up_sync(kFull, key, kLanes);
    const bool joins = lane >= kLanes && key >= 0 && key == prev;
    const unsigned links = __ballot_sync(kFull, joins);
    adds = key >= 0 && !joins;
    end = lane;
    longest = 1;
    if (links != 0) {
      // Heads in the lane's column above it; the next one ends its run.
      // For lane 31 the shift leaves 0, so no lane lies above.
      const int column = lane % kLanes;
      const unsigned above =
          ~links & (kFirstLanes << column) & ~((2u << lane) - 1u);
      end = above != 0 ? __ffs(above) - 1 - kLanes : 32 - kLanes + column;
      longest = static_cast<int>(__reduce_max_sync(
          kFull, static_cast<unsigned>((end - lane) / kLanes + 1)));
    }
  }

  // v[0:N] of every lane <- the sum of v over the lane's column of the
  // updates from its own to its run's last; the run's first update then
  // holds its run's total. Warp-collective.
  template <int N>
  __device__ __forceinline__ void sum(float v[N]) const {
    const int lane = threadIdx.x & 31;
    for (int d = kLanes; d < longest * kLanes; d <<= 1) {
      const bool take = lane + d <= end;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float t = __shfl_down_sync(kFull, v[k], d);
        if (take) v[k] += t;
      }
    }
  }
};

}  // namespace warp_runs
