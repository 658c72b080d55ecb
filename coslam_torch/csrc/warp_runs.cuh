// Runs of equal keys across the lanes of one warp, and their sums: the
// merge that kernels P (probe_accum.cu, F with its clip rule) and U
// (tensovm_encode.cu, the tri-plane's table gradient) make before their
// atomics. Lane l holds one update, keyed by the row it adds to (a
// negative key: no update). The lanes whose key equals the previous
// lane's continue its run; one ballot tells whether the warp holds a run
// at all. Where it does, each run is summed by a segmented log-step
// shuffle sum (Hillis-Steele, toward the run's first lane), and only the
// run's first lane adds: one row of atomics a run where every lane added
// one. Same-address atomics from one warp instruction are serialised in
// L2, so the samples of one ray that share a coarse cell cost one atomic
// where they cost up to 32.

#pragma once

#include <cuda_runtime.h>

namespace warp_runs {

constexpr unsigned kFull = 0xffffffffu;

// Warp-collective (all 32 lanes call it with their key).
struct Run {
  bool adds;    // the lane holds an update and heads its run
  int end;      // the last lane of the lane's run
  int longest;  // the longest run of the warp (1: no run)

  __device__ __forceinline__ explicit Run(int key) {
    const int lane = threadIdx.x & 31;
    const int prev = __shfl_up_sync(kFull, key, 1);
    const bool joins = lane > 0 && key >= 0 && key == prev;
    const unsigned links = __ballot_sync(kFull, joins);
    adds = key >= 0 && !joins;
    end = lane;
    longest = 1;
    if (links != 0) {
      // Heads above this lane; the next one ends its run. For lane 31
      // the shift leaves 0, so no lane lies above.
      const unsigned above = ~links & ~((2u << lane) - 1u);
      end = above != 0 ? __ffs(above) - 2 : 31;
      longest = static_cast<int>(__reduce_max_sync(
          kFull, static_cast<unsigned>(end - lane + 1)));
    }
  }

  // v[0:N] of every lane <- the sum of v over lanes [lane, end]; the run's
  // first lane then holds its run's total. Warp-collective.
  template <int N>
  __device__ __forceinline__ void sum(float v[N]) const {
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < longest; d <<= 1) {
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
