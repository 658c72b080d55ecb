// Runs of equal keys across the lanes of one warp, and their sums: the
// merge that kernels P (probe_accum.cu, F with its clip rule, Q with its
// packed bf16 values), R (probe_accum.cu, pairs of rows) and U
// (tensovm_encode.cu, the tri-plane's table gradient) make before their
// atomics. An update is held by kLanes adjacent lanes (1 for U, R and for
// P's vector forms, one lane a column of the row for P's scalar form), all
// with the same keys, the rows it adds to (a negative key: no row). An
// update holds one row, or two (R: a pair whose rows differ), and the
// rows lie in the warp's order first_0, last_0, first_1, last_1, ...
// An update's first row continues the run of the previous update's last
// row (kLanes lanes down) where their keys are equal; a run goes on past
// an update only where that update holds one row. One ballot tells
// whether the warp holds a run at all. Where it does, each run is summed
// by a segmented log-step shuffle sum (Hillis-Steele, toward the run's
// first update, kLanes lanes a step), and only the run's head adds: one
// row of atomics a run where every row added one. Same-address atomics
// from one warp instruction are serialised in L2, so the samples of one
// ray that share a coarse cell cost one atomic where they cost up to 32.

#pragma once

#include <cuda_runtime.h>

namespace warp_runs {

constexpr unsigned kFull = 0xffffffffu;

// Warp-collective (all 32 lanes construct it with their keys); kLanes
// divides 32, and the kLanes lanes of an update hold the same keys.
template <int kLanes = 1>
struct Run {
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0,
                "an update's lanes must tile the warp");
  // Bits 0, kLanes, 2 kLanes, ...: the first lane of every update.
  static constexpr unsigned kFirstLanes =
      kLanes == 32 ? 1u : kFull / ((1u << kLanes) - 1u);

  bool adds;        // the lane's (first) row heads its run
  bool adds_last;   // the lane holds a second row, which heads its run
  unsigned joined;  // lanes whose first row continues the previous update's
  int end;          // the lane's column in the last update its sum covers
  int longest;      // the longest such stretch of the warp in updates

  // One row an update: Run(key, key).
  __device__ __forceinline__ explicit Run(int key) {
    const int lane = threadIdx.x & 31;
    const int prev = __shfl_up_sync(kFull, key, kLanes);
    const bool joins = lane >= kLanes && key >= 0 && key == prev;
    joined = __ballot_sync(kFull, joins);
    adds = key >= 0 && !joins;
    adds_last = false;
    segments(joined);
  }

  // One or two rows an update: `first` and `last` differ only where the
  // update holds two rows (both >= 0); else both are its one row's key
  // (negative: no row).
  __device__ __forceinline__ Run(int first, int last) {
    const int lane = threadIdx.x & 31;
    const int prev = __shfl_up_sync(kFull, last, kLanes);
    const bool joins = lane >= kLanes && first >= 0 && first == prev;
    joined = __ballot_sync(kFull, joins);
    const unsigned twos = __ballot_sync(kFull, first != last);
    adds = first >= 0 && !joins;
    adds_last = first != last;
    // A first row's value goes on into the previous update's sum only
    // through an update of one row.
    segments(kLanes == 32 ? joined : joined & ~(twos << (kLanes & 31)));
  }

  // v[0:N] of every lane <- the sum of v (the updates' first rows) over
  // the lane's column of the updates from its own to `end`: the head of a
  // run of one-row updates then holds its run's total. Warp-collective.
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

  // After sum(summed): v_last[0:N] += the rest of the run that the lane's
  // last row heads (the next update's sum, where its first row continues
  // the lane's last). Warp-collective; only a lane with adds_last reads
  // v_last.
  template <int N>
  __device__ __forceinline__ void add_next(const float summed[N],
                                           float v_last[N]) const {
    if (joined == 0) return;  // the same for the whole warp
    const int lane = threadIdx.x & 31;
    const bool take =
        lane + kLanes < 32 && ((joined >> (lane + kLanes)) & 1u) != 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float t = __shfl_down_sync(kFull, summed[k], kLanes);
      if (take) v_last[k] += t;
    }
  }

 private:
  // end and longest from `links`, the lanes whose first row's value goes
  // on into the previous update's sum.
  __device__ __forceinline__ void segments(unsigned links) {
    const int lane = threadIdx.x & 31;
    end = lane;
    longest = 1;
    if (links != 0) {
      // Heads in the lane's column above it; the next one ends its sum.
      // For lane 31 the shift leaves 0, so no lane lies above.
      const int column = lane % kLanes;
      const unsigned above =
          ~links & (kFirstLanes << column) & ~((2u << lane) - 1u);
      end = above != 0 ? __ffs(above) - 1 - kLanes : 32 - kLanes + column;
      longest = static_cast<int>(__reduce_max_sync(
          kFull, static_cast<unsigned>((end - lane) / kLanes + 1)));
    }
  }
};

}  // namespace warp_runs
