// The scatter-accumulate probes' kernels for Hopper (sm_90a), bound to
// Python through a plain C interface (coslam_torch/ops/_kernels.py;
// wrapped by coslam_torch/ops/probe_accum.py). They add W-wide f32 rows
// into an f32 accumulator `out` at element offset idx[m] * stride:
// out[idx[m] * stride + e] += v[m][e] for e < W.
//
// What they replace: the Pallas probes of tools/bench/, serial loops on
// the TPU's scalar core with the accumulator in VMEM, each a variant of
// the row read-modify-write of K3/K4 (coslam_tpu/ops/serial_scatter.py
// :_row_kernel):
//   P probe_accum (f32 values, streams [W, M] or rows [M, W]):
//     _bench_cell_merge.py:_kernel_base (K5), _bench_chunk_tune.py
//     :kernel (K7, pair form), _bench_row_rates.py:_kernel_vec (K8, rows)
//     and _kernel_f32 (K9), _bench_scatter_variants.py:_kernel_tuned (K10,
//     pair form).
//   Q probe_accum_bf16x2 (values as int32 words, two bf16 each, element
//     2p = the low half): _bench_row_rates.py:_kernel_pk (K9) and
//     _bench_scatter_variants.py:_kernel_packed_bf16 (K10, pair form);
//     P's two kernels with a loader that unpacks the words.
//   R probe_accum_pair_merged (pairs after the pre-pass) and
//     probe_accum_cell_merged (the raw updates, the pre-pass fused in):
//     _bench_cell_merge.py:_kernel_merged (K6) after run_merged's XLA
//     pre-pass.
//   S probe_accum_run_merge: _bench_run_merge.py:_merge_kernel (K11),
//     which is P with its clip rule, rows [M, W] and the widest vector
//     atomic dividing W (launch_accum): P's warp merge is K11's flush on
//     change.
//   V probe_accum_run_skip: _bench_run_merge.py:_skip_kernel (K12) with
//     the segmented suffix scan before it (run_merge_outside) fused in.
// P in that form is also kernel F, the atomic row accumulate of the main path
// (coslam_torch/ops/serial_scatter.py:row_accum; it replaces K4,
// coslam_tpu/ops/hash_pallas.py:_scatter_kernel, and K3's generic form).
//
// The pair form (K2's shape) is stride = F and W = 2F: rows idx and
// idx + 1 of an [rows, F] table, contiguous. P, Q and R skip an update
// whose idx lies outside [0, max_idx] (the wrapper sets max_idx so that
// the whole W-wide row lies inside out), the sentinel rule of K12; the
// probes clip idx into the slack row before the call, as their JAX
// callers do. With `clip` (kernel F), P clips idx into [0, max_idx]
// itself: row max_idx is then the caller's slack row, as K11's caller
// (merge_accum) clips. V clips idx into [0, max_idx] as K12's caller
// (run_merge_outside) does.
//
// What bounds them on this card: f32 atomics in L2 (the 65,536-98,305-row
// accumulators of the probes, 0.5-3.1 MB, stay in the 50 MB L2), and
// contention where many updates hit one row: the atomics of one warp
// instruction that hit one address are serialised there. All add each
// row with vector atomics where the alignment allows (`vec` 4: atomicAdd
// on float4, 2: float2, both sm_90 and global memory only; 1: scalar; a
// launch argument of P and Q, the widest that divides W for R and V).
//
// P's design: consecutive lanes of a warp take consecutive updates, so
// the loads of an index or a value step are coalesced; a warp takes
// 32 x `upt` updates, a thread its `upt` updates one warp-width apart (`upt`
// and the launch's threads per block are the counterparts of the probes'
// unroll and chunk). At each step the lanes compare their clipped (or
// skipped) index with the previous lane's, and one ballot tells whether
// the warp holds a run of equal indices (warp_runs.cuh). A warp without
// one, as on uniform points, adds one row of atomics an update. A warp
// with runs sums each run's rows in registers by a segmented log-step
// shuffle sum, and the run's first lane adds one row of atomics for it;
// a run that crosses a warp boundary costs one row a warp piece. On the
// ray-ordered streams that F sums (the samples of a ray share the coarse
// levels' cells) that removes the same-address atomics of a warp.
// P with scalar atomics (`vec` 1, its default) lays a warp's lanes across
// the row instead, column fastest, where W divides 32
// (probe_accum_lanes_kernel): with one update a lane, each warp
// instruction's 32 scalar atomics fell on up to 32 rows, about 32 L2
// sectors an instruction and W instructions an update; with the lanes
// across the row they fall on 32 / W rows of W contiguous floats (at W = 8
// four rows, one sector each), the layout that gives index_add_ its time
// on the same updates. Streams [W, M] are staged in shared memory by
// coalesced loads so that the transposed read costs no extra sectors;
// the warp merge compares rows W lanes apart. A W that does not divide 32
// keeps one update a lane (probe_accum_kernel at `vec` 1).
// Q is P with a third value layout: W / 2 streams of int32 words, two
// bf16 each, unpacked in registers as they are read (load_update; the
// lanes kernel stages a warp's W / 2 x 32 words, W / 2 coalesced loads,
// and unpacks each as its column reads it). It thereby has P's coalesced
// loads, its warp merge and its lanes-across-the-row layout at `vec` 1,
// with no copy of them; it reads half of P's value bytes.
// R takes one pair of updates a lane, 32 consecutive pairs a warp. In its
// fused form (probe_accum_cell_merged) lane l reads its pair's two idx as
// one int2 and each stream's two values as one float2 (both coalesced)
// and merges a pair on one row in registers, v[2i] + v[2i+1] as the
// pre-pass adds them, so the pre-pass's (12 + 8 W) bytes a pair are never
// written and read back, and the route is one launch. In both forms a
// lane holds one or two rows; on the runs stream (runs of 1-5) a pair's
// second row is often the next pair's first, so without a merge the lanes
// of one instruction send atomics to one address, which L2 serialises
// (on an H100 the pairs form took 0.0136 ms there, 0.0095 with the
// merge). The merge (warp_runs::Run(first, last): rows in the order a_0,
// b_0, a_1, ...; a run goes on past a lane only where it holds one row)
// sums each run by shuffles, and its head adds one row of atomics.
// V takes a tile of `tile` consecutive updates a block (a multiple of
// 32, at most 512), so the probes' 62,208 updates fill the card with
// hundreds of blocks. A block stages its tile's rows in shared memory
// with coalesced float4 loads (`stage_rows`; at W = 8 a warp reads 16
// rows an instruction) and its clipped indices beside them, and the 31
// rows after its tile (2^5 - 1, the reach of the scan's 5 rounds; zero
// values and no link past M). It runs the rounds of run_merge_outside's
// Hillis-Steele suffix scan over them, one thread a position with its row
// in registers and the shifted row read from shared memory, with the same
// f32 adds in the same association (v + (link ? v_up : 0), round by
// round), and each first entry of a run inside the tile adds its scanned
// row: the others are K12's sentinels and add nothing. A run longer than
// 2^rounds contributes its first 2^rounds updates, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_runs.cuh"

namespace {

constexpr int kMaxRunWidth = 16;  // V keeps a row piece in registers
constexpr int kMaxTile = 512;     // V: updates a block, at most
constexpr int kMaxRounds = 5;     // V: scan rounds, at most
constexpr int kSkipHalo = (1 << kMaxRounds) - 1;  // V: rows staged past a tile

inline unsigned int n_blocks(int64_t n_threads, int threads) {
  return static_cast<unsigned int>((n_threads + threads - 1) / threads);
}

// The value layouts of P's kernels: f32 streams [W, M], f32 rows
// [M, W], and (kernel Q) bf16 pairs, W / 2 streams of int32 words [W / 2,
// M], word p holding element 2p in its low and 2p + 1 in its high half.
enum Layout : int { kStreams = 0, kRows = 1, kWords = 2 };

// Half h of a bf16x2 word (0: the low half, an even element) as f32.
__device__ __forceinline__ float bf16_half(unsigned int w, int h) {
  return h ? __uint_as_float(w & 0xffff0000u) : __uint_as_float(w << 16);
}

// out[0:VEC] += v[0:VEC] as one vector atomic (dst aligned to VEC floats).
template <int VEC>
__device__ __forceinline__ void add_vec(float* dst, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

// Update i's VEC values from element e (e a multiple of VEC) in layout
// LAYOUT: rows by one vector load where vals is aligned to it; words one
// load a pair of elements (e is even where VEC >= 2).
template <int VEC, int LAYOUT>
__device__ __forceinline__ void load_update(const float* __restrict__ v,
                                            int64_t m, int width, int64_t i,
                                            int e, bool aligned, float* x) {
  if constexpr (LAYOUT == kWords) {
    const unsigned int* w = reinterpret_cast<const unsigned int*>(v);
    if constexpr (VEC == 1) {
      x[0] = bf16_half(__ldg(w + (e >> 1) * m + i), e & 1);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; k += 2) {
        const unsigned int word = __ldg(w + ((e + k) >> 1) * m + i);
        x[k] = bf16_half(word, 0);
        x[k + 1] = bf16_half(word, 1);
      }
    }
    return;
  } else if constexpr (LAYOUT == kRows && VEC == 4) {
    if (aligned) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(v + i * width +
                                                             e));
      x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
      return;
    }
  } else if constexpr (LAYOUT == kRows && VEC == 2) {
    if (aligned) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(v + i * width +
                                                             e));
      x[0] = q.x, x[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    x[k] = LAYOUT == kRows ? __ldg(v + i * width + e + k)
                           : __ldg(v + (e + k) * m + i);
}

// P's key for update i: its row, clipped into [0, max_idx] (clip) or -1
// where the skip rule drops it, and -1 past M.
__device__ __forceinline__ int update_row(const int* __restrict__ idx,
                                          int64_t m, int64_t i, int max_idx,
                                          bool clip) {
  if (i >= m) return -1;
  const int j = __ldg(idx + i);
  if (clip) return min(max(j, 0), max_idx);
  return j >= 0 && j <= max_idx ? j : -1;
}

// Kernels P and Q: values in layout LAYOUT. Warp w takes updates
// [32 upt w, 32 upt (w + 1)), 32 a step, lane l update 32 k + l of step
// k; blockDim.x is a multiple of 32. A lane's key is its update's row
// (clipped, or -1 where the skip rule drops it or past M). The vector
// forms, and the scalar form at a W that does not divide 32.
template <int VEC, int LAYOUT>
__global__ void probe_accum_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, int64_t m,
                                   int width, int stride, int max_idx,
                                   int upt, bool clip) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(vals) & (sizeof(float) * VEC - 1)) == 0;
  for (int k = 0; k < upt; ++k) {
    const int64_t first = (warp * upt + k) * 32;
    if (first >= m) break;  // the same for the whole warp
    const int64_t i = first + lane;
    const int key = update_row(idx, m, i, max_idx, clip);
    const warp_runs::Run<> run(key);
    for (int e = 0; e < width; e += VEC) {
      float x[VEC];
      if (key >= 0) {
        load_update<VEC, LAYOUT>(vals, m, width, i, e, aligned, x);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) x[c] = 0.0f;
      }
      run.sum<VEC>(x);
      if (run.adds) add_vec<VEC>(out + static_cast<int64_t>(key) * stride + e,
                                 x);
    }
  }
}

// Kernels P and Q with scalar atomics where W divides 32 (`vec` 1): lanes
// across a row. Warp w takes the updates of probe_accum_kernel's warp w,
// 32 a step, and issues each step as W instructions of G = 32 / W
// updates: lane l takes column l mod W of update j G + l / W of step j, so
// the 32 scalar atomics of an instruction fall on G rows of W contiguous
// floats. Lane l reads the index of update 32 k + l of its step
// (coalesced) and each instruction's lanes take their update's from it by
// a shuffle. Rows [M, W] are read as they lie: instruction j reads 32
// contiguous floats. Streams [W, M] are staged first, a warp's own W x 32
// floats in shared memory, by W coalesced loads of 32 floats: column e of
// the step's update q at s[e * kPitch + q]; words [W / 2, M] likewise, W
// / 2 loads of 32 words, word p at s[p * kPitch + q], and column c unpacks
// half c & 1 of word c / 2 as it reads it. The G floats of skew a staged
// row (kPitch = 32 + G) put an instruction's 32 reads, staged row r of
// update u at bank (r G + u + j G) mod 32, in distinct banks (the two
// columns of a word read one address). The warp merge compares each
// update's row with the previous update's, W lanes down
// (warp_runs::Run<W>), and sums runs by shuffles W lanes apart.
template <int W, int LAYOUT>
__global__ void probe_accum_lanes_kernel(const int* __restrict__ idx,
                                         const float* __restrict__ vals,
                                         float* __restrict__ out, int64_t m,
                                         int stride, int max_idx, int upt,
                                         bool clip) {
  constexpr int G = 32 / W;
  constexpr int kPitch = 32 + G;
  constexpr int kStaged = LAYOUT == kWords ? W / 2 : W;  // rows a warp
  extern __shared__ float stage[];  // [warps a block][kStaged][kPitch]
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  float* s = stage + (threadIdx.x >> 5) * (kStaged * kPitch);
  const int u = lane / W, c = lane % W;
  for (int k = 0; k < upt; ++k) {
    const int64_t first = (warp * upt + k) * 32;
    if (first >= m) break;  // the same for the whole warp
    const int64_t i = first + lane;
    const int key = update_row(idx, m, i, max_idx, clip);
    if constexpr (LAYOUT != kRows) {
      __syncwarp();  // the last step's reads of s are done
#pragma unroll
      for (int e = 0; e < kStaged; ++e)
        s[e * kPitch + lane] = i < m ? __ldg(vals + e * m + i) : 0.0f;
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int q = j * G + u;  // the lane's update in the step
      const int row = __shfl_sync(warp_runs::kFull, key, q);
      float x = 0.0f;
      if (row >= 0) {
        if constexpr (LAYOUT == kRows)
          x = __ldg(vals + (first + q) * W + c);
        else if constexpr (LAYOUT == kStreams)
          x = s[c * kPitch + q];
        else
          x = bf16_half(__float_as_uint(s[(c >> 1) * kPitch + q]), c & 1);
      }
      const warp_runs::Run<W> run(row);
      run.template sum<1>(&x);
      if (run.adds) atomicAdd(out + static_cast<int64_t>(row) * stride + c, x);
    }
  }
}

// Kernel R: lane l of warp w takes pair 32 w + l; blockDim.x is a
// multiple of 32. Pairs form: pair i adds v1[:, i] at idx1[i] and, where
// take2[i], v2[:, i] at idx2[i] (v1, v2 streams [W, n]). FUSED: idx1 is
// the raw idx [2n] and v1 the raw streams [W, 2n] (take2, idx2 and v2
// unused); pair i is updates 2i and 2i + 1, merged into the first where
// their idx are equal (run_merged's pre-pass). A row outside [0, max_idx]
// is skipped. A lane's rows: its first in range and, where it differs, its
// second; two rows on one row are summed in registers first.
template <int VEC, bool FUSED>
__global__ void pair_merged_kernel(const int* __restrict__ idx1,
                                   const int* __restrict__ take2,
                                   const int* __restrict__ idx2,
                                   const float* __restrict__ v1,
                                   const float* __restrict__ v2,
                                   float* __restrict__ out, int64_t n,
                                   int width, int max_idx) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  int a = -1, b = -1;
  bool take = false;
  if (i < n) {
    if constexpr (FUSED) {
      if ((reinterpret_cast<uintptr_t>(idx1) & 7) == 0) {
        const int2 p = __ldg(reinterpret_cast<const int2*>(idx1) + i);
        a = p.x, b = p.y;
      } else {
        a = __ldg(idx1 + 2 * i), b = __ldg(idx1 + 2 * i + 1);
      }
      take = a != b;
    } else {
      a = __ldg(idx1 + i), take = __ldg(take2 + i) != 0, b = __ldg(idx2 + i);
    }
  }
  const bool in_a = i < n && a >= 0 && a <= max_idx;
  const bool in_b = take && b >= 0 && b <= max_idx;
  // The values of the lane's first row: v1's, the sum of both where the
  // pair is on one row (FUSED: v[2i] + v[2i+1], as the pre-pass adds
  // them), or v2's where only the second row is in range.
  const bool both = FUSED ? !take : in_a && in_b && a == b;
  const bool only_b = !in_a && in_b;
  const int first = in_a ? a : (in_b ? b : -1);
  const int last = in_a && in_b && a != b ? b : first;
  const warp_runs::Run<> run(first, last);
  const int64_t m = FUSED ? 2 * n : n;
  const bool pairs_aligned =
      FUSED && (reinterpret_cast<uintptr_t>(v1) & 7) == 0;
  for (int e = 0; e < width; e += VEC) {
    float xa[VEC], xb[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float va = 0.0f, vb = 0.0f;
      if (i < n) {
        if constexpr (FUSED) {
          const float* src = v1 + (e + c) * m + 2 * i;
          if (pairs_aligned) {
            const float2 p = __ldg(reinterpret_cast<const float2*>(src));
            va = p.x, vb = p.y;
          } else {
            va = __ldg(src), vb = __ldg(src + 1);
          }
        } else {
          va = __ldg(v1 + (e + c) * m + i), vb = __ldg(v2 + (e + c) * m + i);
        }
      }
      xa[c] = both ? va + vb : (only_b ? vb : va);
      xb[c] = vb;
    }
    run.sum<VEC>(xa);
    run.add_next<VEC>(xa, xb);
    if (run.adds)
      add_vec<VEC>(out + static_cast<int64_t>(first) * width + e, xa);
    if (run.adds_last)
      add_vec<VEC>(out + static_cast<int64_t>(last) * width + e, xb);
  }
}

// V: out[0:VEC] <- src[0:VEC] from (16-byte aligned for VEC 4)
// shared memory, one vector access.
template <int VEC>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x, dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

// V: dst[0:VEC] <- v[0:VEC] in shared memory, one vector access.
template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}

__device__ __forceinline__ int clip_row(int j, int max_idx) {
  return min(max(j, 0), max_idx);
}

// V: rows [first, first + n) of vals rows [M, W] into s (shared
// memory, 16-byte aligned), the whole block cooperating: float4 loads
// where the rows start on 16 bytes (first is a multiple of 32, so that
// is where vals does), then the tail (or everything) as scalars.
__device__ __forceinline__ void stage_rows(const float* __restrict__ vals,
                                           int64_t first, int n, int width,
                                           float* __restrict__ s) {
  const float* src = vals + first * width;
  const int count = n * width;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* s4 = reinterpret_cast<float4*>(s);
    const int n4 = count >> 2;
    for (int k = threadIdx.x; k < n4; k += blockDim.x) s4[k] = __ldg(src4 + k);
    done = n4 << 2;
  }
  for (int k = done + threadIdx.x; k < count; k += blockDim.x)
    s[k] = __ldg(src + k);
}

// Kernel V: block b takes updates [b * tile, (b + 1) * tile) and stages
// `span` = tile + kSkipHalo rows from its first (fewer at the end of the
// stream): their rows [span][W], the clipped idx of positions first - 1
// to first + span (-1 outside the stream, which equals no clipped idx)
// and the links [span]. Thread q holds position q's row; round r adds the
// row 2^r further on where q links to it, as run_merge_outside does. Once
// no position of the block links on, the rounds left would add only 0.0
// (turning a -0.0 into +0.0, which the add onto the zeroed output does
// too), so the block stops there.
template <int VEC>
__global__ void run_skip_kernel(const int* __restrict__ idx,
                                const float* __restrict__ vals,
                                float* __restrict__ out, int64_t m,
                                int width, int max_idx, int rounds,
                                int tile) {
  extern __shared__ float4 smem[];
  const int span = tile + kSkipHalo;
  float* s_vals = reinterpret_cast<float*>(smem);
  int* s_idx = reinterpret_cast<int*>(s_vals + span * width);
  unsigned char* s_link = reinterpret_cast<unsigned char*>(s_idx + span + 2);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile;
  const int ns = m - first < span ? static_cast<int>(m - first) : span;
  stage_rows(vals, first, ns, width, s_vals);
  for (int k = threadIdx.x; k < ns + 2; k += blockDim.x) {
    const int64_t g = first - 1 + k;
    s_idx[k] = g >= 0 && g < m ? clip_row(__ldg(idx + g), max_idx) : -1;
  }
  __syncthreads();
  const int q = threadIdx.x;   // blockDim.x >= span
  float v[kMaxRunWidth];
  bool link = false;
#pragma unroll
  for (int e = 0; e < kMaxRunWidth; e += VEC)
    if (e < width) {
      if (q < ns) {
        load_vec<VEC>(v + e, s_vals + q * width + e);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) v[e + c] = 0.0f;
      }
    }
  if (q < ns) link = s_idx[q + 2] == s_idx[q + 1];
  for (int r = 0; r < rounds; ++r) {
    const int s = 1 << r;
    // Every read of the last round is done; stop if nothing links on.
    if (!__syncthreads_or(link)) break;
    if (q < ns) {
#pragma unroll
      for (int e = 0; e < kMaxRunWidth; e += VEC)
        if (e < width) store_vec<VEC>(s_vals + q * width + e, v + e);
      s_link[q] = link;
    }
    __syncthreads();
    const bool inside = q + s < ns;
    const bool link_up = inside && s_link[q + s];
#pragma unroll
    for (int e = 0; e < kMaxRunWidth; e += VEC)
      if (e < width) {
        float up[VEC];
        if (inside) {
          load_vec<VEC>(up, s_vals + (q + s) * width + e);
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) up[c] = 0.0f;
        }
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          v[e + c] = __fadd_rn(v[e + c], link ? up[c] : 0.0f);
      }
    link = link && link_up;
  }
  if (q < min(tile, ns) && s_idx[q + 1] != s_idx[q]) {
    float* dst = out + static_cast<int64_t>(s_idx[q + 1]) * width;
#pragma unroll
    for (int e = 0; e < kMaxRunWidth; e += VEC)
      if (e < width) add_vec<VEC>(dst + e, v + e);
  }
}

bool bad_launch(int64_t m, int width, int vec, int threads) {
  return m < 0 || width <= 0 || (vec != 1 && vec != 2 && vec != 4) ||
         width % vec != 0 || threads < 32 || threads > 1024;
}

// V: a tile is a multiple of 32 updates, at most kMaxTile, and a
// row at most kMaxRunWidth wide.
bool bad_tile(int64_t m, int width, int vec, int tile, int max_idx) {
  return bad_launch(m, width, vec, 32) || width > kMaxRunWidth ||
         tile < 32 || tile > kMaxTile || tile % 32 != 0 || max_idx < 0;
}

template <typename Launch>
int launch_by_vec(int vec, Launch launch) {
  if (vec == 4)
    launch(std::integral_constant<int, 4>());
  else if (vec == 2)
    launch(std::integral_constant<int, 2>());
  else
    launch(std::integral_constant<int, 1>());
  return cudaGetLastError();
}

// P and Q with scalar atomics and W dividing 32: the lanes kernel at W;
// streams stage W x (32 + 32 / W) floats a warp and words half that,
// above 48 KB (W 16 and 32 with many threads) only when asked for.
template <int W, int LAYOUT>
cudaError_t launch_lanes(const int* idx, const float* v, float* out,
                         int64_t m, int stride, int max_idx, int upt,
                         bool clip, int threads, unsigned int blocks,
                         cudaStream_t s) {
  if constexpr (LAYOUT == kWords && W % 2 != 0) {
    return cudaErrorInvalidValue;  // refused by probe_accum
  } else {
    constexpr int kStaged = LAYOUT == kWords ? W / 2 : W;
    const size_t smem = LAYOUT == kRows ? 0 : sizeof(float) * (threads / 32) *
                                                  kStaged * (32 + 32 / W);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          probe_accum_lanes_kernel<W, LAYOUT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    probe_accum_lanes_kernel<W, LAYOUT><<<blocks, threads, smem, s>>>(
        idx, v, out, m, stride, max_idx, upt, clip);
    return cudaGetLastError();
  }
}

template <int VEC, int LAYOUT>
cudaError_t launch_accum(const int* idx, const float* v, float* out,
                         int64_t m, int width, int stride, int max_idx,
                         int upt, bool clip, int threads, cudaStream_t s) {
  const int64_t per_warp = 32 * static_cast<int64_t>(upt);
  const unsigned int blocks =
      n_blocks((m + per_warp - 1) / per_warp * 32, threads);
  if constexpr (VEC == 1) {
    switch (width) {
      case 1: return launch_lanes<1, LAYOUT>(idx, v, out, m, stride, max_idx,
                                             upt, clip, threads, blocks, s);
      case 2: return launch_lanes<2, LAYOUT>(idx, v, out, m, stride, max_idx,
                                             upt, clip, threads, blocks, s);
      case 4: return launch_lanes<4, LAYOUT>(idx, v, out, m, stride, max_idx,
                                             upt, clip, threads, blocks, s);
      case 8: return launch_lanes<8, LAYOUT>(idx, v, out, m, stride, max_idx,
                                             upt, clip, threads, blocks, s);
      case 16: return launch_lanes<16, LAYOUT>(idx, v, out, m, stride,
                                               max_idx, upt, clip, threads,
                                               blocks, s);
      case 32: return launch_lanes<32, LAYOUT>(idx, v, out, m, stride,
                                               max_idx, upt, clip, threads,
                                               blocks, s);
      default: break;  // one update a lane, below
    }
  }
  // The vector forms, and the scalar form at a W that does not divide 32
  // (one update a lane, W scalar atomics each; no SLAM path takes it: F
  // and K3's generic widths add with vec >= 2 where W is even).
  probe_accum_kernel<VEC, LAYOUT><<<blocks, threads, 0, s>>>(
      idx, v, out, m, width, stride, max_idx, upt, clip);
  return cudaGetLastError();
}

template <int LAYOUT>
cudaError_t dispatch_accum(const int* idx, const float* v, float* out,
                           int64_t m, int width, int stride, int max_idx,
                           int vec, int upt, bool clip, int threads,
                           cudaStream_t s) {
  if (vec == 4)
    return launch_accum<4, LAYOUT>(idx, v, out, m, width, stride, max_idx,
                                   upt, clip, threads, s);
  if (vec == 2)
    return launch_accum<2, LAYOUT>(idx, v, out, m, width, stride, max_idx,
                                   upt, clip, threads, s);
  return launch_accum<1, LAYOUT>(idx, v, out, m, width, stride, max_idx, upt,
                                 clip, threads, s);
}

// R in either form: n pairs, threads a multiple of 32.
template <bool FUSED>
int launch_pairs(const int* idx1, const int* take2, const int* idx2,
                         const float* v1, const float* v2, float* out,
                         int64_t n, int width, int max_idx, int vec,
                         int threads, void* stream) {
  if (bad_launch(n, width, vec, threads) || threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = n_blocks(n, threads);
  return launch_by_vec(vec, [&](auto v) {
    pair_merged_kernel<decltype(v)::value, FUSED><<<blocks, threads, 0, s>>>(
        idx1, take2, idx2, v1, v2, out, n, width, max_idx);
  });
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code (0 = success). out is
// zeroed by the caller; vec must divide width and stride.

// Kernels P (bf16 = 0, vals f32, streams or rows) and Q (bf16 = 1, vals
// int32 word streams, W even); threads a multiple of 32; clip = 1 clips
// idx into [0, max_idx] instead of skipping what lies outside (kernel F).
int probe_accum(const int* idx, const void* vals, float* out, int64_t m,
                int width, int stride, int max_idx, int vec, int bf16,
                int rows, int upt, int clip, int threads, void* stream) {
  if (bad_launch(m, width, vec, threads) || stride % vec != 0 || upt < 1 ||
      (bf16 && (width % 2 != 0 || rows)) || threads % 32 != 0 ||
      (clip && max_idx < 0))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  if (bf16)
    return dispatch_accum<kWords>(idx, v, out, m, width, stride, max_idx,
                                  vec, upt, clip != 0, threads, s);
  if (rows)
    return dispatch_accum<kRows>(idx, v, out, m, width, stride, max_idx, vec,
                                 upt, clip != 0, threads, s);
  return dispatch_accum<kStreams>(idx, v, out, m, width, stride, max_idx,
                                  vec, upt, clip != 0, threads, s);
}

// Kernel R, pairs form: n pairs (idx1, take2, idx2 [n], v1, v2 [width,
// n]); out [rows, width].
int probe_accum_pair_merged(const int* idx1, const int* take2,
                            const int* idx2, const float* v1, const float* v2,
                            float* out, int64_t n, int width, int max_idx,
                            int vec, int threads, void* stream) {
  return launch_pairs<false>(idx1, take2, idx2, v1, v2, out, n, width,
                             max_idx, vec, threads, stream);
}

// Kernel R, fused form: the 2n raw updates (idx [2n], vals [width, 2n]),
// each adjacent pair on one row merged in registers; out [rows, width].
int probe_accum_cell_merged(const int* idx, const float* vals, float* out,
                            int64_t n, int width, int max_idx, int vec,
                            int threads, void* stream) {
  return launch_pairs<true>(idx, nullptr, nullptr, vals, nullptr, out, n,
                            width, max_idx, vec, threads, stream);
}

// Kernel V: vals rows [m, width], width <= 16, idx clipped into
// [0, max_idx], out [max_idx + 1, width]; `rounds` (at most 5) rounds of
// the suffix scan before the adds, each run's first entry adding its
// scanned row.
int probe_accum_run_skip(const int* idx, const float* vals, float* out,
                         int64_t m, int width, int max_idx, int vec,
                         int rounds, int tile, void* stream) {
  if (bad_tile(m, width, vec, tile, max_idx) || rounds < 0 ||
      rounds > kMaxRounds)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = n_blocks(m, tile);
  const int span = tile + kSkipHalo;
  const size_t smem = sizeof(float) * span * width +
                      sizeof(int) * (span + 2) + span;
  return launch_by_vec(vec, [&](auto v) {
    run_skip_kernel<decltype(v)::value><<<blocks, tile + 32, smem, s>>>(
        idx, vals, out, m, width, max_idx, rounds, tile);
  });
}

}  // extern "C"
