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
//     pair form), _bench_run_merge.py:_skip_kernel (K12, skip rule).
//   Q probe_accum_bf16x2 (values as int32 words, two bf16 each, element
//     2p = the low half): _bench_row_rates.py:_kernel_pk (K9) and
//     _bench_scatter_variants.py:_kernel_packed_bf16 (K10, pair form).
//   R probe_accum_pair_merged: _bench_cell_merge.py:_kernel_merged (K6).
//   S probe_accum_run_merge: _bench_run_merge.py:_merge_kernel (K11).
// P, with `clip` set, rows [M, W] and the widest vector atomic dividing W,
// is also kernel F, the atomic row accumulate of the main path
// (coslam_torch/ops/serial_scatter.py:row_accum; it replaces K4,
// coslam_tpu/ops/hash_pallas.py:_scatter_kernel, and K3's generic form).
//
// The pair form (K2's shape) is stride = F and W = 2F: rows idx and
// idx + 1 of an [rows, F] table, contiguous. An update whose idx lies
// outside [0, max_idx] is skipped (the wrapper sets max_idx so that the
// whole W-wide row lies inside out); that is K12's sentinel rule, and the
// other probes clip idx into the slack row before the call, as their JAX
// callers do. With `clip` (kernel F), P clips idx into [0, max_idx]
// itself: row max_idx is then the caller's slack row.
//
// What bounds them on this card: f32 atomics in L2 (the 65,536-98,305-row
// accumulators of the probes, 0.5-3.1 MB, stay in the 50 MB L2), and
// contention where many updates hit one row. Design: one thread takes
// `upt` consecutive updates (P, Q: the counterpart of the probes' unroll;
// the launch's threads per block are the counterpart of their chunk),
// and adds each row with vector atomics where the alignment allows
// (`vec` 4: atomicAdd on float4, 2: float2, both sm_90 and global memory
// only; 1: scalar; a launch argument of P and Q, the widest that divides
// W for R and S). R keeps the pre-pass (equal adjacent pairs merged)
// in torch, as it was XLA, and is one thread per pair with the second
// row's add predicated on take2. S is the GPU's own form of K11's
// flush-on-change: a thread walks a contiguous span of updates carrying
// (cur, acc[W]) in registers and issues one row of vector atomics per run
// boundary and one at the end of its span, so a run of equal adjacent
// indices costs one row of atomics instead of one per update.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRunWidth = 16;  // S keeps a row in registers

inline unsigned int n_blocks(int64_t n_threads, int threads) {
  return static_cast<unsigned int>((n_threads + threads - 1) / threads);
}

// Element e of update i: f32 in streams [W, M] or rows [M, W], or packed
// bf16 in word streams [W / 2, M] (word p holds element 2p in its low and
// 2p + 1 in its high half).
template <bool BF16, bool ROWS>
__device__ __forceinline__ float value(const void* __restrict__ vals,
                                       int64_t m, int width, int64_t i,
                                       int e) {
  if constexpr (!BF16) {
    const float* v = static_cast<const float*>(vals);
    return ROWS ? __ldg(v + i * width + e) : __ldg(v + e * m + i);
  } else {
    static_assert(!ROWS, "packed bf16 comes as word streams");
    const unsigned int* v = static_cast<const unsigned int*>(vals);
    const unsigned int w = __ldg(v + (e >> 1) * m + i);
    return (e & 1) ? __uint_as_float(w & 0xffff0000u)
                   : __uint_as_float(w << 16);
  }
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

// Kernels P (BF16 false) and Q (BF16 true).
template <int VEC, bool BF16, bool ROWS>
__global__ void probe_accum_kernel(const int* __restrict__ idx,
                                   const void* __restrict__ vals,
                                   float* __restrict__ out, int64_t m,
                                   int width, int stride, int max_idx,
                                   int upt, bool clip) {
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * upt;
  const int64_t last = first + upt < m ? first + upt : m;
  for (int64_t i = first; i < last; ++i) {
    int j = __ldg(idx + i);
    if (clip)
      j = min(max(j, 0), max_idx);
    else if (j < 0 || j > max_idx)
      continue;
    float* dst = out + static_cast<int64_t>(j) * stride;
    for (int e = 0; e < width; e += VEC) {
      float x[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        x[k] = value<BF16, ROWS>(vals, m, width, i, e + k);
      add_vec<VEC>(dst + e, x);
    }
  }
}

// Kernel R: one thread per pair i; v1, v2 streams [W, n].
template <int VEC>
__device__ __forceinline__ void add_stream_row(float* __restrict__ out,
                                               int j,
                                               const float* __restrict__ v,
                                               int64_t n, int64_t i,
                                               int width, int max_idx) {
  if (j < 0 || j > max_idx) return;
  float* dst = out + static_cast<int64_t>(j) * width;
  for (int e = 0; e < width; e += VEC) {
    float x[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = __ldg(v + (e + k) * n + i);
    add_vec<VEC>(dst + e, x);
  }
}

template <int VEC>
__global__ void pair_merged_kernel(const int* __restrict__ idx1,
                                   const int* __restrict__ take2,
                                   const int* __restrict__ idx2,
                                   const float* __restrict__ v1,
                                   const float* __restrict__ v2,
                                   float* __restrict__ out, int64_t n,
                                   int width, int max_idx) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  add_stream_row<VEC>(out, __ldg(idx1 + i), v1, n, i, width, max_idx);
  if (__ldg(take2 + i) != 0)
    add_stream_row<VEC>(out, __ldg(idx2 + i), v2, n, i, width, max_idx);
}

// Kernel S: thread t walks updates [t * span, (t + 1) * span) of vals
// rows [M, W]; each run of equal adjacent idx is summed in registers, in
// update order from its first value, and added with one row of atomics.
template <int VEC>
__device__ __forceinline__ void flush_row(float* __restrict__ out, int cur,
                                          const float* acc, int width,
                                          int max_idx) {
  if (cur < 0 || cur > max_idx) return;
  float* dst = out + static_cast<int64_t>(cur) * width;
#pragma unroll
  for (int e = 0; e < kMaxRunWidth; e += VEC)
    if (e < width) add_vec<VEC>(dst + e, acc + e);
}

template <int VEC>
__global__ void run_merge_kernel(const int* __restrict__ idx,
                                 const float* __restrict__ vals,
                                 float* __restrict__ out, int64_t m,
                                 int width, int max_idx, int span) {
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * span;
  if (first >= m) return;
  const int64_t last = first + span < m ? first + span : m;
  float acc[kMaxRunWidth];
  int cur = __ldg(idx + first);
#pragma unroll
  for (int e = 0; e < kMaxRunWidth; ++e)
    acc[e] = e < width ? __ldg(vals + first * width + e) : 0.0f;
  for (int64_t i = first + 1; i < last; ++i) {
    const int j = __ldg(idx + i);
    const float* src = vals + i * width;
    if (j == cur) {
#pragma unroll
      for (int e = 0; e < kMaxRunWidth; ++e)
        if (e < width) acc[e] = __fadd_rn(acc[e], __ldg(src + e));
    } else {
      flush_row<VEC>(out, cur, acc, width, max_idx);
      cur = j;
#pragma unroll
      for (int e = 0; e < kMaxRunWidth; ++e)
        if (e < width) acc[e] = __ldg(src + e);
    }
  }
  flush_row<VEC>(out, cur, acc, width, max_idx);
}

bool bad_launch(int64_t m, int width, int vec, int threads) {
  return m < 0 || width <= 0 || (vec != 1 && vec != 2 && vec != 4) ||
         width % vec != 0 || threads < 32 || threads > 1024;
}

template <int VEC, bool BF16>
void launch_accum(const int* idx, const void* vals, float* out, int64_t m,
                  int width, int stride, int max_idx, bool rows, int upt,
                  bool clip, int threads, cudaStream_t s) {
  const unsigned int blocks = n_blocks((m + upt - 1) / upt, threads);
  if constexpr (!BF16) {
    if (rows) {
      probe_accum_kernel<VEC, false, true><<<blocks, threads, 0, s>>>(
          idx, vals, out, m, width, stride, max_idx, upt, clip);
      return;
    }
  }
  probe_accum_kernel<VEC, BF16, false><<<blocks, threads, 0, s>>>(
      idx, vals, out, m, width, stride, max_idx, upt, clip);
}

template <bool BF16>
void dispatch_accum(const int* idx, const void* vals, float* out, int64_t m,
                    int width, int stride, int max_idx, int vec, bool rows,
                    int upt, bool clip, int threads, cudaStream_t s) {
  if (vec == 4)
    launch_accum<4, BF16>(idx, vals, out, m, width, stride, max_idx, rows,
                          upt, clip, threads, s);
  else if (vec == 2)
    launch_accum<2, BF16>(idx, vals, out, m, width, stride, max_idx, rows,
                          upt, clip, threads, s);
  else
    launch_accum<1, BF16>(idx, vals, out, m, width, stride, max_idx, rows,
                          upt, clip, threads, s);
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code (0 = success). out is
// zeroed by the caller; vec must divide width and stride.

// Kernels P (bf16 = 0, vals f32, streams or rows) and Q (bf16 = 1, vals
// int32 word streams); clip = 1 clips idx into [0, max_idx] instead of
// skipping what lies outside (kernel F).
int probe_accum(const int* idx, const void* vals, float* out, int64_t m,
                int width, int stride, int max_idx, int vec, int bf16,
                int rows, int upt, int clip, int threads, void* stream) {
  if (bad_launch(m, width, vec, threads) || stride % vec != 0 || upt < 1 ||
      (bf16 && (width % 2 != 0 || rows)) || (clip && max_idx < 0))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    dispatch_accum<true>(idx, vals, out, m, width, stride, max_idx, vec,
                         rows != 0, upt, clip != 0, threads, s);
  else
    dispatch_accum<false>(idx, vals, out, m, width, stride, max_idx, vec,
                          rows != 0, upt, clip != 0, threads, s);
  return cudaGetLastError();
}

// Kernel R: n pairs; out [rows, width].
int probe_accum_pair_merged(const int* idx1, const int* take2,
                            const int* idx2, const float* v1, const float* v2,
                            float* out, int64_t n, int width, int max_idx,
                            int vec, int threads, void* stream) {
  if (bad_launch(n, width, vec, threads)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = n_blocks(n, threads);
  if (vec == 4)
    pair_merged_kernel<4><<<blocks, threads, 0, s>>>(idx1, take2, idx2, v1,
                                                     v2, out, n, width,
                                                     max_idx);
  else if (vec == 2)
    pair_merged_kernel<2><<<blocks, threads, 0, s>>>(idx1, take2, idx2, v1,
                                                     v2, out, n, width,
                                                     max_idx);
  else
    pair_merged_kernel<1><<<blocks, threads, 0, s>>>(idx1, take2, idx2, v1,
                                                     v2, out, n, width,
                                                     max_idx);
  return cudaGetLastError();
}

// Kernel S: vals rows [m, width], width <= 16; out [rows, width].
int probe_accum_run_merge(const int* idx, const float* vals, float* out,
                          int64_t m, int width, int max_idx, int vec,
                          int span, int threads, void* stream) {
  if (bad_launch(m, width, vec, threads) || width > kMaxRunWidth ||
      span < 1)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = n_blocks((m + span - 1) / span, threads);
  if (vec == 4)
    run_merge_kernel<4><<<blocks, threads, 0, s>>>(idx, vals, out, m, width,
                                                   max_idx, span);
  else if (vec == 2)
    run_merge_kernel<2><<<blocks, threads, 0, s>>>(idx, vals, out, m, width,
                                                   max_idx, span);
  else
    run_merge_kernel<1><<<blocks, threads, 0, s>>>(idx, vals, out, m, width,
                                                   max_idx, span);
  return cudaGetLastError();
}

}  // extern "C"
