// The deterministic row accumulate out[clip(idx[m], 0, rows), :] +=
// vals[m, :] (idx int32 [M], vals f32 [M, W], out f32 [rows + 1, W], row
// `rows` the slack row) for Hopper (sm_90a), bound to Python through a
// plain C interface (coslam_torch/ops/_kernels.py; wrapped by
// coslam_torch/ops/serial_scatter.py:row_accum).
//
// What it replaces: the Pallas K4, coslam_tpu/ops/hash_pallas.py
// :_scatter_kernel via scatter_add_pallas (the XOR-hash table gradient of
// grid.grad_impl: pallas), and the generic signature of K3,
// coslam_tpu/ops/serial_scatter.py:_row_kernel via row_accum_mat /
// row_accum. Both are serial loops on the TPU's scalar core with the
// accumulator in VMEM; their VMEM row limits, level groups and multi-pass
// have no counterpart here: one pass covers a table of any size.
//
// row_accum_segmented (kernel H): row_accum_keys clips the keys; a stable
// sort of the keys gives the permutation (torch.sort with stable=True, in
// the wrapper); then one thread per row finds its run in the sorted keys
// by binary search and sums the run in sorted order, which is increasing
// m, from 0.0f, and writes the row (empty rows get 0). That is the order
// of the TPU's serial loop, so every row has the same bits on every run
// and equals a serial np.add.at. Bound by the sort and by the gather of
// vals through the permutation (8 random bytes per update at W = 2); a hot
// row is summed by one thread, serially, by design.
//
// The atomic mode (kernel F) is kernel P of probe_accum.cu with its clip
// rule: one thread per update, a row of vector atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int n_blocks(int64_t n_threads) {
  return static_cast<unsigned int>((n_threads + kThreads - 1) / kThreads);
}

__device__ __forceinline__ int clip_row(int i, int rows) {
  return min(max(i, 0), rows);
}

__global__ void row_accum_keys_kernel(const int* __restrict__ idx,
                                      int* __restrict__ keys, int64_t m,
                                      int rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < m) keys[i] = clip_row(idx[i], rows);
}

// First j in [0, m) with keys[j] >= r (keys sorted ascending), or m.
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ keys,
                                               int64_t m, int r) {
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) < r) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// W > 0: the width at compile time (the row's sums in registers);
// W == 0: any width, one pass over the run per column.
template <int W>
__global__ void row_accum_segmented_kernel(const int* __restrict__ keys,
                                           const int64_t* __restrict__ perm,
                                           const float* __restrict__ vals,
                                           float* __restrict__ out, int64_t m,
                                           int rows, int width) {
  const int r = static_cast<int>(static_cast<int64_t>(blockIdx.x) *
                                 blockDim.x + threadIdx.x);
  if (r > rows) return;
  const int64_t lo = lower_bound(keys, m, r);
  const int64_t hi = r == rows ? m : lower_bound(keys, m, r + 1);
  float* dst = out + static_cast<int64_t>(r) * width;
  if constexpr (W > 0) {
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    for (int64_t j = lo; j < hi; ++j) {
      const float* src = vals + __ldg(perm + j) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = __fadd_rn(acc[w], src[w]);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) dst[w] = acc[w];
  } else {
    for (int w = 0; w < width; ++w) {
      float acc = 0.0f;
      for (int64_t j = lo; j < hi; ++j)
        acc = __fadd_rn(acc, vals[__ldg(perm + j) * width + w]);
      dst[w] = acc;
    }
  }
}

template <int W>
void launch_segmented(const int* keys, const int64_t* perm, const float* vals,
                      float* out, int64_t m, int rows, int width,
                      cudaStream_t s) {
  row_accum_segmented_kernel<W><<<n_blocks(int64_t{rows} + 1), kThreads, 0,
                                  s>>>(keys, perm, vals, out, m, rows, width);
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code (0 = success).

// keys[m] = clip(idx[m], 0, rows): the sort keys of row_accum_segmented.
int row_accum_keys(const int* idx, int* keys, int64_t m, int rows,
                   void* stream) {
  if (rows < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  row_accum_keys_kernel<<<n_blocks(m), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(idx, keys, m,
                                                               rows);
  return cudaGetLastError();
}

// keys: the clipped keys sorted ascending; perm: the stable sort's
// permutation (int64); out: [rows + 1, width], every row written.
int row_accum_segmented(const int* keys, const int64_t* perm,
                        const float* vals, float* out, int64_t m, int rows,
                        int width, void* stream) {
  if (rows < 0 || width <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The grids' 2 features per level get their sums in registers; any other
  // width takes the column loop.
  if (width == 2)
    launch_segmented<2>(keys, perm, vals, out, m, rows, width, s);
  else
    launch_segmented<0>(keys, perm, vals, out, m, rows, width, s);
  return cudaGetLastError();
}

}  // extern "C"
