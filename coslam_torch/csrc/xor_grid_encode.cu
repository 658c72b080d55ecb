// XOR-hash multiresolution grid encode: forward (kernel E) and backward
// (kernel G) for Hopper (sm_90a), bound to Python through a plain C
// interface (coslam_torch/ops/_kernels.py loads the shared library with
// ctypes; coslam_torch/ops/hash_pallas.py wraps the entry points).
//
// What they replace:
//   xor_grid_encode_fwd (E) - coslam_tpu/ops/encodings.py:hashgrid_encode,
//                             which XLA compiled on the TPU (no pallas_call).
//   xor_grid_encode_bwd (G) - the dx of the custom VJP of
//                             coslam_tpu/ops/hash_pallas.py
//                             :make_hashgrid_encode_pallas_bwd (jax.vjp of
//                             hashgrid_encode at a fixed table), and the
//                             update streams it feeds to the Pallas K4
//                             (_scatter_kernel): idx int32 [M] and values
//                             [M, F], M = L * 8 * N in the level-major
//                             [L, 8, N] order of that backward, so that the
//                             deterministic row accumulate (row_accum.cu,
//                             kernel H) adds every row in the TPU's order.
//
// Layout. One [T, F] f32 table: dense levels hold (res+1)^3 rows at
// (x (r+1) + y) (r+1) + z, hashed levels 2^S rows at
// (x * 1 ^ y * 2654435761 ^ z * 805459861) & (2^S - 1) in uint32 arithmetic
// (tiny-cuda-nn's hash). Corner c of a cell is (c >> 2, (c >> 1) & 1, c & 1).
//
// Cell rule (differs from grid_encode.cu on purpose): pos = res * clip(x,
// 0, 1), cell = floor(pos) with NO clamp to res - 1; the corners are clamped
// to res instead. At x = 1 both corners of an axis are row res, so dx along
// that axis is 0. pos is __fmul_rn (no FMA contraction) and each corner
// weight is a select of w or 1 - w multiplied x, y, z in that order with
// __fmul_rn, so the weights, and the update values weight * g, are the bits
// of the CPU version.
//
// dx follows jax.vjp through jnp.clip (minimum(maximum(x, 0), 1)): the
// cotangent passes with factor 1 inside (0, 1), 0.5 at exactly 0 or 1
// (the max or min splits a tie) and 0 outside.
//
// What bounds them on this card. E reads 8 corner rows of F = 2 floats per
// (point, level) at scattered rows of a table that stays in the 50 MB L2
// (6.7 MB at room0_xor): it is bound by the count and latency of scattered
// L2 sector reads, which the DRAM-byte bound does not see. Its design:
//   - level-major warps: a block takes a tile of consecutive points (32 when
//     L >= 8, more for fewer levels) and each warp walks one level across
//     32 of them, so the consecutive samples of a ray, which share the cells
//     of the coarse levels, read the same rows in one warp (one L1 sector
//     for many lanes), and every warp takes one branch (dense or hashed);
//   - vector row loads: one float2 per corner row, and one float4 for two
//     corners whose rows form one 16-byte aligned pair: on a dense level
//     the z pair (rows e and e + 1, when e is even), on a hashed level the
//     x pair (rows h and h ^ 1 when the cell's x is even: the x prime is
//     1);
//   - the tile's points (x) come into shared memory with coalesced loads,
//     and its [points, L * F] outputs are staged in shared memory and
//     written as whole contiguous rows;
//   - the fold is unchanged: corners 0..7 in order, the same __fmul_rn
//     weights and the same multiply-adds, so the result is the plain
//     version's up to FMA contraction, as before.
// G writes 12 bytes of stream per (point, level, corner), 22.5 M updates
// (270 MB) at room0's largest BA call, so it is bound by that write; its
// threads run level-major (thread = l * N + n) so the stream stores of a
// warp are contiguous, at the price of a strided read of g and an f32
// atomic per dx component (16 levels of a point add into it from different
// blocks). Fusing the stream write into the accumulate is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned int kPrimeY = 2654435761u;  // Instant-NGP primes (x: 1)
constexpr unsigned int kPrimeZ = 805459861u;

// levels: int32 device array [3, L] = (resolution, table offset, hashed).
struct Levels {
  const int* __restrict__ table;
  int n_levels;
  unsigned int hash_mask;

  __device__ __forceinline__ int res(int l) const { return __ldg(table + l); }
  __device__ __forceinline__ int offset(int l) const {
    return __ldg(table + n_levels + l);
  }
  __device__ __forceinline__ bool hashed(int l) const {
    return __ldg(table + 2 * n_levels + l) != 0;
  }
};

// encodings._cells_and_weights: pos = res * clip(x, 0, 1), cell = floor,
// w = pos - cell.
__device__ __forceinline__ void cell_and_weights(const float* __restrict__ x,
                                                 int64_t n, int res,
                                                 int cell[3], float w[3]) {
  const float r = static_cast<float>(res);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xv = fminf(fmaxf(x[n * 3 + d], 0.0f), 1.0f);
    const float pos = __fmul_rn(r, xv);
    const float c = floorf(pos);
    cell[d] = static_cast<int>(c);
    w[d] = __fsub_rn(pos, c);
  }
}

// encodings._corner_indices: table row of corner c, corners clamped to res.
__device__ __forceinline__ int corner_row(const Levels& lv, int l, int res,
                                          const int cell[3], int c) {
  const int xc = min(cell[0] + ((c >> 2) & 1), res);
  const int yc = min(cell[1] + ((c >> 1) & 1), res);
  const int zc = min(cell[2] + (c & 1), res);
  if (lv.hashed(l)) {
    const unsigned int h = (static_cast<unsigned int>(xc) ^
                            (static_cast<unsigned int>(yc) * kPrimeY) ^
                            (static_cast<unsigned int>(zc) * kPrimeZ)) &
                           lv.hash_mask;
    return static_cast<int>(h) + lv.offset(l);
  }
  const int r1 = res + 1;
  return (xc * r1 + yc) * r1 + zc + lv.offset(l);
}

// The select of w or 1 - w per axis (corner bit set: w).
__device__ __forceinline__ void corner_cw(const float w[3], int c,
                                          float cw[3]) {
  cw[0] = ((c >> 2) & 1) ? w[0] : __fsub_rn(1.0f, w[0]);
  cw[1] = ((c >> 1) & 1) ? w[1] : __fsub_rn(1.0f, w[1]);
  cw[2] = (c & 1) ? w[2] : __fsub_rn(1.0f, w[2]);
}

// d clip(x, 0, 1) / dx under jax.vjp (the tie rule above).
__device__ __forceinline__ float clip_grad(float xv) {
  if (xv > 0.0f && xv < 1.0f) return 1.0f;
  return (xv == 0.0f || xv == 1.0f) ? 0.5f : 0.0f;
}

// Rows e0 and e1 of a [T, 2] table: one float4 when they are the two rows
// of one 16-byte aligned pair (e0 ^ e1 == 1), two float2 (or one, when
// e1 == e0: a corner clamped to res) otherwise.
__device__ __forceinline__ void load_rows(const float* __restrict__ table,
                                          int e0, int e1, float2* v0,
                                          float2* v1) {
  const float2* rows = reinterpret_cast<const float2*>(table);
  if ((e0 ^ e1) == 1) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(rows + (e0 & ~1)));
    const float2 lo = make_float2(q.x, q.y), hi = make_float2(q.z, q.w);
    *v0 = (e0 & 1) ? hi : lo;
    *v1 = (e0 & 1) ? lo : hi;
  } else {
    *v0 = __ldg(rows + e0);
    *v1 = e1 == e0 ? *v0 : __ldg(rows + e1);
  }
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// E: a block per tile of `tile` consecutive points (a multiple of 32); the
// tile's L * tile / 32 (level, 32-point group) items go round its warps,
// lane = point. Dynamic shared memory: the tile's x [tile, 3], then its
// outputs [tile, L * 2 + 1] (one float of padding a row, so the lanes' row
// stores fall in different banks).
__global__ void __launch_bounds__(kThreads) xor_grid_encode_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ table,
    float* __restrict__ out, int64_t n_points, Levels lv, int tile) {
  constexpr int F = 2;
  extern __shared__ float smem[];
  const int L = lv.n_levels;
  const int width = L * F;
  float* xs = smem;
  float* os = smem + tile * 3;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int rows =
      n_points - n0 < tile ? static_cast<int>(n_points - n0) : tile;
  for (int i = threadIdx.x; i < rows * 3; i += kThreads) xs[i] = x[n0 * 3 + i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int items = L * (tile / 32);
  for (int item = threadIdx.x / 32; item < items; item += kWarps) {
    const int l = item % L;
    const int p = (item / L) * 32 + lane;
    if (p >= rows) continue;
    const int res = lv.res(l);
    int cell[3];
    float w[3];
    cell_and_weights(xs, p, res, cell, w);
    // The pairs that can share a 16-byte row pair: on a dense level the z
    // pair (corners c, c + 1: rows e, e + 1); on a hashed level the x pair
    // (corners c, c + 4), whose rows are h and h ^ 1 when the cell's x is
    // even, since the x prime is 1. The branch is the same for the warp.
    float2 v[8];
    if (lv.hashed(l)) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        load_rows(table, corner_row(lv, l, res, cell, c),
                  corner_row(lv, l, res, cell, c + 4), &v[c], &v[c + 4]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; c += 2)
        load_rows(table, corner_row(lv, l, res, cell, c),
                  corner_row(lv, l, res, cell, c + 1), &v[c], &v[c + 1]);
    }
    float acc[F] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float cw[3];
      corner_cw(w, c, cw);
      const float wt = __fmul_rn(__fmul_rn(cw[0], cw[1]), cw[2]);
      acc[0] += v[c].x * wt;
      acc[1] += v[c].y * wt;
    }
    os[p * (width + 1) + l * F] = acc[0];
    os[p * (width + 1) + l * F + 1] = acc[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int p = i / width;
    out[n0 * width + i] = os[p * (width + 1) + (i - p * width)];
  }
}

// Points per tile of E: 32 when L >= kWarps, else enough 32-point groups
// that every warp of the block has a (level, group) item.
inline int fwd_tile(int n_levels) {
  return 32 * ((kWarps + n_levels - 1) / n_levels);
}

// G: one thread per (level, point), thread = l * N + n. idx/vals (the
// streams) and dx may each be null.
template <int F>
__global__ void xor_grid_encode_bwd_kernel(const float* __restrict__ x,
                                           const float* __restrict__ table,
                                           const float* __restrict__ g,
                                           int* __restrict__ idx,
                                           float* __restrict__ vals,
                                           float* __restrict__ dx,
                                           int64_t n_points, Levels lv) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int L = lv.n_levels;
  if (tid >= n_points * L) return;
  const int l = static_cast<int>(tid / n_points);
  const int64_t n = tid - static_cast<int64_t>(l) * n_points;
  const int res = lv.res(l);

  int cell[3];
  float w[3];
  cell_and_weights(x, n, res, cell, w);
  float gl[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gl[f] = g[(n * L + l) * F + f];

  float dw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int e = corner_row(lv, l, res, cell, c);
    float cw[3];
    corner_cw(w, c, cw);
    if (idx != nullptr) {
      const int64_t m = (static_cast<int64_t>(l) * 8 + c) * n_points + n;
      const float wt = __fmul_rn(__fmul_rn(cw[0], cw[1]), cw[2]);
      idx[m] = e;
#pragma unroll
      for (int f = 0; f < F; ++f) vals[m * F + f] = __fmul_rn(wt, gl[f]);
    }
    if (dx != nullptr) {
      const float* row = table + static_cast<int64_t>(e) * F;
      float s = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) s += __ldg(row + f) * gl[f];
      // d weight / d w_d = +-(product of the other two cw).
      dw[0] += ((c >> 2) & 1 ? s : -s) * (cw[1] * cw[2]);
      dw[1] += ((c >> 1) & 1 ? s : -s) * (cw[0] * cw[2]);
      dw[2] += (c & 1 ? s : -s) * (cw[0] * cw[1]);
    }
  }
  if (dx == nullptr) return;
  const float r = static_cast<float>(res);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float k = clip_grad(x[n * 3 + d]);
    if (k != 0.0f) atomicAdd(dx + n * 3 + d, dw[d] * r * k);
  }
}

// Features per level: the port's grids have 2 (encodings.make_encoder).
// Instantiate another width together with a configuration that needs it.
constexpr int kFeatures = 2;

inline unsigned int n_blocks(int64_t n_threads) {
  return static_cast<unsigned int>((n_threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Both entry points return a cudaError_t code (0 = success); a feature
// width other than kFeatures returns cudaErrorInvalidValue without a launch.

int xor_grid_encode_fwd(const float* x, const float* table, float* out,
                        int64_t n_points, int n_features, const int* levels,
                        int n_levels, unsigned int hash_mask, void* stream) {
  if (n_features != kFeatures || n_levels < 1 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  const Levels lv{levels, n_levels, hash_mask};
  const int tile = fwd_tile(n_levels);
  const size_t smem =
      static_cast<size_t>(tile) * (3 + n_levels * kFeatures + 1) *
      sizeof(float);
  if (smem > 48 * 1024) {
    // Above 48 KB a block gets shared memory only when asked for (at most
    // 227 KB on Hopper: L up to ~440 levels).
    const cudaError_t err = cudaFuncSetAttribute(
        xor_grid_encode_fwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks =
      static_cast<unsigned int>((n_points + tile - 1) / tile);
  xor_grid_encode_fwd_kernel<<<blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      x, table, out, n_points, lv, tile);
  return cudaGetLastError();
}

// idx [L * 8 * N] int32 and vals [L * 8 * N, F] (both written whole, or
// both null) and dx (zeroed [N, 3], or null).
int xor_grid_encode_bwd(const float* x, const float* table, const float* g,
                        int* idx, float* vals, float* dx, int64_t n_points,
                        int n_features, const int* levels, int n_levels,
                        unsigned int hash_mask, void* stream) {
  if (n_features != kFeatures || (idx == nullptr) != (vals == nullptr))
    return cudaErrorInvalidValue;
  if (n_points == 0 || (idx == nullptr && dx == nullptr)) return cudaSuccess;
  const Levels lv{levels, n_levels, hash_mask};
  xor_grid_encode_bwd_kernel<kFeatures>
      <<<n_blocks(n_points * n_levels), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(x, table, g, idx, vals, dx,
                                              n_points, lv);
  return cudaGetLastError();
}

}  // extern "C"
