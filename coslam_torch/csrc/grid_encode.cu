// Packed z-linear multiresolution hash-grid encode: forward and backward
// kernels for Hopper (sm_90a), bound to Python through a plain C interface
// (coslam_torch/ops/_kernels.py loads the shared library with ctypes).
//
// What they replace (coslam_tpu/ops/hash_packed.py):
//   grid_encode_fwd  - the forward of make_packed_encode /
//                      make_packed_encode_frozen: _cells_and_weights,
//                      _corner_entries, the pair read (the Pallas
//                      _pair_select_kernel, or the XLA _gather_pairs),
//                      the dense _gather_cells and _combine.
//   grid_encode_bwd  - the table gradient of the hashed levels (Pallas
//                      _pair_scatter_kernel via _scatter_table_grad), the
//                      table gradient of the dense levels (Pallas
//                      serial_scatter._row_kernel via _cell_table_grad)
//                      and the dx chain of the custom VJP.
//
// Layout. The table is the LOGICAL [T, F] f32 table. Corner (xc, yc, z+1)
// of every cell is row e + 1 of corner (xc, yc, z): dense levels are
// z-minor and hashed levels hash only (x, y) and add z, and a hashed level
// holds 2^S + res + 1 rows, so e + 1 never leaves its level. The TPU's
// stride-7 window storage, the dense cell storage and the slack rows are
// therefore not needed: both kernels read and write rows e and e + 1 of
// the logical table directly.
//
// Threads. One thread per (point, level). The forward numbers them
// n * L + l; the backward gives each block kThreads / L whole points with
// their L threads adjacent (the same numbering when L divides kThreads),
// so the L threads of a point are adjacent and their F-wide output slices
// are contiguous (coalesced stores of out[n, l*F + f]).
//
// What bounds them on this card. The forward is bound by random row
// reads: per (point, level) 4 xy-corners x 2 rows of F floats, each a
// separate 8-byte access scattered over a table of T * F * 4 bytes
// (6.7 MB at room0: it stays in the 50 MB L2, so the reads are L2-latency
// bound rather than HBM-bandwidth bound). The design reads the row pair
// straight from the table (no packed mirror to rebuild per call) through
// the read-only cache.
//
// The backward (kernel B) is bound by its atomic instructions: the
// scatter-accumulate probes showed that on this card the count of atomic
// instructions, not the bytes, sets the time of a table gradient. Rows e
// and e + 1 of a corner are always adjacent, 16 contiguous bytes at F = 2,
// so each corner adds its row pair with one float4 atomic when e is even
// (16-byte aligned) and two float2 atomics when e is odd: 4-8 atomic
// instructions per (point, level) where scalar atomics took 16. dx takes
// no atomic: the L level-threads of a point sum their terms in registers
// (__shfl_down_sync in the half-warp when L = 16, shared memory for any
// other L) and one thread stores dx[n], so the wrapper allocates dx
// without zeroing it. dx re-reads the pair from the f32 table instead of
// saving a pair residual in the forward.
//
// Determinism. f32 atomicAdd order changes from run to run, so dtable
// agrees with a serial sum only to a sum-order tolerance; dx is summed in
// a fixed order, but not the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned int kPrime1 = 2654435761u;  // Instant-NGP primes (x, y)
constexpr unsigned int kPrime2 = 805459861u;

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

// _cells_and_weights: clip x to [0, 1], scale by the level's resolution,
// cell = clip(floor(pos), 0, res - 1), w = pos - cell.
__device__ __forceinline__ void cell_and_weights(const float* __restrict__ x,
                                                 int64_t n, int res,
                                                 int cell[3], float w[3]) {
  const float r = static_cast<float>(res);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xv = fminf(fmaxf(x[n * 3 + d], 0.0f), 1.0f);
    const float pos = __fmul_rn(r, xv);  // no FMA contraction: cell and w
                                         // must match the CPU reference
    int c = static_cast<int>(floorf(pos));
    c = min(max(c, 0), res - 1);
    cell[d] = c;
    w[d] = __fsub_rn(pos, static_cast<float>(c));
  }
}

// _corner_entries: logical row of corner (xc, yc, z) for xy-corner c in
// (00, 01, 10, 11) = (c >> 1, c & 1). Hashed: ((xc*P1) ^ (yc*P2)) & mask in
// uint32 arithmetic (wraps like the JAX version); dense: (xc*(r+1)+yc)*(r+1).
__device__ __forceinline__ int64_t corner_entry(const Levels& lv, int l,
                                                int res, const int cell[3],
                                                int c) {
  const int xc = min(cell[0] + (c >> 1), res);
  const int yc = min(cell[1] + (c & 1), res);
  int64_t base;
  if (lv.hashed(l)) {
    const unsigned int h = ((static_cast<unsigned int>(xc) * kPrime1) ^
                            (static_cast<unsigned int>(yc) * kPrime2)) &
                           lv.hash_mask;
    base = static_cast<int64_t>(h);
  } else {
    const int64_t r1 = res + 1;
    base = (static_cast<int64_t>(xc) * r1 + yc) * r1;
  }
  return base + cell[2] + lv.offset(l);
}

// _xy_weights: [(1-wx)(1-wy), (1-wx)wy, wx(1-wy), wx wy].
__device__ __forceinline__ float xy_weight(const float w[3], int c) {
  const float wx = (c >> 1) ? w[0] : 1.0f - w[0];
  const float wy = (c & 1) ? w[1] : 1.0f - w[1];
  return wx * wy;
}

template <int F>
__global__ void grid_encode_fwd_kernel(const float* __restrict__ x,
                                       const float* __restrict__ table,
                                       float* __restrict__ out,
                                       int64_t n_points, Levels lv) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int L = lv.n_levels;
  if (tid >= n_points * L) return;
  const int64_t n = tid / L;
  const int l = static_cast<int>(tid - n * L);
  const int res = lv.res(l);

  int cell[3];
  float w[3];
  cell_and_weights(x, n, res, cell, w);
  const float wz = w[2];

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int64_t e = corner_entry(lv, l, res, cell, c);
    const float wxy = xy_weight(w, c);
    const float* r0 = table + e * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float p0 = __ldg(r0 + f);
      const float p1 = __ldg(r0 + F + f);
      acc[f] += (p0 * (1.0f - wz) + p1 * wz) * wxy;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[tid * F + f] = acc[f];
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// dtable rows e and e + 1 (F = 2: four contiguous floats at dtable + 2e)
// += (v0, v1): one float4 atomic when e is even (16-byte aligned), two
// float2 atomics when it is odd (8-byte aligned).
__device__ __forceinline__ void add_row_pair(float* dtable, int64_t e,
                                             const float v0[2],
                                             const float v1[2]) {
  float* d = dtable + e * 2;
  if ((e & 1) == 0) {
    atomicAdd(reinterpret_cast<float4*>(d),
              make_float4(v0[0], v0[1], v1[0], v1[1]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(d), make_float2(v0[0], v0[1]));
    atomicAdd(reinterpret_cast<float2*>(d + 2), make_float2(v1[0], v1[1]));
  }
}

// Thread (point, level): a block holds `ppb` = kThreads / L whole points,
// their L level-threads adjacent (L = 16: a half-warp each), so a point's
// dx is summed inside the block and stored once.
template <int F>
__global__ void __launch_bounds__(kThreads) grid_encode_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ table,
    const float* __restrict__ g, float* __restrict__ dtable,
    float* __restrict__ dx, int64_t n_points, Levels lv, int ppb) {
  static_assert(F == 2, "the row-pair atomics are written for F = 2");
  __shared__ float part[kThreads][3];
  const int L = lv.n_levels;
  const int t = threadIdx.x;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * ppb + t / L;
  const int l = t % L;
  const bool active = t < ppb * L && n < n_points;

  float dxl[3] = {0.0f, 0.0f, 0.0f};
  if (active) {
    const int res = lv.res(l);
    int cell[3];
    float w[3];
    cell_and_weights(x, n, res, cell, w);
    const float wz = w[2];

    float gl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = g[(n * L + l) * F + f];

    float dwxy[4];
    float dwz = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t e = corner_entry(lv, l, res, cell, c);
      const float wxy = xy_weight(w, c);
      if (dtable != nullptr) {
        float v0[F], v1[F];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float gw = gl[f] * wxy;
          v0[f] = gw * (1.0f - wz);
          v1[f] = gw * wz;
        }
        add_row_pair(dtable, e, v0, v1);
      }
      if (dx != nullptr) {
        const float* r0 = table + e * F;
        float feat = 0.0f;
        float diff = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float p0 = __ldg(r0 + f);
          const float p1 = __ldg(r0 + F + f);
          feat += (p0 * (1.0f - wz) + p1 * wz) * gl[f];
          diff += (p1 - p0) * gl[f];
        }
        dwxy[c] = feat;
        dwz += diff * wxy;
      }
    }
    if (dx != nullptr) {
      // d wxy / d (wx, wy) for the corner order above; d pos / d x = res.
      const float wx = w[0];
      const float wy = w[1];
      const float r = static_cast<float>(res);
      dxl[0] = (-dwxy[0] * (1.0f - wy) - dwxy[1] * wy + dwxy[2] * (1.0f - wy) +
                dwxy[3] * wy) * r;
      dxl[1] = (-dwxy[0] * (1.0f - wx) + dwxy[1] * (1.0f - wx) - dwxy[2] * wx +
                dwxy[3] * wx) * r;
      dxl[2] = dwz * r;
    }
  }
  if (dx == nullptr) return;  // the same for every thread of the launch

  // Sum the point's L levels: shuffles in the half-warp when L = 16,
  // shared memory otherwise. Every thread takes part (inactive ones add 0).
  if (L == 16) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        dxl[d] += __shfl_down_sync(kFull, dxl[d], o, 16);
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) part[t][d] = dxl[d];
    __syncthreads();
    if (active && l == 0)
      for (int d = 0; d < 3; ++d) {
        float s = 0.0f;
        for (int k = 0; k < L; ++k) s += part[t + k][d];
        dxl[d] = s;
      }
  }
  if (!active || l != 0) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xv = x[n * 3 + d];
    // Zero dx where x was clipped outside [0, 1] (the JAX custom VJP's mask).
    dx[n * 3 + d] = xv >= 0.0f && xv <= 1.0f ? dxl[d] : 0.0f;
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

int grid_encode_fwd(const float* x, const float* table, float* out,
                    int64_t n_points, int n_features, const int* levels,
                    int n_levels, unsigned int hash_mask, void* stream) {
  if (n_points == 0) return cudaSuccess;
  const Levels lv{levels, n_levels, hash_mask};
  const unsigned int blocks = n_blocks(n_points * n_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_features != kFeatures) return cudaErrorInvalidValue;
  grid_encode_fwd_kernel<kFeatures><<<blocks, kThreads, 0, s>>>(x, table, out,
                                                                n_points, lv);
  return cudaGetLastError();
}

// dtable (zeroed [T, F], 16-byte aligned) and dx ([N, 3], every entry
// written) may each be null: null dtable is the frozen-table (tracking)
// call, null dx the constant-points (smoothness lattice) call.
int grid_encode_bwd(const float* x, const float* table, const float* g,
                    float* dtable, float* dx, int64_t n_points,
                    int n_features, const int* levels, int n_levels,
                    unsigned int hash_mask, void* stream) {
  if (n_points == 0 || (dtable == nullptr && dx == nullptr))
    return cudaSuccess;
  if (n_features != kFeatures || n_levels < 1 || n_levels > kThreads ||
      reinterpret_cast<uintptr_t>(dtable) % 16 != 0)
    return cudaErrorInvalidValue;
  const Levels lv{levels, n_levels, hash_mask};
  const int ppb = kThreads / n_levels;
  const unsigned int blocks =
      static_cast<unsigned int>((n_points + ppb - 1) / ppb);
  grid_encode_bwd_kernel<kFeatures>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, table, g, dtable, dx, n_points, lv, ppb);
  return cudaGetLastError();
}

const char* grid_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
