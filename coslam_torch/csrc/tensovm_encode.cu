// TensoVM encode: forward and backward kernels for Hopper (sm_90a), bound
// to Python through a plain C interface (coslam_torch/ops/_kernels.py loads
// the shared library with ctypes; coslam_torch/ops/tensovm.py wraps it).
//
// Encoding. Per pyramid level l and channel f,
//   out[n, l*F + f] = sum over the level's 3 sections s of
//       bilinear(planes, section s, u, v)[f] * linear(lines, section s, w)[f]
// with (u, v) = r * clip(x) on the plane's axes ((0,1), (0,2), (1,2) for
// s = 0, 1, 2) and w = r * clip(x) on the axis the plane drops (2, 1, 0).
//
// What they replace (no Pallas kernel computes the forward on the TPU):
//   tensovm_encode_fwd - the forward of coslam_tpu/ops/tensovm.py
//                        make_tensovm_encode: plane_quad.gather_quads on
//                        the bf16 quad-window mirror, make_line_eval's
//                        two-hot matmul and _vm_combine (XLA on the TPU);
//                        numerically tensovm_encode_fwd_only.
//   tensovm_encode_bwd - the custom VJPs of the same: the plane-table
//                        gradient of plane_quad.quad_table_grad, whose fine
//                        sections go through the Pallas
//                        serial_scatter._row_kernel (called by
//                        plane_quad.cell_scatter_grad) and whose coarse
//                        sections go through a two-hot matmul; the line
//                        gradient (a two-hot matmul); and dx.
//
// Layout. Planes are the LOGICAL [Tp, F] f32 table: section s of level l
// starts at row plane_off[l] + s * (r+1)^2 and corner (iu, iv) of cell
// (cu, cv) is row start + (cu + iu) * (r+1) + cv + iv. Lines are one
// [Tl, F] f32 table: section s of level l starts at row
// line_off[l] + s * (r+1). On the TPU, Mosaic could not update a 2x2 patch
// at a dynamic start, so the plane gradient went through a cell-row
// accumulator [r^2, 4F] followed by 4 shifted adds, with the coarse levels
// routed to matmuls because serial issues cost more there. Here one thread
// adds the 4 corner rows of its cell, as two adjacent row pairs, straight
// into the logical table with atomics, for every section alike: no
// accumulator, no shifted adds, no routing.
//
// What bounds them on this card. The forward (kernel C, one thread per
// (point, level), thread id = n * L + l) reads, per (point, level), 3
// sections x (4 plane rows + 2 line rows) of F floats, each a separate
// 8-byte access; the tables (2.6 MB of planes, 10.7 KB of lines at room0)
// stay in the 50 MB L2, so it is bound by L2 latency of scattered reads.
//
// The backward (kernel D) re-reads the same rows (no saved residual) and
// is bound by the atomic instructions it issues and by the scattered L2
// reads, not by DRAM bytes. Its design:
//   - vector plane atomics: corners (cu, cv) and (cu, cv + 1) are adjacent
//     rows, 16 contiguous bytes at F = 2, and so are (cu + 1, cv) and
//     (cu + 1, cv + 1); each pair takes one float4 atomic when its first
//     row is even (16-byte aligned) and two float2 otherwise, 2-4 atomic
//     instructions per section where scalar atomics took 8;
//   - vector loads of the same pairs and of the line's rows i0, i0 + 1;
//   - level-major warps: a block takes a tile of consecutive points (64 at
//     L = 3) with the tile's x and cotangent staged in shared memory by
//     coalesced loads, and each warp walks one level across 32 of them;
//   - dx without atomics: each (point, level) thread leaves its 3 terms in
//     shared memory and one thread per point sums the L levels in order and
//     stores dx[n] once, so the wrapper does not zero dx;
//   - the line gradient: every point lands on the tiny line table 2 x 3
//     times per level, so its updates are summed in a per-block shared
//     [Tl, F] accumulator (10.7 KB at room0) and flushed with one global
//     atomic per non-zero entry per block; before each shared atomic the
//     lanes of a warp that hold the same line row are summed by shuffles
//     (__match_any_sync groups, a log-step tree), so one lane adds each
//     row's share of the warp (the samples of a ray, and the coarse r = 32
//     sections' 33 rows, make those groups large). With dlines the kernel
//     runs as a grid-stride loop over as many blocks as fit on the card at
//     once (the occupancy the compiler's register count allows), so each
//     block flushes once for many tiles.

// Cell choice. u = r * clip(x) is taken with __fmul_rn (no FMA
// contraction) before floorf, so cell and weight agree bit for bit with
// the CPU version, also for points on a grid line.
//
// The line's derivative. d linear / d w is V[i0 + 1] - V[i0] for every w in
// the segment [i0, i0 + 1], integer w included (autodiff of the gather
// oracle tensovm_encode_fwd_only, which the JAX package runs on the CPU);
// the TPU's two-hot derivative gives 0 at integer w instead.
//
// Determinism. f32 atomicAdd order changes from run to run, so dplanes and
// dlines agree with a serial sum only to a sum-order tolerance; dx is
// summed in a fixed order, but not the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Axes of section s: plane (u, v) and line w.
__device__ __forceinline__ int u_axis(int s) { return s == 2 ? 1 : 0; }
__device__ __forceinline__ int v_axis(int s) { return s == 0 ? 1 : 2; }
__device__ __forceinline__ int line_axis(int s) { return 2 - s; }

// levels: int32 device array [3, L] = (resolution, plane row of section 0,
// line row of section 0).
struct Levels {
  const int* __restrict__ table;
  int n_levels;

  __device__ __forceinline__ int res(int l) const { return __ldg(table + l); }
  __device__ __forceinline__ int64_t plane_row(int l) const {
    return __ldg(table + n_levels + l);
  }
  __device__ __forceinline__ int64_t line_row(int l) const {
    return __ldg(table + 2 * n_levels + l);
  }
};

// clip(x) scaled by r -> (cell in [0, res - 1], weight pos - cell).
__device__ __forceinline__ float cell_weight(float xv, int res, int* cell) {
  const float xc = fminf(fmaxf(xv, 0.0f), 1.0f);
  const float pos = __fmul_rn(static_cast<float>(res), xc);
  int c = static_cast<int>(floorf(pos));
  c = min(max(c, 0), res - 1);
  *cell = c;
  return __fsub_rn(pos, static_cast<float>(c));
}

// One section of one (point, level): the rows it reads and its weights.
struct Section {
  int64_t e00;  // plane row of corner (cu, cv); (cu+1, cv) is e00 + r1
  int64_t l0;   // line row i0; i0 + 1 is the next row
  int r1;
  float wu, wv, wl;
};

__device__ __forceinline__ Section section(const Levels& lv, int l, int res,
                                           int s, const float xs[3]) {
  Section sec;
  int cu, cv, ci;
  sec.wu = cell_weight(xs[u_axis(s)], res, &cu);
  sec.wv = cell_weight(xs[v_axis(s)], res, &cv);
  sec.wl = cell_weight(xs[line_axis(s)], res, &ci);
  sec.r1 = res + 1;
  const int64_t r1 = sec.r1;
  sec.e00 = lv.plane_row(l) + s * r1 * r1 + cu * r1 + cv;
  sec.l0 = lv.line_row(l) + s * r1 + ci;
  return sec;
}

template <int F>
__global__ void tensovm_fwd_kernel(const float* __restrict__ x,
                                   const float* __restrict__ planes,
                                   const float* __restrict__ lines,
                                   float* __restrict__ out, int64_t n_points,
                                   Levels lv) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int L = lv.n_levels;
  if (tid >= n_points * L) return;
  const int64_t n = tid / L;
  const int l = static_cast<int>(tid - n * L);
  const int res = lv.res(l);
  const float xs[3] = {x[n * 3], x[n * 3 + 1], x[n * 3 + 2]};

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const Section sec = section(lv, l, res, s, xs);
    const float* p0 = planes + sec.e00 * F;          // (cu, cv), (cu, cv+1)
    const float* p1 = planes + (sec.e00 + sec.r1) * F;  // (cu+1, ...)
    const float* v = lines + sec.l0 * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float featv0 = __ldg(p0 + f) * (1.0f - sec.wv) +
                           __ldg(p0 + F + f) * sec.wv;
      const float featv1 = __ldg(p1 + f) * (1.0f - sec.wv) +
                           __ldg(p1 + F + f) * sec.wv;
      const float plane = featv0 * (1.0f - sec.wu) + featv1 * sec.wu;
      const float line = __ldg(v + f) * (1.0f - sec.wl) +
                         __ldg(v + F + f) * sec.wl;
      acc[f] += plane * line;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[tid * F + f] = acc[f];
}

constexpr unsigned kFull = 0xffffffffu;

// Rows e and e + 1 of a [T, 2] table: one float4 when e is even, two
// float2 otherwise.
__device__ __forceinline__ void load_pair(const float* __restrict__ t,
                                          int64_t e, float2* v0, float2* v1) {
  const float2* rows = reinterpret_cast<const float2*>(t);
  if ((e & 1) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(rows + e));
    *v0 = make_float2(q.x, q.y);
    *v1 = make_float2(q.z, q.w);
  } else {
    *v0 = __ldg(rows + e);
    *v1 = __ldg(rows + e + 1);
  }
}

// dt rows e and e + 1 (F = 2: four contiguous floats at dt + 2e) += (v0,
// v1): one float4 atomic when e is even, two float2 atomics otherwise.
__device__ __forceinline__ void add_pair(float* dt, int64_t e, float2 v0,
                                         float2 v1) {
  float* d = dt + e * 2;
  if ((e & 1) == 0) {
    atomicAdd(reinterpret_cast<float4*>(d), make_float4(v0.x, v0.y, v1.x,
                                                        v1.y));
  } else {
    atomicAdd(reinterpret_cast<float2*>(d), v0);
    atomicAdd(reinterpret_cast<float2*>(d + 2), v1);
  }
}

// Warp-collective (every lane of the warp calls it): the lanes with the
// same `key` sum their 4 values by shuffles, and the lowest such lane adds
// the sums into the shared line accumulator at rows key and key + 1. A
// negative key (a lane without a point) adds nothing. The tree takes
// log2(group size) + 1 rounds.
__device__ __forceinline__ void add_line_rows(float* acc, int key, float v[4]) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, key);
  const int first = __ffs(peers) - 1;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // place in the group
  unsigned rest = peers & (0xfffffffeu << lane);         // peers above
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);  // 0: none left
    const int src = next > 0 ? next - 1 : lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = __shfl_sync(kFull, v[k], src);
      if (next > 0) v[k] += t;
    }
    rest &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  if (lane == first && key >= 0) {
    atomicAdd(acc + key * 2, v[0]);
    atomicAdd(acc + key * 2 + 1, v[1]);
    atomicAdd(acc + key * 2 + 2, v[2]);
    atomicAdd(acc + key * 2 + 3, v[3]);
  }
}

constexpr int kThreads = 256;

// Points per tile of the backward: 32 x as many 32-point groups as fit
// kThreads / 32 warps with one level each (64 at L = 3); the block has
// L * tile threads, thread t = l * tile + p.
inline int bwd_tile(int n_levels) {
  return 32 * (n_levels >= kThreads / 32 ? 1 : kThreads / 32 / n_levels);
}

// dplanes, dlines and dx may each be null (not asked for). Dynamic shared
// memory, in floats: the tile's x [tile * 3] and g [tile * L * 2], dx's
// terms [L * tile * 3] (with dx) and the line accumulator [n_line_rows * 2]
// (with dlines).
__global__ void tensovm_bwd_kernel(const float* __restrict__ x,
                                   const float* __restrict__ planes,
                                   const float* __restrict__ lines,
                                   const float* __restrict__ g,
                                   float* __restrict__ dplanes,
                                   float* __restrict__ dlines,
                                   float* __restrict__ dx, int64_t n_points,
                                   Levels lv, int n_line_rows, int tile) {
  constexpr int F = 2;
  extern __shared__ float smem[];
  const int L = lv.n_levels;
  float* xs = smem;
  float* gs = xs + tile * 3;
  float* part = gs + tile * L * F;
  float* dl = part + (dx != nullptr ? L * tile * 3 : 0);
  const int n_line = n_line_rows * F;
  if (dlines != nullptr)
    for (int i = threadIdx.x; i < n_line; i += blockDim.x) dl[i] = 0.0f;

  const int l = threadIdx.x / tile;
  const int p = threadIdx.x - l * tile;
  const int res = lv.res(l);
  const float r = static_cast<float>(res);
  const int64_t n_tiles = (n_points + tile - 1) / tile;
  for (int64_t tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const int64_t n0 = tl * tile;
    const int rows =
        n_points - n0 < tile ? static_cast<int>(n_points - n0) : tile;
    __syncthreads();  // the previous tile's xs, gs and part are read
    for (int i = threadIdx.x; i < rows * 3; i += blockDim.x)
      xs[i] = x[n0 * 3 + i];
    for (int i = threadIdx.x; i < rows * L * F; i += blockDim.x)
      gs[i] = g[n0 * L * F + i];
    __syncthreads();

    const bool active = p < rows;
    float dxa[3] = {0.0f, 0.0f, 0.0f};
    float xv[3] = {0.0f, 0.0f, 0.0f};
    float gl[F] = {0.0f, 0.0f};
    if (active) {
#pragma unroll
      for (int d = 0; d < 3; ++d) xv[d] = xs[p * 3 + d];
      gl[0] = gs[(p * L + l) * F];
      gl[1] = gs[(p * L + l) * F + 1];
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      int key = -1;
      float lv4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (active) {
        const Section sec = section(lv, l, res, s, xv);
        const float wu = sec.wu, wv = sec.wv, wl = sec.wl;
        float2 p00, p01, p10, p11, v0, v1;
        load_pair(planes, sec.e00, &p00, &p01);
        load_pair(planes, sec.e00 + sec.r1, &p10, &p11);
        load_pair(lines, sec.l0, &v0, &v1);
        const float a[F][6] = {{p00.x, p01.x, p10.x, p11.x, v0.x, v1.x},
                               {p00.y, p01.y, p10.y, p11.y, v0.y, v1.y}};
        float gp[F], gq[F];
        float du = 0.0f, dv = 0.0f, dw = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float featv0 = a[f][0] * (1.0f - wv) + a[f][1] * wv;
          const float featv1 = a[f][2] * (1.0f - wv) + a[f][3] * wv;
          const float plane = featv0 * (1.0f - wu) + featv1 * wu;
          const float line = a[f][4] * (1.0f - wl) + a[f][5] * wl;
          gp[f] = gl[f] * line;   // d out / d plane feature
          gq[f] = gl[f] * plane;  // d out / d line value
          du += gp[f] * (featv1 - featv0);
          dv += gp[f] * ((a[f][1] - a[f][0]) * (1.0f - wu) +
                         (a[f][3] - a[f][2]) * wu);
          dw += gq[f] * (a[f][5] - a[f][4]);
        }
        if (dplanes != nullptr) {
          const float w00 = (1.0f - wu) * (1.0f - wv), w01 = (1.0f - wu) * wv;
          const float w10 = wu * (1.0f - wv), w11 = wu * wv;
          add_pair(dplanes, sec.e00, make_float2(gp[0] * w00, gp[1] * w00),
                   make_float2(gp[0] * w01, gp[1] * w01));
          add_pair(dplanes, sec.e00 + sec.r1,
                   make_float2(gp[0] * w10, gp[1] * w10),
                   make_float2(gp[0] * w11, gp[1] * w11));
        }
        key = static_cast<int>(sec.l0);
        lv4[0] = gq[0] * (1.0f - wl);
        lv4[1] = gq[1] * (1.0f - wl);
        lv4[2] = gq[0] * wl;
        lv4[3] = gq[1] * wl;
        // d pos / d x = r on each axis.
        dxa[u_axis(s)] += du * r;
        dxa[v_axis(s)] += dv * r;
        dxa[line_axis(s)] += dw * r;
      }
      if (dlines != nullptr) add_line_rows(dl, key, lv4);
    }
    if (dx != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d) part[(l * tile + p) * 3 + d] = dxa[d];
      __syncthreads();
      if (l == 0 && active) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float sum = 0.0f;
          for (int k = 0; k < L; ++k) sum += part[(k * tile + p) * 3 + d];
          // Zero dx where x was clipped outside [0, 1] (the custom VJP's
          // mask).
          dx[(n0 + p) * 3 + d] = xv[d] >= 0.0f && xv[d] <= 1.0f ? sum : 0.0f;
        }
      }
    }
  }

  if (dlines != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_line; i += blockDim.x) {
      const float v = dl[i];
      if (v != 0.0f) atomicAdd(dlines + i, v);
    }
  }
}

// Features per level: TensoVM's default of 2 (room0_vm and every *_vm
// config). Instantiate another width together with a configuration that
// needs it.
constexpr int kFeatures = 2;

inline int64_t n_blocks(int64_t n_threads) {
  return (n_threads + kThreads - 1) / kThreads;
}

// The blocks of tensovm_bwd_kernel that the card holds at once with
// `threads` threads and `smem` bytes each: the SM count times the
// occupancy the compiler's register count allows, kept for the last
// (device, threads, smem) asked.
cudaError_t resident_blocks(int threads, size_t smem, int64_t* wave) {
  static int last_device = -1, last_threads = 0;
  static size_t last_smem = 0;
  static int64_t last_wave = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != last_device || threads != last_threads || smem != last_smem) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tensovm_bwd_kernel, threads, smem);
    if (err != cudaSuccess) return err;
    last_device = device;
    last_threads = threads;
    last_smem = smem;
    last_wave = static_cast<int64_t>(n_sm) * (per_sm > 0 ? per_sm : 1);
  }
  *wave = last_wave;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Both entry points return a cudaError_t code (0 = success); a feature
// width other than kFeatures returns cudaErrorInvalidValue without a launch.

int tensovm_encode_fwd(const float* x, const float* planes,
                       const float* lines, float* out, int64_t n_points,
                       int n_features, const int* levels, int n_levels,
                       void* stream) {
  if (n_features != kFeatures) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  const Levels lv{levels, n_levels};
  const unsigned int blocks =
      static_cast<unsigned int>(n_blocks(n_points * n_levels));
  tensovm_fwd_kernel<kFeatures>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, planes, lines, out, n_points, lv);
  return cudaGetLastError();
}

// dplanes ([Tp, F], zeroed), dlines ([Tl, F] with Tl = n_line_rows,
// zeroed) and dx ([N, 3], every entry written) may each be null: null
// dplanes and dlines is the frozen-map (tracking) call, null dx the
// fixed-pose (mapping) call. planes, lines and dplanes must be 16-byte
// aligned (the row-pair loads and atomics).
int tensovm_encode_bwd(const float* x, const float* planes,
                       const float* lines, const float* g, float* dplanes,
                       float* dlines, float* dx, int64_t n_points,
                       int n_features, const int* levels, int n_levels,
                       int n_line_rows, void* stream) {
  const auto misaligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
  };
  if (n_features != kFeatures || n_levels < 1 || n_levels > 32 ||
      misaligned(planes) || misaligned(lines) || misaligned(dplanes))
    return cudaErrorInvalidValue;
  if (n_points == 0 ||
      (dplanes == nullptr && dlines == nullptr && dx == nullptr))
    return cudaSuccess;
  const Levels lv{levels, n_levels};
  const int tile = bwd_tile(n_levels);
  const int threads = n_levels * tile;
  const size_t floats =
      static_cast<size_t>(tile) * (3 + n_levels * kFeatures) +
      (dx != nullptr ? static_cast<size_t>(n_levels) * tile * 3 : 0) +
      (dlines != nullptr ? static_cast<size_t>(n_line_rows) * kFeatures : 0);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    // Above 48 KB a block gets shared memory only when asked for (at most
    // 227 KB on Hopper; a larger line table is refused at launch).
    err = cudaFuncSetAttribute(tensovm_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int64_t blocks = (n_points + tile - 1) / tile;
  if (dlines != nullptr) {
    // One wave of resident blocks, each flushing its line accumulator once.
    int64_t wave = 0;
    err = resident_blocks(threads, smem, &wave);
    if (err != cudaSuccess) return err;
    if (blocks > wave) blocks = wave;
  }
  tensovm_bwd_kernel<<<static_cast<unsigned int>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, planes, lines, g, dplanes, dlines, dx, n_points, lv, n_line_rows,
      tile);
  return cudaGetLastError();
}

}  // extern "C"
