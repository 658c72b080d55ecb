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
// With unit lines (kUnitLines: no line table, the line factor 1) the same
// kernels compute the additive tri-plane (grid.enc TriPlane, and the plane
// part of TriPlaneHybrid): TensoVM with unit lines is the tri-plane
// (coslam_tpu/models/scene_rep.py relies on it for the TV term).
//
// What they replace (no Pallas kernel computes the forward on the TPU):
//   tensovm_encode_fwd - kernel C, the forward of
//                        coslam_tpu/ops/tensovm.py make_tensovm_encode:
//                        plane_quad.gather_quads on the bf16 quad-window
//                        mirror, make_line_eval's two-hot matmul and
//                        _vm_combine (XLA on the TPU); numerically
//                        tensovm_encode_fwd_only.
//   tensovm_encode_bwd - kernel D, the custom VJPs of the same: the
//                        plane-table gradient of
//                        plane_quad.quad_table_grad, whose fine
//                        sections go through the Pallas
//                        serial_scatter._row_kernel (called by
//                        plane_quad.cell_scatter_grad) and whose coarse
//                        sections go through a two-hot matmul; the line
//                        gradient (a two-hot matmul); and dx.
//   triplane_encode_fwd - kernel T (triplane_fwd_kernel), the
//                        forward of coslam_tpu/ops/triplane.py
//                        make_triplane_encode (_gather_pairs on the bf16
//                        window mirror and _combine, XLA on the TPU);
//                        numerically triplane_encode_fwd_only.
//   triplane_encode_bwd - kernel U, that encode's custom VJP: the plane
//                        table gradient through
//                        hash_packed._scatter_table_grad, the Pallas pair
//                        scatter (K2) on the plane table, and dx.
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
// What bounds them on this card. The forward (kernel C) reads, per
// (point, level), 3 sections x (2 plane row pairs + 1 line row pair) of F
// floats; the tables (2.6 MB of planes, 10.7 KB of lines at room0_vm)
// stay in the 50 MB L2, so it is bound by the scattered 32-byte sectors
// it asks of L2, of which L1 serves the line table, level 0's planes (26
// KB at room0_vm) and part of level 1's (245 KB). Its design:
//   - level-major warps: a block takes one tile of 64 consecutive points
//     at L = 3 with the tile's x staged in shared memory by coalesced
//     loads, and each warp walks one level across 32 of them, so the
//     samples of a ray share line rows and coarse plane rows inside one
//     load;
//   - row pairs read as one float4 (first row even) or two float2;
//   - the tile's outputs staged in shared memory and written as whole
//     contiguous rows;
//   - the fold of the plain version: per section the v, then u, then line
//     interpolation, their product summed over the sections in order.
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
//
// The serial mode (tensovm_encode_bwd_sort: K3 in the TPU kernel's serial
// order). The updates of dplanes and dlines are produced inside the
// segmented radix sort of serial_sort.cuh over the concatenated table
// [Tp + Tl, F] (line row i is row Tp + i): one segment a plane section
// (its (r + 1)^2 rows) and one for the whole line table. No update stream
// is written. Each segment keeps the plain version's order
// (tensovm_encode_bwd_ref: the plane corners e00, e00 + 1, e10, e10 + 1,
// each over [S, N], then the line rows i0 and i0 + 1, each over [S, N],
// with S = 3 L sections) restricted to its rows: a section's corner k,
// then n; the lines' row j, then section s, then n. The run bounds and
// kernel H's walk (row_accum.cu) then sum every row of the sorted output in
// that order from 0.0, so dplanes and dlines are the same bits on every
// run.
// The values are formed with __fmul_rn / __fadd_rn, one rounding an
// operation as in the plain version, where FMA contraction moved
// single-update entries by a few ulp. dx is the atomic mode's launch with
// dplanes and dlines null.
//
// Kernel T (triplane_fwd_kernel) has a kernel of its own, shaped for the
// tri-plane's pyramid (room0_hybrid: 4 levels 32/68/146/311, F = 2,
// 374,409 rows). Its L2 figure at the BA 1-keyframe case (sector
// accesses over the measured gather rate, kernel_times.t_l2_sectors:
// 44 us) lies above its time (35 us uniform, 19 us on room0_hybrid's
// ray-ordered points), so much of T is served by L1 already, and asking
// L2 for fewer sectors did not help: copying levels 0-1 (140 KB) into
// each block's shared memory (persistent blocks, one an SM, bulk copies
// on an mbarrier, also shared by multicast across clusters of 2 and 4)
// lost at every case. The reading we hold, not checked by any counter
// (none of L1 wavefronts or L2 sectors was read on the card), is that T
// is limited by its L1 data path, and that the copy shrank the L1 the
// fine levels hit in. A thread a point with all its levels (warps of 32
// points) won on uniform points but lost on rays. So T keeps C's
// level-major warps (a warp one level of 32 points, the samples of a ray
// sharing coarse rows inside one load), with each warp's level,
// resolution and section-0 row read once before the block's first
// barrier, blocks of 2 tiles x 4 levels (256 threads; 32 registers a
// thread by ptxas), the level count compiled in for the main path's 4
// levels, and the tiles' x and outputs staged in shared memory and moved
// as whole contiguous rows. The tried designs' times are in
// PERF.md section 6.
//
// Unit lines (kernels T and U). The line reads, the line factor, the line
// gradient and dx's line term drop out; U adds the plane gradient as the
// tri-plane's K2 forms it, v = (g * wu_k) * (1 - wv) at (u corner k, v0)
// and (g * wu_k) * wv at (u corner k, v1). U's atomics meet the
// level-major warps' contention: on ray-ordered points a warp's 32 points
// are the samples of one or two rays, which at the coarse planes (level 0:
// 3 x 33^2 rows) share a cell, so its atomics hit one row pair and are
// serialised in L2. So before it adds, U merges runs (warp_runs.cuh): per
// section, the lanes whose corner row e00 equals the previous lane's form
// a run, one ballot skips the merge where the warp holds none (uniform
// points), and otherwise each run's 8 values (2 row pairs x F = 2) are
// summed by a segmented log-step shuffle sum and the run's first lane
// issues the run's two add_pairs. D keeps its one add_pair per lane. U's
// serial mode (triplane_encode_bwd_sort: K2 in its serial order) has the
// plane sections' segments only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "serial_sort.cuh"
#include "warp_runs.cuh"

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

// Section s of a level at resolution res whose section 0 starts at plane
// row plane0 and line row line0. kUnitLines: no line (wl 0, l0 0; line0
// unread).
template <bool kUnitLines>
__device__ __forceinline__ Section section_at(int64_t plane0, int64_t line0,
                                              int res, int s,
                                              const float xs[3]) {
  Section sec;
  int cu, cv, ci = 0;
  sec.wu = cell_weight(xs[u_axis(s)], res, &cu);
  sec.wv = cell_weight(xs[v_axis(s)], res, &cv);
  sec.wl = kUnitLines ? 0.0f : cell_weight(xs[line_axis(s)], res, &ci);
  sec.r1 = res + 1;
  const int64_t r1 = sec.r1;
  sec.e00 = plane0 + s * r1 * r1 + cu * r1 + cv;
  sec.l0 = kUnitLines ? 0 : line0 + s * r1 + ci;
  return sec;
}

template <bool kUnitLines>
__device__ __forceinline__ Section section(const Levels& lv, int l, int res,
                                           int s, const float xs[3]) {
  return section_at<kUnitLines>(lv.plane_row(l),
                                kUnitLines ? 0 : lv.line_row(l), res, s, xs);
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

// Kernel U, warp-collective: lane l adds the row pairs (key, key + 1)
// and (key + r1, key + r1 + 1) of a section, v = their 4 rows x F = 2
// values; a negative key adds nothing. The lanes whose key equals the
// previous lane's form a run with it; where the warp holds one, each run
// is summed by shuffles and its first lane adds (warp_runs.cuh).
__device__ __forceinline__ void add_plane_runs(float* dt, int key, int r1,
                                               float v[8]) {
  const warp_runs::Run<> run(key);
  run.sum<8>(v);
  if (run.adds) {
    add_pair(dt, key, make_float2(v[0], v[1]), make_float2(v[2], v[3]));
    add_pair(dt, key + r1, make_float2(v[4], v[5]), make_float2(v[6], v[7]));
  }
}

constexpr int kThreads = 256;

// Kernel C. Block b takes the tile of `tile` consecutive points from
// b * tile (tile_points: 64 at L = 3), thread t = l * tile + p, so each
// warp walks one level across 32 points. Dynamic shared memory, in floats:
// the tile's x [tile * 3], then its outputs [tile, L * F + 1] (one float of
// padding a row, so the lanes' row stores fall in different banks).
__global__ void __launch_bounds__(1024) tensovm_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ planes,
    const float* __restrict__ lines, float* __restrict__ out,
    int64_t n_points, Levels lv, int tile) {
  constexpr int F = 2;
  extern __shared__ float smem[];
  const int L = lv.n_levels;
  const int width = L * F;
  float* xs = smem;
  float* os = xs + tile * 3;
  const int l = threadIdx.x / tile;
  const int p = threadIdx.x - l * tile;
  const int res = lv.res(l);
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int rows =
      n_points - n0 < tile ? static_cast<int>(n_points - n0) : tile;
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x)
    xs[i] = x[n0 * 3 + i];
  __syncthreads();
  if (p < rows) {
    const float xv[3] = {xs[p * 3], xs[p * 3 + 1], xs[p * 3 + 2]};
    float acc[F] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const Section sec = section<false>(lv, l, res, s, xv);
      float2 p00, p01, p10, p11, v0, v1;
      load_pair(planes, sec.e00, &p00, &p01);
      load_pair(planes, sec.e00 + sec.r1, &p10, &p11);
      load_pair(lines, sec.l0, &v0, &v1);
      const float a[F][6] = {{p00.x, p01.x, p10.x, p11.x, v0.x, v1.x},
                             {p00.y, p01.y, p10.y, p11.y, v0.y, v1.y}};
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float featv0 = a[f][0] * (1.0f - sec.wv) + a[f][1] * sec.wv;
        const float featv1 = a[f][2] * (1.0f - sec.wv) + a[f][3] * sec.wv;
        const float plane = featv0 * (1.0f - sec.wu) + featv1 * sec.wu;
        const float line = a[f][4] * (1.0f - sec.wl) + a[f][5] * sec.wl;
        acc[f] += plane * line;
      }
    }
    os[p * (width + 1) + l * F] = acc[0];
    os[p * (width + 1) + l * F + 1] = acc[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int q = i / width;
    out[n0 * width + i] = os[q * (width + 1) + (i - q * width)];
  }
}

// Points per tile of kernels C and D: 32 x as many 32-point groups as fit
// kThreads / 32 warps with one level each (64 at L = 3); the block has
// L * tile threads, thread t = l * tile + p.
inline int tile_points(int n_levels) {
  return 32 * (n_levels >= kThreads / 32 ? 1 : kThreads / 32 / n_levels);
}

// One level of point xv at resolution res, its section 0 at table row
// row0: the sum over its 3 sections of the bilinear plane value, with the
// sections and fold of kernel C with unit lines (per section the v, then
// the u interpolation; the sections summed in order).
__device__ __forceinline__ float2 triplane_level(const float* __restrict__ t,
                                                 int res, int64_t row0,
                                                 const float xv[3]) {
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const Section sec = section_at<true>(row0, 0, res, s, xv);
    float2 p00, p01, p10, p11;
    load_pair(t, sec.e00, &p00, &p01);
    load_pair(t, sec.e00 + sec.r1, &p10, &p11);
    const float a[2][4] = {{p00.x, p01.x, p10.x, p11.x},
                           {p00.y, p01.y, p10.y, p11.y}};
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const float featv0 = a[f][0] * (1.0f - sec.wv) + a[f][1] * sec.wv;
      const float featv1 = a[f][2] * (1.0f - sec.wv) + a[f][3] * sec.wv;
      acc[f] += featv0 * (1.0f - sec.wu) + featv1 * sec.wu;
    }
  }
  return make_float2(acc[0], acc[1]);
}

// Kernel T: a block takes `tiles` tiles of 32 consecutive points, each
// served by L warps, warp w of the block level w mod L of tile w / L (so
// one gather instruction reads one row pair of one section for 32
// points). A warp's level, its resolution and its section-0 row are fixed
// for the block and read before the block's first barrier. kL: the level
// count at compile time (4: the main path's pyramids, where it makes the
// warp's level and the output rows' divisions constant), or 0 (lv's).
// Dynamic shared memory, in floats: the tiles' x [tiles * 32 * 3], then
// their outputs [tiles * 32, L * 2 + 1] (one float of padding a row, so
// the lanes' row stores fall in different banks), written out as whole
// contiguous rows.
template <int kL>
__global__ void __launch_bounds__(1024) triplane_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ planes,
    float* __restrict__ out, int64_t n_points, Levels lv, int tiles) {
  constexpr int F = 2;
  extern __shared__ float smem[];
  const int L = kL > 0 ? kL : lv.n_levels;
  const int width = L * F, pitch = width + 1;
  float* xs = smem;
  float* os = xs + tiles * 32 * 3;
  const int warp = threadIdx.x >> 5;
  const int l = warp % L;
  const int p = (warp / L) * 32 + (threadIdx.x & 31);
  const int res = lv.res(l);
  const int64_t row0 = lv.plane_row(l);
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * tiles * 32;
  const int rows = n_points - n0 < tiles * 32
                       ? static_cast<int>(n_points - n0) : tiles * 32;
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x)
    xs[i] = __ldg(x + n0 * 3 + i);
  __syncthreads();
  if (p < rows) {
    const float xv[3] = {xs[p * 3], xs[p * 3 + 1], xs[p * 3 + 2]};
    const float2 v = triplane_level(planes, res, row0, xv);
    os[p * pitch + l * F] = v.x;
    os[p * pitch + l * F + 1] = v.y;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int q = i / width;
    out[n0 * width + i] = os[q * pitch + (i - q * width)];
  }
}

// dplanes, dlines and dx may each be null (not asked for). Dynamic shared
// memory, in floats: the tile's x [tile * 3] and g [tile * L * 2], dx's
// terms [L * tile * 3] (with dx) and the line accumulator [n_line_rows * 2]
// (with dlines).
//
// kUnitLines: kernel U, the tri-plane's backward (lines and dlines null,
// no line term in dx).
template <bool kUnitLines>
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
      // kUnitLines: the section's corner (cu, cv) row and its two row
      // pairs' 8 values, added after the warp's run merge.
      int pkey = -1, r1 = 0;
      float pv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (active) {
        const Section sec = section<kUnitLines>(lv, l, res, s, xv);
        const float wu = sec.wu, wv = sec.wv, wl = sec.wl;
        float2 p00, p01, p10, p11;
        float2 v0 = make_float2(1.0f, 1.0f), v1 = v0;
        load_pair(planes, sec.e00, &p00, &p01);
        load_pair(planes, sec.e00 + sec.r1, &p10, &p11);
        if (!kUnitLines) load_pair(lines, sec.l0, &v0, &v1);
        const float a[F][6] = {{p00.x, p01.x, p10.x, p11.x, v0.x, v1.x},
                               {p00.y, p01.y, p10.y, p11.y, v0.y, v1.y}};
        float gp[F], gq[F];
        float du = 0.0f, dv = 0.0f, dw = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float featv0 = a[f][0] * (1.0f - wv) + a[f][1] * wv;
          const float featv1 = a[f][2] * (1.0f - wv) + a[f][3] * wv;
          const float plane = featv0 * (1.0f - wu) + featv1 * wu;
          const float line =
              kUnitLines ? 1.0f : a[f][4] * (1.0f - wl) + a[f][5] * wl;
          gp[f] = gl[f] * line;   // d out / d plane feature
          gq[f] = gl[f] * plane;  // d out / d line value
          du += gp[f] * (featv1 - featv0);
          dv += gp[f] * ((a[f][1] - a[f][0]) * (1.0f - wu) +
                         (a[f][3] - a[f][2]) * wu);
          if (!kUnitLines) dw += gq[f] * (a[f][5] - a[f][4]);
        }
        if (dplanes != nullptr && kUnitLines) {
          const float2 gu0 = make_float2(gp[0] * (1.0f - wu),
                                         gp[1] * (1.0f - wu));
          const float2 gu1 = make_float2(gp[0] * wu, gp[1] * wu);
          pv[0] = gu0.x * (1.0f - wv), pv[1] = gu0.y * (1.0f - wv);
          pv[2] = gu0.x * wv, pv[3] = gu0.y * wv;
          pv[4] = gu1.x * (1.0f - wv), pv[5] = gu1.y * (1.0f - wv);
          pv[6] = gu1.x * wv, pv[7] = gu1.y * wv;
          pkey = static_cast<int>(sec.e00);
          r1 = sec.r1;
        } else if (dplanes != nullptr) {
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
        if (!kUnitLines) dxa[line_axis(s)] += dw * r;
      }
      if constexpr (kUnitLines) {
        if (dplanes != nullptr) add_plane_runs(dplanes, pkey, r1, pv);
      }
      if (!kUnitLines && dlines != nullptr) add_line_rows(dl, key, lv4);
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

  if (!kUnitLines && dlines != nullptr) {
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

// The serial modes of D and U as the producer of serial_sort.cuh. Segment
// seg < S (= 3 L) is plane section seg (level seg / 3, plane seg % 3),
// whose update i is (corner k, point n) = (i / N, i mod N): key the
// corner's row in the section, (cu + (k >> 1)) (r + 1) + cv + (k & 1);
// value, with unit lines (U), (g * wu_k) * wv_k, else (g * line) * (wu_k *
// wv_k). Segment S (D only) is the line table, whose update i is (row j,
// section s, point n) = (i / SN, i / N mod S, i mod N): key the line row
// i0 + j, value (g * plane) * wl_j. Every operation rounded once, as in
// the plain version. gt is the cotangent level-major ([L, N, 2]).
template <bool kUnitLines>
struct PlaneSerial {
  const float* x;
  const float* planes;
  const float* lines;
  const float2* gt;
  Levels lv;
  int64_t n;
  int n_sections;

  template <bool kValue>
  __device__ __forceinline__ int produce(int seg, int64_t i,
                                         float2* v) const {
    // Indices below the segment's count, < 2^31: 32-bit division.
    const bool line = !kUnitLines && seg >= n_sections;
    const unsigned un = static_cast<unsigned>(n);
    unsigned rem = static_cast<unsigned>(i);
    int j = 0, sec_idx = seg;
    if (line) {
      const unsigned sn = static_cast<unsigned>(n_sections) * un;
      j = static_cast<int>(rem / sn);
      rem -= j * sn;
      sec_idx = static_cast<int>(rem / un);
      rem -= sec_idx * un;
    }
    const int k = line ? 0 : static_cast<int>(rem / un);
    const int64_t pt = rem - k * un;
    const int l = sec_idx / 3, s = sec_idx - 3 * l;
    const int res = lv.res(l);
    const float xs[3] = {x[pt * 3], x[pt * 3 + 1], x[pt * 3 + 2]};
    const Section sec = section<kUnitLines>(lv, l, res, s, xs);
    const int64_t r1 = sec.r1;
    if (line) {
      if (kValue) {
        const float2 gl = __ldg(gt + l * n + pt);
        const float wu = sec.wu, wv = sec.wv;
        float2 p00, p01, p10, p11;
        load_pair(planes, sec.e00, &p00, &p01);
        load_pair(planes, sec.e00 + sec.r1, &p10, &p11);
        const float a[2][4] = {{p00.x, p01.x, p10.x, p11.x},
                               {p00.y, p01.y, p10.y, p11.y}};
        const float gf[2] = {gl.x, gl.y};
        const float wl = j ? sec.wl : 1.0f - sec.wl;
        float out[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const float featv0 = __fadd_rn(__fmul_rn(a[f][0], 1.0f - wv),
                                         __fmul_rn(a[f][1], wv));
          const float featv1 = __fadd_rn(__fmul_rn(a[f][2], 1.0f - wv),
                                         __fmul_rn(a[f][3], wv));
          const float plane = __fadd_rn(__fmul_rn(featv0, 1.0f - wu),
                                        __fmul_rn(featv1, wu));
          out[f] = __fmul_rn(__fmul_rn(gf[f], plane), wl);
        }
        *v = make_float2(out[0], out[1]);
      }
      return static_cast<int>(sec.l0) + j;
    }
    if (kValue) {
      const float2 gl = __ldg(gt + l * n + pt);
      const float wuk = (k >> 1) ? sec.wu : 1.0f - sec.wu;
      const float wvk = (k & 1) ? sec.wv : 1.0f - sec.wv;
      if (kUnitLines) {
        *v = make_float2(__fmul_rn(__fmul_rn(gl.x, wuk), wvk),
                         __fmul_rn(__fmul_rn(gl.y, wuk), wvk));
      } else {
        float2 v0, v1;
        load_pair(lines, sec.l0, &v0, &v1);
        const float wl = sec.wl;
        const float line0 = __fadd_rn(__fmul_rn(v0.x, 1.0f - wl),
                                      __fmul_rn(v1.x, wl));
        const float line1 = __fadd_rn(__fmul_rn(v0.y, 1.0f - wl),
                                      __fmul_rn(v1.y, wl));
        const float w = __fmul_rn(wuk, wvk);
        *v = make_float2(__fmul_rn(__fmul_rn(gl.x, line0), w),
                         __fmul_rn(__fmul_rn(gl.y, line1), w));
      }
    }
    return static_cast<int>(sec.e00 - lv.plane_row(l) - s * r1 * r1 +
                            (k >> 1) * r1 + (k & 1));
  }

  // The histogram's units: a point of a plane section (its 4 corner
  // keys), or a (section, point) of the line table (its 2 line rows).
  __device__ __forceinline__ int64_t units(int seg) const {
    return !kUnitLines && seg >= n_sections ? n_sections * n : n;
  }
  int64_t host_units(int seg) const {
    return !kUnitLines && seg >= n_sections ? n_sections * n : n;
  }
  template <class Emit>
  __device__ __forceinline__ void unit_keys(int seg, int64_t u,
                                            Emit&& emit) const {
    const bool line = !kUnitLines && seg >= n_sections;
    const int sec_idx = line ? static_cast<int>(static_cast<unsigned>(u) /
                                                static_cast<unsigned>(n))
                             : seg;
    const int64_t pt = line ? u - sec_idx * n : u;
    const int l = sec_idx / 3, s = sec_idx - 3 * l;
    const float xs[3] = {x[pt * 3], x[pt * 3 + 1], x[pt * 3 + 2]};
    const Section sec = section<kUnitLines>(lv, l, lv.res(l), s, xs);
    if (line) {
      emit(static_cast<int>(sec.l0));
      emit(static_cast<int>(sec.l0) + 1);
      return;
    }
    const int e = static_cast<int>(sec.e00 - lv.plane_row(l) -
                                   s * static_cast<int64_t>(sec.r1) * sec.r1);
    emit(e);
    emit(e + 1);
    emit(e + sec.r1);
    emit(e + sec.r1 + 1);
  }
};

inline bool misaligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
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
          &per_sm, tensovm_bwd_kernel<false>, threads, smem);
    if (err != cudaSuccess) return err;
    last_device = device;
    last_threads = threads;
    last_smem = smem;
    last_wave = static_cast<int64_t>(n_sm) * (per_sm > 0 ? per_sm : 1);
  }
  *wave = last_wave;
  return cudaSuccess;
}

// The level count kernel T is compiled for: the main path's tri-plane
// pyramids (TriPlaneHybrid's and TriPlane's, triplane_levels 4), where on
// an H100 it is 6-13 % faster on uniform points and 1-2 % on rays than
// the count read at run time (PERF.md section 6); other counts take the
// same kernel with the count read at run time.
constexpr int kTriplaneLevels = 4;

}  // namespace

extern "C" {

// Both entry points return a cudaError_t code (0 = success); a feature
// width other than kFeatures returns cudaErrorInvalidValue without a launch.

// planes and lines must be 16-byte aligned (the row-pair loads).
int tensovm_encode_fwd(const float* x, const float* planes,
                       const float* lines, float* out, int64_t n_points,
                       int n_features, const int* levels, int n_levels,
                       void* stream) {
  if (n_features != kFeatures || n_levels < 1 || n_levels > 32 ||
      misaligned(planes) || misaligned(lines))
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  const int tile = tile_points(n_levels);
  const int threads = n_levels * tile;
  const size_t smem = static_cast<size_t>(tile) *
                      (3 + n_levels * kFeatures + 1) * sizeof(float);
  const int64_t blocks = (n_points + tile - 1) / tile;
  tensovm_fwd_kernel
      <<<static_cast<unsigned int>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, planes, lines, out, n_points, Levels{levels, n_levels}, tile);
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
  if (n_features != kFeatures || n_levels < 1 || n_levels > 32 ||
      misaligned(planes) || misaligned(lines) || misaligned(dplanes))
    return cudaErrorInvalidValue;
  if (n_points == 0 ||
      (dplanes == nullptr && dlines == nullptr && dx == nullptr))
    return cudaSuccess;
  const Levels lv{levels, n_levels};
  const int tile = tile_points(n_levels);
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
    err = cudaFuncSetAttribute(tensovm_bwd_kernel<false>,
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
  tensovm_bwd_kernel<false>
      <<<static_cast<unsigned int>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          x, planes, lines, g, dplanes, dlines, dx, n_points, lv,
          n_line_rows, tile);
  return cudaGetLastError();
}

// Kernel T (triplane_fwd_kernel): planes must be 16-byte aligned.
int triplane_encode_fwd(const float* x, const float* planes, float* out,
                        int64_t n_points, int n_features, const int* levels,
                        int n_levels, void* stream) {
  if (n_features != kFeatures || n_levels < 1 || n_levels > 32 ||
      misaligned(planes))
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  // Tiles of 32 points a block: 2 at 4 levels (256 threads, the shape
  // timed in PERF.md section 6), else as many as keep 256 threads (at
  // least one tile, so at most 1024 threads at 32 levels).
  const int tiles = n_levels >= 8 ? 1 : 8 / n_levels;
  const int threads = 32 * n_levels * tiles;
  const size_t smem = static_cast<size_t>(tiles) * 32 *
                      (3 + n_levels * kFeatures + 1) * sizeof(float);
  const int64_t points = 32 * static_cast<int64_t>(tiles);
  const unsigned int blocks =
      static_cast<unsigned int>((n_points + points - 1) / points);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Levels lv{levels, n_levels};
  if (n_levels == kTriplaneLevels)
    triplane_fwd_kernel<kTriplaneLevels><<<blocks, threads, smem, st>>>(
        x, planes, out, n_points, lv, tiles);
  else
    triplane_fwd_kernel<0><<<blocks, threads, smem, st>>>(
        x, planes, out, n_points, lv, tiles);
  return cudaGetLastError();
}

// dplanes ([Tp, F], zeroed) and dx ([N, 3], every entry written) may each
// be null.
int triplane_encode_bwd(const float* x, const float* planes, const float* g,
                        float* dplanes, float* dx, int64_t n_points,
                        int n_features, const int* levels, int n_levels,
                        void* stream) {
  if (n_features != kFeatures || n_levels < 1 || n_levels > 32 ||
      misaligned(planes) || misaligned(dplanes))
    return cudaErrorInvalidValue;
  if (n_points == 0 || (dplanes == nullptr && dx == nullptr))
    return cudaSuccess;
  const int tile = tile_points(n_levels);
  const size_t smem =
      (static_cast<size_t>(tile) * (3 + n_levels * kFeatures) +
       (dx != nullptr ? static_cast<size_t>(n_levels) * tile * 3 : 0)) *
      sizeof(float);
  const int64_t blocks = (n_points + tile - 1) / tile;
  tensovm_bwd_kernel<true>
      <<<static_cast<unsigned int>(blocks), n_levels * tile, smem,
         static_cast<cudaStream_t>(stream)>>>(
          x, planes, nullptr, g, dplanes, nullptr, dx, n_points,
          Levels{levels, n_levels}, 0, tile);
  return cudaGetLastError();
}

// The serial modes' sort (serial_sort.cuh) for D (tensovm_encode_bwd_sort:
// one segment a plane section, then the line table) and U
// (triplane_encode_bwd_sort: the plane sections only): the cotangent g [N,
// L * F] level-major into gt ([L, N, F] floats), then the histogram and
// the radix passes (serial_scatter.py:SerialSort gives the segment table
// and the buffers). The sorted (global row, value) pairs, line rows from
// Tp on, land in keys_out and pay_out for the run bounds and kernel H's
// walk (row_accum.cu). planes and lines must be 16-byte aligned. The
// caller keeps the updates and the rows below 2^31.
int tensovm_encode_bwd_sort(const float* x, const float* planes,
                            const float* lines, const float* g, float* gt,
                            int64_t n_points, int n_features,
                            const int* levels, int n_levels, const int* segs,
                            const int* segs_host, int n_segs, int* keys_a,
                            float* pay_a, int* keys_b, float* pay_b,
                            int* keys_out, float* pay_out, unsigned* status,
                            int64_t status_len, int* hist, int pass_bits,
                            int passes, void* stream) {
  if (n_features != kFeatures || n_levels < 1 || n_levels > 32 ||
      n_segs != 3 * n_levels + 1 || misaligned(planes) || misaligned(lines) ||
      gt == nullptr)
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = serial::transpose_levels(g, gt, n_points, n_levels, st);
  if (err != cudaSuccess) return err;
  const serial::SortArgs a{segs, segs_host, n_segs,
                           {keys_a, keys_b},
                           {reinterpret_cast<float2*>(pay_a),
                            reinterpret_cast<float2*>(pay_b)},
                           keys_out, reinterpret_cast<float2*>(pay_out),
                           status, status_len, hist, pass_bits, passes};
  return serial::segmented_sort(
      PlaneSerial<false>{x, planes, lines,
                         reinterpret_cast<const float2*>(gt),
                         Levels{levels, n_levels}, n_points, 3 * n_levels},
      a, st);
}

int triplane_encode_bwd_sort(const float* x, const float* planes,
                             const float* g, float* gt, int64_t n_points,
                             int n_features, const int* levels, int n_levels,
                             const int* segs, const int* segs_host, int n_segs,
                             int* keys_a, float* pay_a, int* keys_b,
                             float* pay_b,
                             int* keys_out, float* pay_out, unsigned* status,
                             int64_t status_len, int* hist, int pass_bits,
                             int passes, void* stream) {
  if (n_features != kFeatures || n_levels < 1 || n_levels > 32 ||
      n_segs != 3 * n_levels || misaligned(planes) || gt == nullptr)
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = serial::transpose_levels(g, gt, n_points, n_levels, st);
  if (err != cudaSuccess) return err;
  const serial::SortArgs a{segs, segs_host, n_segs,
                           {keys_a, keys_b},
                           {reinterpret_cast<float2*>(pay_a),
                            reinterpret_cast<float2*>(pay_b)},
                           keys_out, reinterpret_cast<float2*>(pay_out),
                           status, status_len, hist, pass_bits, passes};
  return serial::segmented_sort(
      PlaneSerial<true>{x, planes, nullptr,
                        reinterpret_cast<const float2*>(gt),
                        Levels{levels, n_levels}, n_points, 3 * n_levels},
      a, st);
}

}  // extern "C"
