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
// adds the 4 corner rows of its cell straight into the logical table with
// atomics, for every section alike: no accumulator, no shifted adds, no
// routing.
//
// Threads. One thread per (point, level), thread id = n * L + l, so the L
// threads of a point are adjacent and their F-wide outputs contiguous. A
// thread handles the level's 3 sections in turn.
//
// What bounds them on this card. The forward reads, per (point, level), 3
// sections x (4 plane rows + 2 line rows) of F floats, each a separate
// 8-byte access; the tables (2.6 MB of planes, 10.7 KB of lines at room0)
// stay in the 50 MB L2, so it is bound by L2 latency of scattered reads.
// The backward re-reads the same rows (no saved residual) and adds 4 plane
// rows per section with f32 atomics; the coarse r = 32 sections (1,089
// rows each) take many updates per row, so the plane atomics contend in L2.
// The line table is tiny and every point lands on it 2 x 3 times per
// level, so global atomics there would serialize on a few hundred hot
// addresses: the line gradient is summed in shared memory per block (the
// whole [Tl, F] table, 10.7 KB at room0) and flushed with one global
// atomic per non-zero entry per block. The backward runs as a grid-stride
// loop over at most 4 blocks per SM when it computes dlines, so that flush
// is paid by few blocks. Making either kernel faster is later work.
//
// Cell choice. u = r * clip(x) is taken with __fmul_rn (no FMA
// contraction) before floorf, so cell and weight agree bit for bit with
// the CPU version, also for points on a grid line.
//
// The line's derivative. d linear / d w is V[i0 + 1] - V[i0] for every w in
// the segment [i0, i0 + 1], integer w included (autodiff of the gather
// oracle tensovm_encode_fwd_only, which the JAX package runs on the CPU);
// the TPU's two-hot derivative gives 0 at integer w instead.
//
// Determinism. f32 atomicAdd order changes from run to run, so dplanes,
// dlines and dx agree with a serial sum only to a sum-order tolerance.

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

// dplanes, dlines and dx may each be null (not asked for). With dlines,
// the block's shared memory holds a [n_line_rows, F] accumulator.
template <int F>
__global__ void tensovm_bwd_kernel(const float* __restrict__ x,
                                   const float* __restrict__ planes,
                                   const float* __restrict__ lines,
                                   const float* __restrict__ g,
                                   float* __restrict__ dplanes,
                                   float* __restrict__ dlines,
                                   float* __restrict__ dx, int64_t n_points,
                                   Levels lv, int n_line_rows) {
  extern __shared__ float dlines_block[];
  const int n_line = n_line_rows * F;
  if (dlines != nullptr) {
    for (int i = threadIdx.x; i < n_line; i += blockDim.x)
      dlines_block[i] = 0.0f;
    __syncthreads();
  }

  const int L = lv.n_levels;
  const int64_t total = n_points * L;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       tid < total; tid += stride) {
    const int64_t n = tid / L;
    const int l = static_cast<int>(tid - n * L);
    const int res = lv.res(l);
    const float xs[3] = {x[n * 3], x[n * 3 + 1], x[n * 3 + 2]};
    float gl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = g[tid * F + f];

    float dxa[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const Section sec = section(lv, l, res, s, xs);
      const float wu = sec.wu, wv = sec.wv, wl = sec.wl;
      const float* p0 = planes + sec.e00 * F;
      const float* p1 = planes + (sec.e00 + sec.r1) * F;
      const float* v = lines + sec.l0 * F;
      float du = 0.0f, dv = 0.0f, dw = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float p00 = __ldg(p0 + f), p01 = __ldg(p0 + F + f);
        const float p10 = __ldg(p1 + f), p11 = __ldg(p1 + F + f);
        const float v0 = __ldg(v + f), v1 = __ldg(v + F + f);
        const float featv0 = p00 * (1.0f - wv) + p01 * wv;
        const float featv1 = p10 * (1.0f - wv) + p11 * wv;
        const float plane = featv0 * (1.0f - wu) + featv1 * wu;
        const float line = v0 * (1.0f - wl) + v1 * wl;
        const float gp = gl[f] * line;   // d out / d plane feature
        const float gq = gl[f] * plane;  // d out / d line value
        if (dplanes != nullptr) {
          float* d0 = dplanes + sec.e00 * F + f;
          float* d1 = dplanes + (sec.e00 + sec.r1) * F + f;
          atomicAdd(d0, gp * ((1.0f - wu) * (1.0f - wv)));
          atomicAdd(d0 + F, gp * ((1.0f - wu) * wv));
          atomicAdd(d1, gp * (wu * (1.0f - wv)));
          atomicAdd(d1 + F, gp * (wu * wv));
        }
        if (dlines != nullptr) {
          float* d = dlines_block + sec.l0 * F + f;
          atomicAdd(d, gq * (1.0f - wl));
          atomicAdd(d + F, gq * wl);
        }
        du += gp * (featv1 - featv0);
        dv += gp * ((p01 - p00) * (1.0f - wu) + (p11 - p10) * wu);
        dw += gq * (v1 - v0);
      }
      // d pos / d x = r on each axis.
      const float r = static_cast<float>(res);
      dxa[u_axis(s)] += du * r;
      dxa[v_axis(s)] += dv * r;
      dxa[line_axis(s)] += dw * r;
    }
    if (dx != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        // Zero dx where x was clipped outside [0, 1] (the custom VJP's mask).
        if (xs[d] >= 0.0f && xs[d] <= 1.0f) atomicAdd(dx + n * 3 + d, dxa[d]);
      }
    }
  }

  if (dlines != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_line; i += blockDim.x) {
      const float v = dlines_block[i];
      if (v != 0.0f) atomicAdd(dlines + i, v);
    }
  }
}

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // grid-stride cap of the dlines backward

// Features per level: TensoVM's default of 2 (room0_vm and every *_vm
// config). Instantiate another width together with a configuration that
// needs it.
constexpr int kFeatures = 2;

inline int64_t n_blocks(int64_t n_threads) {
  return (n_threads + kThreads - 1) / kThreads;
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

// dplanes ([Tp, F]), dlines ([Tl, F] with Tl = n_line_rows) and dx
// ([N, 3]) are zeroed by the caller and may each be null: null dplanes and
// dlines is the frozen-map (tracking) call, null dx the fixed-pose
// (mapping) call.
int tensovm_encode_bwd(const float* x, const float* planes,
                       const float* lines, const float* g, float* dplanes,
                       float* dlines, float* dx, int64_t n_points,
                       int n_features, const int* levels, int n_levels,
                       int n_line_rows, void* stream) {
  if (n_features != kFeatures) return cudaErrorInvalidValue;
  if (n_points == 0 ||
      (dplanes == nullptr && dlines == nullptr && dx == nullptr))
    return cudaSuccess;
  const Levels lv{levels, n_levels};
  int64_t blocks = n_blocks(n_points * n_levels);
  size_t smem = 0;
  if (dlines != nullptr) {
    int device = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    if (blocks > static_cast<int64_t>(n_sm) * kBlocksPerSm)
      blocks = static_cast<int64_t>(n_sm) * kBlocksPerSm;
    smem = static_cast<size_t>(n_line_rows) * kFeatures * sizeof(float);
    // Above 48 KB a block gets shared memory only when asked for (at most
    // 227 KB on Hopper; a larger table is refused at launch).
    err = cudaFuncSetAttribute(tensovm_bwd_kernel<kFeatures>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tensovm_bwd_kernel<kFeatures>
      <<<static_cast<unsigned int>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          x, planes, lines, g, dplanes, dlines, dx, n_points, lv,
          n_line_rows);
  return cudaGetLastError();
}

}  // extern "C"
