// Kernel H, the deterministic row accumulate out[clip(idx[m], 0, rows), :]
// += vals[m, :] (idx int32 [M], vals f32 [M, W], out f32 [rows + 1, W], row
// `rows` the slack row), for Hopper (sm_90a), bound to Python through a
// plain C interface (coslam_torch/ops/_kernels.py; wrapped by
// coslam_torch/ops/serial_scatter.py:row_accum).
//
// What it replaces: the Pallas K4, coslam_tpu/ops/hash_pallas.py
// :_scatter_kernel via scatter_add_pallas (the XOR-hash table gradient of
// grid.grad_impl: pallas), and the generic signature of K3,
// coslam_tpu/ops/serial_scatter.py:_row_kernel via row_accum_mat /
// row_accum. Both are serial loops on the TPU's scalar core with the
// accumulator in VMEM. Their result is the contract kept here: every row
// is summed from 0.0f in increasing m with round-to-nearest f32 adds, so
// it has the same bits on every run and equals a serial np.add.at.
//
// What bounds it on this card. No f32 atomic can keep that order, so the
// updates are put in row order first, by a stable sort of M keys, and
// then every row's run is folded. Both move device memory and do little
// arithmetic: the time is set by bytes (and by how whole the sectors are
// that the sort's scattered writes fill), not by operations.
//
// The design, in three phases (each its own entry point, so that the
// wrapper and the smoke's per-phase timing call the same code):
//  1. row_accum_sort: a stable LSD radix sort of the clipped keys over
//     only the bits that `rows` needs, in `passes` passes of `digit_bits`
//     (<= 7) bits. One histogram kernel reads the keys once and counts
//     the digits of every pass. Then each pass is one kernel in the
//     "onesweep" form: a block takes the next 4,096-key tile by ticket,
//     each warp ranks its 512 consecutive keys in order (the lanes of
//     equal digit from one ballot per digit bit, a per-warp count in
//     shared memory), the block publishes its digit counts and finds its
//     global offsets by looking back at the tiles before it (decoupled
//     look-back), lays the tile out by digit in shared memory and writes
//     each digit's run coalesced. Tiles run in ticket order, so the
//     tiles in flight write neighbouring parts of every digit's run and
//     the L2 merges their partial sectors. Stability follows from the
//     ranks (warp, round, lane order) and the tile order, so each row's
//     run comes out in increasing m. The payload is the value row itself
//     when W = 2 (read in order by the first pass), so that the walk reads
//     each run contiguously; for other widths it is m, and the walk
//     gathers vals through it.
//  2. row_accum_starts: one coalesced pass over the sorted keys that
//     writes start[r] for every row r in 0..rows + 1 (empty rows get an
//     empty run), in place of a binary search per row.
//  3. row_accum_walk: one thread per row sums a run of at most kLongRun
//     updates, loading 8 entries before it adds them (one memory round
//     trip per 8 updates); each longer run (the coarse dense levels, and
//     rows shared by the samples of a ray) gets a warp of its own, which
//     loads 256 entries a round trip into shared memory, issues the next
//     round trip's loads before the fold, and lets one lane fold them in
//     run order, so a long run costs its chain of dependent adds. Both
//     fold with __fadd_rn from 0.0f in run order.
//
// The atomic mode (kernel F) is kernel P of probe_accum.cu with its clip
// rule: one thread per update, a row of vector atomics.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                   // keys per thread per tile
constexpr int kTile = kThreads * kItems;     // 4,096 keys
constexpr int kMaxBits = 7;                  // 128 digits, < kThreads
constexpr int kMaxRadix = 1 << kMaxBits;
constexpr int kMaxPasses = 5;                // 31 bits in 5 passes of 7
constexpr int kScatterBlocksPerSM = 4;       // 64 registers, no spills
constexpr int kHistItems = 4;                // loads in flight a thread
constexpr int kLookBack = 4;                 // tiles' counts read at once
constexpr int kLongRun = 64;                 // longer runs: a warp each
constexpr int kWalkUnroll = 8;
constexpr int kFoldChunk = 256;              // long run: entries a trip
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoDigit = -1;

// A tile's published count of one digit: the value in the low 30 bits,
// and whether it is the tile's own count (aggregate) or the count of this
// tile and every tile before it (inclusive). 0: not published yet.
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kInclusive = 2u << 30;
constexpr unsigned kValueMask = kAggregate - 1u;

__device__ __forceinline__ int clip_row(int i, int rows) {
  return min(max(i, 0), rows);
}

// The payload of the first pass: the value row (float2) or m (int).
template <typename Pay>
struct Pass {
  const int* idx;           // first pass: keys = clip(idx, 0, rows)
  const float2* vals;       // first pass, Pay = float2: the value rows
  const int* keys_in;       // later passes (null on the first)
  const Pay* pay_in;
  int* keys_out;
  Pay* pay_out;
  unsigned* status;         // [n_tiles, radix] published counts, then
                            // the tile ticket (zeroed before the pass)
  const int* digit_total;   // [radix] this pass's digit counts
  int64_t m, n_tiles;
  int rows, shift, bits;

  __device__ __forceinline__ int radix() const { return 1 << bits; }
  __device__ __forceinline__ int key(int64_t i) const {
    return keys_in ? __ldg(keys_in + i) : clip_row(__ldg(idx + i), rows);
  }
  __device__ __forceinline__ int digit(int k) const {
    return (k >> shift) & (radix() - 1);
  }
};

// Exclusive prefix sum of v over the block's kThreads threads (all must
// call).
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();
  return before + x - v;
}

// The lanes of the warp whose digit (`bits` bits, or kNoDigit) equals
// this lane's: one ballot per bit and one for kNoDigit. (__match_any_sync
// computes the same mask, but ballots issue at full rate.)
__device__ __forceinline__ unsigned digit_peers(int d, int bits) {
  const bool valid = d != kNoDigit;
  const unsigned v = __ballot_sync(kFull, valid);
  unsigned peers = valid ? v : ~v;
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b) {
    if (b >= bits) break;
    const bool bit = valid && ((d >> b) & 1);
    const unsigned m = __ballot_sync(kFull, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// The digit counts of every pass in one read of the keys:
// digit_total[pass * radix + d] (zeroed first), from shared-memory counts
// added in with integer atomics (an integer sum does not depend on the
// order of its adds).
__global__ void __launch_bounds__(kThreads) radix_histogram_kernel(
    const int* __restrict__ idx, int* __restrict__ digit_total, int64_t m,
    int rows, int bits, int passes) {
  __shared__ int hist[kMaxPasses * kMaxRadix];
  const int radix = 1 << bits;
  for (int j = threadIdx.x; j < passes * radix; j += kThreads) hist[j] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
       base < m; base += stride * kHistItems) {
    int key[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const int64_t i = base + k * stride;
      key[k] = i < m ? clip_row(__ldg(idx + i), rows) : -1;
    }
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      if (key[k] < 0) continue;
      for (int pass = 0; pass < passes; ++pass)
        atomicAdd(hist + pass * radix +
                      ((key[k] >> (pass * bits)) & (radix - 1)),
                  1);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < passes * radix; j += kThreads)
    if (hist[j] != 0) atomicAdd(digit_total + j, hist[j]);
}

// Shared memory of one onesweep block: the tile's payloads in update
// order, its keys laid out by digit and each one's slot in update order,
// the digits' starts in the tile and global offsets, scan scratch and the
// tile's ticket, and each warp's digit counts.
template <typename Pay>
size_t onesweep_smem(int radix) {
  return (sizeof(Pay) + sizeof(int) + sizeof(unsigned short)) * kTile +
         sizeof(int) * (2 * radix + kWarps + 1) +
         sizeof(unsigned short) * kWarps * radix;
}

// One pass of the stable LSD radix sort over one 4,096-key tile.
template <typename Pay>
__global__ void __launch_bounds__(kThreads, kScatterBlocksPerSM)
    radix_onesweep_kernel(Pass<Pay> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Pay* stage = reinterpret_cast<Pay*>(smem_raw);   // [kTile] update order
  int* skey = reinterpret_cast<int*>(stage + kTile);  // [kTile] by digit
  unsigned short* slot =                           // [kTile] by digit
      reinterpret_cast<unsigned short*>(skey + kTile);
  const int radix = p.radix();
  int* tile_start = reinterpret_cast<int*>(slot + kTile);  // [radix]
  int* glob = tile_start + radix;                  // [radix]
  int* warp_sums = glob + radix;                   // [kWarps], then ticket
  unsigned short* hist =                           // [kWarps, radix]
      reinterpret_cast<unsigned short*>(warp_sums + kWarps + 1);

  // Thread t < radix keeps the tile's counts of digit t.
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0)
    warp_sums[kWarps] = static_cast<int>(
        atomicAdd(p.status + p.n_tiles * radix, 1u));
  for (int j = t; j < kWarps * radix / 2; j += kThreads)
    reinterpret_cast<unsigned int*>(hist)[j] = 0u;
  __syncthreads();
  const int64_t tile = warp_sums[kWarps];
  const int64_t base = tile * kTile;
  const int64_t hi = base + kTile < p.m ? base + kTile : p.m;

  // The tile's payloads go to shared memory in update order by
  // asynchronous 16-byte copies, which need no registers and land while
  // the keys are ranked (m itself, on the first pass, is not copied).
  const Pay* pay_src = p.pay_in != nullptr ? p.pay_in + base
                       : std::is_same<Pay, float2>::value
                           ? reinterpret_cast<const Pay*>(p.vals + base)
                           : nullptr;
  if (pay_src != nullptr) {
    constexpr int kPer = 16 / sizeof(Pay);
    const int n = static_cast<int>(hi - base), whole = n / kPer;
    for (int c = t; c < whole; c += kThreads)
      __pipeline_memcpy_async(stage + c * kPer, pay_src + c * kPer, 16);
    __pipeline_commit();
    for (int e = whole * kPer + t; e < n; e += kThreads)
      stage[e] = pay_src[e];
  }

  // Warp w ranks keys [base + 512 w, base + 512 (w + 1)) in order; key -1
  // marks a slot past the end (keys are >= 0).
  int key[kItems];
  unsigned rank[kItems];
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned short* wh = hist + warp * radix;
  const int64_t wbase = base + static_cast<int64_t>(warp) * kItems * 32;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = wbase + k * 32 + lane;
    key[k] = i < hi ? p.key(i) : -1;
  }
  // The peers of every round first (independent ballots), then the ranks,
  // round after round, from the warp's running digit counts.
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    rank[k] = digit_peers(key[k] < 0 ? kNoDigit : p.digit(key[k]), p.bits);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned peers = rank[k];
    const int d = key[k] < 0 ? kNoDigit : p.digit(key[k]);
    const int cnt = d != kNoDigit ? wh[d] : 0;
    rank[k] = cnt + __popc(peers & lanes_below);
    __syncwarp();
    if (d != kNoDigit && lane == __ffs(peers) - 1)
      wh[d] = static_cast<unsigned short>(cnt + __popc(peers));
    __syncwarp();
  }
  __syncthreads();

  // Each warp's offset within its digit and the tile's digit counts; the
  // counts published at once, so that later tiles can look back.
  volatile unsigned* status = p.status;
  const int d = t;
  int tc = 0, total = 0;
  if (d < radix) {
    for (int w = 0; w < kWarps; ++w) {
      const int h = hist[w * radix + d];
      hist[w * radix + d] = static_cast<unsigned short>(tc);
      tc += h;
    }
    status[tile * radix + d] =
        static_cast<unsigned>(tc) | (tile == 0 ? kInclusive : kAggregate);
    total = p.digit_total[d];
  }
  const int start = block_exclusive_sum(tc, warp_sums);
  const int digit_base = block_exclusive_sum(total, warp_sums);
  if (d < radix) {
    tile_start[d] = start;
    // Decoupled look-back: add the counts of the tiles before, back to
    // the first that has published its inclusive count.
    unsigned excl = 0;
    bool done = tile == 0;
    for (int64_t q = tile - 1; !done; q -= kLookBack) {
      // kLookBack tiles' counts in flight at once, then added from the
      // nearest back to the first inclusive one.
      unsigned v[kLookBack];
#pragma unroll
      for (int u = 0; u < kLookBack; ++u)
        v[u] = q - u >= 0 ? static_cast<unsigned>(status[(q - u) * radix + d])
                          : kInclusive;
#pragma unroll
      for (int u = 0; u < kLookBack; ++u) {
        if (done) break;
        while (v[u] == 0u) v[u] = status[(q - u) * radix + d];
        excl += v[u] & kValueMask;
        done = (v[u] & kInclusive) != 0;
      }
    }
    if (tile > 0)
      status[tile * radix + d] = (excl + tc) | kInclusive;
    glob[d] = digit_base + static_cast<int>(excl);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (key[k] < 0) continue;
    const int d = p.digit(key[k]);
    const int q = tile_start[d] + wh[d] + rank[k];
    skey[q] = key[k];
    slot[q] = static_cast<unsigned short>(warp * kItems * 32 + k * 32 + lane);
  }
  if (pay_src != nullptr) __pipeline_wait_prior(0);
  __syncthreads();

  const int n = static_cast<int>(hi - base);
  for (int j = t; j < n; j += kThreads) {
    const int k = skey[j];
    const int d = p.digit(k);
    const int64_t dst = static_cast<int64_t>(glob[d]) + j - tile_start[d];
    p.keys_out[dst] = k;
    if constexpr (std::is_same<Pay, float2>::value)
      p.pay_out[dst] = stage[slot[j]];
    else
      p.pay_out[dst] = pay_src != nullptr ? stage[slot[j]]
                                          : static_cast<int>(base + slot[j]);
  }
}

template <typename Pay>
cudaError_t sort_passes(const int* idx, const float2* vals, int* keys_a,
                        Pay* pay_a, int* keys_b, Pay* pay_b,
                        unsigned* status, int* digit_total, int64_t m,
                        int rows, int bits, int passes, cudaStream_t s) {
  // Set up once per payload type, on the first call (callers warm up
  // before any CUDA graph capture): the pass kernel's shared memory above
  // 48 KB, and the SM count that sizes the histogram's grid.
  static bool ready = false;
  static int sms = 0;
  const int radix = 1 << bits;
  const size_t smem = onesweep_smem<Pay>(radix);
  if (!ready) {
    int device = 0;
    cudaError_t err = cudaFuncSetAttribute(
        radix_onesweep_kernel<Pay>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(onesweep_smem<Pay>(kMaxRadix)));
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int64_t n_tiles = (m + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(digit_total, 0,
                                    sizeof(int) * passes * radix, s);
  if (err != cudaSuccess) return err;
  radix_histogram_kernel<<<sms * 8, kThreads, 0, s>>>(idx, digit_total, m,
                                                      rows, bits, passes);
  err = cudaGetLastError();
  int* keys[2] = {keys_a, keys_b};
  Pay* pays[2] = {pay_a, pay_b};
  for (int k = 0; k < passes && err == cudaSuccess; ++k) {
    err = cudaMemsetAsync(status, 0,
                          sizeof(unsigned) * (n_tiles * radix + 1), s);
    if (err != cudaSuccess) break;
    const Pass<Pay> p{idx,
                      vals,
                      k == 0 ? nullptr : keys[(k + 1) & 1],
                      k == 0 ? nullptr : pays[(k + 1) & 1],
                      keys[k & 1],
                      pays[k & 1],
                      status,
                      digit_total + k * radix,
                      m,
                      n_tiles,
                      rows,
                      k * bits,
                      bits};
    radix_onesweep_kernel<Pay>
        <<<static_cast<unsigned int>(n_tiles), kThreads, smem, s>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

// start[r] = the first position of row r in the sorted keys, for r in
// [0, rows + 1]; start[rows + 1] = m. Position p writes the starts of the
// rows in (keys[p - 1], keys[p]] (position m: up to rows + 1). A thread
// takes 4 positions with one 16-byte load (keys is 16-byte aligned and
// padded to a multiple of 4).
__global__ void run_starts_kernel(const int* __restrict__ keys,
                                  int* __restrict__ start, int64_t m,
                                  int rows) {
  const int64_t p0 = 4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                          threadIdx.x);
  if (p0 > m) return;
  int k[4];
  if (p0 < m) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(keys + p0));
    k[0] = v.x, k[1] = v.y, k[2] = v.z, k[3] = v.w;
  }
  int prev = p0 == 0 ? -1 : __ldg(keys + p0 - 1);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t p = p0 + u;
    if (p > m) break;
    const int cur = p == m ? rows + 1 : k[u];
    for (int r = prev + 1; r <= cur; ++r) start[r] = static_cast<int>(p);
    prev = cur;
  }
}

// The value row of update q: W floats (W = 2: one float2 load).
template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ vals,
                                         int64_t q, float v[W]) {
  if constexpr (W == 2) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(vals) + q);
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = __ldg(vals + q * W + w);
  }
}

// Entry j of a run: the sorted value rows themselves (perm null), or the
// value row of update perm[j].
template <int W>
__device__ __forceinline__ void load_entry(const int* __restrict__ perm,
                                           const float* __restrict__ vals,
                                           int64_t j, float v[W]) {
  load_row<W>(vals, perm == nullptr ? j : __ldg(perm + j), v);
}

// One thread per row of at most kLongRun updates; a longer run's row is
// appended to long_rows (long_rows[0] the count, then the rows, in no set
// order: a warp sums each one in row_walk_long_kernel). W > 0: the width
// at compile time; W == 0: any width, one pass over the run per column.
template <int W>
__global__ void row_walk_kernel(const int* __restrict__ start,
                                const int* __restrict__ perm,
                                const float* __restrict__ vals,
                                float* __restrict__ out,
                                int* __restrict__ long_rows, int rows,
                                int width) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int lo = r <= rows ? __ldg(start + r) : 0;
  const int hi = r <= rows ? __ldg(start + r + 1) : 0;
  const bool is_long = hi - lo > kLongRun;
  const unsigned longs = __ballot_sync(kFull, is_long);
  if (longs != 0) {
    int base = 0;
    if (lane == __ffs(longs) - 1) base = atomicAdd(long_rows, __popc(longs));
    base = __shfl_sync(kFull, base, __ffs(longs) - 1);
    if (is_long)
      long_rows[1 + base + __popc(longs & ((1u << lane) - 1u))] =
          static_cast<int>(r);
  }
  if (r > rows || is_long) return;
  float* dst = out + r * width;
  if constexpr (W > 0) {
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    // Batches of kWalkUnroll entries: loaded, then added (the last batch
    // masked, not serial).
    for (int j = lo; j < hi; j += kWalkUnroll) {
      float v[kWalkUnroll][W];
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u)
        if (j + u < hi) load_entry<W>(perm, vals, j + u, v[u]);
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u)
        if (j + u < hi)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] = __fadd_rn(acc[w], v[u][w]);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) dst[w] = acc[w];
  } else {
    for (int w = 0; w < width; ++w) {
      float acc = 0.0f;
      for (int j = lo; j < hi; ++j)
        acc = __fadd_rn(acc, __ldg(vals + static_cast<int64_t>(
                                              __ldg(perm + j)) * width + w));
      dst[w] = acc;
    }
  }
}

// One warp per row that row_walk_kernel listed (the launch has a warp for
// as many rows as could be long; the spare warps return at once). The
// warp loads kFoldChunk entries a round trip, one a lane a round, into
// its shared buffer (two buffers: the next round trip's loads are issued
// before this one is folded) and lane 0 folds them in run order, so the
// time of a run is its chain of dependent adds, not its loads.
template <int W>
__global__ void __launch_bounds__(kThreads) row_walk_long_kernel(
    const int* __restrict__ start, const int* __restrict__ perm,
    const float* __restrict__ vals, float* __restrict__ out,
    const int* __restrict__ long_rows, int width) {
  constexpr int NW = W > 0 ? W : 1;
  __shared__ __align__(16) float buf[kWarps][2][kFoldChunk][NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  if (i >= long_rows[0]) return;
  const int64_t row = long_rows[1 + i];
  const int lo = __ldg(start + row), hi = __ldg(start + row + 1);
  for (int col = 0; col < (W > 0 ? 1 : width); ++col) {
    float acc[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] = 0.0f;
    float v[kFoldChunk / 32][NW];
    // Entries [c, c + kFoldChunk) of the run, one a lane a round.
    auto load = [&](int c) {
#pragma unroll
      for (int q = 0; q < kFoldChunk / 32; ++q) {
        const int j = c + q * 32 + lane;
        if (j >= hi) continue;
        if constexpr (W > 0)
          load_entry<W>(perm, vals, j, v[q]);
        else
          v[q][0] = __ldg(vals + static_cast<int64_t>(__ldg(perm + j)) *
                                     width + col);
      }
    };
    load(lo);
    int side = 0;
    for (int c = lo; c < hi; c += kFoldChunk, side ^= 1) {
#pragma unroll
      for (int q = 0; q < kFoldChunk / 32; ++q)
#pragma unroll
        for (int w = 0; w < NW; ++w)
          buf[warp][side][q * 32 + lane][w] = v[q][w];
      __syncwarp();
      if (c + kFoldChunk < hi) load(c + kFoldChunk);
      if (lane == 0) {
        const int n = min(kFoldChunk, hi - c);
        int k = 0;
        if constexpr (NW == 2) {   // two entries a 16-byte shared load
          const float4* b4 = reinterpret_cast<const float4*>(buf[warp][side]);
          for (; k + 2 <= n; k += 2) {
            const float4 e = b4[k / 2];
            acc[0] = __fadd_rn(acc[0], e.x);
            acc[1] = __fadd_rn(acc[1], e.y);
            acc[0] = __fadd_rn(acc[0], e.z);
            acc[1] = __fadd_rn(acc[1], e.w);
          }
        }
        for (; k < n; ++k)
#pragma unroll
          for (int w = 0; w < NW; ++w)
            acc[w] = __fadd_rn(acc[w], buf[warp][side][k][w]);
      }
      // The other buffer is written next; this one only after the fold.
      __syncwarp();
    }
    if (lane == 0) {
      float* dst = out + row * width;
      if constexpr (W > 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) dst[w] = acc[w];
      } else {
        dst[col] = acc[0];
      }
    }
  }
}

template <int W>
cudaError_t launch_walk(const int* start, const int* perm, const float* vals,
                        float* out, int* long_rows, int64_t m, int rows,
                        int width, cudaStream_t s) {
  const int64_t n_rows = int64_t{rows} + 1;
  cudaError_t err = cudaMemsetAsync(long_rows, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  row_walk_kernel<W><<<static_cast<unsigned int>(
                           (n_rows + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(start, perm, vals, out, long_rows,
                                         rows, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // A warp for each row that could be long: at most m / (kLongRun + 1).
  int64_t most = m / (kLongRun + 1);
  if (most > n_rows) most = n_rows;
  if (most == 0) return cudaSuccess;
  row_walk_long_kernel<W><<<static_cast<unsigned int>(
                                (most + kWarps - 1) / kWarps),
                            kThreads, 0, s>>>(start, perm, vals, out,
                                              long_rows, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code (0 = success).

// Stable sort of the keys clip(idx, 0, rows) in `passes` passes of
// `digit_bits` bits (rows < 2^(digit_bits * passes), digit_bits <= 7).
// With vals (float2 [m]), the payload is the value row; without, it is
// m (int32). keys_a/b: int32 [m]; pay_a/b: [m] of the payload; the passes
// alternate between a and b, starting with a, so the result is in a
// after an odd count of passes. status: uint32 [status_len] >=
// ceil(m / 4096) * 2^digit_bits + 1; digit_total: int32
// [passes * 2^digit_bits].
int row_accum_sort(const int* idx, const float* vals, int* keys_a,
                   void* pay_a, int* keys_b, void* pay_b, unsigned* status,
                   int64_t status_len, int* digit_total, int64_t m, int rows,
                   int digit_bits, int passes, void* stream) {
  if (rows < 0 || m < 0 || m > kValueMask || digit_bits < 1 ||
      digit_bits > kMaxBits || passes < 1 || passes > kMaxPasses ||
      (digit_bits * passes < 31 &&
       (int64_t{1} << (digit_bits * passes)) <= rows) ||
      status_len < ((m + kTile - 1) / kTile << digit_bits) + 1)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals != nullptr)
    return sort_passes<float2>(
        idx, reinterpret_cast<const float2*>(vals), keys_a,
        static_cast<float2*>(pay_a), keys_b, static_cast<float2*>(pay_b),
        status, digit_total, m, rows, digit_bits, passes, s);
  return sort_passes<int>(idx, nullptr, keys_a, static_cast<int*>(pay_a),
                          keys_b, static_cast<int*>(pay_b), status,
                          digit_total, m, rows, digit_bits, passes, s);
}

// start: int32 [rows + 2] from the sorted keys [m] (16-byte aligned,
// readable up to a multiple of 4).
int row_accum_starts(const int* keys, int* start, int64_t m, int rows,
                     void* stream) {
  if (rows < 0 || m < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0)  // every run is empty
    return cudaMemsetAsync(start, 0, sizeof(int) * (int64_t{rows} + 2), s);
  if (reinterpret_cast<uintptr_t>(keys) % 16 != 0)
    return cudaErrorInvalidValue;
  run_starts_kernel<<<static_cast<unsigned int>(m / (4 * kThreads) + 1),
                      kThreads, 0, s>>>(keys, start, m, rows);
  return cudaGetLastError();
}

// out: [rows + 1, width], every row written. perm null: vals are the
// value rows sorted by row (width 2); else vals [m, width] in update
// order and perm the sorted payload m. long_rows: int32 [rows + 2]
// scratch (the count and list of the long runs).
int row_accum_walk(const int* start, const int* perm, const float* vals,
                   float* out, int* long_rows, int64_t m, int rows, int width,
                   void* stream) {
  if (rows < 0 || m < 0 || width <= 0 ||
      (perm == nullptr && width != 2 && m > 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The grids' 2 features per level get their sums in registers and one
  // float2 load per update; any other width takes the column loop.
  return width == 2 ? launch_walk<2>(start, perm, vals, out, long_rows, m,
                                     rows, width, s)
                    : launch_walk<0>(start, perm, vals, out, long_rows, m,
                                     rows, width, s);
}

}  // extern "C"
