// The serial-order route of the table gradients (K2 and K3 in the TPU
// kernels' serial order) for Hopper (sm_90a): kernel B's serial mode
// (grid_encode.cu: grid_encode_bwd_sort) and the serial mode of the
// TensoVM and tri-plane backward, D's and U's (tensovm_encode.cu:
// tensovm_encode_bwd_sort, triplane_encode_bwd_sort). Each of those files
// includes this header and gives it a producer; coslam_torch/ops/
// serial_scatter.py:SerialSort drives it, then the run bounds and kernel
// H's walk (row_accum.cu) sum the sorted output.
//
// The contract (the TPU's serial loops): every table row is summed from
// 0.0f in increasing plain-order update index m with round-to-nearest f32
// adds, so the table gradient has the same bits on every run and equals
// the host's plain version. What fixes a row's sum is only the order of
// the updates to that row.
//
// Segments. The rows of a table fall into disjoint segments that no update
// crosses: a level of the packed grid (its corner pair (e, e + 1) stays in
// the level), one plane section of the TensoVM or tri-plane table, and
// TensoVM's line table. Inside a segment the updates are numbered in an
// order that keeps the plain order of every row's updates (the producer's
// order, serial_scatter.py:segment_plan and each module's serial_order):
// a stable sort of each segment by its local row key is then, element for
// element, a stable sort of the plain update stream.
//
// What bounds it on this card: bytes. The route moves (key, value) pairs
// of 12 bytes through two radix passes and does little arithmetic. Its
// design cuts the bytes the former route (the encode kernel writing the
// whole 12-byte update stream, then kernel H sorting it in 3 passes of 7
// bits) moved:
//  - no update stream: the first pass computes each update's local key
//    and value from x, the cotangent and the tables where it needs them
//    (producer.produce), in the segment's order, and the histogram each
//    point's keys (producer.unit_keys), so they read ~25 MB (and L2 ten
//    times that) where the stream was 270 MB written and read again;
//  - local keys: a segment has at most 2^17 rows at room0 (a hashed level,
//    a 311-plane), so 2 passes of at most 9-bit digits cover the keys that
//    took 3 passes of 7 (the Dense grid's 401^3 level: 3 passes); each pass
//    has its own digit width (serial_scatter.py:segment_plan);
//  - the cotangent [N, L, 2] is first staged level-major ([L, N, 2]), so
//    the first pass reads it with coalesced loads, not one sector a lane;
//  - each pass is H's onesweep form over 4,096-update tiles that never
//    straddle a segment (a tile's padding slots take kNoDigit): a block
//    takes the next tile by ticket, ranks its keys warp by warp with one
//    ballot per digit bit, publishes its digit counts and looks back over
//    the earlier tiles of its own segment only (the segment's first tile
//    publishes its counts as inclusive at once), lays the tile out by digit
//    in shared memory and writes each digit's run coalesced;
//  - the last pass writes each key as its global row (segment start +
//    local key), so its output is sorted by row; row_accum.cu's
//    row_accum_bounds gives every non-empty row's run [start, end) from it,
//    and H's walk sums each run.
// Launching the passes over groups of segments that fit the 50 MB L2 (one
// or two levels of B, 17-34 MB), with one group-sized intermediate buffer
// that every group reuses, was slower on an H100 at every group size tried
// (B serial 1.4-1.9 ms against 1.0-1.3 ms in one launch): a group has
// fewer tiles than the card holds at once.
// Stability: the first pass ranks the tile's updates in segment order
// (warp, round, lane) and tiles run in ticket order, as in H.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace serial {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // updates per thread per tile
constexpr int kTile = kThreads * kItems;      // 4,096
constexpr int kMaxBits = 9;                   // 512 digits, 2 per thread
constexpr int kMaxRadix = 1 << kMaxBits;
constexpr int kPerThread = kMaxRadix / kThreads;
constexpr int kMaxPasses = 4;                 // 36 bits
constexpr int kBlocksPerSM = 3;               // 68 KB of shared memory each
constexpr int kLookBack = 4;                  // tiles' counts read at once
constexpr int kHistUnits = 2048;              // units per histogram block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoDigit = -1;
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kInclusive = 2u << 30;
constexpr unsigned kValueMask = kAggregate - 1u;

// The segment table, int32 [4, n + 1] (on the card, and a copy on the
// host): each segment's first row, its update count, its first tile and its
// first position in the sorted output; entry n of the last two rows is the
// total.
struct Segments {
  const int* t;
  int n;

  __host__ __device__ int at(int row, int s) const {
    return t[row * (n + 1) + s];
  }
  __device__ int lo(int s) const { return __ldg(t + s); }
  __device__ int count(int s) const { return __ldg(t + (n + 1) + s); }
  __device__ int tile0(int s) const { return __ldg(t + 2 * (n + 1) + s); }
  __device__ int base(int s) const { return __ldg(t + 3 * (n + 1) + s); }
};

// The lanes whose digit (`bits` bits, or kNoDigit) equals this lane's: one
// ballot per bit and one for kNoDigit (kernel H's digit_peers, 9 bits).
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

// Exclusive prefix sum of v over the block's threads (all must call).
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

// gt[l * n + i] = g[i * L + l] (float2 rows): the cotangent level-major. A
// block per 64 points, through shared memory (rows padded by one so the
// column reads spread over the banks).
__global__ void __launch_bounds__(kThreads) transpose_levels_kernel(
    const float2* __restrict__ g, float2* __restrict__ gt, int64_t n,
    int L) {
  extern __shared__ float2 buf[];   // [64, L + 1]
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * 64;
  const int rows = n - n0 < 64 ? static_cast<int>(n - n0) : 64;
  for (int j = threadIdx.x; j < rows * L; j += kThreads) {
    const int i = j / L;
    buf[i * (L + 1) + (j - i * L)] = g[n0 * L + j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows * L; j += kThreads) {
    const int l = j / rows, i = j - l * rows;
    gt[l * n + n0 + i] = buf[i * (L + 1) + l];
  }
}

// The digit width of pass k: nibble k of the packed widths.
__host__ __device__ __forceinline__ int pass_bits(int packed, int k) {
  return (packed >> (4 * k)) & 15;
}

// Every segment's digit counts of every pass, hist[(s * passes + pass) *
// kMaxRadix + d] (zeroed first). Counts do not depend on the order of the
// updates, so the histogram takes them point-major: block (c, s) takes
// units [c, c + 1) * kHistUnits of segment s (producer.units: a point, whose
// cell is found once for all its updates of the segment) and
// producer.unit_keys gives each unit's keys. Shared atomics count them, and
// the block adds its counts in with global atomics (an integer sum does not
// depend on the order of its adds).
template <class P>
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    P prod, Segments sg, int* __restrict__ hist, int packed, int passes) {
  __shared__ int h[kMaxPasses * kMaxRadix];
  const int s = blockIdx.y;
  const int64_t units = prod.units(s);
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kHistUnits;
  if (lo >= units) return;
  const int t = threadIdx.x;
  int shift[kMaxPasses], mask[kMaxPasses];
  for (int k = 0, sh = 0; k < kMaxPasses; ++k) {
    shift[k] = sh;
    mask[k] = (1 << pass_bits(packed, k)) - 1;
    sh += pass_bits(packed, k);
  }
  for (int j = t; j < passes * kMaxRadix; j += kThreads) h[j] = 0;
  __syncthreads();
  const int64_t hi = lo + kHistUnits < units ? lo + kHistUnits : units;
  for (int64_t u = lo + t; u < hi; u += kThreads)
    prod.unit_keys(s, u, [&](int key) {
      for (int k = 0; k < passes; ++k)
        atomicAdd(h + k * kMaxRadix + ((key >> shift[k]) & mask[k]), 1);
    });
  __syncthreads();
  int* dst = hist + static_cast<int64_t>(s) * passes * kMaxRadix;
  for (int j = t; j < passes * kMaxRadix; j += kThreads)
    if (h[j] != 0) atomicAdd(dst + j, h[j]);
}

// One pass over every tile.
struct Pass {
  const int* keys_in;        // later passes: the previous pass's output
  const float2* pay_in;
  int* keys_out;
  float2* pay_out;
  unsigned* status;          // [n_tiles, radix] published counts, then the
                             // tile ticket (zeroed before the pass)
  const int* hist;           // [n_segs, passes, kMaxRadix]
  Segments sg;
  int64_t n_tiles;
  int pass, passes, shift, bits;   // this pass's digit: bits from shift

  __device__ __forceinline__ int radix() const { return 1 << bits; }
  __device__ __forceinline__ int digit(int k) const {
    return (k >> shift) & (radix() - 1);
  }
  __device__ __forceinline__ bool last() const { return pass == passes - 1; }
};

inline size_t onesweep_smem() {
  return (sizeof(float2) + sizeof(int) + sizeof(unsigned short)) * kTile +
         sizeof(int) * (2 * kMaxRadix + kWarps + 2) +
         sizeof(unsigned short) * kWarps * kMaxRadix;
}

// One radix pass over one tile. kFirst: the producer computes the tile's
// keys and values in segment order; else they are read from the previous
// pass's output.
template <class P, bool kFirst>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    onesweep_kernel(P prod, Pass p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* stage = reinterpret_cast<float2*>(smem_raw);  // [kTile] in order
  int* skey = reinterpret_cast<int*>(stage + kTile);     // [kTile] by digit
  unsigned short* slot =                                 // [kTile] by digit
      reinterpret_cast<unsigned short*>(skey + kTile);
  int* tile_start = reinterpret_cast<int*>(slot + kTile);  // [kMaxRadix]
  int* glob = tile_start + kMaxRadix;                    // [kMaxRadix]
  int* scratch = glob + kMaxRadix;   // [kWarps] scan, ticket, segment
  unsigned short* whist =                                // [kWarps, radix]
      reinterpret_cast<unsigned short*>(scratch + kWarps + 2);
  const int radix = p.radix();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) {
    const int64_t ticket = atomicAdd(p.status + p.n_tiles * radix, 1u);
    // The segment of the tile: the last whose first tile is not after it.
    int a = 0, b = p.sg.n - 1;
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (p.sg.tile0(mid) <= ticket) a = mid; else b = mid - 1;
    }
    scratch[kWarps] = static_cast<int>(ticket);
    scratch[kWarps + 1] = a;
  }
  for (int j = t; j < kWarps * radix / 2; j += kThreads)
    reinterpret_cast<unsigned*>(whist)[j] = 0u;
  __syncthreads();
  const int64_t tile = scratch[kWarps];
  const int s = scratch[kWarps + 1];
  const int64_t first = p.sg.tile0(s);
  const int64_t i0 = (tile - first) * kTile;       // segment-local index
  const int n_items = static_cast<int>(
      p.sg.count(s) - i0 < kTile ? p.sg.count(s) - i0 : kTile);
  const int64_t pos0 = p.sg.base(s) + i0;          // global position

  // Later passes: the tile's values go to shared memory in order by
  // asynchronous 16-byte copies while the keys are ranked (counts are even,
  // so every tile starts 16-byte aligned).
  if (!kFirst) {
    const float2* src = p.pay_in + pos0;
    const int whole = n_items / 2;
    for (int c = t; c < whole; c += kThreads)
      __pipeline_memcpy_async(stage + 2 * c, src + 2 * c, 16);
    __pipeline_commit();
    if ((n_items & 1) && t == 0) stage[n_items - 1] = src[n_items - 1];
  }

  // Warp w ranks updates [512 w, 512 (w + 1)) of the tile, in order; key
  // -1 marks a slot past the segment's end.
  const int wbase = warp * kItems * 32;
  int key[kItems];
  if (kFirst) {
    // The producer is long: two items at a time, through shared memory.
#pragma unroll 2
    for (int k = 0; k < kItems; ++k) {
      const int local = wbase + k * 32 + lane;
      if (local < n_items) {
        float2 v;
        skey[local] = prod.template produce<true>(s, i0 + local, &v);
        stage[local] = v;
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int local = wbase + k * 32 + lane;
    key[k] = local >= n_items ? -1
             : kFirst        ? skey[local]
                             : __ldg(p.keys_in + pos0 + local);
  }
  unsigned rank[kItems];
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned short* wh = whist + warp * radix;
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

  // Thread t keeps digits 2t and 2t + 1: each warp's offset within the
  // digit, the tile's counts (published at once), the segment's totals.
  volatile unsigned* status = p.status;
  const bool seg_first = tile == first;
  const int* total = p.hist + (static_cast<int64_t>(s) * p.passes + p.pass) *
                                  kMaxRadix;
  int tc[kPerThread], tot[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int d = kPerThread * t + u;
    tc[u] = tot[u] = 0;
    if (d >= radix) continue;
    for (int w = 0; w < kWarps; ++w) {
      const int h = whist[w * radix + d];
      whist[w * radix + d] = static_cast<unsigned short>(tc[u]);
      tc[u] += h;
    }
    status[tile * radix + d] =
        static_cast<unsigned>(tc[u]) | (seg_first ? kInclusive : kAggregate);
    tot[u] = __ldg(total + d);
  }
  const int start = block_exclusive_sum(tc[0] + tc[1], scratch);
  const int digit_base = block_exclusive_sum(tot[0] + tot[1], scratch);
  const int seg_out = p.sg.base(s);
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int d = kPerThread * t + u;
    if (d >= radix) continue;
    tile_start[d] = start + (u ? tc[0] : 0);
    // Decoupled look-back over the segment's earlier tiles, back to the
    // first that has published its inclusive count.
    unsigned excl = 0;
    bool done = seg_first;
    for (int64_t q = tile - 1; !done; q -= kLookBack) {
      unsigned v[kLookBack];
#pragma unroll
      for (int b = 0; b < kLookBack; ++b)
        v[b] = q - b >= first
                   ? static_cast<unsigned>(status[(q - b) * radix + d])
                   : kInclusive;
#pragma unroll
      for (int b = 0; b < kLookBack; ++b) {
        if (done) break;
        while (v[b] == 0u) v[b] = status[(q - b) * radix + d];
        excl += v[b] & kValueMask;
        done = (v[b] & kInclusive) != 0;
      }
    }
    if (!seg_first) status[tile * radix + d] = (excl + tc[u]) | kInclusive;
    glob[d] = seg_out + digit_base + (u ? tot[0] : 0) +
              static_cast<int>(excl);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (key[k] < 0) continue;
    const int d = p.digit(key[k]);
    const int q = tile_start[d] + wh[d] + rank[k];
    skey[q] = key[k];
    slot[q] = static_cast<unsigned short>(wbase + k * 32 + lane);
  }
  if (!kFirst) __pipeline_wait_prior(0);
  __syncthreads();

  // The last pass writes the global row of each key.
  const int add = p.last() ? p.sg.lo(s) : 0;
  for (int j = t; j < n_items; j += kThreads) {
    const int k = skey[j];
    const int d = p.digit(k);
    const int64_t dst = static_cast<int64_t>(glob[d]) + j - tile_start[d];
    p.keys_out[dst] = k + add;
    p.pay_out[dst] = stage[slot[j]];
  }
}

// The arguments every serial entry point takes after its producer's (see
// serial_scatter.py:SerialSort.sort_args).
struct SortArgs {
  const int* segs;        // the segment table on the card
  const int* segs_host;   // and on the host
  int n_segs;
  int* keys_tmp[2];       // the intermediate passes' buffers, [m] each
  float2* pay_tmp[2];
  int* keys_out;          // the last pass's, [m]
  float2* pay_out;
  unsigned* status;       // [status_len]
  int64_t status_len;
  int* hist;              // [n_segs, passes, kMaxRadix]
  int packed_bits;        // pass k's digit width in nibble k
  int passes;
};

inline bool misaligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
}

// Checks the arguments against the segment table on the host.
inline cudaError_t check_args(const SortArgs& a) {
  if (a.n_segs < 1 || a.passes < 1 || a.passes > kMaxPasses ||
      a.segs == nullptr || a.segs_host == nullptr || misaligned16(a.pay_out) ||
      (a.passes > 1 && misaligned16(a.pay_tmp[0])) ||
      (a.passes > 2 && misaligned16(a.pay_tmp[1])))
    return cudaErrorInvalidValue;
  for (int k = 0; k < a.passes; ++k)
    if (pass_bits(a.packed_bits, k) < 1 ||
        pass_bits(a.packed_bits, k) > kMaxBits)
      return cudaErrorInvalidValue;
  const Segments sg{a.segs_host, a.n_segs};
  for (int s = 0; s < a.n_segs; ++s)
    if (sg.at(1, s) < 0 || sg.at(1, s) % 2 != 0 ||
        sg.at(1, s) > static_cast<int>(kValueMask))
      return cudaErrorInvalidValue;
  return static_cast<int64_t>(sg.at(2, a.n_segs)) * kMaxRadix + 1 >
                 a.status_len
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

// The histogram and the passes on stream st.
template <class P>
cudaError_t segmented_sort(const P& prod, const SortArgs& a,
                           cudaStream_t st) {
  cudaError_t err = check_args(a);
  if (err != cudaSuccess) return err;
  // Set once per producer, on the first call (callers warm up before any
  // CUDA graph capture): the pass kernels' shared memory above 48 KB.
  static bool ready = false;
  const size_t smem = onesweep_smem();
  if (!ready) {
    err = cudaFuncSetAttribute(onesweep_kernel<P, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(onesweep_kernel<P, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const Segments host{a.segs_host, a.n_segs}, sg{a.segs, a.n_segs};
  int64_t chunks = 1;
  for (int s = 0; s < a.n_segs; ++s) {
    const int64_t c = (prod.host_units(s) + kHistUnits - 1) / kHistUnits;
    if (c > chunks) chunks = c;
  }
  err = cudaMemsetAsync(a.hist, 0,
                        sizeof(int) * a.n_segs * a.passes * kMaxRadix, st);
  if (err != cudaSuccess) return err;
  histogram_kernel<P><<<dim3(static_cast<unsigned>(chunks), a.n_segs),
                        kThreads, 0, st>>>(prod, sg, a.hist, a.packed_bits,
                                           a.passes);
  err = cudaGetLastError();
  const int64_t n_tiles = host.at(2, a.n_segs);
  for (int k = 0, shift = 0; k < a.passes && err == cudaSuccess;
       shift += pass_bits(a.packed_bits, k++)) {
    const int bits = pass_bits(a.packed_bits, k);
    err = cudaMemsetAsync(a.status, 0,
                          sizeof(unsigned) * ((n_tiles << bits) + 1), st);
    if (err != cudaSuccess) break;
    const bool last = k == a.passes - 1;
    const Pass p{k == 0 ? nullptr : a.keys_tmp[(k - 1) & 1],
                 k == 0 ? nullptr : a.pay_tmp[(k - 1) & 1],
                 last ? a.keys_out : a.keys_tmp[k & 1],
                 last ? a.pay_out : a.pay_tmp[k & 1],
                 a.status,
                 a.hist,
                 sg,
                 n_tiles,
                 k,
                 a.passes,
                 shift,
                 bits};
    if (k == 0)
      onesweep_kernel<P, true><<<static_cast<unsigned>(n_tiles), kThreads,
                                 smem, st>>>(prod, p);
    else
      onesweep_kernel<P, false><<<static_cast<unsigned>(n_tiles), kThreads,
                                  smem, st>>>(prod, p);
    err = cudaGetLastError();
  }
  return err;
}

// The cotangent g [n, L, 2] level-major into gt [L, n, 2].
inline cudaError_t transpose_levels(const float* g, float* gt, int64_t n,
                                    int L, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  const size_t smem = sizeof(float2) * 64 * (L + 1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  transpose_levels_kernel<<<static_cast<unsigned>((n + 63) / 64), kThreads,
                            smem, st>>>(
      reinterpret_cast<const float2*>(g), reinterpret_cast<float2*>(gt), n,
      L);
  return cudaGetLastError();
}

}  // namespace serial
}  // namespace
