// table_summary: one pass over the device state table for the report.
//
// Replaces the Pallas TPU kernel flowsentryx_tpu/ops/pallas_kernels.py
// _table_summary_device / _summary_kernel (pallas_call at :166; wrapper
// table_summary at :219).  Over N rows it counts tracked rows (key != 0),
// blocked rows (blocked_until > now) and stale rows (now - last_seen >
// stale_s), all among tracked rows, and takes the max last_seen over
// tracked rows.
//
// What bounds it on an H100: device-memory bytes at sector granularity,
// and the latency of reaching them.  Every key is read (4 B/row); the two
// state words it needs are read only for tracked rows, straight out of
// the [N, 12] f32 state with its row stride (no column copy, which would
// be a second pass).  LAST_SEEN sits at byte 0 and BLOCKED_UNTIL at byte
// 44 of a 48-byte row, in two different 32-byte sectors, and neighbouring
// rows share sectors, so a half-full table touches most of the state's
// sectors while a sparse one touches few.  A whole-row stream (TMA or
// cp.async) would move 52 B/row, 16.3 us for 2^20 rows at 3.35 TB/s at
// every occupancy; skipping untracked rows beats it on a half-full table
// and, on a sparse one (0.5 % tracked), reads little more than the keys.
// What the design does about latency:
//
// * A warp takes steps of two tiles of 128 consecutive rows.  Lane l
//   reads the keys of rows 4l..4l+3 of each tile as one 16-byte load
//   (both tiles' keys in flight at once).  Four ballots per tile give
//   every lane the tile's tracked bits, so the state loads can be laid
//   out differently from the keys: lane l takes rows 32i + l (i < 4) of
//   each tile, and each state load instruction of the warp covers 32
//   consecutive rows (a contiguous 1.5 KB).  Every state load the keys
//   ask for (LAST_SEEN and BLOCKED_UNTIL of each tracked row, predicated
//   __ldg) is issued before any is consumed: up to 16 in flight per lane.
//   (Eight consecutive rows per thread for the state loads as well was
//   measured slower on a half-full table: each of its load instructions
//   touched 32 different 128-byte lines.)
// * As many 256-thread blocks as are resident at once (occupancy queried
//   once per device), no more than there is work; a grid-stride loop
//   takes any larger N.
// * Per-thread register counters, a warp-shuffle reduction, one shared
//   memory combine per block, then one integer atomicAdd per count and one
//   atomicMax per block.
//
// Exactness: the counts are integers at any N (the reference needed its
// int32 lane-sum argument because it accumulated in f32; here it holds by
// construction).  last_seen is a stream time >= 0 (decoded timestamps
// are non-negative), and for non-negative IEEE floats the bit patterns
// read as signed ints order exactly as the floats do, so the max is an
// atomicMax on the int pattern.  Any N works: rows past N read as
// untracked keys and are never dereferenced in the state.  The key column
// must start on a 16-byte boundary (the wrapper checks it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                  // rows per tile: 4 per lane
constexpr int kTiles = 2;                   // tiles per warp step
constexpr int kStepRows = kTile * kTiles;
constexpr int kColLastSeen = 0;
constexpr int kColBlockedUntil = 11;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// Keys of rows r..r+3 (r a multiple of 4): one 16-byte load, or scalar
// loads for the last partial group; rows at or past n read as 0.
__device__ __forceinline__ uint4 load_keys(const uint32_t* key, long long r,
                                           long long n) {
  if (r + 4 <= n) return __ldg(reinterpret_cast<const uint4*>(key + r));
  uint4 k = make_uint4(0u, 0u, 0u, 0u);
  if (r < n) k.x = __ldg(key + r);
  if (r + 1 < n) k.y = __ldg(key + r + 1);
  if (r + 2 < n) k.z = __ldg(key + r + 2);
  return k;
}

__global__ void __launch_bounds__(kThreads)
table_summary_kernel(const uint32_t* __restrict__ key,
                     const float* __restrict__ state, long long n,
                     long long row_stride, float now, float stale_s,
                     unsigned long long* __restrict__ counts,
                     int* __restrict__ newest_bits) {
  unsigned int tracked = 0, blocked = 0, stale = 0;
  float newest = 0.0f;
  const int lane = threadIdx.x & 31;
  const long long steps = (n + kStepRows - 1) / kStepRows;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long s = (static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x) >> 5;
       s < steps; s += warps) {
    const long long base = s * kStepRows;
    uint4 k[kTiles];
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
      k[t] = load_keys(key, base + t * kTile + 4 * lane, n);
    // Row 32 i + l of a tile was read by lane 8 i + l / 4 as component
    // l % 4, so lane l needs bit 8 i + l / 4 of that component's ballot.
    unsigned word[kTiles];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      tracked += (k[t].x != 0u) + (k[t].y != 0u) + (k[t].z != 0u)
                 + (k[t].w != 0u);
      const unsigned b0 = __ballot_sync(kFull, k[t].x != 0u);
      const unsigned b1 = __ballot_sync(kFull, k[t].y != 0u);
      const unsigned b2 = __ballot_sync(kFull, k[t].z != 0u);
      const unsigned b3 = __ballot_sync(kFull, k[t].w != 0u);
      const int c = lane & 3;
      word[t] = c == 0 ? b0 : c == 1 ? b1 : c == 2 ? b2 : b3;
    }
    // every load the keys ask for, before any is consumed
    float seen[kTiles][4], until[kTiles][4];
    unsigned on = 0;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        seen[t][i] = 0.0f;
        until[t][i] = 0.0f;
        if ((word[t] >> (8 * i + (lane >> 2))) & 1u) {
          on |= 1u << (4 * t + i);
          const float* row = state + (base + t * kTile + 32 * i + lane)
                                     * row_stride;
          seen[t][i] = __ldg(row + kColLastSeen);
          until[t][i] = __ldg(row + kColBlockedUntil);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((on >> (4 * t + i)) & 1u) {
          blocked += until[t][i] > now;
          stale += (now - seen[t][i]) > stale_s;
          newest = fmaxf(newest, seen[t][i]);
        }
      }
    }
  }
  // warp reduction
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tracked += __shfl_down_sync(kFull, tracked, off);
    blocked += __shfl_down_sync(kFull, blocked, off);
    stale += __shfl_down_sync(kFull, stale, off);
    newest = fmaxf(newest, __shfl_down_sync(kFull, newest, off));
  }
  __shared__ unsigned int s_cnt[3][kWarps];
  __shared__ float s_new[kWarps];
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_cnt[0][warp] = tracked;
    s_cnt[1][warp] = blocked;
    s_cnt[2][warp] = stale;
    s_new[warp] = newest;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0, bl = 0, st = 0;
    float nw = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      t += s_cnt[0][w];
      bl += s_cnt[1][w];
      st += s_cnt[2][w];
      nw = fmaxf(nw, s_new[w]);
    }
    if (t) {
      atomicAdd(&counts[0], t);
      atomicAdd(&counts[1], bl);
      atomicAdd(&counts[2], st);
      atomicMax(newest_bits, __float_as_int(nw));
    }
  }
}

// Resident blocks the card holds (SMs x blocks per SM), once per device.
int resident_blocks() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, table_summary_kernel, kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// key: 16-byte aligned.  counts: [3] int64 zero-filled by the caller;
// newest_bits: [1] int32 zero-filled (0 is the bit pattern of 0.0f, the
// empty-table answer).
extern "C" int fsx_table_summary(const void* key, const void* state,
                                 long long n, long long row_stride,
                                 float now, float stale_s, void* counts,
                                 void* newest_bits, void* stream) {
  if (n > 0) {
    const int cap = resident_blocks();
    if (cap == 0) {
      const cudaError_t e = cudaGetLastError();
      return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidDevice);
    }
    const long long want = ((n + kStepRows - 1) / kStepRows + kWarps - 1)
                           / kWarps;
    const int blocks = static_cast<int>(want < cap ? want : cap);
    table_summary_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(key), static_cast<const float*>(state),
        n, row_stride, now, stale_s,
        static_cast<unsigned long long*>(counts),
        static_cast<int*>(newest_bits));
  }
  return static_cast<int>(cudaGetLastError());
}
