// segment_sum_seq: per-segment float32 sums of a sorted vector, each
// segment added left to right.
//
// Not a port of a TPU kernel.  The reference's fused step sums each
// flow's packet bytes with jax.ops.segment_sum over the sorted lanes,
// which XLA:CPU compiles to a scatter-add that visits the lanes one after
// another, so every segment is ((0 + v0) + v1) + ... rounded to f32 at
// each add.  On the raw48 wire a record's pkt_len goes up to 65535, so one
// flow's bytes in a 2048-record batch pass 2^24 and the f32 sum depends on
// its order; CUDA's index_add_ adds atomically in no fixed order, and an
// order-dependent, non-associative sum has no parallel torch formulation.
//
// Contract (ops/kernels.py segment_sum_seq checks the shapes): v is [b]
// f32, seg is [b] int64, non-decreasing and dense from 0 (segment ids
// 0..S-1 all present, S = seg[b-1] + 1), as the step's
// cumsum(run_heads) - 1 makes them; out is [n] f32 with n >= S.  Segments
// S..n-1 are empty and read 0.
//
// What bounds it on an H100: the longest segment's chain of dependent
// adds (4 cycles each), not bytes (b = 2048 moves 24 KB in and 8 KB out).
// A raw48 record is one packet, so a single-source flood makes one
// segment of the whole batch: 2,047 adds at B = 2048, ~4.1 us at
// 1.98 GHz.  The design keeps load latency off that chain:
// * one thread per lane; the lane that opens a segment of fewer than 32
//   lanes (the served batches' flows) walks it itself, eight lanes
//   loaded per round, summing with __fadd_rn (never contracted or
//   reordered); every lane loads its first round with its own id, so
//   one round trip both finds the heads and feeds the short walks;
// * a segment of 32 lanes or more is walked by a whole warp of its
//   head's block: each warp instruction loads 32 consecutive lanes of v
//   and seg (coalesced), 8 such chunks stay in flight in registers, a
//   ballot gives the chunk's lanes in the segment (a prefix: seg is
//   non-decreasing), and every lane adds the chunk's values in lane
//   order from shuffles, so the walk runs at the add's latency
//   whatever tile or block edge the segment crosses;
// * lanes at or past S zero the empty tail of out, so the wrapper needs
//   no separate fill.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // lanes per round of a thread's own walk
constexpr int kLong = 32;      // a segment this long is walked by a warp
constexpr int kDepth = 8;      // chunks of 32 lanes a walking warp holds
constexpr unsigned kAll = 0xffffffffu;

// Lanes j .. j + kUnroll - 1 of seg and v (-1 and 0 past b).
__device__ __forceinline__ void load_round(const float* __restrict__ v,
                                           const long long* __restrict__ seg,
                                           long long b, long long j,
                                           long long (&sj)[kUnroll],
                                           float (&vj)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = j + u < b;
    sj[u] = in ? __ldg(seg + j + u) : -1;
    vj[u] = in ? __ldg(v + j + u) : 0.0f;
  }
}

// The segment s opened at lane i, shorter than kLong, walked by the
// calling thread alone; sj and vj hold its first round (lanes i ..).
__device__ __forceinline__ void thread_walk(const float* __restrict__ v,
                                            const long long* __restrict__ seg,
                                            long long b, long long i,
                                            long long s,
                                            float* __restrict__ out,
                                            long long (&sj)[kUnroll],
                                            float (&vj)[kUnroll]) {
  float acc = 0.0f;
  for (long long j = i;; j += kUnroll) {
    if (j != i) load_round(v, seg, b, j, sj, vj);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (sj[u] != s) {   // seg is non-decreasing: the segment has ended
        out[s] = acc;
        return;
      }
      acc = __fadd_rn(acc, vj[u]);
    }
  }
}

// The segment opened at lane h, walked by the calling warp (all 32
// lanes, converged); lane 0 writes its sum.  `buf` is the warp's 64
// floats of shared memory: two chunks, one being added while the next
// is staged.
__device__ __forceinline__ void warp_walk(const float* __restrict__ v,
                                          const long long* __restrict__ seg,
                                          long long b, long long h,
                                          float* __restrict__ out,
                                          float* buf) {
  const int lane = threadIdx.x & 31;
  const long long s = __ldg(seg + h);
  // chunk c of the walk (lanes h + 32c ..) sits in ring slot c % kDepth
  float vr[kDepth];
  long long sr[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const long long j = h + d * 32 + lane;
    vr[d] = j < b ? __ldg(v + j) : 0.0f;
    sr[d] = j < b ? __ldg(seg + j) : -1;
  }
  // stage ring slot d into buffer half `half`, refill the slot with the
  // chunk kDepth further on (lanes from `next`); returns the chunk's
  // lanes in the segment (a prefix: seg is non-decreasing)
  auto stage = [&](int d, int half, long long next) {
    const unsigned in = __ballot_sync(kAll, sr[d] == s);
    buf[half * 32 + lane] = vr[d];
    const long long j = next + lane;
    vr[d] = j < b ? __ldg(v + j) : 0.0f;
    sr[d] = j < b ? __ldg(seg + j) : -1;
    __syncwarp();
    return in;
  };
  auto fetch = [&](int half, float4 (&x)[8]) {
    const float4* p = reinterpret_cast<const float4*>(buf + half * 32);
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = p[q];
  };
  auto add = [](float acc, const float4 (&x)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc = __fadd_rn(acc, x[q].x);
      acc = __fadd_rn(acc, x[q].y);
      acc = __fadd_rn(acc, x[q].z);
      acc = __fadd_rn(acc, x[q].w);
    }
    return acc;
  };
  float4 xa[8], xb[8];      // the even and the odd chunks' values
  float acc = 0.0f;
  unsigned in = stage(0, 0, h + kDepth * 32);
  fetch(0, xa);
  for (long long base = h;; base += kDepth * 32) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      // stage and fetch chunk d + 1 while chunk d is added
      const unsigned nin = stage((d + 1) % kDepth, (d + 1) & 1,
                                 base + (d + 1 + kDepth) * 32);
      fetch((d + 1) & 1, (d & 1) ? xa : xb);
      if (in == kAll) {
        acc = add(acc, (d & 1) ? xb : xa);
      } else {
        const int cnt = __popc(in);
        for (int u = 0; u < cnt; ++u) {
          acc = __fadd_rn(acc, buf[(d & 1) * 32 + u]);
        }
        if (lane == 0) out[s] = acc;
        return;
      }
      in = nin;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_seq_kernel(const float* __restrict__ v,
                       const long long* __restrict__ seg, long long b,
                       float* __restrict__ out, long long n) {
  __shared__ __align__(16) float walk_buf[kWarps][64];
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long n_seg = b > 0 ? __ldg(seg + b - 1) + 1 : 0;
  if (i >= n_seg && i < n) out[i] = 0.0f;
  // the lane's id and the first round of its walk, its left
  // neighbour's id and the one kLong - 1 lanes on, loaded together: one
  // round trip decides the walk and feeds a short one
  long long sj[kUnroll];
  float vj[kUnroll];
  load_round(v, seg, b, i, sj, vj);
  const long long s = sj[0];
  bool head = false, walks_long = false;
  if (i < b) {
    const long long left = i > 0 ? __ldg(seg + i - 1) : -1;
    const long long far = i + kLong - 1 < b ? __ldg(seg + i + kLong - 1)
                                            : -1;
    head = left != s;
    walks_long = head && far == s;
  }
  // a long segment's lanes span the warp, so a warp opens at most one
  const unsigned longs = __ballot_sync(kAll, walks_long);
  if (longs) {
    warp_walk(v, seg, b, i - (threadIdx.x & 31) + __ffs(longs) - 1, out,
              walk_buf[threadIdx.x >> 5]);
  }
  if (head && !walks_long) thread_walk(v, seg, b, i, s, out, sj, vj);
}

}  // namespace

extern "C" int fsx_segment_sum_seq(const void* v, const void* seg,
                                   long long b, void* out, long long n,
                                   void* stream) {
  const long long lanes = b > n ? b : n;
  if (lanes > 0) {
    const long long blocks = (lanes + kThreads - 1) / kThreads;
    segment_sum_seq_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(v), static_cast<const long long*>(seg), b,
        static_cast<float*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
