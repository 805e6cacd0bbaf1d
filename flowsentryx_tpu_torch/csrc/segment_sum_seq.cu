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
// Design: one thread per lane.  A lane that opens a segment walks it to
// its end, summing with __fadd_rn (never contracted or reordered), and
// writes the segment's total; lanes at or past S zero the empty tail of
// out, so the wrapper needs no separate fill.  The walk reads eight lanes
// at a time (their loads issued together, then added in order up to the
// segment's end), so the chain waits on one load per eight adds.  What
// bounds it on an H100 is the longest segment's serial chain of dependent
// adds (a single 2048-record flow is 2048 adds, 256 load rounds), not
// bytes: at b = 2048 it moves 24 KB in and 8 KB out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
segment_sum_seq_kernel(const float* __restrict__ v,
                       const long long* __restrict__ seg, long long b,
                       float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long n_seg = b > 0 ? __ldg(seg + b - 1) + 1 : 0;
  if (i >= n_seg && i < n) out[i] = 0.0f;
  if (i >= b) return;
  const long long s = __ldg(seg + i);
  if (i > 0 && __ldg(seg + i - 1) == s) return;   // not a segment head
  float acc = 0.0f;
  for (long long j = i;; j += kUnroll) {
    long long sj[kUnroll];
    float vj[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = j + u < b;
      sj[u] = in ? __ldg(seg + j + u) : -1;
      vj[u] = in ? __ldg(v + j + u) : 0.0f;
    }
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
