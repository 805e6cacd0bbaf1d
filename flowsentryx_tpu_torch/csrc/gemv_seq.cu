// gemv_seq: g^T M for g [N] and M [N, K] (K <= 8), each output summed
// row by row, one fused multiply-add per row, in row order.
//
// Not a TPU kernel.  It is the weight gradient of the int8 scorer's QAT
// epoch (train/qat.py qat_epoch: xq^T dL/dy over the training set), and
// it exists for the order of its sum: the reference's compiled backward
// computes that [N] x [N, 8] dot as one sequential FMA chain per output
// (acc = fma(g[n], M[n, k], acc) for n = 0 .. N-1; checked against the
// jitted dot at N up to 800,000).  A tree or blocked sum gives other
// bits, and in the quantized phase of QAT the weights' int8 codes flip on
// them: a port summing in torch's order left the reference's trajectory
// within two epochs of the phase switch and ended 10 codes away from the
// deployed artifact on the full 2,016,639-row recipe.
//
// What bounds it on an H100: the chain.  Each output is N dependent
// FMAs (4 cycles each), so at N = 2,016,639 the floor is ~4.1 ms at a
// 1.98 GHz clock, against
// 0.022 ms to move the 72.6 MB it reads.  The design keeps the chain fed
// and does nothing else: one block of 256 threads; all threads load the
// next tile of 512 rows (18 KB, coalesced) into the other half of a
// double buffer in shared memory while lanes 0..K-1 of warp 0 run their
// chains over the current tile from shared memory (the K lanes read K
// consecutive words of a row: no bank conflict).  Results below 2^-126
// are flushed to zero, as XLA:CPU flushes them (the plain version does
// the same).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;             // rows per tile
constexpr int kMaxK = 8;               // M's row width this build serves
constexpr float kTiny = 1.17549435e-38f;   // 2^-126

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  const float r = __fmaf_rn(a, b, c);
  return fabsf(r) < kTiny ? __fmul_rn(r, 0.0f) : r;
}

__global__ void __launch_bounds__(kThreads)
gemv_seq_kernel(const float* __restrict__ g, const float* __restrict__ m,
                long long n, int k, float* __restrict__ out) {
  __shared__ float ms[2][kTile * kMaxK];
  __shared__ float gs[2][kTile];
  const int t = threadIdx.x;
  const long long tiles = (n + kTile - 1) / kTile;
  constexpr int kPerThread = kTile * kMaxK / kThreads;   // 16 words of M
  constexpr int kGPerThread = kTile / kThreads;          // 2 words of g
  float acc = 0.0f;

  // tile 0 into buffer 0
  if (tiles > 0) {
    const long long rows = n < kTile ? n : kTile;
    for (int u = 0; u < kPerThread; ++u) {
      const int w = t + u * kThreads;
      if (w < rows * k) ms[0][w] = __ldg(m + w);
    }
    for (int u = 0; u < kGPerThread; ++u) {
      const int r = t + u * kThreads;
      if (r < rows) gs[0][r] = __ldg(g + r);
    }
  }
  __syncthreads();
  for (long long tile = 0; tile < tiles; ++tile) {
    const int cur = static_cast<int>(tile & 1);
    const long long base = tile * kTile;
    const long long rows = n - base < kTile ? n - base : kTile;
    // the next tile's loads, in flight while the chain runs
    const long long nbase = base + kTile;
    const long long nrows = nbase < n ? (n - nbase < kTile ? n - nbase
                                                            : kTile) : 0;
    float mv[kPerThread], gv[kGPerThread];
    for (int u = 0; u < kPerThread; ++u) {
      const int w = t + u * kThreads;
      mv[u] = w < nrows * k ? __ldg(m + nbase * k + w) : 0.0f;
    }
    for (int u = 0; u < kGPerThread; ++u) {
      const int r = t + u * kThreads;
      gv[u] = r < nrows ? __ldg(g + nbase + r) : 0.0f;
    }
    if (t < k) {
      const float* mrow = ms[cur] + t;
      const float* grow = gs[cur];
      int r = 0;
      for (; r + 8 <= rows; r += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc = fma_ftz(grow[r + u], mrow[(r + u) * k], acc);
        }
      }
      for (; r < rows; ++r) acc = fma_ftz(grow[r], mrow[r * k], acc);
    }
    if (nrows > 0) {
      for (int u = 0; u < kPerThread; ++u) ms[cur ^ 1][t + u * kThreads] = mv[u];
      for (int u = 0; u < kGPerThread; ++u) gs[cur ^ 1][t + u * kThreads] = gv[u];
    }
    __syncthreads();
  }
  if (t < k) out[t] = acc;
}

}  // namespace

// g: [n] f32, m: [n, k] f32 row-major (k <= 8), out: [k] f32.
extern "C" int fsx_gemv_seq(const void* g, const void* m, long long n, int k,
                            void* out, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  gemv_seq_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(m), n, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
