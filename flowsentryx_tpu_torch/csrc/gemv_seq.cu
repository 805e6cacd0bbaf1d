// gemv_seq: g^T M for S shards at once, g [S, R] and M [S, R, K]
// (K <= 8) -> [S, K], each output summed row by row, one fused
// multiply-add per row, in row order.
//
// Not a TPU kernel.  It is the weight gradient of the int8 scorer's QAT
// epoch (train/qat.py qat_epoch: xq^T dL/dy over the training set; the
// data-parallel epoch's S shards in one launch), and it exists for the
// order of its sum: the reference's compiled backward computes that
// [N] x [N, 8] dot as one sequential FMA chain per output
// (acc = fma(g[n], M[n, k], acc) for n = 0 .. N-1; checked against the
// jitted dot at N up to 800,000).  A tree or blocked sum gives other
// bits, and in the quantized phase of QAT the weights' int8 codes flip on
// them: a port summing in torch's order left the reference's trajectory
// within two epochs of the phase switch and ended 10 codes away from the
// deployed artifact on the full 2,016,639-row recipe.  XLA:CPU runs it
// with denormal inputs and results flushed to zero (DAZ and FTZ), a
// result's tininess judged after rounding.
//
// What bounds it on an H100: the chain.  Each output is R dependent
// FMAs, so the floor is R x the FFMA latency (4 cycles): ~4.1 ms at
// R = 2,016,639 and a 1.98 GHz clock, against 0.022 ms to move the
// 72.6 MB it reads.  The design keeps nothing on the chain but the FMA:
// * the step is one native fma.rn.ftz.f32 (inline PTX, this source
//   only), which flushes denormal inputs and results as XLA:CPU does;
// * its operands come from registers: warps 1..3 copy 1024-row tiles
//   into a ring of 4 stages in shared memory with 4-byte cp.async
//   (M transposed to [K][rows], any alignment), each stage's arrival
//   an mbarrier that the copies' completion triggers; lanes 0..K-1 of
//   warp 0 run the K chains, loading the next 16 rows' g and M[., k]
//   (float4s) while the current 16 are consumed, and free a stage with
//   an mbarrier of their own.  No block-wide barrier after the set-up;
// * one block per shard, each on its own SM, so the data-parallel
//   epoch's S independent chains run side by side in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;          // M's row width this build serves
constexpr int kProducerWarps = 3;
constexpr int kThreads = 32 * (1 + kProducerWarps);
constexpr int kStages = 4;
constexpr int kTile = 1024;       // rows per stage
constexpr int kGroup = 16;        // rows a chain lane holds in registers
constexpr int kRowsAlloc = kTile + kGroup;    // room for a look-ahead
constexpr int kLd = kRowsAlloc + 4;           // M^T row stride (floats):
                                              // 4-aligned, conflict-free
__host__ __device__ constexpr int stage_floats(int k) {
  return kRowsAlloc + k * kLd;
}
__host__ __device__ constexpr size_t smem_bytes(int k) {
  return 2 * kStages * sizeof(uint64_t)
         + static_cast<size_t>(kStages) * stage_floats(k) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Completes when this thread's earlier cp.asyncs have landed; counted
// in the barrier's expected arrivals (noinc).
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// The chain's step: denormal inputs and a denormal result flushed to a
// sign-preserving zero.
__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

template <int K>
struct Stage {
  float* g;   // [kRowsAlloc]
  float* m;   // [K][kLd]: M transposed
};

template <int K>
__device__ __forceinline__ Stage<K> stage(float* base, int s) {
  float* p = base + s * stage_floats(K);
  return {p, p + kRowsAlloc};
}

constexpr int kQ = kGroup / 4;

__device__ __forceinline__ void load_group(const float* gs, const float* mk,
                                           int j, float4 (&g)[kQ],
                                           float4 (&m)[kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    g[q] = *reinterpret_cast<const float4*>(gs + j + 4 * q);
    m[q] = *reinterpret_cast<const float4*>(mk + j + 4 * q);
  }
}

__device__ __forceinline__ float chain_group(float acc, const float4 (&g)[kQ],
                                             const float4 (&m)[kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    acc = fma_ftz(g[q].x, m[q].x, acc);
    acc = fma_ftz(g[q].y, m[q].y, acc);
    acc = fma_ftz(g[q].z, m[q].z, acc);
    acc = fma_ftz(g[q].w, m[q].w, acc);
  }
  return acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
gemv_seq_kernel(const float* __restrict__ g, const float* __restrict__ m,
                long long r, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* ring = reinterpret_cast<float*>(smem + 2 * kStages * sizeof(uint64_t));
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const long long shard = blockIdx.x;
  const float* gp = g + shard * r;
  const float* mp = m + shard * r * K;
  const long long tiles = (r + kTile - 1) / kTile;

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32 * kProducerWarps);
      mbar_init(&empty[s], 1);
    }
  }
  __syncthreads();

  if (warp > 0) {
    // producers: fill stage (tile % kStages) once the chains freed it
    const int p = t - 32;
    constexpr int kP = 32 * kProducerWarps;
    for (long long tile = 0; tile < tiles; ++tile) {
      const int s = static_cast<int>(tile % kStages);
      mbar_wait(&empty[s], static_cast<uint32_t>((tile / kStages) & 1) ^ 1u);
      const long long base = tile * kTile;
      const int rows = static_cast<int>(r - base < kTile ? r - base : kTile);
      const Stage<K> st = stage<K>(ring, s);
      for (int i = p; i < rows; i += kP) copy4(st.g + i, gp + base + i);
      const float* src = mp + base * K;
      for (int i = p; i < rows * K; i += kP) {
        const int row = i / K, col = i - row * K;
        copy4(st.m + col * kLd + row, src + i);
      }
      mbar_arrive_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  if (lane >= K) return;

  // lanes 0..K-1 of warp 0: chain `lane` over every row, in row order
  constexpr uint32_t kMask = (1u << K) - 1u;
  float acc = 0.0f;
  for (long long tile = 0; tile < tiles; ++tile) {
    const int s = static_cast<int>(tile % kStages);
    mbar_wait(&full[s], static_cast<uint32_t>((tile / kStages) & 1));
    const long long base = tile * kTile;
    const int rows = static_cast<int>(r - base < kTile ? r - base : kTile);
    const Stage<K> st = stage<K>(ring, s);
    const float* mk = st.m + lane * kLd;
    const int paired = rows & ~(2 * kGroup - 1);
    float4 ga[kQ], ma[kQ], gb[kQ], mb[kQ];
    load_group(st.g, mk, 0, ga, ma);
    for (int j = 0; j < paired; j += 2 * kGroup) {
      load_group(st.g, mk, j + kGroup, gb, mb);
      acc = chain_group(acc, ga, ma);
      load_group(st.g, mk, j + 2 * kGroup, ga, ma);   // < kRowsAlloc
      acc = chain_group(acc, gb, mb);
    }
    for (int j = paired; j < rows; ++j) acc = fma_ftz(st.g[j], mk[j], acc);
    __syncwarp(kMask);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  out[shard * K + lane] = acc;
}

template <int K>
int launch(const float* g, const float* m, long long s, long long r,
           float* out, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemv_seq_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(K)));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  gemv_seq_kernel<K><<<static_cast<unsigned>(s), kThreads, smem_bytes(K),
                       stream>>>(g, m, r, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: [s, r] f32, m: [s, r, k] f32 row-major (1 <= k <= 8), out: [s, k]
// f32; one block per shard.
extern "C" int fsx_gemv_seq(const void* g, const void* m, long long s,
                            long long r, int k, void* out, void* stream) {
  if (k < 1 || k > kMaxK || s < 0 || s > 0x7fffffffLL || r < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0) return static_cast<int>(cudaGetLastError());
  const float* gf = static_cast<const float*>(g);
  const float* mf = static_cast<const float*>(m);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(gf, mf, s, r, o, st);
    case 2: return launch<2>(gf, mf, s, r, o, st);
    case 3: return launch<3>(gf, mf, s, r, o, st);
    case 4: return launch<4>(gf, mf, s, r, o, st);
    case 5: return launch<5>(gf, mf, s, r, o, st);
    case 6: return launch<6>(gf, mf, s, r, o, st);
    case 7: return launch<7>(gf, mf, s, r, o, st);
    default: return launch<8>(gf, mf, s, r, o, st);
  }
}
