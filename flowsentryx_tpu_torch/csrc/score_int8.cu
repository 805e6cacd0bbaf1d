// score_int8: the serving classifier's int8 pipeline, eight lanes per row.
//
// Replaces the Pallas TPU kernel flowsentryx_tpu/ops/pallas_kernels.py
// score_int8 / _score_kernel (pallas_call at :101).  Per row of a [B, 8]
// f32 batch: optional log1p, quint8 input quantization (round half to
// even, clip 0..255), the K=8 int8 dot (q - zp) . w, dequant + bias,
// quint8 requant, and the quantized sigmoid on the 1/256 grid.
//
// What bounds it on an H100: the launch and the length of one thread's
// dependent chain, not bytes.  At the serving batch B=2048 it moves
// 2048 * (32 B in + 4 B out) = 72 KB, ~22 ns of HBM time at 3.35 TB/s,
// and K=8, N=1 leaves no matrix for the tensor cores.  The design makes
// the chain short and spreads it over the card:
//
// * Eight lanes per row, one per feature: lane t reads float t of the
//   batch, so a warp's 32 loads are one coalesced 128-byte line.  Each
//   lane runs one log1p, one division and one rint; the exact integer
//   dot is summed across the row's eight lanes with __shfl_xor_sync.
// * 128-thread blocks of 16 rows: 128 blocks at B=2048, on 128 SMs.
// * The output stage is a 256-entry table indexed by q_y, the only value
//   the sigmoid sees.  ops/kernels.py pack_score_params builds it once
//   with the plain version's own arithmetic on the params' device, so it
//   equals the plain version by construction; the group leader does one
//   fma, one division, one rint, a clip and the lookup (no expf and two
//   divisions fewer than a per-row sigmoid).
// * Parameters, weights and table travel by value in one
//   __grid_constant__ argument struct (1,060 B, in the constant bank): no
//   dependent first loads from global memory.  The weights are two packed
//   words read uniformly and unpacked in registers, so the eight lanes do
//   not make divergent constant-bank reads; the table is read by the four
//   leaders of a warp only (at most four addresses).
//
// Bit-exactness is the design constraint (the plain PyTorch version and
// the reference must agree to the bit).  Every rounding step is written
// with an explicit round-to-nearest intrinsic, which nvcc never contracts
// or reorders: true division (__fdiv_rn, never a reciprocal multiply),
// rintf for round half to even, and ONE fused multiply-add (__fmaf_rn)
// for acc * (in_scale * w_scale) + bias, which is how the reference's
// compiled graph rounds it.  The plain version flushes a subnormal y to
// zero (XLA:CPU does); the kernel does not, and for any out_scale >=
// 2^-125 both give rint(y / out_scale) = 0, so q_y is the same.
//
// The optional log1p is XLA:CPU's, not CUDA's log1pf: on the raw48 wire
// the scorer sees any float32, and log1pf differs from XLA's on a third
// of the values below 1.  xla_log1p below mirrors core/device.py
// xla_log1p operation for operation (the same roundings, each fused
// multiply-add one __fmaf_rn, the same flushes); fsx_xla_log1p exposes
// it elementwise so that it can be held to the plain version over every
// non-negative float32 on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 16 rows of 8 lanes
constexpr int kLanes = 8;
constexpr float kTiny = 1.17549435e-38f;   // 2^-126

// fma32 of core/device.py: one rounding, a result below 2^-126 flushed to
// a zero of its sign
__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  const float r = __fmaf_rn(a, b, c);
  return fabsf(r) < kTiny ? __fmul_rn(r, 0.0f) : r;
}

// core/device.py _log_positive: XLA:CPU's logf of u (u read with DAZ)
__device__ float xla_log_positive(float u) {
  const int bits = __float_as_int(fmaxf(u, kTiny));
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  float e = static_cast<float>((bits >> 23) - 126);
  const bool low = m < 0.707106769f;
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), low ? m : 0.0f);
  if (low) e = __fadd_rn(e, -1.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float y0 = fma_ftz(x, fma_ftz(x, 7.0376836292e-2f, -1.1514610310e-1f),
                           1.1676998740e-1f);
  const float y1 = fma_ftz(x, fma_ftz(x, -1.2420140846e-1f, 1.4249322787e-1f),
                           -1.6668057665e-1f);
  const float y2 = fma_ftz(x, fma_ftz(x, 2.0000714765e-1f, -2.4999993993e-1f),
                           3.3333331174e-1f);
  float y = fma_ftz(x3, fma_ftz(x3, y0, y1), y2);
  y = fma_ftz(x3, y, __fmul_rn(e, -2.12194440e-4f));
  const float r = fma_ftz(e, 0.693359375f,
                          __fadd_rn(fma_ftz(x2, -0.5f, x), y));
  if (u == 0.0f) return -INFINITY;
  if (u == INFINITY) return INFINITY;
  return u > 0.0f ? r : __int_as_float(-1);   // the all-ones NaN
}

// core/device.py xla_log1p: XLA:CPU's log1pf, bit for bit
__device__ float xla_log1p(float x) {
  if (fabsf(x) < kTiny) x = __fmul_rn(x, 0.0f);   // DAZ
  if (!(fabsf(x) < 0.414213568f)) return xla_log_positive(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float d = __fadd_rn(x, 1.5062909083469192043167e1f);
  d = fma_ftz(x, d, 8.3047565967967209469434e1f);
  d = fma_ftz(x, d, 2.2176239823732856465394e2f);
  d = fma_ftz(x, d, 3.0909872225312059774938e2f);
  d = fma_ftz(x, d, 2.1642788614495947685003e2f);
  d = fma_ftz(x, d, 6.0118660497603843919306e1f);
  float n = fma_ftz(x, 4.5270000862445199635215e-5f,
                    4.9854102823193375972212e-1f);
  n = fma_ftz(x, n, 6.5787325942061044846969e0f);
  n = fma_ftz(x, n, 2.9911919328553073277375e1f);
  n = fma_ftz(x, n, 6.0949667980987787057556e1f);
  n = fma_ftz(x, n, 5.7112963590585538103336e1f);
  n = fma_ftz(x, n, 2.0039553499201281259648e1f);
  const float t = fma_ftz(x2, -0.5f,
                          __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(n, d)));
  return __fadd_rn(x, t);
}

// Mirrored by ops/kernels.py _ScoreArgs (checked by fsx_score_args_size).
struct ScoreArgs {
  float in_scale, in_zp, s, bias, out_scale, out_zp;  // s = in_scale*w_scale
  int log1p;
  uint32_t w_lo, w_hi;   // the 8 int8 weights, little-endian bytes
  float table[256];      // score for each output code q_y
};

__device__ __forceinline__ float clip_u8(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
score_int8_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long b, const __grid_constant__ ScoreArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long row = t / kLanes;
  const int k = static_cast<int>(t % kLanes);
  int prod = 0;
  if (row < b) {
    float v = __ldg(x + t);
    if (a.log1p) v = xla_log1p(v);
    const float q = clip_u8(__fadd_rn(rintf(__fdiv_rn(v, a.in_scale)),
                                      a.in_zp));
    const uint32_t word = k < 4 ? a.w_lo : a.w_hi;
    const int w = static_cast<int8_t>((word >> (8 * (k & 3))) & 0xffu);
    prod = (static_cast<int>(q) - static_cast<int>(a.in_zp)) * w;
  }
  // (q_x - zp) . w over the row's 8 lanes: |acc| < 2^18, exact in int32.
  // Every lane of the warp takes part (rows past b add zeros).
  prod += __shfl_xor_sync(0xffffffffu, prod, 4);
  prod += __shfl_xor_sync(0xffffffffu, prod, 2);
  prod += __shfl_xor_sync(0xffffffffu, prod, 1);
  if (k == 0 && row < b) {
    const float y = __fmaf_rn(static_cast<float>(prod), a.s, a.bias);
    const float q_y = clip_u8(__fadd_rn(rintf(__fdiv_rn(y, a.out_scale)),
                                        a.out_zp));
    out[row] = a.table[static_cast<int>(q_y)];
  }
}

__global__ void xla_log1p_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < n) out[i] = xla_log1p(__ldg(x + i));
}

}  // namespace

// The scorer's log1p alone, elementwise over [n] f32 (a check entry: the
// serving path runs it inside score_int8_kernel).
extern "C" int fsx_xla_log1p(const void* x, void* out, long long n,
                             void* stream) {
  if (n > 0) {
    xla_log1p_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fsx_score_args_size() {
  return static_cast<int>(sizeof(ScoreArgs));
}

// args: host pointer to a ScoreArgs, copied into the launch by value.
extern "C" int fsx_score_int8(const void* x, void* out, long long b,
                              const void* args, void* stream) {
  if (b > 0) {
    const long long blocks = (b * kLanes + kThreads - 1) / kThreads;
    score_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), b,
        *static_cast<const ScoreArgs*>(args));
  }
  return static_cast<int>(cudaGetLastError());
}
