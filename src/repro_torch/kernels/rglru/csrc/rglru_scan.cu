// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t over (B, T, C), h_0 = 0.
//
// Replaces the TPU kernel rglru_scan_btc / _rglru_kernel
// (src/repro/kernels/rglru/kernel.py:44, :27).  The TPU kernel walks a
// (batch, channel block, time block) grid in order and carries the fp32
// state across time blocks in VMEM scratch.  Here blocks run in parallel
// and in no order, so nothing is carried between blocks: one thread owns
// one (b, c) channel and loops over all of T itself with an fp32 carry.
// Neighbouring threads hold neighbouring channels, so each time step's
// loads and stores coalesce across a warp.  Every T is taken (the TPU
// kernel needs t_block | T; exact-length prefill gives any T), and a, x
// and h are addressed through their strides, so the wrapper copies
// nothing.
//
// Bound on the card: bytes.  Each element of a and x is read once and h
// written once (3 * B * T * C * 4 bytes in fp32) for 2 flops per element.
// The loop is a chain through the carry, so each thread loads kUnroll
// steps of a and x ahead of the carry (the loads do not depend on it) and
// keeps the next group in flight while it walks the current one.  At
// C = 2560 the grid is only 20 blocks of 128 threads on 132 SMs, so the
// bytes in flight, not the bandwidth, set the time: a chunked two-pass
// scan (chunks of T across blocks, then a carry fix-up) is the redesign.
//
// The product and the sum round separately (__fmul_rn, __fadd_rn, no
// fused multiply-add), as the plain PyTorch version's two operations do,
// so the kernel and its plain version agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                  TX* __restrict__ h, int t_len, int c_len, long long a_sb,
                  long long a_st, long long a_sc, long long x_sb,
                  long long x_st, long long x_sc, long long h_sb,
                  long long h_st, long long h_sc) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= c_len) return;
  const int b = blockIdx.y;
  const TA* ap = a + b * a_sb + c * a_sc;
  const TX* xp = x + b * x_sb + c * x_sc;
  TX* hp = h + b * h_sb + c * h_sc;

  float carry = 0.f;
  const int n_full = t_len / kUnroll;
  float av[kUnroll], xv[kUnroll];
  if (n_full > 0) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = to_f32(ap[i * a_st]);
      xv[i] = to_f32(xp[i * x_st]);
    }
  }
  for (int g = 0; g < n_full; ++g) {
    const long long t0 = (long long)g * kUnroll;
    float an[kUnroll], xn[kUnroll];
    if (g + 1 < n_full) {           // the next group, loaded ahead
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        an[i] = to_f32(ap[(t0 + kUnroll + i) * a_st]);
        xn[i] = to_f32(xp[(t0 + kUnroll + i) * x_st]);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      carry = __fadd_rn(__fmul_rn(av[i], carry), xv[i]);
      store(hp + (t0 + i) * h_st, carry);
    }
    if (g + 1 < n_full) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        av[i] = an[i];
        xv[i] = xn[i];
      }
    }
  }
  for (long long t = (long long)n_full * kUnroll; t < t_len; ++t) {
    carry = __fadd_rn(__fmul_rn(to_f32(ap[t * a_st]), carry),
                      to_f32(xp[t * x_st]));
    store(hp + t * h_st, carry);
  }
}

template <typename TA, typename TX>
int run(const void* a, const void* x, void* h, int b, int t, int c,
        long long a_sb, long long a_st, long long a_sc, long long x_sb,
        long long x_st, long long x_sc, long long h_sb, long long h_st,
        long long h_sc, void* stream) {
  if (b <= 0 || t <= 0 || c <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((c + kThreads - 1) / kThreads, b);
  rglru_scan_kernel<TA, TX><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const TA*)a, (const TX*)x, (TX*)h, t, c, a_sb, a_st, a_sc, x_sb,
      x_st, x_sc, h_sb, h_st, h_sc);
  return (int)cudaGetLastError();
}

}  // namespace

// a, x: (B, T, C) read through element strides (sb, st, sc); h: (B, T, C)
// written in x's dtype.  a_dtype, x_dtype: 0 = float32, 1 = bfloat16.
// Launches on the calling thread's current device, which the caller sets
// to the tensors' own, on ``stream``.  Returns a cudaError_t (0 =
// launched).
extern "C" int rglru_scan(const void* a, const void* x, void* h, int b,
                          int t, int c, long long a_sb, long long a_st,
                          long long a_sc, long long x_sb, long long x_st,
                          long long x_sc, long long h_sb, long long h_st,
                          long long h_sc, int a_dtype, int x_dtype,
                          void* stream) {
#define RGLRU_RUN(TA, TX)                                                   \
  return run<TA, TX>(a, x, h, b, t, c, a_sb, a_st, a_sc, x_sb, x_st, x_sc, \
                     h_sb, h_st, h_sc, stream)
  if (a_dtype == 0 && x_dtype == 0) RGLRU_RUN(float, float);
  if (a_dtype == 0 && x_dtype == 1) RGLRU_RUN(float, __nv_bfloat16);
  if (a_dtype == 1 && x_dtype == 0) RGLRU_RUN(__nv_bfloat16, float);
  if (a_dtype == 1 && x_dtype == 1) RGLRU_RUN(__nv_bfloat16, __nv_bfloat16);
#undef RGLRU_RUN
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
