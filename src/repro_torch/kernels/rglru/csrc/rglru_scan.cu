// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t over (B, T, C), h_0 = 0.
//
// Replaces the TPU kernel rglru_scan_btc / _rglru_kernel
// (src/repro/kernels/rglru/kernel.py:44, :27).  The TPU kernel walks a
// (batch, channel block, time block) grid in order and carries the fp32
// state across time blocks in VMEM scratch.  Here blocks run in parallel
// and in no order, so the carry crosses blocks through a second pass.  T
// is cut into n_chunks chunks of chunk_len steps (``ops.scan_chunks``,
// from the shape alone), and one thread owns one (b, c) channel over one
// chunk:
//
//   pass 1, rglru_chunk_reduce_kernel: every chunk but the last scans from
//     zero and writes only its product A = prod a_t and its end state H,
//     two fp32 numbers per (b, chunk, c), into a scratch that the wrapper
//     allocates; it writes nothing of h;
//   pass 2, rglru_chunk_scan_kernel: chunk k folds its carry-in,
//     carry = A_j * carry + H_j over j < k in chunk order, then walks its
//     chunk from that carry and writes h in x's dtype.
//
// Bound on the card: bytes.  The call must read a and x once and write h
// once (3 * B * T * C * 4 bytes in fp32) for 2 flops per element; the two
// passes read a and x twice.  One thread per channel over all of T gave 20
// blocks of 128 threads at recurrentgemma's prefill (B = 1, C = 2560) on
// 132 SMs: too few bytes in flight for the bandwidth.  The chunks give
// (channel tiles) x n_chunks x B blocks, at least 4 per SM there.  The
// walk through a chunk is a chain through the carry, so each thread loads
// kUnroll steps of a and x ahead of it (the loads do not depend on it) and
// keeps the next group in flight while it walks the current one.
//
// Pass 2 is launched as a programmatic dependent of pass 1 (Hopper's
// dependent launch): its blocks may start while pass 1's last blocks run.
// Each starts its first group of loads (a and x, which no pass writes),
// then waits for pass 1 (griddepcontrol.wait) before it folds the sums, so
// the launch gap and the fold's reads overlap those loads.  Pass 2 reads a
// and x for the last time in the call and writes h once, so it loads and
// stores with the evict-first (streaming) hint: its misses do not push out
// of the 50 MB L2 the lines that pass 1 left there and pass 2 still has to
// read.  Pass 2's blocks take the chunks in reverse order, so the chunks
// that pass 1 read last are read again first.  Neighbouring threads hold
// neighbouring channels, so each step's loads and stores coalesce across a
// warp.  Every T is taken, and a, x and h are addressed through their
// strides, so the wrapper copies nothing.
//
// Every product and sum rounds separately (__fmul_rn, __fadd_rn, no fused
// multiply-add), as the plain PyTorch version's operations do, and the
// fold runs in chunk order with no atomics, so the result is
// deterministic.  With one chunk (short T) only pass 2 runs, from a zero
// carry, and agrees with the plain version bit for bit; with more, each
// chunk's carry-in is the same sum reassociated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// kLast: the call's last read of p, with the evict-first hint
template <bool kLast, typename T>
__device__ __forceinline__ float load(const T* p) {
  if constexpr (kLast) {
    return to_f32(__ldcs(p));
  } else {
    return to_f32(*p);
  }
}
__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  __stcs(p, __float2bfloat16_rn(v));
}

// Walks steps [0, len) of one channel (a, x and h at their time strides)
// from the carry that init() returns; init() runs once the first group's
// loads are started.  kWrite (pass 2): stores each h_t, and loads and
// stores with the evict-first hint; else multiplies the steps' a into
// *prod.  -> the carry after the last step.
template <bool kWrite, typename TA, typename TX, typename Init>
__device__ __forceinline__ float walk(const TA* ap, long long a_st,
                                      const TX* xp, long long x_st, TX* hp,
                                      long long h_st, int len, Init init,
                                      float* prod) {
  const int n_full = len / kUnroll;
  float av[kUnroll], xv[kUnroll];
  if (n_full > 0) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = load<kWrite>(ap + i * a_st);
      xv[i] = load<kWrite>(xp + i * x_st);
    }
  }
  float carry = init();
  float p = 1.f;
  for (int g = 0; g < n_full; ++g) {
    const long long t0 = (long long)g * kUnroll;
    float an[kUnroll], xn[kUnroll];
    if (g + 1 < n_full) {           // the next group, loaded ahead
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        an[i] = load<kWrite>(ap + (t0 + kUnroll + i) * a_st);
        xn[i] = load<kWrite>(xp + (t0 + kUnroll + i) * x_st);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      carry = __fadd_rn(__fmul_rn(av[i], carry), xv[i]);
      if constexpr (kWrite) {
        store(hp + (t0 + i) * h_st, carry);
      } else {
        p = __fmul_rn(p, av[i]);
      }
    }
    if (g + 1 < n_full) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        av[i] = an[i];
        xv[i] = xn[i];
      }
    }
  }
  // the last len % kUnroll steps: all their loads first, then the chain
  const long long t0 = (long long)n_full * kUnroll;
  const int rem = len - n_full * kUnroll;
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    if (i < rem) {
      av[i] = load<kWrite>(ap + (t0 + i) * a_st);
      xv[i] = load<kWrite>(xp + (t0 + i) * x_st);
    }
  }
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    if (i < rem) {
      carry = __fadd_rn(__fmul_rn(av[i], carry), xv[i]);
      if constexpr (kWrite) {
        store(hp + (t0 + i) * h_st, carry);
      } else {
        p = __fmul_rn(p, av[i]);
      }
    }
  }
  if constexpr (!kWrite) *prod = p;
  return carry;
}

// Pass 1.  grid (channel tiles, n_chunks - 1, B): chunk blockIdx.y, always
// chunk_len steps long (only the last chunk may be shorter, and its sums
// are never read).  prod, state: (B, n_chunks - 1, C) fp32.
template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_reduce_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                          float* __restrict__ prod, float* __restrict__ state,
                          int c_len, int chunk_len, long long a_sb,
                          long long a_st, long long a_sc, long long x_sb,
                          long long x_st, long long x_sc) {
  asm volatile("griddepcontrol.launch_dependents;");   // pass 2 may start
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= c_len) return;
  const int k = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)k * chunk_len;
  float p;
  const float h = walk<false>(
      a + b * a_sb + t0 * a_st + c * a_sc, a_st,
      x + b * x_sb + t0 * x_st + c * x_sc, x_st, (TX*)nullptr, 0, chunk_len,
      [] { return 0.f; }, &p);
  const long long at = ((long long)b * gridDim.y + k) * c_len + c;
  prod[at] = p;
  state[at] = h;
}

// Pass 2.  grid (channel tiles, n_chunks, B): chunk n_chunks - 1 -
// blockIdx.y, so the chunks run in the reverse of pass 1's order.  Reads
// nothing of pass 1 before griddepcontrol.wait.
template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_scan_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                        TX* __restrict__ h, const float* __restrict__ prod,
                        const float* __restrict__ state, int t_len,
                        int c_len, int chunk_len, long long a_sb,
                        long long a_st, long long a_sc, long long x_sb,
                        long long x_st, long long x_sc, long long h_sb,
                        long long h_st, long long h_sc) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= c_len) return;
  const int n_chunks = gridDim.y;
  const int k = n_chunks - 1 - blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)k * chunk_len;
  const int len = (int)min((long long)chunk_len, t_len - t0);
  const long long row = (long long)b * (n_chunks - 1) * c_len + c;
  walk<true>(
      a + b * a_sb + t0 * a_st + c * a_sc, a_st,
      x + b * x_sb + t0 * x_st + c * x_sc, x_st,
      h + b * h_sb + t0 * h_st + c * h_sc, h_st, len,
      [&] {
        // pass 1 done and its sums visible (no-op without a pass 1)
        asm volatile("griddepcontrol.wait;" ::: "memory");
        float carry = 0.f;
#pragma unroll 8
        for (int j = 0; j < k; ++j) {
          const long long at = row + (long long)j * c_len;
          carry = __fadd_rn(__fmul_rn(prod[at], carry), state[at]);
        }
        return carry;
      },
      (float*)nullptr);
}

template <typename TA, typename TX>
int run(const void* a, const void* x, void* h, float* scratch, int b, int t,
        int c, int chunk_len, int n_chunks, long long a_sb, long long a_st,
        long long a_sc, long long x_sb, long long x_st, long long x_sc,
        long long h_sb, long long h_st, long long h_sc, void* stream) {
  if (b <= 0 || t <= 0 || c <= 0 || b > 65535 || chunk_len <= 0 ||
      n_chunks <= 0 || n_chunks > 65535 ||
      (long long)(n_chunks - 1) * chunk_len >= t ||
      (long long)n_chunks * chunk_len < t ||
      (n_chunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = (c + kThreads - 1) / kThreads;
  float* prod = scratch;
  float* state = scratch + (long long)b * (n_chunks - 1) * c;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 1) {
    rglru_chunk_reduce_kernel<TA, TX>
        <<<dim3(tiles, n_chunks - 1, b), kThreads, 0, s>>>(
            (const TA*)a, (const TX*)x, prod, state, c, chunk_len, a_sb,
            a_st, a_sc, x_sb, x_st, x_sc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // after a pass 1, a programmatic dependent of it; else an ordinary
  // launch, which waits for the kernels that wrote a and x
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, n_chunks, b);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &dependent;
  cfg.numAttrs = n_chunks > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rglru_chunk_scan_kernel<TA, TX>, (const TA*)a, (const TX*)x,
      (TX*)h, (const float*)prod, (const float*)state, t, c, chunk_len, a_sb,
      a_st, a_sc, x_sb, x_st, x_sc, h_sb, h_st, h_sc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// a, x: (B, T, C) read through element strides (sb, st, sc); h: (B, T, C)
// written in x's dtype.  T is cut into n_chunks chunks of chunk_len steps,
// (n_chunks - 1) * chunk_len < T <= n_chunks * chunk_len; scratch holds 2 *
// B * (n_chunks - 1) * C floats (products, then end states; unread when
// n_chunks is 1).  a_dtype, x_dtype: 0 = float32, 1 = bfloat16.  Launches
// pass 1 (when n_chunks > 1) and pass 2 on the calling thread's current
// device, which the caller sets to the tensors' own, on ``stream``.
// Returns a cudaError_t (0 = both launched).
extern "C" int rglru_scan(const void* a, const void* x, void* h,
                          void* scratch, int b, int t, int c, int chunk_len,
                          int n_chunks, long long a_sb, long long a_st,
                          long long a_sc, long long x_sb, long long x_st,
                          long long x_sc, long long h_sb, long long h_st,
                          long long h_sc, int a_dtype, int x_dtype,
                          void* stream) {
#define RGLRU_RUN(TA, TX)                                                   \
  return run<TA, TX>(a, x, h, (float*)scratch, b, t, c, chunk_len,          \
                     n_chunks, a_sb, a_st, a_sc, x_sb, x_st, x_sc, h_sb,    \
                     h_st, h_sc, stream)
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
