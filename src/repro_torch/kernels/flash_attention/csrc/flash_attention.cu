// Prefill (flash) attention: causal, sliding-window or full GQA softmax
// attention over a whole prompt, streaming keys through shared memory.
//
// Replaces the TPU kernel flash_attention_bhsd / _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:279, :30).  It computes
// the same function, not the same blocks: the TPU kernel's grid walks kv
// blocks in order on one core and carries m / l / acc in VMEM scratch;
// here one thread block owns one (64-query tile, batch row b, query head
// h) and walks the kv tiles in a loop of its own, keeping the running
// max m, normaliser l and fp32 accumulator acc of its rows in registers.
// Query head h reads kv head h / G of the same row (GQA, no broadcast).
//
// Semantics kept from the TPU kernel: q is scaled by dh^-0.5 before the
// dot product; softcap is tanh(s / cap) * cap; masked scores are the
// finite -1e30, never -inf, so a row that meets a visited tile with every
// key masked before its first valid key computes exp(0) = 1 there and is
// rescaled to exactly zero by alpha = exp(-1e30 - m) once a valid key
// arrives (with -inf that step is NaN); the same update order (m_new,
// p, alpha, l, acc); division by max(l, 1e-30) only at the end; and, when
// causal, the kv tiles wholly in the future or wholly left of the window
// are skipped (kernel.py:48-52).  Keys past Sk, in a short last tile,
// get p = 0.  Any Sq >= 1 and Sk >= 1 (the TPU kernel asserts that its
// blocks divide both), any dh <= 256.
//
// Layout: q (B, Sq, Hq, dh), k / v (B, Sk, Hkv, dh), read through their
// strides (the head_dim stride is 1); out is a contiguous
// (B, Sq, Hq, dh).  The TPU wrapper's per-call transpose to heads-major
// layout is not ported.
//
// Bound on the card: operations.  A causal 4096-token prompt at
// qwen2-0.5b's 14 heads of 64 is 30 GFLOP against 16.8 MB of q/k/v/out
// in bf16, some 1800 flops per byte, far above the H100's bf16 ridge of
// about 295.  This first version runs the two products on the fp32 FMA
// units: 256 threads each hold a 4 x 4 tile of scores and a 4 x (DH / 16)
// tile of the accumulator, over fp32 copies of the q, k and v tiles in
// shared memory, one scalar shared-memory load for every two FMAs.
// Tensor-core products (mma.sync, then wgmma with TMA loads) are the
// redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // a 16 x 16 grid: ty = row group, tx = column
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kRows = kBQ / 16;  // query rows per thread: ty + 16 * i
constexpr int kCols = kBK / 16;  // keys per thread: tx + 16 * j
constexpr float kNegInf = -1e30f;  // NEG_INF of the reference kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max / sum over the 16 lanes (tx = 0..15) that share one query row; an
// xor butterfly leaves the same value, bit for bit, in every lane
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: q tile kBQ x (DH+1) and k tile kBK x (DH+1),
// padded so the 16 rows a warp reads at one d fall in distinct banks;
// v tile kBK x DH; probabilities kBQ x (kBK+1).
inline size_t smem_bytes(int dh_cap) {
  return sizeof(float) * ((size_t)kBQ * (dh_cap + 1) +
                          (size_t)kBK * (dh_cap + 1) + (size_t)kBK * dh_cap +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int sq,
                     int sk, int hq, int g, int dh, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, float scale,
                     float softcap, int causal, int window) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * (DH + 1);
  float* vs = ks + kBK * (DH + 1);
  float* ps = vs + kBK * DH;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / hq, h = blockIdx.y - b * hq;
  const int hk = h / g;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  // q tile, scaled; rows past Sq and columns past dh are zero
  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    float x = 0.f;
    if (q0 + r < sq && d < dh) x = to_f32(qb[(q0 + r) * q_ss + d]) * scale;
    qs[r * (DH + 1) + d] = x;
  }

  float m[kRows], l[kRows], acc[kRows][DH / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[i][c] = 0.f;
  }

  // the kv tiles this q tile visits: all of them, or (causal) those not
  // wholly in the future of its last row nor wholly left of its first
  // row's window
  const int q_last = min(q0 + kBQ, sq) - 1;
  int kt_lo = 0, kt_hi = (sk + kBK - 1) / kBK;
  if (causal) {
    kt_hi = min(kt_hi, q_last / kBK + 1);
    const int left = q0 - window + 1;
    if (window > 0 && left > 0) kt_lo = left / kBK;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
#pragma unroll 4
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int t = i / DH, d = i - t * DH;
      float kx = 0.f, vx = 0.f;
      if (k0 + t < sk && d < dh) {
        kx = to_f32(kb[(k0 + t) * k_ss + d]);
        vx = to_f32(vb[(k0 + t) * v_ss + d]);
      }
      ks[t * (DH + 1) + d] = kx;
      vs[t * DH + d] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      float a[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], kv[j], s[i][j]);
    }

    // online softmax per row: the 16 lanes of a row reduce together
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool valid = (!causal || kp <= qp) &&
                           (window <= 0 || kp > qp - window);
        x = valid ? x : kNegInf;
        s[i][j] = x;
        if (kp < sk) mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float p = k0 + c < sk ? expf(s[i][j] - m_new) : 0.f;
        ps[r * (kBK + 1) + c] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p @ v, keys summed in order
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + 16 * i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        const float vx = vs[t * DH + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float norm = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * sq + qp) * hq + h) * dh;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) store(o + d, acc[i][c] / norm);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int hq, int hkv, int dh, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, float softcap, int causal, int window,
           void* stream) {
  auto kernel = flash_attention_kernel<T, DH>;
  const size_t smem = smem_bytes(DH);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, hq, hq / hkv,
      dh, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
      softcap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int sq, int sk, int hq, int hkv, int dh, long long q_sb,
             long long q_ss, long long q_sh, long long k_sb, long long k_ss,
             long long k_sh, long long v_sb, long long v_ss, long long v_sh,
             float scale, float softcap, int causal, int window,
             void* stream) {
#define FLASH_ATTENTION_CASE(CAP)                                              \
  if (dh <= CAP)                                                             \
    return launch<T, CAP>(q, k, v, out, b, sq, sk, hq, hkv, dh, q_sb, q_ss, \
                          q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,  \
                          softcap, causal, window, stream);
  FLASH_ATTENTION_CASE(32)
  FLASH_ATTENTION_CASE(64)
  FLASH_ATTENTION_CASE(128)
  FLASH_ATTENTION_CASE(256)
#undef FLASH_ATTENTION_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory one block asks for at head_dim dh (0 if dh > 256).
extern "C" long long flash_attention_smem_bytes(int dh) {
  for (int cap = 32; cap <= 256; cap *= 2)
    if (dh <= cap) return (long long)smem_bytes(cap);
  return 0;
}

// q (B, Sq, Hq, dh), k / v (B, Sk, Hkv, dh) with the given element strides
// (head_dim stride 1) -> out, a contiguous (B, Sq, Hq, dh).  causal: 0 or
// 1; window: 0 = none.  dtype: 0 = float32, 1 = bfloat16.  Needs
// 1 <= dh <= 256, Sq >= 1, Sk >= 1, Hq % Hkv == 0, B * Hq <= 65535.
// Launches on the calling thread's current device, which the caller sets
// to the tensors' own.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int sk, int hq,
                               int hkv, int dh, long long q_sb,
                               long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, float scale,
                               float softcap, int causal, int window,
                               int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv || dh < 1 ||
      b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, sq, sk, hq, hkv, dh, q_sb, q_ss,
                           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                           softcap, causal, window, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hkv, dh,
                                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                   v_ss, v_sh, scale, softcap, causal,
                                   window, stream);
  return (int)cudaErrorInvalidValue;
}
