// Shared body of the two decode-attention kernels (ragged_decode.cu,
// paged_decode.cu).
//
// One thread block owns one (batch row b, kv head hk): the G query heads
// that share kv head hk (query heads hk*G .. hk*G+G-1, the packing of
// q.reshape(b, hkv, g, dh)) attend together to the row's live key prefix
// [0, n_keys).  Keys stream through shared memory in tiles of kTile; each
// tile updates an fp32 running max m, normaliser l and accumulator acc
// per query head (online softmax), and the block writes its G output rows
// once at the end.
//
// The two kernels differ only in how key t of the row is addressed
// (contiguous cache row or page-table lookup).  Both walk keys in the
// same tiles and sum in the same order, so the same cache contents give
// bit-identical outputs through either kernel.
//
// Bound on the card: the K/V bytes of the live prefix, read once
// (2 * n_keys * dh * sizeof(T) per block); the arithmetic is ~7 flops per
// byte at G=7, far below the H100's ridge.  This first version reads
// each key row with scalar loads and keeps one block per (b, kv head):
// 16 blocks at qwen2-0.5b's B=8, Hkv=2 fill 16 of 132 SMs.  Split-KV and
// vectorised (TMA) loads are the next steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kThreads = 128;
constexpr int kTile = 32;
constexpr float kNegInf = -1e30f;   // NEG_INF of the reference kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: q (g*dh), k tile (kTile*(dh+1), padded so the
// score loop's per-key rows fall in different banks), v tile (kTile*dh),
// probabilities (g*kTile), acc (g*dh), m / l / alpha (3*g).
inline size_t smem_bytes(int g, int dh) {
  return sizeof(float) * (size_t)(2 * g * dh + kTile * (dh + 1) +
                                  kTile * dh + g * kTile + 3 * g);
}

// q: this block's G query rows (g*dh contiguous); out likewise.
// k_row(t) / v_row(t): pointer to the dh contiguous elements of key t.
template <typename T, typename Rows>
__device__ void decode_block(const T* __restrict__ q, T* __restrict__ out,
                             const Rows& k_row, const Rows& v_row,
                             int n_keys, int g, int dh, float scale,
                             float softcap, float* smem) {
  float* qs = smem;
  float* ks = qs + g * dh;
  float* vs = ks + kTile * (dh + 1);
  float* sp = vs + kTile * dh;
  float* acc = sp + g * kTile;
  float* m = acc + g * dh;
  float* l = m + g;
  float* alpha = l + g;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int kstride = dh + 1;

  for (int i = tid; i < g * dh; i += nt) {
    qs[i] = to_f32(q[i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += nt) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    const int tn = min(kTile, n_keys - t0);
    for (int i = tid; i < tn * dh; i += nt) {
      const int t = i / dh, d = i - t * dh;
      ks[t * kstride + d] = to_f32(k_row(t0 + t)[d]);
      vs[t * dh + d] = to_f32(v_row(t0 + t)[d]);
    }
    __syncthreads();

    // scores: q already carries the dh^-0.5 scale
    for (int i = tid; i < g * kTile; i += nt) {
      const int r = i / kTile, t = i - r * kTile;
      float s = kNegInf;
      if (t < tn) {
        const float* qr = qs + r * dh;
        const float* kr = ks + t * kstride;
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(qr[d], kr[d], a);
        if (softcap > 0.f) a = tanhf(a / softcap) * softcap;
        s = a;
      }
      sp[i] = s;
    }
    __syncthreads();

    // one warp per query row: tile max, probabilities, running stats
    for (int r = warp; r < g; r += n_warps) {
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, sp[r * kTile + t]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = t < tn ? expf(sp[r * kTile + t] - m_new) : 0.f;
        sp[r * kTile + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, keys summed in order
    for (int i = tid; i < g * dh; i += nt) {
      const int r = i / dh, d = i - r * dh;
      const float* pr = sp + r * kTile;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < tn; ++t) a = fmaf(pr[t], vs[t * dh + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * dh; i += nt) {
    const int r = i / dh;
    store(out + i, acc[i] / fmaxf(l[r], 1e-30f));
  }
}

// Launch helper shared by both C entry points: raises the dynamic shared
// memory ceiling when needed, launches, and returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, size_t smem, void* stream,
           Args... args) {
  if (blocks == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace decode_attn

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory one block of either kernel asks for.
extern "C" long long decode_smem_bytes(int g, int dh) {
  return (long long)decode_attn::smem_bytes(g, dh);
}
