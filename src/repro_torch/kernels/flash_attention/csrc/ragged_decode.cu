// Ragged decode attention over a contiguous per-slot KV cache.
//
// Replaces the TPU kernel ragged_decode_bhsd / _ragged_decode_kernel
// (src/repro/kernels/flash_attention/kernel.py:132, :87).  Batch row b
// attends to cache positions [0, cur[b]]; rows with cur[b] >= Smax are
// retired slots and attend to the whole cache, and the key loop is
// clamped to Smax-1 so nothing is read out of bounds.  The cache is read
// in its native (B, Smax, Hkv, dh) layout through strides: the TPU
// wrapper's per-call transpose into heads-major layout is not ported.
//
// What bounds it and what the design does: see decode_common.cuh.
#include "decode_common.cuh"

namespace {

template <typename T>
struct ContigRows {
  const T* base;      // &cache[b, 0, hk, 0]
  long long s_seq;    // elements between consecutive positions
  __device__ __forceinline__ const T* operator()(int t) const {
    return base + (long long)t * s_seq;
  }
};

template <typename T>
__global__ void __launch_bounds__(decode_attn::kThreads)
ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ cur,
                     T* __restrict__ out, int hkv, int g, int dh, int smax,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     float scale, float softcap) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / hkv, hk = bh - b * hkv;
  const int c = cur[b];
  const int n_keys = c < 0 ? 0 : min(c, smax - 1) + 1;
  ContigRows<T> k_row{k + b * k_sb + hk * k_sh, k_ss};
  ContigRows<T> v_row{v + b * v_sb + hk * v_sh, v_ss};
  const size_t row0 = (size_t)bh * g * dh;
  decode_attn::decode_block<T>(q + row0, out + row0, k_row, v_row, n_keys,
                               g, dh, scale, softcap, smem);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* cur,
        void* out, int b, int hkv, int g, int dh, int smax, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, float scale, float softcap, void* stream) {
  return decode_attn::launch(
      ragged_decode_kernel<T>, b * hkv, decode_attn::smem_bytes(g, dh),
      stream, (const T*)q, (const T*)k, (const T*)v, (const int*)cur,
      (T*)out, hkv, g, dh, smax, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
      softcap);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on the calling thread's
// current device, which the caller sets to the tensors' own.  Returns a
// cudaError_t (0 = launched).
extern "C" int ragged_decode(const void* q, const void* k, const void* v,
                             const void* cur, void* out, int b, int hkv,
                             int g, int dh, int smax, long long k_sb,
                             long long k_ss, long long k_sh, long long v_sb,
                             long long v_ss, long long v_sh, float scale,
                             float softcap, int dtype,
                             void* stream) {
  if (dtype == 0)
    return run<float>(q, k, v, cur, out, b, hkv, g, dh, smax, k_sb, k_ss,
                      k_sh, v_sb, v_ss, v_sh, scale, softcap, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, cur, out, b, hkv, g, dh, smax, k_sb,
                              k_ss, k_sh, v_sb, v_ss, v_sh, scale, softcap,
                              stream);
  return (int)cudaErrorInvalidValue;
}
