// Ragged decode attention over a contiguous per-slot KV cache.
//
// Replaces the TPU kernel ragged_decode_bhsd / _ragged_decode_kernel
// (src/repro/kernels/flash_attention/kernel.py:132, :87).  Batch row b
// attends to cache positions [0, cur[b]]; rows with cur[b] >= Smax are
// retired slots and attend to the whole cache, and the key range is
// clamped to Smax-1 so nothing is read out of bounds.  The cache is read
// in its native (B, Smax, Hkv, dh) layout through strides: the TPU
// wrapper's per-call transpose into heads-major layout is not ported.
//
// What bounds it and what the design does: see decode_common.cuh.
#include "decode_common.cuh"

namespace {

template <typename T>
struct ContigRows {
  const T* k;         // &k_cache[b, 0, hk, 0]
  const T* v;
  long long k_ss;     // elements between consecutive positions
  long long v_ss;
  __device__ __forceinline__ void locate(int t, const T*& kr,
                                         const T*& vr) const {
    kr = k + (long long)t * k_ss;
    vr = v + (long long)t * v_ss;
  }
};

// DHC > 0: the tensor-core body (bf16) with dh rounded up to DHC; 0: SIMT.
template <typename T, int VEC, int DHC>
__global__ void __launch_bounds__(decode_attn::kThreads)
ragged_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cur,
                    int hkv, int g, int dh, int smax, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, float scale,
                    float softcap, int chunk, int n_split,
                    float* __restrict__ ml, float* __restrict__ acc) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int b = bh / hkv, hk = bh - b * hkv;
  const int n_keys = decode_attn::live_keys(cur[b], smax);
  const int c0 = s * chunk;
  if (c0 >= n_keys) return;
  const int c1 = min(c0 + chunk, n_keys);
  constexpr int kRows = DHC ? decode_attn::kMmaRows : decode_attn::kWarps;
  const int r0 = z * kRows;
  const ContigRows<T> rows{k + b * k_sb + hk * k_sh,
                           v + b * v_sb + hk * v_sh, k_ss, v_ss};
  const size_t p0 = ((size_t)bh * n_split + s) * g + r0;
  if constexpr (DHC > 0)
    decode_attn::mma_block<DHC>(
        q + ((size_t)bh * g + r0) * dh, min(kRows, g - r0), rows, c0, c1, dh,
        scale, softcap, ml + p0 * 2, acc + p0 * dh, smem);
  else
    decode_attn::split_block<T, VEC>(
        q + ((size_t)bh * g + r0) * dh, min(kRows, g - r0), rows, c0, c1, dh,
        scale, softcap, ml + p0 * 2, acc + p0 * dh, smem);
}

template <typename T, int VEC, int DHC>
int run(const void* q, const void* k, const void* v, const void* cur,
        void* out, void* ws, int b, int hkv, int g, int dh, int smax,
        long long k_sb, long long k_ss, long long k_sh, long long v_sb,
        long long v_ss, long long v_sh, float scale, float softcap,
        int chunk, int n_split, void* stream) {
  return decode_attn::launch_pair<T>(
      ragged_split_kernel<T, VEC, DHC>, decode_attn::block_rows(DHC),
      decode_attn::block_smem(DHC, dh, sizeof(T)), b, hkv, g, dh, smax, chunk,
      n_split, (const int*)cur, (float*)ws, (T*)out, stream, (const T*)q,
      (const T*)k, (const T*)v, (const int*)cur, hkv, g, dh, smax, k_sb,
      k_ss, k_sh, v_sb, v_ss, v_sh, scale, softcap, chunk, n_split);
}


// The body a call runs (decode_common.cuh, mma_cap): bf16 rows that allow
// 16-byte loads with dh <= 64 on the tensor cores, the rest on the SIMT
// body, with 16-byte or element loads.
using Run = decltype(&run<float, 4, 0>);
Run pick(int dtype, int wide, int dh) {
  using bf16 = __nv_bfloat16;
  if (decode_attn::mma_cap(dtype, wide, dh)) return &run<bf16, 8, 64>;
  if (dtype == 0) return wide ? &run<float, 4, 0> : &run<float, 1, 0>;
  return wide ? &run<bf16, 8, 0> : &run<bf16, 1, 0>;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  wide: 1 if dh, every stride and the
// K/V data allow 16-byte loads.  ws: the fp32 workspace of the split
// partials, b * hkv * n_split * g * (dh + 2) floats.  Launches the split
// and the combine kernel on `stream`, on the calling thread's current
// device, which the caller sets to the tensors' own.  Returns a
// cudaError_t (0 = launched).
extern "C" int ragged_decode(const void* q, const void* k, const void* v,
                             const void* cur, void* out, void* ws, int b,
                             int hkv, int g, int dh, int smax,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             float scale, float softcap, int chunk,
                             int n_split, int wide, int dtype,
                             void* stream) {
  if (dh < 1 || dh > decode_attn::kMaxDh || chunk < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return pick(dtype, wide, dh)(
      q, k, v, cur, out, ws, b, hkv, g, dh, smax, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, scale, softcap, chunk, n_split, stream);
}
