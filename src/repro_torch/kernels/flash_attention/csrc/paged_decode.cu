// Paged decode attention: keys and values gathered through a page table.
//
// Replaces the TPU kernel paged_decode_bhsd / _paged_decode_kernel
// (src/repro/kernels/flash_attention/kernel.py:227, :180).  Logical key t
// of batch row b lives in physical page pt[b, t / ps] at offset t % ps.
// Only keys t <= cur[b] are visited, so logical pages with j * ps > cur[b]
// are skipped; the table entry is still clipped to [0, N-1], because the
// sentinel N of an unmapped page (or of a retired slot's row) would read
// past the pool on this card.  The pool is read in its native
// (N, ps, Hkv, dh) layout through strides.
//
// Keys are cut into the same chunks and walked in the same order as by
// the contiguous kernel, whatever the page size, so paged and contiguous
// caches holding the same values give bit-identical outputs.  What bounds
// it and what the design does: see decode_common.cuh.
#include "decode_common.cuh"

namespace {

template <typename T>
struct PagedRows {
  const T* k;           // &k_pages[0, 0, hk, 0]
  const T* v;
  const int* pt_row;    // this row's page table (max_pages entries)
  int ps;               // page size
  int n_pages;          // pool size N
  long long k_sp, k_ss; // elements between pages, between positions
  long long v_sp, v_ss;
  __device__ __forceinline__ void locate(int t, const T*& kr,
                                         const T*& vr) const {
    const int j = t / ps;
    const long long p = min(max(pt_row[j], 0), n_pages - 1);
    const long long off = t - j * ps;
    kr = k + p * k_sp + off * k_ss;
    vr = v + p * v_sp + off * v_ss;
  }
};

// DHC > 0: the tensor-core body (bf16) with dh rounded up to DHC; 0: SIMT.
template <typename T, int VEC, int DHC>
__global__ void __launch_bounds__(decode_attn::kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pt,
                   const int* __restrict__ cur, int hkv, int g, int dh,
                   int ps, int n_pages, int max_pages, long long k_sp,
                   long long k_ss, long long k_sh, long long v_sp,
                   long long v_ss, long long v_sh, float scale,
                   float softcap, int chunk, int n_split,
                   float* __restrict__ ml, float* __restrict__ acc) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int b = bh / hkv, hk = bh - b * hkv;
  const int n_keys = decode_attn::live_keys(cur[b], max_pages * ps);
  const int c0 = s * chunk;
  if (c0 >= n_keys) return;
  const int c1 = min(c0 + chunk, n_keys);
  constexpr int kRows = DHC ? decode_attn::kMmaRows : decode_attn::kWarps;
  const int r0 = z * kRows;
  const PagedRows<T> rows{k + hk * k_sh, v + hk * v_sh,
                          pt + (size_t)b * max_pages, ps, n_pages,
                          k_sp, k_ss, v_sp, v_ss};
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
int run(const void* q, const void* k, const void* v, const void* pt,
        const void* cur, void* out, void* ws, int b, int hkv, int g, int dh,
        int ps, int n_pages, int max_pages, long long k_sp, long long k_ss,
        long long k_sh, long long v_sp, long long v_ss, long long v_sh,
        float scale, float softcap, int chunk, int n_split, void* stream) {
  return decode_attn::launch_pair<T>(
      paged_split_kernel<T, VEC, DHC>, decode_attn::block_rows(DHC),
      decode_attn::block_smem(DHC, dh, sizeof(T)), b, hkv, g, dh,
      max_pages * ps, chunk, n_split, (const int*)cur, (float*)ws, (T*)out,
      stream, (const T*)q, (const T*)k, (const T*)v, (const int*)pt,
      (const int*)cur, hkv, g, dh, ps, n_pages, max_pages, k_sp, k_ss, k_sh,
      v_sp, v_ss, v_sh, scale, softcap, chunk, n_split);
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
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* pt, const void* cur, void* out,
                            void* ws, int b, int hkv, int g, int dh, int ps,
                            int n_pages, int max_pages, long long k_sp,
                            long long k_ss, long long k_sh, long long v_sp,
                            long long v_ss, long long v_sh, float scale,
                            float softcap, int chunk, int n_split, int wide,
                            int dtype, void* stream) {
  if (dh < 1 || dh > decode_attn::kMaxDh || chunk < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return pick(dtype, wide, dh)(
      q, k, v, pt, cur, out, ws, b, hkv, g, dh, ps, n_pages, max_pages, k_sp,
      k_ss, k_sh, v_sp, v_ss, v_sh, scale, softcap, chunk, n_split, stream);
}
