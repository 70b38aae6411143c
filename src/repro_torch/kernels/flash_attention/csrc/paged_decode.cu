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
// Keys are walked in the same tiles as the contiguous kernel, whatever
// the page size, so paged and contiguous caches holding the same values
// give bit-identical outputs.  What bounds it: see decode_common.cuh.
#include "decode_common.cuh"

namespace {

template <typename T>
struct PagedRows {
  const T* base;        // &pages[0, 0, hk, 0]
  const int* pt_row;    // this row's page table (max_pages entries)
  int ps;               // page size
  int n_pages;          // pool size N
  long long s_page;     // elements between pages
  long long s_pos;      // elements between positions within a page
  __device__ __forceinline__ const T* operator()(int t) const {
    const int j = t / ps;
    const int p = min(max(pt_row[j], 0), n_pages - 1);
    return base + (long long)p * s_page + (long long)(t - j * ps) * s_pos;
  }
};

template <typename T>
__global__ void __launch_bounds__(decode_attn::kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pt,
                    const int* __restrict__ cur, T* __restrict__ out,
                    int hkv, int g, int dh, int ps, int n_pages,
                    int max_pages, long long k_sp, long long k_ss,
                    long long k_sh, long long v_sp, long long v_ss,
                    long long v_sh, float scale, float softcap) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / hkv, hk = bh - b * hkv;
  const int c = cur[b];
  const int max_len = max_pages * ps;
  const int n_keys = c < 0 ? 0 : min(c, max_len - 1) + 1;
  const int* pt_row = pt + (size_t)b * max_pages;
  PagedRows<T> k_row{k + hk * k_sh, pt_row, ps, n_pages, k_sp, k_ss};
  PagedRows<T> v_row{v + hk * v_sh, pt_row, ps, n_pages, v_sp, v_ss};
  const size_t row0 = (size_t)bh * g * dh;
  decode_attn::decode_block<T>(q + row0, out + row0, k_row, v_row, n_keys,
                               g, dh, scale, softcap, smem);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* pt,
        const void* cur, void* out, int b, int hkv, int g, int dh, int ps,
        int n_pages, int max_pages, long long k_sp, long long k_ss,
        long long k_sh, long long v_sp, long long v_ss, long long v_sh,
        float scale, float softcap, void* stream) {
  return decode_attn::launch(
      paged_decode_kernel<T>, b * hkv, decode_attn::smem_bytes(g, dh),
      stream, (const T*)q, (const T*)k, (const T*)v, (const int*)pt,
      (const int*)cur, (T*)out, hkv, g, dh, ps, n_pages, max_pages, k_sp,
      k_ss, k_sh, v_sp, v_ss, v_sh, scale, softcap);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on the calling thread's
// current device, which the caller sets to the tensors' own.  Returns a
// cudaError_t (0 = launched).
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* pt, const void* cur, void* out,
                            int b, int hkv, int g, int dh, int ps,
                            int n_pages, int max_pages, long long k_sp,
                            long long k_ss, long long k_sh, long long v_sp,
                            long long v_ss, long long v_sh, float scale,
                            float softcap, int dtype,
                            void* stream) {
  if (dtype == 0)
    return run<float>(q, k, v, pt, cur, out, b, hkv, g, dh, ps, n_pages,
                      max_pages, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, scale,
                      softcap, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, pt, cur, out, b, hkv, g, dh, ps,
                              n_pages, max_pages, k_sp, k_ss, k_sh, v_sp,
                              v_ss, v_sh, scale, softcap, stream);
  return (int)cudaErrorInvalidValue;
}
