// Prefill (flash) attention: causal, sliding-window or full GQA softmax
// attention over a whole prompt, streaming keys through shared memory.
//
// Replaces the TPU kernel flash_attention_bhsd / _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:279, :30).  It computes
// the same function, not the same blocks: the TPU kernel's grid walks kv
// blocks in order on one core and carries m / l / acc in VMEM scratch;
// here one thread block owns one (query tile, batch row b, query head h)
// and walks the kv tiles in a loop of its own, keeping the running max m,
// normaliser l and fp32 accumulator acc of its rows in registers.  Query
// head h reads kv head h / G of the same row (GQA, no broadcast).
//
// Semantics kept from the TPU kernel: softcap is tanh(s / cap) * cap of
// the scaled score; masked scores are the finite -1e30, never -inf, so a
// row that meets a visited tile with every key masked before its first
// valid key computes exp(0) = 1 there and is rescaled to exactly zero by
// alpha = exp(-1e30 - m) once a valid key arrives (with -inf that step is
// NaN); the same update order (m_new, p, alpha, l, acc); division by
// max(l, 1e-30) only at the end; and, when causal, the kv tiles wholly in
// the future or wholly left of the window are skipped (kernel.py:48-52).
// Keys past Sk, in a short last tile, get p = 0.  Any Sq >= 1 and
// Sk >= 1 (the TPU kernel asserts that its blocks divide both), any
// dh <= 256.
//
// Layout: q (B, Sq, Hq, dh), k / v (B, Sk, Hkv, dh), read through their
// strides (the head_dim stride is 1); out is a contiguous
// (B, Sq, Hq, dh).  The TPU wrapper's per-call transpose to heads-major
// layout is not ported.
//
// Bound on the card: operations.  A causal 4096-token prompt at
// qwen2-0.5b's 14 heads of 64 is 30.07 GFLOP (8,390,656 unmasked query-key
// pairs) against 16.8 MB of q/k/v/out in bf16, some 1800 flops per byte,
// far above the H100's bf16 ridge of about 295; recurrentgemma-2b's 3500
// tokens at 10 heads of 256, window 2048, are 51.94 GFLOP.  At the dense
// bf16 tensor-core peak (989 TFLOP/s) that is 0.030 and 0.053 ms; on the
// fp32 FMA units (67 TFLOP/s) 0.45 and 0.78 ms.  Two bodies:
//
// * bf16, flash_attention_kernel_mma: the FlashAttention-2 structure on
//   the tensor cores.  Each warp owns 16 query rows; S = Q K^T and
//   O += P V are mma.sync m16n8k16 bf16 products with fp32 accumulators,
//   their operands read from shared memory with ldmatrix (V with
//   ldmatrix.trans, so the row-major V tile serves as the column
//   operand).  The S accumulator, rounded to bf16 pairs, is the A operand
//   of P V as it stands: P never goes through shared memory.  q, k and v
//   tiles stay bf16 in shared memory, loaded with 16-byte cp.async.cg;
//   the K/V tiles are double buffered, so tile t+1 loads while tile t is
//   multiplied.  Rows are padded to dh + 8 elements, so the eight 16-byte
//   rows of an ldmatrix fall in distinct banks.  The scale dh^-0.5 (times
//   log2 e, for exp2f) multiplies the fp32 scores, never bf16 q; only
//   tiles that cross the diagonal, the window's left edge or Sk evaluate
//   the mask, and a warp skips a tile wholly in the future of its rows
//   (it would add exactly zero).  Causal query tiles differ in work by up
//   to Sq / 64 times, so the heaviest (last) tiles launch first.  Tiles:
//   dh <= 128, 128 query rows (8 warps) and 64 keys, 55 KB of shared
//   memory at dh 64, two blocks an SM; dh 256, 64 query rows (4 warps)
//   and 64 keys, 165 KB, one block an SM (the 128 fp32 accumulators of
//   a thread).  The q fragments are re-read from shared memory at every
//   k-step: held in registers they made dh 64 spill under its two-blocks
//   cap and were no faster on the card.  dh below a template's width (8,
//   16, 32 ...) is zero-padded.  Needs dh % 8 == 0 and 16-byte aligned
//   rows (the wrapper checks).
// * fp32, flash_attention_kernel_simt: the products on the fp32 FMA units
//   (TF32 would cost the card-against-CPU token checks their exact
//   tokens).  256 threads each hold a 4 x 4 tile of scores and a
//   4 x (DH / 16) tile of the accumulator, over fp32 copies of the q
//   (scaled), k and v tiles in shared memory, one scalar shared-memory
//   load for every two FMAs.  The same body, instantiated for bf16 with
//   element loads, takes the bf16 calls at a dh that is not a multiple of
//   8, which the tensor-core body cannot (dtype code 2); it rounds to
//   bf16 once, at the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the reference kernel

// ----- fp32: SIMT body ------------------------------------------------------

constexpr int kThreads = 256;    // a 16 x 16 grid: ty = row group, tx = column
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kRows = kBQ / 16;  // query rows per thread: ty + 16 * i
constexpr int kCols = kBK / 16;  // keys per thread: tx + 16 * j

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
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
inline size_t simt_smem_bytes(int dh_cap) {
  return sizeof(float) * ((size_t)kBQ * (dh_cap + 1) +
                          (size_t)kBK * (dh_cap + 1) + (size_t)kBK * dh_cap +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_simt(const T* __restrict__ q, const T* __restrict__ k,
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

// ----- bf16: tensor-core body -----------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// Tiles of the tensor-core body at head_dim template DH.
template <int DH>
struct MmaTile {
  static constexpr int kWarps = DH <= 128 ? 8 : 4;  // 16 query rows each
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kBK = 64;         // keys per tile
  static constexpr int kPitch = DH + 8;  // elements per shared-memory row
  static constexpr int kMinBlocks = DH <= 64 ? 2 : 1;
  // q tile kBQ rows, then two K and two V tiles of kBK rows, all bf16
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * kPitch;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
// Lane l holds rows l / 4 and l / 4 + 8 of d, columns 2 (l % 4) and +1.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// max / sum over the 4 lanes (l % 4) that share one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH>
__global__ void __launch_bounds__(32 * MmaTile<DH>::kWarps,
                                  MmaTile<DH>::kMinBlocks)
flash_attention_kernel_mma(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int sq, int sk, int hq, int g, int dh,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           float scale, float softcap, int causal,
                           int window) {
  using Tile = MmaTile<DH>;
  constexpr int kNT = 32 * Tile::kWarps, BQ = Tile::kBQ, BK = Tile::kBK;
  constexpr int P = Tile::kPitch, CH = DH / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * P;       // two buffers of BK x P
  bf16* vs = ks + 2 * BK * P;   // two buffers of BK x P
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;  // accumulator row, column pair
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tiles first
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int hk = h / g;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  // q tile; rows past Sq and columns past dh are zero
  for (int i = tid; i < BQ * CH; i += kNT) {
    const int r = i / CH, c = i - r * CH;
    const bool in = q0 + r < sq && c * 8 < dh;
    cp_async16(smem_addr(qs + r * P + c * 8),
               in ? qb + (q0 + r) * q_ss + c * 8 : qb, in);
  }
  cp_async_commit();

  // the kv tiles this q tile visits, as the SIMT body
  const int q_last = min(q0 + BQ, sq) - 1;
  int kt_lo = 0, kt_hi = (sk + BK - 1) / BK;
  if (causal) {
    kt_hi = min(kt_hi, q_last / BK + 1);
    const int left = q0 - window + 1;
    if (window > 0 && left > 0) kt_lo = left / BK;
  }

  // K and V tile kt into buffer buf; keys past Sk are zero (so p = 0
  // meets v = 0, never garbage)
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    bf16* kd = ks + buf * BK * P;
    bf16* vd = vs + buf * BK * P;
    for (int i = tid; i < BK * CH; i += kNT) {
      const int r = i / CH, c = i - r * CH;
      const bool in = k0 + r < sk && c * 8 < dh;
      cp_async16(smem_addr(kd + r * P + c * 8),
                 in ? kb + (k0 + r) * k_ss + c * 8 : kb, in);
      cp_async16(smem_addr(vd + r * P + c * 8),
                 in ? vb + (k0 + r) * v_ss + c * 8 : vb, in);
    }
  };
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  // per-lane ldmatrix offsets, in elements.  q (A operand): lanes 0-15
  // rows 0-15 at column 0, lanes 16-31 at column 8.  K (B operand of S,
  // two n-blocks of 8 keys): lanes 0-7 keys 0-7 at d 0, 8-15 keys 0-7 at
  // d 8, 16-23 keys 8-15 at d 0, 24-31 keys 8-15 at d 8.  V (B operand of
  // P V, transposed, two n-blocks of 8 columns): lanes 0-7 keys 0-7 at
  // column 0, 8-15 keys 8-15 at column 0, 16-31 the same at column 8.
  const uint32_t q_lane =
      smem_addr(qs + (warp * 16 + (lane & 15)) * P + (lane >> 4) * 8);
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * P +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * P +
                     (lane >> 4) * 8;
  const int qw0 = q0 + warp * 16, qw_last = qw0 + 15;  // this warp's rows
  const float score_scale = scale * kLog2e;

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (of scores times log2 e) and this lane's part of l, for
  // rows gr and gr + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // q and tile kt have landed
    __syncthreads();
    const int k0 = kt * BK;
    // a warp past Sq, or (causal) wholly before this tile, has nothing to
    // add: its rows' scores here are all masked and p = 0 exactly
    if (qw0 < sq && (!causal || k0 <= qw_last)) {
      const uint32_t k_tile = smem_addr(ks + buf * BK * P + k_lane);
      const uint32_t v_tile = smem_addr(vs + buf * BK * P + v_lane);

      // S = Q K^T: s[j] holds keys 8j .. 8j+7 of the tile
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];  // q, re-read at every k-step: no spare registers
        ldmatrix_x4(q_lane + kk * 32, a);
#pragma unroll
        for (int nb = 0; nb < BK / 16; ++nb) {
          uint32_t bk[4];
          ldmatrix_x4(k_tile + (nb * 16 * P + kk * 16) * 2, bk);
          mma_bf16(s[2 * nb], a, bk[0], bk[1]);
          mma_bf16(s[2 * nb + 1], a, bk[2], bk[3]);
        }
      }

      // scores in the log2 domain; the mask only where the tile crosses
      // the diagonal, the window's left edge or Sk for some row of this
      // warp
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e];
          if (softcap > 0.f)
            x = tanhf(x * scale / softcap) * softcap * kLog2e;
          else
            x *= score_scale;
          s[j][e] = x;
        }
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qw0) ||
                        (window > 0 && k0 <= qw_last - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * tq + (e & 1);
            const int qp = qw0 + gr + 8 * (e >> 1);
            const bool valid = kp < sk && (!causal || kp <= qp) &&
                               (window <= 0 || kp > qp - window);
            if (!valid) s[j][e] = kNegInf;
          }
      }

      // online softmax, in the reference's order: m_new, p, alpha, l, acc
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            float p = exp2f(s[j][e] - m_new);
            if (edge && k0 + 8 * j + 2 * tq + (e & 1) >= sk) p = 0.f;
            s[j][e] = p;
            sum += p;
          }
        const float alpha = exp2f(m[r] - m_new);
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }

      // acc += P V: the S accumulators of keys 16c .. 16c+15, rounded to
      // bf16 pairs, are the A operand as they stand
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                               pack_bf16(s[2 * c][2], s[2 * c][3]),
                               pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                               pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int db = 0; db < DH / 16; ++db) {
          uint32_t bv[4];
          ldmatrix_x4_trans(v_tile + (c * 16 * P + db * 16) * 2, bv);
          mma_bf16(acc[2 * db], a, bv[0], bv[1]);
          mma_bf16(acc[2 * db + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // buffer buf is free for tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float norm = fmaxf(quad_sum(l[r]), 1e-30f);
    const int qp = qw0 + gr + 8 * r;
    if (qp >= sq) continue;
    bf16* o = out + (((long long)b * sq + qp) * hq + h) * dh;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d < dh)
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
            acc[n][2 * r] / norm, acc[n][2 * r + 1] / norm);
    }
  }
}

// ----- launch ---------------------------------------------------------------

template <typename T, int DH>
int launch_simt(const void* q, const void* k, const void* v, void* out, int b,
                int sq, int sk, int hq, int hkv, int dh, long long q_sb,
                long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                float scale, float softcap, int causal, int window,
                void* stream) {
  if (b * hq > 65535) return (int)cudaErrorInvalidValue;   // grid.y
  auto kernel = flash_attention_kernel_simt<T, DH>;
  const size_t smem = simt_smem_bytes(DH);
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

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int sk, int hq, int hkv, int dh, long long q_sb,
               long long q_ss, long long q_sh, long long k_sb, long long k_ss,
               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
               float scale, float softcap, int causal, int window,
               void* stream) {
  using Tile = MmaTile<DH>;
  auto kernel = flash_attention_kernel_mma<DH>;
  const size_t smem = Tile::kSmemBytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_tiles = (sq + Tile::kBQ - 1) / Tile::kBQ;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;   // grid.y
  const dim3 grid(b * hq, n_tiles);
  kernel<<<grid, 32 * Tile::kWarps, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, sq, sk, hq,
      hq / hkv, dh, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

// the body for dtype (0 = float32, 1 = bfloat16 on the tensor cores, 2 =
// bfloat16 on the SIMT body) at head_dim template DH
template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int b, int sq, int sk, int hq, int hkv, int dh, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, float softcap, int causal, int window, void* stream) {
  auto fn = dtype == 0   ? launch_simt<float, DH>
            : dtype == 1 ? launch_mma<DH>
                         : launch_simt<bf16, DH>;
  return fn(q, k, v, out, b, sq, sk, hq, hkv, dh, q_sb, q_ss, q_sh, k_sb,
            k_ss, k_sh, v_sb, v_ss, v_sh, scale, softcap, causal, window,
            stream);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory one block asks for at head_dim dh and dtype (0 =
// float32, 1 = bfloat16 on the tensor cores, 2 = bfloat16 on the SIMT
// body); 0 if dh > 256.
extern "C" long long flash_attention_smem_bytes(int dh, int dtype) {
#define FLASH_ATTENTION_SMEM(CAP)                                   \
  if (dh <= CAP)                                                  \
    return (long long)(dtype == 1 ? MmaTile<CAP>::kSmemBytes      \
                                  : simt_smem_bytes(CAP));
  FLASH_ATTENTION_SMEM(32)
  FLASH_ATTENTION_SMEM(64)
  FLASH_ATTENTION_SMEM(128)
  FLASH_ATTENTION_SMEM(256)
#undef FLASH_ATTENTION_SMEM
  return 0;
}

// q (B, Sq, Hq, dh), k / v (B, Sk, Hkv, dh) with the given element strides
// (head_dim stride 1) -> out, a contiguous (B, Sq, Hq, dh).  causal: 0 or
// 1; window: 0 = none.  dtype: 0 = float32, 1 = bfloat16 on the tensor
// cores (then the caller also guarantees dh % 8 == 0, every stride a
// multiple of 8 and q / k / v 16-byte aligned), 2 = bfloat16 on the SIMT
// body (any strides and alignment; the wrapper sends it dh % 8 != 0).  Needs 1 <= dh <= 256, Sq >= 1,
// Sk >= 1, Hq % Hkv == 0, and a grid.y within 65535: B * Hq on the SIMT
// body, Sq's query tiles on the tensor cores.  Launches on the calling
// thread's current device, which the caller sets to the tensors' own.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int sk, int hq,
                               int hkv, int dh, long long q_sb,
                               long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, float scale,
                               float softcap, int causal, int window,
                               int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hq < 1 || hkv < 1 || hq % hkv ||
      dh < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
#define FLASH_ATTENTION_CASE(CAP)                                             \
  if (dh <= CAP)                                                            \
    return launch<CAP>(dtype, q, k, v, out, b, sq, sk, hq, hkv, dh, q_sb,   \
                       q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,      \
                       scale, softcap, causal, window, stream);
  FLASH_ATTENTION_CASE(32)
  FLASH_ATTENTION_CASE(64)
  FLASH_ATTENTION_CASE(128)
  FLASH_ATTENTION_CASE(256)
#undef FLASH_ATTENTION_CASE
  return (int)cudaErrorInvalidValue;
}
