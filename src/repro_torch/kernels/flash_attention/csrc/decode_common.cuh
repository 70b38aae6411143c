// Shared body of the two decode-attention kernels (ragged_decode.cu,
// paged_decode.cu), which replace the TPU kernels ragged_decode_bhsd and
// paged_decode_bhsd (src/repro/kernels/flash_attention/kernel.py:132,
// :227; bodies :87, :180).
//
// One decode step: the G query heads that share kv head hk (query heads
// hk*G .. hk*G+G-1, the packing of q.reshape(b, hkv, g, dh)) attend to
// their row's live key prefix [0, n_keys).
//
// What bounds it on the card: the bytes of the live K/V prefix, read once
// (2 * n_keys * dh * sizeof(T) per row and kv head).  The arithmetic is
// about 2 * G flops per K/V element, far below the H100's ridge; what
// held the first version back was 16 blocks on 132 SMs walking whole
// prefixes, scalar loads, and per-element shared-memory arithmetic.
//
// Split-KV ("flash decoding"), two launches from one C entry point:
//
// 1. The split pass runs a grid of (B*Hkv, n_split, ceil(G/R)) blocks of
//    kThreads threads.  Block (bh, s, z) owns keys [s*chunk, (s+1)*chunk)
//    of row b's prefix and R of the kv head's G query rows.  n_split
//    comes from the cache's capacity, never from cur, so the grid depends
//    on shapes only (no host sync; a CUDA graph can capture the launch).
//    A block whose chunk starts at or past n_keys exits at once.  The
//    block stages its keys' K and V rows in shared memory with 16-byte
//    cp.async (every load of a tile in flight at once; element loads
//    where dh, a stride or the alignment rule 16 bytes out), then:
//    - bf16 with 16-byte rows and dh <= 64 runs on the tensor cores
//      (mma_block, R = 16: one m16 tile of query rows; S = q K^T and
//      acc += P V by mma.sync m16n8k16 with fp32 accumulators);
//    - anything else runs on the FMA units (split_block, R = kWarps: one
//      query row per warp or more warps per row; a group of lanes reads
//      a key row, kElems elements a lane, q pre-scaled by dh^-0.5 in
//      registers, the group's partial dot products summed by
//      __shfl_xor_sync).
//    Both keep the reference's finite -1e30 (p = 0 past n_keys) and
//    softcap by tanhf, run an online softmax per warp, merge the warps in
//    shared memory in warp order, and write one fp32 partial (m, l,
//    acc[dh]) per query row.
// 2. The combine pass, one block per (bh, query row), merges the row's
//    live partials in a fixed order, divides by max(l, 1e-30) (so a row
//    with no keys gives zeros) and writes q's dtype.  No atomics: the
//    result is the same from run to run.
//
// Chunks, tiles, warps' keys and the order of every sum depend on the key
// index alone, never on the page size or the capacity, so the same cache
// contents give bit-identical outputs through either kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kElems = 8;            // elements of a key row per lane
constexpr int kMaxDh = 32 * kElems;  // a key row takes one warp at most
constexpr float kNegInf = -1e30f;    // NEG_INF of the reference kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// kElems elements of one key row as loaded, in 32-bit words (fp32: one
// element a word; bf16: two, the lower element in the low half), turned
// into fp32 on use: a bf16 is the high half of its fp32.  Plain words,
// never addressed, so the packs live in registers.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  uint32_t w[kElems];
  __device__ __forceinline__ float get(int e) const {
    return __uint_as_float(w[e]);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  uint32_t w[kElems / 2];
  __device__ __forceinline__ float get(int e) const {
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stages a lane's kElems elements of a key row (global src, shared dst,
// both at the lane's first element): the first n (a multiple of VEC) from
// the row, zeros for the rest up to the tile's pitch (`room` elements
// from dst), so that a staged row is defined over its whole pitch.
template <typename T, int VEC>
__device__ __forceinline__ void stage_slice(T* dst, const T* __restrict__ src,
                                            int n, int room) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte or scalar");
  if constexpr (VEC > 1) {
#pragma unroll
    for (int i = 0; i < kElems; i += VEC)
      if (i < room) cp_async16(dst + i, src + (i < n ? i : 0), i < n);
  } else {
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      if (e < room) dst[e] = e < n ? src[e] : T(0.f);
  }
}

// A lane's kElems elements of a staged row (16-byte aligned in shared
// memory), or zeros.
template <typename T>
__device__ __forceinline__ void read_pack(const T* src, bool active,
                                          Pack<T>& dst) {
  constexpr int kWords = kElems * sizeof(T) / 4;
#pragma unroll
  for (int i = 0; i < kWords; i += 4) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (active) x = reinterpret_cast<const uint4*>(src)[i / 4];
    dst.w[i] = x.x;
    dst.w[i + 1] = x.y;
    dst.w[i + 2] = x.z;
    dst.w[i + 3] = x.w;
  }
}

// Keys a group of the SIMT body reads per step from the staged tile: 64
// bytes of K and 64 of V a lane (4 keys in bf16, 2 in fp32).
template <typename T>
__host__ __device__ constexpr int keys_per_step() {
  return 64 / (int)(kElems * sizeof(T));
}

// exp(x) for x <= 0 (a score minus a running max) on the special function
// unit: ex2.approx of x * log2(e).  exp(0) = 1 and exp(-1e30 - m) = 0
// exactly, as the reference's finite mask needs.
__device__ __forceinline__ float exp_neg(float x) { return __expf(x); }

// Lanes per key row: the least power of two with L * kElems >= dh.
__device__ __forceinline__ int lanes_per_key(int dh) {
  int lanes = 1;
  while (lanes * kElems < dh) lanes <<= 1;
  return lanes;
}

// A split block stages its keys' K and V rows in shared memory in tiles
// of at most kStageBytes (all its loads in flight at once), at a pitch of
// dh rounded up to kElems.
constexpr int kStageBytes = 36 * 1024;
__host__ __device__ inline int tile_pitch(int dh) {
  return (dh + kElems - 1) / kElems * kElems;
}
__host__ __device__ inline int tile_keys(int dh, int elt) {
  return kStageBytes / (2 * tile_pitch(dh) * elt);
}

// Dynamic shared memory of a split block: the K and V tiles, then each
// warp's (m, l, acc[dh]).
inline size_t split_smem_bytes(int dh, int elt) {
  return (size_t)2 * tile_keys(dh, elt) * tile_pitch(dh) * elt +
         sizeof(float) * (size_t)kWarps * (dh + 2);
}

// Keys of the live prefix: rows with cur >= capacity are retired slots
// and read the whole cache; cur < 0 reads nothing.
__device__ __forceinline__ int live_keys(int cur, int capacity) {
  return cur < 0 ? 0 : min(cur, capacity - 1) + 1;
}

// One split block: up to kWarps query rows (q: the first, rows of dh
// contiguous elements, `rows` of them) over keys [c0, c1) of the row, c0
// < c1; rows_at.locate(t, k, v) points k and v at key t's dh elements.
// Each row takes kWarps / R warps (R: rows rounded up to a power of two),
// which split the keys between them.  The block first stages a tile of
// K/V rows in shared memory (16-byte cp.async, every load in flight at
// once), and every query row's warps read it there.  Writes the block's
// partial for its query row r at ml[2*r], ml[2*r + 1] (m, l) and
// acc[r*dh .. r*dh + dh).
template <typename T, int VEC, typename Rows>
__device__ __forceinline__ void split_block(
    const T* __restrict__ q, int rows, const Rows& rows_at, int c0, int c1,
    int dh, float scale, float softcap, float* __restrict__ ml,
    float* __restrict__ acc_out, float* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int rpad = 1;
  while (rpad < rows) rpad <<= 1;
  const int slices = kWarps / rpad;               // warps per query row
  const int row = warp / slices, slice = warp - row * slices;
  const int lanes = lanes_per_key(dh);
  const int groups = 32 / lanes;                  // key groups per warp
  const int lig = lane & (lanes - 1);             // lane in its group
  const int grp = lane / lanes;                   // group in the warp
  const int stride = slices * groups;             // a row's keys a sub-step
  const int d0 = lig * kElems;
  const int n_el = max(0, min(kElems, dh - d0));
  constexpr int kKeys = keys_per_step<T>();

  float qr[kElems], acc[kElems], m = kNegInf, l = 0.f;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    qr[e] = (row < rows && e < n_el) ? to_f32(q[row * dh + d0 + e]) * scale
                                     : 0.f;
    acc[e] = 0.f;
  }
  const int pitch = tile_pitch(dh), tile = tile_keys(dh, sizeof(T));
  T* sk = reinterpret_cast<T*>(smem);             // [tile][pitch]
  T* sv = sk + tile * pitch;
  float* sm_ml = reinterpret_cast<float*>(sv + tile * pitch);  // [kWarps][2]
  float* sm_acc = sm_ml + 2 * kWarps;             // [kWarps][dh]
  const int stage_group = warp * groups + grp;    // a row per group a pass

  for (int base = c0; base < c1; base += tile) {
    const int n = min(tile, c1 - base);
    // stage keys [base, base + n): one row per key group and pass
    for (int t = stage_group; t < n; t += kWarps * groups) {
      const T* kr;
      const T* vr;
      rows_at.locate(base + t, kr, vr);
      stage_slice<T, VEC>(sk + t * pitch + d0, kr + d0, n_el, pitch - d0);
      stage_slice<T, VEC>(sv + t * pitch + d0, vr + d0, n_el, pitch - d0);
    }
    if constexpr (VEC > 1) cp_async_wait_all();
    __syncthreads();

    // the warp's keys of the tile: t0 + j * stride + grp; t0 is the same
    // on every lane, so the whole warp takes each step (the shuffles need
    // all 32 lanes); padding warps (row >= rows) take none
    const int n_row = row < rows ? n : 0;
    for (int t0 = slice * groups; t0 < n_row; t0 += stride * kKeys) {
      Pack<T> kp[kKeys], vp[kKeys];
      bool valid[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int t = t0 + j * stride + grp;
        valid[j] = t < n_row;
        read_pack<T>(sk + t * pitch + d0, valid[j] && n_el > 0, kp[j]);
        read_pack<T>(sv + t * pitch + d0, valid[j] && n_el > 0, vp[j]);
      }
      // scores: this lane's partial dot products, then the group's sum
      float s[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) a = fmaf(qr[e], kp[j].get(e), a);
        s[j] = a;
      }
      for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      // online softmax over the step's keys
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (softcap > 0.f) s[j] = tanhf(s[j] / softcap) * softcap;
        if (valid[j]) mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = exp_neg(m - m_new);
      float p[kKeys], sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        p[j] = valid[j] ? exp_neg(s[j] - m_new) : 0.f;
        sum += p[j];
      }
      l = l * alpha + sum;
      m = m_new;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        float a = acc[e] * alpha;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) a = fmaf(p[j], vp[j].get(e), a);
        acc[e] = a;
      }
    }
    __syncthreads();                              // the tile is reused
  }

  // merge the warp's key groups (butterfly over the group index)
  for (int o = lanes; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, m2);
    const float a1 = exp_neg(m - mn), a2 = exp_neg(m2 - mn);
    l = l * a1 + l2 * a2;
    m = mn;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const float x2 = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * a1 + x2 * a2;
    }
  }
  // merge each row's warps in shared memory, in warp order
  if (lane < lanes) {
    if (lane == 0) {
      sm_ml[2 * warp] = m;
      sm_ml[2 * warp + 1] = l;
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      if (e < n_el) sm_acc[warp * dh + d0 + e] = acc[e];
  }
  __syncthreads();
  for (int i = tid; i < rows * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const int w0 = r * slices;
    float mb = kNegInf;
    for (int w = w0; w < w0 + slices; ++w) mb = fmaxf(mb, sm_ml[2 * w]);
    float a = 0.f, lb = 0.f;
    for (int w = w0; w < w0 + slices; ++w) {
      const float x = exp_neg(sm_ml[2 * w] - mb);
      a += sm_acc[w * dh + d] * x;
      lb += sm_ml[2 * w + 1] * x;
    }
    acc_out[i] = a;
    if (d == 0) {
      ml[2 * r] = mb;
      ml[2 * r + 1] = lb;
    }
  }
}

// ---- the tensor-core body: bf16, 16-byte aligned rows, dh <= 64 ---------

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

// The tensor-core block's tiles: DHC is dh rounded up to 64 (the
// columns past dh are staged as zeros), P the pitch (16 bytes of padding
// against ldmatrix bank conflicts), kKeys the keys of a K/V tile (a
// multiple of 16).  After the last tile the merge area overlays the
// tiles; q sits in front.
constexpr int kMmaRows = 16;     // query rows of a block: one m16 tile
template <int DHC>
struct MmaTile {
  static constexpr int P = DHC + 8;
  static constexpr int kKeys = kStageBytes / (2 * 2 * P) / 16 * 16;
  static constexpr size_t kQBytes = 2 * kMmaRows * P;
  static constexpr size_t kTileBytes = 2 * 2 * (size_t)kKeys * P;
  static constexpr size_t kMergeBytes =
      sizeof(float) * kWarps * kMmaRows * (DHC + 2);
  static constexpr size_t kSmem =
      kQBytes + (kTileBytes > kMergeBytes ? kTileBytes : kMergeBytes);
};

// One split block on the tensor cores: up to 16 query rows (q: the
// first, rows of dh contiguous bf16, `rows` of them) over keys [c0, c1)
// of the row.  K/V tiles are staged in shared memory with 16-byte
// cp.async; warp w takes the tile's 16-key blocks w, w + kWarps, ...: S =
// q K^T (mma.sync m16n8k16, fp32 accumulate, q fragments in registers,
// K through ldmatrix), scaled by dh^-0.5 in fp32, softcap, the finite
// mask (p = 0 past the row's keys), online softmax per query row across
// the 4 lanes that hold it, then acc += P V with P rounded to bf16 as the
// A operand and V through ldmatrix.trans.  The warps then merge in shared
// memory in warp order.  Same outputs as split_block (the partial
// layout), to bf16's rounding of P.
template <int DHC, typename Rows>
__device__ __forceinline__ void mma_block(
    const __nv_bfloat16* __restrict__ q, int rows, const Rows& rows_at,
    int c0, int c1, int dh, float scale, float softcap,
    float* __restrict__ ml, float* __restrict__ acc_out, float* smem) {
  using Tile = MmaTile<DHC>;
  constexpr int P = Tile::P, BK = Tile::kKeys;
  constexpr int kPieces = DHC / 8;                // 16-byte pieces a row
  using bf16 = __nv_bfloat16;
  char* base = reinterpret_cast<char*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(base);       // [16][P]
  bf16* ks = reinterpret_cast<bf16*>(base + Tile::kQBytes);  // [BK][P]
  bf16* vs = ks + BK * P;
  float* mg = reinterpret_cast<float*>(base + Tile::kQBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;

  // q rows, zero past `rows` and dh; a lane stages one 16-byte piece of
  // one row a pass (kPieces lanes a row)
  for (int i = tid; i < kMmaRows * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool full = r < rows && c < dh;
    cp_async16(qs + r * P + c, q + (full ? r * dh + c : 0), full);
  }

  // ldmatrix lane offsets (elements).  q (A): lanes 0-15 rows 0-15 at
  // column 0, 16-31 at column 8.  K (B of S, two n-blocks of 8 keys):
  // lanes 0-7 keys 0-7 at d 0, 8-15 keys 0-7 at d 8, 16-23 keys 8-15 at
  // d 0, 24-31 keys 8-15 at d 8.  V (B of P V, transposed, two n-blocks
  // of 8 columns): lanes 0-7 keys 0-7 at column 0, 8-15 keys 8-15 at
  // column 0, 16-31 the same at column 8.
  const uint32_t q_lane = smem_addr(qs + (lane & 15) * P + (lane >> 4) * 8);
  const uint32_t k_lane = smem_addr(
      ks + ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = smem_addr(
      vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * P + (lane >> 4) * 8);

  uint32_t qa[DHC / 16][4];
  float acc[DHC / 8][4];
#pragma unroll
  for (int n = 0; n < DHC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max and this lane's part of l, for rows gr and gr + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int row_lanes = kPieces;                  // lanes staging a row
  const int stage_row = tid / row_lanes, piece = (tid % row_lanes) * 8;
  for (int t_base = c0; t_base < c1; t_base += BK) {
    const int n = min(BK, c1 - t_base);
    const int n16 = (n + 15) / 16 * 16;           // rows the warps read
    // K/V rows [t_base, t_base + n), zeros past n (up to n16) and past dh
    for (int t = stage_row; t < n16; t += kThreads / row_lanes) {
      const bool full = t < n && piece < dh;
      const bf16* kr;
      const bf16* vr;
      rows_at.locate(t_base + (t < n ? t : 0), kr, vr);
      cp_async16(ks + t * P + piece, kr + (full ? piece : 0), full);
      cp_async16(vs + t * P + piece, vr + (full ? piece : 0), full);
    }
    cp_async_wait_all();
    __syncthreads();
    if (t_base == c0) {
#pragma unroll
      for (int kk = 0; kk < DHC / 16; ++kk)
        ldmatrix_x4(q_lane + kk * 32, qa[kk]);
    }

    for (int kb = warp; kb * 16 < n; kb += kWarps) {
      // S = q K^T: s[j] holds keys 8j .. 8j+7 of the 16-key block
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DHC / 16; ++kk) {
        uint32_t bk[4];
        ldmatrix_x4(k_lane + (kb * 16 * P + kk * 16) * 2, bk);
        mma_bf16(s[0], qa[kk], bk[0], bk[1]);
        mma_bf16(s[1], qa[kk], bk[2], bk[3]);
      }
      bool valid[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          valid[j][e] = kb * 16 + 8 * j + 2 * tq + (e & 1) < n;
          s[j][e] = valid[j][e] ? x : kNegInf;
        }
      // online softmax, in the reference's order: m_new, p, alpha, l, acc
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = valid[j][e] ? exp_neg(s[j][e] - m_new) : 0.f;
            s[j][e] = p;
            sum += p;
          }
        const float alpha = exp_neg(m[r] - m_new);
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int nd = 0; nd < DHC / 8; ++nd) {
          acc[nd][2 * r] *= alpha;
          acc[nd][2 * r + 1] *= alpha;
        }
      }
      // acc += P V: the S accumulators, rounded to bf16 pairs, are the A
      // operand as they stand
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int db = 0; db < DHC / 16; ++db) {
        uint32_t bv[4];
        ldmatrix_x4_trans(v_lane + (kb * 16 * P + db * 16) * 2, bv);
        mma_bf16(acc[2 * db], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * db + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                              // the tiles are reused
  }

  // merge the warps in shared memory (over the tiles), in warp order
  float* sm_acc = mg;                             // [kWarps][16][DHC]
  float* sm_m = mg + kWarps * kMmaRows * DHC;     // [kWarps][16]
  float* sm_l = sm_m + kWarps * kMmaRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (tq == 0) {
      sm_m[warp * kMmaRows + gr + 8 * r] = m[r];
      sm_l[warp * kMmaRows + gr + 8 * r] = lr;
    }
  }
#pragma unroll
  for (int nd = 0; nd < DHC / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sm_acc[(warp * kMmaRows + gr + 8 * (e >> 1)) * DHC + nd * 8 + 2 * tq +
             (e & 1)] = acc[nd][e];
  __syncthreads();
  for (int i = tid; i < rows * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm_m[w * kMmaRows + r]);
    float a = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = exp_neg(sm_m[w * kMmaRows + r] - mb);
      a += sm_acc[(w * kMmaRows + r) * DHC + d] * x;
      lb += sm_l[w * kMmaRows + r] * x;
    }
    acc_out[i] = a;
    if (d == 0) {
      ml[2 * r] = mb;
      ml[2 * r + 1] = lb;
    }
  }
}

// The combine pass: block (bh, r) merges the live partials of query row
// r of (batch row, kv head) bh in a fixed order.  Partials: ml[((bh *
// n_split + s) * g + r) * 2 + {0, 1}] (m, l) and acc[((bh * n_split + s)
// * g + r) * dh + d].  The threads read the partials' (m, l) together
// into shared memory; thread (d, part) then sums acc over the splits s =
// part (mod parts) and the parts are added in order, so every load of the
// block is in flight at once and the sums run in a fixed order.
constexpr int kCombineThreads = 256;

// Dynamic shared memory of a combine block: (weight, l * weight) per
// split and one partial sum per thread.
inline size_t combine_smem_bytes(int n_split) {
  return sizeof(float) * ((size_t)2 * n_split + kCombineThreads);
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const int* __restrict__ cur,
                      const float* __restrict__ ml,
                      const float* __restrict__ acc, T* __restrict__ out,
                      int hkv, int g, int dh, int capacity, int chunk,
                      int n_split) {
  extern __shared__ float smem[];
  float* w = smem;                      // [n_split]
  float* lw = smem + n_split;           // [n_split]
  float* part_sum = lw + n_split;       // [kCombineThreads]
  const int bh = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int n_keys = live_keys(cur[bh / hkv], capacity);
  const int n_live = (n_keys + chunk - 1) / chunk;
  const size_t p0 = (size_t)bh * n_split * g + r;   // partial of split 0
  for (int s = tid; s < n_live; s += kCombineThreads) {
    w[s] = ml[(p0 + (size_t)s * g) * 2];
    lw[s] = ml[(p0 + (size_t)s * g) * 2 + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, w[s]);
  __syncthreads();
  for (int s = tid; s < n_live; s += kCombineThreads) {
    const float x = exp_neg(w[s] - mx);
    w[s] = x;
    lw[s] *= x;
  }
  __syncthreads();
  const int cols = (dh + 31) / 32 * 32;
  const int parts = kCombineThreads / cols;
  const int d = tid % cols, part = tid / cols;
  float a = 0.f;
  if (d < dh && part < parts) {
#pragma unroll 4
    for (int s = part; s < n_live; s += parts)
      a += acc[(p0 + (size_t)s * g) * dh + d] * w[s];
  }
  part_sum[tid] = a;
  __syncthreads();
  if (part == 0 && d < dh) {
    for (int p = 1; p < parts; ++p) a += part_sum[p * cols + d];
    float lsum = 0.f;
    for (int s = 0; s < n_live; ++s) lsum += lw[s];
    store(out + ((size_t)bh * g + r) * dh + d, a / fmaxf(lsum, 1e-30f));
  }
}

// Launches the split kernel, then the combine kernel on the same stream;
// returns the first launch error (cudaGetLastError() after each).
template <typename T, typename Split, typename... Args>
int launch_pair(Split split, int rows_per_block, size_t smem, int b, int hkv,
                int g, int dh, int capacity, int chunk, int n_split,
                const int* cur, float* ws, T* out, void* stream,
                Args... args) {
  if (b * hkv == 0 || g == 0) return 0;
  if (combine_smem_bytes(n_split) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* ml = ws;
  float* acc = ws + (size_t)b * hkv * n_split * g * 2;
  const dim3 grid(b * hkv, n_split,
                  (g + rows_per_block - 1) / rows_per_block);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  split<<<grid, kThreads, smem, st>>>(args..., ml, acc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T><<<dim3(b * hkv, g), kCombineThreads,
                             combine_smem_bytes(n_split), st>>>(
      cur, ml, acc, out, hkv, g, dh, capacity, chunk, n_split);
  return (int)cudaGetLastError();
}

// The split body a call takes: the tensor cores for bf16 rows that allow
// 16-byte loads and dh <= 64 (DHC 64), else the SIMT body (DHC 0).
// -> (query rows a block serves, dynamic shared memory of a block).
inline int mma_cap(int dtype, int wide, int dh) {
  return dtype == 1 && wide && dh <= 64 ? 64 : 0;
}
inline int block_rows(int dhc) { return dhc ? kMmaRows : kWarps; }
inline size_t block_smem(int dhc, int dh, int elt) {
  return dhc ? MmaTile<64>::kSmem : split_smem_bytes(dh, elt);
}

}  // namespace decode_attn

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory one split block of either kernel asks for, for
// dtype (0 = float32, 1 = bfloat16) and 16-byte rows or not.
extern "C" long long decode_smem_bytes(int dh, int dtype, int wide) {
  const int dhc = decode_attn::mma_cap(dtype, wide, dh);
  return (long long)decode_attn::block_smem(dhc, dh, dtype ? 2 : 4);
}
