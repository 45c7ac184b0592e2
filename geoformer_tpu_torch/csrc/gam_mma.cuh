// Tile machinery of the masked-KV attention kernels (K2 forward, K3
// backward): f32-accurate products on the tensor cores from
// mma.sync.m16n8k8 TF32 (and, for K2's bf16 path, m16n8k16 bf16 with
// ldmatrix), cp.async copies of [64][64] tiles into shared memory, and the
// list of key tiles that hold a kept key.
//
// Precision. A TF32 operand keeps 11 of f32's 24 significant bits. An f32
// value x is split into hi = tf32(x) and lo = tf32(x - hi), and a product
// is summed as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b ("3xTF32"; lo*lo is
// dropped), which keeps about 21 bits. A bf16 value is exact in TF32, so an
// operand that comes from a bf16 input is not split and its lo terms are
// skipped at compile time. On the bf16 path an f32 operand (P) is split
// into two bf16 (16 bits), against a bf16 operand that is exact.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A 16x8 (row):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B 8x8  (col):  b0 (k=t, n=g)   b1 (k=t+4, n=g)
//   C 16x8:        c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A product's sum runs over k in any order, so where A comes from an
// accumulator (P or dS) the k index is permuted: k = t is column 2t and
// k = t+4 column 2t+1 of the C tile. Then a = (c0, c2, c1, c3) with no
// shuffle, and the B rows are read in the same order (load_b).
#pragma once

#include <cstdint>
#include <type_traits>

#include "gam_common.cuh"

namespace gam {

constexpr int kTile = 64;           // queries or keys per tile; head width
constexpr int kTileThreads = 128;   // 4 warps of 16 rows each

// Row stride (elements) of a [64][64] tile of T in shared memory: 68 floats
// or 72 bf16. Row-major fragment reads (load_a, load_bt) then hit 32
// different banks, and column reads (load_b) too; every row starts on a
// 16-byte boundary for cp.async.
template <typename T> struct TileStride;
template <> struct TileStride<float> { static constexpr int value = 68; };
template <> struct TileStride<__nv_bfloat16> {
  static constexpr int value = 72;
};
template <typename T>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * TileStride<T>::value * sizeof(T);
}

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Copies rows [0, 64) of a [64][64] slab of T (global row stride rs
// elements) into a shared tile; rows >= valid are zero-filled. No commit.
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long rs, int valid) {
  constexpr int kChunks = kTile * sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int kPer = 16 / sizeof(T);
  for (int i = threadIdx.x; i < kTile * kChunks; i += kTileThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool ok = r < valid;
    cp_async16(dst + r * TileStride<T>::value + c,
               src + (ok ? r * rs : 0) + c, ok);
  }
}

// -------------------------------------------------------------- values ----

__device__ __forceinline__ float lds(const float* p) { return *p; }
__device__ __forceinline__ float lds(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32 when kSplit; else x is exact in TF32 (a bf16 value).
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kSplit) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// ----------------------------------------------------------- fragments ----

// A operand: rows r0.., columns c0.. of a shared tile (natural layout).
template <bool kSplit, typename T>
__device__ __forceinline__ void load_a(const T* tile, int r0, int c0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  constexpr int ST = TileStride<T>::value;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = tile + (r0 + g) * ST + c0 + t;
  split<kSplit>(lds(p), hi[0], lo[0]);
  split<kSplit>(lds(p + 8 * ST), hi[1], lo[1]);
  split<kSplit>(lds(p + 4), hi[2], lo[2]);
  split<kSplit>(lds(p + 8 * ST + 4), hi[3], lo[3]);
}

// B operand that is the transpose of a shared tile X: B(k, n) =
// X[n0 + n][k0 + k], i.e. the n index runs over X's rows.
template <bool kSplit, typename T>
__device__ __forceinline__ void load_bt(const T* tile, int n0, int k0,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  constexpr int ST = TileStride<T>::value;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = tile + (n0 + g) * ST + k0 + t;
  split<kSplit>(lds(p), hi[0], lo[0]);
  split<kSplit>(lds(p + 4), hi[1], lo[1]);
}

// B operand B(k, n) = X[k0 + k][n0 + n], the k index running over X's rows
// in the permuted order of a_from_acc: k = t is row 2t, k = t+4 row 2t+1.
template <bool kSplit, typename T>
__device__ __forceinline__ void load_b(const T* tile, int k0, int n0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  constexpr int ST = TileStride<T>::value;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = tile + (k0 + 2 * t) * ST + n0 + g;
  split<kSplit>(lds(p), hi[0], lo[0]);
  split<kSplit>(lds(p + ST), hi[1], lo[1]);
}

// A operand from a 16x8 accumulator tile (its 8 columns are the k index,
// permuted as above). Always split: P and dS are computed f32 values.
__device__ __forceinline__ void a_from_acc(const float (&c)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split<true>(c[0], hi[0], lo[0]);
  split<true>(c[2], hi[1], lo[1]);
  split<true>(c[1], hi[2], lo[2]);
  split<true>(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b with the lo terms of the split operands (3xTF32 when both are).
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (kSplitA) mma_tf32(d, al, bh);
  if (kSplitB) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// ------------------------------------------------- bf16 tensor-core path ----
// mma.m16n8k16 .bf16 (f32 accumulators; C layout as above):
//   A 16x16: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//            a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
// each register holding two bf16 (the lower column in the low half).

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. With kTrans each lane gets the transpose's
// fragment (two values of one column).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// (x0, x1) = hi + lo with hi, lo pairs of bf16 (16 of the 24 bits).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// -------------------------------------------------------- mask and rows ----

// The key tiles of one batch row that hold a kept key, in order: fills
// list[0, n) and returns n, and bits[tile] with bit j set where key
// 64 * tile + j is kept. bits: ceil(len_kv / 64) words, list as many ints,
// of shared memory. Called by every thread of the block.
__device__ __forceinline__ int live_key_tiles(const unsigned char* mask,
                                              int len_kv,
                                              unsigned long long* bits,
                                              int* list, int* count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = cdiv(len_kv, kTile);
  for (int tile = warp; tile < n_tiles; tile += kTileThreads / 32) {
    const int s = tile * kTile + lane;
    const unsigned lo = __ballot_sync(kFullMask, s < len_kv && mask[s]);
    const unsigned hi =
        __ballot_sync(kFullMask, s + 32 < len_kv && mask[s + 32]);
    if (lane == 0) bits[tile] = (unsigned long long)hi << 32 | lo;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const bool live = base + lane < n_tiles && bits[base + lane] != 0ull;
      const unsigned ballot = __ballot_sync(kFullMask, live);
      if (live) list[n + __popc(ballot & ((1u << lane) - 1u))] = base + lane;
      n += __popc(ballot);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// Shared bytes of live_key_tiles' bits and list.
__host__ __device__ inline int live_list_bytes(int len_kv) {
  return cdiv(len_kv, kTile) * (int)(sizeof(unsigned long long) + sizeof(int));
}

// Kept and in-range bits of the 16 keys a lane's accumulators hold in a
// 64-key tile (bit 2n + e is key 8n + 2t + e), from the tile's mask word
// and the number of keys of the tile that exist.
__device__ __forceinline__ void lane_key_bits(unsigned long long tile_bits,
                                              int n_valid, unsigned& keep,
                                              unsigned& valid) {
  const int t = threadIdx.x & 3;
  keep = valid = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int key = 8 * n + 2 * t;
    keep |= (unsigned)((tile_bits >> key) & 3ull) << (2 * n);
    valid |= (key < n_valid ? 1u : 0u) << (2 * n);
    valid |= (key + 1 < n_valid ? 1u : 0u) << (2 * n + 1);
  }
}

// 2^x by the special-function unit (2 ulp; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// res[c] = (sum over rows r of src[r * rs + c]) / div for the 64 channels,
// in a fixed order (8 strided partial sums, then their sum). red: 512
// floats and res: 64 floats of shared memory. Called by every thread.
template <typename T>
__device__ __forceinline__ void column_mean(const T* src, long long rs,
                                            int rows, float div, float* red,
                                            float* res) {
  constexpr int kParts = kTileThreads / 16, kBatch = 8;
  const int c4 = (threadIdx.x & 15) * 4, part = threadIdx.x >> 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int r = part;
  for (; r + (kBatch - 1) * kParts < rows; r += kBatch * kParts) {
    float x[kBatch][4];  // kBatch loads in flight before the adds
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      load4(src + (r + u * kParts) * rs + c4, x[u]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += x[u][j];
  }
  for (; r < rows; r += kParts) {
    float x[4];
    load4(src + r * rs + c4, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += x[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[part * kTile + c4 + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < kTile) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) s += red[p * kTile + threadIdx.x];
    res[threadIdx.x] = s / div;
  }
  __syncthreads();
}

// dst[r * rs + c] = val[c] (or 0 when val is null) for r < rows, c < 64.
__device__ __forceinline__ void fill_rows(float* dst, long long rs, int rows,
                                          const float* val) {
  for (int i = threadIdx.x; i < rows * 16; i += kTileThreads) {
    const int r = i >> 4, c4 = (i & 15) * 4;
    const float4 x = val ? make_float4(val[c4], val[c4 + 1], val[c4 + 2],
                                       val[c4 + 3])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * rs + c4) = x;
  }
}

}  // namespace gam
