// K6: the streamed dual-softmax match extraction of the coarse matcher.
//
// Replaces the chunked loop of PyTorch ops of
// geoformer_tpu_torch/ops/streaming_match.py (streaming_match_extract's two
// passes over [B, 600, S] similarity tiles, each built in device memory and
// read some ten times). It replaces no TPU kernel: the JAX package computes
// this function with XLA ops (geoformer_tpu/ops/fused_loss.py: _tile,
// sim_lse, streaming_match_extract), not in Pallas.
//
// With t_ij = <f0_i, f1_j> * inv (inv = 1 / (C T)) and every masked entry
// set to the fill -1e9, as in _tile, a matching needs four vectors of each
// pair: the row LSE r, the column LSE c, the row arg-max of 2t - c (its
// value gives row_best = exp(max - r)) and the column arg-max of 2t - r.
// Two passes, each a matrix product with an online epilogue, like
// FlashAttention's forward but with column statistics as well as row ones:
//   lse:    per row the running max and sum of exp over the columns; per
//           column each row block's partial (max, sum of exp), which a
//           merge kernel reduces over the row blocks;
//   argmax: per row the running max of 2t - c and its first column; per
//           column each row block's max of 2t - r and its first row, which
//           the merge kernel takes in row order (strict >: the earliest row
//           wins ties, as in the plain loop).
// No similarity tile is written to device memory.
//
// What bounds it on an H100: the products. At the matcher's shape (B = 8,
// L = S = 5120, C = 256) a pass is 2 B L S C = 107 GFLOP, 0.65 ms in
// 3xTF32 on the tensor cores (495 / 3 TFLOP/s for f32-accurate products),
// 1.6 ms in f32 FFMA; the bytes (features in, vectors and a few MB of
// partials) take ~0.02 ms.
//
// Design: a block of 8 warps takes 128 rows of a pair against one split of
// its columns (the wrapper picks the splits that fill the last wave). The
// rows (C <= 256 f32) stay in shared memory; feat1 streams through in tiles
// of 64 columns, 64 channels a stage, in a 4-stage cp.async ring (feat1 is
// 5 MB a pair and stays in L2). The products run on mma.sync m16n8k8 TF32
// with 3xTF32 splitting (split_fast below), both operands read with
// ldmatrix (an f32 is a pair of b16, so one ldmatrix.x4 gives a whole TF32
// fragment). The tensor core truncates as it accumulates, so the hi*hi
// terms are summed two k-steps at a time from zero and added in f32
// (rounded to nearest); the small lo terms keep their own sum. At the
// matcher's shape this holds r within 4e-6 of an f64 evaluation, where the
// plain f32 loop (cuBLAS FFMA) is 1e-5 off. Each warp owns 32 rows x 32
// columns of a tile. The row statistics stay in registers across the
// column loop; the column statistics reduce over a warp's rows by shuffles
// and over the block's four row warps in shared memory, one tile behind, so
// that the reduction rides on the next tile's first barrier. A tile with no
// valid (row, column) pair skips its products and reads as all fill, which
// is what the plain version reads there. expf and logf are the accurate
// ones (the build has no fast math).

#include <cstdint>

#include "gam_mma.cuh"

namespace {

constexpr int kBM = 128;       // rows of feat0 a block
constexpr int kBN = 64;        // columns of feat1 a tile
constexpr int kBK = 64;        // channels a copy stage
constexpr int kMaxC = 256;     // channels the resident rows hold
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps: 4 along the rows x 2 along a tile
constexpr int kRowWarps = 4;
constexpr int kAStride = kMaxC + 4;  // floats; rows 16-byte aligned, and the
constexpr int kBStride = kBK + 4;    // 8 rows of an ldmatrix hit 32 banks
constexpr float kFill = -1e9f;       // the plain version's mask fill

constexpr int kSmemFixed =
    (kBM * kAStride + kStages * kBN * kBStride) * (int)sizeof(float) +
    (2 * kRowWarps * kBN + kBM) * (int)sizeof(float2);

__host__ __device__ inline int smem_bytes(int tiles_per_split) {
  return kSmemFixed + tiles_per_split * (int)sizeof(int);
}

// (v, i) beats (bv, bi): larger, or equal with the smaller index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float shfl(float x, int m) {
  return __shfl_xor_sync(gam::kFullMask, x, m);
}
__device__ __forceinline__ int shfl(int x, int m) {
  return __shfl_xor_sync(gam::kFullMask, x, m);
}

// The 4 rows (of 128) and 8 columns (of 64) a lane's accumulators hold:
// big[mt][nt][j] (and small) is row wr*32 + mt*16 + (j>>1)*8 + g and column
// wc*32 + nt*8 + 2t + (j&1). Index i = 2 mt + (j>>1) of the rows and
// n = 2 nt + (j&1) of the columns, both ascending.
__device__ __forceinline__ int lane_row(int wr, int i, int g) {
  return wr * 32 + (i >> 1) * 16 + (i & 1) * 8 + g;
}
__device__ __forceinline__ int lane_col(int wc, int n, int t) {
  return wc * 32 + (n >> 1) * 8 + 2 * t + (n & 1);
}

// x = hi + lo with hi rounded to TF32 (half an ulp up, then the low 13
// bits cleared: two integer operations, where cvt.rna takes the slower
// conversion unit) and lo = x - hi, exact in f32; the tensor core reads the
// top 10 mantissa bits of lo, so each product keeps ~21 bits, as with
// gam::split.
__device__ __forceinline__ void split_fast(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void fadd(float (&acc)[2][4][4],
                                     const float (&x)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] += x[mt][nt][j];
}

// One k-step of 8 channels for a warp's 32 x 32 products: the A fragments
// (two 16-row tiles) from the resident rows at column at, the B fragments
// (four 8-column tiles) from the stage at bt, each by one ldmatrix.x4 per
// pair of tiles. The lo terms go into small; the hi*hi terms into tmp, which
// starts from 0 where odd is 0 and is added to big (FADD, rounded to
// nearest) where odd is 1. The tensor core truncates each sum it adds
// into its accumulator, so the 96 mma of a tile's products, kept in one
// register, drift by up to ~1 ulp of the running sum each; big's partial
// sums span two k-steps.
__device__ __forceinline__ void k_step(const float* at, const float* bt,
                                       int wr, int wc, int lane, int odd,
                                       float (&big)[2][4][4],
                                       float (&small)[2][4][4],
                                       float (&tmp)[2][4][4]) {
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t x[4];
    gam::ldmatrix_x4<false>(
        x, at + (wr * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                    kAStride + (lane >> 4) * 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) split_fast(x[q], ah[mt][q], al[mt][q]);
  }
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t x[4];
    gam::ldmatrix_x4<false>(
        x, bt + (wc * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                    kBStride + ((lane >> 3) & 1) * 4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split_fast(x[q], bh[2 * np + (q >> 1)][q & 1],
                 bl[2 * np + (q >> 1)][q & 1]);
  }
  if (odd != 1)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) tmp[mt][nt][j] = 0.f;
  // independent products back to back: the hi*hi terms, then the lo terms
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) gam::mma_tf32(tmp[mt][nt], ah[mt], bh[nt]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      gam::mma_tf32(small[mt][nt], al[mt], bh[nt]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      gam::mma_tf32(small[mt][nt], ah[mt], bl[nt]);
  if (odd) fadd(big, tmp);
}

template <bool kArgmax>
__global__ void __launch_bounds__(kThreads, 1)
extract_pass(const float* __restrict__ f0, const float* __restrict__ f1,
             const unsigned char* __restrict__ m0,
             const unsigned char* __restrict__ m1,
             const float* __restrict__ r_vec, const float* __restrict__ c_vec,
             float2* __restrict__ col_part, float2* __restrict__ row_part,
             int len0, int len1, int ch, int tiles_per_split, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);         // [128][kAStride]
  float* bs = as + kBM * kAStride;                    // [4][64][kBStride]
  float2* red = reinterpret_cast<float2*>(bs + kStages * kBN * kBStride);
  float2* rowx = red + 2 * kRowWarps * kBN;           // [128]
  int* live = reinterpret_cast<int*>(rowx + kBM);     // [tiles_per_split]
  __shared__ int n_live_s, any_row_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int blk = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int row0 = blk * kBM;
  const int rows_here = min(kBM, len0 - row0);
  const int n_tiles = gam::cdiv(len1, kBN);
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  const int n_kc = gam::cdiv(ch, kBK);
  const float* f0b = f0 + ((long long)b * len0 + row0) * ch;
  const float* f1b = f1 + (long long)b * len1 * ch;
  const unsigned char* m0b = m0 ? m0 + (long long)b * len0 + row0 : nullptr;
  const unsigned char* m1b = m1 ? m1 + (long long)b * len1 : nullptr;

  // ---- the block's rows into shared memory (group 0 of the ring)
  for (int i = tid; i < kBM * (kMaxC / 4); i += kThreads) {
    const int r = i / (kMaxC / 4), c = (i % (kMaxC / 4)) * 4;
    const bool ok = r < rows_here && c < ch;
    gam::cp_async16(as + r * kAStride + c, ok ? f0b + (long long)r * ch + c
                                              : f0, ok);
  }

  // ---- the tiles of this split that hold a valid (row, column) pair
  const int span = tile1 - tile0;
  if (tid == 0) any_row_s = m0b == nullptr;
  for (int i = tid; i < span; i += kThreads) live[i] = m1b == nullptr;
  __syncthreads();
  if (m0b != nullptr)
    for (int i = tid; i < rows_here; i += kThreads)
      if (m0b[i]) any_row_s = 1;
  if (m1b != nullptr)
    for (int i = tid; i < span * kBN; i += kThreads) {
      const int col = tile0 * kBN + i;
      if (col < len1 && m1b[col]) live[i / kBN] = 1;
    }
  __syncthreads();
  if (warp == 0) {  // compact in place: list[k] = k-th live tile
    int n = 0;
    if (any_row_s)
      for (int base = 0; base < span; base += 32) {
        const bool ok = base + lane < span && live[base + lane] != 0;
        const unsigned ballot = __ballot_sync(gam::kFullMask, ok);
        __syncwarp();
        if (ok) live[n + __popc(ballot & ((1u << lane) - 1u))] =
            tile0 + base + lane;
        n += __popc(ballot);
        __syncwarp();
      }
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_items = n_live_s * n_kc;  // (live tile, channel stage) pairs

  auto prefetch = [&](int item) {
    if (item < n_items) {
      const int col0 = live[item / n_kc] * kBN, ch0 = (item % n_kc) * kBK;
      float* dst = bs + (item % kStages) * kBN * kBStride;
      for (int i = tid; i < kBN * (kBK / 4); i += kThreads) {
        const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
        const bool ok = col0 + r < len1 && ch0 + c < ch;
        gam::cp_async16(dst + r * kBStride + c,
                        ok ? f1b + (long long)(col0 + r) * ch + ch0 + c : f1,
                        ok);
      }
    }
    gam::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  // ---- the lane's rows
  bool row_in[4], row_ok[4];
  float r_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = lane_row(wr, i, g);
    row_in[i] = lr < rows_here;
    row_ok[i] = row_in[i] && (m0b == nullptr || m0b[lr]);
    r_row[i] = kArgmax && row_in[i] ? r_vec[(long long)b * len0 + row0 + lr]
                                    : 0.f;
  }
  // running row state: lse (max, sum of exp); argmax (max, first column)
  float rm[4], rl[4];
  int rj[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rm[i] = -INFINITY;
    rl[i] = 0.f;
    rj[i] = INT32_MAX;
  }

  // column partials of the tile that waits in red[tile & 1]: 64 threads
  // merge the four row warps and write the block's partial
  auto flush = [&](int tile) {
    const int col = tile * kBN + tid;
    if (tid < kBN && col < len1) {
      const float2* q = red + (tile & 1) * kRowWarps * kBN + tid;
      float2 out;
      if (kArgmax) {  // row warps in order, strict >: the first row wins
        out = q[0];
#pragma unroll
        for (int w = 1; w < kRowWarps; ++w)
          if (q[w * kBN].x > out.x) out = q[w * kBN];
        out.y = __int_as_float(row0 + __float_as_int(out.y));
      } else {
        float m = q[0].x;
#pragma unroll
        for (int w = 1; w < kRowWarps; ++w) m = fmaxf(m, q[w * kBN].x);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kRowWarps; ++w)
          s += q[w * kBN].y * expf(q[w * kBN].x - m);
        out = make_float2(m, s);
      }
      col_part[((long long)b * gridDim.x + blk) * len1 + col] = out;
    }
  };

  int item = 0, pending = -1;
  for (int tile = tile0; tile < tile1; ++tile) {
    const bool live_t = item < n_items && live[item / n_kc] == tile;
    // the products in two sums: the hi*hi terms (FADD-ed into big every two
    // k-steps from a fresh tensor-core sum) and the lo*hi, hi*lo terms
    float big[2][4][4], small[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) big[mt][nt][j] = small[mt][nt][j] = 0.f;
    if (live_t) {
      for (int kc = 0; kc < n_kc; ++kc, ++item) {
        gam::cp_async_wait<kStages - 2>();
        __syncthreads();
        if (kc == 0 && pending >= 0) {
          flush(pending);
          pending = -1;
        }
        prefetch(item + kStages - 1);
        const float* bt = bs + (item % kStages) * kBN * kBStride;
        const float* at = as + kc * kBK;
        const int left = ch - kc * kBK;
        if (left >= kBK) {
          float tmp[2][4][4];
#pragma unroll
          for (int ks = 0; ks < kBK / 8; ++ks)
            k_step(at + ks * 8, bt + ks * 8, wr, wc, lane, ks & 1, big, small,
                   tmp);
        } else {
          for (int ks = 0; ks * 8 < left; ++ks) {
            float tmp[2][4][4];
            k_step(at + ks * 8, bt + ks * 8, wr, wc, lane, 0, big, small, tmp);
            fadd(big, tmp);
          }
        }
      }
    } else {
      __syncthreads();
      if (pending >= 0) {
        flush(pending);
        pending = -1;
      }
    }

    // ---- the tile's values: t, the fill, or -inf outside the matrix
    float v[4][8], c_col[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = tile * kBN + lane_col(wc, n, t);
      const bool in = col < len1;
      const bool keep = in && (m1b == nullptr || m1b[col]);
      c_col[n] = kArgmax && in ? c_vec[(long long)b * len1 + col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = i >> 1, nt = n >> 1, j = (i & 1) * 2 + (n & 1);
        const float x = big[mt][nt][j] + small[mt][nt][j];
        v[i][n] = !(row_in[i] && in) ? -INFINITY
                  : live_t && row_ok[i] && keep ? x * inv : kFill;
      }
    }
    float2* red_t = red + (tile & 1) * kRowWarps * kBN + wr * kBN;

    if (!kArgmax) {
      // rows: the online max and sum of exp over the warp's 32 columns
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = v[i][0];
#pragma unroll
        for (int n = 1; n < 8; ++n) mx = fmaxf(mx, v[i][n]);
        mx = fmaxf(mx, shfl(mx, 1));
        mx = fmaxf(mx, shfl(mx, 2));
        const float m_new = fmaxf(rm[i], mx);
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        float s = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) s += expf(v[i][n] - mu);
        s += shfl(s, 1);
        s += shfl(s, 2);
        rl[i] = rl[i] * expf(rm[i] - mu) + s;
        rm[i] = m_new;
      }
      // columns: max and sum of exp over the warp's 32 rows
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float mx = v[0][n];
#pragma unroll
        for (int i = 1; i < 4; ++i) mx = fmaxf(mx, v[i][n]);
        mx = fmaxf(mx, shfl(mx, 4));
        mx = fmaxf(mx, shfl(mx, 8));
        mx = fmaxf(mx, shfl(mx, 16));
        const float mu = mx == -INFINITY ? 0.f : mx;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) s += expf(v[i][n] - mu);
        s += shfl(s, 4);
        s += shfl(s, 8);
        s += shfl(s, 16);
        if (g == 0) red_t[lane_col(wc, n, t)] = make_float2(mx, s);
      }
    } else {
      // rows: the running max of 2t - c and its first column
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float bv = -INFINITY;
        int bj = INT32_MAX;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float u = 2.f * v[i][n] - c_col[n];
          const int j = tile * kBN + lane_col(wc, n, t);
          if (beats(u, j, bv, bj)) {
            bv = u;
            bj = j;
          }
        }
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          const float ov = shfl(bv, m);
          const int oj = shfl(bj, m);
          if (beats(ov, oj, bv, bj)) {
            bv = ov;
            bj = oj;
          }
        }
        if (beats(bv, bj, rm[i], rj[i])) {
          rm[i] = bv;
          rj[i] = bj;
        }
      }
      // columns: the max of 2t - r over the warp's 32 rows, first row
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float bv = -INFINITY;
        int bi = INT32_MAX;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float u = 2.f * v[i][n] - r_row[i];
          const int lr = lane_row(wr, i, g);
          if (beats(u, lr, bv, bi)) {
            bv = u;
            bi = lr;
          }
        }
#pragma unroll
        for (int m = 4; m <= 16; m <<= 1) {
          const float ov = shfl(bv, m);
          const int oi = shfl(bi, m);
          if (beats(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (g == 0)
          red_t[lane_col(wc, n, t)] = make_float2(bv, __int_as_float(bi));
      }
    }
    pending = tile;
  }
  __syncthreads();
  if (pending >= 0) flush(pending);

  // ---- rows: merge the tile's two column warps, write the split's partial
  if (wc == 1 && t == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rowx[lane_row(wr, i, g)] = make_float2(
          rm[i], kArgmax ? __int_as_float(rj[i]) : rl[i]);
  __syncthreads();
  if (wc == 0 && t == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = lane_row(wr, i, g);
      if (!row_in[i]) continue;
      const float2 o = rowx[lr];
      float2 out;
      if (kArgmax) {
        const int oj = __float_as_int(o.y);
        out = beats(o.x, oj, rm[i], rj[i])
                  ? o : make_float2(rm[i], __int_as_float(rj[i]));
      } else {
        const float m = fmaxf(rm[i], o.x);
        const float mu = m == -INFINITY ? 0.f : m;
        out = make_float2(m, rl[i] * expf(rm[i] - mu) + o.y * expf(o.x - mu));
      }
      row_part[((long long)b * gridDim.y + split) * len0 + row0 + lr] = out;
    }
  gam::cp_async_wait<0>();
}

// The partials over the row blocks (columns) and the column splits (rows).
// lse:    out_a, out_b = column max and sum of exp [B, S]; out_r = row LSE.
// argmax: out_a = column max of 2t - r, col_arg its row + row_off [B, S];
//         out_r = row_best = exp(max - r), j_ids its column [B, L].
template <bool kArgmax>
__global__ void merge_parts(const float2* __restrict__ col_part,
                            const float2* __restrict__ row_part,
                            const float* __restrict__ r_vec, int batch,
                            int len0, int len1, int n_blk, int n_split,
                            int row_off, float* __restrict__ out_a,
                            float* __restrict__ out_b,
                            long long* __restrict__ col_arg,
                            float* __restrict__ out_r,
                            long long* __restrict__ j_ids) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_cols = (long long)batch * len1;
  if (idx < n_cols) {
    const int b = (int)(idx / len1), s = (int)(idx % len1);
    const float2* p = col_part + (long long)b * n_blk * len1 + s;
    if (kArgmax) {  // row blocks in order, strict >: the first row wins
      float2 best = p[0];
      for (int k = 1; k < n_blk; ++k) {
        const float2 q = p[(long long)k * len1];
        if (q.x > best.x) best = q;
      }
      out_a[idx] = best.x;
      col_arg[idx] = (long long)__float_as_int(best.y) + row_off;
    } else {
      float m = p[0].x;
      for (int k = 1; k < n_blk; ++k) m = fmaxf(m, p[(long long)k * len1].x);
      float acc = 0.f;
      for (int k = 0; k < n_blk; ++k) {
        const float2 q = p[(long long)k * len1];
        acc += q.y * expf(q.x - m);
      }
      out_a[idx] = m;
      out_b[idx] = acc;
    }
    return;
  }
  const long long ridx = idx - n_cols;
  if (ridx >= (long long)batch * len0) return;
  const int b = (int)(ridx / len0), l = (int)(ridx % len0);
  const float2* p = row_part + (long long)b * n_split * len0 + l;
  if (kArgmax) {  // splits in column order, strict >: the first column wins
    float2 best = p[0];
    for (int k = 1; k < n_split; ++k) {
      const float2 q = p[(long long)k * len0];
      if (q.x > best.x) best = q;
    }
    out_r[ridx] = expf(best.x - r_vec[ridx]);
    j_ids[ridx] = __float_as_int(best.y);
  } else {
    float m = p[0].x;
    for (int k = 1; k < n_split; ++k) m = fmaxf(m, p[(long long)k * len0].x);
    float sum = 0.f;
    for (int k = 0; k < n_split; ++k) {
      const float2 q = p[(long long)k * len0];
      sum += q.y * expf(q.x - m);
    }
    out_r[ridx] = m + logf(sum);
  }
}

constexpr int kMergeThreads = 256;

template <bool kArgmax>
int launch(const void* f0, const void* f1, const void* m0, const void* m1,
           const void* r_vec, const void* c_vec, void* col_part,
           void* row_part, void* out_a, void* out_b, void* col_arg,
           void* out_r, void* j_ids, int batch, int len0, int len1, int ch,
           int n_split, float inv, int row_off, cudaStream_t stream) {
  const int n_tiles = gam::cdiv(len1, kBN);
  const int per_split = gam::cdiv(n_tiles, n_split);
  n_split = gam::cdiv(n_tiles, per_split);  // no split without a tile
  const int n_blk = gam::cdiv(len0, kBM);
  const int smem = smem_bytes(per_split);
  cudaError_t err = cudaFuncSetAttribute(
      extract_pass<kArgmax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  extract_pass<kArgmax><<<dim3(n_blk, n_split, batch), kThreads, smem,
                          stream>>>(
      static_cast<const float*>(f0), static_cast<const float*>(f1),
      static_cast<const unsigned char*>(m0),
      static_cast<const unsigned char*>(m1),
      static_cast<const float*>(r_vec), static_cast<const float*>(c_vec),
      static_cast<float2*>(col_part), static_cast<float2*>(row_part), len0,
      len1, ch, per_split, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)batch * (len0 + len1);
  merge_parts<kArgmax><<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
                         kMergeThreads, 0, stream>>>(
      static_cast<const float2*>(col_part),
      static_cast<const float2*>(row_part), static_cast<const float*>(r_vec),
      batch, len0, len1, n_blk, n_split, row_off, static_cast<float*>(out_a),
      static_cast<float*>(out_b), static_cast<long long*>(col_arg),
      static_cast<float*>(out_r), static_cast<long long*>(j_ids));
  return (int)cudaGetLastError();
}

}  // namespace

// feat0 [B, L, C], feat1 [B, S, C] f32, C a multiple of 4 and at most 256;
// mask0 [B, L], mask1 [B, S] bytes (nonzero keeps the row or column) or
// null for none. Scratch: col_part [B, ceil(L / 128), S] and row_part
// [B, n_split, L] of (f32, f32). The LSE pass writes the column max and sum
// of exp (col_m, col_acc [B, S]) and the row LSE r [B, L].
extern "C" int gam_streaming_match_lse(
    const void* f0, const void* f1, const void* m0, const void* m1,
    void* col_part, void* row_part, void* col_m, void* col_acc, void* r,
    int batch, int len0, int len1, int ch, int n_split, float inv,
    void* stream) {
  return launch<false>(f0, f1, m0, m1, nullptr, nullptr, col_part, row_part,
                       col_m, col_acc, nullptr, r, nullptr, batch, len0, len1,
                       ch, n_split, inv, 0, static_cast<cudaStream_t>(stream));
}

// The arg-max pass from the LSE pass's r [B, L] and the column LSE c
// [B, S]: col_m [B, S] f32 and col_arg [B, S] int64 (row + row_off),
// row_best [B, L] f32 and j_ids [B, L] int64. Inputs and scratch as above.
extern "C" int gam_streaming_match_argmax(
    const void* f0, const void* f1, const void* m0, const void* m1,
    const void* r, const void* c, void* col_part, void* row_part,
    void* col_m, void* col_arg, void* row_best, void* j_ids, int batch,
    int len0, int len1, int ch, int n_split, float inv, int row_off,
    void* stream) {
  return launch<true>(f0, f1, m0, m1, r, c, col_part, row_part, col_m,
                      nullptr, col_arg, row_best, j_ids, batch, len0, len1,
                      ch, n_split, inv, row_off,
                      static_cast<cudaStream_t>(stream));
}
