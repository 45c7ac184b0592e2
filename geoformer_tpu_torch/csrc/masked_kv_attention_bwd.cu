// K3: masked-KV attention backward, the GAM self layers in training.
//
// Replaces the TPU kernel geoformer_tpu/ops/pallas_attention.py:
// _mka_bwd_kernel, reached through _mka_bwd_pallas. With
// z = scale * (mask ? q.k : mask_fill), attn = softmax over all S keys,
// dp = g.v and dot = rowsum(attn * dp) = rowsum(g * out):
//
//   dv = attn^T g,   dl = attn * (dp - dot) * scale (0 on masked keys),
//   dq = dl k,       dk = dl^T q.
//
// A row whose whole mask is false attends uniformly to its S keys, so its
// dv gets colsum(g) / S and its dq and dk are 0, as in the TPU kernel.
//
// The row statistics come from the forward (K2): each row's max m and
// log-denominator logd, and its f32 output, from which the dq pass forms
// dot. The probabilities are exp((z - m) - logd), not exp(z - lse): for a
// row with no kept key z = m = scale * mask_fill ~ -1.25e7, where an f32
// LSE would round away log(S) (f32 spacing there is 1.0) while z - m is
// exactly 0. A masked key in a row with a kept key has weight exactly 0
// (the wrapper refuses mask_fill > -1e4), so key tiles with no kept key are
// skipped.
//
// The TPU kernel sums dk/dv into one output block across the sequential
// query-tile grid. Blocks of a GPU grid run concurrently, so this file uses
// two passes and no atomics (the same bits from call to call):
//
// 1. dq pass, one CTA of 4 warps per (batch, head, 64-query tile): one
//    sweep over the live key tiles (gam_mma.cuh: live_key_tiles; K and V
//    through a 2-stage cp.async ring) computes S = Q K^T and dP = G V^T,
//    then dS, then dq += dS K. It also writes dot ([B, L, H]) for pass 2.
// 2. dk/dv pass, one CTA of 4 warps per (batch, head, 64-key tile, chunk
//    of the queries): a tile with no kept key writes 0 at once; otherwise
//    the CTA walks its chunk's queries in tiles of 64 (Q, G and the row
//    statistics through a 2-stage ring), computing S^T = K Q^T and
//    dP^T = V G^T, then dv += P^T G and dk += dS^T Q. S is small next to L
//    (512 against 4800 in training), so the key tiles alone give too few
//    CTAs for 132 SMs: the wrapper picks the number of chunks, each chunk
//    writes its partial dk/dv, and a last kernel sums the chunks in order.
//
// Every product runs on the tensor cores (mma.sync m16n8k8 TF32, with the
// 3xTF32 splitting of gam_mma.cuh for f32 operands, G, P and dS), so both
// the f32 and the bf16 path keep f32 accuracy. What bounds it on an H100:
// operations. At B=4, L=4800, S=512, H=4, D=64 the 5 products of 2*L*S*D
// per (batch, head) on the live keys come to ~25 GFLOP with every key live;
// at the 165 TFLOP/s of 3xTF32 (495 / 3) that is ~0.15 ms, against ~67 MB
// of bytes (0.02 ms at 3.35 TB/s).

#include "gam_mma.cuh"

namespace {

using gam::kTile;
using gam::kTileThreads;

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
mka_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const unsigned char* __restrict__ mask,
                  const float* __restrict__ g, const float* __restrict__ out,
                  const float* __restrict__ row_m,
                  const float* __restrict__ row_logd,
                  float* __restrict__ dot_out, float* __restrict__ dq,
                  int len_q, int len_kv, int heads, float scale,
                  float mask_fill) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kElems = gam::tile_bytes<T>() / sizeof(T);
  constexpr int kF32 = gam::tile_bytes<float>() / sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);       // [64][68]
  T* qs = reinterpret_cast<T*>(gs + kF32);          // [64][stride]
  T* ks = qs + kElems;                              // [2][64][stride]
  T* vs = ks + 2 * kElems;                          // [2][64][stride]
  auto* bits = reinterpret_cast<unsigned long long*>(vs + 2 * kElems);
  int* list = reinterpret_cast<int*>(bits + gam::cdiv(len_kv, kTile));
  __shared__ int n_live_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int l0 = blockIdx.x * kTile;
  const int rows_q = min(kTile, len_q - l0);
  const long long rs = (long long)heads * kTile;
  const long long qoff = ((long long)b * len_q + l0) * rs + h * kTile;
  const T* kb = k + (long long)b * len_kv * rs + h * kTile;
  const T* vb = v + (long long)b * len_kv * rs + h * kTile;
  const unsigned char* mrow = mask + (long long)b * len_kv;
  const long long stat0 = ((long long)b * len_q + l0) * heads + h;

  const int n_live = gam::live_key_tiles(mrow, len_kv, bits, list, &n_live_s);
  if (n_live == 0) {  // uniform attention: dq = 0
    gam::fill_rows(dq + qoff, rs, rows_q, nullptr);
    return;
  }

  gam::load_tile_async(qs, q + qoff, rs, rows_q);
  gam::load_tile_async(gs, g + qoff, rs, rows_q);
  gam::cp_async_commit();
  auto prefetch = [&](int i) {
    const int s0 = list[i] * kTile, valid = min(kTile, len_kv - s0);
    gam::load_tile_async(ks + (i & 1) * kElems, kb + s0 * rs, rs, valid);
    gam::load_tile_async(vs + (i & 1) * kElems, vb + s0 * rs, rs, valid);
    gam::cp_async_commit();
  };
  prefetch(0);
  gam::cp_async_wait<1>();  // Q and G are in
  __syncthreads();

  // row statistics of this lane's rows r0 + gq (r = 0) and r0 + gq + 8
  const int r0 = warp * 16;
  float m_r[2], logd_r[2], dot_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gq + 8 * r;
    float acc = 0.f;
    if (row < rows_q) {
      const float* orow = out + qoff + row * rs;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc += gs[row * gam::TileStride<float>::value + t + 4 * j] *
               orow[t + 4 * j];
    }
    acc += __shfl_xor_sync(gam::kFullMask, acc, 1);
    acc += __shfl_xor_sync(gam::kFullMask, acc, 2);
    dot_r[r] = acc;
    m_r[r] = row < rows_q ? row_m[stat0 + (long long)row * heads] : 0.f;
    logd_r[r] = row < rows_q ? row_logd[stat0 + (long long)row * heads] : 0.f;
    if (row < rows_q && t == 0) dot_out[stat0 + (long long)row * heads] = acc;
  }

  float dqa[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float fill = scale * mask_fill;

  for (int i = 0; i < n_live; ++i) {
    if (i + 1 < n_live) {
      prefetch(i + 1);
      gam::cp_async_wait<1>();
    } else {
      gam::cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + (i & 1) * kElems;
    const T* vt = vs + (i & 1) * kElems;
    const int s0 = list[i] * kTile;
    unsigned keep, valid;  // bit 2n + e: key s0 + 8n + 2t + e
    gam::lane_key_bits(bits[list[i]], len_kv - s0, keep, valid);

    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t qh[4], ql[4], gh[4], gl[4];
      gam::load_a<kSplit>(qs, r0, 8 * c, qh, ql);
      gam::load_a<true>(gs, r0, 8 * c, gh, gl);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh[2], bl[2];
        gam::load_bt<kSplit>(kt, 8 * n, 8 * c, bh, bl);
        gam::mma3<kSplit, kSplit>(sc[n], qh, ql, bh, bl);
        gam::load_bt<kSplit>(vt, 8 * n, 8 * c, bh, bl);
        gam::mma3<true, kSplit>(dp[n], gh, gl, bh, bl);
      }
    }

    // dS = P (dP - dot) scale on kept keys, 0 elsewhere (held in sc)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bit = 2 * n + (j & 1), r = j >> 1;
        const bool kept = (keep >> bit) & 1u;
        const float z = kept                  ? scale * sc[n][j]
                        : (valid >> bit) & 1u ? fill
                                              : -INFINITY;
        const float p =
            gam::fast_exp2(((z - m_r[r]) - logd_r[r]) * gam::kLog2e);
        sc[n][j] = kept ? p * (dp[n][j] - dot_r[r]) * scale : 0.f;
      }
    }

    // dq += dS K: k runs over the tile's keys, n over the 64 channels
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      gam::a_from_acc(sc[kk], ah, al);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh[2], bl[2];
        gam::load_b<kSplit>(kt, 8 * kk, 8 * n, bh, bl);
        gam::mma3<true, kSplit>(dqa[n], ah, al, bh, bl);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gq + 8 * r;
    if (row < rows_q) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
        gam::store2(dq + qoff + row * rs + 8 * n + 2 * t, dqa[n][2 * r],
                    dqa[n][2 * r + 1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
mka_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ g,
                   const float* __restrict__ row_m,
                   const float* __restrict__ row_logd,
                   const float* __restrict__ dot_in, float* __restrict__ dk,
                   float* __restrict__ dv, long long chunk_stride,
                   int tiles_per_chunk, int len_q, int len_kv, int heads,
                   float scale, float mask_fill) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kElems = gam::tile_bytes<T>() / sizeof(T);
  constexpr int kF32 = gam::tile_bytes<float>() / sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);       // [2][64][68]
  float* st = gs + 2 * kF32;                        // [2][3][64] m, logd, dot
  T* qs = reinterpret_cast<T*>(st + 2 * 3 * kTile);  // [2][64][stride]
  T* kts = qs + 2 * kElems;                         // [64][stride]
  T* vts = kts + kElems;                            // [64][stride]
  __shared__ int kflag[kTile];  // 1 kept, 0 masked, -1 past the end

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int s0 = blockIdx.x * kTile;
  const int rows_k = min(kTile, len_kv - s0);
  const long long rs = (long long)heads * kTile;
  const long long koff = ((long long)b * len_kv + s0) * rs + h * kTile;
  const long long qbase = (long long)b * len_q * rs + h * kTile;
  const long long stat_base = (long long)b * len_q * heads + h;
  const unsigned char* mrow = mask + (long long)b * len_kv;
  // this CTA's query tiles [i0, i1) and its partial dk, dv
  const int n_qt = gam::cdiv(len_q, kTile);
  const int i0 = min(n_qt, (int)blockIdx.z * tiles_per_chunk);
  const int i1 = min(n_qt, i0 + tiles_per_chunk);
  dk += blockIdx.z * chunk_stride;
  dv += blockIdx.z * chunk_stride;

  bool any_row = false;
  for (int s = tid; s < len_kv; s += kTileThreads) any_row |= mrow[s] != 0;
  if (tid < kTile) {
    const int s = s0 + tid;
    kflag[tid] = s < len_kv ? (mrow[s] ? 1 : 0) : -1;
  }
  const bool row_live = __syncthreads_or(any_row);
  const bool tile_live = __syncthreads_or(tid < kTile && kflag[tid] == 1);
  if (!row_live) {  // uniform attention: dk = 0, dv = colsum(g) / S
    float* red = gs;
    const int l0 = i0 * kTile, rows = min(len_q, i1 * kTile) - l0;
    gam::column_mean(g + qbase + l0 * rs, rs, max(rows, 0), (float)len_kv,
                     red, red + 8 * kTile);
    gam::fill_rows(dk + koff, rs, rows_k, nullptr);
    gam::fill_rows(dv + koff, rs, rows_k, red + 8 * kTile);
    return;
  }
  if (!tile_live || i0 == i1) {  // every weight of these keys is 0
    gam::fill_rows(dk + koff, rs, rows_k, nullptr);
    gam::fill_rows(dv + koff, rs, rows_k, nullptr);
    return;
  }

  gam::load_tile_async(kts, k + koff, rs, rows_k);
  gam::load_tile_async(vts, v + koff, rs, rows_k);
  gam::cp_async_commit();
  auto prefetch = [&](int i) {
    const int l0 = i * kTile, valid = min(kTile, len_q - l0);
    const int stage = i & 1;
    gam::load_tile_async(qs + stage * kElems, q + qbase + l0 * rs, rs, valid);
    gam::load_tile_async(gs + stage * kF32, g + qbase + l0 * rs, rs, valid);
    if (tid < kTile) {
      const bool ok = tid < valid;
      const long long row = stat_base + (long long)(ok ? l0 + tid : 0) * heads;
      float* dst = st + stage * 3 * kTile + tid;
      gam::cp_async4(dst, row_m + row, ok);
      gam::cp_async4(dst + kTile, row_logd + row, ok);
      gam::cp_async4(dst + 2 * kTile, dot_in + row, ok);
    }
    gam::cp_async_commit();
  };
  prefetch(i0);

  const int r0 = warp * 16;  // this warp's keys r0 + gq and r0 + gq + 8
  const int flag_r[2] = {kflag[r0 + gq], kflag[r0 + gq + 8]};
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;
  const float fill = scale * mask_fill;

  for (int i = i0; i < i1; ++i) {
    if (i + 1 < i1) {
      prefetch(i + 1);
      gam::cp_async_wait<1>();
    } else {
      gam::cp_async_wait<0>();
    }
    __syncthreads();
    const T* qt = qs + (i & 1) * kElems;
    const float* gt = gs + (i & 1) * kF32;
    const float* stt = st + (i & 1) * 3 * kTile;

    // S^T = K Q^T and dP^T = V G^T: rows are keys, columns queries
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      gam::load_a<kSplit>(kts, r0, 8 * c, kh, kl);
      gam::load_a<kSplit>(vts, r0, 8 * c, vh, vl);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh[2], bl[2];
        gam::load_bt<kSplit>(qt, 8 * n, 8 * c, bh, bl);
        gam::mma3<kSplit, kSplit>(sc[n], kh, kl, bh, bl);
        gam::load_bt<true>(gt, 8 * n, 8 * c, bh, bl);
        gam::mma3<kSplit, true>(dp[n], vh, vl, bh, bl);
      }
    }

    // P^T into sc, dS^T into dp
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * n + 2 * t + (j & 1), flag = flag_r[j >> 1];
        const float z = flag == 1 ? scale * sc[n][j]
                        : flag == 0 ? fill
                                    : -INFINITY;
        const float p = gam::fast_exp2(
            ((z - stt[col]) - stt[kTile + col]) * gam::kLog2e);
        sc[n][j] = p;
        dp[n][j] = flag == 1 ? p * (dp[n][j] - stt[2 * kTile + col]) * scale
                             : 0.f;
      }
    }

    // dv += P^T G and dk += dS^T Q: k runs over the tile's queries
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      gam::a_from_acc(sc[kk], ph, pl);
      gam::a_from_acc(dp[kk], sh, sl);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh[2], bl[2];
        gam::load_b<true>(gt, 8 * kk, 8 * n, bh, bl);
        gam::mma3<true, true>(dva[n], ph, pl, bh, bl);
        gam::load_b<kSplit>(qt, 8 * kk, 8 * n, bh, bl);
        gam::mma3<true, kSplit>(dka[n], sh, sl, bh, bl);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + gq + 8 * r;
    if (key < rows_k) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        gam::store2(dk + koff + key * rs + 8 * n + 2 * t, dka[n][2 * r],
                    dka[n][2 * r + 1]);
        gam::store2(dv + koff + key * rs + 8 * n + 2 * t, dva[n][2 * r],
                    dva[n][2 * r + 1]);
      }
    }
  }
}

// out[i] = sum over chunks c of part[c * 2n + i] for i < 2n (dk then dv),
// four values a thread, the chunks in order.
__global__ void mka_bwd_sum_kernel(const float* __restrict__ part,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv, long long n,
                                   int n_chunks) {
  const long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int c = 1; c < n_chunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(part + c * 2 * n + i);
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  *reinterpret_cast<float4*>(i < n ? dk + i : dv + (i - n)) = acc;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, const void* out, const void* row_m,
           const void* row_logd, void* dot, void* dq, void* dk, void* dv,
           void* part, int n_chunks, int batch, int len_q, int len_kv,
           int heads, float scale, float mask_fill, cudaStream_t stream) {
  const int smem_q = gam::tile_bytes<float>() + 5 * gam::tile_bytes<T>() +
                     gam::live_list_bytes(len_kv);
  cudaError_t err = cudaFuncSetAttribute(
      mka_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(gam::cdiv(len_q, kTile), batch * heads);
  mka_bwd_dq_kernel<T><<<grid_q, kTileThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const float*>(row_m), static_cast<const float*>(row_logd),
      static_cast<float*>(dot), static_cast<float*>(dq), len_q, len_kv, heads,
      scale, mask_fill);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_kv = 2 * gam::tile_bytes<float>() +
                      2 * 3 * kTile * (int)sizeof(float) +
                      4 * gam::tile_bytes<T>();
  err = cudaFuncSetAttribute(mka_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return (int)err;
  // n_chunks > 1: chunk c writes dk to part[c][0] and dv to part[c][1]
  const long long n = (long long)batch * len_kv * heads * kTile;
  float* pt = static_cast<float*>(part);
  float* dk_w = n_chunks > 1 ? pt : static_cast<float*>(dk);
  float* dv_w = n_chunks > 1 ? pt + n : static_cast<float*>(dv);
  const dim3 grid_kv(gam::cdiv(len_kv, kTile), batch * heads, n_chunks);
  mka_bwd_dkv_kernel<T><<<grid_kv, kTileThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(g), static_cast<const float*>(row_m),
      static_cast<const float*>(row_logd), static_cast<const float*>(dot),
      dk_w, dv_w, 2 * n, gam::cdiv(gam::cdiv(len_q, kTile), n_chunks), len_q,
      len_kv, heads, scale, mask_fill);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  const int threads = 256;
  mka_bwd_sum_kernel<<<(int)((2 * n / 4 + threads - 1) / threads), threads, 0,
                       stream>>>(static_cast<const float*>(part),
                                 static_cast<float*>(dk),
                                 static_cast<float*>(dv), n, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, L, H, 64]; k, v: [B, S, H, 64] (bf16 if is_bf16 else f32); mask:
// [B, S] bytes (nonzero keeps the column); g and out (the forward's
// output): f32 [B, L, H, 64]; row_m and row_logd (the forward's row
// statistics): f32 [B, L, H]. Writes f32 dq [B, L, H, 64], dk and dv
// [B, S, H, 64], and the scratch dot, f32 [B, L, H]. The dk/dv pass splits
// the queries into n_chunks chunks; for n_chunks > 1, part is f32 scratch
// [n_chunks, 2, B, S, H, 64] (else unused). Returns the first CUDA error,
// or 0.
extern "C" int gam_masked_kv_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* g, const void* out, const void* row_m, const void* row_logd,
    void* dot, void* dq, void* dk, void* dv, void* part, int n_chunks,
    int batch, int len_q, int len_kv, int heads, float scale, float mask_fill,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, g, out, row_m, row_logd, dot,
                                 dq, dk, dv, part, n_chunks, batch, len_q,
                                 len_kv, heads, scale, mask_fill, s);
  return launch<float>(q, k, v, mask, g, out, row_m, row_logd, dot, dq, dk,
                       dv, part, n_chunks, batch, len_q, len_kv, heads, scale,
                       mask_fill, s);
}
