// K2: masked-KV attention forward, the GAM self layers.
//
// Replaces the TPU kernel geoformer_tpu/ops/pallas_attention.py:_mka_kernel,
// reached through _mka_forward. L queries attend to a fixed-capacity KV set
// (S = max_inliers) under a [B, S] column mask. As in the TPU kernel, masked
// logits are set to mask_fill BEFORE scaling and the softmax runs over all S
// columns, so a row whose whole mask is false gets the uniform mean of the S
// value rows (not zeros, not NaN). The output is f32 whatever the input type.
// On request it also writes each row's max m and log-denominator logd
// ([B, L, H] f32) for the backward (K3).
//
// What bounds it on an H100 depends on the share of live keys, since a
// masked key's weight is exactly 0 (exp(scale * mask_fill - m) underflows
// for mask_fill <= -1e4; the wrapper refuses larger fills). At L=4800,
// S=1024, H=4, D=64, B=2 the call moves ~17 MB (bf16 q, k, v; f32 out);
// with every key live it is ~10 GFLOP, bound by operations on the tensor
// cores, and with under half the keys live, by bytes.
//
// Design: FlashAttention-2-shaped. One CTA of 4 warps per (batch, head,
// 64-query tile); each warp owns 16 queries, its Q fragments in registers.
// The CTA lists the 64-key tiles of its batch row that hold a kept key
// (gam_mma.cuh: live_key_tiles) and streams only those through a 2-stage
// cp.async ring of K and V tiles. S = Q K^T and O += P V run on the tensor
// cores: bf16 inputs on mma.sync m16n8k16 bf16 with ldmatrix (Q.K^T one
// exact pass; P split into two bf16, so P.V keeps 16 bits of P), f32
// inputs on m16n8k8 TF32 with 3xTF32 splitting (gam_mma.cuh), so the
// result keeps f32 accuracy either way. The online softmax lives in the
// accumulator registers with row reductions over the 4 lanes of a quad.
// On a prefix mask (the GAM's, from masked_select_capacity) the work is
// proportional to the live count. A row with no kept key does no product:
// its CTAs write the mean of V, summed once per CTA in a fixed order.

#include "gam_mma.cuh"

namespace {

using gam::kTile;
using gam::kTileThreads;

// A warp's 16 query rows as A fragments, held in registers for the whole
// key sweep; scores() adds S = Q K^T for one key tile into sc ([key tile of
// 8][C fragment]) and pv() adds P V into o ([channel tile of 8][C]).
template <typename T>
struct QueryFrags;

template <>
struct QueryFrags<float> {  // 3xTF32, 8 steps of 8 channels
  uint32_t hi[8][4], lo[8][4];

  __device__ void load(const float* qb, long long rs, int r0, int rows) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + g + (i & 1) * 8, col = 8 * c + t + (i >> 1) * 4;
        const float x = r < rows ? qb[r * rs + col] : 0.f;
        gam::split<true>(x, hi[c][i], lo[c][i]);
      }
  }

  __device__ void scores(const float* kt, float (&sc)[8][4]) const {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh[2], bl[2];
        gam::load_bt<true>(kt, 8 * n, 8 * c, bh, bl);
        gam::mma3<true, true>(sc[n], hi[c], lo[c], bh, bl);
      }
  }

  static __device__ void pv(const float* vt, const float (&p)[8][4],
                            float (&o)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      gam::a_from_acc(p[kk], ah, al);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh[2], bl[2];
        gam::load_b<true>(vt, 8 * kk, 8 * n, bh, bl);
        gam::mma3<true, true>(o[n], ah, al, bh, bl);
      }
    }
  }
};

template <>
struct QueryFrags<__nv_bfloat16> {  // bf16 m16n8k16, 4 steps of 16 channels
  uint32_t a[4][4];

  __device__ void load(const __nv_bfloat16* qb, long long rs, int r0,
                       int rows) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + g + (i & 1) * 8;
        const int col = 16 * c + 2 * t + (i >> 1) * 8;
        a[c][i] = r < rows
            ? *reinterpret_cast<const uint32_t*>(qb + r * rs + col) : 0u;
      }
  }

  // B = K^T: ldmatrix of keys (rows) by channels gives b0 b1 directly;
  // matrices 0-1 are key tile n, 2-3 key tile n + 1.
  __device__ void scores(const __nv_bfloat16* kt, float (&sc)[8][4]) const {
    constexpr int ST = gam::TileStride<__nv_bfloat16>::value;
    const int lane = threadIdx.x & 31, mi = lane >> 3, ri = lane & 7;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        const int key = 16 * np + ri + (mi >> 1) * 8;
        gam::ldmatrix_x4<false>(b, kt + key * ST + 16 * c + (mi & 1) * 8);
        gam::mma_bf16(sc[2 * np], a[c], b[0], b[1]);
        gam::mma_bf16(sc[2 * np + 1], a[c], b[2], b[3]);
      }
  }

  // A = P from the accumulators of key tiles 2kk and 2kk + 1 (FlashAttention
  // 2's register reuse), split into two bf16; B = V by transposed ldmatrix,
  // matrices 0-1 channel tile n, 2-3 channel tile n + 1.
  static __device__ void pv(const __nv_bfloat16* vt, const float (&p)[8][4],
                            float (&o)[8][4]) {
    constexpr int ST = gam::TileStride<__nv_bfloat16>::value;
    const int lane = threadIdx.x & 31, mi = lane >> 3, ri = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      gam::split_bf16x2(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
      gam::split_bf16x2(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
      gam::split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
      gam::split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        const int key = 16 * kk + ri + (mi & 1) * 8;
        gam::ldmatrix_x4<true>(b, vt + key * ST + 16 * np + (mi >> 1) * 8);
        gam::mma_bf16(o[2 * np], al, b[0], b[1]);
        gam::mma_bf16(o[2 * np], ah, b[0], b[1]);
        gam::mma_bf16(o[2 * np + 1], al, b[2], b[3]);
        gam::mma_bf16(o[2 * np + 1], ah, b[2], b[3]);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
mka_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const unsigned char* __restrict__ mask,
               float* __restrict__ out, float* __restrict__ row_m,
               float* __restrict__ row_logd, int len_q, int len_kv, int heads,
               float scale, float mask_fill) {
  constexpr int kElems = gam::tile_bytes<T>() / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);               // [2][64][stride]
  T* vs = ks + 2 * kElems;                          // [2][64][stride]
  auto* bits = reinterpret_cast<unsigned long long*>(vs + 2 * kElems);
  int* list = reinterpret_cast<int*>(bits + gam::cdiv(len_kv, kTile));
  __shared__ int n_live_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int l0 = blockIdx.x * kTile;
  const int rows_q = min(kTile, len_q - l0);
  const long long rs = (long long)heads * kTile;  // row stride of q, k, v, out
  const T* kb = k + (long long)b * len_kv * rs + h * kTile;
  const T* vb = v + (long long)b * len_kv * rs + h * kTile;
  const T* qb = q + ((long long)b * len_q + l0) * rs + h * kTile;
  float* ob = out + ((long long)b * len_q + l0) * rs + h * kTile;
  const unsigned char* mrow = mask + (long long)b * len_kv;
  const long long stat0 = ((long long)b * len_q + l0) * heads + h;

  const int n_live = gam::live_key_tiles(mrow, len_kv, bits, list, &n_live_s);
  if (n_live == 0) {  // no kept key: uniform weights, the mean of V
    float* red = reinterpret_cast<float*>(smem);
    gam::column_mean(vb, rs, len_kv, (float)len_kv, red, red + 8 * kTile);
    gam::fill_rows(ob, rs, rows_q, red + 8 * kTile);
    if (row_m != nullptr && tid < rows_q) {
      row_m[stat0 + (long long)tid * heads] = scale * mask_fill;
      row_logd[stat0 + (long long)tid * heads] = logf((float)len_kv);
    }
    return;
  }

  auto prefetch = [&](int i) {
    const int s0 = list[i] * kTile, valid = min(kTile, len_kv - s0);
    gam::load_tile_async(ks + (i & 1) * kElems, kb + s0 * rs, rs, valid);
    gam::load_tile_async(vs + (i & 1) * kElems, vb + s0 * rs, rs, valid);
    gam::cp_async_commit();
  };
  prefetch(0);

  const int r0 = warp * 16;  // this warp's 16 queries
  QueryFrags<T> qf;
  qf.load(qb, rs, r0, rows_q);

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
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

    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    qf.scores(kt, sc);

    // logits, then the online softmax: row g holds c0, c1; row g+8 c2, c3
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bit = 2 * n + (j & 1);
        const float z = (keep >> bit) & 1u    ? scale * sc[n][j]
                        : (valid >> bit) & 1u ? fill
                                              : -INFINITY;
        sc[n][j] = z;
        mx[j >> 1] = fmaxf(mx[j >> 1], z);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(gam::kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(gam::kFullMask, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = gam::fast_exp2((m_r[r] - m_new) * gam::kLog2e);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[n][j] *= corr[j >> 1];
        const float p = gam::fast_exp2((sc[n][j] - m_r[j >> 1]) * gam::kLog2e);
        sc[n][j] = p;
        l_r[j >> 1] += p;
      }
    }

    QueryFrags<T>::pv(vt, sc, o);  // k runs over the keys, n the channels
    __syncthreads();  // the stage is consumed before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(gam::kFullMask, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(gam::kFullMask, l_r[r], 2);
    const int row = r0 + g + 8 * r;
    if (row < rows_q) {
      const float inv = 1.f / l_r[r];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        gam::store2(ob + row * rs + 8 * n + 2 * t, o[n][2 * r] * inv,
                    o[n][2 * r + 1] * inv);
      if (row_m != nullptr && t == 0) {
        row_m[stat0 + (long long)row * heads] = m_r[r];
        row_logd[stat0 + (long long)row * heads] = logf(l_r[r]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* row_m, void* row_logd, int batch, int len_q,
           int len_kv, int heads, float scale, float mask_fill,
           cudaStream_t stream) {
  const int smem = 4 * gam::tile_bytes<T>() + gam::live_list_bytes(len_kv);
  cudaError_t err = cudaFuncSetAttribute(
      mka_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(gam::cdiv(len_q, kTile), batch * heads);
  mka_fwd_kernel<T><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), static_cast<float*>(row_m),
      static_cast<float*>(row_logd), len_q, len_kv, heads, scale, mask_fill);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, L, H, 64]; k, v: [B, S, H, 64]; mask: [B, S] bytes (nonzero keeps
// the column); out: f32 [B, L, H, 64]. row_m and row_logd: f32 [B, L, H],
// or both null to skip the statistics. is_bf16 selects bf16 (1) or f32 (0)
// for q, k and v. Returns the first CUDA error, or 0.
extern "C" int gam_masked_kv_attention(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, void* row_m, void* row_logd,
                                       int batch, int len_q, int len_kv,
                                       int heads, float scale, float mask_fill,
                                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, row_m, row_logd, batch,
                                 len_q, len_kv, heads, scale, mask_fill, s);
  return launch<float>(q, k, v, mask, out, row_m, row_logd, batch, len_q,
                       len_kv, heads, scale, mask_fill, s);
}
