// K2: masked-KV attention forward, the GAM self layers.
//
// Replaces the TPU kernel geoformer_tpu/ops/pallas_attention.py:_mka_kernel,
// reached through _mka_forward. L queries attend to a fixed-capacity KV set
// (S = max_inliers) under a [B, S] column mask. As in the TPU kernel, masked
// logits are set to mask_fill BEFORE scaling and the softmax runs over all S
// columns, so a row whose whole mask is false gets the uniform mean of the S
// value rows (not zeros, not NaN). The output is f32 whatever the input type.
//
// What bounds it on an H100 depends on the share of live keys, since a
// masked key's weight is exactly 0. At L=4800, S=1024, H=4, D=64, B=2 the
// call moves ~17 MB (bf16 q, k, v; f32 out). With every key live it is
// ~10 GFLOP, bound by operations even on the tensor cores (~0.010 ms at
// 989 TFLOP/s against ~0.005 ms for the bytes); with under half the keys
// live, or a row with no inlier, it is bound by bytes.
//
// Design (a first version that is right, not fast): one CTA of 8 warps per
// (batch, head, 64-query tile). The query tile is held in shared memory as
// f32; K and V stream through shared memory in 32-key tiles (K rows padded
// to 65 floats so that 32 lanes reading 32 different keys hit 32 banks).
// Each warp owns 8 queries; lane j scores key j of the tile, the warp keeps
// an online softmax in f32 per query, and each lane accumulates two of the
// 64 output channels, taking the 32 weights of the tile by shuffle. The dot
// products run on the CUDA cores in f32, not on the tensor cores (wgmma and
// TMA are later work), so this kernel is far from its bound.

#include "gam_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kQueryTile = 64;
constexpr int kKeyTile = 32;
constexpr int kWarps = 8;
constexpr int kQueriesPerWarp = kQueryTile / kWarps;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mka_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const unsigned char* __restrict__ mask,
               float* __restrict__ out, int len_q, int len_kv, int heads,
               float scale, float mask_fill) {
  __shared__ float qs[kQueryTile][kHeadDim];
  __shared__ float ks[kKeyTile][kHeadDim + 1];
  __shared__ float vs[kKeyTile][kHeadDim];
  __shared__ int kflag[kKeyTile];  // 1 valid, 0 masked, -1 past the end

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int l0 = blockIdx.x * kQueryTile;

  for (int i = tid; i < kQueryTile * kHeadDim; i += kWarps * 32) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    const int l = l0 + r;
    qs[r][c] = l < len_q
        ? gam::to_f32(q[(((long long)b * len_q + l) * heads + h) * kHeadDim + c])
        : 0.f;
  }

  float m[kQueriesPerWarp], denom[kQueriesPerWarp];
  float a0[kQueriesPerWarp], a1[kQueriesPerWarp];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    m[i] = -INFINITY;
    denom[i] = 0.f;
    a0[i] = 0.f;
    a1[i] = 0.f;
  }

  for (int s0 = 0; s0 < len_kv; s0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kKeyTile * kHeadDim; i += kWarps * 32) {
      const int r = i / kHeadDim, c = i % kHeadDim;
      const int s = s0 + r;
      float kk = 0.f, vv = 0.f;
      if (s < len_kv) {
        const long long off =
            (((long long)b * len_kv + s) * heads + h) * kHeadDim + c;
        kk = gam::to_f32(k[off]);
        vv = gam::to_f32(v[off]);
      }
      ks[r][c] = kk;
      vs[r][c] = vv;
    }
    if (tid < kKeyTile) {
      const int s = s0 + tid;
      kflag[tid] = s < len_kv ? (mask[(long long)b * len_kv + s] ? 1 : 0) : -1;
    }
    __syncthreads();

    const int flag = kflag[lane];
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const float* qrow = qs[warp * kQueriesPerWarp + i];
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < kHeadDim; ++c) dot += qrow[c] * ks[lane][c];
      const float z = flag == 1   ? scale * dot
                      : flag == 0 ? scale * mask_fill
                                  : -INFINITY;
      const float m_new = fmaxf(m[i], gam::warp_max(z));
      const float corr = expf(m[i] - m_new);
      const float p = expf(z - m_new);
      denom[i] = denom[i] * corr + gam::warp_sum(p);
      float acc0 = a0[i] * corr, acc1 = a1[i] * corr;
#pragma unroll 8
      for (int j = 0; j < kKeyTile; ++j) {
        const float pj = __shfl_sync(gam::kFullMask, p, j);
        const float2 vv = *reinterpret_cast<const float2*>(&vs[j][2 * lane]);
        acc0 += pj * vv.x;
        acc1 += pj * vv.y;
      }
      a0[i] = acc0;
      a1[i] = acc1;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int l = l0 + warp * kQueriesPerWarp + i;
    if (l < len_q) {
      float* o = out + (((long long)b * len_q + l) * heads + h) * kHeadDim +
                 2 * lane;
      gam::store2(o, a0[i] / denom[i], a1[i] / denom[i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int batch, int len_q, int len_kv, int heads, float scale,
           float mask_fill, cudaStream_t stream) {
  const dim3 grid((len_q + kQueryTile - 1) / kQueryTile, batch * heads);
  mka_fwd_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), len_q, len_kv, heads, scale, mask_fill);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, L, H, 64]; k, v: [B, S, H, 64]; mask: [B, S] bytes (nonzero keeps
// the column); out: f32 [B, L, H, 64]. is_bf16 selects bf16 (1) or f32 (0)
// for q, k and v. Returns cudaGetLastError() after the launch.
extern "C" int gam_masked_kv_attention(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, int batch, int len_q,
                                       int len_kv, int heads, float scale,
                                       float mask_fill, int is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, batch, len_q, len_kv,
                                 heads, scale, mask_fill, s);
  return launch<float>(q, k, v, mask, out, batch, len_q, len_kv, heads, scale,
                       mask_fill, s);
}
