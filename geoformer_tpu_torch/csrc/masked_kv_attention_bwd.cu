// K3: masked-KV attention backward, the GAM self layers in training.
//
// Replaces the TPU kernel geoformer_tpu/ops/pallas_attention.py:
// _mka_bwd_kernel, reached through _mka_bwd_pallas. With
// z = scale * (mask ? q.k : mask_fill), attn = softmax over all S keys,
// dp = g.v and dot = rowsum(attn * dp):
//
//   dv = attn^T g,   dl = attn * (dp - dot) * scale (0 on masked keys),
//   dq = dl k,       dk = dl^T q.
//
// A row whose whole mask is false attends uniformly to its S keys, so its
// dv gets colsum(g) / S and its dq and dk are 0, as in the TPU kernel.
//
// The TPU kernel sums dk/dv into one output block across the sequential
// query-tile grid. Blocks of a GPU grid run concurrently, so this file uses
// two passes and no atomics (deterministic):
//
// 1. dq pass, one CTA of 8 warps per (batch, head, 32-query tile): sweep 1
//    over the S keys keeps an online max, denominator and sum of e * dp per
//    query, giving the row's max m, log-denominator and dot; sweep 2
//    recomputes z and dp and accumulates dq. It writes dq and the per-row m,
//    log-denominator and dot ([B, L, H]). The probabilities are
//    exp((z - m) - logd), not exp(z - lse): for a row with no kept key
//    z = m = scale * mask_fill ~ -1.25e7, where an f32 LSE would round away
//    log(S) (f32 spacing there is 1.0) while z - m is exactly 0.
// 2. dk/dv pass, one CTA of 8 warps per (batch, head, 32-key tile): the
//    CTA walks all L queries in tiles of 32 through shared memory; each warp
//    owns 4 keys, lane i scores query i of the tile against them, and the
//    probabilities are shuffled to lanes that own two of the 64 channels of
//    dk and dv.
//
// What bounds it on an H100: operations. At B=4, L=4800, S=512, H=4, D=64
// the backward needs 5 products of 2*L*S*D per (batch, head): ~25 GFLOP,
// ~0.38 ms at the 67 TFLOP/s of the f32 CUDA cores, against ~67 MB of
// bytes (0.02 ms at 3.35 TB/s). The dot products run on the CUDA cores in
// f32 from shared memory (sweep 1 and 2 of the dq pass each recompute q.k
// and g.v), not on the tensor cores: a first version that is right, not
// fast.

#include "gam_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
// dq pass
constexpr int kQueryTile = 32;
constexpr int kKeyTile = 32;
constexpr int kQueriesPerWarp = kQueryTile / kWarps;
// dk/dv pass
constexpr int kKvTile = 32;
constexpr int kKeysPerWarp = kKvTile / kWarps;
constexpr int kRowTile = 32;

// Key flags: 1 kept, 0 masked (logit = mask_fill), -1 past the end.
__device__ __forceinline__ float masked_logit(int flag, float dot, float scale,
                                              float mask_fill) {
  return flag == 1 ? scale * dot : flag == 0 ? scale * mask_fill : -INFINITY;
}

// q.k and g.v of the warp's queries (rows warp * kQueriesPerWarp + i of
// qs/gs) against key `lane` of the tile: channel-outer, so each key value
// is read from shared memory once for all the warp's queries.
__device__ __forceinline__ void scores(
    float (*qs)[kHeadDim], float (*gs)[kHeadDim], float (*ks)[kHeadDim + 1],
    float (*vs)[kHeadDim + 1], int warp, int lane, float* qk, float* gv) {
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) qk[i] = gv[i] = 0.f;
#pragma unroll 8
  for (int c = 0; c < kHeadDim; ++c) {
    const float kc = ks[lane][c];
    const float vc = vs[lane][c];
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      qk[i] += qs[warp * kQueriesPerWarp + i][c] * kc;
      gv[i] += gs[warp * kQueriesPerWarp + i][c] * vc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mka_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const unsigned char* __restrict__ mask,
                  const float* __restrict__ g, float* __restrict__ dq,
                  float* __restrict__ row_m, float* __restrict__ row_logd,
                  float* __restrict__ dot_out,
                  int len_q, int len_kv, int heads, float scale,
                  float mask_fill) {
  __shared__ float qs[kQueryTile][kHeadDim];
  __shared__ float gs[kQueryTile][kHeadDim];
  __shared__ float ks[kKeyTile][kHeadDim + 1];
  __shared__ float vs[kKeyTile][kHeadDim + 1];
  __shared__ int kflag[kKeyTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int l0 = blockIdx.x * kQueryTile;

  for (int i = tid; i < kQueryTile * kHeadDim; i += kWarps * 32) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    const int l = l0 + r;
    const long long off =
        (((long long)b * len_q + l) * heads + h) * kHeadDim + c;
    qs[r][c] = l < len_q ? gam::to_f32(q[off]) : 0.f;
    gs[r][c] = l < len_q ? g[off] : 0.f;
  }

  float m[kQueriesPerWarp], denom[kQueriesPerWarp], acc[kQueriesPerWarp];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    m[i] = -INFINITY;
    denom[i] = 0.f;
    acc[i] = 0.f;
  }

  // Loads key tile s0 into ks/vs/kflag (callers synchronize around it).
  auto load_tile = [&](int s0) {
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
      kflag[tid] =
          s < len_kv ? (mask[(long long)b * len_kv + s] ? 1 : 0) : -1;
    }
  };

  // Sweep 1: LSE and dot = sum_j attn_j * dp_j per query, online.
  for (int s0 = 0; s0 < len_kv; s0 += kKeyTile) {
    __syncthreads();
    load_tile(s0);
    __syncthreads();
    const int flag = kflag[lane];
    float qk[kQueriesPerWarp], gv[kQueriesPerWarp];
    scores(qs, gs, ks, vs, warp, lane, qk, gv);
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const float z = masked_logit(flag, qk[i], scale, mask_fill);
      const float m_new = fmaxf(m[i], gam::warp_max(z));
      const float corr = expf(m[i] - m_new);
      const float e = expf(z - m_new);
      denom[i] = denom[i] * corr + gam::warp_sum(e);
      acc[i] = acc[i] * corr + gam::warp_sum(flag >= 0 ? e * gv[i] : 0.f);
      m[i] = m_new;
    }
  }
  float logd[kQueriesPerWarp], row_dot[kQueriesPerWarp];
  float dq0[kQueriesPerWarp], dq1[kQueriesPerWarp];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    logd[i] = logf(denom[i]);
    row_dot[i] = acc[i] / denom[i];
    dq0[i] = 0.f;
    dq1[i] = 0.f;
  }

  // Sweep 2: dl = attn * (dp - dot) * scale on kept keys; dq = dl k.
  for (int s0 = 0; s0 < len_kv; s0 += kKeyTile) {
    __syncthreads();
    load_tile(s0);
    __syncthreads();
    const int flag = kflag[lane];
    float qk[kQueriesPerWarp], gv[kQueriesPerWarp];
    scores(qs, gs, ks, vs, warp, lane, qk, gv);
    float dl[kQueriesPerWarp];
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const float p = expf((masked_logit(flag, qk[i], scale, mask_fill) - m[i])
                           - logd[i]);
      dl[i] = flag == 1 ? p * (gv[i] - row_dot[i]) * scale : 0.f;
    }
    // lane = 2 channels of dq: each key row is read once for the warp's
    // queries
#pragma unroll 4
    for (int j = 0; j < kKeyTile; ++j) {
      const float k0 = ks[j][2 * lane], k1 = ks[j][2 * lane + 1];
#pragma unroll
      for (int i = 0; i < kQueriesPerWarp; ++i) {
        const float dlj = __shfl_sync(gam::kFullMask, dl[i], j);
        dq0[i] += dlj * k0;
        dq1[i] += dlj * k1;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int l = l0 + warp * kQueriesPerWarp + i;
    if (l < len_q) {
      const long long row = ((long long)b * len_q + l) * heads + h;
      gam::store2(dq + row * kHeadDim + 2 * lane, dq0[i], dq1[i]);
      if (lane == 0) {
        row_m[row] = m[i];
        row_logd[row] = logd[i];
        dot_out[row] = row_dot[i];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mka_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ g,
                   const float* __restrict__ row_m,
                   const float* __restrict__ row_logd,
                   const float* __restrict__ dot_in, float* __restrict__ dk,
                   float* __restrict__ dv, int len_q, int len_kv, int heads,
                   float scale, float mask_fill) {
  __shared__ float ks[kKvTile][kHeadDim];
  __shared__ float vs[kKvTile][kHeadDim];
  __shared__ float qs[kRowTile][kHeadDim + 1];
  __shared__ float gs[kRowTile][kHeadDim + 1];
  __shared__ float m_s[kRowTile];
  __shared__ float logd_s[kRowTile];
  __shared__ float dot_s[kRowTile];
  __shared__ int kflag[kKvTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int s0 = blockIdx.x * kKvTile;

  for (int i = tid; i < kKvTile * kHeadDim; i += kWarps * 32) {
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
  if (tid < kKvTile) {
    const int s = s0 + tid;
    kflag[tid] = s < len_kv ? (mask[(long long)b * len_kv + s] ? 1 : 0) : -1;
  }

  float dk0[kKeysPerWarp], dk1[kKeysPerWarp];
  float dv0[kKeysPerWarp], dv1[kKeysPerWarp];
#pragma unroll
  for (int t = 0; t < kKeysPerWarp; ++t) {
    dk0[t] = dk1[t] = dv0[t] = dv1[t] = 0.f;
  }

  for (int r0 = 0; r0 < len_q; r0 += kRowTile) {
    __syncthreads();  // the previous query tile is consumed (ks is written)
    for (int i = tid; i < kRowTile * kHeadDim; i += kWarps * 32) {
      const int r = i / kHeadDim, c = i % kHeadDim;
      const int l = r0 + r;
      const long long off =
          (((long long)b * len_q + l) * heads + h) * kHeadDim + c;
      qs[r][c] = l < len_q ? gam::to_f32(q[off]) : 0.f;
      gs[r][c] = l < len_q ? g[off] : 0.f;
    }
    if (tid < kRowTile) {
      const int l = r0 + tid;
      const long long row = ((long long)b * len_q + l) * heads + h;
      m_s[tid] = l < len_q ? row_m[row] : 0.f;
      logd_s[tid] = l < len_q ? row_logd[row] : INFINITY;  // p = 0 past L
      dot_s[tid] = l < len_q ? dot_in[row] : 0.f;
    }
    __syncthreads();

    // lane = query of the tile; scores against the warp's keys
    float qk[kKeysPerWarp], gv[kKeysPerWarp];
#pragma unroll
    for (int t = 0; t < kKeysPerWarp; ++t) qk[t] = gv[t] = 0.f;
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float qc = qs[lane][c];
      const float gc = gs[lane][c];
#pragma unroll
      for (int t = 0; t < kKeysPerWarp; ++t) {
        qk[t] += qc * ks[warp * kKeysPerWarp + t][c];
        gv[t] += gc * vs[warp * kKeysPerWarp + t][c];
      }
    }
    const float rm = m_s[lane];
    const float rlogd = logd_s[lane];
    const float row_dot = dot_s[lane];
    float p[kKeysPerWarp], dl[kKeysPerWarp];
#pragma unroll
    for (int t = 0; t < kKeysPerWarp; ++t) {
      const int flag = kflag[warp * kKeysPerWarp + t];
      const float z = masked_logit(flag, qk[t], scale, mask_fill);
      p[t] = flag >= 0 ? expf((z - rm) - rlogd) : 0.f;
      dl[t] = flag == 1 ? p[t] * (gv[t] - row_dot) * scale : 0.f;
    }
    // lane = 2 channels of dk/dv: each query row of the tile is read once
    // for all the warp's keys
#pragma unroll 4
    for (int i = 0; i < kRowTile; ++i) {
      const float g0 = gs[i][2 * lane], g1 = gs[i][2 * lane + 1];
      const float q0 = qs[i][2 * lane], q1 = qs[i][2 * lane + 1];
#pragma unroll
      for (int t = 0; t < kKeysPerWarp; ++t) {
        const float pi = __shfl_sync(gam::kFullMask, p[t], i);
        const float dli = __shfl_sync(gam::kFullMask, dl[t], i);
        dv0[t] += pi * g0;
        dv1[t] += pi * g1;
        dk0[t] += dli * q0;
        dk1[t] += dli * q1;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kKeysPerWarp; ++t) {
    const int s = s0 + warp * kKeysPerWarp + t;
    if (s < len_kv) {
      const long long off =
          (((long long)b * len_kv + s) * heads + h) * kHeadDim + 2 * lane;
      gam::store2(dk + off, dk0[t], dk1[t]);
      gam::store2(dv + off, dv0[t], dv1[t]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, void* dq, void* dk, void* dv, void* row_m,
           void* row_logd, void* dot, int batch, int len_q, int len_kv, int heads, float scale,
           float mask_fill, cudaStream_t stream) {
  const dim3 grid_q((len_q + kQueryTile - 1) / kQueryTile, batch * heads);
  mka_bwd_dq_kernel<T><<<grid_q, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(row_m), static_cast<float*>(row_logd),
      static_cast<float*>(dot), len_q, len_kv, heads, scale, mask_fill);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((len_kv + kKvTile - 1) / kKvTile, batch * heads);
  mka_bwd_dkv_kernel<T><<<grid_kv, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(g), static_cast<const float*>(row_m),
      static_cast<const float*>(row_logd), static_cast<const float*>(dot),
      static_cast<float*>(dk),
      static_cast<float*>(dv), len_q, len_kv, heads, scale, mask_fill);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, L, H, 64]; k, v: [B, S, H, 64] (bf16 if is_bf16 else f32); mask:
// [B, S] bytes (nonzero keeps the column); g: f32 [B, L, H, 64]. Writes f32
// dq [B, L, H, 64], dk and dv [B, S, H, 64], and the scratch row_m, row_logd
// and dot, f32 [B, L, H]. Returns the first launch error, or 0.
extern "C" int gam_masked_kv_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* g, void* dq, void* dk, void* dv, void* row_m, void* row_logd,
    void* dot, int batch, int len_q, int len_kv, int heads, float scale,
    float mask_fill, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, g, dq, dk, dv, row_m,
                                 row_logd, dot, batch, len_q, len_kv, heads,
                                 scale, mask_fill, s);
  return launch<float>(q, k, v, mask, g, dq, dk, dv, row_m, row_logd, dot,
                       batch, len_q, len_kv, heads, scale, mask_fill, s);
}
