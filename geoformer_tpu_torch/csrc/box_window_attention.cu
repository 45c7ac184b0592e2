// K1: box-window attention forward, the GAM cross layers.
//
// Replaces the TPU kernel geoformer_tpu/ops/pallas_attention.py:
// _box_fwd_tiled_kernel (and its whole-KV twin _box_fwd_kernel), reached
// through _box_forward. Each query attends only to the (2r+1)^2 destination
// cells around its warped centre; out is written in the input type and the
// per-(row, head) LSE of the scaled logits in f32.
//
// What bounds it on an H100: bytes. Per (query, head) the work is 25 dot
// products and 25 axpys of length 64 (~6.4 kFLOP) against 128 bytes of q and
// 25 rows of K and V that neighbouring queries share, so the arithmetic
// intensity is far below the ~295 FLOP/byte where bf16 tensor cores would
// be the limit.
//
// Design: one warp per (batch, query, head). The warp reads its centre,
// visits only the in-grid cells of the box in raster order (never scans S),
// and runs an online softmax in f32; each lane owns two of the 64 channels,
// so every K/V row is one coalesced 128/256-byte read. Neighbouring queries
// hit the same K/V rows, which stay in L2. The TPU kernel's kv-tile skip is
// unnecessary: no masked key is ever touched. Masked keys contribute
// exp(scale * mask_fill - m) = 0 in the TPU kernel, so reading only the
// in-box cells is exact. A row whose box misses the grid gets out = 0 and
// LSE = scale * mask_fill + log(S), the value of an all-masked row.

#include "gam_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
box_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ centers,
               T* __restrict__ out, float* __restrict__ lse, int batch,
               int len_q, int len_kv, int heads, int grid_h, int grid_w,
               int radius, float scale, float mask_fill) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * len_q * heads) return;
  const int h = (int)(row % heads);
  const long long bl = row / heads;  // b * len_q + l
  const long long b = bl / len_q;

  const int cx = centers[2 * bl];
  const int cy = centers[2 * bl + 1];
  const int x0 = max(cx - radius, 0), x1 = min(cx + radius, grid_w - 1);
  const int y0 = max(cy - radius, 0), y1 = min(cy + radius, grid_h - 1);

  const float2 qv = gam::load2(q + row * kHeadDim + 2 * lane);
  float m = -INFINITY, denom = 0.f, a0 = 0.f, a1 = 0.f;
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      const long long off =
          ((b * len_kv + (long long)y * grid_w + x) * heads + h) * kHeadDim +
          2 * lane;
      const float2 kv = gam::load2(k + off);
      const float2 vv = gam::load2(v + off);
      const float z = scale * gam::warp_sum(qv.x * kv.x + qv.y * kv.y);
      const float m_new = fmaxf(m, z);
      const float corr = expf(m - m_new);
      const float e = expf(z - m_new);
      denom = denom * corr + e;
      a0 = a0 * corr + e * vv.x;
      a1 = a1 * corr + e * vv.y;
      m = m_new;
    }
  }
  T* o = out + row * kHeadDim + 2 * lane;
  if (x0 <= x1 && y0 <= y1) {
    gam::store2(o, a0 / denom, a1 / denom);
    if (lane == 0) lse[row] = m + logf(denom);
  } else {
    gam::store2(o, 0.f, 0.f);
    if (lane == 0) lse[row] = scale * mask_fill + logf((float)len_kv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* centers,
           void* out, void* lse, int batch, int len_q, int len_kv, int heads,
           int grid_h, int grid_w, int radius, float scale, float mask_fill,
           cudaStream_t stream) {
  const long long rows = (long long)batch * len_q * heads;
  const unsigned blocks =
      (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  box_fwd_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(centers),
      static_cast<T*>(out), static_cast<float*>(lse), batch, len_q, len_kv,
      heads, grid_h, grid_w, radius, scale, mask_fill);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, L, H, 64]; k, v: [B, S, H, 64] with S = grid_h * grid_w; centers:
// int32 [B, L, 2] (cx, cy); out: [B, L, H, 64] in the input type; lse: f32
// [B, L, H]. is_bf16 selects bf16 (1) or f32 (0) for q, k, v and out.
// Returns cudaGetLastError() after the launch.
extern "C" int gam_box_window_attention(
    const void* q, const void* k, const void* v, const void* centers,
    void* out, void* lse, int batch, int len_q, int len_kv, int heads,
    int grid_h, int grid_w, int radius, float scale, float mask_fill,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, centers, out, lse, batch, len_q,
                                 len_kv, heads, grid_h, grid_w, radius, scale,
                                 mask_fill, s);
  return launch<float>(q, k, v, centers, out, lse, batch, len_q, len_kv,
                       heads, grid_h, grid_w, radius, scale, mask_fill, s);
}
