// K5 and K4: box-window attention backward, the GAM cross layers in
// training.
//
// Replace the TPU kernels geoformer_tpu/ops/pallas_attention.py:
// _box_bwd_dq_kernel (K5) and _box_bwd_dkv_kernel (K4), reached through
// _box_bwd_pallas. Both recompute the attention of query l over its in-grid
// box cells from the forward's LSE:
//
//   p = exp(scale * q.k - lse),  dl = p * (g.v - delta) * scale,
//   dq = sum_s dl k_s (K5),  dk_s = sum_l dl q_l,  dv_s = sum_l p g_l (K4),
//
// with delta = rowsum(g * out) computed by the caller. A row whose box misses
// the grid has no in-grid cell and gets no gradient, as in the TPU kernels.
//
// What bounds them on an H100: bytes. Per (query, head) the work is 25 cells
// of four length-64 products (~13 kFLOP); q, k, v, g are read and dq, dk, dv
// written once each, ~7 x 19.7 MB in f32 at B=4, L=S=4800, H=4, D=64
// (~0.04 ms at 3.35 TB/s).
//
// K5 (dq) is the gather direction: one warp per (batch, query, head) visits
// the in-grid cells of the query's box, as K1's forward does; each lane owns
// two of the 64 channels.
//
// K4 (dk/dv) is the scatter direction: the queries that touch key cell s are
// those whose centre lies within r of s, an irregular set under a
// homography. Design: no atomics on the gradients. A pre-pass (one warp per
// batch row) counting-sorts the queries by centre cell over the grid widened
// by r on each side (centres off that widened grid touch no cell and are
// dropped); ranks come from __match_any_sync in query order, so the sort is
// stable. Then one warp per (batch, key, head) reads the (2r+1)^2 buckets
// around its cell in a fixed order, each bucket in query order, and sums
// without atomics: the result is the same from run to run.

#include "gam_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
box_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ g,
                  const int* __restrict__ centers,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int batch, int len_q, int len_kv, int heads, int grid_h,
                  int grid_w, int radius, float scale) {
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
  const float2 gv = gam::load2(g + row * kHeadDim + 2 * lane);
  const float row_lse = lse[row];
  const float row_delta = delta[row];
  float a0 = 0.f, a1 = 0.f;
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      const long long off =
          ((b * len_kv + (long long)y * grid_w + x) * heads + h) * kHeadDim +
          2 * lane;
      const float2 kv = gam::load2(k + off);
      const float2 vv = gam::load2(v + off);
      const float qk = gam::warp_sum(qv.x * kv.x + qv.y * kv.y);
      const float dp = gam::warp_sum(gv.x * vv.x + gv.y * vv.y);
      const float p = expf(scale * qk - row_lse);
      const float dl = p * (dp - row_delta) * scale;
      a0 += dl * kv.x;
      a1 += dl * kv.y;
    }
  }
  gam::store2(dq + row * kHeadDim + 2 * lane, a0, a1);
}

// Widened-grid bucket of a query centre, or -1 if its box misses the grid.
__device__ __forceinline__ int bucket_of(int cx, int cy, int grid_h,
                                         int grid_w, int radius) {
  const int ex = cx + radius, ey = cy + radius;
  const int ew = grid_w + 2 * radius, eh = grid_h + 2 * radius;
  if (ex < 0 || ex >= ew || ey < 0 || ey >= eh) return -1;
  return ey * ew + ex;
}

// One warp per batch row. starts: [B, n_buckets + 1] (bucket j's queries are
// order[starts[j] .. starts[j + 1])); order: [B, len_q]. Shared memory holds
// one int per bucket.
__global__ void __launch_bounds__(32)
box_bucket_kernel(const int* __restrict__ centers, int* __restrict__ starts,
                  int* __restrict__ order, int len_q, int grid_h, int grid_w,
                  int radius, int n_buckets) {
  extern __shared__ int cursor[];
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const int* cb = centers + 2 * b * len_q;
  int* sb = starts + b * (long long)(n_buckets + 1);
  int* ob = order + b * (long long)len_q;
  const unsigned lower = (1u << lane) - 1u;

  for (int j = lane; j < n_buckets; j += 32) cursor[j] = 0;
  __syncwarp();
  // count: the lowest lane of each group of equal buckets adds the group
  for (int l0 = 0; l0 < len_q; l0 += 32) {
    const int l = l0 + lane;
    const int bk = l < len_q
        ? bucket_of(cb[2 * l], cb[2 * l + 1], grid_h, grid_w, radius) : -1;
    const unsigned peers = __match_any_sync(gam::kFullMask, bk);
    if (bk >= 0 && (peers & lower) == 0) cursor[bk] += __popc(peers);
    __syncwarp();
  }
  // exclusive scan: each lane scans a contiguous segment of the buckets
  const int seg = (n_buckets + 31) / 32;
  const int j0 = min(lane * seg, n_buckets), j1 = min(j0 + seg, n_buckets);
  int total = 0;
  for (int j = j0; j < j1; ++j) total += cursor[j];
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(gam::kFullMask, incl, o);
    if (lane >= o) incl += up;
  }
  int run = incl - total;
  __syncwarp();
  for (int j = j0; j < j1; ++j) {
    const int c = cursor[j];
    cursor[j] = run;
    sb[j] = run;
    run += c;
  }
  if (lane == 31) sb[n_buckets] = incl;
  __syncwarp();
  // fill in query order: rank within the group of equal buckets
  for (int l0 = 0; l0 < len_q; l0 += 32) {
    const int l = l0 + lane;
    const int bk = l < len_q
        ? bucket_of(cb[2 * l], cb[2 * l + 1], grid_h, grid_w, radius) : -1;
    const unsigned peers = __match_any_sync(gam::kFullMask, bk);
    int base = 0;
    if (bk >= 0) {
      base = cursor[bk];
      ob[base + __popc(peers & lower)] = l;
    }
    __syncwarp();
    if (bk >= 0 && (peers & lower) == 0) cursor[bk] = base + __popc(peers);
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
box_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ starts,
                   const int* __restrict__ order, float* __restrict__ dk,
                   float* __restrict__ dv, int batch, int len_q, int len_kv,
                   int heads, int grid_w, int radius, int n_buckets,
                   float scale) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * len_kv * heads) return;
  const int h = (int)(row % heads);
  const long long bs = row / heads;  // b * len_kv + s
  const long long b = bs / len_kv;
  const int s = (int)(bs % len_kv);
  const int sx = s % grid_w, sy = s / grid_w;
  const int ew = grid_w + 2 * radius;
  const int* sb = starts + b * (long long)(n_buckets + 1);
  const int* ob = order + b * (long long)len_q;

  const float2 kv = gam::load2(k + row * kHeadDim + 2 * lane);
  const float2 vv = gam::load2(v + row * kHeadDim + 2 * lane);
  float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
  // centres (sx + dx, sy + dy), |dx|, |dy| <= r, all inside the widened grid
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx) {
      const int bk = (sy + dy + radius) * ew + (sx + dx + radius);
      const int end = sb[bk + 1];
      for (int i = sb[bk]; i < end; ++i) {
        const long long qrow = (b * len_q + ob[i]) * heads + h;
        const float2 qv = gam::load2(q + qrow * kHeadDim + 2 * lane);
        const float2 gv = gam::load2(g + qrow * kHeadDim + 2 * lane);
        const float qk = gam::warp_sum(qv.x * kv.x + qv.y * kv.y);
        const float dp = gam::warp_sum(gv.x * vv.x + gv.y * vv.y);
        const float p = expf(scale * qk - lse[qrow]);
        const float dl = p * (dp - delta[qrow]) * scale;
        v0 += p * gv.x;
        v1 += p * gv.y;
        k0 += dl * qv.x;
        k1 += dl * qv.y;
      }
    }
  }
  gam::store2(dk + row * kHeadDim + 2 * lane, k0, k1);
  gam::store2(dv + row * kHeadDim + 2 * lane, v0, v1);
}

unsigned blocks_for(long long rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* centers, const void* lse, const void* delta,
              void* dq, int batch, int len_q, int len_kv, int heads,
              int grid_h, int grid_w, int radius, float scale,
              cudaStream_t stream) {
  box_bwd_dq_kernel<T><<<blocks_for((long long)batch * len_q * heads),
                         kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const int*>(centers), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), batch,
      len_q, len_kv, heads, grid_h, grid_w, radius, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* centers, const void* lse, const void* delta,
               void* starts, void* order, void* dk, void* dv, int batch,
               int len_q, int len_kv, int heads, int grid_h, int grid_w,
               int radius, float scale, cudaStream_t stream) {
  const int n_buckets = (grid_h + 2 * radius) * (grid_w + 2 * radius);
  const size_t smem = (size_t)n_buckets * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      box_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  box_bucket_kernel<<<batch, 32, smem, stream>>>(
      static_cast<const int*>(centers), static_cast<int*>(starts),
      static_cast<int*>(order), len_q, grid_h, grid_w, radius, n_buckets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  box_bwd_dkv_kernel<T><<<blocks_for((long long)batch * len_kv * heads),
                          kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(starts), static_cast<const int*>(order),
      static_cast<float*>(dk), static_cast<float*>(dv), batch, len_q, len_kv,
      heads, grid_w, radius, n_buckets, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. q: [B, L, H, 64]; k, v: [B, S, H, 64] (bf16 if is_bf16 else f32), S =
// grid_h * grid_w; g: f32 [B, L, H, 64]; centers: int32 [B, L, 2]; lse,
// delta: f32 [B, L, H]. Writes f32 dq [B, L, H, 64]. Returns
// cudaGetLastError() after the launch.
extern "C" int gam_box_window_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* centers, const void* lse, const void* delta, void* dq,
    int batch, int len_q, int len_kv, int heads, int grid_h, int grid_w,
    int radius, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dq<__nv_bfloat16>(q, k, v, g, centers, lse, delta, dq,
                                    batch, len_q, len_kv, heads, grid_h,
                                    grid_w, radius, scale, s);
  return launch_dq<float>(q, k, v, g, centers, lse, delta, dq, batch, len_q,
                          len_kv, heads, grid_h, grid_w, radius, scale, s);
}

// K4. Inputs as K5; scratch starts: int32 [B, (grid_h + 2r)(grid_w + 2r) +
// 1] and order: int32 [B, L]. Writes f32 dk, dv [B, S, H, 64]. Returns the
// first launch error, or 0.
extern "C" int gam_box_window_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* centers, const void* lse, const void* delta, void* starts,
    void* order, void* dk, void* dv, int batch, int len_q, int len_kv,
    int heads, int grid_h, int grid_w, int radius, float scale, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dkv<__nv_bfloat16>(q, k, v, g, centers, lse, delta, starts,
                                     order, dk, dv, batch, len_q, len_kv,
                                     heads, grid_h, grid_w, radius, scale, s);
  return launch_dkv<float>(q, k, v, g, centers, lse, delta, starts, order,
                           dk, dv, batch, len_q, len_kv, heads, grid_h,
                           grid_w, radius, scale, s);
}
