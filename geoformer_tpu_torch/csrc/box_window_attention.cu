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
// be the limit. The bound reads each K and V row once.
//
// Design (the gather plan of box_plan.cuh, shared with K5): the queries are
// sorted by the 8x8 destination tile that holds their centre, and a block
// takes a piece of at most 128 of one tile's queries and one head. It copies
// the tile's window of K and V rows (<= (8 + 2r)^2 = 144 cells, 36 KB in
// bf16, 72 KB in f32) into shared memory once with cp.async, so a K/V row is
// read from L2 about (8 + 2r)^2 / 64 = 2.25 times a launch in all, instead of
// once for every query whose box covers it (25 times). Then 8 lanes per
// query, 8 channels a lane (3 shuffle levels a product), walk the box a row
// at a time: the row's 5 logits side by side, one rescale of the online
// softmax, then the row's weights and V rows, in raster order, in f32.
// Masked keys contribute exp(scale * mask_fill - m) = 0 in the TPU kernel,
// so reading only the in-box cells is exact. A row whose box misses the
// grid gets out = 0 and LSE = scale * mask_fill + log(S), the value of an
// all-masked row, from the plan's count pass. Each query is computed by
// one group of lanes in a fixed order: the same bits in every call. Three
// launches: the plan's two (count, fill) and the pieces. The shared-memory
// reads and the instructions per cell (in bf16 many of them widen bf16 to
// f32), not the bytes from memory, now bound a launch.

#include "box_plan.cuh"

namespace {

// K1's contract for a row whose box misses the grid: out = 0 and the LSE
// of an all-masked row, all heads, in parts of 16 bytes of out (the first
// `heads` parts also write one head's LSE).
template <typename T>
struct OffGridRow {
  T* out;
  float* lse;
  int heads, len_kv;
  float scale, mask_fill;
  __device__ int parts() const {
    return heads * kHeadDim * (int)sizeof(T) / 16;
  }
  __device__ void operator()(long long bl, int i) const {
    reinterpret_cast<uint4*>(out + bl * heads * kHeadDim)[i] =
        make_uint4(0u, 0u, 0u, 0u);
    if (i < heads)
      lse[bl * heads + i] = scale * mask_fill + logf((float)len_kv);
  }
};

// K1's pieces, laid out as K5's (box_window_attention_bwd.cu): one block
// per (head, piece, batch row), the window in shared memory, a group of 8
// lanes per query, each warp taking 4 queries at a time, all groups
// stepping through the (2R+1)^2 box cells together. The softmax is online
// over the box's rows: a row's logits (in log2 units, -inf off the grid),
// one rescale of the sums, then the row's weights and V rows.
template <typename T, int R>
__global__ void __launch_bounds__(kGatherThreads, 3)
box_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ centers,
               const GatherPlan pl, T* __restrict__ out,
               float* __restrict__ lse, int len_q, int len_kv, int heads,
               int grid_h, int grid_w, float scale) {
  constexpr int W = 2 * R + 1, kSide = kGatherTile + 2 * R;
  extern __shared__ __align__(16) unsigned char window[];
  const int h = blockIdx.x;
  const long long b = blockIdx.z;
  Piece pc;
  if (!find_piece(pl, b, blockIdx.y, grid_h, grid_w, R, pc)) return;
  T* ks = reinterpret_cast<T*>(window);
  T* vs = ks + kSide * kSide * kHeadDim;
  stage_window(ks, vs, k, v, b, h, heads, len_kv, grid_w, pc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 3, sub = lane & 7;
  const float c1 = scale * gam::kLog2e;
  gam::cp_async_wait<0>();
  __syncthreads();
  // warp w takes queries 4 w + group, then kGatherGroups further on
  for (int i0 = 4 * warp; i0 < pc.count; i0 += kGatherGroups) {
    const GroupQuery<R> gq = group_query<R>(pl.order, centers, b, len_q,
                                            heads, h, grid_h, grid_w, pc,
                                            i0 + group);
    float qv[8];
    load_row(q + gq.row * kHeadDim, sub, qv);
    // an online softmax over box rows: a row's W logits (their group sums
    // side by side), one rescale, then its terms in raster order
    float m = -INFINITY, denom = 0.f, acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < W; ++dy) {
      float z[W];
#pragma unroll
      for (int dx = 0; dx < W; ++dx) {
        float kk[8];
        load_row(ks + (gq.ys[dy] + gq.xs[dx]) * kHeadDim, sub, kk);
        z[dx] = dot8(qv, kk);
      }
      group_sums<W>(z);
      float m_new = m;
#pragma unroll
      for (int dx = 0; dx < W; ++dx) {
        z[dx] = gq.y_in[dy] && gq.x_in[dx] ? z[dx] * c1 : -INFINITY;
        m_new = fmaxf(m_new, z[dx]);
      }
      if (m_new == -INFINITY) continue;  // the box row is off the grid
      const float corr = exp2f(m - m_new);  // 0 while m is -inf
      m = m_new;
      denom *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] *= corr;
#pragma unroll
      for (int dx = 0; dx < W; ++dx) {
        const float e = exp2f(z[dx] - m);  // 0 off the grid
        float vv[8];
        load_row(vs + (gq.ys[dy] + gq.xs[dx]) * kHeadDim, sub, vv);
        denom += e;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += e * vv[j];
      }
    }
    if (gq.active) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] /= denom;
      store_row(out + gq.row * kHeadDim, sub, acc);
      if (sub == 0) lse[gq.row] = (m + log2f(denom)) * (1.f / gam::kLog2e);
    }
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, const void* centers,
           void* plan, void* out, void* lse, int batch, int len_q,
           int len_kv, int heads, int grid_h, int grid_w, int plan_ints,
           float scale, float mask_fill, cudaStream_t stream) {
  const GatherPlan pl = gather_plan(plan, batch, len_q, grid_h, grid_w, R);
  constexpr size_t smem = window_bytes<T, R>();
  if (pl.ints > plan_ints || pl.max_pieces > 65535 || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      box_fwd_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = launch_gather_plan(
        static_cast<const int*>(centers), pl,
        OffGridRow<T>{static_cast<T*>(out), static_cast<float*>(lse), heads,
                      len_kv, scale, mask_fill},
        batch, len_q, grid_h, grid_w, R, stream);
  if (err != cudaSuccess) return (int)err;
  box_fwd_kernel<T, R><<<dim3(heads, pl.max_pieces, batch), kGatherThreads,
                         smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(centers), pl,
      static_cast<T*>(out), static_cast<float*>(lse), len_q, len_kv, heads,
      grid_h, grid_w, scale);
  return (int)cudaGetLastError();
}

// K1 for the radii the kernels are compiled for (box widths 3, 5, 7).
template <typename T>
int launch_any(const void* q, const void* k, const void* v,
               const void* centers, void* plan, void* out, void* lse,
               int batch, int len_q, int len_kv, int heads, int grid_h,
               int grid_w, int radius, int plan_ints, float scale,
               float mask_fill, cudaStream_t stream) {
  if (batch == 0 || len_q == 0) return 0;
  switch (radius) {
    case 1:
      return launch<T, 1>(q, k, v, centers, plan, out, lse, batch, len_q,
                          len_kv, heads, grid_h, grid_w, plan_ints, scale,
                          mask_fill, stream);
    case 2:
      return launch<T, 2>(q, k, v, centers, plan, out, lse, batch, len_q,
                          len_kv, heads, grid_h, grid_w, plan_ints, scale,
                          mask_fill, stream);
    case 3:
      return launch<T, 3>(q, k, v, centers, plan, out, lse, batch, len_q,
                          len_kv, heads, grid_h, grid_w, plan_ints, scale,
                          mask_fill, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: [B, L, H, 64]; k, v: [B, S, H, 64] with S = grid_h * grid_w; centers:
// int32 [B, L, 2] (cx, cy); plan: int32 scratch of plan_ints >= the size
// box_plan.cuh's GatherPlan carves; out: [B, L, H, 64] in the input type;
// lse: f32 [B, L, H]. is_bf16 selects bf16 (1) or f32 (0) for q, k, v and
// out. Returns the first launch error, or 0.
extern "C" int gam_box_window_attention(
    const void* q, const void* k, const void* v, const void* centers,
    void* plan, void* out, void* lse, int batch, int len_q, int len_kv,
    int heads, int grid_h, int grid_w, int radius, int plan_ints,
    float scale, float mask_fill, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_any<__nv_bfloat16>(q, k, v, centers, plan, out, lse,
                                     batch, len_q, len_kv, heads, grid_h,
                                     grid_w, radius, plan_ints, scale,
                                     mask_fill, s);
  return launch_any<float>(q, k, v, centers, plan, out, lse, batch, len_q,
                           len_kv, heads, grid_h, grid_w, radius, plan_ints,
                           scale, mask_fill, s);
}
