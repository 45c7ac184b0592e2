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
// K5 (dq) is the gather direction and shares K1's design (box_plan.cuh):
// the queries are sorted by the 8x8 destination tile that holds their
// centre, and a block takes a piece of at most 128 of one tile's queries
// and one head. It copies the tile's window of K and V rows ((8 + 2r)^2 =
// 144 cells, 72 KB in f32, 36 KB in bf16) into shared memory once, so each
// K/V row is read from L2 about (8 + 2r)^2 / 64 = 2.25 times a launch in
// all, not once for every query whose box covers it (25 times, ~1 GB a
// launch in f32 at B=4). Then 8 lanes per query, 8 channels a lane, walk
// the box's cells in raster order: two products a cell, summed over the 8
// lanes by 3 shuffle levels, and dq += dl k. Three launches: the plan's two
// (count, fill) and the pieces. The shared-memory reads (512 bytes a
// query-cell in f32) and the instructions per cell, not the bytes from
// memory, now bound a launch.
//
// K4 (dk/dv) is the scatter direction: the queries that touch key cell s are
// those whose centre lies within r of s, an irregular set under a
// homography, and a collapsing one (an untrained model's RANSAC fit, a zoom)
// crowds thousands of queries onto one key. So the work is cut into pieces
// of at most kPiece contributions, and a launch's time follows the total
// work, not its busiest key. No atomics on the gradients. Five launches:
//
// 1. box_count_kernel, one thread per query: its bucket, the query's centre
//    cell on the grid widened by r on each side (-1 off that widened grid:
//    its box misses the grid), and the buckets' counts (integer atomics,
//    the same counts in any order).
// 2. box_plan_kernel, one block per batch row: the counts' exclusive scan
//    (bucket starts of a counting sort); per key s its count n_s (its box's
//    2r+1 runs of 2r+1 adjacent buckets), its pieces P_s = max(1, ceil(n_s
//    / kPiece)), their numbering (a scan over the keys) and a piece -> key
//    map.
// 3. box_fill_kernel, one thread per query: its place in the sorted order
//    is its bucket's start plus the earlier queries of its bucket, so the
//    order within a bucket is the query order and the sums' order, hence
//    the bits, depend on the centres alone.
// 4. box_bwd_dkv_kernel, one warp per (batch, piece, 4 heads), 8 lanes a
//    head, 8 channels a lane: each lane finds one of the piece's queries,
//    then the warp takes them in the fixed (dy, dx, query) order, kUnroll
//    row loads in flight, 3 shuffle levels a product. A key with one piece
//    writes dk/dv; the pieces of a key with more write partial sums, and
// 5. box_dkv_sum_kernel sums those in piece order.
//
// The launch is sized by the most pieces any centres can give, S +
// ceil((2r+1)^2 L / kPiece) per batch row, so the host reads nothing; the
// surplus warps exit.

#include "box_plan.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// K5's contract for a row whose box misses the grid: dq = 0, all heads,
// in parts of 16 bytes.
struct ZeroDq {
  float* dq;
  int heads;
  __device__ int parts() const { return heads * kHeadDim / 4; }
  __device__ void operator()(long long bl, int i) const {
    reinterpret_cast<float4*>(dq + bl * heads * kHeadDim)[i] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// K5's pieces: one block per (head, piece, batch row) with the piece's
// window in dynamic shared memory (window_bytes<T, R>); a group of 8 lanes
// per query, each warp taking 4 queries at a time until the piece's are
// done. Each query visits the (2R+1)^2 cells of its box in raster order,
// every group in step (cells off the grid read a clamped cell and get p =
// 0), so the shuffles need no mask.
template <typename T, int R>
__global__ void __launch_bounds__(kGatherThreads, 3)
box_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ g,
                  const int* __restrict__ centers,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, const GatherPlan pl,
                  float* __restrict__ dq, int len_q, int len_kv, int heads,
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
  const float c1 = scale * gam::kLog2e;  // p = 2^(c1 q.k - log2e lse)
  gam::cp_async_wait<0>();
  __syncthreads();
  // warp w takes queries 4 w + group, then kGatherGroups further on
  for (int i0 = 4 * warp; i0 < pc.count; i0 += kGatherGroups) {
    const GroupQuery<R> gq = group_query<R>(pl.order, centers, b, len_q,
                                            heads, h, grid_h, grid_w, pc,
                                            i0 + group);
    float qv[8], gv[8], acc[8];
    load_row(q + gq.row * kHeadDim, sub, qv);
    load_row_as<T>(g + gq.row * kHeadDim, sub, gv);
    const float lse2 = lse[gq.row] * gam::kLog2e, row_delta = delta[gq.row];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < W; ++dy) {
#pragma unroll
      for (int dx = 0; dx < W; ++dx) {
        const int cell = gq.ys[dy] + gq.xs[dx];
        float kk[8], vv[8], sums[2];
        load_row(ks + cell * kHeadDim, sub, kk);
        load_row(vs + cell * kHeadDim, sub, vv);
        sums[0] = dot8(qv, kk);
        sums[1] = dot8(gv, vv);
        group_sums<2>(sums);
        const float p =
            gq.y_in[dy] && gq.x_in[dx] ? exp2f(sums[0] * c1 - lse2) : 0.f;
        const float dl = p * (sums[1] - row_delta) * scale;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += dl * kk[j];
      }
    }
    if (gq.active) store_row_as<T>(dq + gq.row * kHeadDim, sub, acc);
  }
}

// Widened-grid bucket of a query centre, or -1 if its box misses the grid.
__device__ __forceinline__ int bucket_of(int cx, int cy, int grid_h,
                                         int grid_w, int radius) {
  const int ex = cx + radius, ey = cy + radius;
  const int ew = grid_w + 2 * radius, eh = grid_h + 2 * radius;
  if (ex < 0 || ex >= ew || ey < 0 || ey >= eh) return -1;
  return ey * ew + ex;
}

constexpr int kPiece = 64;  // contributions a warp of K4 takes at most
constexpr int kPlanThreads = 1024;

// One thread per (batch, query), grid (L / kFillThreads, B): the query's
// bucket into bucket [B, len_q], and its count into the bucket's counts
// [B, n_buckets + 1] and into its block's chunk_counts [B, gridDim.x,
// n_buckets] (both zeroed before; integer atomics give the same counts in
// any order).
__global__ void __launch_bounds__(kFillThreads)
box_count_kernel(const int* __restrict__ centers, int* __restrict__ bucket,
                 int* __restrict__ counts, int* __restrict__ chunk_counts,
                 int len_q, int grid_h, int grid_w, int radius,
                 int n_buckets) {
  const int l = blockIdx.x * kFillThreads + threadIdx.x;
  const long long b = blockIdx.y;
  if (l >= len_q) return;
  const long long bl = b * len_q + l;
  const int bk = bucket_of(centers[2 * bl], centers[2 * bl + 1], grid_h,
                           grid_w, radius);
  bucket[bl] = bk;
  if (bk < 0) return;
  atomicAdd(&counts[b * (n_buckets + 1) + bk], 1);
  atomicAdd(&chunk_counts[(b * gridDim.x + blockIdx.x) * n_buckets + bk], 1);
}

// One block per batch row: the counts in starts [B, n_buckets + 1] become
// bucket starts (bucket j's queries will be order[starts[j] ..
// starts[j + 1])); then per key s its count n_s (the 2r+1 runs of 2r+1
// adjacent buckets of its box), its pieces P_s = max(1, ceil(n_s /
// kPiece)), piece_base [B, len_kv + 1] (key s has pieces piece_base[s] ..
// piece_base[s + 1]; the last entry is the row's number of pieces) and
// piece_key [B, max_pieces]. Shared memory: n_buckets + 1 + len_kv + 32
// ints.
__global__ void __launch_bounds__(kPlanThreads)
box_plan_kernel(int* __restrict__ starts, int* __restrict__ piece_base,
                int* __restrict__ piece_key, int len_kv, int grid_w,
                int radius, int n_buckets, int max_pieces) {
  extern __shared__ int smem[];
  int* cnt = smem;
  int* pcnt = cnt + n_buckets + 1;
  int* warp_tot = pcnt + len_kv;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b = blockIdx.x;
  int* sb = starts + b * (n_buckets + 1);

  for (int j = tid; j < n_buckets; j += nt) cnt[j] = sb[j];
  __syncthreads();
  const int on_grid = block_exclusive_scan(cnt, n_buckets, warp_tot);
  for (int j = tid; j < n_buckets; j += nt) sb[j] = cnt[j];
  if (tid == 0) {
    cnt[n_buckets] = on_grid;
    sb[n_buckets] = on_grid;
  }
  __syncthreads();
  const int ew = grid_w + 2 * radius, w = 2 * radius + 1;
  for (int s = tid; s < len_kv; s += nt) {
    const int sx = s % grid_w, sy = s / grid_w;
    int n = 0;
    for (int i = 0; i < w; ++i) {
      const int b0 = (sy + i) * ew + sx;
      n += cnt[b0 + w] - cnt[b0];
    }
    pcnt[s] = max(1, (n + kPiece - 1) / kPiece);
  }
  __syncthreads();
  const int n_pieces = block_exclusive_scan(pcnt, len_kv, warp_tot);
  int* pb = piece_base + b * (long long)(len_kv + 1);
  int* pk = piece_key + b * (long long)max_pieces;
  for (int s = tid; s < len_kv; s += nt) {
    const int end = s + 1 < len_kv ? pcnt[s + 1] : n_pieces;
    pb[s] = pcnt[s];
    for (int p = pcnt[s]; p < end; ++p) pk[p] = s;
  }
  if (tid == 0) pb[len_kv] = n_pieces;
}

// One thread per (batch, query), grid (L / kFillThreads, B): the query's
// place in order [B, len_q] is its bucket's start plus the earlier queries
// of its bucket (those of the earlier blocks from chunk_counts, those of its
// own block counted in shared memory), so the order within a bucket is the
// query order.
__global__ void __launch_bounds__(kFillThreads)
box_fill_kernel(const int* __restrict__ bucket,
                const int* __restrict__ chunk_counts,
                const int* __restrict__ starts, int* __restrict__ order,
                int len_q, int n_buckets) {
  __shared__ int sbk[kFillThreads];
  const int tid = threadIdx.x;
  const int l = blockIdx.x * kFillThreads + tid;
  const long long b = blockIdx.y;
  sbk[tid] = l < len_q ? bucket[b * len_q + l] : -1;
  __syncthreads();
  const int bk = sbk[tid];
  if (bk < 0) return;
  int rank = 0;
  const int* cc = chunk_counts + b * gridDim.x * (long long)n_buckets + bk;
  for (int c = 0; c < (int)blockIdx.x; ++c) rank += cc[c * (long long)n_buckets];
  for (int j = 0; j < tid; ++j) rank += sbk[j] == bk;
  order[b * len_q + starts[b * (n_buckets + 1) + bk] + rank] = l;
}

// Eight consecutive elements widened to f32 (32- or 16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

constexpr int kGroupHeads = 4;  // heads a warp of K4 takes, 8 lanes each
constexpr int kUnroll = 4;      // contributions in flight in a warp of K4

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 3)
box_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ starts,
                   const int* __restrict__ order,
                   const int* __restrict__ piece_base,
                   const int* __restrict__ piece_key,
                   float* __restrict__ part, float* __restrict__ dk,
                   float* __restrict__ dv, int batch, int len_q, int len_kv,
                   int heads, int grid_w, int radius, int n_buckets,
                   int max_pieces, float scale) {
  const int n_groups = (heads + kGroupHeads - 1) / kGroupHeads;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * max_pieces * n_groups) return;
  const long long bp = row / n_groups;  // b * max_pieces + piece
  const long long b = bp / max_pieces;
  const int p = (int)(bp % max_pieces);
  const int* pb = piece_base + b * (long long)(len_kv + 1);
  // both loads before the exit; a surplus piece's key is never used
  const int n_pieces = pb[len_kv];
  const int s = piece_key[bp];
  if (p >= n_pieces) return;
  const int sx = s % grid_w, sy = s / grid_w;
  const int ew = grid_w + 2 * radius, w = 2 * radius + 1;
  const int* sb = starts + b * (long long)(n_buckets + 1);
  const int* ob = order + b * (long long)len_q;

  // lane i < w: the run of box row i (its w buckets are adjacent)
  int run_beg = 0, run_len = 0;
  if (lane < w) {
    const int b0 = (sy + lane) * ew + sx;
    run_beg = sb[b0];
    run_len = sb[b0 + w] - run_beg;
  }
  // 8 lanes a head, a lane holds channels 8 sub .. 8 sub + 7
  const int h = (int)(row % n_groups) * kGroupHeads + (lane >> 3);
  const int hc = min(h, heads - 1);  // a group past the last head idles
  const int sub = lane & 7;
  const long long krow = (b * len_kv + s) * heads + hc;
  float kk[8], vv[8], ak[8], av[8];
  load8(k + krow * kHeadDim + 8 * sub, kk);
  load8(v + krow * kHeadDim + 8 * sub, vv);
  const int first = pb[s];
  const bool alone = pb[s + 1] - first == 1;

  int incl = run_len;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(gam::kFullMask, incl, o);
    if (lane >= o) incl += up;
  }
  const int n_key = __shfl_sync(gam::kFullMask, incl, w - 1);
  const int c0 = (p - first) * kPiece;
  const int cnt = min(kPiece, n_key - c0);
  // the piece's contribution c0 + 32 m + lane: its run, then its query
  int my_l[kPiece / 32];
#pragma unroll
  for (int m = 0; m < kPiece / 32; ++m) {
    const int c = c0 + 32 * m + lane;
    int run = 0;
    for (int i = 0; i < w; ++i)
      run += c >= __shfl_sync(gam::kFullMask, incl, i) ? 1 : 0;
    const int rb = __shfl_sync(gam::kFullMask, run_beg, run);
    const int rx = __shfl_sync(gam::kFullMask, incl - run_len, run);
    my_l[m] = 32 * m + lane < cnt ? ob[rb + c - rx] : 0;
  }

  // this lane's head and channels of the batch row's q and g, lse and
  // delta; a query's offset in the row fits 32 bits (the launch checks)
  const long long qbase = b * len_q * heads + hc;
  const T* qb = q + qbase * kHeadDim + 8 * sub;
  const float* gb = g + qbase * kHeadDim + 8 * sub;
  const float* lb = lse + qbase;
  const float* db = delta + qbase;
#pragma unroll
  for (int i = 0; i < 8; ++i) ak[i] = av[i] = 0.f;
#pragma unroll
  for (int m = 0; m < kPiece / 32; ++m) {
    const int n_m = min(32, cnt - 32 * m);
    for (int t0 = 0; t0 < n_m; t0 += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u;
        const int qrow = __shfl_sync(gam::kFullMask, my_l[m], t) * heads;
        float qv[8], gv[8];
        load8(qb + qrow * kHeadDim, qv);
        load8(gb + qrow * kHeadDim, gv);
        float qk = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          qk += qv[i] * kk[i];
          dp += gv[i] * vv[i];
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          qk += __shfl_xor_sync(gam::kFullMask, qk, o);
          dp += __shfl_xor_sync(gam::kFullMask, dp, o);
        }
        const bool valid = t < n_m;
        const float pr = valid ? expf(scale * qk - lb[qrow]) : 0.f;
        const float dl = valid ? pr * (dp - db[qrow]) * scale : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          av[i] += pr * gv[i];
          ak[i] += dl * qv[i];
        }
      }
    }
  }
  if (h < heads) {
    float* dkp = alone ? dk + krow * kHeadDim
                       : part + (bp * heads + h) * (2 * kHeadDim);
    float* dvp = alone ? dv + krow * kHeadDim : dkp + kHeadDim;
    store8(dkp + 8 * sub, ak);
    store8(dvp + 8 * sub, av);
  }
}

// One warp per (batch, key, group of 4 heads) of a key with more than one
// piece, lanes as in box_bwd_dkv_kernel: the sum of its pieces' partials,
// in piece order.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
box_dkv_sum_kernel(const float* __restrict__ part,
                   const int* __restrict__ piece_base,
                   float* __restrict__ dk, float* __restrict__ dv, int batch,
                   int len_kv, int heads, int max_pieces) {
  const int n_groups = (heads + kGroupHeads - 1) / kGroupHeads;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * len_kv * n_groups) return;
  const long long bs = row / n_groups;  // b * len_kv + s
  const long long b = bs / len_kv;
  const int s = (int)(bs % len_kv);
  const int* pb = piece_base + b * (long long)(len_kv + 1);
  const int first = pb[s], last = pb[s + 1];
  const int h = (int)(row % n_groups) * kGroupHeads + (lane >> 3);
  if (last - first < 2 || h >= heads) return;
  const int sub = lane & 7;
  float ak[8], av[8], xk[8], xv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ak[i] = av[i] = 0.f;
  const float* src =
      part + ((b * max_pieces + first) * heads + h) * (2 * kHeadDim) +
      8 * sub;
  for (int p = first; p < last; ++p, src += heads * 2 * kHeadDim) {
    load8(src, xk);
    load8(src + kHeadDim, xv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ak[i] += xk[i];
      av[i] += xv[i];
    }
  }
  const long long krow = (bs * heads + h) * kHeadDim + 8 * sub;
  store8(dk + krow, ak);
  store8(dv + krow, av);
}

unsigned blocks_for(long long rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T, int R>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* centers, const void* lse, const void* delta,
              void* plan, void* dq, int batch, int len_q, int len_kv,
              int heads, int grid_h, int grid_w, int plan_ints, float scale,
              cudaStream_t stream) {
  const GatherPlan pl = gather_plan(plan, batch, len_q, grid_h, grid_w, R);
  constexpr size_t smem = window_bytes<T, R>();
  if (pl.ints > plan_ints || pl.max_pieces > 65535 || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      box_bwd_dq_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = launch_gather_plan(static_cast<const int*>(centers), pl,
                             ZeroDq{static_cast<float*>(dq), heads}, batch,
                             len_q, grid_h, grid_w, R, stream);
  if (err != cudaSuccess) return (int)err;
  box_bwd_dq_kernel<T, R><<<dim3(heads, pl.max_pieces, batch),
                            kGatherThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const int*>(centers), static_cast<const float*>(lse),
      static_cast<const float*>(delta), pl, static_cast<float*>(dq), len_q,
      len_kv, heads, grid_h, grid_w, scale);
  return (int)cudaGetLastError();
}

// K5 for the radii the kernels are compiled for (box widths 3, 5, 7).
template <typename T>
int launch_dq_any(const void* q, const void* k, const void* v, const void* g,
                  const void* centers, const void* lse, const void* delta,
                  void* plan, void* dq, int batch, int len_q, int len_kv,
                  int heads, int grid_h, int grid_w, int radius,
                  int plan_ints, float scale, cudaStream_t stream) {
  if (batch == 0 || len_q == 0) return 0;
  switch (radius) {
    case 1:
      return launch_dq<T, 1>(q, k, v, g, centers, lse, delta, plan, dq,
                             batch, len_q, len_kv, heads, grid_h, grid_w,
                             plan_ints, scale, stream);
    case 2:
      return launch_dq<T, 2>(q, k, v, g, centers, lse, delta, plan, dq,
                             batch, len_q, len_kv, heads, grid_h, grid_w,
                             plan_ints, scale, stream);
    case 3:
      return launch_dq<T, 3>(q, k, v, g, centers, lse, delta, plan, dq,
                             batch, len_q, len_kv, heads, grid_h, grid_w,
                             plan_ints, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* centers, const void* lse, const void* delta,
               void* starts, void* chunk_counts, void* bucket, void* order,
               void* piece_base, void* piece_key, void* part, void* dk,
               void* dv, int batch,
               int len_q, int len_kv, int heads, int grid_h, int grid_w,
               int radius, int max_pieces, float scale, cudaStream_t stream) {
  const int w = 2 * radius + 1;
  const int n_buckets = (grid_h + 2 * radius) * (grid_w + 2 * radius);
  // a warp holds a key's 2r+1 runs; a query's offset in its batch row
  // fits 32 bits; the scratch holds the most pieces any centres give
  if (radius < 0 || w > 31 ||
      (long long)len_q * heads * kHeadDim >= (1LL << 31) ||
      max_pieces < len_kv + ((long long)w * w * len_q + kPiece - 1) / kPiece)
    return (int)cudaErrorInvalidValue;
  const size_t plan_smem = ((size_t)n_buckets + 1 + len_kv + 32) * sizeof(int);
  const int n_chunks = (len_q + kFillThreads - 1) / kFillThreads;
  cudaError_t err = cudaFuncSetAttribute(
      box_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)plan_smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(starts, 0,
                          (size_t)batch * (n_buckets + 1) * sizeof(int),
                          stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(
        chunk_counts, 0,
        (size_t)batch * n_chunks * n_buckets * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 per_query(n_chunks, batch);
  box_count_kernel<<<per_query, kFillThreads, 0, stream>>>(
      static_cast<const int*>(centers), static_cast<int*>(bucket),
      static_cast<int*>(starts), static_cast<int*>(chunk_counts), len_q,
      grid_h, grid_w, radius, n_buckets);
  box_plan_kernel<<<batch, kPlanThreads, plan_smem, stream>>>(
      static_cast<int*>(starts), static_cast<int*>(piece_base),
      static_cast<int*>(piece_key), len_kv, grid_w, radius, n_buckets,
      max_pieces);
  box_fill_kernel<<<per_query, kFillThreads, 0, stream>>>(
      static_cast<const int*>(bucket), static_cast<const int*>(chunk_counts),
      static_cast<const int*>(starts), static_cast<int*>(order), len_q,
      n_buckets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (heads + kGroupHeads - 1) / kGroupHeads;
  box_bwd_dkv_kernel<T>
      <<<blocks_for((long long)batch * max_pieces * n_groups),
         kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(g),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int*>(starts), static_cast<const int*>(order),
          static_cast<const int*>(piece_base),
          static_cast<const int*>(piece_key), static_cast<float*>(part),
          static_cast<float*>(dk), static_cast<float*>(dv), batch, len_q,
          len_kv, heads, grid_w, radius, n_buckets, max_pieces, scale);
  box_dkv_sum_kernel<<<blocks_for((long long)batch * len_kv * n_groups),
                       kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(piece_base),
      static_cast<float*>(dk), static_cast<float*>(dv), batch, len_kv, heads,
      max_pieces);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. q: [B, L, H, 64]; k, v: [B, S, H, 64] (bf16 if is_bf16 else f32), S =
// grid_h * grid_w; g: f32 [B, L, H, 64]; centers: int32 [B, L, 2]; lse,
// delta: f32 [B, L, H]; plan: int32 scratch of plan_ints >= the size
// box_plan.cuh's GatherPlan carves. Writes f32 dq [B, L, H, 64]. Returns the
// first launch error, or 0.
extern "C" int gam_box_window_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* centers, const void* lse, const void* delta, void* plan,
    void* dq, int batch, int len_q, int len_kv, int heads, int grid_h,
    int grid_w, int radius, int plan_ints, float scale, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dq_any<__nv_bfloat16>(q, k, v, g, centers, lse, delta,
                                        plan, dq, batch, len_q, len_kv, heads,
                                        grid_h, grid_w, radius, plan_ints,
                                        scale, s);
  return launch_dq_any<float>(q, k, v, g, centers, lse, delta, plan, dq,
                              batch, len_q, len_kv, heads, grid_h, grid_w,
                              radius, plan_ints, scale, s);
}

// K4. Inputs as K5; scratch: with n_buckets = (grid_h + 2r)(grid_w + 2r),
// int32 starts [B, n_buckets + 1], chunk_counts [B, ceil(L / 256),
// n_buckets], bucket and order [B, L], piece_base [B, S + 1], piece_key [B,
// max_pieces] and f32 part [B, max_pieces, H, 2, 64], where max_pieces >= S
// + ceil((2r+1)^2 L / 64). Writes f32 dk, dv [B, S, H, 64]. Returns the
// first launch error, or 0.
extern "C" int gam_box_window_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* centers, const void* lse, const void* delta, void* starts,
    void* chunk_counts, void* bucket, void* order, void* piece_base,
    void* piece_key, void* part, void* dk, void* dv, int batch, int len_q,
    int len_kv, int heads, int grid_h, int grid_w, int radius,
    int max_pieces, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dkv<__nv_bfloat16>(
        q, k, v, g, centers, lse, delta, starts, chunk_counts, bucket, order,
        piece_base, piece_key, part, dk, dv, batch, len_q, len_kv, heads,
        grid_h, grid_w, radius, max_pieces, scale, s);
  return launch_dkv<float>(
      q, k, v, g, centers, lse, delta, starts, chunk_counts, bucket, order,
      piece_base, piece_key, part, dk, dv, batch, len_q, len_kv, heads,
      grid_h, grid_w, radius, max_pieces, scale, s);
}
