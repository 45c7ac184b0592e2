// Plans of the box-window attention kernels: the block scan that K4
// (box_window_attention_bwd.cu) and the gather pair K1/K5 share, and the
// gather pair's plan and shared-memory window.
//
// The gather plan (K1 forward, K5 dq backward). The destination grid,
// widened by r on each side, is cut into tiles of kGatherTile x kGatherTile
// cells. A query belongs to the tile that holds its centre; every in-grid
// cell of its box then lies in the tile's window, the tile widened by r
// again and clamped to the grid: at most (kGatherTile + 2r)^2 cells. Each
// tile's queries, in query order, are cut into pieces of at most
// kGatherPiece, and one block takes a piece and one head with the window's
// K and V rows of that head in shared memory. Two launches before the
// pieces, no memset and no atomics in global memory:
//
// 1. gather_count_kernel, one block per chunk of kFillThreads queries: each
//    query's tile (-1 if its box misses the grid; the block then writes the
//    row's contract value) and the chunk's count of each tile (a histogram
//    in shared memory, written out whole).
// 2. gather_fill_kernel, the same blocks: each computes the tiles' counts
//    (sums over chunks) and their exclusive scan (tile starts of a counting
//    sort), and places its queries in the sorted order: a query's place is
//    its tile's start plus the earlier queries of its tile (those of the
//    earlier chunks from the chunk counts, those of its own chunk counted
//    in shared memory). The order within a tile is the query order, so
//    which group of lanes takes a query, and hence every bit of the
//    results, depends on the centres alone. The first block of each batch
//    row also writes the starts, each tile's pieces ceil(n_t /
//    kGatherPiece), their numbering and a piece -> tile map.
//
// The pieces kernels' grids are sized by the most pieces any centres can
// give, tiles + ceil(L / kGatherPiece) a batch row, so the host reads
// nothing; the surplus blocks exit after two loads.

#pragma once

#include "gam_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kFillThreads = 256;  // queries a chunk of the counting sort
constexpr int kGatherTile = 8;     // tile side, in cells
constexpr int kGatherPiece = 128;  // queries a block of K1/K5 takes at most
constexpr int kGatherThreads = 256;  // 8 warps of 4 groups of 8 lanes
constexpr int kGatherGroups = kGatherThreads / 8;

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// In-place exclusive scan of a[0..n) in shared memory by the whole block;
// returns the total. warp_tot: 32 ints of shared memory.
__device__ int block_exclusive_scan(int* a, int n, int* warp_tot) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int seg = (n + nt - 1) / nt;
  const int j0 = min(tid * seg, n), j1 = min(j0 + seg, n);
  int sum = 0;
  for (int j = j0; j < j1; ++j) sum += a[j];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(gam::kFullMask, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < n_warps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(gam::kFullMask, x, o);
      if (lane >= o) x += up;
    }
    warp_tot[lane] = x;
  }
  __syncthreads();
  int run = (warp > 0 ? warp_tot[warp - 1] : 0) + incl - sum;
  for (int j = j0; j < j1; ++j) {
    const int c = a[j];
    a[j] = run;
    run += c;
  }
  const int total = warp_tot[n_warps - 1];
  __syncthreads();
  return total;
}

// ------------------------------------------------------- gather plan ------

// The gather plan's int32 scratch, carved in this order (the wrapper's
// _box_gather_scratch sizes it the same way).
struct GatherPlan {
  int n_tiles_x, n_tiles, n_chunks, max_pieces;
  int* starts;        // [B, n_tiles + 1]: tile starts, then the total
  int* chunk_counts;  // [B, n_chunks, n_tiles]
  int* bucket;        // [B, L]: each query's tile, -1 off the grid
  int* order;         // [B, L]: the queries sorted by tile
  int* piece_base;    // [B, n_tiles + 1]: tile t has pieces pb[t]..pb[t+1]
  int* piece_tile;    // [B, max_pieces]
  long long ints;     // the scratch's size
};

inline GatherPlan gather_plan(void* scratch, int batch, int len_q,
                              int grid_h, int grid_w, int radius) {
  GatherPlan p;
  p.n_tiles_x = cdiv(grid_w + 2 * radius, kGatherTile);
  p.n_tiles = p.n_tiles_x * cdiv(grid_h + 2 * radius, kGatherTile);
  p.n_chunks = cdiv(len_q, kFillThreads);
  p.max_pieces = p.n_tiles + cdiv(len_q, kGatherPiece);
  int* s = static_cast<int*>(scratch);
  const long long nb = batch;
  p.starts = s;
  p.chunk_counts = p.starts + nb * (p.n_tiles + 1);
  p.bucket = p.chunk_counts + nb * p.n_chunks * p.n_tiles;
  p.order = p.bucket + nb * len_q;
  p.piece_base = p.order + nb * len_q;
  p.piece_tile = p.piece_base + nb * (p.n_tiles + 1);
  p.ints = (p.piece_tile + nb * p.max_pieces) - s;
  return p;
}

// One block per (chunk of kFillThreads queries, batch row): each query's
// tile into bucket and the chunk's tile counts into chunk_counts (a
// histogram in shared memory, n_tiles ints, warp-aggregated adds). The rows
// whose box misses the grid are listed in shared memory and the block
// writes their contract values together: off(bl, i) writes part i of row
// bl, i < off.parts().
template <class OffGrid>
__global__ void __launch_bounds__(kFillThreads)
gather_count_kernel(const int* __restrict__ centers, int* __restrict__ bucket,
                    int* __restrict__ chunk_counts, int len_q, int grid_h,
                    int grid_w, int radius, int n_tiles_x, int n_tiles,
                    OffGrid off) {
  extern __shared__ int hist[];
  __shared__ long long off_rows[kFillThreads];
  __shared__ int n_off;
  for (int j = threadIdx.x; j < n_tiles; j += kFillThreads) hist[j] = 0;
  if (threadIdx.x == 0) n_off = 0;
  __syncthreads();
  const int l = blockIdx.x * kFillThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.y;
  const long long bl = b * len_q + l;
  int t = -1;
  bool off_grid = false;
  if (l < len_q) {
    const int cx = centers[2 * bl], cy = centers[2 * bl + 1];
    off_grid = cx < -radius || cx >= grid_w + radius || cy < -radius ||
               cy >= grid_h + radius;
    if (!off_grid)
      t = ((cy + radius) / kGatherTile) * n_tiles_x +
          (cx + radius) / kGatherTile;
    bucket[bl] = t;
  }
  const unsigned offs = __ballot_sync(gam::kFullMask, off_grid);
  if (offs != 0) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&n_off, __popc(offs));
    base = __shfl_sync(gam::kFullMask, base, 0);
    if (off_grid) off_rows[base + __popc(offs & ((1u << lane) - 1))] = bl;
  }
  const unsigned on = __ballot_sync(gam::kFullMask, t >= 0);
  if (t >= 0) {
    const unsigned peers = __match_any_sync(on, t);
    if (lane == __ffs(peers) - 1) atomicAdd(&hist[t], __popc(peers));
  }
  __syncthreads();
  int* cc = chunk_counts + (b * gridDim.x + blockIdx.x) * (long long)n_tiles;
  for (int j = threadIdx.x; j < n_tiles; j += kFillThreads) cc[j] = hist[j];
  const int parts = off.parts();
  for (int i = threadIdx.x; i < n_off * parts; i += kFillThreads)
    off(off_rows[i / parts], i % parts);
}

// The same blocks as gather_count_kernel: the plan (by the first block of
// each batch row) and each query's place in order. Shared memory: 2 n_tiles
// + 32 ints.
__global__ void __launch_bounds__(kFillThreads)
gather_fill_kernel(const int* __restrict__ bucket,
                   const int* __restrict__ chunk_counts,
                   int* __restrict__ starts, int* __restrict__ order,
                   int* __restrict__ piece_base, int* __restrict__ piece_tile,
                   int len_q, int n_tiles, int max_pieces) {
  extern __shared__ int smem[];
  int* cnt = smem;
  int* pcnt = cnt + n_tiles;
  int* warp_tot = pcnt + n_tiles;
  __shared__ int sbk[kFillThreads];
  const int tid = threadIdx.x;
  const int l = blockIdx.x * kFillThreads + tid;
  const long long b = blockIdx.y;
  const int n_chunks = gridDim.x;
  const int* cc = chunk_counts + b * n_chunks * (long long)n_tiles;
  sbk[tid] = l < len_q ? bucket[b * len_q + l] : -1;
  for (int j = tid; j < n_tiles; j += kFillThreads) {
    int c = 0;
    for (int k = 0; k < n_chunks; ++k) c += cc[k * (long long)n_tiles + j];
    cnt[j] = c;
    pcnt[j] = cdiv(c, kGatherPiece);
  }
  __syncthreads();
  const int on_grid = block_exclusive_scan(cnt, n_tiles, warp_tot);
  if (blockIdx.x == 0) {
    const int n_pieces = block_exclusive_scan(pcnt, n_tiles, warp_tot);
    int* sb = starts + b * (n_tiles + 1);
    int* pb = piece_base + b * (n_tiles + 1);
    int* pt = piece_tile + b * max_pieces;
    for (int j = tid; j < n_tiles; j += kFillThreads) {
      sb[j] = cnt[j];
      pb[j] = pcnt[j];
      const int end = j + 1 < n_tiles ? pcnt[j + 1] : n_pieces;
      for (int p = pcnt[j]; p < end; ++p) pt[p] = j;
    }
    if (tid == 0) {
      sb[n_tiles] = on_grid;
      pb[n_tiles] = n_pieces;
    }
  }
  const int bk = sbk[tid];
  if (bk < 0) return;
  int rank = cnt[bk];
  for (int c = 0; c < (int)blockIdx.x; ++c)
    rank += cc[c * (long long)n_tiles + bk];
  for (int j = 0; j < tid; ++j) rank += sbk[j] == bk;
  order[b * len_q + rank] = l;
}

// The plan's launches (count, fill) on the stream; the first error.
template <class OffGrid>
cudaError_t launch_gather_plan(const int* centers, const GatherPlan& p,
                               OffGrid off, int batch, int len_q, int grid_h,
                               int grid_w, int radius, cudaStream_t stream) {
  const size_t fill_smem = (2 * (size_t)p.n_tiles + 32) * sizeof(int);
  if (fill_smem > 32 * 1024) return cudaErrorInvalidValue;
  const dim3 per_query(p.n_chunks, batch);
  gather_count_kernel<<<per_query, kFillThreads, p.n_tiles * sizeof(int),
                        stream>>>(centers, p.bucket, p.chunk_counts, len_q,
                                  grid_h, grid_w, radius, p.n_tiles_x,
                                  p.n_tiles, off);
  gather_fill_kernel<<<per_query, kFillThreads, fill_smem, stream>>>(
      p.bucket, p.chunk_counts, p.starts, p.order, p.piece_base,
      p.piece_tile, len_q, p.n_tiles, p.max_pieces);
  return cudaGetLastError();
}

// ------------------------------------------------------ pieces' side ------

// A block's piece: its queries order[first .. first + count) of its batch
// row, and its tile's window on the grid (ww x wh cells from (wx0, wy0)).
struct Piece {
  int first, count, wx0, wy0, ww, wh;
};

// The piece p of batch row b, or false for a surplus block.
__device__ __forceinline__ bool find_piece(const GatherPlan& pl, long long b,
                                           int p, int grid_h, int grid_w,
                                           int radius, Piece& pc) {
  const int* pb = pl.piece_base + b * (pl.n_tiles + 1);
  const int n_pieces = pb[pl.n_tiles];
  if (p >= n_pieces) return false;
  const int t = pl.piece_tile[b * pl.max_pieces + p];
  const int* sb = pl.starts + b * (pl.n_tiles + 1);
  pc.first = sb[t] + (p - pb[t]) * kGatherPiece;
  pc.count = min(kGatherPiece, sb[t + 1] - pc.first);
  // centres of tile (tx, ty) lie in [T tx - r, T tx + T - 1 - r], so
  // their boxes in [T tx - 2r, T tx + T - 1]; likewise in y
  const int x0 = (t % pl.n_tiles_x) * kGatherTile - 2 * radius;
  const int y0 = (t / pl.n_tiles_x) * kGatherTile - 2 * radius;
  pc.wx0 = max(x0, 0);
  pc.wy0 = max(y0, 0);
  pc.ww = min(x0 + kGatherTile + 2 * radius - 1, grid_w - 1) - pc.wx0 + 1;
  pc.wh = min(y0 + kGatherTile + 2 * radius - 1, grid_h - 1) - pc.wy0 + 1;
  return true;
}

// Copies head h's K and V rows of the piece's window into ks, vs (cell
// (x, y) at row (y - wy0) ww + x - wx0), 16 bytes a cp.async; commits.
template <typename T>
__device__ __forceinline__ void stage_window(T* ks, T* vs, const T* k,
                                             const T* v, long long b, int h,
                                             int heads, int len_kv,
                                             int grid_w, const Piece& pc) {
  constexpr int kPer = 16 / sizeof(T);     // elements a chunk
  constexpr int kChunks = kHeadDim / kPer;  // chunks a row
  const int n = pc.ww * pc.wh * kChunks;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int cell = i / kChunks, c = (i % kChunks) * kPer;
    const int y = pc.wy0 + cell / pc.ww, x = pc.wx0 + cell % pc.ww;
    const long long off =
        ((b * len_kv + (long long)y * grid_w + x) * heads + h) * kHeadDim + c;
    gam::cp_async16(ks + cell * kHeadDim + c, k + off, true);
    gam::cp_async16(vs + cell * kHeadDim + c, v + off, true);
  }
  gam::cp_async_commit();
}

// A row of 64 channels is held by a group of 8 lanes (sub = 0..7), 8
// channels a lane: in f32 two runs of 4, channels 4 sub.. and 32 + 4 sub..;
// in bf16 one run of 8, channels 8 sub... Either way each 16-byte read of
// the group covers one contiguous 128-byte span, so a warp's four groups
// read shared memory without bank conflicts (one row per quarter-warp, no
// padding) and global memory in whole lines. Rows of f32 that go with a
// row of T (g, dq) use T's channel map.
__device__ __forceinline__ void unpack(float4 a, float4 c, float (&x)[8]) {
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}
__device__ __forceinline__ void load_row(const float* row, int sub,
                                         float (&x)[8]) {
  unpack(*reinterpret_cast<const float4*>(row + 4 * sub),
         *reinterpret_cast<const float4*>(row + 32 + 4 * sub), x);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* row, int sub,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * sub);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_row(float* row, int sub,
                                          const float (&x)[8]) {
  *reinterpret_cast<float4*>(row + 4 * sub) =
      make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(row + 32 + 4 * sub) =
      make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* row, int sub,
                                          const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(row + 8 * sub) = u;
}
// an f32 row in the channel map of T
template <typename T>
__device__ __forceinline__ void load_row_as(const float* row, int sub,
                                            float (&x)[8]) {
  if constexpr (sizeof(T) == 4) {
    load_row(row, sub, x);
  } else {
    unpack(*reinterpret_cast<const float4*>(row + 8 * sub),
           *reinterpret_cast<const float4*>(row + 8 * sub + 4), x);
  }
}
template <typename T>
__device__ __forceinline__ void store_row_as(float* row, int sub,
                                             const float (&x)[8]) {
  if constexpr (sizeof(T) == 4) {
    store_row(row, sub, x);
  } else {
    *reinterpret_cast<float4*>(row + 8 * sub) =
        make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(row + 8 * sub + 4) =
        make_float4(x[4], x[5], x[6], x[7]);
  }
}

// A lane's part of a dot product: its 8 channels in two chains of 4.
__device__ __forceinline__ float dot8(const float (&a)[8],
                                      const float (&b)[8]) {
  float e = a[0] * b[0], o = a[1] * b[1];
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    e += a[j] * b[j];
    o += a[j + 1] * b[j + 1];
  }
  return e + o;
}

// The sums over each group of 8 lanes of N values side by side (3 shuffle
// levels; every lane of the warp takes part).
template <int N>
__device__ __forceinline__ void group_sums(float (&x)[N]) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] += __shfl_xor_sync(gam::kFullMask, x[i], o);
}

// Dynamic shared memory of a pieces block: K and V rows of the largest
// window, (kGatherTile + 2R)^2 cells.
template <typename T, int R>
constexpr size_t window_bytes() {
  return 2 * (size_t)(kGatherTile + 2 * R) * (kGatherTile + 2 * R) *
         kHeadDim * sizeof(T);
}

// A query of a piece as one group of lanes sees it: its row (b L + l) H + h,
// whether the group has a query at all (a group past the piece's count
// takes its last query and stores nothing), and for each of the box's W =
// 2R+1 columns and rows its offset in the window (clamped to the grid) and
// whether it lies on the grid. Cell (dx, dy) of the box is window row
// ys[dy] + xs[dx]; off the grid it is a clamped in-box cell, which the
// kernels read and give no weight.
template <int R>
struct GroupQuery {
  static constexpr int W = 2 * R + 1;
  long long row;
  bool active;
  int xs[W], ys[W];
  bool x_in[W], y_in[W];
};

template <int R>
__device__ __forceinline__ GroupQuery<R> group_query(
    const int* __restrict__ order, const int* __restrict__ centers,
    long long b, int len_q, int heads, int h, int grid_h, int grid_w,
    const Piece& pc, int i) {
  GroupQuery<R> gq;
  gq.active = i < pc.count;
  const int l = order[b * len_q + pc.first + min(i, pc.count - 1)];
  const long long bl = b * len_q + l;
  gq.row = bl * heads + h;
  const int cx = centers[2 * bl], cy = centers[2 * bl + 1];
#pragma unroll
  for (int d = 0; d < GroupQuery<R>::W; ++d) {
    const int x = cx - R + d, y = cy - R + d;
    gq.x_in[d] = (unsigned)x < (unsigned)grid_w;
    gq.y_in[d] = (unsigned)y < (unsigned)grid_h;
    gq.xs[d] = min(max(x, 0), grid_w - 1) - pc.wx0;
    gq.ys[d] = (min(max(y, 0), grid_h - 1) - pc.wy0) * pc.ww;
  }
  return gq;
}

}  // namespace
