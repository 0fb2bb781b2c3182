// FENNEL partition scores (paper Eq. 7) for a chunk of streamed vertices,
// or for all S shard frontiers of a parallel superstep, written for Hopper
// (sm_90a).
//
//   out[r, p] = hist[r, p] - alpha*gamma * max(sizes[size_row(r), p], 0)^(gamma-1)
//
// where hist[r, p] counts row r's neighbour partition ids equal to p; ids
// outside [0, K) (the -1 of an unassigned neighbour) are not counted. The
// sequential entries have one size row; the sharded entries one per shard.
//
// Replaces: repro/kernels/partition_score/partition_score.py
//           ::fennel_scores_pallas (_score_kernel) with the GatherRows and
//           DenseRows loaders, and ::fennel_scores_sharded_pallas
//           (_score_kernel_sharded) with the ShardedGatherRows and
//           ShardedDenseRows loaders.
//
// Bound: bytes. For one engine chunk (C = 512 rows, K = 8, mean degree 16)
// the function reads (C+1)*8 B of indptr, nnz*4 B of indices, nnz*4 B of
// part_of gathers and writes C*K*4 B of scores: about 80 KB, about 25 ns at
// 3.35 TB/s. At that size a launch (about 1 us) and a chain of four
// dependent loads (batch, indptr, indices, part_of; about 0.5 us each on an
// H100) set the pace, not the bytes.
//
// Design: a merge path over each cluster's rows (SCORE_VARIANT
// "cluster_path"). The TPU kernel compared a dense [C, pow2 <= 1024] matrix
// of neighbour ids against every partition id (a TPU has no scatter) and
// left hub rows to the host. Split by rows (a block a row), a chunk takes as
// long as its longest row: the 2^22 R-MAT's 97,599-entry hub holds one
// block for 382 strided passes while the others idle. So the work is split
// by entries:
//   - The rows are cut into groups of at most kThreads rows (fewer where K is
//     large, so that a group's counters fit kCountInts), one cluster of
//     kClusterBlocks blocks a group.
//   - Every block of the cluster rebuilds the group's path itself: row r is
//     its deg(r) entries followed by one end item, and one block scan of
//     deg + 1 (two indptr reads a row, L2 hits after the first block) gives
//     each row's end position. The host never sees the degrees, so the grid
//     follows the shapes alone and the call needs no synchronisation. The
//     counters are zeroed and the penalties (alpha*gamma*size^(gamma-1), K
//     per size row) computed into shared memory while those loads are in
//     flight.
//   - The path is cut into kClusterBlocks shares, one a block: bound b sits at
//     path * b / kClusterBlocks, moved back to the start of its row unless
//     the row has more than kWholeRow items. So a short row is never split
//     (and a cluster with no long row takes no cluster barrier), while a
//     hub's entries spread over all the cluster's blocks.
//   - A thread walks a contiguous run of its block's share, kUnroll items at
//     a time: one search for its first row, then a row's end item moves it
//     on; the indices and part_of loads of the kUnroll items are in flight
//     together. It counts into int32 counters in shared memory with one
//     atomic an entry (one row of K for each row the share touches); ballot
//     and match_any counting were slower on an H100 at K = 8 and 64
//     (scripts/kernel_ablation_partition_score.py).
//   - A row belongs to the block holding its end item, which writes its K
//     scores. A block whose share ends inside a row adds its counts of that
//     row to the owner's counters through distributed shared memory, between
//     a split cluster barrier (arrived at once the counters are zero, waited
//     on after the walk) and a full one. Counts are integers, so every order
//     of the adds gives the same bits; nothing is written to global memory
//     but the scores, and no scratch outlives a launch.
// The epilogue is the first port's: __fsub_rn(count, __fmul_rn(ag, pw)) with
// sqrtf at gamma = 1.5. A row's size row is found once a row per block (the
// sharded gather loader's clamped search over shard_start).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;       // a block; also the most rows of a group
constexpr int kClusterBlocks = 16;  // blocks sharing one group's path
constexpr int kUnroll = 4;          // path items a thread has in flight
constexpr int kWholeRow = 4096;     // rows of at most this many items are never split
constexpr int kPenalties = 2048;    // penalties (size rows x K) kept in shared memory
constexpr int kCountInts = 16384;   // int32 counters a block may hold (64 KB)
constexpr int kMaxK = 12288;        // one row of counters fits kCountInts
constexpr int kMaxDevices = 64;     // devices whose kernel attributes are remembered
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;
// dynamic shared memory: ends and begins (int64), size rows (int32) of a
// group's rows, and the counters
constexpr int kMaxSmem = kThreads * 20 + kCountInts * 4;

// Row r is the CSR row of vertex batch[r]; entry j reads part_of[indices[j]].
struct GatherRows {
  const int64_t* indptr;
  const int32_t* indices;
  const int32_t* part_of;
  const int64_t* batch;

  __device__ void row(int r, int64_t& begin, int64_t& deg) const {
    const int64_t v = batch[r];
    begin = indptr[v];
    deg = indptr[v + 1] - begin;
  }
  __device__ int key(int64_t j) const { return __ldg(indices + j); }
  __device__ int part(int key) const { return __ldg(part_of + key); }
  __device__ int size_row(int) const { return 0; }
  __device__ int size_rows() const { return 1; }
};

// Row r is nbr_parts[r, 0:width] of a dense row-major matrix.
struct DenseRows {
  const int32_t* nbr_parts;
  int64_t width;

  __device__ void row(int r, int64_t& begin, int64_t& deg) const {
    begin = static_cast<int64_t>(r) * width;
    deg = width;
  }
  __device__ int key(int64_t j) const { return __ldg(nbr_parts + j); }
  __device__ int part(int key) const { return key; }
  __device__ int size_row(int) const { return 0; }
  __device__ int size_rows() const { return 1; }
};

// Row r is the CSR row of vertex batch[r]; the rows are the candidates of S
// shards, shard after shard, and shard s holds rows
// [shard_start[s], shard_start[s+1]). Its size row is that shard's: the
// largest s with shard_start[s] <= r, by binary search over the S+1 bounds
// (an empty shard repeats a bound and is skipped). The search is clamped to
// [0, S), so a malformed shard_start picks a wrong size row but never reads
// out of bounds.
struct ShardedGatherRows {
  const int64_t* indptr;
  const int32_t* indices;
  const int32_t* part_of;
  const int64_t* batch;
  const int64_t* shard_start;
  int num_shards;

  __device__ void row(int r, int64_t& begin, int64_t& deg) const {
    const int64_t v = batch[r];
    begin = indptr[v];
    deg = indptr[v + 1] - begin;
  }
  __device__ int key(int64_t j) const { return __ldg(indices + j); }
  __device__ int part(int key) const { return __ldg(part_of + key); }
  __device__ int size_row(int r) const {
    int lo = 0, hi = num_shards - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (shard_start[mid] <= r) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    return lo;
  }
  __device__ int size_rows() const { return num_shards; }
};

// Row r is nbr_parts[r / C, r % C, 0:width] of a dense row-major
// [S, C, width] matrix (the JAX signature); its size row is shard r / C.
struct ShardedDenseRows {
  const int32_t* nbr_parts;
  int64_t width;
  int rows_per_shard;
  int num_shards;

  __device__ void row(int r, int64_t& begin, int64_t& deg) const {
    begin = static_cast<int64_t>(r) * width;
    deg = width;
  }
  __device__ int key(int64_t j) const { return __ldg(nbr_parts + j); }
  __device__ int part(int key) const { return key; }
  __device__ int size_row(int r) const { return r / rows_per_shard; }
  __device__ int size_rows() const { return num_shards; }
};

// alpha*gamma * max(size, 0)^(gamma-1). gamma = 1.5 (the paper's value)
// takes the correctly rounded sqrt, as torch.pow does for an exponent of
// 0.5; the product rounds by itself (no fused multiply-add), as in the plain
// version: at counts in the thousands a fused result differs from it in the
// last place.
__device__ __forceinline__ float penalty(float size, float ag, float gm1) {
  size = fmaxf(size, 0.0f);
  return __fmul_rn(ag, gm1 == 0.5f ? sqrtf(size) : powf(size, gm1));
}

// The first of rows [lo, hi) whose end item lies at or after path position
// x (hi if none); ends rise with the row.
__device__ __forceinline__ int first_row_at(const int64_t* ends, int lo, int hi, int64_t x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <class Rows>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads)
score_path_kernel(Rows rows, int num_rows, int group_rows, const float* __restrict__ sizes,
                  int k, float ag, float gm1, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* ends = reinterpret_cast<int64_t*>(smem);  // path position of each row's end item
  int64_t* begin = ends + group_rows;                 // each row's first entry
  int* srow = reinterpret_cast<int*>(begin + group_rows);  // each row's size row
  int* counts = srow + group_rows;                    // [rows touched here, k]
  __shared__ int64_t warp_total[kWarps];
  __shared__ int64_t bound[kClusterBlocks + 1];  // the blocks' shares of the path
  __shared__ int bound_row[kClusterBlocks + 1];  // the row holding each bound's item
  __shared__ int split;                          // a bound lies inside a row
  __shared__ float pen[kPenalties];              // every size row's penalties, where they fit

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g0 = (blockIdx.x / kClusterBlocks) * group_rows;
  const int n = min(group_rows, num_rows - g0);

  // the group's rows (their loads in flight while the counters are zeroed)
  // and its path: an inclusive scan of deg + 1 over its rows
  if (tid == 0) {
    bound_row[kClusterBlocks] = n;
    split = 0;
  }
  int64_t x = 0, deg = 0;
  if (tid < n) {
    int64_t b;
    rows.row(g0 + tid, b, deg);
    srow[tid] = rows.size_row(g0 + tid);
    begin[tid] = b;
    x = deg + 1;
  }
  for (int i = tid; i < n * k; i += kThreads) counts[i] = 0;
  const int num_pen = rows.size_rows() * k;
  const bool staged = num_pen <= kPenalties;
  if (staged) {
    for (int i = tid; i < num_pen; i += kThreads) pen[i] = penalty(sizes[i], ag, gm1);
  }
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int64_t y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == kWarp - 1) warp_total[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t t = lane < kWarps ? warp_total[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int64_t y = __shfl_up_sync(kFullMask, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kWarps) warp_total[lane] = t;
  }
  __syncthreads();
  if (warp > 0) x += warp_total[warp - 1];
  const int64_t path = warp_total[kWarps - 1];
  if (tid == 0) bound[kClusterBlocks] = path;

  // the shares: block b takes items [bound[b], bound[b+1]) of the path,
  // path * b / kClusterBlocks moved back to the start of its row unless that
  // row has more than kWholeRow items, so only such rows are split. Row tid
  // ends at item x - 1 and sets the bounds that fall in it (a float
  // estimate of the first, then exact integer steps).
  if (tid < n) {
    const int64_t e = x - 1, s0 = e - deg;
    ends[tid] = e;
    const bool whole = e - s0 < kWholeRow;
    int b = max(0, static_cast<int>(__fdividef(static_cast<float>(s0) * kClusterBlocks,
                                               static_cast<float>(path))) - 1);
    for (; b < kClusterBlocks; ++b) {
      const int64_t at = path * b / kClusterBlocks;
      if (at > e) break;
      if (at >= s0) {
        bound[b] = whole ? s0 : at;
        bound_row[b] = tid;
        if (!whole && at > s0) split = 1;
      }
    }
  }
  __syncthreads();
  const int64_t d0 = bound[rank], d1 = bound[rank + 1];
  // rows [r_lo, r_lo + touched) meet the share and rows [r_lo, r_end) end in
  // it; row r_end holds item d1 and meets the share unless d1 starts it
  const int r_lo = bound_row[rank];
  const int r_end = bound_row[rank + 1];
  const bool open = d1 < path && d1 != (r_end == 0 ? 0 : ends[r_end - 1] + 1);
  const int touched = d0 < d1 ? r_end - r_lo + (open ? 1 : 0) : 0;
  const int owned = d0 < d1 ? r_end - r_lo : 0;
  const bool cluster_split = split != 0;
  if (cluster_split) cluster_arrive();  // this block's counters are zero; others add to them after their wait

  // thread tid walks items [item, stop) of the share, kUnroll at a time: one
  // search for its first row, then a row's end item moves it to the next row
  const int64_t per = (d1 - d0 + kThreads - 1) / kThreads;
  int64_t item = d0 + tid * per;
  const int64_t stop = min(item + per, d1);
  int r = item < stop ? first_row_at(ends, r_lo, r_lo + touched, item) : r_lo;
  int64_t cur_end = 0, j = 0;
  if (item < stop) {
    cur_end = ends[r];
    j = begin[r] + (item - (r == 0 ? 0 : ends[r - 1] + 1));
  }
  for (int64_t q = 0; q < per; q += kUnroll) {  // the same trip count in every thread
    int row[kUnroll];
    int64_t at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      row[u] = -1;
      at[u] = 0;
      if (item < stop) {
        if (item < cur_end) {  // an entry of row r
          row[u] = r - r_lo;
          at[u] = j++;
        } else if (++r < n) {  // row r's end item: on to the next row
          cur_end = ends[r];
          j = begin[r];
        }
        ++item;
      }
    }
    int key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) key[u] = row[u] >= 0 ? rows.key(at[u]) : 0;
    int part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) part[u] = row[u] >= 0 ? rows.part(key[u]) : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (part[u] >= 0 && part[u] < k) atomicAdd(&counts[row[u] * k + part[u]], 1);
    }
  }
  __syncthreads();  // this block's counts are complete

  if (cluster_split) {
    cluster_wait();  // every block's counters are zero
    // the row this block leaves open ends in a later block, whose first row
    // it is: add this block's counts of it to that block's (distributed
    // shared memory)
    if (open && d0 < d1) {
      const int lr = touched - 1;
      const int64_t e = ends[r_lo + lr];
      int owner = rank + 1;
      while (bound[owner + 1] <= e) ++owner;
      int* remote = cluster.map_shared_rank(counts, owner);
      for (int p = tid; p < k; p += kThreads) {
        const int c = counts[lr * k + p];
        if (c != 0) atomicAdd(remote + p, c);
      }
    }
    cluster.sync();  // every block's counts of the rows it owns are final
  }

  // the scores of the rows whose end item lies in this share: thread tid
  // writes partition tid % k of rows tid / k, tid / k + step, ... (partitions
  // tid, tid + kThreads, ... of every row where k > kThreads)
  float* o = out + static_cast<int64_t>(g0 + r_lo) * k;
  const int p0 = k <= kThreads ? tid % k : tid;
  const int lr0 = k <= kThreads ? tid / k : 0;
  const int step = k <= kThreads ? kThreads / k : 1;
  for (int p = lr0 < step ? p0 : k; p < k; p += kThreads) {
    for (int lr = lr0; lr < owned; lr += step) {
      const int64_t at = static_cast<int64_t>(srow[r_lo + lr]) * k + p;
      // the difference rounds by itself (no fused multiply-add), as in the
      // plain version
      o[static_cast<int64_t>(lr) * k + p] = __fsub_rn(static_cast<float>(counts[lr * k + p]),
                                                      staged ? pen[at] : penalty(sizes[at], ag, gm1));
    }
    if (k <= kThreads) break;
  }
}

// Rows of a cluster's group: one a thread in the scan, at most kCountInts / k
// (their counters must fit), at most the call's rows; rows of a fixed width
// (width >= 0, the dense loaders) no more than give each thread of the
// cluster kUnroll items.
int group_rows(int num_rows, int k, int64_t width) {
  int64_t g = kThreads < kCountInts / k ? kThreads : kCountInts / k;
  if (width >= 0) {
    const int64_t fill = static_cast<int64_t>(kClusterBlocks) * kThreads * kUnroll / (width + 1);
    g = fill < 1 ? 1 : (fill < g ? fill : g);
  }
  return static_cast<int>(g < num_rows ? g : num_rows);
}

template <class Rows>
int launch(Rows rows, int num_rows, int64_t width, const float* sizes, int k, float ag,
           float gm1, float* out, cudaStream_t stream) {
  if (num_rows <= 0 || k <= 0 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = group_rows(num_rows, k, width);
  const int64_t blocks = static_cast<int64_t>((num_rows + group - 1) / group) * kClusterBlocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = score_path_kernel<Rows>;
  // the kernel's attributes, set once per device (a host call each costs
  // microseconds, and the engines launch once per chunk)
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device >= kMaxDevices || !configured[device])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) {
      // clusters of more than 8 blocks (Hopper takes up to 16)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err == cudaSuccess && device < kMaxDevices) configured[device] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(group) * (20 + 4 * static_cast<size_t>(k));
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(rows, num_rows, group, sizes,
                                                                   k, ag, gm1, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out f32[num_rows, k]; ag = alpha*gamma, gm1 = gamma-1. Returns the CUDA
// error code of the launch (0 on success).
int partition_score_gather(const int64_t* indptr, const int32_t* indices,
                           const int32_t* part_of, const int64_t* batch,
                           int num_rows, const float* sizes, int k, float ag,
                           float gm1, float* out, void* stream) {
  GatherRows rows{indptr, indices, part_of, batch};
  return launch(rows, num_rows, -1, sizes, k, ag, gm1, out,
                static_cast<cudaStream_t>(stream));
}

int partition_score_dense(const int32_t* nbr_parts, int num_rows, int width,
                          const float* sizes, int k, float ag, float gm1,
                          float* out, void* stream) {
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  DenseRows rows{nbr_parts, static_cast<int64_t>(width)};
  return launch(rows, num_rows, width, sizes, k, ag, gm1, out,
                static_cast<cudaStream_t>(stream));
}

// out f32[num_rows, k] for the candidates of num_shards shards; sizes
// f32[num_shards, k], shard_start int64[num_shards + 1].
int partition_score_sharded_gather(const int64_t* indptr,
                                   const int32_t* indices,
                                   const int32_t* part_of,
                                   const int64_t* batch,
                                   const int64_t* shard_start, int num_shards,
                                   int num_rows, const float* sizes, int k,
                                   float ag, float gm1, float* out,
                                   void* stream) {
  if (num_shards <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ShardedGatherRows rows{indptr, indices, part_of, batch, shard_start,
                         num_shards};
  return launch(rows, num_rows, -1, sizes, k, ag, gm1, out,
                static_cast<cudaStream_t>(stream));
}

// out f32[num_shards, rows_per_shard, k]; nbr_parts int32[num_shards,
// rows_per_shard, width], sizes f32[num_shards, k].
int partition_score_sharded_dense(const int32_t* nbr_parts, int num_shards,
                                  int rows_per_shard, int width,
                                  const float* sizes, int k, float ag,
                                  float gm1, float* out, void* stream) {
  if (num_shards <= 0 || rows_per_shard <= 0 || width < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ShardedDenseRows rows{nbr_parts, static_cast<int64_t>(width),
                        rows_per_shard, num_shards};
  return launch(rows, num_shards * rows_per_shard, width, sizes, k, ag, gm1, out,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
