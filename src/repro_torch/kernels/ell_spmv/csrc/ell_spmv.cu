// Sparse gather/reduce for the analytics engine, written for Hopper (sm_90a):
//
//   out[r] = reduce_{j in row r} x[col_j],   reduce in {sum, min}, float32
//
// Replaces: repro/kernels/ell_spmv/ell_spmv.py::ell_spmv_pallas
//           (_spmv_kernel), the inner loop of repro/analytics/engine.py's
//           _local_step (gather full[cols], then _segment_reduce over rows).
//
// Two row loaders feed one device routine:
//   SegmentRows - the engine's call: one launch covers the local rows of all
//                 k devices. Device p's row r holds
//                 cols[p, row_ptr[p, r] : row_ptr[p, r+1]] and reads x[p, :].
//                 An empty row writes the identity: 0 for sum, x[p, last]
//                 (the engine's identity slot) for min, as _segment_reduce
//                 starts from zeros or the identity; min starts from that
//                 slot for every row, as _segment_reduce does.
//   EllRows     - the JAX signature: x[V+1], cols[R, D] dense (pads point
//                 at x[V]); row r reduces its D entries.
//
// Bound: bytes. One engine launch at 2^22 vertices, k=8 (65.2M CSR entries)
// must read the int32 cols of every entry (261 MB), each distinct x value
// the entries name once, k*(v_max+1) int64 row pointers (34 MB) and write
// k*v_max floats (17 MB): about 0.37 GB, 0.11 ms at 3.35 TB/s (chip_smoke.py
// phase 9 counts these bytes from the run's own layout). The adds are
// nothing beside that (65M double adds at 34 TFLOP/s: 2 us). The gathers are
// random over k*state_len floats, so each costs a 32-byte L2 sector: L2, not
// device memory, sets the floor.
//
// Design: merge path. The TPU kernel held the whole source vector in VMEM
// and reduced a dense [block_r, D] tile along its minor axis, which needs
// every row padded to the widest (the 2^22 graph's hub has degree 97,599).
// Here each device's rows and entries are merged into one path of
// rows + nnz items (a row's end item follows its last entry), and the path
// is cut into tiles of kTile items, one block each: every block does the
// same work whatever the degrees, and empty rows are items like any other.
//   - A block finds where its tile starts and ends on the path with two
//     8-way warp searches over row_ptr (six or seven rounds of loads).
//   - A row belongs to the tile that holds its end item. The tile stages its
//     rows' ends and the x values of its entries in shared memory (cols read
//     coalesced, the gathers all in flight at once). Entries of the row still
//     open at the tile's end are left to the tile that closes it, and the
//     closing tile sums the entries of its first row that lie before the
//     tile (a hub's whole degree, strided over the block), so every entry is
//     read once.
//   - Each thread walks kItemsPerThread items of the tile's path from shared
//     memory (a binary search in shared memory finds its start). A row that
//     starts and ends in one thread is written by it; the first row a thread
//     closes may have begun in earlier threads. Their carries (the row open
//     at each thread's end and its partial) are joined by a segmented scan
//     over the lanes' shuffles and the warps' tails in shared memory, and the
//     head row's earlier partials by one warp's tree: no chain longer than a
//     few dozen steps, whatever the degrees.
// Sums accumulate in double and round once to float: the order of the adds
// follows the tiles and the threads, fixed by the shapes and row_ptr alone,
// so two launches give the same bits; no atomics. Offsets within a device
// are 32-bit: the wrapper checks v_max + e_max + kTile < 2^31.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 8;  // path items (entries and row ends) a thread walks
constexpr int kTile = kThreads * kItemsPerThread;
constexpr int kWarp = 32;
constexpr int kProbes = 8;  // lanes probing row_ptr in each round of a tile's search
constexpr unsigned kFullMask = 0xffffffffu;

enum Reduce : int { kSum = 0, kMin = 1 };

// The end of row i, as an entry offset from the device's first entry.
struct SegmentEnds {
  const int64_t* rp;  // row_ptr[p, :]
  int64_t base;       // row_ptr[p, 0]
  __device__ int operator()(int i) const { return static_cast<int>(__ldg(rp + i + 1) - base); }
};

struct EllEnds {
  int width;
  __device__ int operator()(int i) const { return (i + 1) * width; }
};

// One device's rows: `rows` rows over `nnz` entries starting at `cols`,
// each naming an entry of `x`; min starts every row from `min_init`.
template <class Ends>
struct Device {
  Ends ends;
  int rows;
  int nnz;
  const int32_t* cols;
  const float* x;
  float min_init;
};

struct SegmentRows {
  const float* x;
  const int64_t* row_ptr;
  const int32_t* cols;
  int v_max;
  int64_t state_len;
  int64_t e_max;

  __device__ Device<SegmentEnds> device(int p) const {
    const int64_t* rp = row_ptr + static_cast<int64_t>(p) * (v_max + 1);
    const int64_t base = __ldg(rp);
    const float* xp = x + p * state_len;
    return {SegmentEnds{rp, base}, v_max, static_cast<int>(__ldg(rp + v_max) - base),
            cols + p * e_max + base, xp, __ldg(xp + state_len - 1)};
  }
};

struct EllRows {
  const float* x;
  const int32_t* cols;
  int num_rows;
  int width;

  __device__ Device<EllEnds> device(int) const {
    return {EllEnds{width}, num_rows, num_rows * width, cols, x,
            __int_as_float(0x7f800000)};  // +inf
  }
};

template <int kReduce>
struct Op;
template <>
struct Op<kSum> {
  using Acc = double;
  __device__ static Acc init(float) { return 0.0; }
  __device__ static Acc add(Acc a, float v) { return a + static_cast<double>(v); }
  __device__ static Acc join(Acc a, Acc b) { return a + b; }
  __device__ static float finish(Acc a) { return __double2float_rn(a); }
};
template <>
struct Op<kMin> {
  using Acc = float;
  __device__ static Acc init(float min_init) { return min_init; }
  __device__ static Acc add(Acc a, float v) { return fminf(a, v); }
  __device__ static Acc join(Acc a, Acc b) { return fminf(a, b); }
  __device__ static float finish(Acc a) { return a; }
};

// The number of rows whose end item lies before path position d, i.e. rows
// i with i + ends(i) < d (a rising function of i), by one warp: each round
// kProbes lanes probe evenly spaced rows and the range shrinks
// (kProbes + 1)-fold. Each probe is a random read of row_ptr, one L2 sector
// like a gather, so few lanes probe: more rounds, fewer requests.
template <class Ends>
__device__ int path_rows(const Device<Ends>& dv, int d, int lane) {
  int lo = max(0, d - dv.nnz), hi = min(d, dv.rows);
  while (lo < hi) {  // lo and hi are the same in every lane
    const int q = lo + static_cast<int>(static_cast<int64_t>(lane + 1) * (hi - lo) / (kProbes + 1));
    const unsigned before = __ballot_sync(kFullMask, lane < kProbes && q + dv.ends(q) < d);
    const int c = __popc(before);  // probes rise with the lane: lanes 0..c-1 are before d
    const int q_before = __shfl_sync(kFullMask, q, c > 0 ? c - 1 : 0);
    const int q_after = __shfl_sync(kFullMask, q, c < kProbes ? c : kProbes - 1);
    if (c > 0) lo = q_before + 1;
    if (c < kProbes) hi = q_after;
  }
  return lo;
}

template <class Rows, int kReduce>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(Rows rows, int tiles_per_device, float* __restrict__ out) {
  using O = Op<kReduce>;
  using Acc = typename O::Acc;
  constexpr int kWarps = kThreads / kWarp;
  __shared__ float vals[kTile];  // x of the tile's entries
  __shared__ int ends[kTile];    // the tile's row ends, relative to its first entry
  __shared__ Acc pre[kThreads];  // per-thread partials of the head row's earlier entries
  __shared__ Acc warp_tail[kWarps];
  __shared__ int warp_key[kWarps];
  __shared__ Acc head_total;
  __shared__ int coord[2];

  const int p = blockIdx.x / tiles_per_device;
  const int d0 = (blockIdx.x - p * tiles_per_device) * kTile;
  const auto dv = rows.device(p);
  const int path = dv.rows + dv.nnz;
  if (d0 >= path) return;  // past this device's path
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  if (warp < 2) {
    const int r = path_rows(dv, warp == 0 ? d0 : min(d0 + kTile, path), lane);
    if (lane == 0) coord[warp] = r;
  }
  __syncthreads();
  const int i0 = coord[0], i1 = coord[1];
  if (i0 == i1) return;  // no row ends here: the tile lies inside a row a later tile closes
  const int j0 = d0 - i0;                                // the tile's first entry
  const int head = i0 == 0 ? 0 : dv.ends(i0 - 1);        // first entry of row i0
  const int nr = i1 - i0;                                // rows closed here
  const int ne = dv.ends(i1 - 1) - j0;                   // their entries in the tile
  const int pre_n = j0 - head;                           // row i0's entries before it
  const Acc init = O::init(dv.min_init);
  float* row_out = out + static_cast<int64_t>(p) * dv.rows + i0;

  // stage: the rows' ends, the entries' x values, and the head row's
  // earlier entries strided over the threads (all loads issued together)
  for (int i = tid; i < nr; i += kThreads) ends[i] = dv.ends(i0 + i) - j0;
  int col[kItemsPerThread];
#pragma unroll
  for (int u = 0; u < kItemsPerThread; ++u) {
    const int e = tid + u * kThreads;
    col[u] = e < ne ? __ldg(dv.cols + j0 + e) : 0;
  }
  const int pre_col = tid < pre_n ? __ldg(dv.cols + head + tid) : 0;
#pragma unroll
  for (int u = 0; u < kItemsPerThread; ++u) {
    const int e = tid + u * kThreads;
    if (e < ne) vals[e] = __ldg(dv.x + col[u]);
  }
  Acc part = tid < pre_n ? O::add(init, __ldg(dv.x + pre_col)) : init;
  for (int e = tid + kThreads; e < pre_n; e += kThreads) {
    part = O::add(part, __ldg(dv.x + __ldg(dv.cols + head + e)));
  }
  pre[tid] = part;
  __syncthreads();

  if (warp == 0 && pre_n > 0) {
    // the head row's earlier entries: lane l joins partials l, l+32, ...,
    // then a tree down to lane 0
    Acc v = pre[lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = O::join(v, pre[lane + w * kWarp]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) v = O::join(v, __shfl_down_sync(kFullMask, v, off));
    if (lane == 0) head_total = v;
  }

  // this thread's items [t0, t1) of the tile's path of nr + ne items
  const int t0 = min(tid * kItemsPerThread, nr + ne);
  const int t1 = min(t0 + kItemsPerThread, nr + ne);
  int lo = max(0, t0 - ne), hi = min(t0, nr);
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (mid + ends[mid] < t0) lo = mid + 1; else hi = mid;
  }
  int r = lo, j = t0 - lo;
  Acc acc = init, first_val = init;
  int first = -1;  // the first row this thread closes: earlier threads may hold part of it
#pragma unroll
  for (int u = 0; u < kItemsPerThread; ++u) {
    if (t0 + u < t1) {
      if (j < ends[r]) {
        acc = O::add(acc, vals[j]);
        ++j;
      } else {
        if (first < 0) {
          first = r;
          first_val = acc;
        } else {
          row_out[r] = O::finish(acc);
        }
        acc = init;
        ++r;
      }
    }
  }

  // the carries (row still open at a thread's end, its partial): a
  // segmented inclusive scan over the lanes (the rows rise with the lane, so
  // equal rows are neighbours), then the warps' tails in shared memory
  int key = t0 < t1 ? r : nr;  // nr: no row
  Acc val = acc;
#pragma unroll
  for (int off = 1; off < kWarp; off *= 2) {
    const int k_up = __shfl_up_sync(kFullMask, key, off);
    const Acc v_up = __shfl_up_sync(kFullMask, val, off);
    if (lane >= off && k_up == key) val = O::join(v_up, val);
  }
  const int key_prev = __shfl_up_sync(kFullMask, key, 1);
  const Acc val_prev = __shfl_up_sync(kFullMask, val, 1);
  const int key_lane0 = __shfl_sync(kFullMask, key, 0);
  if (lane == kWarp - 1) {
    warp_key[warp] = key;
    warp_tail[warp] = val;
  }
  __syncthreads();

  if (first >= 0) {
    Acc total = first == 0 && pre_n > 0 ? head_total : init;
    if (lane == 0 || key_lane0 == first) {  // the row may reach back into earlier warps
      for (int w = 0; w < warp; ++w) {
        if (warp_key[w] == first) total = O::join(total, warp_tail[w]);
      }
    }
    if (lane > 0 && key_prev == first) total = O::join(total, val_prev);
    row_out[first] = O::finish(O::join(total, first_val));
  }
}

template <class Rows>
int launch(Rows rows, int64_t devices, int64_t path_len, int reduce, float* out,
           cudaStream_t stream) {
  const int64_t tiles = (path_len + kTile - 1) / kTile;
  if (devices <= 0 || path_len <= 0 || path_len + kTile > 0x7fffffff ||
      devices * tiles > 0x7fffffff || (reduce != kSum && reduce != kMin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(devices * tiles));
  if (reduce == kSum) {
    spmv_kernel<Rows, kSum><<<grid, kThreads, 0, stream>>>(rows, static_cast<int>(tiles), out);
  } else {
    spmv_kernel<Rows, kMin><<<grid, kThreads, 0, stream>>>(rows, static_cast<int>(tiles), out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out f32[k, v_max]; x f32[k, state_len], row_ptr int64[k, v_max + 1],
// cols int32[k, e_max]; reduce 0 = sum, 1 = min. Returns the CUDA error
// code of the launch (0 on success).
int ell_spmv_segments(const float* x, const int64_t* row_ptr,
                      const int32_t* cols, int64_t k, int64_t v_max,
                      int64_t state_len, int64_t e_max, int reduce, float* out,
                      void* stream) {
  if (k <= 0 || v_max <= 0 || state_len <= 0 || e_max < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SegmentRows rows{x, row_ptr, cols, static_cast<int>(v_max), state_len, e_max};
  // each device's path is at most v_max + e_max items; a tile past a
  // device's own path returns at once
  return launch(rows, k, v_max + e_max, reduce, out, static_cast<cudaStream_t>(stream));
}

// out f32[num_rows]; x f32[V + 1], cols int32[num_rows, width].
int ell_spmv_ell(const float* x, const int32_t* cols, int64_t num_rows,
                 int64_t width, int reduce, float* out, void* stream) {
  if (width < 0 || num_rows <= 0 || num_rows * (width + 1) + kTile > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EllRows rows{x, cols, static_cast<int>(num_rows), static_cast<int>(width)};
  return launch(rows, 1, num_rows * (width + 1), reduce, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
