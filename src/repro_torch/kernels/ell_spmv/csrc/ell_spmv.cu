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
//                 k devices. Row q = p*v_max + r holds
//                 cols[p, row_ptr[p, r] : row_ptr[p, r+1]] and reads x[p, :].
//                 An empty row writes the identity: 0 for sum, x[p, last]
//                 (the engine's identity slot) for min, as _segment_reduce
//                 starts from zeros or the identity; min starts from that
//                 slot for every row, as _segment_reduce does.
//   EllRows     - the JAX signature: x[V+1], cols[R, D] dense (pads point
//                 at x[V]); row r reduces its D entries.
//
// Bound: bytes. One engine launch at 2^22 vertices, k=8 (about 65M CSR
// entries) must read the int32 cols of every entry, the x value each one
// names, and k*(v_max+1) int64 row pointers, and write k*v_max floats:
// about 0.6 GB, about 0.18 ms at 3.35 TB/s. The adds are nothing beside
// that (65M double adds at 34 TFLOP/s: 2 us).
//
// Design: the TPU kernel held the whole source vector in VMEM and reduced a
// dense [block_r, D] tile along its minor axis, because a TPU has no
// efficient scatter; that needs every row padded to the widest. At 2^22 the
// hub has degree 97,599 and v_max is about 524k rows, so the ELL matrix
// would hold about 5e10 entries. Here each warp walks one CSR row: lane l
// takes entries l, l+32, ...; then a shuffle tree joins the lanes. Rows of
// any degree are a longer loop, with no padding and no atomics. Sums
// accumulate in double and round once to float: the order of the adds is
// fixed by the row, so two runs give the same bits, and the result is
// within one float rounding of the plain version's (which also sums in
// double). A hub row costs one warp its whole degree; splitting long rows
// is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;

enum Reduce : int { kSum = 0, kMin = 1 };

// One row: `len` column indices starting at `cols`, each naming an entry of
// `x`.
struct Row {
  const int32_t* cols;
  int64_t len;
  const float* x;
};

struct SegmentRows {
  const float* x;
  const int64_t* row_ptr;
  const int32_t* cols;
  int64_t v_max;
  int64_t state_len;
  int64_t e_max;

  __device__ Row row(int64_t q) const {
    const int64_t p = q / v_max;
    const int64_t r = q - p * v_max;
    const int64_t* rp = row_ptr + p * (v_max + 1);
    const int64_t begin = rp[r];
    return Row{cols + p * e_max + begin, rp[r + 1] - begin, x + p * state_len};
  }
  __device__ float min_init(int64_t q) const {
    return x[(q / v_max) * state_len + state_len - 1];
  }
};

struct EllRows {
  const float* x;
  const int32_t* cols;
  int64_t width;

  __device__ Row row(int64_t q) const { return Row{cols + q * width, width, x}; }
  __device__ float min_init(int64_t) const { return __int_as_float(0x7f800000); }  // +inf
};

template <class Rows, int kReduce>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(Rows rows, int64_t num_rows, float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x / kWarp);
  // q is the same for the whole warp, so a warp leaves together and the
  // shuffles below always see all 32 lanes
  if (q >= num_rows) return;
  const Row row = rows.row(q);
  if constexpr (kReduce == kSum) {
    double acc = 0.0;
    for (int64_t j = lane; j < row.len; j += kWarp) {
      acc += static_cast<double>(__ldg(row.x + __ldg(row.cols + j)));
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      acc += __shfl_down_sync(kFullMask, acc, off);
    }
    if (lane == 0) out[q] = __double2float_rn(acc);
  } else {
    float acc = rows.min_init(q);
    for (int64_t j = lane; j < row.len; j += kWarp) {
      acc = fminf(acc, __ldg(row.x + __ldg(row.cols + j)));
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      acc = fminf(acc, __shfl_down_sync(kFullMask, acc, off));
    }
    if (lane == 0) out[q] = acc;
  }
}

template <class Rows>
int launch(Rows rows, int64_t num_rows, int reduce, float* out,
           cudaStream_t stream) {
  const int64_t blocks = (num_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (num_rows <= 0 || blocks > 0x7fffffff || (reduce != kSum && reduce != kMin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  if (reduce == kSum) {
    spmv_kernel<Rows, kSum><<<grid, kThreads, 0, stream>>>(rows, num_rows, out);
  } else {
    spmv_kernel<Rows, kMin><<<grid, kThreads, 0, stream>>>(rows, num_rows, out);
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
  if (k <= 0 || v_max <= 0 || state_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SegmentRows rows{x, row_ptr, cols, v_max, state_len, e_max};
  return launch(rows, k * v_max, reduce, out, static_cast<cudaStream_t>(stream));
}

// out f32[num_rows]; x f32[V + 1], cols int32[num_rows, width].
int ell_spmv_ell(const float* x, const int32_t* cols, int64_t num_rows,
                 int64_t width, int reduce, float* out, void* stream) {
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  EllRows rows{x, cols, width};
  return launch(rows, num_rows, reduce, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
