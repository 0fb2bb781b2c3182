// FENNEL partition scores (paper Eq. 7) for a chunk of streamed vertices,
// written for Hopper (sm_90a).
//
//   out[r, p] = hist[r, p] - alpha*gamma * max(sizes[p], 0)^(gamma-1)
//
// where hist[r, p] counts row r's neighbour partition ids equal to p; ids
// outside [0, K) (the -1 of an unassigned neighbour) are not counted.
//
// Replaces: repro/kernels/partition_score/partition_score.py
//           ::fennel_scores_pallas (_score_kernel).
//
// Bound: bytes. For one engine chunk (C = 512 rows, K = 8, mean degree 16)
// the function reads (C+1)*8 B of indptr, nnz*4 B of indices, nnz*4 B of
// part_of gathers and writes C*K*4 B of scores: about 80 KB, about 25 ns at
// 3.35 TB/s. At that chunk size the launch itself is the bound.
//
// Design: the TPU kernel compared a dense [C, pow2 <= 1024] matrix of
// neighbour partition ids against every partition id, because a TPU has no
// scatter; the host built and padded that matrix and histogrammed hub rows
// wider than 1024 itself. Here the gather is fused: one block per row walks
// the row's CSR entries directly, reads part_of of each neighbour, and
// counts with shared-memory atomics into K int32 counters. The dense matrix
// never exists and a row of any degree is just a longer loop. The same
// kernel also takes a dense [B, D] matrix (the JAX signature) through a
// second row loader. Every row names its size row, so a sharded entry with
// one size row per shard needs only another loader.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// K int32 counters in shared memory must fit the 48 KB a block gets without
// opting in to more.
constexpr int kMaxK = 12288;

// Row r is the CSR row of vertex batch[r]; entry j reads part_of[indices[j]].
struct GatherRows {
  const int64_t* indptr;
  const int32_t* indices;
  const int32_t* part_of;
  const int64_t* batch;

  __device__ void range(int r, int64_t& begin, int64_t& end) const {
    const int64_t v = batch[r];
    begin = indptr[v];
    end = indptr[v + 1];
  }
  __device__ int part(int64_t j) const { return part_of[indices[j]]; }
  __device__ int size_row(int) const { return 0; }
};

// Row r is nbr_parts[r, 0:width] of a dense row-major matrix.
struct DenseRows {
  const int32_t* nbr_parts;
  int64_t width;

  __device__ void range(int r, int64_t& begin, int64_t& end) const {
    begin = static_cast<int64_t>(r) * width;
    end = begin + width;
  }
  __device__ int part(int64_t j) const { return nbr_parts[j]; }
  __device__ int size_row(int) const { return 0; }
};

template <class Rows>
__global__ void __launch_bounds__(kThreads)
score_kernel(Rows rows, const float* __restrict__ sizes, int k, float ag,
             float gm1, float* __restrict__ out) {
  extern __shared__ int counts[];
  const int r = blockIdx.x;
  for (int p = threadIdx.x; p < k; p += blockDim.x) counts[p] = 0;
  __syncthreads();

  int64_t begin, end;
  rows.range(r, begin, end);
  for (int64_t j = begin + threadIdx.x; j < end; j += blockDim.x) {
    const int p = rows.part(j);
    if (p >= 0 && p < k) atomicAdd(&counts[p], 1);
  }
  __syncthreads();

  const float* s = sizes + static_cast<int64_t>(rows.size_row(r)) * k;
  float* o = out + static_cast<int64_t>(r) * k;
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    const float size = fmaxf(s[p], 0.0f);
    // gamma = 1.5 (the paper's value): the correctly rounded sqrt, as
    // torch.pow takes for an exponent of 0.5
    const float pw = gm1 == 0.5f ? sqrtf(size) : powf(size, gm1);
    // the product and the difference round separately (no fused
    // multiply-add), as in the plain version: at counts in the thousands a
    // fused result differs from it in the last place
    o[p] = __fsub_rn(static_cast<float>(counts[p]), __fmul_rn(ag, pw));
  }
}

template <class Rows>
int launch(Rows rows, int num_rows, const float* sizes, int k, float ag,
           float gm1, float* out, cudaStream_t stream) {
  if (num_rows <= 0 || k <= 0 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(k) * sizeof(int);
  score_kernel<Rows><<<num_rows, kThreads, smem, stream>>>(rows, sizes, k, ag,
                                                           gm1, out);
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
  return launch(rows, num_rows, sizes, k, ag, gm1, out,
                static_cast<cudaStream_t>(stream));
}

int partition_score_dense(const int32_t* nbr_parts, int num_rows, int width,
                          const float* sizes, int k, float ag, float gm1,
                          float* out, void* stream) {
  DenseRows rows{nbr_parts, static_cast<int64_t>(width)};
  return launch(rows, num_rows, sizes, k, ag, gm1, out,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
