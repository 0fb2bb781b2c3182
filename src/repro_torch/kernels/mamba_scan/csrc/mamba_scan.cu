// Fused Mamba-1 selective scan for Hopper (sm_90a):
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t     h: [D, N], h_0 = 0
//   y_t = h_t . C_t + D_skip * x_t                          y: [D]
//
// per batch row, with x, dt [B, T, D], A [D, N] (float32), B, C [B, T, N],
// D_skip [D] (float32); returns y [B, T, D] in x's type and the final state
// h_T [B, D, N] in float32.
//
// Replaces: repro/kernels/mamba_scan/mamba_scan.py::selective_scan_pallas
//           (_scan_kernel), and with it the model's jnp mirror of it,
//           _ssm_scan_chunked plus the D skip (models/mamba.py:121-122).
//
// Bound. One falcon-mamba-7b layer at prefill (B=1, T=8192, D=8192, N=16,
// float32): the function must read x and dt and write y (3 * T * D * 4 =
// 805 MB) and do 7 float32 operations per (t, d, n) (dt*A, the exp counted
// as one, *h, *B, +, *C and the sum over N; 7.5 GFLOP): 0.24 ms of bytes at
// 3.35 TB/s and 0.11 ms of operations at 67 TFLOP/s, but its 1.07e9 exps
// take 0.257 ms on the special-function units (16 a clock an SM), so the
// exps bound it.
//
// Design. The state never leaves the registers: [T, D, N] never reaches
// device memory, which is the fusion the Pallas kernel made. The TPU kernel
// kept a [block_d, N] state in VMEM and walked time with a fori_loop; here
// one thread owns one (channel, state) pair, so N = 16 neighbouring lanes
// hold one channel and a shuffle tree over them takes h_t . C_t. A block of
// 256 threads covers 256 / N channels of one batch row; the (batch row,
// channel block) pairs are flattened onto grid x, so any batch fits. One
// thread per channel, with N states in its registers, would give only B * D threads
// (8,192 at B=1, D=8192: a sixteenth of what the card keeps in flight); one
// per (channel, state) gives B * D * N = 131,072 and keeps the recurrence's
// dependent chain per thread to one FMA a step. Time is streamed in chunks
// of 64 steps: the block stages x, dt (64 x channels) and B, C (64 x N) of
// a chunk in shared memory with coalesced loads, walks the chunk, collects
// y in shared memory and writes it back coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // time steps staged per pass
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <class T, int N>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ a,
            const T* __restrict__ b, const T* __restrict__ c, const float* __restrict__ d_skip,
            T* __restrict__ y, float* __restrict__ h_last, int64_t t_len, int64_t d) {
  constexpr int CH = kThreads / N;  // channels per block
  __shared__ float xs[kChunk][CH];
  __shared__ float dts[kChunk][CH];
  __shared__ float ys[kChunk][CH];
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];

  const int tid = threadIdx.x;
  const int n = tid % N;   // this thread's state
  const int ch = tid / N;  // its channel within the block
  // grid x is (batch row, channel block) flattened: up to 2^31 - 1 blocks
  const int64_t blocks_per_row = (d + CH - 1) / CH;
  const int64_t bi = blockIdx.x / blocks_per_row;
  const int64_t d0 = (blockIdx.x % blocks_per_row) * CH;
  const int64_t chan = d0 + ch;
  const bool valid = chan < d;
  const float an = valid ? a[chan * N + n] : 0.0f;
  const float skip = valid ? d_skip[chan] : 0.0f;
  const int64_t row_base = bi * t_len;  // first [t, :] row of this batch entry
  float h = 0.0f;

  for (int64_t t0 = 0; t0 < t_len; t0 += kChunk) {
    const int steps = static_cast<int>(t_len - t0 < kChunk ? t_len - t0 : kChunk);
    for (int idx = tid; idx < kChunk * CH; idx += kThreads) {
      const int tt = idx / CH, cc = idx % CH;
      float xv = 0.0f, dv = 0.0f;
      if (tt < steps && d0 + cc < d) {
        const int64_t off = (row_base + t0 + tt) * d + d0 + cc;
        xv = to_float(x[off]);
        dv = to_float(dt[off]);
      }
      xs[tt][cc] = xv;
      dts[tt][cc] = dv;
    }
    for (int idx = tid; idx < kChunk * N; idx += kThreads) {
      const int tt = idx / N, nn = idx % N;
      float bv = 0.0f, cv = 0.0f;
      if (tt < steps) {
        const int64_t off = (row_base + t0 + tt) * N + nn;
        bv = to_float(b[off]);
        cv = to_float(c[off]);
      }
      bs[tt][nn] = bv;
      cs[tt][nn] = cv;
    }
    __syncthreads();

    for (int tt = 0; tt < steps; ++tt) {
      const float xv = xs[tt][ch];
      const float dv = dts[tt][ch];
      h = expf(dv * an) * h + (dv * xv) * bs[tt][n];
      float part = h * cs[tt][n];
#pragma unroll
      for (int off = N / 2; off > 0; off /= 2) part += __shfl_xor_sync(kFullMask, part, off);
      if (n == 0) ys[tt][ch] = part + skip * xv;
    }
    __syncthreads();

    for (int idx = tid; idx < kChunk * CH; idx += kThreads) {
      const int tt = idx / CH, cc = idx % CH;
      if (tt < steps && d0 + cc < d) {
        y[(row_base + t0 + tt) * d + d0 + cc] = from_float<T>(ys[tt][cc]);
      }
    }
    // the next chunk's loads touch xs/dts/bs/cs only; ys is rewritten after
    // the next __syncthreads, when every thread has stored this chunk
  }
  if (valid) h_last[(bi * d + chan) * N + n] = h;
}

template <class T, int N>
int launch(const void* x, const void* dt, const float* a, const void* b, const void* c,
           const float* d_skip, void* y, float* h_last, int64_t batch, int64_t t_len,
           int64_t d, cudaStream_t stream) {
  constexpr int CH = kThreads / N;
  const int64_t blocks = batch * ((d + CH - 1) / CH);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a, static_cast<const T*>(b),
      static_cast<const T*>(c), d_skip, static_cast<T*>(y), h_last, t_len, d);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_n(int n, const void* x, const void* dt, const float* a, const void* b, const void* c,
             const float* d_skip, void* y, float* h_last, int64_t batch, int64_t t_len,
             int64_t d, cudaStream_t stream) {
  switch (n) {
    case 8:
      return launch<T, 8>(x, dt, a, b, c, d_skip, y, h_last, batch, t_len, d, stream);
    case 16:
      return launch<T, 16>(x, dt, a, b, c, d_skip, y, h_last, batch, t_len, d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// y[B, T, D] (x's type) and h_last[B, D, N] (float32) from x, dt [B, T, D],
// a [D, N] f32, b, c [B, T, N], d_skip [D] f32, all contiguous. dtype 0 =
// float32, 1 = bfloat16 (x, dt, b, c, y); n in {8, 16}. Returns the CUDA
// error code of the launch.
int selective_scan_fwd(int dtype, int n, const void* x, const void* dt, const float* a,
                       const void* b, const void* c, const float* d_skip, void* y,
                       float* h_last, int64_t batch, int64_t t_len, int64_t d, void* stream) {
  if (batch <= 0 || t_len < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_n<float>(n, x, dt, a, b, c, d_skip, y, h_last, batch, t_len, d, s);
  }
  if (dtype == 1) {
    return launch_n<__nv_bfloat16>(n, x, dt, a, b, c, d_skip, y, h_last, batch, t_len, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
