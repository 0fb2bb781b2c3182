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
// a block takes 32 channels of one batch row (one lane each) and N / kStates
// warps, warp g holding states [g*kStates, (g+1)*kStates) of its lane's
// channel in registers. So each step costs a thread kStates exps and about
// 5 * kStates float operations, with no shuffles: B_t and C_t are the same
// for a whole warp (broadcast reads of shared memory), and h . C is summed
// over the thread's states in registers and over the warps once a chunk in
// shared memory. A is scaled by log2(e) once per thread, so each
// exponential is one ex2.approx.ftz.f32 on the special-function units
// (relative error within 2 ulp). The (batch row, channel block) pairs are
// flattened onto grid x, so any batch fits. At B=1, D=8192, N=16 and four
// states a thread that is 256 blocks of 4 warps, about 7.8 warps an SM.
// Time is streamed in chunks of kChunk steps through two shared-memory
// buffers: the next chunk's x, dt, B and C are copied with 16-byte cp.async
// while the block walks the current one (element loads where the rows are
// not 16-byte aligned), and the previous chunk's y is summed from the warps'
// partials (two buffers of them too; warp 0's partial carries the D skip).
// The block synchronises once a chunk anyway, to hand the partials of y
// between warps, so one cp.async commit group per chunk and that barrier
// take the place of mbarriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStates = 4;   // states of one channel a thread holds
constexpr int kChunk = 64;   // time steps staged per buffer
constexpr int kAhead = 16;   // B values (and C) a batch of the walk loads: kAhead / kStates steps
constexpr int kChannels = 32;  // channels a block takes: one per lane
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S consecutive values from shared memory as floats, in 16-, 8- or 4-byte
// loads (the caller's offsets keep them aligned)
template <int S>
__device__ __forceinline__ void load_states(const float* p, float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {
      const float2 q = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = q.x, v[2 * i + 1] = q.y;
    }
  }
}

template <int S>
__device__ __forceinline__ void load_states(const __nv_bfloat16* p, float (&v)[S]) {
#pragma unroll
  for (int i = 0; i < S / 2; ++i) {
    const float2 q = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
    v[2 * i] = q.x, v[2 * i + 1] = q.y;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <class T, int N, int S>
struct Scan {
  static constexpr int kGroups = N / S;  // warps a block: one per group of states
  static constexpr int kThreads = 32 * kGroups;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  static constexpr int kSteps = kAhead / S;  // steps a batch of the walk
  // shared memory: two buffers each of x and dt [kChunk][kChannels] and of
  // B and C [kChunk][N] (in T), and of the warps' partial sums of y
  // [kChunk][kGroups][kChannels] (float)
  static constexpr int kXElems = kChunk * kChannels;
  static constexpr int kBElems = kChunk * N;
  static constexpr int kYElems = kChunk * kGroups * kChannels;
  static constexpr size_t kSmem =
      (4 * kXElems + 4 * kBElems) * sizeof(T) + 2 * kYElems * sizeof(float);
};

// Copies steps [t0, t0 + steps) of this block's x, dt (channels d0..d0+31)
// and B, C into one buffer.
template <class T, int N, int S>
__device__ __forceinline__ void stage(const T* __restrict__ x, const T* __restrict__ dt,
                                      const T* __restrict__ b, const T* __restrict__ c,
                                      T* xs, T* dts, T* bs, T* cs, int64_t row0, int steps,
                                      int64_t d, int64_t d0, bool vec) {
  using K = Scan<T, N, S>;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kRowVecs = kChannels / K::kVec;
    for (int i = tid; i < steps * kRowVecs; i += K::kThreads) {
      const int tt = i / kRowVecs, v = i % kRowVecs;
      const int64_t ch = d0 + v * K::kVec;
      if (ch < d) {  // d is a multiple of kVec here: a vector is all in or all out
        const int64_t off = (row0 + tt) * d + ch;
        cp_async16(xs + tt * kChannels + v * K::kVec, x + off);
        cp_async16(dts + tt * kChannels + v * K::kVec, dt + off);
      }
    }
    for (int i = tid; i < steps * N / K::kVec; i += K::kThreads) {
      cp_async16(bs + i * K::kVec, b + row0 * N + i * K::kVec);
      cp_async16(cs + i * K::kVec, c + row0 * N + i * K::kVec);
    }
  } else {
    for (int i = tid; i < steps * kChannels; i += K::kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      if (d0 + cc < d) {
        const int64_t off = (row0 + tt) * d + d0 + cc;
        xs[i] = x[off];
        dts[i] = dt[off];
      }
    }
    for (int i = tid; i < steps * N; i += K::kThreads) {
      bs[i] = b[row0 * N + i];
      cs[i] = c[row0 * N + i];
    }
  }
}

// The chunk's y from the warps' partial sums, in warp order: warp g writes
// steps g, g + kGroups, ...
template <class T, int G>
__device__ __forceinline__ void write_y(T* __restrict__ y, const float* yp, int64_t row0,
                                        int steps, int64_t d, int64_t chan, int lane, int g) {
  for (int tt = g; tt < steps; tt += G) {
    float acc = yp[tt * G * kChannels + lane];
#pragma unroll
    for (int gg = 1; gg < G; ++gg) acc += yp[(tt * G + gg) * kChannels + lane];
    y[(row0 + tt) * d + chan] = from_float<T>(acc);
  }
}

// The shared-memory values of U time steps from tt on that this thread's S
// states of its lane's channel read: dt and x of the channel, B and C of the
// states.
template <int S, int U>
struct Steps {
  float dv[U], xv[U], bv[U][S], cv[U][S];
};

template <class T, int N, int S, int U>
__device__ __forceinline__ void load_steps(Steps<S, U>& st, const T* xc, const T* dc,
                                           const T* bc, const T* cc, int tt, int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    st.dv[u] = to_float(dc[(tt + u) * kChannels + lane]);
    st.xv[u] = to_float(xc[(tt + u) * kChannels + lane]);
    load_states<S>(bc + (tt + u) * N, st.bv[u]);
    load_states<S>(cc + (tt + u) * N, st.cv[u]);
  }
}

// The recurrence over those U steps, then the stores of this thread's partial
// sums of y.
template <int N, int S, int U>
__device__ __forceinline__ void run_steps(const Steps<S, U>& st, float* yp, const float (&a2)[S],
                                          float (&h)[S], float skip, int tt, int lane, int g) {
  constexpr int G = N / S;
  float part[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float dtx = st.dv[u] * st.xv[u];
    part[u] = skip * st.xv[u];  // the D skip, in warp 0's partial (0 in the others)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      h[s] = fmaf(exp2_approx(st.dv[u] * a2[s]), h[s], dtx * st.bv[u][s]);
      part[u] = fmaf(h[s], st.cv[u][s], part[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) yp[((tt + u) * G + g) * kChannels + lane] = part[u];
}

// One chunk's walk. A full chunk is unrolled in batches of U steps, each
// batch's loads issued while the batch before it computes, so the latency
// of shared memory never sits between dt and the exponentials (a whole
// chunk's walk waits on it only once); a last, shorter chunk goes step by
// step.
template <class T, int N, int S, int U>
__device__ __forceinline__ void walk_chunk(const T* xc, const T* dc, const T* bc, const T* cc,
                                           float* yp, const float (&a2)[S], float (&h)[S],
                                           float skip, int steps, int lane, int g) {
  if (steps == kChunk) {
    Steps<S, U> st[2];
    load_steps<T, N, S, U>(st[0], xc, dc, bc, cc, 0, lane);
#pragma unroll
    for (int k = 0; k < kChunk / U; ++k) {
      if (k + 1 < kChunk / U) load_steps<T, N, S, U>(st[(k + 1) % 2], xc, dc, bc, cc, (k + 1) * U, lane);
      run_steps<N, S, U>(st[k % 2], yp, a2, h, skip, k * U, lane, g);
    }
  } else {
    for (int tt = 0; tt < steps; ++tt) {
      Steps<S, 1> st;
      load_steps<T, N, S, 1>(st, xc, dc, bc, cc, tt, lane);
      run_steps<N, S, 1>(st, yp, a2, h, skip, tt, lane, g);
    }
  }
}

template <class T, int N, int S>
__global__ void __launch_bounds__(Scan<T, N, S>::kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ a,
            const T* __restrict__ b, const T* __restrict__ c, const float* __restrict__ d_skip,
            T* __restrict__ y, float* __restrict__ h_last, int64_t t_len, int64_t d, bool vec) {
  using K = Scan<T, N, S>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [2][kChunk][kChannels]
  T* dts = xs + 2 * K::kXElems;        // [2][kChunk][kChannels]
  T* bs = dts + 2 * K::kXElems;        // [2][kChunk][N]
  T* cs = bs + 2 * K::kBElems;         // [2][kChunk][N]
  float* yp = reinterpret_cast<float*>(cs + 2 * K::kBElems);  // [kChunk][kGroups][kChannels]

  const int lane = threadIdx.x % 32;
  const int g = threadIdx.x / 32;  // this warp's states: [g*S, (g+1)*S)
  // grid x is (batch row, channel block) flattened: up to 2^31 - 1 blocks
  const int64_t blocks_per_row = (d + kChannels - 1) / kChannels;
  const int64_t bi = blockIdx.x / blocks_per_row;
  const int64_t d0 = (blockIdx.x % blocks_per_row) * kChannels;
  const int64_t chan = d0 + lane;
  const bool valid = chan < d;
  float a2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a2[s] = valid ? a[chan * N + g * S + s] * kLog2e : 0.0f;
    h[s] = 0.0f;
  }
  const float skip = valid && g == 0 ? d_skip[chan] : 0.0f;  // warp 0's partial takes the skip
  const int64_t row_base = bi * t_len;  // first [t, :] row of this batch entry
  const int64_t chunks = (t_len + kChunk - 1) / kChunk;

  if (chunks > 0) {
    stage<T, N, S>(x, dt, b, c, xs, dts, bs, cs, row_base,
                   static_cast<int>(t_len < kChunk ? t_len : kChunk), d, d0, vec);
  }
  cp_async_commit();
  for (int64_t ci = 0; ci < chunks; ++ci) {
    const int buf = static_cast<int>(ci & 1);
    const int64_t t0 = ci * kChunk;
    const int steps = static_cast<int>(t_len - t0 < kChunk ? t_len - t0 : kChunk);
    cp_async_wait_all();
    // chunk ci has landed in every thread's view; every thread is done with
    // chunk ci-1's walk (its x, dt, B, C buffer is free, its y partials are
    // in) and with chunk ci-2's y (this chunk's partials buffer is free)
    __syncthreads();
    if (ci + 1 < chunks) {
      const int64_t t1 = t0 + kChunk;
      stage<T, N, S>(x, dt, b, c, xs + (1 - buf) * K::kXElems, dts + (1 - buf) * K::kXElems,
                     bs + (1 - buf) * K::kBElems, cs + (1 - buf) * K::kBElems, row_base + t1,
                     static_cast<int>(t_len - t1 < kChunk ? t_len - t1 : kChunk), d, d0, vec);
    }
    cp_async_commit();
    if (ci > 0 && valid) {
      write_y<T, K::kGroups>(y, yp + (1 - buf) * K::kYElems, row_base + t0 - kChunk, kChunk, d,
                             chan, lane, g);
    }

    const T* xc = xs + buf * K::kXElems;
    const T* dc = dts + buf * K::kXElems;
    const T* bc = bs + buf * K::kBElems + g * S;
    const T* cc = cs + buf * K::kBElems + g * S;
    walk_chunk<T, N, S, K::kSteps>(xc, dc, bc, cc, yp + buf * K::kYElems, a2, h, skip, steps,
                                   lane, g);
  }
  if (chunks > 0) {
    __syncthreads();
    const int64_t t0 = (chunks - 1) * kChunk;
    if (valid) {
      write_y<T, K::kGroups>(y, yp + ((chunks - 1) & 1) * K::kYElems, row_base + t0,
                             static_cast<int>(t_len - t0), d, chan, lane, g);
    }
  }
  if (valid) {
#pragma unroll
    for (int s = 0; s < S; ++s) h_last[(bi * d + chan) * N + g * S + s] = h[s];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <class T, int N>
int launch(const void* x, const void* dt, const float* a, const void* b, const void* c,
           const float* d_skip, void* y, float* h_last, int64_t batch, int64_t t_len,
           int64_t d, cudaStream_t stream) {
  constexpr int S = kStates < N ? kStates : N;
  using K = Scan<T, N, S>;
  const int64_t blocks = batch * ((d + kChannels - 1) / kChannels);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(K::kSmem <= 227 * 1024, "shared memory per block");
  // once per instance, before any launch (a CUDA graph may capture later ones)
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_kernel<T, N, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec = aligned16(x) && aligned16(dt) && aligned16(b) && aligned16(c) &&
                   d % K::kVec == 0;
  scan_kernel<T, N, S><<<static_cast<unsigned>(blocks), K::kThreads, K::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a, static_cast<const T*>(b),
      static_cast<const T*>(c), d_skip, static_cast<T*>(y), h_last, t_len, d, vec);
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
