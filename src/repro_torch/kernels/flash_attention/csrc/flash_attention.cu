// Online-softmax (flash) attention for Hopper (sm_90a):
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h / g, j] / sqrt(Dh)) v[b, h / g, j]
//
// over the keys j that the masks keep: j < Tk; j <= q_offset + i when causal;
// j > q_offset + i - window with a sliding window. g = Hq / Hkv query heads
// share one key/value head (GQA).
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
//           flash_attention_pallas (_attn_kernel), and with it the model's
//           jnp mirrors of it, _sdpa / _chunked_sdpa (prefill) and
//           gqa_flash_decode (one decode step, Tq = 1, q_offset = pos).
//
// Bound. Prefill of one qwen3-8b layer (B=1, Hq=32, Hkv=8, T=8192, Dh=128,
// bf16, causal): the two products take 4 * Hq * Dh * T^2 / 2 = 550 GFLOP,
// 0.56 ms at the tensor cores' 989 TFLOP/s; its bytes (q, k, v, o: 100 MB)
// take 0.03 ms, so operations bound it. One decode step at 32k context
// (B=32, Tq=1, Tk=32768): the K/V reads (4.3 GB) take 1.28 ms and bound it.
//
// Design, a first version that is right before it is fast. One block of 256
// threads owns BQ query rows of one (batch, query head); it reads its key
// and value head h / g directly (no repeat of K/V, no padding of Tq) through
// element strides, so the model's [B, T, H, Dh] tensors and its [B, S, Hkv,
// Dh] cache are read in place. When g * Tq <= 16 (a decode step: qwen3's
// g = 4, Tq = 1), one block owns the Tq rows of all g query heads of a
// key/value head instead, so the cache is read once per KV head and 4 of the
// block's 16 rows do work rather than 1. Key/value tiles of 64 rows are
// staged in shared memory as float32 (16-byte loads where the strides allow
// them); the block visits only the tiles between the
// Pallas kernel's bounds (lo from the window, hi from the causal limit), so
// masked tiles are skipped, not computed. Running max, denominator and the
// [BQ, Dh] accumulator stay in float32 (the accumulator in registers). Both
// products run on the CUDA cores in float32 FMA, not the tensor cores: the
// float32 path must meet a 2e-5 tolerance, which TF32 cannot, and wgmma/TMA
// tiles are later work. Masked scores take the finite -1e30, as the Pallas
// kernel does, so a row whose first visited tile is fully masked gets
// exp(0) weights that the first real score wipes out (alpha = 0), never NaN.
// A block holds BQ = 64 query rows, or 16 when Tq <= 16, so a decode step
// does not drag 63 idle rows through the products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of (ty, tx)
constexpr int kBK = 64;        // key/value rows per tile
constexpr int kPS = kBK + 1;   // padded row of the probability tile
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// element strides of a [B, H, T, Dh] view whose last dimension is contiguous
struct Strides {
  int64_t b, h, t;
};

// eight bf16 or four float32 values from one 16-byte load, as float32
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of a float32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int DH, int BQ>
struct Smem {
  static constexpr int kQS = DH + 1;  // padded rows: conflict-free column reads
  static constexpr int kKS = DH + 1;
  // the probability tile reuses the key tile's space once scores are taken
  static constexpr int kKRegion = (kBK * kKS > BQ * kPS) ? kBK * kKS : BQ * kPS;
  static constexpr int kFloats = BQ * kQS + kKRegion + kBK * DH + 3 * BQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <class T, int DH, int BQ>
__global__ void __launch_bounds__(kThreads, 2)  // <= 128 registers: two blocks an SM
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int64_t hq,
            int64_t group, int64_t heads_per_block, int64_t rows_per_head, int64_t tq,
            int64_t tk, int causal, int64_t window, int64_t q_offset, float sm_scale) {
  using S = Smem<DH, BQ>;
  constexpr int RM = BQ / 16;   // rows per thread
  constexpr int CN = kBK / 16;  // score columns per thread
  constexpr int DN = DH / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][DH + 1], scaled queries
  float* ks = qs + BQ * S::kQS;     // [kBK][DH + 1] keys, then [BQ][kPS] probabilities
  float* ps = ks;
  float* vs = ks + S::kKRegion;     // [kBK][DH]
  float* m_s = vs + kBK * DH;       // running max per row
  float* l_s = m_s + BQ;            // running denominator per row
  float* a_s = l_s + BQ;            // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  // block row r < used_rows is query row row0 + r % rows_per_head of query
  // head h0 + r / rows_per_head; all of the block's heads share KV head kvh
  const int64_t head_blocks = hq / heads_per_block;
  const int64_t bi = blockIdx.y / head_blocks;
  const int64_t h0 = (blockIdx.y % head_blocks) * heads_per_block;
  const int64_t kvh = h0 / group;
  const int rph = static_cast<int>(rows_per_head);
  const int used_rows = static_cast<int>(heads_per_block) * rph;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rph;
  const int64_t q_start = row0 + q_offset;  // absolute position of row offset 0

  const T* kp = k + bi * sk.b + kvh * sk.h;
  const T* vp = v + bi * sv.b + kvh * sv.h;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const bool vec_kv =
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16 == 0) &&
      sk.t % kVec == 0 && sv.t % kVec == 0;

  for (int idx = tid; idx < BQ * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    float val = 0.0f;
    if (r < used_rows) {
      const int64_t row = row0 + r % rph;
      const int64_t head = h0 + r / rph;
      if (row < tq) val = to_float(q[bi * sq.b + head * sq.h + row * sq.t + d]) * sm_scale;
    }
    qs[r * S::kQS + d] = val;
  }
  int rel[RM];  // this thread's rows' offsets from q_start
#pragma unroll
  for (int i = 0; i < RM; ++i) rel[i] = (ty + 16 * i) % rph;
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }

  // the key tiles this query tile can see (the Pallas kernel's loop bounds)
  const int64_t n_tiles = (tk + kBK - 1) / kBK;
  int64_t hi = n_tiles;
  if (causal) {
    const int64_t last = (q_start + rph + kBK - 1) / kBK;
    hi = last < n_tiles ? last : n_tiles;
  }
  int64_t lo = 0;
  if (window > 0) {
    const int64_t first = q_start - window + 1;  // floor division; negative clamps to 0
    lo = first > 0 ? first / kBK : 0;
  }

  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.0f;

  for (int64_t tile = lo; tile < hi; ++tile) {
    const int64_t kbase = tile * kBK;
    __syncthreads();  // the previous tile's probabilities and values are consumed
    if (vec_kv) {
      constexpr int kPerRow = DH / kVec;
      for (int idx = tid; idx < kBK * kPerRow; idx += kThreads) {
        const int c = idx / kPerRow, d = (idx % kPerRow) * kVec;
        const int64_t kpos = kbase + c;
        float kv[kVec], vv[kVec];
        if (kpos < tk) {
          load_vec(kp + kpos * sk.t + d, kv);
          load_vec(vp + kpos * sv.t + d, vv);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv[e] = vv[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ks[c * S::kKS + d + e] = kv[e];
          vs[c * DH + d + e] = vv[e];
        }
      }
    } else {
      for (int idx = tid; idx < kBK * DH; idx += kThreads) {
        const int c = idx / DH, d = idx % DH;
        const int64_t kpos = kbase + c;
        float kv = 0.0f, vv = 0.0f;
        if (kpos < tk) {
          kv = to_float(kp[kpos * sk.t + d]);
          vv = to_float(vp[kpos * sv.t + d]);
        }
        ks[c * S::kKS + d] = kv;
        vs[c * DH + d] = vv;
      }
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty + 16 * i) * S::kQS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = ks[(tx + 16 * j) * S::kKS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with the keys: ps may overwrite them
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      const int64_t qpos = q_start + rel[i];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 16 * j;
        const int64_t kpos = kbase + c;
        bool keep = kpos < tk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        ps[r * kPS + c] = keep ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row: the tile's max, the rescale of what
    // came before, the probabilities and their sum
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float* row = ps + r * kPS;
      const float s0 = row[lane], s1 = row[lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mt = fmaxf(mt, __shfl_xor_sync(kFullMask, mt, off));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mt);
      const float p0 = expf(s0 - m_cur), p1 = expf(s1 - m_cur);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(kFullMask, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        m_s[r] = m_cur;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = vs[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s holds the last tile's denominators

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    const int64_t row = row0 + rel[i];
    if (r >= used_rows || row >= tq) continue;
    T* op = o + bi * so.b + (h0 + r / rph) * so.h + row * so.t;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j) op[tx + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

// heads_per_block query heads (1, or all g of a KV head) of rows_per_head
// query rows each make one block
template <class T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, const int64_t* st,
           int64_t batch, int64_t hq, int64_t hkv, int64_t heads_per_block,
           int64_t rows_per_head, int64_t tq, int64_t tk, int causal, int64_t window,
           int64_t q_offset, float sm_scale, cudaStream_t stream) {
  using S = Smem<DH, BQ>;
  auto kernel = attn_kernel<T, DH, BQ>;
  // set once, before any launch (and so before any CUDA-graph capture)
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kBytes));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int64_t q_tiles = (tq + rows_per_head - 1) / rows_per_head;
  const int64_t head_blocks = batch * (hq / heads_per_block);
  if (head_blocks > 65535 || q_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(head_blocks));
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, hq, hq / hkv,
      heads_per_block, rows_per_head, tq, tk, causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int DH>
int launch_bq(const void* q, const void* k, const void* v, void* o, const int64_t* st,
              int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int causal,
              int64_t window, int64_t q_offset, float sm_scale, cudaStream_t stream) {
  const int64_t group = hq / hkv;
  if (group * tq <= 16) {  // decode: the g heads of a KV head in one block
    return launch<T, DH, 16>(q, k, v, o, st, batch, hq, hkv, group, tq, tq, tk, causal, window,
                             q_offset, sm_scale, stream);
  }
  if (tq <= 16) {
    return launch<T, DH, 16>(q, k, v, o, st, batch, hq, hkv, 1, 16, tq, tk, causal, window,
                             q_offset, sm_scale, stream);
  }
  return launch<T, DH, 64>(q, k, v, o, st, batch, hq, hkv, 1, 64, tq, tk, causal, window,
                           q_offset, sm_scale, stream);
}

template <class T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o, const int64_t* st,
              int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int causal,
              int64_t window, int64_t q_offset, float sm_scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_bq<T, 32>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window, q_offset,
                              sm_scale, stream);
    case 64:
      return launch_bq<T, 64>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window, q_offset,
                              sm_scale, stream);
    case 128:
      return launch_bq<T, 128>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window, q_offset,
                               sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o[B, Hq, Tq, Dh] from q[B, Hq, Tq, Dh], k and v[B, Hkv, Tk, Dh], all given
// by base pointer and element strides (strides[0..11]: the batch, head and
// row strides of q, k, v, o, in that order; the last dimension contiguous).
// dtype 0 = float32, 1 = bfloat16; dh in {32, 64, 128}; Hq a multiple of
// Hkv; window <= 0 means none. Returns the CUDA error code of the launch.
int flash_attention_fwd(int dtype, int dh, const void* q, const void* k, const void* v, void* o,
                        const int64_t* strides, int64_t batch, int64_t hq, int64_t hkv,
                        int64_t tq, int64_t tk, int causal, int64_t window, int64_t q_offset,
                        float sm_scale, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || tk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dh<float>(dh, q, k, v, o, strides, batch, hq, hkv, tq, tk, causal, window,
                            q_offset, sm_scale, s);
  }
  if (dtype == 1) {
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
