// Online-softmax (flash) attention for Hopper (sm_90a): the kernel templates,
// shared by the two libraries that instantiate them (flash_attention.cu at
// Dqk = Dv, flash_attention_mla.cu at MLA's pairs):
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h / g, j] * sm_scale) v[b, h / g, j]
//
// over the keys j that the masks keep: j < Tk; j <= q_offset + i when causal;
// j > q_offset + i - window with a sliding window. g = Hq / Hkv query heads
// share one key/value head (GQA). q and k are Dqk wide, v and o Dv wide (Dqk =
// Dv but for MLA); the wrappers pass sm_scale = Dqk^-0.5. Masked scores take
// the finite -1e30, as the Pallas kernel does, so a row whose first visited
// tile is fully masked gets exp(0) weights that the first real score wipes out
// (alpha = 0), never NaN.
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
//           flash_attention_pallas (_attn_kernel), and with it the model's
//           jnp mirrors of it, _sdpa / _chunked_sdpa (prefill) and
//           gqa_flash_decode (one decode step, Tq = 1, q_offset = pos); at
//           MLA's widths also the reference's mla_flash_decode (a jnp
//           einsum, no Pallas kernel), which attn_latent_kernel runs.
//
// Bound. Prefill of one qwen3-8b layer (B=1, Hq=32, Hkv=8, T=8192, Dh=128,
// bf16, causal): the two products over the pairs the mask keeps take
// 4 * Hq * Dh * T (T + 1) / 2 = 550 GFLOP, 0.556 ms at the tensor cores'
// 989 TFLOP/s; its bytes (q, k, v, o: 100 MB) take 0.03 ms, so operations
// bound it. One decode step at 32k context (B=32, Tq=1, Tk=32768): the K/V
// reads (4.3 GB) take 1.28 ms and bound it.
//
// Five kernels. The wrapper (ops.py kernel_variant) picks one before launch
// from the dtype, Tq, g, Dh and the 16-byte alignment of the pointers and
// strides alone, never from a failed build or launch.
//
// attn_decode_kernel, decode (g * Tq <= 16, float32 and bf16): split-KV
// over the cache, bound by the K/V bytes. A block owns all g * Tq query rows
// of one (batch, KV head) and one contiguous share ("split") of the key tiles
// between the Pallas bounds, so the cache is read once per KV head and
// B * Hkv * n_split blocks fill the card even at small batch (ops.py
// decode_splits picks n_split from the shapes and from the blocks an SM
// holds, which flash_decode_blocks_per_sm reads). K/V stay in their
// stored dtype in a shared-memory ring of >= 3 stages of 64 keys, filled by
// 16-byte cp.async copies (element loads for rows that are not 16-byte
// aligned) and guarded by full/empty mbarriers, so the next tiles' bytes are
// in flight while a tile is consumed and no __syncthreads sits in the loop.
// Each warp takes 16 keys of every tile, a group of 4-32 lanes a key: a lane
// holds its slice of every scaled query row in registers, the dot products are reduced
// by shuffles inside the key's lane group, and the warp keeps its own running
// max, sum and output (float32, base-2 exponent). The warps merge once at the
// end of the block; with n_split > 1 each split writes its float32 (m, l,
// unnormalised o) to a workspace and attn_merge_kernel, a second launch on
// the same stream, combines them by the reference's gqa_flash_decode rule
// (m = max m_s, l = sum exp(m_s - m) l_s, o = sum exp(m_s - m) o_s / l).
//
// attn_wgmma_kernel, bf16 prefill (Tq > 16 and g * Tq > 16), on the tensor
// cores with wgmma (bf16 operands, float32 accumulators). A block is two
// consumer warpgroups of 64 query rows each (128 rows of one (batch, query
// head)) and one producer warp. The producer has the tensor memory
// accelerator (TMA) copy the Q tile once and then K/V tiles of 64 keys, as
// bf16, into a ring of 4 stages (2 at Dh = 256, whose tiles are 32 KB), each
// stage guarded by a pair of mbarriers
// (full: the bytes landed; empty: every consumer warp is done with it), so
// loads run ahead of the products; TMA writes the tiles in the swizzled
// layout wgmma reads, reads the model's strided [B, T, H, Dh] views in place
// and zero-fills rows past Tq and Tk. Each consumer warpgroup takes S = Q K^T
// with both operands from shared memory, keeps the row max, row sum and
// rescale in float32 registers (base-2 exponent, the scale folded in; trees,
// not chains, for the maxima and sums; the O rescale skipped while no row of
// a thread sees a new maximum), rounds P to bf16 and feeds it straight from
// the S registers as wgmma's register A operand of P V, with V read N-major
// (transposed) from shared memory; O stays in float32 registers and is
// rounded once on store. Each step issues S of the next tile together with
// P V of the current one and takes the softmax of the next tile while P V
// runs, so the tensor cores work during the softmax. Only the key tiles
// between the Pallas kernel's bounds are visited (lo from the window, hi from
// the causal limit); only tiles that cross the diagonal, the window edge or
// Tk apply the mask, and a warpgroup skips the tiles past its own diagonal.
// Query tiles are handed out last first, so the heaviest causal tiles start
// first. The softmax, not the products, still sets the pace (PERF.md);
// tiles of 128 keys would halve its per-tile costs but need more registers
// than the launch bound leaves (with a producer warpgroup and setmaxnreg,
// ptxas still held 168 registers a thread and spilled).
//
// attn_kernel, the rest (g * Tq > 16): float32 inputs, and bf16 inputs with
// Tq <= 16 or rows that are not 16-byte aligned. Both products in float32
// FMA on the CUDA cores. The float32 path must meet the 2e-5
// tolerance of the reference's tests, which neither TF32 nor bf16 operands
// can. A block of 256 threads owns BQ query rows of one (batch, query head)
// (BQ = 64, or 16 when Tq <= 16); K/V tiles of 64 rows are staged as float32
// (16-byte loads where the strides allow them), with the same tile bounds.
//
// attn_latent_kernel, MLA's absorbed decode (Dqk = 576 latent + rope, Dv =
// 512 latent, all 128 query heads on one latent KV head: g = 128) and MLA's
// short prefill (Tq <= 16, g = 1). Like decode_split, a block takes all g * Tq
// query rows of a (batch, KV head), so the latent cache is read once per
// block and not once per query head; unlike it, the rows are many (128) and
// wide (576), so they sit in shared memory as the FMA kernel's query tile (64
// rows a block, float32), the keys are staged 64 columns at a time, and a
// grid axis cuts the output columns into slices of at most 128 (a 64 x 128
// float32 accumulator a block; the slices recompute the same scores). Split-KV
// shares and attn_merge_kernel as in decode_split. Both products in float32
// FMA: the bytes (the cache, 1,152 bytes a key in bf16) bound this step, but
// the FMA rate bounds this kernel (PERF.md). It keeps the float32 calls, the
// unaligned bf16 ones and the (192, 128) and (48, 32) pairs.
//
// attn_latent_wgmma_kernel (latent_wgmma), MLA's absorbed decode in bf16 at
// (576, 512) with 16-byte aligned inputs and the value a view of the key's
// first 512 columns (Tq <= 16). Replaces, as attn_latent_kernel does,
// repro/models/attention.py::mla_flash_decode, a jnp einsum with no Pallas
// kernel. Bound, at B=8 over a 32k latent cache: 302 MB of latent rows, 0.0908
// ms at 3.35 TB/s; the necessary products (a 576-wide QK^T and a 512-wide P V
// for 128 heads) are 73 GFLOP, 0.074 ms at 989 TFLOP/s; so bytes bound it, and
// barely. The design reads each latent row once a block and feeds both
// products from that one read: a producer warpgroup has TMA copy each 64-key tile
// (9 boxes of 64 columns, 128-byte swizzle) into a ring of 2 stages guarded by
// full/empty mbarriers; S = Q K^T reads the tile K-major (9 k64 blocks of
// wgmma_ss) and P V reads its first 512 columns N-major, as the prefill
// kernel reads V. A block owns 64 query rows (g * Tq rows of a (batch, KV
// head) in tiles of 64, Q resident in shared memory) and all 512 output
// columns: two consumer warpgroups, 256 columns each (a 64 x 256 float32
// accumulator, two m64n128k16 wgmma_rs a 16-key step and part of P, P from
// the S registers). Each warpgroup takes S of the tile itself (1.5x the necessary
// QK work, still under the byte time). So a (batch, share) is 2 blocks where
// attn_latent_kernel had 8, the cache is read twice (the two row tiles sit on
// adjacent blocks, so the second read tends to hit L2), and the split count
// (ops.py decode_splits) fills the card with shares. setmaxnreg moves
// registers from the producer warpgroup (24) to the consumers (240): the
// launch leaves 168 a thread, and a consumer holds 208 in accumulators and
// operands alone. (A lone producer warp gives back too few: the consumers'
// setmaxnreg.inc would wait for ever.)
// Same semantics as attn_latent_kernel: the Pallas tile bounds, base-2 scores,
// -1e30 for masked ones, float32 row statistics, split shares merged by
// attn_merge_kernel. P enters wgmma as three bf16 operands that sum to the
// float32 P (24 bits), so P V runs three times: with P in bf16 alone a row's
// error was 4x the output's own bf16 rounding, and with one or two parts a
// deepseek-v2 decode step's logits left the plain version's by more than
// chip_smoke.py's 1e-2 (a router near-tie flipped; PERF.md).
//
// All kernels read q, k, v and write o through element strides, so the
// model's [B, T, H, Dh] tensors and its [B, S, Hkv, Dh] cache are read in
// place and the output is written in the model's layout. The (batch, head)
// blocks, and the decode kernel's (batch, KV head, split) blocks, go on grid
// x (up to 2^31 - 1), the query tiles on grid y; past 65,535 query tiles a
// block loops over them.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime's driver entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>  // INFINITY
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of (ty, tx)
constexpr int kBK = 64;        // key/value rows per tile, in both kernels
constexpr int kPS = kBK + 1;   // padded row of the probability tile
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int64_t kMaxGridY = 65535;
constexpr int kMaxSmemBytes = 227 * 1024;  // the dynamic shared memory a block may have

// the variants of ops.py's VARIANTS, in order
enum Variant : int {
  kFma = 0,
  kFmaShort = 1,
  kDecodeSplit = 2,
  kWgmmaBf16 = 3,
  kDecodeLatent = 4,
  kLatentWgmma = 5
};

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

// the key tiles [lo, hi) that query rows [q_start, q_start + rows) can see:
// the Pallas kernel's loop bounds
__device__ __forceinline__ void tile_bounds(int64_t q_start, int64_t rows, int64_t tk,
                                            int causal, int64_t window, int64_t& lo,
                                            int64_t& hi) {
  const int64_t n_tiles = (tk + kBK - 1) / kBK;
  hi = n_tiles;
  if (causal) {
    const int64_t last = (q_start + rows + kBK - 1) / kBK;
    hi = last < n_tiles ? last : n_tiles;
  }
  lo = 0;
  if (window > 0) {
    const int64_t first = q_start - window + 1;  // floor division; negative clamps to 0
    lo = first > 0 ? first / kBK : 0;
  }
}

// ------------------------------------------------------------------ FMA kernel

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

template <int DQK, int DV, int BQ>
struct Smem {
  static constexpr int kQS = DQK + 1;  // padded rows: conflict-free column reads
  static constexpr int kKS = DQK + 1;
  // the probability tile reuses the key tile's space once scores are taken
  static constexpr int kKRegion = (kBK * kKS > BQ * kPS) ? kBK * kKS : BQ * kPS;
  static constexpr int kFloats = BQ * kQS + kKRegion + kBK * DV + 3 * BQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  // two blocks an SM where their shared memory fits (<= 128 registers a
  // thread); one at Dh = 256, whose tiles take 148-198 KB
  static constexpr int kMinBlocks = 2 * kBytes <= kMaxSmemBytes ? 2 : 1;
};

// rows [0, kBK) of a K or V tile (COLS wide, from column c0 of the source
// rows) as float32 into dst (rows dst_stride floats apart), zero past Tk;
// 16-byte loads where vec says the rows allow them
template <int COLS, class T>
__device__ __forceinline__ void stage_tile(const T* src, int64_t row_stride, int64_t kbase,
                                           int64_t tk, int c0, bool vec, float* dst,
                                           int dst_stride, int tid) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  if (vec) {
    constexpr int kPerRow = COLS / kVec;
    static_assert(COLS % kVec == 0, "a row is whole 16-byte pieces");
    for (int idx = tid; idx < kBK * kPerRow; idx += kThreads) {
      const int c = idx / kPerRow, d = (idx % kPerRow) * kVec;
      const int64_t kpos = kbase + c;
      float x[kVec];
      if (kpos < tk) {
        load_vec(src + kpos * row_stride + c0 + d, x);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[c * dst_stride + d + e] = x[e];
    }
  } else {
    for (int idx = tid; idx < kBK * COLS; idx += kThreads) {
      const int c = idx / COLS, d = idx % COLS;
      const int64_t kpos = kbase + c;
      dst[c * dst_stride + d] = kpos < tk ? to_float(src[kpos * row_stride + c0 + d]) : 0.0f;
    }
  }
}

template <class T, int DQK, int DV, int BQ>
__global__ void __launch_bounds__(kThreads, (Smem<DQK, DV, BQ>::kMinBlocks))
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int64_t hq,
            int64_t group, int64_t tq, int64_t tk, int causal, int64_t window, int64_t q_offset,
            float sm_scale) {
  using S = Smem<DQK, DV, BQ>;
  constexpr int RM = BQ / 16;   // rows per thread
  constexpr int CN = kBK / 16;  // score columns per thread
  constexpr int DN = DV / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][DQK + 1], scaled queries
  float* ks = qs + BQ * S::kQS;     // [kBK][DQK + 1] keys, then [BQ][kPS] probabilities
  float* ps = ks;
  float* vs = ks + S::kKRegion;     // [kBK][DV]
  float* m_s = vs + kBK * DV;       // running max per row
  float* l_s = m_s + BQ;            // running denominator per row
  float* a_s = l_s + BQ;            // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  // block row r is query row row0 + r of query head h
  const int64_t bi = blockIdx.x / hq;
  const int64_t h = blockIdx.x % hq;
  const int64_t kvh = h / group;
  const int64_t q_tiles = (tq + BQ - 1) / BQ;

  const T* kp = k + bi * sk.b + kvh * sk.h;
  const T* vp = v + bi * sv.b + kvh * sv.h;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const bool vec_kv =
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16 == 0) &&
      sk.t % kVec == 0 && sv.t % kVec == 0;

  for (int64_t qt = blockIdx.y; qt < q_tiles; qt += gridDim.y) {
    const int64_t row0 = qt * BQ;
    const int64_t q_start = row0 + q_offset;  // absolute position of row offset 0
    __syncthreads();  // the previous query tile's epilogue has read l_s

    for (int idx = tid; idx < BQ * DQK; idx += kThreads) {
      const int r = idx / DQK, d = idx % DQK;
      const int64_t row = row0 + r;
      qs[r * S::kQS + d] =
          row < tq ? to_float(q[bi * sq.b + h * sq.h + row * sq.t + d]) * sm_scale : 0.0f;
    }
    for (int r = tid; r < BQ; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.0f;
    }
    int64_t lo, hi;
    tile_bounds(q_start, BQ, tk, causal, window, lo, hi);

    float acc[RM][DN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] = 0.0f;

    for (int64_t tile = lo; tile < hi; ++tile) {
      const int64_t kbase = tile * kBK;
      __syncthreads();  // the previous tile's probabilities and values are consumed
      stage_tile<DQK>(kp, sk.t, kbase, tk, 0, vec_kv, ks, S::kKS, tid);
      stage_tile<DV>(vp, sv.t, kbase, tk, 0, vec_kv, vs, DV, tid);
      __syncthreads();

      // scores of rows ty + 16 i against keys tx + 16 j
      float s[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DQK; ++d) {
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
        const int64_t qpos = q_start + r;
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
        for (int j = 0; j < DN; ++j) vv[j] = vs[c * DV + tx + 16 * j];
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
      const int64_t row = row0 + r;
      if (row >= tq) continue;
      T* op = o + bi * so.b + h * so.h + row * so.t;
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DN; ++j) op[tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

// ----------------------------------------------------------- tensor-core kernel

using bf16 = __nv_bfloat16;
constexpr int kWgConsumers = 2;                      // consumer warpgroups, 64 query rows each
constexpr int kWgBQ = 64 * kWgConsumers;             // query rows a block
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block: the Q tile of kWgBQ rows, kStages K tiles and
// kStages V tiles of kBK rows, then the barriers. A tile is stored as
// wgmma's swizzled descriptors read it and the tensor memory accelerator
// writes it: rows of kRB bytes (the largest of 128, 64 and 32 that divides a
// row: 128 at Dh = 64, 128 and 256, 64 at Dh = 32, 32 at Dh = 80, whose
// 160-byte rows are five blocks), the Dh columns in blocks of kRB bytes one
// after another ([block][rows][kRB]), and inside each 8-row atom the 16-byte
// chunk c of row r at c ^ (r % 8) (128-byte swizzle), c ^ (r / 2 % 4)
// (64-byte swizzle) or c ^ (r / 4 % 2) (32-byte swizzle), which keeps the
// copies and wgmma's reads free of bank conflicts. Atoms start on 1024 bytes.
// Q and K tiles are Dqk wide, V tiles Dv wide, each with its own row blocks.
// The ring keeps as many stages as fit, at most 4: Dh = 256 keeps two (four
// would need 320 KB), MLA's (192, 128) four (209 KB).
template <int COLS>
struct WgRow {  // the row blocks of a COLS-wide bf16 tile
  static constexpr int kRB = COLS * 2 % 128 == 0 ? 128 : (COLS * 2 % 64 == 0 ? 64 : 32);
  static_assert(COLS * 2 % kRB == 0 && COLS % 16 == 0, "a row is whole blocks of 16-column steps");
  // descriptor and tensor-map swizzle: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t kLayout = kRB == 128 ? 1 : (kRB == 64 ? 2 : 3);
  static constexpr int kBoxes = COLS * 2 / kRB;  // column blocks of a row
};

template <int DQK, int DV>
struct WgSmem {
  using QK = WgRow<DQK>;
  using V = WgRow<DV>;
  static constexpr int kQBytes = kWgBQ * DQK * 2;
  static constexpr int kKTileBytes = kBK * DQK * 2;
  static constexpr int kVTileBytes = kBK * DV * 2;
  static constexpr size_t bytes(int stages) {
    return kQBytes + stages * (kKTileBytes + kVTileBytes) + 8 * (2 * stages + 1) + 1024;
  }
  static constexpr int kStages = bytes(4) <= kMaxSmemBytes   ? 4
                                 : bytes(3) <= kMaxSmemBytes ? 3
                                                             : 2;  // K/V tiles in the ring
  static constexpr size_t kBytes = bytes(kStages);
  static_assert(kBytes <= kMaxSmemBytes, "the block's tiles fit in shared memory");
  static_assert(kQBytes % 1024 == 0 && kKTileBytes % 1024 == 0 && kVTileBytes % 1024 == 0,
                "every tile starts on a 1024-byte atom");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (relative error about 2^-22; 0 for -1e30)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two float32 rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3ffff) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3ffff) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of r across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, float32) (+)= a (64 x 16, shared) b (16 x 64, shared): bf16, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 16, float32) (+)= a (64 x 16, registers) b (16 x 16, shared): bf16, b N-major
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 32, float32) (+)= a (64 x 16, registers) b (16 x 32, shared): bf16, b N-major
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64, float32) (+)= a (64 x 16, registers) b (16 x 64, shared): bf16, b N-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 128, float32) (+)= a (64 x 16, registers) b (16 x 128, shared): bf16, b N-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// the float32 accumulator registers of columns [C, C + N) of a wgmma fragment
// (8 columns take 4 registers)
template <int C, int N, int M>
__device__ __forceinline__ float (&columns(float (&acc)[M]))[N / 2] {
  static_assert(C % 8 == 0 && (C + N) / 2 <= M, "whole 8-column groups inside the fragment");
  return *reinterpret_cast<float(*)[N / 2]>(acc + C / 2);
}

// O (64 x DV) += P (64 x 16, registers) V (16 x DV, shared, N-major; the
// tile's block 0 at b0, blocks kBK rows of RB bytes apart): one instruction
// up to 128 columns, two for Dv = 256 (128 each) and Dv = 80 (64 + 16)
template <int DV, int RB>
__device__ __forceinline__ void wgmma_pv(float (&acc)[DV / 2], const uint32_t (&a)[4],
                                         uint32_t b0, uint64_t layout) {
  auto desc = [&](int col) {  // the descriptor of the columns from col on
    return wg_desc(b0 + col * 2 / RB * kBK * RB, kBK * RB, 8 * RB, layout);
  };
  if constexpr (DV == 256) {
    wgmma_rs(columns<0, 128>(acc), a, desc(0), 1);
    wgmma_rs(columns<128, 128>(acc), a, desc(128), 1);
  } else if constexpr (DV == 80) {
    wgmma_rs(columns<0, 64>(acc), a, desc(0), 1);
    wgmma_rs(columns<64, 16>(acc), a, desc(64), 1);
  } else {
    wgmma_rs(acc, a, desc(0), 1);
  }
}

// mbarriers in shared memory: a phase completes when its arrivals (and any
// expected bytes of asynchronous copies) are in; waits name the phase parity
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the barrier's current phase also waits for `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// one box of a 4-D tensor map (coordinates innermost first) into shared memory,
// counted on `bar` when it lands
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Register fragments (lane = 4 grp + tig of warp w of a warpgroup): an
// accumulator of N columns holds, for each 8-column group j, rows 16 w + grp
// (elements 4 j, 4 j + 1) and 16 w + grp + 8 (4 j + 2, 4 j + 3) at columns
// 8 j + 2 tig, + 1. Two adjacent 8-key groups of S in that layout are
// exactly wgmma's register A operand for 16 keys of P V.
template <int DQK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, Strides so,
                  int64_t hq, int64_t group, int64_t tq, int64_t tk, int causal,
                  int64_t window, int64_t q_offset, float scale_log2) {
  using S = WgSmem<DQK, DV>;
  using QK = typename S::QK;
  using V = typename S::V;
  constexpr int KT = kBK / 8;  // 8-key column tiles of S
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t qs_a = smem_addr(base);                       // [kWgBQ rows]
  const uint32_t ks_a = qs_a + S::kQBytes;                     // [kStages][kBK rows]
  const uint32_t vs_a = ks_a + S::kStages * S::kKTileBytes;    // [kStages][kBK rows]
  const uint32_t bar_a = vs_a + S::kStages * S::kVTileBytes;   // full[S], empty[S], q_full
  auto full = [&](int s) { return bar_a + 8 * s; };
  auto empty = [&](int s) { return bar_a + 8 * (S::kStages + s); };
  const uint32_t q_full = bar_a + 8 * 2 * S::kStages;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const bool producer = wg == kWgConsumers;
  const int grp = lane / 4, tig = lane % 4;
  const int64_t bi = blockIdx.x / hq, h = blockIdx.x % hq, kvh = h / group;
  bf16* op = o + bi * so.b + h * so.h;
  const int64_t q_tiles = (tq + kWgBQ - 1) / kWgBQ;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);                  // the producer's expect-tx arrival
      mbar_init(empty(s), 4 * kWgConsumers);  // one arrival a consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int stage = 0;
  uint32_t phase = 0;  // parity of the ring's current lap
  uint32_t q_phase = 0;

  for (int64_t it = blockIdx.y; it < q_tiles; it += gridDim.y) {
    const int64_t qt = q_tiles - 1 - it;  // the heaviest causal tiles first
    const int64_t row0 = qt * kWgBQ;
    const int64_t rows = tq - row0 < kWgBQ ? tq - row0 : kWgBQ;
    const int64_t q_start = row0 + q_offset;  // absolute position of the tile's row 0
    int64_t lo, hi;
    tile_bounds(q_start, rows, tk, causal, window, lo, hi);
    __syncthreads();  // barriers initialised; the previous query tile is done with Q

    if (producer) {
      // one thread: Q once, then K/V tiles into the ring as fast as consumers
      // free stages; the tensor memory accelerator writes them swizzled and
      // zero-fills rows past Tq / Tk
      if (lane == 0) {
        constexpr uint32_t kQBoxBytes = 64 * QK::kRB;  // a warpgroup's rows
        constexpr uint32_t kKBoxBytes = kBK * QK::kRB;
        constexpr uint32_t kVBoxBytes = kBK * V::kRB;
        mbar_expect_tx(q_full, kWgConsumers * QK::kBoxes * kQBoxBytes);
        for (int g = 0; g < kWgConsumers; ++g) {
          for (int cb = 0; cb < QK::kBoxes; ++cb) {
            tma_load_4d(qs_a + cb * kWgBQ * QK::kRB + g * kQBoxBytes, &q_map, q_full,
                        cb * (QK::kRB / 2), static_cast<int>(row0 + g * 64),
                        static_cast<int>(h), static_cast<int>(bi));
          }
        }
        for (int64_t tile = lo; tile < hi; ++tile) {
          mbar_wait(empty(stage), phase ^ 1);  // a fresh ring passes the first lap
          mbar_expect_tx(full(stage), QK::kBoxes * kKBoxBytes + V::kBoxes * kVBoxBytes);
          const uint32_t kd = ks_a + stage * S::kKTileBytes, vd = vs_a + stage * S::kVTileBytes;
          const int row = static_cast<int>(tile * kBK);
          for (int cb = 0; cb < QK::kBoxes; ++cb) {
            tma_load_4d(kd + cb * kKBoxBytes, &k_map, full(stage), cb * (QK::kRB / 2), row,
                        static_cast<int>(kvh), static_cast<int>(bi));
          }
          for (int cb = 0; cb < V::kBoxes; ++cb) {
            tma_load_4d(vd + cb * kVBoxBytes, &v_map, full(stage), cb * (V::kRB / 2), row,
                        static_cast<int>(kvh), static_cast<int>(bi));
          }
          if (++stage == S::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      __syncwarp();  // the warp converges before the next __syncthreads
    } else {
      const int64_t wg_start = q_start + wg * 64;  // absolute position of its row 0
      // the tiles this warpgroup works on; it releases the rest of [lo, hi) unread
      int64_t wlo, whi;
      tile_bounds(wg_start, 64, tk, causal, window, wlo, whi);
      wlo = wlo < lo ? lo : (wlo > hi ? hi : wlo);
      whi = whi < wlo ? wlo : (whi > hi ? hi : whi);
      float acc[DV / 2];  // O, 64 x DV a warpgroup: rows grp (+8) of each warp's 16
      float s[KT * 4];    // S of one tile, then its probabilities
      uint32_t p[kBK / 16][4];  // P in bf16 as wgmma A fragments
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < KT * 4; ++i) s[i] = 0.0f;
      float m_row[2] = {kNegInf, kNegInf};  // running max of rows grp, grp + 8 (raw scores)
      float l_row[2] = {0.0f, 0.0f};        // this thread's part of the running sums
      float alpha[2];
      const int64_t qpos0 = wg_start + warp * 16 + grp;
      const int64_t qpos1 = qpos0 + 8;

      auto issue_qk = [&](int st) {  // S = Q K^T, 16 columns of Dqk a step
        const uint32_t kt = ks_a + st * S::kKTileBytes;
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {
          const uint32_t col = (kk * 32) / QK::kRB, within = (kk * 32) % QK::kRB;
          const uint64_t da = wg_desc(qs_a + col * kWgBQ * QK::kRB + wg * 64 * QK::kRB + within,
                                      16, 8 * QK::kRB, QK::kLayout);
          const uint64_t db = wg_desc(kt + col * kBK * QK::kRB + within, 16, 8 * QK::kRB,
                                      QK::kLayout);
          wgmma_ss(s, da, db, kk > 0);
        }
        wgmma_commit();
      };
      auto issue_pv = [&](int st) {  // O += P V, 16 keys a step, V read N-major
        const uint32_t vt = vs_a + st * S::kVTileBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_pv<DV, V::kRB>(acc, p[kk], vt + kk * 16 * V::kRB, V::kLayout);
        }
        wgmma_commit();
      };
      // S of tile `tile` -> its probabilities in s, the rescale of what came before
      // in alpha. Scores stay in their own units (masked ones at -1e30); the
      // maxima and sums are trees, not chains
      auto softmax = [&](int64_t tile) {
        const int64_t kbase = tile * kBK;
        const bool edge = kbase + kBK > tk ||
                          (causal && kbase + kBK - 1 > wg_start) ||
                          (window > 0 && kbase <= wg_start + 63 - window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < KT * 4; ++i) {
            const int64_t kpos = kbase + (i / 4) * 8 + 2 * tig + (i & 1);
            const int64_t qpos = (i & 2) ? qpos1 : qpos0;
            bool keep = kpos < tk;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) s[i] = kNegInf;
          }
        }
        float mx[2][KT];  // row maxima, a tree over the tile's columns
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          mx[0][j] = fmaxf(s[4 * j], s[4 * j + 1]);
          mx[1][j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
        }
#pragma unroll
        for (int w = KT / 2; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) {
            mx[0][j] = fmaxf(mx[0][j], mx[0][j + w]);
            mx[1][j] = fmaxf(mx[1][j], mx[1][j + w]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m = fmaxf(m_row[r], mx[r][0]);
          m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 1));
          m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 2));
          alpha[r] = fast_exp2((m_row[r] - m) * scale_log2);
          m_row[r] = m;
        }
        // (s - m) before the scale: a masked score against a masked maximum
        // gives exactly 0, so exp2 gives 1 as in the Pallas kernel
        float sm[2][KT];
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * j + e] = fast_exp2((s[4 * j + e] - m_row[e >> 1]) * scale_log2);
          }
          sm[0][j] = s[4 * j] + s[4 * j + 1];
          sm[1][j] = s[4 * j + 2] + s[4 * j + 3];
        }
#pragma unroll
        for (int w = KT / 2; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) {
            sm[0][j] += sm[0][j + w];
            sm[1][j] += sm[1][j + w];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + sm[r][0];
      };
      // after the last P V that read p has finished: O *= alpha (skipped while
      // no row of this thread saw a new maximum), P rounded to bf16
      auto rescale_and_pack = [&]() {
        fence_regs(acc);
        fence_regs(p);
        if (alpha[0] != 1.0f || alpha[1] != 1.0f) {
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        }
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      auto advance = [&]() {
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      auto release = [&](int st) {  // this warp is done with stage st
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      };

      mbar_wait(q_full, q_phase);
      for (int64_t tile = lo; tile < wlo; ++tile) {  // before the window: released unread
        mbar_wait(full(stage), phase);
        release(stage);
        advance();
      }
      if (whi > wlo) {
        // tile wlo alone, then each step issues S of the next tile and P V of
        // this one together, and takes the softmax of the next tile while P V
        // runs: the tensor cores work while this warpgroup does the softmax
        mbar_wait(full(stage), phase);
        wgmma_fence();
        issue_qk(stage);
        wgmma_wait<0>();
        fence_regs(s);
        softmax(wlo);
        rescale_and_pack();
        int prev = stage;
        advance();
        for (int64_t tile = wlo + 1; tile < whi; ++tile) {
          mbar_wait(full(stage), phase);
          wgmma_fence();
          issue_qk(stage);
          issue_pv(prev);
          wgmma_wait<1>();  // S of this tile is in; P V of the previous may still run
          fence_regs(s);
          softmax(tile);
          wgmma_wait<0>();
          release(prev);
          rescale_and_pack();
          prev = stage;
          advance();
        }
        wgmma_fence();
        issue_pv(prev);
        wgmma_wait<0>();
        fence_regs(acc);
        release(prev);
      }
      for (int64_t tile = whi; tile < hi; ++tile) {  // past the diagonal: released unread
        mbar_wait(full(stage), phase);
        release(stage);
        advance();
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_row[r];
        l += __shfl_xor_sync(kFullMask, l, 1);
        l += __shfl_xor_sync(kFullMask, l, 2);
        const float denom = fmaxf(l, 1e-30f);
        const int64_t row = wg * 64 + warp * 16 + grp + 8 * r;
        if (row >= rows) continue;
        bf16* orow = op + (row0 + row) * so.t;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * tig) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
        }
      }
    }
    q_phase ^= 1;
  }
}

// ------------------------------------------------------- split-KV decode kernel

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecKeysPerWarp = kBK / kDecWarps;  // each warp's keys of a tile
constexpr int kDecRingBytes = 96 * 1024;          // the ring's size to aim for
constexpr int kMergeWarps = 4;                    // merge kernel: warps a block

constexpr int clamp_int(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
// the largest power of two <= most that divides n
constexpr int pow2_divisor(int n, int most) {
  int p = 1;
  while (p * 2 <= most && n % (p * 2) == 0) p *= 2;
  return p;
}

// The decode kernel's layout for R query rows (a power of two, >= g * Tq) at
// head dim DH. A key is taken by a group of kG lanes (a power of two that
// divides DH: 16 at most for Dh = 80); lane gl of the group holds elements
// (c * kG + gl) * kVW + [0, kVW) of a row for c < kNC (one shared-memory load
// each: kVW the largest power of two of at most 16 bytes that divides the
// lane's kE elements, so Dh = 80 reads pieces of 1-4 elements), so a group
// reads a row as contiguous kCB-byte pieces. K and V rows sit kRS bytes apart
// in the ring: when one load instruction of a warp spans several rows (kG *
// kCB < 128 bytes a group), the rows are padded so that their pieces fall on
// distinct banks. The ring keeps 3-8 stages of about kDecRingBytes, fewer
// where shared memory holds no 3 (float32 at Dh = 256: one 128 KB stage).
template <class T, int DH, int R>
struct Dec {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  // R x kE <= 32 where it can
  static constexpr int kG = pow2_divisor(DH, clamp_int(R * DH / 32, 4, 32));
  static constexpr int kKW = 32 / kG;                       // keys a warp takes at once
  static constexpr int kSteps = kDecKeysPerWarp / kKW;      // such steps a tile
  static constexpr int kE = DH / kG;                        // elements a lane holds of a row
  static constexpr int kVW = pow2_divisor(kE, 16 / kSize);
  static constexpr int kNC = kE / kVW;
  static constexpr int kCB = kVW * kSize;
  static constexpr int kRB = DH * kSize;
  static constexpr int kPad = kG * kCB >= 128 ? 0 : ((kG * kCB - kRB % 128) % 128 + 128) % 128;
  static constexpr int kRS = (kRB + kPad + 15) / 16 * 16;  // cp.async writes 16-byte pieces
  static_assert(kG >= 4 && kG * kE == DH && kNC * kVW == kE, "a row splits over a lane group");
  // steps whose scores are held at once: at most 32 registers of them
  static constexpr int kChunk = clamp_int(32 / R, 1, kSteps);
  static constexpr int kTileBytes = kBK * kRS;
  static constexpr int kMerge = kDecWarps * R * (DH + 2) * 4;  // the warps' partials
  static constexpr int kStagesFit = (kMaxSmemBytes - 16 * 8) / (2 * kTileBytes);
  static constexpr int kStagesWant = clamp_int(kDecRingBytes / (2 * kTileBytes), 3, 8);
  static constexpr int kStages = kStagesWant < kStagesFit ? kStagesWant : kStagesFit;
  static constexpr int kRing = kStages * 2 * kTileBytes;
  static constexpr int kBarOffset = kRing > kMerge ? kRing : kMerge;
  static constexpr size_t kBytes = kBarOffset + 16 * kStages;  // + full/empty barriers
  static_assert(kStages >= 1 && kBytes <= kMaxSmemBytes, "the ring fits in shared memory");
};

// N elements of T at p (shared memory, N * sizeof(T) <= 16 bytes, aligned to
// that size) as float32
template <class T, int N>
__device__ __forceinline__ void lds(const unsigned char* p, float* out) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (N == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
    } else if constexpr (N == 2) {
      const float2 x = *reinterpret_cast<const float2*>(p);
      out[0] = x.x, out[1] = x.y;
    } else {
      static_assert(N == 1, "float32 pieces are 4, 8 or 16 bytes");
      out[0] = *reinterpret_cast<const float*>(p);
    }
  } else if constexpr (N == 1) {  // one bf16: the high half of a float32
    out[0] = __uint_as_float(static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  } else {
    unsigned w[N / 2];
    if constexpr (N == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else if constexpr (N == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x, w[1] = x.y;
    } else {
      static_assert(N == 2, "bf16 pieces are 2, 4, 8 or 16 bytes");
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {  // a bf16 is the high half of a float32
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// 16 bytes from global to shared memory without passing registers; the
// bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// an arrival on `bar` once every cp.async this thread has issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// One block: query rows r < g * Tq (head kvh * g + r / Tq, query row r % Tq)
// of one (batch, KV head) against key tiles [s_lo, s_hi), the split's share
// of the Pallas bounds [lo, hi). Scores are in base-2 units (q carries
// scale * log2(e)); masked scores are the finite -1e30, so a fully masked
// tile weighs exp2(0) = 1 until a real score wipes it out (alpha = 0), as in
// the Pallas kernel.
// Two blocks of 128 threads an SM hold every register a thread can use, so
// the bound asks for nothing more; the 96 KB ring of the qwen3 shape keeps
// two blocks an SM resident.
template <class T, int DH, int R>
__global__ void __launch_bounds__(kDecThreads)
attn_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ ws, Strides sq, Strides sk,
                   Strides sv, Strides so, int64_t hkv, int64_t group, int64_t tq, int64_t tk,
                   int causal, int64_t window, int64_t q_offset, float scale_log2, int n_split,
                   int vec) {
  using D = Dec<T, DH, R>;
  extern __shared__ __align__(16) unsigned char dsmem[];
  const uint32_t ring_a = smem_addr(dsmem);
  const uint32_t bar_a = ring_a + D::kBarOffset;  // full[kStages], empty[kStages]
  auto full = [&](int st) { return bar_a + 8 * st; };
  auto empty = [&](int st) { return bar_a + 8 * (D::kStages + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / D::kG, gl = lane % D::kG;  // the key group and the lane in it
  const int64_t split = blockIdx.x % n_split;
  const int64_t pair = blockIdx.x / n_split;
  const int64_t bi = pair / hkv, kvh = pair % hkv;
  const int rows = static_cast<int>(group * tq);
  const int tqi = static_cast<int>(tq);

  int64_t lo, hi;
  tile_bounds(q_offset, tq, tk, causal, window, lo, hi);
  const int64_t n_vis = hi > lo ? hi - lo : 0;
  const int64_t s_lo = lo + n_vis * split / n_split;
  const int64_t s_hi = lo + n_vis * (split + 1) / n_split;
  const int64_t n = s_hi - s_lo;

  const T* kp = k + bi * sk.b + kvh * sk.h;
  const T* vp = v + bi * sv.b + kvh * sv.h;

  // this lane's slice of every scaled query row
  float qr[R][D::kE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t head = kvh * group + r / tqi, row = r % tqi;
#pragma unroll
    for (int c = 0; c < D::kNC; ++c)
#pragma unroll
      for (int e = 0; e < D::kVW; ++e) {
        const int d = (c * D::kG + gl) * D::kVW + e;
        qr[r][c * D::kVW + e] =
            r < rows ? to_float(q[bi * sq.b + head * sq.h + row * sq.t + d]) * scale_log2 : 0.0f;
      }
  }

  if (tid == 0) {
    for (int st = 0; st < D::kStages; ++st) {
      mbar_init(full(st), kDecThreads);  // every thread's copies of the stage
      mbar_init(empty(st), kDecWarps);   // every warp is done with it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // all threads copy tile `tile` into stage st and arrive on its full barrier
  auto fill = [&](int st, int64_t tile) {
    unsigned char* kd = dsmem + st * 2 * D::kTileBytes;
    unsigned char* vd = kd + D::kTileBytes;
    const int64_t kbase = tile * kBK;
    if (vec) {
      constexpr int kPieces = D::kRB / 16;  // 16-byte pieces of a row
      constexpr int kElems = 16 / D::kSize;
      for (int idx = tid; idx < kBK * kPieces; idx += kDecThreads) {
        const int c = idx / kPieces, piece = idx % kPieces;
        const int64_t kpos = kbase + c;
        const bool in = kpos < tk;
        const int64_t at = in ? kpos : 0;  // a valid address; nothing is read past Tk
        cp_async16(smem_addr(kd + c * D::kRS + piece * 16), kp + at * sk.t + piece * kElems,
                   in ? 16 : 0);
        cp_async16(smem_addr(vd + c * D::kRS + piece * 16), vp + at * sv.t + piece * kElems,
                   in ? 16 : 0);
      }
      cp_async_arrive(full(st));
    } else {  // rows not 16-byte aligned: element loads
      for (int idx = tid; idx < kBK * DH; idx += kDecThreads) {
        const int c = idx / DH, d = idx % DH;
        const int64_t kpos = kbase + c;
        T kv = from_float<T>(0.0f), vv = from_float<T>(0.0f);
        if (kpos < tk) {
          kv = kp[kpos * sk.t + d];
          vv = vp[kpos * sv.t + d];
        }
        reinterpret_cast<T*>(kd + c * D::kRS)[d] = kv;
        reinterpret_cast<T*>(vd + c * D::kRS)[d] = vv;
      }
      mbar_arrive(full(st));
    }
  };

  float m_run[R], l_run[R], acc[R][D::kE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < D::kE; ++e) acc[r][e] = 0.0f;
  }

  // this warp's keys of the tile in stage st: scores, the online softmax of
  // each chunk of steps, P V
  auto consume = [&](int st, int64_t tile) {
    const unsigned char* kt = dsmem + st * 2 * D::kTileBytes;
    const unsigned char* vt = kt + D::kTileBytes;
    const int64_t kbase = tile * kBK;
    const bool edge = kbase + kBK > tk || (causal && kbase + kBK - 1 > q_offset) ||
                      (window > 0 && kbase <= q_offset + tq - 1 - window);
#pragma unroll
    for (int c0 = 0; c0 < D::kSteps; c0 += D::kChunk) {
      float s[D::kChunk][R];
#pragma unroll
      for (int i = 0; i < D::kChunk; ++i) {
        const int key = warp * kDecKeysPerWarp + (c0 + i) * D::kKW + grp;
        float kf[D::kE];
#pragma unroll
        for (int c = 0; c < D::kNC; ++c) {
          lds<T, D::kVW>(kt + key * D::kRS + (c * D::kG + gl) * D::kCB, kf + c * D::kVW);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < D::kE; ++e) dot = fmaf(qr[r][e], kf[e], dot);
          s[i][r] = dot;
        }
      }
#pragma unroll
      for (int off = D::kG / 2; off > 0; off /= 2)  // the sums over the key's lanes
#pragma unroll
        for (int i = 0; i < D::kChunk; ++i)
#pragma unroll
          for (int r = 0; r < R; ++r) s[i][r] += __shfl_xor_sync(kFullMask, s[i][r], off);
      if (edge) {
#pragma unroll
        for (int i = 0; i < D::kChunk; ++i) {
          const int64_t kpos = kbase + warp * kDecKeysPerWarp + (c0 + i) * D::kKW + grp;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int64_t qpos = q_offset + r % tqi;
            bool keep = kpos < tk;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) s[i][r] = kNegInf;
          }
        }
      }
      // the chunk's row maxima over the warp's groups; the rescale
      float alpha[R];
      bool moved = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = s[0][r];
#pragma unroll
        for (int i = 1; i < D::kChunk; ++i) mx = fmaxf(mx, s[i][r]);
#pragma unroll
        for (int off = D::kG; off < 32; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
        const float m_new = fmaxf(m_run[r], mx);
        alpha[r] = fast_exp2(m_run[r] - m_new);
        moved = moved || m_new != m_run[r];
        m_run[r] = m_new;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < D::kChunk; ++i) {
          s[i][r] = fast_exp2(s[i][r] - m_run[r]);
          sum += s[i][r];
        }
        l_run[r] = l_run[r] * alpha[r] + sum;
      }
      if (moved) {  // warp-uniform: the maxima are the warp's
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < D::kE; ++e) acc[r][e] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < D::kChunk; ++i) {
        const int key = warp * kDecKeysPerWarp + (c0 + i) * D::kKW + grp;
        float vf[D::kE];
#pragma unroll
        for (int c = 0; c < D::kNC; ++c) {
          lds<T, D::kVW>(vt + key * D::kRS + (c * D::kG + gl) * D::kCB, vf + c * D::kVW);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < D::kE; ++e) acc[r][e] = fmaf(s[i][r], vf[e], acc[r][e]);
      }
    }
  };

  // the ring: kStages tiles in flight; a stage is refilled once every warp
  // has consumed it
  for (int st = 0; st < D::kStages && st < n; ++st) fill(st, s_lo + st);
  for (int64_t j = 0; j < n; ++j) {
    const int st = static_cast<int>(j % D::kStages);
    const uint32_t parity = static_cast<uint32_t>(j / D::kStages) & 1;
    mbar_wait(full(st), parity);
    consume(st, s_lo + j);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
    if (j + D::kStages < n) {
      mbar_wait(empty(st), parity);
      fill(st, s_lo + j + D::kStages);
    }
  }

  // the warp's partial sums over its groups, then the warps merged
#pragma unroll
  for (int off = D::kG; off < 32; off *= 2)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l_run[r] += __shfl_xor_sync(kFullMask, l_run[r], off);
#pragma unroll
      for (int e = 0; e < D::kE; ++e) acc[r][e] += __shfl_xor_sync(kFullMask, acc[r][e], off);
    }
  __syncthreads();  // every warp is past its last tile: the ring is free
  float* red_o = reinterpret_cast<float*>(dsmem);  // [warp][R][DH]
  float* red_m = red_o + kDecWarps * R * DH;       // [warp][R]
  float* red_l = red_m + kDecWarps * R;
  if (lane < D::kG) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < D::kNC; ++c)
#pragma unroll
        for (int e = 0; e < D::kVW; ++e) {
          red_o[(warp * R + r) * DH + (c * D::kG + gl) * D::kVW + e] = acc[r][c * D::kVW + e];
        }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      red_m[warp * R + r] = m_run[r];
      red_l[warp * R + r] = l_run[r];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * DH; idx += kDecThreads) {
    const int r = idx / DH, d = idx % DH;
    float m = red_m[r];
    for (int w = 1; w < kDecWarps; ++w) m = fmaxf(m, red_m[w * R + r]);
    float l = 0.0f, acc_d = 0.0f;
    for (int w = 0; w < kDecWarps; ++w) {
      const float a = fast_exp2(red_m[w * R + r] - m);
      l += a * red_l[w * R + r];
      acc_d += a * red_o[(w * R + r) * DH + d];
    }
    if (n_split == 1) {
      const int64_t head = kvh * group + r / tqi, row = r % tqi;
      o[bi * so.b + head * so.h + row * so.t + d] = from_float<T>(acc_d / fmaxf(l, 1e-30f));
    } else {  // the split's partial: [pair][row][split] (m, l) and [..][DH] o
      const int64_t at = (pair * rows + r) * n_split + split;
      const int64_t parts = static_cast<int64_t>(gridDim.x) * rows;  // (pair, row, split)s
      ws[at * DH + d] = acc_d;
      if (d == 0) {
        ws[parts * DH + at] = n > 0 ? m : -INFINITY;  // an empty share: m = -inf, l = o = 0
        ws[parts * (DH + 1) + at] = l;
      }
    }
  }
}

// One warp a query row: the splits' partials merged by the reference's
// gqa_flash_decode rule (pmax / psum), in base 2; splits with m = -inf (an
// empty share) weigh 0.
template <class T, int DH>
__global__ void __launch_bounds__(32 * kMergeWarps)
attn_merge_kernel(const float* __restrict__ ws, T* __restrict__ o, Strides so, int64_t hkv,
                  int64_t group, int64_t tq, int64_t rows_total, int n_split) {
  constexpr int kPer = (DH + 31) / 32;  // output columns a lane (the last ones past Dh = 80)
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows_total) return;
  const int64_t parts = rows_total * n_split;
  const float* wo = ws + row * n_split * DH;
  const float* wm = ws + parts * DH + row * n_split;
  const float* wl = ws + parts * (DH + 1) + row * n_split;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, wm[s]);
  float l = 0.0f, acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float a = wm[s] == -INFINITY ? 0.0f : exp2f(wm[s] - m);
    l += a * wl[s];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (lane + 32 * j < DH) acc[j] += a * wo[s * DH + lane + 32 * j];
    }
  }
  const int64_t rows = group * tq;
  const int64_t pair = row / rows, r = row % rows;
  const int64_t bi = pair / hkv, head = (pair % hkv) * group + r / tq, t = r % tq;
  T* op = o + bi * so.b + head * so.h + t * so.t;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (lane + 32 * j < DH) op[lane + 32 * j] = from_float<T>(acc[j] / denom);
  }
}

// ------------------------------------------------------ latent decode kernel

constexpr int kLatBR = 64;    // query rows a block: a 16 x 16 grid of threads, 4 rows each
constexpr int kLatDVS = 128;  // output columns a block, at most

// The latent kernel's layout at (DQK, DV): the block's query rows resident in
// shared memory (float32, scaled, padded rows), the keys staged kKC columns
// at a time (a 64-key tile's chunk of the score sum), the block's kDVS value
// columns of the tile, the probabilities (over the key chunk's space once the
// scores are taken) and the per-row statistics.
template <int DQK, int DV>
struct Lat {
  static constexpr int kKC = DQK % 64 == 0 ? 64 : DQK;  // key columns staged at once
  static constexpr int kDVS = DV < kLatDVS ? DV : kLatDVS;
  static constexpr int kSlices = DV / kDVS;  // the grid's output-column slices
  static_assert(DQK % kKC == 0 && DV % kDVS == 0 && kDVS % 16 == 0,
                "whole key chunks and whole 16-column output steps");
  static constexpr int kQS = DQK + 1;
  static constexpr int kKS = kKC + 1;
  static constexpr int kKRegion = (kBK * kKS > kLatBR * kPS) ? kBK * kKS : kLatBR * kPS;
  static constexpr int kFloats = kLatBR * kQS + kKRegion + kBK * kDVS + 3 * kLatBR;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kBytes <= kMaxSmemBytes, "the query rows and a tile fit in shared memory");
};

// One block: query rows [rt * 64, rt * 64 + 64) of the g * Tq rows of one
// (batch, KV head) (row r is head kvh * g + r / Tq, query row r % Tq), output
// columns [slice * kDVS, + kDVS), key tiles [s_lo, s_hi): the split's share of
// the Pallas bounds, as in attn_decode_kernel. Scores in base-2 units (q
// carries sm_scale * log2(e)); with n_split > 1 the split's (m, l, o) go to the
// workspace in attn_decode_kernel's layout (m and l from slice 0), for
// attn_merge_kernel.
template <class T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
attn_latent_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ ws, Strides sq, Strides sk,
                   Strides sv, Strides so, int64_t hkv, int64_t group, int64_t tq, int64_t tk,
                   int causal, int64_t window, int64_t q_offset, float scale_log2,
                   int n_split) {
  using L = Lat<DQK, DV>;
  constexpr int RM = kLatBR / 16;  // rows per thread
  constexpr int CN = kBK / 16;     // score columns per thread
  constexpr int DN = L::kDVS / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [kLatBR][DQK + 1], scaled queries
  float* ks = qs + kLatBR * L::kQS;    // [kBK][kKC + 1] a key chunk, then [kLatBR][kPS] probabilities
  float* ps = ks;
  float* vs = ks + L::kKRegion;        // [kBK][kDVS] the slice's values
  float* m_s = vs + kBK * L::kDVS;     // running max per row
  float* l_s = m_s + kLatBR;           // running denominator per row
  float* a_s = l_s + kLatBR;           // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t rows = group * tq;
  const int64_t row_tiles = (rows + kLatBR - 1) / kLatBR;
  int64_t idx = blockIdx.x;  // ((pair * row_tiles + rt) * kSlices + slice) * n_split + split
  const int64_t split = idx % n_split;
  idx /= n_split;
  const int slice = static_cast<int>(idx % L::kSlices);
  idx /= L::kSlices;
  const int64_t rt = idx % row_tiles;
  const int64_t pair = idx / row_tiles;
  const int64_t bi = pair / hkv, kvh = pair % hkv;
  const int col0 = slice * L::kDVS;
  const int64_t row0 = rt * kLatBR;

  int64_t lo, hi;
  tile_bounds(q_offset, tq, tk, causal, window, lo, hi);
  const int64_t n_vis = hi > lo ? hi - lo : 0;
  const int64_t s_lo = lo + n_vis * split / n_split;
  const int64_t s_hi = lo + n_vis * (split + 1) / n_split;

  const T* kp = k + bi * sk.b + kvh * sk.h;
  const T* vp = v + bi * sv.b + kvh * sv.h;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_k = reinterpret_cast<uintptr_t>(kp) % 16 == 0 && sk.t % kVec == 0;
  const bool vec_v = reinterpret_cast<uintptr_t>(vp) % 16 == 0 && sv.t % kVec == 0;

  for (int i = tid; i < kLatBR * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK;
    const int64_t row = row0 + r;
    float x = 0.0f;
    if (row < rows) {
      const int64_t head = kvh * group + row / tq, t = row % tq;
      x = to_float(q[bi * sq.b + head * sq.h + t * sq.t + d]) * scale_log2;
    }
    qs[r * L::kQS + d] = x;
  }
  for (int r = tid; r < kLatBR; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.0f;

  for (int64_t tile = s_lo; tile < s_hi; ++tile) {
    const int64_t kbase = tile * kBK;
    __syncthreads();  // the previous tile's probabilities and values are consumed
    stage_tile<L::kDVS>(vp, sv.t, kbase, tk, col0, vec_v, vs, L::kDVS, tid);
    // scores of rows ty + 16 i against keys tx + 16 j, a key chunk at a time
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
    for (int c0 = 0; c0 < DQK; c0 += L::kKC) {
      if (c0 > 0) __syncthreads();  // every thread is done with the previous chunk
      stage_tile<L::kKC>(kp, sk.t, kbase, tk, c0, vec_k, ks, L::kKS, tid);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < L::kKC; ++d) {
        float qv[RM], kv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) qv[i] = qs[(ty + 16 * i) * L::kQS + c0 + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) kv[j] = ks[(tx + 16 * j) * L::kKS + d];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    __syncthreads();  // every thread is done with the keys: ps may overwrite them
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      const int64_t qpos = q_offset + (row0 + r) % tq;
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

    // online softmax in base 2, one warp per row
    for (int r = warp; r < kLatBR; r += kThreads / 32) {
      float* row = ps + r * kPS;
      const float s0 = row[lane], s1 = row[lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mt = fmaxf(mt, __shfl_xor_sync(kFullMask, mt, off));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mt);
      const float p0 = exp2f(s0 - m_cur), p1 = exp2f(s1 - m_cur);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(kFullMask, sum, off);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_cur);
        m_s[r] = m_cur;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, rows ty + 16 i, slice columns tx + 16 j
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
      for (int j = 0; j < DN; ++j) vv[j] = vs[c * L::kDVS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // m_s and l_s hold the last tile's statistics

  const int64_t pairs = static_cast<int64_t>(gridDim.x) / (row_tiles * L::kSlices * n_split);
  const int64_t parts = pairs * rows * n_split;  // (pair, row, split)s of the workspace
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    const int64_t row = row0 + r;
    if (row >= rows) continue;
    if (n_split == 1) {
      const int64_t head = kvh * group + row / tq, t = row % tq;
      T* op = o + bi * so.b + head * so.h + t * so.t + col0;
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DN; ++j) op[tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    } else {  // the split's partial: [pair][row][split] (m, l) and [..][DV] o
      const int64_t at = (pair * rows + row) * n_split + split;
#pragma unroll
      for (int j = 0; j < DN; ++j) ws[at * DV + col0 + tx + 16 * j] = acc[i][j];
      if (slice == 0 && tx == 0) {
        ws[parts * DV + at] = s_hi > s_lo ? m_s[r] : -INFINITY;  // an empty share weighs 0
        ws[parts * (DV + 1) + at] = l_s[r];
      }
    }
  }
}

// --------------------------------------------- latent decode on the tensor cores

constexpr int kLwBR = 64;                            // query rows a block: one wgmma M tile
constexpr int kLwConsumers = 2;                      // consumer warpgroups, Dv / 2 columns each
constexpr int kLwThreads = 128 * (kLwConsumers + 1);  // + one producer warpgroup
constexpr int kLwStages = 2;                           // latent tiles in the ring
constexpr int kLwPParts = 3;  // bf16 wgmma operands that sum to P: its 24 bits
// setmaxnreg: the launch gives every thread 168 registers (12 warps, 3 on
// each sub-partition's 16,384); the consumers take from the pool only what
// the producer gives back: 128 x (168 - 24) = 256 x (240 - 168)
constexpr int kLwProducerRegs = 24;
constexpr int kLwConsumerRegs = 240;

// The latent_wgmma kernel's shared memory at (DQK, DV): the block's Q tile
// (kLwBR rows) and kLwStages latent tiles of kBK keys, all DQK wide in
// WgRow<DQK>'s layout (column blocks of 64 columns one after another, 128-byte
// swizzle), then the full/empty barriers. The value is the tile's first DV
// columns, whole column blocks: each consumer warpgroup reads kCols of them.
template <int DQK, int DV>
struct LatWg {
  using R = WgRow<DQK>;
  static constexpr int kCols = DV / kLwConsumers;  // output columns a warpgroup
  static constexpr int kQBytes = kLwBR * DQK * 2;
  static constexpr int kTileBytes = kBK * DQK * 2;
  static constexpr int kBlockBytes = kBK * R::kRB;  // one column block (TMA box) of a tile
  static constexpr size_t kBytes = kQBytes + kLwStages * kTileBytes + 8 * 2 * kLwStages + 1024;
  static_assert(R::kRB == 128 && kCols == 256,
                "128-byte rows; P V as wgmma_pv<256>'s two n128 a warpgroup");
  static_assert(kBytes <= kMaxSmemBytes, "Q and the latent ring fit in shared memory");
};

// One block: query rows [rt * 64, rt * 64 + 64) of the g * Tq rows of one
// (batch, KV head) (row r is head kvh * g + r / Tq, query row r % Tq), all DV
// output columns, key tiles [s_lo, s_hi) (the split's share of the Pallas
// bounds, as in attn_decode_kernel). Grid x: ((pair * n_split + split) *
// row_tiles + rt), so a share's row tiles run on adjacent blocks. The key is
// the latent row (k_map, DQK wide), the value its first DV columns. Scores
// stay in their own units (masked ones -1e30), scale_log2 folded into the
// exponent; with n_split > 1 the split's (m in base 2, l, unnormalised o) go
// to the workspace in attn_decode_kernel's layout, for attn_merge_kernel.
template <int DQK, int DV>
__global__ void __launch_bounds__(kLwThreads, 1)
attn_latent_wgmma_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap k_map,
                         bf16* __restrict__ o, float* __restrict__ ws, Strides sq, Strides so,
                         int64_t hkv, int64_t group, int64_t tq, int64_t tk, int causal,
                         int64_t window, int64_t q_offset, float scale_log2, int n_split) {
  using L = LatWg<DQK, DV>;
  using R = typename L::R;
  constexpr int KT = kBK / 8;  // 8-key column tiles of S
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t qs_a = smem_addr(base);                      // [kLwBR rows]
  const uint32_t ks_a = qs_a + L::kQBytes;                    // [kLwStages][kBK rows]
  const uint32_t bar_a = ks_a + kLwStages * L::kTileBytes;    // full[S], empty[S]
  auto full = [&](int s) { return bar_a + 8 * s; };
  auto empty = [&](int s) { return bar_a + 8 * (kLwStages + s); };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int64_t rows = group * tq;
  const int64_t row_tiles = (rows + kLwBR - 1) / kLwBR;
  const int64_t rt = blockIdx.x % row_tiles;
  const int64_t split = (blockIdx.x / row_tiles) % n_split;
  const int64_t pair = blockIdx.x / row_tiles / n_split;
  const int64_t bi = pair / hkv, kvh = pair % hkv;
  const int64_t row0 = rt * kLwBR;

  int64_t lo, hi;
  tile_bounds(q_offset, tq, tk, causal, window, lo, hi);
  const int64_t n_vis = hi > lo ? hi - lo : 0;
  const int64_t s_lo = lo + n_vis * split / n_split;
  const int64_t s_hi = lo + n_vis * (split + 1) / n_split;

  // the Q tile, 16 bytes a thread, written as TMA would write it (chunk c of
  // row r of a column block at c ^ (r % 8)); zero past the g * Tq rows
  constexpr int kPieces = DQK / 8;  // 16-byte pieces of a row
  for (int i = tid; i < kLwBR * kPieces; i += kLwThreads) {
    const int r = i / kPieces, c = i % kPieces;
    const int64_t row = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int64_t head = kvh * group + row / tq, t = row % tq;
      x = __ldg(reinterpret_cast<const uint4*>(q + bi * sq.b + head * sq.h + t * sq.t + c * 8));
    }
    *reinterpret_cast<uint4*>(base + (c / 8) * (kLwBR * R::kRB) + r * R::kRB +
                              ((c % 8) ^ (r % 8)) * 16) = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's reads
  if (tid == 0) {
    for (int s = 0; s < kLwStages; ++s) {
      mbar_init(full(s), 1);                  // the producer's expect-tx arrival
      mbar_init(empty(s), 4 * kLwConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the roles never meet again, so setmaxnreg can move the registers
  if (wg == kLwConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLwProducerRegs));
    // one thread: the share's latent tiles into the ring as fast as the
    // consumers free stages; TMA zero-fills rows past Tk
    if (tid == kLwConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t tile = s_lo; tile < s_hi; ++tile) {
        mbar_wait(empty(stage), phase ^ 1);  // a fresh ring passes the first lap
        mbar_expect_tx(full(stage), L::kTileBytes);
        const uint32_t dst = ks_a + stage * L::kTileBytes;
        for (int cb = 0; cb < R::kBoxes; ++cb) {
          tma_load_4d(dst + cb * L::kBlockBytes, &k_map, full(stage), cb * (R::kRB / 2),
                      static_cast<int>(tile * kBK), static_cast<int>(kvh), static_cast<int>(bi));
        }
        if (++stage == kLwStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kLwConsumerRegs));
    float acc[L::kCols / 2];  // O, 64 x kCols: rows grp (+8) of each warp's 16
    float s[KT * 4];          // S of one tile, then its probabilities
    // P as kLwPParts bf16 wgmma A fragments that sum to it (8 bits each)
    uint32_t p[kLwPParts][kBK / 16][4];
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < KT * 4; ++i) s[i] = 0.0f;
    float m_row[2] = {kNegInf, kNegInf};  // running max of rows grp, grp + 8 (raw scores)
    float l_row[2] = {0.0f, 0.0f};        // this thread's part of the running sums
    float alpha[2];
    const int r0 = warp * 16 + grp;  // the thread's first row in the block
    const int64_t qpos0 = q_offset + (row0 + r0) % tq;
    const int64_t qpos1 = q_offset + (row0 + r0 + 8) % tq;
    // the warpgroup's value columns: column blocks [wg * kCols / 64, ...) of the tile
    const uint32_t v_off = wg * (L::kCols / 64) * L::kBlockBytes;

    auto issue_qk = [&](int st) {  // S = Q K^T over the 576 columns, 16 a step
      const uint32_t kt = ks_a + st * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t col = (kk * 32) / R::kRB, within = (kk * 32) % R::kRB;
        const uint64_t da =
            wg_desc(qs_a + col * kLwBR * R::kRB + within, 16, 8 * R::kRB, R::kLayout);
        const uint64_t db = wg_desc(kt + col * L::kBlockBytes + within, 16, 8 * R::kRB,
                                    R::kLayout);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {  // O += P V, 16 keys a step, the tile's columns N-major
      const uint32_t vt = ks_a + st * L::kTileBytes + v_off;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int part = 0; part < kLwPParts; ++part) {
          wgmma_pv<L::kCols, R::kRB>(acc, p[part][kk], vt + kk * 16 * R::kRB, R::kLayout);
        }
      wgmma_commit();
    };
    // the masks, the online softmax of the tile (trees for the maxima and
    // sums), O rescaled (skipped while no row of the thread saw a new
    // maximum) and P split into its bf16 parts
    auto softmax = [&](int64_t tile) {
      const int64_t kbase = tile * kBK;
      const bool edge = kbase + kBK > tk || (causal && kbase + kBK - 1 > q_offset) ||
                        (window > 0 && kbase <= q_offset + tq - 1 - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < KT * 4; ++i) {
          const int64_t kpos = kbase + (i / 4) * 8 + 2 * tig + (i & 1);
          const int64_t qpos = (i & 2) ? qpos1 : qpos0;
          bool keep = kpos < tk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          if (!keep) s[i] = kNegInf;
        }
      }
      float mx[2][KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        mx[0][j] = fmaxf(s[4 * j], s[4 * j + 1]);
        mx[1][j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
      }
#pragma unroll
      for (int w = KT / 2; w > 0; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) {
          mx[0][j] = fmaxf(mx[0][j], mx[0][j + w]);
          mx[1][j] = fmaxf(mx[1][j], mx[1][j + w]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = fmaxf(m_row[r], mx[r][0]);
        m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 1));
        m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 2));
        alpha[r] = fast_exp2((m_row[r] - m) * scale_log2);
        m_row[r] = m;
      }
      float sm[2][KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = fast_exp2((s[4 * j + e] - m_row[e >> 1]) * scale_log2);
        }
        sm[0][j] = s[4 * j] + s[4 * j + 1];
        sm[1][j] = s[4 * j + 2] + s[4 * j + 3];
      }
#pragma unroll
      for (int w = KT / 2; w > 0; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) {
          sm[0][j] += sm[0][j + w];
          sm[1][j] += sm[1][j + w];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + sm[r][0];
      if (alpha[0] != 1.0f || alpha[1] != 1.0f) {
#pragma unroll
        for (int i = 0; i < L::kCols / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = s[8 * kk + 2 * e], b = s[8 * kk + 2 * e + 1];
#pragma unroll
          for (int part = 0; part < kLwPParts; ++part) {
            // a in the low half; a bf16 is the top half of a float
            const uint32_t w = pack_bf16(a, b);
            p[part][kk][e] = w;
            a -= __uint_as_float(w << 16);
            b -= __uint_as_float(w & 0xffff0000u);
          }
        }
    };

    // a tile: S, its softmax, P V, then the stage goes back to the producer;
    // the ring's other stage is loading the next tile meanwhile
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t tile = s_lo; tile < s_hi; ++tile) {
      mbar_wait(full(stage), phase);
      wgmma_fence();
      issue_qk(stage);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(tile);
      wgmma_fence();
      issue_pv(stage);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
      if (++stage == kLwStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const int64_t pairs = static_cast<int64_t>(gridDim.x) / (row_tiles * n_split);
    const int64_t parts = pairs * rows * n_split;  // (pair, row, split)s of the workspace
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_row[r];
      l += __shfl_xor_sync(kFullMask, l, 1);
      l += __shfl_xor_sync(kFullMask, l, 2);
      const int64_t row = row0 + r0 + 8 * r;
      if (row >= rows) continue;
      if (n_split == 1) {
        const int64_t head = kvh * group + row / tq, t = row % tq;
        bf16* orow = o + bi * so.b + head * so.h + t * so.t + wg * L::kCols;
        const float denom = fmaxf(l, 1e-30f);
#pragma unroll
        for (int j = 0; j < L::kCols / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * tig) = __floats2bfloat162_rn(
              acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
        }
      } else {  // the split's partial: [pair][row][split] (m, l) and [..][DV] o
        const int64_t at = (pair * rows + row) * n_split + split;
        float* wrow = ws + at * DV + wg * L::kCols;
#pragma unroll
        for (int j = 0; j < L::kCols / 8; ++j) {
          *reinterpret_cast<float2*>(wrow + j * 8 + 2 * tig) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
        if (wg == 0 && tig == 0) {
          // m in base 2, as the merge takes it; an empty share weighs 0
          ws[parts * DV + at] = s_hi > s_lo ? m_row[r] * scale_log2 : -INFINITY;
          ws[parts * (DV + 1) + at] = l;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launchers

dim3 grid_of(int64_t head_blocks, int64_t q_tiles) {
  const int64_t y = q_tiles < kMaxGridY ? q_tiles : kMaxGridY;  // a block loops past 65,535
  return dim3(static_cast<unsigned>(head_blocks), static_cast<unsigned>(y));
}

template <class T, int DQK, int DV, int BQ>
int launch_fma(const void* q, const void* k, const void* v, void* o, const int64_t* st,
               int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int causal,
               int64_t window, int64_t q_offset, float sm_scale, cudaStream_t stream) {
  using S = Smem<DQK, DV, BQ>;
  auto kernel = attn_kernel<T, DQK, DV, BQ>;
  // set once, before any launch (and so before any CUDA-graph capture)
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kBytes));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int64_t head_blocks = batch * hq;
  if (head_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t q_tiles = (tq + BQ - 1) / BQ;
  kernel<<<grid_of(head_blocks, q_tiles), kThreads, S::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, hq, hq / hkv, tq, tk,
      causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// whether the K/V rows of every (batch, KV head) start on 16 bytes: what
// the decode kernel's cp.async copies need (st: element strides of k then v)
template <class T>
bool rows_aligned(const void* k, const void* v, const int64_t* st) {
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0) return false;
  for (int i = 0; i < 6; ++i) {
    if (st[i] * static_cast<int64_t>(sizeof(T)) % 16 != 0) return false;
  }
  return true;
}

// the decode kernel instance for R rows, its shared memory size set once
template <class T, int DH, int R>
cudaError_t configure_decode() {
  static const cudaError_t configured =
      cudaFuncSetAttribute(attn_decode_kernel<T, DH, R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Dec<T, DH, R>::kBytes));
  return configured;
}

// blocks of the instance for R rows that one SM holds at once
template <class T, int DH, int R>
int decode_occupancy(int* blocks) {
  const cudaError_t configured = configure_decode<T, DH, R>();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_decode_kernel<T, DH, R>, kDecThreads, Dec<T, DH, R>::kBytes));
}

// the merge of n_split > 1 shares' partials (ws) into o, on the same stream
template <class T, int DV>
int launch_merge(float* workspace, void* o, const Strides& so, int64_t batch, int64_t hkv,
                 int64_t group, int64_t tq, int n_split, cudaStream_t stream) {
  const int64_t rows_total = batch * hkv * group * tq;  // one warp a query row
  const int64_t merge_blocks = (rows_total + kMergeWarps - 1) / kMergeWarps;
  if (merge_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  attn_merge_kernel<T, DV><<<static_cast<unsigned>(merge_blocks), 32 * kMergeWarps, 0, stream>>>(
      workspace, static_cast<T*>(o), so, hkv, group, tq, rows_total, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int DH, int R>
int launch_decode_rows(const void* q, const void* k, const void* v, void* o, const int64_t* st,
                       int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
                       int causal, int64_t window, int64_t q_offset, float sm_scale,
                       float* workspace, int n_split, cudaStream_t stream) {
  using D = Dec<T, DH, R>;
  auto kernel = attn_decode_kernel<T, DH, R>;
  const cudaError_t configured = configure_decode<T, DH, R>();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int64_t blocks = batch * hkv * n_split;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t group = hq / hkv;
  const Strides so{st[9], st[10], st[11]};
  kernel<<<static_cast<unsigned>(blocks), kDecThreads, D::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), workspace, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]}, so, hkv, group, tq, tk,
      causal, window, q_offset, sm_scale * kLog2e, n_split,
      rows_aligned<T>(k, v, st + 3) ? 1 : 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return launch_merge<T, DH>(workspace, o, so, batch, hkv, group, tq, n_split, stream);
}

// the decode kernel instance whose row capacity R (a power of two) is the
// least that holds the g * Tq query rows of a KV head
template <class T, int DH>
int launch_decode(const void* q, const void* k, const void* v, void* o, const int64_t* st,
                  int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int causal,
                  int64_t window, int64_t q_offset, float sm_scale, float* workspace,
                  int n_split, cudaStream_t stream) {
  const int64_t rows = (hq / hkv) * tq;
  auto go = [&](auto launcher) {
    return launcher(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window, q_offset, sm_scale,
                    workspace, n_split, stream);
  };
  if (rows <= 1) return go(launch_decode_rows<T, DH, 1>);
  if (rows <= 2) return go(launch_decode_rows<T, DH, 2>);
  if (rows <= 4) return go(launch_decode_rows<T, DH, 4>);
  if (rows <= 8) return go(launch_decode_rows<T, DH, 8>);
  if (rows <= 16) return go(launch_decode_rows<T, DH, 16>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// decode_occupancy of the instance launch_decode picks for g * Tq = rows
template <class T, int DH>
int decode_occupancy_rows(int64_t rows, int* blocks) {
  if (rows <= 1) return decode_occupancy<T, DH, 1>(blocks);
  if (rows <= 2) return decode_occupancy<T, DH, 2>(blocks);
  if (rows <= 4) return decode_occupancy<T, DH, 4>(blocks);
  if (rows <= 8) return decode_occupancy<T, DH, 8>(blocks);
  if (rows <= 16) return decode_occupancy<T, DH, 16>(blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the latent kernel's shared memory size, set once
template <class T, int DQK, int DV>
cudaError_t configure_latent() {
  static const cudaError_t configured =
      cudaFuncSetAttribute(attn_latent_kernel<T, DQK, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Lat<DQK, DV>::kBytes));
  return configured;
}

// blocks of the latent kernel that one SM holds at once
template <class T, int DQK, int DV>
int latent_occupancy(int* blocks) {
  const cudaError_t configured = configure_latent<T, DQK, DV>();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_latent_kernel<T, DQK, DV>, kThreads, Lat<DQK, DV>::kBytes));
}

// the latent kernel: (batch, KV head) x row tiles of 64 x output slices x
// splits on grid x; with n_split > 1 the merge on the same stream
template <class T, int DQK, int DV>
int launch_latent(const void* q, const void* k, const void* v, void* o, const int64_t* st,
                  int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int causal,
                  int64_t window, int64_t q_offset, float sm_scale, float* workspace,
                  int n_split, cudaStream_t stream) {
  using L = Lat<DQK, DV>;
  const cudaError_t configured = configure_latent<T, DQK, DV>();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int64_t group = hq / hkv;
  const int64_t row_tiles = (group * tq + kLatBR - 1) / kLatBR;
  const int64_t blocks = batch * hkv * row_tiles * L::kSlices * n_split;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Strides so{st[9], st[10], st[11]};
  attn_latent_kernel<T, DQK, DV><<<static_cast<unsigned>(blocks), kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), workspace, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]}, so, hkv, group, tq, tk,
      causal, window, q_offset, sm_scale * kLog2e, n_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return launch_merge<T, DV>(workspace, o, so, batch, hkv, group, tq, n_split, stream);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a [B, H, T, COLS] bf16 view (element strides st[0..2]: batch, head, row) as
// a 4-D tensor map of boxes of box_rows rows x kRB / 2 columns, swizzled like
// WgRow<COLS>
template <int COLS>
bool make_map(CUtensorMap* map, const void* ptr, const int64_t* st, int64_t batch,
              int64_t heads, int64_t rows, uint32_t box_rows) {
  using R = WgRow<COLS>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {COLS, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {R::kRB / 2, box_rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                R::kRB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : (R::kRB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, const int64_t* st,
              int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int causal,
              int64_t window, int64_t q_offset, float sm_scale, cudaStream_t stream) {
  using S = WgSmem<DQK, DV>;
  auto kernel = attn_wgmma_kernel<DQK, DV>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kBytes));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  int64_t strides = 0;
  for (int i = 0; i < 12; ++i) strides |= st[i];
  if (bases % 16 != 0 || strides % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t head_blocks = batch * hq;
  if (head_blocks > 0x7fffffff || tq > 0x7fffffff || tk > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap q_map, k_map, v_map;
  const int64_t kv_rows = tk > 0 ? tk : 1;  // no tile is read when Tk = 0
  if (!make_map<DQK>(&q_map, q, st, batch, hq, tq, 64) ||
      !make_map<DQK>(&k_map, k, st + 3, batch, hkv, kv_rows, kBK) ||
      !make_map<DV>(&v_map, v, st + 6, batch, hkv, kv_rows, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t q_tiles = (tq + kWgBQ - 1) / kWgBQ;
  kernel<<<grid_of(head_blocks, q_tiles), kWgThreads, S::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), Strides{st[9], st[10], st[11]}, hq, hq / hkv,
      tq, tk, causal, window, q_offset, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// the latent_wgmma kernel's shared memory size, set once
template <int DQK, int DV>
cudaError_t configure_latent_wgmma() {
  static const cudaError_t configured =
      cudaFuncSetAttribute(attn_latent_wgmma_kernel<DQK, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(LatWg<DQK, DV>::kBytes));
  return configured;
}

// blocks of the latent_wgmma kernel that one SM holds at once
template <int DQK, int DV>
int latent_wgmma_occupancy(int* blocks) {
  const cudaError_t configured = configure_latent_wgmma<DQK, DV>();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_latent_wgmma_kernel<DQK, DV>, kLwThreads, LatWg<DQK, DV>::kBytes));
}

// the latent decode on the tensor cores: (batch, KV head) x splits x row
// tiles of 64 on grid x; with n_split > 1 the merge on the same stream. v must
// be the first DV columns of k (the same base and strides): the kernel reads
// the value from the key's tile
template <int DQK, int DV>
int launch_latent_wgmma(const void* q, const void* k, const void* v, void* o, const int64_t* st,
                        int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
                        int causal, int64_t window, int64_t q_offset, float sm_scale,
                        float* workspace, int n_split, cudaStream_t stream) {
  using L = LatWg<DQK, DV>;
  const cudaError_t configured = configure_latent_wgmma<DQK, DV>();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (v != k || st[6] != st[3] || st[7] != st[4] || st[8] != st[5]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(o);
  int64_t strides = 0;
  for (int i = 0; i < 12; ++i) strides |= st[i];
  if (bases % 16 != 0 || strides % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t group = hq / hkv;
  const int64_t row_tiles = (group * tq + kLwBR - 1) / kLwBR;
  const int64_t blocks = batch * hkv * n_split * row_tiles;
  if (blocks > 0x7fffffff || tk > 0x7fffffff || batch > 0x7fffffff || hkv > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap k_map;
  if (!make_map<DQK>(&k_map, k, st + 3, batch, hkv, tk > 0 ? tk : 1, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides so{st[9], st[10], st[11]};
  attn_latent_wgmma_kernel<DQK, DV><<<static_cast<unsigned>(blocks), kLwThreads, L::kBytes,
                                      stream>>>(
      static_cast<const bf16*>(q), k_map, static_cast<bf16*>(o), workspace,
      Strides{st[0], st[1], st[2]}, so, hkv, group, tq, tk, causal, window, q_offset,
      sm_scale * kLog2e, n_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return launch_merge<bf16, DV>(workspace, o, so, batch, hkv, group, tq, n_split, stream);
}

}  // namespace
