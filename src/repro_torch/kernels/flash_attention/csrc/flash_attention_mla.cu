// The attention kernels at MLA's (Dqk, Dv) pairs, where the query and key are
// wider than the value (deepseek-v2-236b's multi-head latent attention): a
// library of its own, built by its own nvcc beside flash_attention.cu (the
// templates and their design: flash_attention.cuh). Only the variants each
// pair's calls take are built:
//
//   (192, 128)  prefill, 128 nope + 64 rope query/key columns, 128 value
//               columns: wgmma_bf16 (QK^T as three k64 blocks of 128-byte
//               swizzle, P V as one n128), fma (float32 and unaligned bf16)
//               and decode_latent (prompts of Tq <= 16);
//   (576, 512)  the absorbed decode step: 128 query heads on one latent KV
//               head, a 512 latent + 64 rope key whose first 512 columns are
//               the value: latent_wgmma (bf16, aligned, the value a view of
//               the key; tensor cores, one TMA-staged tile for both
//               products) and decode_latent (float32, unaligned bf16);
//   (48, 32)    the reduced config's pair, for both: fma and decode_latent.
//
// decode_latent in float32 and bf16 at each of its pairs, fma likewise;
// latent_wgmma in bf16 at (576, 512) alone. Bound: a latent decode step over a
// 32k cache at B=8 reads 302 MB of cache (0.09 ms at 3.35 TB/s); latent_wgmma
// takes its 73 GFLOP of products on the tensor cores (0.074 ms at 989
// TFLOP/s), decode_latent in float32 FMA, which cost far more (PERF.md).
#include "flash_attention.cuh"

namespace {

template <class T, int DQK, int DV>
int launch_pair(int variant, const void* q, const void* k, const void* v, void* o,
                const int64_t* st, int64_t batch, int64_t hq, int64_t hkv, int64_t tq,
                int64_t tk, int causal, int64_t window, int64_t q_offset, float sm_scale,
                float* workspace, int n_split, cudaStream_t stream) {
  constexpr bool kPrefill = DQK != 576;  // (576, 512) is the decode step's pair alone
  if (variant == kDecodeLatent) {
    return launch_latent<T, DQK, DV>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window,
                                     q_offset, sm_scale, workspace, n_split, stream);
  }
  if constexpr (kPrefill) {
    if (variant == kFma) {
      return launch_fma<T, DQK, DV, 64>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window,
                                        q_offset, sm_scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class T>
int launch_mla(int variant, int dqk, int dv, const void* q, const void* k, const void* v,
               void* o, const int64_t* st, int64_t batch, int64_t hq, int64_t hkv, int64_t tq,
               int64_t tk, int causal, int64_t window, int64_t q_offset, float sm_scale,
               float* workspace, int n_split, cudaStream_t stream) {
  if (dqk == 192 && dv == 128) {
    return launch_pair<T, 192, 128>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, workspace, n_split, stream);
  }
  if (dqk == 576 && dv == 512) {
    return launch_pair<T, 576, 512>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, workspace, n_split, stream);
  }
  if (dqk == 48 && dv == 32) {
    return launch_pair<T, 48, 32>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                  window, q_offset, sm_scale, workspace, n_split, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class T>
int latent_occupancy_pair(int dqk, int dv, int* blocks) {
  if (dqk == 192 && dv == 128) return latent_occupancy<T, 192, 128>(blocks);
  if (dqk == 576 && dv == 512) return latent_occupancy<T, 576, 512>(blocks);
  if (dqk == 48 && dv == 32) return latent_occupancy<T, 48, 32>(blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

extern "C" {

// o[B, Hq, Tq, Dv] from q[B, Hq, Tq, Dqk], k[B, Hkv, Tk, Dqk] and v[B, Hkv,
// Tk, Dv], given by base pointer and element strides (strides[0..11]: the
// batch, head and row strides of q, k, v, o; the last dimension contiguous;
// v may be a view of k). variant (ops.py's VARIANTS): 0 = FMA, 64-row tiles;
// 3 = tensor cores (bf16, (192, 128) only, 16-byte aligned bases and
// strides); 4 = latent decode (n_split >= 1 contiguous shares of the key
// tiles, and with n_split > 1 a float32 workspace of B * Hkv * g * Tq *
// n_split * (Dv + 2) elements); 5 = latent decode on the tensor cores (bf16,
// (576, 512) only, 16-byte aligned, v the first Dv columns of k; shares and
// workspace as 4). dtype 0 = float32, 1 = bfloat16; (dqk, dv) in
// {(192, 128), (576, 512), (48, 32)}; Hq a multiple of Hkv; window <= 0 means
// none. Returns the CUDA error code of the launch (or of the first failed
// one); a variant not built at the pair returns cudaErrorInvalidValue.
int flash_attention_mla_fwd(int variant, int dtype, int dqk, int dv, const void* q,
                            const void* k, const void* v, void* o, const int64_t* strides,
                            int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
                            int causal, int64_t window, int64_t q_offset, float sm_scale,
                            void* workspace, int n_split, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || tk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((variant == kDecodeLatent || variant == kLatentWgmma) &&
      (n_split < 1 || (n_split > 1 && workspace == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (variant == kLatentWgmma) {
    if (dtype != 1 || dqk != 576 || dv != 512) return static_cast<int>(cudaErrorInvalidValue);
    return launch_latent_wgmma<576, 512>(q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                                         window, q_offset, sm_scale, ws, n_split, s);
  }
  if (variant == kWgmmaBf16) {
    if (dtype != 1 || dqk != 192 || dv != 128) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<192, 128>(q, k, v, o, strides, batch, hq, hkv, tq, tk, causal, window,
                                  q_offset, sm_scale, s);
  }
  if (dtype == 0) {
    return launch_mla<float>(variant, dqk, dv, q, k, v, o, strides, batch, hq, hkv, tq, tk,
                             causal, window, q_offset, sm_scale, ws, n_split, s);
  }
  if (dtype == 1) {
    return launch_mla<__nv_bfloat16>(variant, dqk, dv, q, k, v, o, strides, batch, hq, hkv, tq,
                                     tk, causal, window, q_offset, sm_scale, ws, n_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// *blocks = the latent decode kernel's blocks that one SM of the current
// device holds at once, for variant (4 = decode_latent, 5 = latent_wgmma),
// dtype (0 = float32, 1 = bfloat16) and (dqk, dv): what its shared memory and
// registers allow. Returns the CUDA error code.
int flash_latent_blocks_per_sm(int variant, int dtype, int dqk, int dv, int* blocks) {
  if (variant == kLatentWgmma) {
    if (dtype != 1 || dqk != 576 || dv != 512) return static_cast<int>(cudaErrorInvalidValue);
    return latent_wgmma_occupancy<576, 512>(blocks);
  }
  if (variant != kDecodeLatent) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return latent_occupancy_pair<float>(dqk, dv, blocks);
  if (dtype == 1) return latent_occupancy_pair<__nv_bfloat16>(dqk, dv, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
