// The attention kernels at Dqk = Dv: every variant at head dims 32, 64, 80,
// 128 and 256 (the templates and their design: flash_attention.cuh; MLA's
// pairs: flash_attention_mla.cu, a library of its own that nvcc builds beside
// this one).
#include "flash_attention.cuh"

namespace {

template <class T, int DH>
int launch_variant(int variant, const void* q, const void* k, const void* v, void* o,
                   const int64_t* st, int64_t batch, int64_t hq, int64_t hkv, int64_t tq,
                   int64_t tk, int causal, int64_t window, int64_t q_offset, float sm_scale,
                   float* workspace, int n_split, cudaStream_t stream) {
  switch (variant) {
    case kDecodeSplit:
      return launch_decode<T, DH>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window,
                                  q_offset, sm_scale, workspace, n_split, stream);
    case kFmaShort:
      return launch_fma<T, DH, DH, 16>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window,
                                       q_offset, sm_scale, stream);
    case kFma:
      return launch_fma<T, DH, DH, 64>(q, k, v, o, st, batch, hq, hkv, tq, tk, causal, window,
                                       q_offset, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
int launch_dh(int variant, int dh, const void* q, const void* k, const void* v, void* o,
              const int64_t* st, int64_t batch, int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
              int causal, int64_t window, int64_t q_offset, float sm_scale, float* workspace,
              int n_split, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_variant<T, 32>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                   window, q_offset, sm_scale, workspace, n_split, stream);
    case 64:
      return launch_variant<T, 64>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                   window, q_offset, sm_scale, workspace, n_split, stream);
    case 80:
      return launch_variant<T, 80>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                   window, q_offset, sm_scale, workspace, n_split, stream);
    case 128:
      return launch_variant<T, 128>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, workspace, n_split, stream);
    case 256:
      return launch_variant<T, 256>(variant, q, k, v, o, st, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, workspace, n_split, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
int decode_occupancy_dh(int dh, int64_t rows, int* blocks) {
  switch (dh) {
    case 32:
      return decode_occupancy_rows<T, 32>(rows, blocks);
    case 64:
      return decode_occupancy_rows<T, 64>(rows, blocks);
    case 80:
      return decode_occupancy_rows<T, 80>(rows, blocks);
    case 128:
      return decode_occupancy_rows<T, 128>(rows, blocks);
    case 256:
      return decode_occupancy_rows<T, 256>(rows, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

extern "C" {

// o[B, Hq, Tq, Dh] from q[B, Hq, Tq, Dh], k and v[B, Hkv, Tk, Dh], all given
// by base pointer and element strides (strides[0..11]: the batch, head and
// row strides of q, k, v, o, in that order; the last dimension contiguous).
// variant: 0 = FMA, 64-row tiles; 1 = FMA, 16-row tiles; 2 = split-KV decode
// (needs g * Tq <= 16; n_split >= 1 contiguous shares of the key tiles, and
// with n_split > 1 a float32 workspace of B * Hkv * g * Tq * n_split *
// (Dh + 2) elements); 3 = tensor cores (bf16 only, 16-byte aligned bases and
// strides). dtype 0 = float32, 1 = bfloat16; dh in {32, 64, 80, 128, 256}; Hq a
// multiple of Hkv; window <= 0 means none. Returns the CUDA error code of the
// launch (or of the first failed one).
int flash_attention_fwd(int variant, int dtype, int dh, const void* q, const void* k,
                        const void* v, void* o, const int64_t* strides, int64_t batch,
                        int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int causal,
                        int64_t window, int64_t q_offset, float sm_scale, void* workspace,
                        int n_split, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || tk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == kDecodeSplit &&
      ((hq / hkv) * tq > 16 || n_split < 1 || (n_split > 1 && workspace == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (variant == kWgmmaBf16) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (dh) {
      case 32:
        return launch_wgmma<32, 32>(q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, s);
      case 64:
        return launch_wgmma<64, 64>(q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, s);
      case 80:
        return launch_wgmma<80, 80>(q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, s);
      case 128:
        return launch_wgmma<128, 128>(q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, s);
      case 256:
        return launch_wgmma<256, 256>(q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                                    window, q_offset, sm_scale, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    return launch_dh<float>(variant, dh, q, k, v, o, strides, batch, hq, hkv, tq, tk, causal,
                            window, q_offset, sm_scale, ws, n_split, s);
  }
  if (dtype == 1) {
    return launch_dh<__nv_bfloat16>(variant, dh, q, k, v, o, strides, batch, hq, hkv, tq, tk,
                                    causal, window, q_offset, sm_scale, ws, n_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// *blocks = the split-KV decode kernel's blocks that one SM of the current
// device holds at once, for dtype (0 = float32, 1 = bfloat16), dh and
// g * Tq = rows (<= 16): what its shared memory and registers allow. Returns
// the CUDA error code.
int flash_decode_blocks_per_sm(int dtype, int dh, int64_t rows, int* blocks) {
  if (dtype == 0) return decode_occupancy_dh<float>(dh, rows, blocks);
  if (dtype == 1) return decode_occupancy_dh<__nv_bfloat16>(dh, rows, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
