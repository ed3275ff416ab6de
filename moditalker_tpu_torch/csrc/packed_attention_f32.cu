// The packed multi-head attention kernel for float32 qkv (the float32 route
// of packed_attention.cu: the UNet's attentions when the trainers and the
// golden record run it in float32). A library of its own, so that the bf16
// kernel's translation unit holds no float32 instantiation.
//
// The same small-head tile (smallhead_tile.cuh) with T = float: q read as
// float32 pairs into the A fragments (times the scale in fp32, rounded to
// bf16 once), K and V staged through the registers of the warp on duty
// (float32 in, rounded to bf16 once, into the swizzled bf16 ring), both
// products on bf16 operands with fp32 accumulators, p rounded to bf16 for
// P·V, the output divided by the fp32 row sum and stored as float32.
#include "smallhead_tile.cuh"

extern "C" {

// qkv [B, L, 3·H·dh] float32 -> out [B, L, H·dh] float32, any L >= 1.
int packed_attention_f32(const void* qkv, void* out, int B, int L, int H,
                         int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* base = static_cast<const float*>(qkv);
  const long hd = (long)H * dh;
  const mdt::SmallHeadArgsT<float> a{base, base + hd, base + 2 * hd,
                                     static_cast<float*>(out),
                                     L * 3 * hd, L * 3 * hd, 3 * hd, L * hd,
                                     hd, dh, L, L, scale};
  // the bf16 entry point's head dims (PACKED_HEAD_DIMS)
  switch (dh) {
    case 16: return mdt::launch_smallhead<16>(a, B, H, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
