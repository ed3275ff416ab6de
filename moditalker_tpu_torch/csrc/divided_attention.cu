// The C entry points of the divided space and time kernels for bf16 qkv
// (the kernels: divided_attention.cuh). The float32 entry points are built
// apart, in divided_attention_f32.cu: instantiated in this translation unit
// beside the bf16 ones, the float32 space kernel changed the compiler's
// choices for the bf16 one (its shared base address recomputed at each use,
// 2-3 % slower on an H100); here, alone, the bf16 kernels compile as they
// do without a float32 instantiation.
#include "divided_attention.cuh"

extern "C" {

// qkv [BF, N, 3·H·dh] bf16, rot [N, dh/2, 2] fp32 (cos, sin per rotated
// pair) -> out [BF, N, H·dh] bf16; N % 128 == 0, N >= 256.
int divided_space_attention(const void* qkv, const void* rot, void* out,
                            int BF, int N, int H, int dh, float scale,
                            void* stream) {
  return mdt::launch_space<mdt::bf16>(qkv, rot, out, BF, N, H, dh, scale,
                                      static_cast<cudaStream_t>(stream));
}

// qkv [B, F, N, 3·H·dh] bf16, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh] bf16.
int divided_time_attention(const void* qkv, const void* sin_t,
                           const void* cos_t, void* out, int B, int F, int N,
                           int H, int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // built for the shape the repository's configurations reach (16 frames,
  // dim_head 64); keep in step with TIME_SHAPES in divided_attention.py
  if (F == 16 && dh == 64)
    return mdt::launch_time<16, 64, mdt::bf16>(qkv, sin_t, cos_t, out, B, F,
                                               N, H, dh, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
