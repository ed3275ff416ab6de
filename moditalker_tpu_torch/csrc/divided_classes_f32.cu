// The C entry points of the divided space and time kernels for float32 qkv
// at the shapes their gate admits beyond the configurations' (the kernels
// and their float32 route: divided_attention.cuh; the configurations'
// shapes: divided_attention_f32.cu). A library of its own, as
// divided_classes.cu is for bf16: space at head dims 2 to 128 (at 64 past
// resident K, N > 1152), a rotation pre-pass and then the small-head tile
// or the wgmma tile built per width (divided_space.cuh), time at 16
// frames of every head-dim class and at 8, 24 and 32 frames the staged
// kernel (time_staged.cuh).
#include "divided_attention.cuh"
#include "divided_space.cuh"
#include "time_staged.cuh"

extern "C" {

// qkv [BF, N, 3·H·dh] float32, rot [N, dh/2, 2] fp32, scratch
// [BF, N, 3·H·max(dh, 8)] bf16 (q, k and v rounded there once; the
// small-head tile at dh <= 32, the wgmma tile at 64 and 128 reads it) ->
// out [BF, N, H·dh] float32; N % 128 == 0, 256 <= N, dh dividing 128.
int divided_space_attention_prerotated_f32(const void* qkv, const void* rot,
                                       void* scratch, void* out, int BF,
                                       int N, int H, int dh, float scale,
                                       void* stream) {
  return mdt::launch_space_prerotated<float>(
      qkv, rot, scratch, out, BF, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// qkv [B, F, N, 3·H·dh] float32, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh]
// float32; F 16, dh dividing 128 from 2 up (8, 24 and 32 frames: the
// staged kernel below; 8 is taken here too, the staged kernel's yardstick).
int divided_time_attention_classes_f32(const void* qkv, const void* sin_t,
                                       const void* cos_t, void* out, int B,
                                       int F, int N, int H, int dh,
                                       float scale, void* stream) {
  return mdt::launch_time_classes<float>(qkv, sin_t, cos_t, out, B, F, N, H,
                                         dh, scale,
                                         static_cast<cudaStream_t>(stream));
}

// qkv [B, F, N, 3·H·dh] float32, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh]
// float32; F = 8 or 16 < F <= 32, F % 8 == 0, dh dividing 128 from 2 up:
// the time kernel staged by cp.async (time_staged.cuh), the frame classes
// 16 and 32.
int divided_time_attention_staged_f32(const void* qkv, const void* sin_t,
                                      const void* cos_t, void* out, int B,
                                      int F, int N, int H, int dh,
                                      float scale, void* stream) {
  return mdt::launch_time_staged_classes<float>(
      qkv, sin_t, cos_t, out, B, F, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
