// The C entry points of the divided space and time kernels for bf16 qkv at
// the shapes their gate admits beyond the configurations' (the kernels:
// divided_attention.cuh). divided_attention.cu holds those (space at head
// dim 64 on the wgmma tile, time at 16 frames of head dim 64); here, in a
// library of their own so that the shipped kernels' translation unit holds
// only their instantiations, are space at head dims 2 to 128 but 64, a
// rotation pre-pass and then the small-head tile or the wgmma tile built
// per width (divided_space.cuh), and time at the frame class 16 (16
// frames) and every head-dim class (16, 32, 64, 128), padded where the
// shape is not the class, and at 8, 24 and 32 frames the staged kernel
// (time_staged.cuh).
#include "divided_attention.cuh"
#include "divided_space.cuh"
#include "time_staged.cuh"

extern "C" {

// qkv [BF, N, 3·H·dh] bf16, rot [N, dh/2, 2] fp32 (cos, sin per rotated
// pair), scratch [BF, N, 3·H·max(dh, 8)] bf16 (the pre-pass writes it, the
// small-head tile at dh <= 32 or the wgmma tile at 128 reads it) -> out
// [BF, N, H·dh] bf16; N % 128 == 0, 256 <= N, dh dividing 128, dh != 64.
int divided_space_attention_prerotated(const void* qkv, const void* rot,
                                       void* scratch, void* out, int BF,
                                       int N, int H, int dh, float scale,
                                       void* stream) {
  return mdt::launch_space_prerotated<mdt::bf16>(
      qkv, rot, scratch, out, BF, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// qkv [B, F, N, 3·H·dh] bf16, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh]
// bf16; F 16, dh dividing 128 from 2 up (8, 24 and 32 frames: the
// staged kernel below; 8 is taken here too, the staged kernel's yardstick).
int divided_time_attention_classes(const void* qkv, const void* sin_t,
                                   const void* cos_t, void* out, int B, int F,
                                   int N, int H, int dh, float scale,
                                   void* stream) {
  return mdt::launch_time_classes<mdt::bf16>(
      qkv, sin_t, cos_t, out, B, F, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// qkv [B, F, N, 3·H·dh] bf16, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh]
// bf16; F = 8 or 16 < F <= 32, F % 8 == 0, dh dividing 128 from 2 up:
// the time kernel staged by cp.async (time_staged.cuh), the frame classes
// 16 and 32.
int divided_time_attention_staged(const void* qkv, const void* sin_t,
                                  const void* cos_t, void* out, int B,
                                  int F, int N, int H, int dh,
                                  float scale, void* stream) {
  return mdt::launch_time_staged_classes<mdt::bf16>(
      qkv, sin_t, cos_t, out, B, F, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
