// The C entry point of the tiny-L kernel for bf16 q, k, v (the kernel:
// tiny_attention.cuh).
#include "tiny_attention.cuh"

extern "C" {

// q, k, v, out: contiguous [B, L, D] bf16.
int tiny_attention(const void* q, const void* k, const void* v, void* out,
                   long B, int L, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // built for the (L, D) the repository's configurations reach (16 frames,
  // AE dim_head 64); keep in step with TINY_SHAPES in flash_attention.py
  if (L == 16 && D == 64)
    return mdt::launch_tiny<16, 64, mdt::bf16>(q, k, v, out, B, L, scale,
                                               st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
