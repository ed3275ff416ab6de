// The C entry point of the tiny-L kernel for float32 q, k, v (the kernel and
// its float32 route: tiny_attention.cuh). A library of its own, so that the
// bf16 kernel's translation unit (tiny_attention.cu) holds no float32
// instantiation.
#include "tiny_attention.cuh"

extern "C" {

// q, k, v, out: contiguous [B, L, D] float32; built for (L, D) = (16, 64),
// as the bf16 entry point.
int tiny_attention_f32(const void* q, const void* k, const void* v, void* out,
                       long B, int L, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 16 && D == 64)
    return mdt::launch_tiny<16, 64, float>(q, k, v, out, B, L, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
