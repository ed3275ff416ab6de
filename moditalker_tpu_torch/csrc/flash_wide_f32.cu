// The float32 entry point of flash_wide.cu, a library of its own: the same
// wgmma tiles reading q, k and v as float32 (each rounded to bf16 once, K
// and V in the producer's registers on their way into their slots) and
// storing the output as float32 from the accumulators.
#include "wgmma_wide.cuh"

extern "C" {

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; float32;
// D % 8 == 0, D >= 40, D != 64.
int fused_attention_wide_f32(const void* q, const void* k, const void* v,
                             void* out, int B, int Nq, int Nk, int D,
                             float scale, void* stream) {
  return mdt::launch_fused_wide<float>(q, k, v, out, B, Nq, Nk, D, scale,
                                       static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
