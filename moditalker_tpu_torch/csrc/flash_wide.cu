// The one-pass and K-blocked fused kernels for bf16 at the head dims above
// 32 their gates admit beyond the configurations' (flash_attention.cu holds
// 16, 32 and 64), in a library of their own: the wgmma tile built per width
// (wgmma_wide.cuh, launch_fused_wide), each d % 8 == 0 from 72 to 256 a
// tile of its own (40, 48 and 56 run on the narrow tile, flash_narrow.cu,
// faster there), and heads past 256 (the fused gate has
// no bound) the 256-column tile in groups of output columns.
#include "wgmma_wide.cuh"

extern "C" {

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; bf16;
// D % 8 == 0, D >= 72.
int fused_attention_wide(const void* q, const void* k, const void* v,
                         void* out, int B, int Nq, int Nk, int D, float scale,
                         void* stream) {
  return mdt::launch_fused_wide<mdt::bf16>(q, k, v, out, B, Nq, Nk, D, scale,
                                           static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
