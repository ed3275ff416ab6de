// The C entry points of the one-pass, K-blocked fused and tiny-L kernels for
// bf16 at the shapes their gates admit beyond the configurations'
// (flash_attention.cu and tiny_attention.cu hold those: head dims 16,
// 32 and 64, and tiny-L at 16 rows of 64), in a library of its own: the
// one-pass and fused kernels on the small-head tile's head-dim classes
// (smallhead_tile.cuh) at 8 and 24 (above 32: flash_narrow.cu's in bf16 at
// 40, 48 and 56, flash_wide.cu's otherwise), tiny-L at rows 8, 24 and 32
// and head dim 128 (tiny_attention.cuh).
#include "smallhead_tile.cuh"
#include "tiny_attention.cuh"

extern "C" {

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; bf16;
// D % 8 == 0, D <= 64.
int fused_attention_classes(const void* q, const void* k, const void* v,
                            void* out, int B, int Nq, int Nk, int D,
                            float scale, void* stream) {
  return mdt::launch_fused_classes<mdt::bf16>(q, k, v, out, B, Nq, Nk, D, scale,
                                          static_cast<cudaStream_t>(stream));
}

// q, k, v, out: contiguous [B, L, D] bf16; L in {8, 16, 24, 32}, D in
// {64, 128}.
int tiny_attention_classes(const void* q, const void* k, const void* v,
                           void* out, long B, int L, int D, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return mdt::launch_tiny_class<64, mdt::bf16>(q, k, v, out, B, L, scale,
                                                   st);
    case 128:
      return mdt::launch_tiny_class<128, mdt::bf16>(q, k, v, out, B, L,
                                                    scale, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
