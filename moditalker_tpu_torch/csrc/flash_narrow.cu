// The one-pass and K-blocked fused kernels for bf16 at head dims 40, 48
// and 56 (the kernel: wgmma_narrow.cuh, the D = 64 tile's plan at the
// head's own width), in a library of its own: every other width above 32
// but 64 is flash_wide.cu's, 16, 32 and 64 flash_attention.cu's, 8 and 24
// flash_classes.cu's. Float32 at these widths runs the wide tile
// (flash_wide_f32.cu).
#include "wgmma_narrow.cuh"

extern "C" {

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; bf16;
// D in {40, 48, 56}; Nk above 1152 a multiple of 128.
int fused_attention_narrow(const void* q, const void* k, const void* v,
                           void* out, int B, int Nq, int Nk, int D,
                           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mdt::NarrowArgs a{static_cast<const mdt::bf16*>(q),
                          static_cast<const mdt::bf16*>(k),
                          static_cast<const mdt::bf16*>(v),
                          static_cast<mdt::bf16*>(out), Nq, Nk, scale, 0, 0};
  switch (D) {
    case 40: return mdt::launch_narrow<40>(a, B, st);
    case 48: return mdt::launch_narrow<48>(a, B, st);
    case 56: return mdt::launch_narrow<56>(a, B, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
