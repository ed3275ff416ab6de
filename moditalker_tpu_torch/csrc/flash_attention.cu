// One-pass attention over [B, N, D] sequences (heads folded into B).
//
// Replaces _onepass_kernel of moditalker_tpu/ops/pallas/flash_attention.py,
// which the JAX package's sdpa picks for mask-free self-attention with
// N >= 1024, N % 256 == 0, D <= 128. On the main path that is the UNet's
// joint attention right after the last upsample: [B·8, 2048, 32] (C = 256,
// 8 heads). The TPU kernel keeps all of K and V in VMEM for a full-row
// softmax; here it is flash_tile.cuh's online-softmax mma.sync kernel on
// three separate contiguous tensors. 4·N²·D FLOPs against 8·N·D bytes per
// sequence: bound by operations.
#include "flash_tile.cuh"

extern "C" {

// q, k, v, out: contiguous [B, N, D] bf16.
int onepass_attention(const void* q, const void* k, const void* v, void* out,
                      int B, int N, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long seq = (long)N * D;
  const mdt::FlashArgs a{static_cast<const mdt::bf16*>(q),
                         static_cast<const mdt::bf16*>(k),
                         static_cast<const mdt::bf16*>(v),
                         nullptr, nullptr, static_cast<mdt::bf16*>(out),
                         seq, D, seq, D, 0, N, scale};
  // built for the head dims the repository's configurations reach (UNet
  // joint and plane attention at 128 and 256 model channels); keep in step
  // with _HEAD_DIMS in flash_attention.py
  switch (D) {
    case 32: return mdt::launch_flash<32, false>(a, B, 1, st);
    case 64: return mdt::launch_flash<64, false>(a, B, 1, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
