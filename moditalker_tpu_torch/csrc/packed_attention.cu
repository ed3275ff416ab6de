// Packed multi-head self-attention of the triplane UNet.
//
// Replaces _packed_kernel of moditalker_tpu/ops/pallas/packed_attention.py:
// qkv [B, L, 3C] (q|k|v thirds, heads contiguous inside each third, dh = 16)
// -> [B, L, C]. The TPU kernel isolates heads with lane masks so that every
// matmul contracts 128 lanes; on Hopper a head is simply its 16-column slice
// of each third, read with strided offsets, so no masks and no wasted
// products. The attention itself is flash_tile.cuh's online-softmax
// mma.sync kernel without rotary: one m16n8k16 per 8 keys for the scores
// (dh = 16 is exactly one k-step) and two per 16 keys for P·V. At the main
// path's L = 1024 and 2048 with dh = 16 it does 4·L²·16 FLOPs per (batch,
// head) against 2·L·16·4 bytes, so it is bound by operations.
#include "flash_tile.cuh"

extern "C" {

int packed_attention(const void* qkv, void* out, int B, int L, int H, int dh,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return mdt::launch_flash<16, false>(
          mdt::packed_args(qkv, nullptr, nullptr, out, L, H, dh, scale), B, H,
          st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
