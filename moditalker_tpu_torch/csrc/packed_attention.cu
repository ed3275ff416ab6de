// Packed multi-head self-attention of the triplane UNet.
//
// Replaces _packed_kernel of moditalker_tpu/ops/pallas/packed_attention.py:
// qkv [B, L, 3C] (q|k|v thirds, heads contiguous inside each third, dh = 16)
// -> [B, L, C]. The TPU kernel isolates heads with lane masks so that every
// matmul contracts 128 lanes; on Hopper a head is simply its 16-column slice
// of each third, read with strided offsets, so no masks and no wasted
// products. The attention itself is smallhead_tile.cuh: K and V behind a
// cp.async ring, ldmatrix fragments, one m16n8k16 per 8 keys for the scores
// (dh = 16 is exactly one k-step) and two per 16 keys for P·V, an online
// softmax over 128-key tiles. At the main path's L = 1024 and 2048 it does
// 4·L²·16 FLOPs per (batch, head) against 2·L·16·4 bytes, so the card's
// bound is the operations one; the floor the SM sets is the softmax's ex2,
// four times that (smallhead_tile.cuh).
#include "smallhead_tile.cuh"

extern "C" {

// qkv [B, L, 3·H·dh] bf16 -> out [B, L, H·dh] bf16, any L >= 1.
int packed_attention(const void* qkv, void* out, int B, int L, int H, int dh,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mdt::bf16* base = static_cast<const mdt::bf16*>(qkv);
  const long hd = (long)H * dh;
  const mdt::SmallHeadArgs a{base, base + hd, base + 2 * hd,
                             static_cast<mdt::bf16*>(out),
                             L * 3 * hd, L * 3 * hd, 3 * hd, L * hd, hd, dh,
                             L, L, scale};
  // built for the head dim the gate admits; keep in step with
  // PACKED_HEAD_DIMS in packed_attention.py
  switch (dh) {
    case 16: return mdt::launch_smallhead<16>(a, B, H, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
