// One-pass and K-blocked fused attention over [B, N, D] sequences (heads
// folded into B).
//
//  * onepass_attention replaces _onepass_kernel of
//    moditalker_tpu/ops/pallas/flash_attention.py, which the JAX package's
//    sdpa picks for mask-free self-attention with N >= 1024, N % 256 == 0,
//    D <= 128. On the main path that is the UNet's joint attention right
//    after the last upsample: [B·8, 2048, 32] (C = 256, 8 heads). With the
//    fused divided and packed kernels switched off it also takes the
//    TimeSformer space attention [B·8·16, 1024, 64] and the UNet's dh = 16
//    attentions [B·8, 2048, 16] and [B·8, 1024, 16]. The TPU kernel keeps
//    all of K and V in VMEM for a full-row softmax, which no Hopper block
//    can hold; here the softmax is an online one. At D = 16 and 32 the
//    softmax, not the products, is the floor, and the kernel is
//    smallhead_tile.cuh (mma.sync behind a cp.async ring, as the packed
//    kernel). At D = 64 the products count: it is wgmma_tile.cuh without the
//    rotary, each [N, 64] tensor one head of width 64 (K resident in shared
//    memory up to N = 1152, a K ring above).
//
//  * fused_attention replaces _attn_kernel of the same file (reached through
//    sdpa_fused → fused_attention): online softmax over K blocks, Nq query
//    rows against Nk keys. The TPU kernel pads Nq to its 128-row block and
//    walks 128-wide K blocks; here it is flash_tile.cuh's kernel with its
//    own key length and key/value batch stride, the ragged last query tile
//    masked in the kernel instead of padded outside it.
//
// Both do 4·Nq·Nk·D FLOPs against 2·(2·Nq + 2·Nk)·D bytes per sequence:
// bound by operations.
#include "flash_tile.cuh"
#include "smallhead_tile.cuh"
#include "wgmma_tile.cuh"

extern "C" {

// q, k, v, out: contiguous [B, N, D] bf16. D = 64 needs N % 128 == 0 and
// N >= 256.
int onepass_attention(const void* q, const void* k, const void* v, void* out,
                      int B, int N, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mdt::bf16* qp = static_cast<const mdt::bf16*>(q);
  const mdt::bf16* kp = static_cast<const mdt::bf16*>(k);
  const mdt::bf16* vp = static_cast<const mdt::bf16*>(v);
  mdt::bf16* op = static_cast<mdt::bf16*>(out);
  const long seq = (long)N * D;
  const mdt::SmallHeadArgs small{qp, kp, vp, op, seq, D, seq, D, 0, N, scale};
  // built for the head dims the repository's configurations reach (UNet
  // attention at 128 and 256 model channels, AE dim_head 64); keep in step
  // with ONEPASS_HEAD_DIMS in flash_attention.py
  switch (D) {
    case 16: return mdt::launch_smallhead<16>(small, B, 1, st);
    case 32: return mdt::launch_smallhead<32>(small, B, 1, st);
    case 64:
      return mdt::launch_wgmma<false>(
          mdt::WgmmaArgs{qp, kp, vp, nullptr, op, seq, D, seq, D, 0, N, scale},
          B, 1, st);
  }
  return cudaErrorInvalidValue;
}

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; bf16.
int fused_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Nq, int Nk, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long q_seq = (long)Nq * D, kv_seq = (long)Nk * D;
  const mdt::FlashArgs a{static_cast<const mdt::bf16*>(q),
                         static_cast<const mdt::bf16*>(k),
                         static_cast<const mdt::bf16*>(v),
                         static_cast<mdt::bf16*>(out),
                         q_seq, kv_seq, D, q_seq, D, Nq, Nk, scale};
  // keep in step with FUSED_HEAD_DIMS in flash_attention.py
  switch (D) {
    case 16: return mdt::launch_flash<16>(a, B, st);
    case 64: return mdt::launch_flash<64>(a, B, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
