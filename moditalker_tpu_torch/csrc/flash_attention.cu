// One-pass and K-blocked fused attention over [B, N, D] sequences (heads
// folded into B), one entry point: fused_attention, Nq query rows over Nk
// keys. The one-pass wrapper launches it with Nq = Nk.
//
//  * one-pass replaces _onepass_kernel of
//    moditalker_tpu/ops/pallas/flash_attention.py, which the JAX package's
//    sdpa picks for mask-free self-attention with N >= 1024, N % 256 == 0,
//    D <= 128. On the main path that is the UNet's joint attention right
//    after the last upsample: [B·8, 2048, 32] (C = 256, 8 heads). With the
//    fused divided and packed kernels switched off it also takes the
//    TimeSformer space attention [B·8·16, 1024, 64] and the UNet's dh = 16
//    attentions [B·8, 2048, 16] and [B·8, 1024, 16]. The TPU kernel keeps
//    all of K and V in VMEM for a full-row softmax, which no Hopper block
//    can hold; here the softmax is an online one.
//
//  * K-blocked fused replaces _attn_kernel of the same file (reached through
//    sdpa_fused → fused_attention): online softmax over K blocks, Nq query
//    rows against Nk keys. The TPU kernel pads Nq to its 128-row block and
//    walks 128-wide K blocks (the whole sequence below 128 keys); here the
//    ragged last query chunk and a key tile short of 128 are masked in the
//    kernel instead of padded outside it.
//
// At D = 16 and 32 the softmax, not the products, is the floor, and the
// kernel is smallhead_tile.cuh (mma.sync behind a cp.async ring, as the
// packed kernel). At D = 64 the products count: it is wgmma_tile.cuh
// without the rotary, each [N, 64] tensor one head of width 64 (K resident
// in shared memory up to Nk = 1152, a K ring above, chosen by Nk; the grid
// sized by Nq). Both tiles take a query length, a key length and a
// key/value batch stride of their own. Both kernels do 4·Nq·Nk·D FLOPs
// against 2·(2·Nq + 2·Nk)·D bytes per sequence: bound by operations.
#include "smallhead_tile.cuh"
#include "wgmma_tile.cuh"

extern "C" {

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; bf16. At
// D = 64, Nk above 1152 must be a multiple of 128 (the fused gate's Nk is
// one from 128 up).
int fused_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Nq, int Nk, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mdt::bf16* qp = static_cast<const mdt::bf16*>(q);
  const mdt::bf16* kp = static_cast<const mdt::bf16*>(k);
  const mdt::bf16* vp = static_cast<const mdt::bf16*>(v);
  mdt::bf16* op = static_cast<mdt::bf16*>(out);
  const long q_seq = (long)Nq * D, kv_seq = (long)Nk * D;
  const mdt::SmallHeadArgs small{qp, kp, vp, op, q_seq, kv_seq, D, q_seq, D,
                                 0, Nq, Nk, scale};
  // built for the head dims the repository's configurations reach (UNet
  // attention at 128 and 256 model channels, AE dim_head 64); keep in step
  // with HEAD_DIMS in flash_attention.py
  switch (D) {
    case 16: return mdt::launch_smallhead<16>(small, B, 1, st);
    case 32: return mdt::launch_smallhead<32>(small, B, 1, st);
    case 64:
      return mdt::launch_wgmma<false>(
          mdt::WgmmaArgs{qp, kp, vp, nullptr, op, q_seq, kv_seq, D, q_seq, D,
                         0, Nq, Nk, scale},
          B, 1, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
