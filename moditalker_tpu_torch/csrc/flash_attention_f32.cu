// The one-pass and K-blocked fused kernel for float32 q, k, v (the float32
// route of flash_attention.cu: the UNet's joint attention [B·8, 2048, 32]
// in the trainers and the golden record, and with the fused divided and
// packed kernels switched off the AE's space attention [B·8·16, 1024, 64]
// and the UNet's dh = 16 attentions; at 256 model channels the UNet's joint
// attention [B·8, 2048, 64]). A library of its own, so that the bf16
// kernels' translation unit holds no float32 instantiation.
//
// The same two tiles with float32 in and out: at D = 16 and 32 the
// small-head tile (K and V rounded to bf16 in the registers of the warp on
// duty on their way into the ring), at D = 64 the wgmma tile without the
// rotary (K rounded in the prologue's registers where it stays resident, up
// to 1152 keys, or in the producer's on its way into the K ring above that;
// V in the producer's). Both round q·scale, k and v to bf16 once, accumulate
// in fp32, round p to bf16 for P·V and store the output, divided by the fp32
// row sum, as float32. At D = 64, Nq = Nk with K resident, where the
// wrapper passes a V scratch, the float32 resident-K kernel of the space
// attention without its rotary (resident_f32_tile.cuh: K rounded once per
// sequence before the roles split, V by the producer in the first round,
// two consumer warpgroups) computes the same at the same rounding points.
#include "resident_f32_tile.cuh"
#include "smallhead_tile.cuh"
#include "wgmma_tile.cuh"

namespace mdt {

// q, k, v [B, N, 64] float32, N a multiple of 128 up to 1152 -> out
// [B, N, 64] float32, through the V scratch [B, N, 64] bf16.
inline int launch_onepass_f32(const void* q, const void* k, const void* v,
                              void* vs, void* out, int B, int N, float scale,
                              cudaStream_t stream) {
  return launch_resident_f32(
      OnepassF32Args{static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<bf16*>(vs),
                     static_cast<float*>(out), N, scale},
      1, B, stream);
}

}  // namespace mdt

extern "C" {

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; float32; the
// V scratch vs [B, Nk, D] bf16 or null. At D = 64, Nk above 1152 must be a
// multiple of 128, as for bf16. With a scratch (D = 64, Nq = Nk a multiple
// of 128 up to 1152, else refused), resident_f32_tile.cuh's kernel; without
// one, the tiles above (the wrapper chooses: onepass_f32_own_kernel in
// ops/kernels/flash_attention.py).
int fused_attention_f32(const void* q, const void* k, const void* v,
                        void* vs, void* out, int B, int Nq, int Nk, int D,
                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vs != nullptr) {
    if (D != mdt::kWgD || Nq != Nk) return cudaErrorInvalidValue;
    return mdt::launch_onepass_f32(q, k, v, vs, out, B, Nq, scale, st);
  }
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  const long q_seq = (long)Nq * D, kv_seq = (long)Nk * D;
  const mdt::SmallHeadArgsT<float> small{qp, kp, vp, op, q_seq, kv_seq, D,
                                         q_seq, D, 0, Nq, Nk, scale};
  // the bf16 entry point's head dims (HEAD_DIMS in flash_attention.py)
  switch (D) {
    case 16: return mdt::launch_smallhead<16>(small, B, 1, st);
    case 32: return mdt::launch_smallhead<32>(small, B, 1, st);
    case 64:
      return mdt::launch_wgmma<false, float, float>(
          mdt::WgmmaArgsT<float, float>{qp, kp, vp, nullptr, op, q_seq,
                                        kv_seq, D, q_seq, D, 0, Nq, Nk,
                                        scale},
          B, 1, st);
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
