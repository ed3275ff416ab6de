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
// At D = 64 past resident K (Nk > 1152: the 256-channel UNet's joint
// attention [B·8, 2048, 64]), where the wrapper chooses it,
// fused_attention_f32_prerounded rounds K and V to bf16 once per sequence,
// into a scratch the wrapper passes, and runs the wgmma tile's bf16 K ring
// on it with float32 q and output (launch_prerounded): the same rounding
// points again.
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

// The pre-pass: k and v [B, Nk, 64] float32 rounded to bf16 once, into the
// scratch kv [2, B, Nk, 64] (k, then v). Block 256, grid ceil(2 x chunks /
// 256): thread i takes 16-byte chunk i of the scratch (32 bytes in), so a
// warp reads 1 KB and writes 512 bytes of neighbouring addresses.
__global__ void __launch_bounds__(256)
round_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                bf16* __restrict__ kv, long chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * chunks) return;
  Chunk8<float> c;
  c.load(i < chunks ? k + 8 * i : v + 8 * (i - chunks));
  float x[8];
  c.to_float(x);
  *reinterpret_cast<uint4*>(kv + 8 * i) = pack8_bf16(x);
}

// q [B, Nq, 64], k, v [B, Nk, 64] float32, Nk a multiple of 128 past
// resident K -> out [B, Nq, 64] float32, through the scratch kv [2, B, Nk,
// 64] bf16. Two launches: the pre-pass, then the bf16 K ring over the
// scratch (two consumer warpgroups of 64 query rows, a producer copying
// each K and V tile with cp.async).
inline int launch_prerounded(const void* q, const void* k, const void* v,
                             void* kv, void* out, int B, int Nq, int Nk,
                             float scale, cudaStream_t stream) {
  if (B < 1 || Nq < 1 || Nk <= kWgMaxKSlots * kWgTile || Nk % kWgTile)
    return cudaErrorInvalidValue;
  const long chunks = (long)B * Nk * kWgD / 8;  // of k, and of v
  bf16* ks = static_cast<bf16*>(kv);
  round_kv_kernel<<<(unsigned)((2 * chunks + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), ks, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long q_seq = (long)Nq * kWgD, kv_seq = (long)Nk * kWgD;
  return launch_wgmma_ring<false>(
      WgmmaArgsT<bf16, float>{static_cast<const float*>(q), ks,
                              ks + B * kv_seq, nullptr,
                              static_cast<float*>(out), q_seq, kv_seq, kWgD,
                              q_seq, kWgD, 0, Nq, Nk, scale},
      B, 1, stream);
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

// q, out: contiguous [B, Nq, D]; k, v: contiguous [B, Nk, D]; float32; the
// scratch kv [2, B, Nk, D] bf16. D = 64 and Nk past 1152 keys, a multiple
// of 128 (else refused): launch_prerounded (the wrapper chooses it:
// onepass_f32_prerounded in ops/kernels/flash_attention.py).
int fused_attention_f32_prerounded(const void* q, const void* k,
                                   const void* v, void* kv, void* out, int B,
                                   int Nq, int Nk, int D, float scale,
                                   void* stream) {
  if (D != mdt::kWgD || kv == nullptr) return cudaErrorInvalidValue;
  return mdt::launch_prerounded(q, k, v, kv, out, B, Nq, Nk, scale,
                                static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
