// Divided space/time attention of the TimeSformer trunk, on packed qkv.
//
// Replaces the Pallas kernels of moditalker_tpu/ops/pallas/divided_attention.py:
//
//  * space (_space_kernel): per frame, self-attention over the N patch
//    tokens with the axial 2D rotary on q and k. At the shipped shape (qkv
//    [B·16, 1024, 1536], H = 8, dh = 64) it does 4·N²·dh FLOPs per (frame,
//    head) against 4 bytes per element moved, so it is bound by operations
//    (tensor cores). It runs on wgmma_tile.cuh: both products on wgmma, K
//    rotated once per block into a 128-byte-swizzled tile, V read as the
//    transposed operand from its row-major tile, copies in flight behind a
//    ring while the tensor cores work. The tile's launcher picks resident K
//    (one block per (frame, head), K rotated once) where N·128 bytes of K fit
//    beside the ring, and a K ring with one query tile per block above that.
//
//  * time (_time_kernel): per patch, self-attention over the F = 16 frames
//    with the 1D time rotary, [B, F, N, 3·H·dh] -> [B, F, N, H·dh] with no
//    transpose. A sequence is 16 rows of 128 bytes per q, k and v, each
//    N·3·H·dh elements from the next, and does 65 KFLOP: the kernel moves
//    bytes (134 MB at the shipped shape, each read or written once). One
//    warp owns one (b, n, head); a block's warps take the neighbouring
//    heads of one (b, n) (at H = 8: all of them), so for each frame the
//    block reads one whole contiguous 3·H·dh row and writes one whole H·dh
//    row. Loads are 16 bytes per lane, eight neighbouring lanes on one
//    row's 128 bytes; the rotary is applied in fp32 (q also scaled) as each
//    chunk passes from the load to the warp's bf16 shared buffer, rounded
//    once; the fp32 tables are staged in shared memory once per block. Both
//    products are mma.sync m16n8k16 around a full-row softmax in registers
//    (tiny_tile.cuh, shared with the tiny-L kernel), and the output leaves
//    through the buffer as 16-byte stores. wgmma is not used: 16 rows cannot
//    fill a 64-row warpgroup tile, and the kernel is bound by bytes. No
//    block barrier follows the table staging.
#include "tiny_tile.cuh"
#include "wgmma_tile.cuh"

namespace mdt {

template <int FT, int DH>
struct TimeShape {
  static constexpr int warps = 8;
  static constexpr int table_floats = 2 * FT * DH;  // sin, cos
  static constexpr int smem_bytes =
      table_floats * (int)sizeof(float) +
      warps * TinyTile<FT, DH>::warp_elems * (int)sizeof(bf16);
};

// grid ceil(B·N·H / 8), block 256; exactly FT frames.
template <int FT, int DH>
__global__ void __launch_bounds__(32 * TimeShape<FT, DH>::warps)
time_attention_kernel(const bf16* __restrict__ qkv,
                      const float* __restrict__ sin_t,
                      const float* __restrict__ cos_t, bf16* __restrict__ out,
                      int B, int N, int H, float scale) {
  using S = TimeShape<FT, DH>;
  using T = TinyTile<FT, DH>;
  constexpr int RS = T::RS, CH = T::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sin_s = reinterpret_cast<float*>(smem_raw);  // [FT][DH]
  float* cos_s = sin_s + FT * DH;
  for (int i = threadIdx.x; i < FT * DH / 4; i += 32 * S::warps) {
    reinterpret_cast<float4*>(sin_s)[i] =
        reinterpret_cast<const float4*>(sin_t)[i];
    reinterpret_cast<float4*>(cos_s)[i] =
        reinterpret_cast<const float4*>(cos_t)[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long wid = (long)blockIdx.x * S::warps + warp;
  if (wid >= (long)B * N * H) return;  // whole warp leaves; no barrier below
  bf16* q_s = reinterpret_cast<bf16*>(sin_s + S::table_floats) +
              warp * T::warp_elems;
  bf16* k_s = q_s + FT * RS;
  bf16* v_s = k_s + FT * RS;

  const int h = (int)(wid % H);
  const int n = (int)((wid / H) % N);
  const int b = (int)(wid / ((long)H * N));
  const int HD = H * DH;
  const long in_frame = (long)N * 3 * HD, out_frame = (long)N * HD;
  const bf16* src = qkv + ((long)b * FT * N + n) * 3L * HD + h * DH;

  // unrolled: all twelve 16-byte loads of a lane are in flight together
#pragma unroll
  for (int i = lane; i < FT * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const bf16* row = src + r * in_frame + c;
    const float* sn = sin_s + r * DH + c;
    const float* cs = cos_s + r * DH + c;
    float x[8];
    load8<true>(row, true, sn, cs, scale, x);
    store8(q_s + r * RS + c, x);
    load8<true>(row + HD, true, sn, cs, 1.f, x);
    store8(k_s + r * RS + c, x);
    *reinterpret_cast<uint4*>(v_s + r * RS + c) =
        *reinterpret_cast<const uint4*>(row + 2 * HD);
  }
  __syncwarp();
  tiny_attend<FT, DH>(q_s, k_s, v_s, lane);
  __syncwarp();
  bf16* dst = out + ((long)b * FT * N + n) * HD + h * DH;
  for (int i = lane; i < FT * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * out_frame + c) =
        *reinterpret_cast<const uint4*>(q_s + r * RS + c);
  }
}

template <int FT, int DH>
cudaError_t launch_time(const void* qkv, const void* sin_t, const void* cos_t,
                        void* out, int B, int N, int H, float scale,
                        cudaStream_t stream) {
  using S = TimeShape<FT, DH>;
  auto kern = time_attention_kernel<FT, DH>;
  if (S::smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
    if (err != cudaSuccess) return err;
  }
  long warps = (long)B * N * H;
  unsigned blocks = (unsigned)((warps + S::warps - 1) / S::warps);
  kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<bf16*>(out), B, N, H,
      scale);
  return cudaGetLastError();
}

}  // namespace mdt

extern "C" {

// qkv [BF, N, 3·H·dh] bf16, rot [N, dh/2, 2] fp32 (cos, sin per rotated
// pair) -> out [BF, N, H·dh] bf16; N % 128 == 0, N >= 256.
int divided_space_attention(const void* qkv, const void* rot, void* out,
                            int BF, int N, int H, int dh, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // built for the head dim the repository's configurations reach (AE
  // dim_head 64); keep in step with SPACE_HEAD_DIMS in divided_attention.py
  if (dh != mdt::kWgD) return cudaErrorInvalidValue;
  const mdt::bf16* base = static_cast<const mdt::bf16*>(qkv);
  const long hd = (long)H * dh;
  mdt::WgmmaArgs a{base, base + hd, base + 2 * hd,
                   static_cast<const float*>(rot),
                   static_cast<mdt::bf16*>(out),
                   N * 3 * hd, N * 3 * hd, 3 * hd, N * hd, hd, dh, N, N,
                   scale};
  return mdt::launch_wgmma<true>(a, BF, H, st);
}

// qkv [B, F, N, 3·H·dh] bf16, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh] bf16.
int divided_time_attention(const void* qkv, const void* sin_t,
                           const void* cos_t, void* out, int B, int F, int N,
                           int H, int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // built for the shape the repository's configurations reach (16 frames,
  // dim_head 64); keep in step with TIME_SHAPES in divided_attention.py
  if (F == 16 && dh == 64)
    return mdt::launch_time<16, 64>(qkv, sin_t, cos_t, out, B, N, H, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
