// Divided space/time attention of the TimeSformer trunk, on packed qkv.
//
// Replaces the Pallas kernels of moditalker_tpu/ops/pallas/divided_attention.py:
//
//  * space (_space_kernel): per frame, self-attention over the N patch
//    tokens with the axial 2D rotary on q and k. Here: flash_tile.cuh's
//    online-softmax mma.sync kernel with ROT = true. At the shipped shape
//    (qkv [B·16, 1024, 1536], H = 8, dh = 64) it does 4·N²·dh FLOPs per
//    (frame, head) against 4 bytes per element moved, so it is bound by
//    operations (tensor cores).
//
//  * time (_time_kernel): per patch, self-attention over the F frames with
//    the 1D time rotary, [B, F, N, 3·H·dh] -> [B, F, N, H·dh] with no
//    transpose. A [F, F] score tile per (patch, head) is tiny (16 x 16), so
//    the kernel moves bytes, not FLOPs: one warp owns one (b, n, h), its
//    lanes split the F rows (32 / F lanes per row, dh·F/32 dims each), q
//    stays in registers, k and v go through a padded per-warp shared buffer,
//    and the softmax runs in registers. Each qkv byte is read once and each
//    output byte written once.
#include "flash_tile.cuh"

namespace mdt {

template <int FT, int DH>
struct TimeShape {
  static constexpr int LPR = 32 / FT;   // lanes per frame row
  static constexpr int DPL = DH / LPR;  // dims per lane (even: rotary pairs)
  static constexpr int RS = DPL + 1;    // padded smem stride (floats)
  static constexpr int warp_floats = 2 * 32 * RS;  // k and v
  static constexpr int warps = 4;
  static constexpr int smem_bytes = warps * warp_floats * (int)sizeof(float);
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// DPL consecutive bf16 -> fp32 registers.
template <int DPL>
__device__ __forceinline__ void load_row(const bf16* src, float (&x)[DPL]) {
  if constexpr (DPL % 8 == 0) {
#pragma unroll
    for (int c = 0; c < DPL; c += 8) {
      uint4 raw = *reinterpret_cast<const uint4*>(src + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[c + i] = __bfloat162float(e[i]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < DPL; c += 2) {
      __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src + c);
      x[c] = __bfloat162float(v.x);
      x[c + 1] = __bfloat162float(v.y);
    }
  }
}

template <int DPL>
__device__ __forceinline__ void rotate(float (&x)[DPL], const float* sn,
                                       const float* cs) {
#pragma unroll
  for (int p = 0; p < DPL / 2; ++p) {
    float a = x[2 * p], b = x[2 * p + 1];
    x[2 * p] = a * cs[2 * p] - b * sn[2 * p];
    x[2 * p + 1] = b * cs[2 * p + 1] + a * sn[2 * p + 1];
  }
}

// grid ceil(B·N·H / 4), block 128; F <= FT frames (rows past F are masked).
template <int FT, int DH>
__global__ void __launch_bounds__(128)
time_attention_kernel(const bf16* __restrict__ qkv,
                      const float* __restrict__ sin_t,
                      const float* __restrict__ cos_t, bf16* __restrict__ out,
                      int B, int F, int N, int H, float scale) {
  using S = TimeShape<FT, DH>;
  constexpr int LPR = S::LPR, DPL = S::DPL, RS = S::RS;
  extern __shared__ float tsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long wid = (long)blockIdx.x * S::warps + warp;
  if (wid >= (long)B * N * H) return;  // whole warp leaves; no block barrier
  float* k_s = tsmem + warp * S::warp_floats;  // [32 lanes][RS]
  float* v_s = k_s + 32 * RS;

  const int h = (int)(wid % H);
  const int n = (int)((wid / H) % N);
  const int b = (int)(wid / ((long)H * N));
  const int HD = H * DH;
  const int i = lane / LPR, part = lane % LPR;
  const int d0 = part * DPL;
  const bool valid = i < F;

  float q[DPL], x[DPL];
  if (valid) {
    const bf16* row = qkv + (((long)b * F + i) * N + n) * 3L * HD + h * DH + d0;
    const float* sn = sin_t + i * DH + d0;
    const float* cs = cos_t + i * DH + d0;
    load_row<DPL>(row, q);
    rotate<DPL>(q, sn, cs);
#pragma unroll
    for (int d = 0; d < DPL; ++d) q[d] = round_bf16(q[d] * scale);
    load_row<DPL>(row + HD, x);
    rotate<DPL>(x, sn, cs);
#pragma unroll
    for (int d = 0; d < DPL; ++d) k_s[lane * RS + d] = round_bf16(x[d]);
    load_row<DPL>(row + 2 * HD, x);
#pragma unroll
    for (int d = 0; d < DPL; ++d) v_s[lane * RS + d] = x[d];
  } else {
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      q[d] = 0.f;
      k_s[lane * RS + d] = 0.f;
      v_s[lane * RS + d] = 0.f;
    }
  }
  __syncwarp();

  // scores of row i against every frame j; lane (j, part) holds row j's dims
  float s[FT];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < FT; ++j) {
    const float* kr = k_s + (j * LPR + part) * RS;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc = fmaf(q[d], kr[d], acc);
#pragma unroll
    for (int off = 1; off < LPR; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    s[j] = j < F ? acc : -INFINITY;
    mx = fmaxf(mx, s[j]);
  }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < FT; ++j) {
    float p = __expf(s[j] - mx);
    l += p;
    s[j] = round_bf16(p);  // P·V takes bf16 probabilities, as on the TPU
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) x[d] = 0.f;
#pragma unroll
  for (int j = 0; j < FT; ++j) {
    const float* vr = v_s + (j * LPR + part) * RS;
#pragma unroll
    for (int d = 0; d < DPL; ++d) x[d] = fmaf(s[j], vr[d], x[d]);
  }
  if (valid) {
    const float inv = 1.f / l;
    bf16* dst = out + (((long)b * F + i) * N + n) * HD + h * DH + d0;
#pragma unroll
    for (int d = 0; d < DPL; d += 2)
      *reinterpret_cast<uint32_t*>(dst + d) = pack_bf16(x[d] * inv, x[d + 1] * inv);
  }
}

template <int FT, int DH>
cudaError_t launch_time(const void* qkv, const void* sin_t, const void* cos_t,
                        void* out, int B, int F, int N, int H, float scale,
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
      static_cast<const float*>(cos_t), static_cast<bf16*>(out), B, F, N, H,
      scale);
  return cudaGetLastError();
}

}  // namespace mdt

extern "C" {

// qkv [BF, N, 3·H·dh] bf16, sin/cos [N, dh] fp32 -> out [BF, N, H·dh] bf16.
int divided_space_attention(const void* qkv, const void* sin_t,
                            const void* cos_t, void* out, int BF, int N, int H,
                            int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mdt::FlashArgs a =
      mdt::packed_args(qkv, sin_t, cos_t, out, N, H, dh, scale);
  // built for the head dim the repository's configurations reach (AE
  // dim_head 64); keep in step with SPACE_HEAD_DIMS in divided_attention.py
  if (dh == 64) return mdt::launch_flash<64, true>(a, BF, H, st);
  return cudaErrorInvalidValue;
}

// qkv [B, F, N, 3·H·dh] bf16, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh] bf16.
int divided_time_attention(const void* qkv, const void* sin_t,
                           const void* cos_t, void* out, int B, int F, int N,
                           int H, int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // built for the shape the repository's configurations reach (16 frames,
  // dim_head 64); keep in step with TIME_SHAPES in divided_attention.py
  if (F == 16 && dh == 64)
    return mdt::launch_time<16, 64>(qkv, sin_t, cos_t, out, B, F, N, H, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
