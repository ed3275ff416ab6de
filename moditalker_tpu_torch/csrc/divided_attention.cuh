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
//
//  * float32 qkv (the trainers' and the golden record's extracts): each
//    kernel reads float32 and writes float32 itself. q is rotated and scaled in fp32 and rounded to bf16
//    once, k rotated and rounded once, v rounded once; the products take
//    bf16 operands with fp32 accumulators (what a float32 dot costs at
//    JAX's default precision on a TPU), p is rounded to bf16 for P·V, and
//    the output, divided by the fp32 row sum, is stored as float32, never
//    rounded to bf16. At float32 both kernels are bound by bytes (qkv read
//    once, the output written once: 1.34 GB at B = 10). Space: where it
//    read faster (the wrapper's space_f32_own_kernel) a kernel of its own
//    (resident_f32_tile.cuh: K rotated and V rounded once per (frame, head)
//    before the roles split, two consumer warpgroups); elsewhere the wgmma
//    tile's float32 route: the
//    loaders that rotate q and k read two float32 chunks where they read
//    one bf16 chunk; V passes through the producer's registers and is
//    rounded on its way into the ring (the producer gets 56 registers, the
//    consumers 152); the output leaves straight from the accumulator
//    fragments as 8-byte stores (a quad writes a whole 32-byte sector).
//    Both for resident K only (N <= 1152; past it, divided_space.cuh).
//    Time: twenty-four 16-byte loads per lane in flight, and the output
//    staged in fp32 over the warp's q and k buffers, then 16-byte stores.
//
// The kernels and their launchers; the C entry points are in
// divided_attention.cu (bf16) and divided_attention_f32.cu (float32). The
// space kernel at the other head dims, and at 64 in float32 past resident
// K, is divided_space.cuh's.
#pragma once

#include "tiny_tile.cuh"
#include "wgmma_tile.cuh"

namespace mdt {

template <int FT, int DH>
struct TimeShape {
  static constexpr int table_floats = 2 * FT * DH;  // sin, cos
  static constexpr int warp_bytes =
      TinyTile<FT, DH>::warp_elems * (int)sizeof(bf16);
  // blocks of eight warps unless four keep more warps on an SM (head dim
  // 128: one block of eight fits an SM's shared memory, three of four do)
  static constexpr int warps =
      resident_warps(4, table_floats * 4, warp_bytes) >
              resident_warps(8, table_floats * 4, warp_bytes)
          ? 4
          : 8;
  static constexpr int smem_bytes =
      table_floats * (int)sizeof(float) + warps * warp_bytes;
};

// grid ceil(B·N·H / 8), block 256; exactly FT frames. TI is qkv's element
// type and TO the output's: bf16 and bf16, or float32 and float32.
template <int FT, int DH, typename TI, typename TO>
__global__ void __launch_bounds__(32 * TimeShape<FT, DH>::warps)
time_attention_kernel(const TI* __restrict__ qkv,
                      const float* __restrict__ sin_t,
                      const float* __restrict__ cos_t, TO* __restrict__ out,
                      int B, int N, int H, float scale) {
  using S = TimeShape<FT, DH>;
  using T = TinyTile<FT, DH>;
  constexpr int RS = T::RS, CH = T::CH;
  constexpr bool kF32 = std::is_same<TI, float>::value;
  static_assert(std::is_same<TI, TO>::value, "output in qkv's type");
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
  const TI* src = qkv + ((long)b * FT * N + n) * 3L * HD + h * DH;

  // unrolled: all of a lane's loads are in flight together (twelve 16-byte
  // loads in bf16, twenty-four in float32)
#pragma unroll
  for (int i = lane; i < FT * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const TI* row = src + r * in_frame + c;
    const float* sn = sin_s + r * DH + c;
    const float* cs = cos_s + r * DH + c;
    float x[8];
    load8<true>(row, true, sn, cs, scale, x);
    store8(q_s + r * RS + c, x);
    load8<true>(row + HD, true, sn, cs, 1.f, x);
    store8(k_s + r * RS + c, x);
    if constexpr (kF32) {  // v rounded to bf16 once
      load8<false>(row + 2 * HD, true, nullptr, nullptr, 1.f, x);
      store8(v_s + r * RS + c, x);
    } else {
      *reinterpret_cast<uint4*>(v_s + r * RS + c) =
          *reinterpret_cast<const uint4*>(row + 2 * HD);
    }
  }
  __syncwarp();
  tiny_attend<FT, DH, TO>(q_s, k_s, v_s, lane);
  __syncwarp();
  TO* dst = out + ((long)b * FT * N + n) * HD + h * DH;
  if constexpr (kF32) {  // fp32 [FT, DH] at stride OS over q_s and k_s
    const float* o_s = reinterpret_cast<const float*>(q_s);
    for (int i = lane; i < FT * DH / 4; i += 32) {
      const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
      *reinterpret_cast<float4*>(dst + r * out_frame + c) =
          *reinterpret_cast<const float4*>(o_s + r * T::OS + c);
    }
  } else {
    for (int i = lane; i < FT * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      *reinterpret_cast<uint4*>(dst + r * out_frame + c) =
          *reinterpret_cast<const uint4*>(q_s + r * RS + c);
    }
  }
}


// The classes' time kernel (grid ceil(B·N·H / warps), block 32·warps), the
// kernel above at F <= FT frames (F % 8 == 0) of head dim dh <= DH (dh
// dividing 128): frames past F and columns past dh are loaded as zeros
// (frames masked in the softmax) and never stored, and the rotary and the
// exp are rounded as the plain versions round them (load8_part,
// tiny_attend's MASK). A kernel of its own, so that the configurations'
// instantiation above compiles as it did before the classes.
template <int FT, int DH, typename TI, typename TO>
__global__ void __launch_bounds__(32 * TimeShape<FT, DH>::warps)
time_attention_class_kernel(const TI* __restrict__ qkv,
                            const float* __restrict__ sin_t,
                            const float* __restrict__ cos_t,
                            TO* __restrict__ out, int B, int N, int H,
                            float scale, int F, int dh) {
  using S = TimeShape<FT, DH>;
  using T = TinyTile<FT, DH>;
  constexpr int RS = T::RS, CH = T::CH;
  constexpr bool kF32 = std::is_same<TI, float>::value;
  static_assert(std::is_same<TI, TO>::value, "output in qkv's type");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sin_s = reinterpret_cast<float*>(smem_raw);  // [FT][DH]
  float* cos_s = sin_s + FT * DH;
  stage_table<FT, DH>(sin_s, sin_t, F, dh, 32 * S::warps);
  stage_table<FT, DH>(cos_s, cos_t, F, dh, 32 * S::warps);
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
  const int HD = H * dh;
  const long in_frame = (long)N * 3 * HD, out_frame = (long)N * HD;
  const TI* src = qkv + ((long)b * F * N + n) * 3L * HD + h * dh;

  // unrolled: all of a lane's loads are in flight together (twelve 16-byte
  // loads in bf16, twenty-four in float32, at 16 frames of head dim 64)
#pragma unroll
  for (int i = lane; i < FT * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const TI* row = src + r * in_frame + c;
    const float* sn = sin_s + r * DH + c;
    const float* cs = cos_s + r * DH + c;
    float x[8];
    // the elements of this chunk inside the sequence and the head
    const int part = r < F ? dh - c : 0;
    load8_part<true>(row, part, sn, cs, scale, x);
    store8(q_s + r * RS + c, x);
    load8_part<true>(row + HD, part, sn, cs, 1.f, x);
    store8(k_s + r * RS + c, x);
    load8_part<false>(row + 2 * HD, part, nullptr, nullptr, 1.f, x);
    store8(v_s + r * RS + c, x);
  }
  __syncwarp();
  tiny_attend<FT, DH, TO, true>(q_s, k_s, v_s, lane, F);
  __syncwarp();
  TO* dst = out + ((long)b * F * N + n) * HD + h * dh;
  if constexpr (kF32) {  // fp32 [FT, DH] at stride OS over q_s and k_s
    const float* o_s = reinterpret_cast<const float*>(q_s);
    for (int i = lane; i < FT * DH / 4; i += 32) {
      const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
      const float* o = o_s + r * T::OS + c;
      if (r < F && c + 4 <= dh) {
        *reinterpret_cast<float4*>(dst + r * out_frame + c) =
            *reinterpret_cast<const float4*>(o);
      } else if (r < F) {  // head dim 2: half a chunk
        for (int e = 0; c + e < dh; ++e) dst[r * out_frame + c + e] = o[e];
      }
    }
  } else {
    for (int i = lane; i < FT * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      if (r < F && c + 8 <= dh) {
        *reinterpret_cast<uint4*>(dst + r * out_frame + c) =
            *reinterpret_cast<const uint4*>(q_s + r * RS + c);
      } else if (r < F && c < dh) {  // head dims 2 and 4
        store_part(dst + r * out_frame + c, q_s + r * RS + c, dh - c);
      }
    }
  }
}

template <int FT, int DH, typename TI, bool PAD = false>
cudaError_t launch_time(const void* qkv, const void* sin_t, const void* cos_t,
                        void* out, int B, int F, int N, int H, int dh,
                        float scale, cudaStream_t stream) {
  using S = TimeShape<FT, DH>;
  long warps = (long)B * N * H;
  unsigned blocks = (unsigned)((warps + S::warps - 1) / S::warps);
  const TI* x = static_cast<const TI*>(qkv);
  const float *sn = static_cast<const float*>(sin_t),
              *cs = static_cast<const float*>(cos_t);
  TI* o = static_cast<TI*>(out);
  if constexpr (PAD) {
    auto kern = time_attention_class_kernel<FT, DH, TI, TI>;
    if (S::smem_bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
      if (err != cudaSuccess) return err;
    }
    kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(
        x, sn, cs, o, B, N, H, scale, F, dh);
  } else {
    auto kern = time_attention_kernel<FT, DH, TI, TI>;
    if (S::smem_bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
      if (err != cudaSuccess) return err;
    }
    kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(x, sn, cs, o, B, N,
                                                           H, scale);
  }
  return cudaGetLastError();
}

// Frames 8 and 16 (F % 8 == 0 up to 16), head dims dh dividing 128 from 2
// up: the frame class 16 and the head-dim class 16, 32, 64 or 128 that hold
// them, with the classes' padding, masking and rounding (PAD), also where
// the shape is its class. The wrappers send it 16 frames: 8 frames and the
// frame class 32 (24 and 32 frames) are the staged kernel's
// (time_staged.cuh), whose output at 8 frames is this kernel's bit for bit
// (the card tests and tools/ab_classes.py --time8 call this one there).
template <typename TI>
int launch_time_classes(const void* qkv, const void* sin_t, const void* cos_t,
                        void* out, int B, int F, int N, int H, int dh,
                        float scale, cudaStream_t stream) {
  if (F < 8 || F > 16 || F % 8 || dh < 2 || dh > 128 || 128 % dh)
    return cudaErrorInvalidValue;
#define MDT_TIME(DH)                                                      \
  return launch_time<16, DH, TI, true>(qkv, sin_t, cos_t, out, B, F, N, H, \
                                       dh, scale, stream)
  switch (dh < 16 ? 16 : dh) {
    case 16: MDT_TIME(16);
    case 32: MDT_TIME(32);
    case 64: MDT_TIME(64);
    case 128: MDT_TIME(128);
  }
#undef MDT_TIME
  return cudaErrorInvalidValue;
}

// qkv [BF, N, 3·H·dh] -> out [BF, N, H·dh], both of element type T (in
// float32 where the wrapper passes a V scratch, resident_f32_tile.cuh's
// kernel instead).
template <typename T>
int launch_space(const void* qkv, const void* rot, void* out, int BF, int N,
                 int H, int dh, float scale, cudaStream_t stream) {
  // built for the head dim the repository's configurations reach (AE
  // dim_head 64); keep in step with SPACE_HEAD_DIMS in divided_attention.py
  if (dh != kWgD) return cudaErrorInvalidValue;
  const T* base = static_cast<const T*>(qkv);
  const long hd = (long)H * dh;
  WgmmaArgsT<T, T> a{base, base + hd, base + 2 * hd,
                     static_cast<const float*>(rot), static_cast<T*>(out),
                     N * 3 * hd, N * 3 * hd, 3 * hd, N * hd, hd, dh, N, N,
                     scale};
  return launch_wgmma<true, T, T>(a, BF, H, stream);
}

}  // namespace mdt
