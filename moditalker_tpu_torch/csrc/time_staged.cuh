// The divided time attention at clips of 24 and 32 frames (the frame class
// 32), bf16 and float32: replaces _time_kernel of
// moditalker_tpu/ops/pallas/divided_attention.py at those lengths.
//
// Per patch it is self-attention over the F frames with the 1D time rotary,
// [B, F, N, 3·H·dh] -> [B, F, N, H·dh]. At qkv [2, 32, 1024, 1536] it moves
// 268 MB (bf16) for 4.3 GFLOP: bound by bytes, 0.080 ms at the card's
// 3.35 TB/s. The classes' kernel (divided_attention.cuh) gives each warp
// one (b, n, head) and loads its rows through registers with the rotary on
// the way; at 32 frames a warp's tile is 13.8 KB of shared memory, 12
// warps fit an SM, and each warp's loads, products and stores run in turn,
// so the reads from device memory stop while a warp computes. Here:
//
//  * a warp copies its item's raw q, k and v rows into its shared buffer
//    with cp.async, every copy of the item in flight at once and none
//    through registers (rows past F and columns past dh zero-filled by the
//    copies; heads of 2 and 4 dims, narrower than a 16-byte chunk, copy
//    their dh elements alone into a buffer zeroed once), then rotates and
//    scales q and rotates k in shared memory, each
//    chunk rounded to bf16 once: the classes' loader's arithmetic
//    (load8_part) on the same values, so the output is the class's bit for
//    bit. bf16 rows land in the tile the products read (stride dh + 8) and
//    are rotated in place; float32 rows land unpadded, [3][FT][DH] fp32,
//    and are rounded into the bf16 tile written over the start of that
//    buffer, a few rows at a time, each group read before it is
//    overwritten.
//  * blocks stay resident (grid: as many as the SMs hold) and each warp
//    walks items grid-stride; the rotary tables are staged once per block,
//    and the block holds as many warps as fit the SM's shared memory (15
//    of 13.8 KB in bf16 at head dim 64, 8 of 24 KB in float32), so while
//    some warps compute the others' copies keep device memory busy.
//  * the products, the masked softmax with the plain version's expf and
//    the output through the buffer are the class's (tiny_tile.cuh's
//    tiny_attend with MASK).
#pragma once

#include <type_traits>

#include "tiny_tile.cuh"

namespace mdt {

// The warps a block of `warp_bytes` each beside `fixed` bytes takes: the
// count that keeps the most warps on an SM, the larger of equal counts (one
// table staged for more warps).
constexpr int staged_block_warps(int fixed, int warp_bytes) {
  int best = 1;
  for (int w = 2; w <= 16; ++w)
    if (resident_warps(w, fixed, warp_bytes) >=
        resident_warps(best, fixed, warp_bytes))
      best = w;
  return best;
}

template <int FT, int DH, typename TI>
struct StagedTime {
  static constexpr bool kF32 = std::is_same<TI, float>::value;
  static constexpr int table_floats = 2 * FT * DH;  // sin, cos
  // a warp's buffer: bf16, the tile tiny_attend reads; float32, the raw rows
  // [3][FT][DH], the bf16 tile written over its start
  static constexpr int tile_bytes = TinyTile<FT, DH>::warp_elems * 2;
  static constexpr int warp_bytes = kF32 ? 3 * FT * DH * 4 : tile_bytes;
  static_assert(warp_bytes >= tile_bytes, "the bf16 tile fits the buffer");
  static constexpr int warps = staged_block_warps(table_floats * 4, warp_bytes);
  static constexpr int smem_bytes = table_floats * 4 + warps * warp_bytes;
};

// `BYTES` (4, 8 or 16) from src to dst by cp.async: the first elements of a
// row narrower than a 16-byte chunk.
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(BYTES)
               : "memory");
}

// grid: at most the blocks the SMs hold, block 32·warps; F frames (FT / 2 <
// F <= FT, F % 8 == 0) of head dim dh (2 <= dh <= DH, dh dividing 128).
template <int FT, int DH, typename TI>
__global__ void __launch_bounds__(32 * StagedTime<FT, DH, TI>::warps)
time_attention_staged_kernel(const TI* __restrict__ qkv,
                             const float* __restrict__ sin_t,
                             const float* __restrict__ cos_t,
                             TI* __restrict__ out, int B, int N, int H,
                             float scale, int F, int dh) {
  using S = StagedTime<FT, DH, TI>;
  using T = TinyTile<FT, DH>;
  constexpr int RS = T::RS, CH = T::CH;
  constexpr bool kF32 = S::kF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sin_s = reinterpret_cast<float*>(smem_raw);  // [FT][DH]
  float* cos_s = sin_s + FT * DH;
  stage_table<FT, DH>(sin_s, sin_t, F, dh, 32 * S::warps);
  stage_table<FT, DH>(cos_s, cos_t, F, dh, 32 * S::warps);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* buf = smem_raw + S::table_floats * 4 + warp * S::warp_bytes;
  const uint32_t buf_s = smem_u32(buf);
  bf16* q_s = reinterpret_cast<bf16*>(buf);
  bf16* k_s = q_s + FT * RS;
  bf16* v_s = k_s + FT * RS;
  const int HD = H * dh;
  const long in_frame = (long)N * 3 * HD, out_frame = (long)N * HD;
  const long items = (long)B * N * H;
  if (dh < 8) {
    // a row's dh elements are copied alone: the rest of the buffer stays the
    // zeros written here (q and k are rewritten whole by the rotation, v's
    // padding by nothing; the float32 loader reads no element past dh)
    for (int i = lane; i < S::warp_bytes / 16; i += 32)
      *reinterpret_cast<uint4*>(buf + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  for (long wid = (long)blockIdx.x * S::warps + warp; wid < items;
       wid += (long)gridDim.x * S::warps) {
    const int h = (int)(wid % H);
    const int n = (int)((wid / H) % N);
    const int b = (int)(wid / ((long)H * N));
    const TI* src = qkv + ((long)b * F * N + n) * 3L * HD + h * dh;

    // q, k, v rows into the buffer; rows past F and columns past dh zeros
    auto at = [&](int m, int r, int c) {  // the buffer's element (m, r, c)
      return buf_s + (kF32 ? ((m * FT + r) * DH + c) * 4
                           : ((m * FT + r) * RS + c) * 2);
    };
    if (dh >= 8) {
#pragma unroll
      for (int i = lane; i < FT * CH; i += 32) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool valid = r < F && c < dh;
        const TI* row = src + (valid ? r * in_frame + c : 0);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          cp_async16_or_zeros(at(m, r, c), row + m * HD, valid);
          if constexpr (kF32)
            cp_async16_or_zeros(at(m, r, c) + 16, row + m * HD + 4, valid);
        }
      }
    } else {
      for (int r = lane; r < F; r += 32)
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const TI* row = src + r * in_frame + m * HD;
          if (dh == 2)
            cp_async_bytes<2 * sizeof(TI)>(at(m, r, 0), row);
          else
            cp_async_bytes<4 * sizeof(TI)>(at(m, r, 0), row);
        }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    if constexpr (kF32) {
      // q rotated and scaled, k rotated, v as it is, each rounded to bf16
      // once into the tile over the raw rows: a group of rows is read into
      // registers before any of it is written (the tile's rows are narrower
      // than the raw ones, so a group's tile rows cover only raw rows read)
      const float* raw = reinterpret_cast<const float*>(buf);
      constexpr int kPer = FT * CH / 32 < 8 ? FT * CH / 32 : 8;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
#pragma unroll
        for (int u0 = 0; u0 < FT * CH; u0 += 32 * kPer) {
          float x[kPer][8];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = u0 + lane + 32 * u, r = i / CH, c = (i % CH) * 8;
            const int part = r < F ? dh - c : 0;
            const float* p = raw + (m * FT + r) * DH + c;
            if (m < 2)
              load8_part<true>(p, part, sin_s + r * DH + c, cos_s + r * DH + c,
                               m == 0 ? scale : 1.f, x[u]);
            else
              load8_part<false>(p, part, nullptr, nullptr, 1.f, x[u]);
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = u0 + lane + 32 * u, r = i / CH, c = (i % CH) * 8;
            store8(q_s + (m * FT + r) * RS + c, x[u]);
          }
          __syncwarp();
        }
      }
    } else {
      // q rotated and scaled, k rotated, in place; v as copied
#pragma unroll
      for (int i = lane; i < FT * CH; i += 32) {
        const int r = i / CH, c = (i % CH) * 8;
        const int part = r < F ? dh - c : 0;
        const float* sn = sin_s + r * DH + c;
        const float* cs = cos_s + r * DH + c;
        float x[8];
        load8_part<true>(q_s + r * RS + c, part, sn, cs, scale, x);
        store8(q_s + r * RS + c, x);
        load8_part<true>(k_s + r * RS + c, part, sn, cs, 1.f, x);
        store8(k_s + r * RS + c, x);
      }
      __syncwarp();
    }
    tiny_attend<FT, DH, TI, true>(q_s, k_s, v_s, lane, F);
    __syncwarp();
    TI* dst = out + ((long)b * F * N + n) * HD + h * dh;
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
    __syncwarp();  // the output read before the next item's copies land
  }
}

template <int DH, typename TI>
cudaError_t launch_time_staged(const void* qkv, const void* sin_t,
                               const void* cos_t, void* out, int B, int F,
                               int N, int H, int dh, float scale,
                               cudaStream_t stream) {
  using S = StagedTime<32, DH, TI>;
  auto kern = time_attention_staged_kernel<32, DH, TI>;
  cudaError_t err = cudaSuccess;
  if (S::smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, 32 * S::warps, S::smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long items = (long)B * N * H;
  const long need = (items + S::warps - 1) / S::warps;
  const long blocks = need < (long)per_sm * sms ? need : (long)per_sm * sms;
  kern<<<(unsigned)blocks, 32 * S::warps, S::smem_bytes, stream>>>(
      static_cast<const TI*>(qkv), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<TI*>(out), B, N, H, scale,
      F, dh);
  return cudaGetLastError();
}

// Frames 16 < F <= 32, F % 8 == 0, head dims dh dividing 128 from 2 up: the
// head-dim class 16, 32, 64 or 128 that holds dh.
template <typename TI>
int launch_time_staged_classes(const void* qkv, const void* sin_t,
                               const void* cos_t, void* out, int B, int F,
                               int N, int H, int dh, float scale,
                               cudaStream_t stream) {
  if (F <= 16 || F > 32 || F % 8 || dh < 2 || dh > 128 || 128 % dh)
    return cudaErrorInvalidValue;
  switch (dh < 16 ? 16 : dh) {
    case 16: return launch_time_staged<16, TI>(qkv, sin_t, cos_t, out, B, F,
                                               N, H, dh, scale, stream);
    case 32: return launch_time_staged<32, TI>(qkv, sin_t, cos_t, out, B, F,
                                               N, H, dh, scale, stream);
    case 64: return launch_time_staged<64, TI>(qkv, sin_t, cos_t, out, B, F,
                                               N, H, dh, scale, stream);
    case 128: return launch_time_staged<128, TI>(qkv, sin_t, cos_t, out, B,
                                                 F, N, H, dh, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace mdt
