// The divided time attention at clips of 8 frames (the frame class 16) and
// of 24 and 32 (the frame class 32), bf16 and float32: replaces _time_kernel
// of moditalker_tpu/ops/pallas/divided_attention.py at those lengths.
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
//    of 13.8 KB in bf16 at head dim 64, 8 of 24 KB in float32, at 32
//    frames), so while some warps compute the others' copies keep device
//    memory busy.
//  * at 8 frames (the frame class 16) a warp's 16-row tile holds two items,
//    rows 0-7 and 8-15 (PAIR), each item's keys in their own n8 tile of S
//    and the other item's scoring -inf before the max (tiny_attend's
//    PAIRS): no copy is a zero fill, the table is 8 frames, and a warp
//    carries two items in the class's 6.8 KB (bf16) or 12 KB (float32)
//    buffer at head dim 64, twice the items in flight of a padded tile
//    (tools/ab_classes.py --time8 times both). The output is the class's
//    bit for bit: a row's scores, max, sum and products are those of its
//    item padded to 16 rows (a zero weight on the other item's v adds 0);
//    but a non-finite v of one item reaches its partner's output through
//    that zero weight (0 x inf), where the class keeps items apart.
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

// PAIR (8 frames, FT = 16): two items a warp's tile, the table 8 frames.
template <int FT, int DH, typename TI, bool PAIR = false>
struct StagedTime {
  static_assert(!PAIR || FT == 16, "two items of 8 frames in an m16 tile");
  static constexpr bool kF32 = std::is_same<TI, float>::value;
  static constexpr int TR = PAIR ? 8 : FT;          // table rows
  static constexpr int table_floats = 2 * TR * DH;  // sin, cos
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
// F <= FT, or F = 8 in the class 16; F % 8 == 0) of head dim dh (2 <= dh
// <= DH, dh dividing 128). PAIR (F = 8, FT = 16): a warp's tile holds two
// items, (b, n, h) = wid 2 i and 2 i + 1, in rows 0-7 and 8-15, each
// item's keys in their own n8 tile of S (the other item's score -inf
// before the max: tiny_attend's PAIRS), so a warp's copies and products
// carry two items where the padded tile carries one.
template <int FT, int DH, typename TI, bool PAIR = false>
__global__ void __launch_bounds__(32 * StagedTime<FT, DH, TI, PAIR>::warps)
time_attention_staged_kernel(const TI* __restrict__ qkv,
                             const float* __restrict__ sin_t,
                             const float* __restrict__ cos_t,
                             TI* __restrict__ out, int B, int N, int H,
                             float scale, int F, int dh) {
  using S = StagedTime<FT, DH, TI, PAIR>;
  using T = TinyTile<FT, DH>;
  constexpr int RS = T::RS, CH = T::CH, TR = S::TR;
  constexpr bool kF32 = S::kF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sin_s = reinterpret_cast<float*>(smem_raw);  // [TR][DH]
  float* cos_s = sin_s + TR * DH;
  stage_table<TR, DH>(sin_s, sin_t, F, dh, 32 * S::warps);
  stage_table<TR, DH>(cos_s, cos_t, F, dh, 32 * S::warps);
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
  // a tile's items (PAIR: two) and, for tile row r, its item and frame
  constexpr int IT = PAIR ? 2 : 1;
  auto item_of = [](int r) { return PAIR ? r >> 3 : 0; };
  auto frame_of = [](int r) { return PAIR ? r & 7 : r; };
  if (dh < 8) {
    // a row's dh elements are copied alone: the rest of the buffer stays the
    // zeros written here (q and k are rewritten whole by the rotation, v's
    // padding by nothing; the float32 loader reads no element past dh)
    for (int i = lane; i < S::warp_bytes / 16; i += 32)
      *reinterpret_cast<uint4*>(buf + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  const long tasks = (items + IT - 1) / IT;
  for (long wid = (long)blockIdx.x * S::warps + warp; wid < tasks;
       wid += (long)gridDim.x * S::warps) {
    // each item's rows in qkv and the output, and whether it is one (the
    // last tile of an odd count holds one)
    const TI* src[IT];
    TI* dst[IT];
    bool live[IT];
#pragma unroll
    for (int t = 0; t < IT; ++t) {
      const long it = wid * IT + t;
      live[t] = it < items;
      const long idx = live[t] ? it : 0;
      const int h = (int)(idx % H);
      const int n = (int)((idx / H) % N);
      const int b = (int)(idx / ((long)H * N));
      src[t] = qkv + ((long)b * F * N + n) * 3L * HD + h * dh;
      dst[t] = out + ((long)b * F * N + n) * HD + h * dh;
    }
    // the rows of the tile inside an item's sequence
    auto in_seq = [&](int r) {
      return PAIR ? live[item_of(r)] : r < F;
    };

    // q, k, v rows into the buffer; rows past F and columns past dh zeros
    auto at = [&](int m, int r, int c) {  // the buffer's element (m, r, c)
      return buf_s + (kF32 ? ((m * FT + r) * DH + c) * 4
                           : ((m * FT + r) * RS + c) * 2);
    };
    if (dh >= 8) {
#pragma unroll
      for (int i = lane; i < FT * CH; i += 32) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool valid = in_seq(r) && c < dh;
        const TI* row =
            src[item_of(r)] + (valid ? frame_of(r) * in_frame + c : 0);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          cp_async16_or_zeros(at(m, r, c), row + m * HD, valid);
          if constexpr (kF32)
            cp_async16_or_zeros(at(m, r, c) + 16, row + m * HD + 4, valid);
        }
      }
    } else {
      for (int r = lane; r < F * IT; r += 32)
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if (!in_seq(r)) continue;  // PAIR: the other item's rows stay
          const TI* row = src[item_of(r)] + frame_of(r) * in_frame + m * HD;
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
            const int part = in_seq(r) ? dh - c : 0;
            const int tr = frame_of(r);  // the table row
            const float* p = raw + (m * FT + r) * DH + c;
            if (m < 2)
              load8_part<true>(p, part, sin_s + tr * DH + c,
                               cos_s + tr * DH + c, m == 0 ? scale : 1.f,
                               x[u]);
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
        const int part = in_seq(r) ? dh - c : 0;
        const float* sn = sin_s + frame_of(r) * DH + c;
        const float* cs = cos_s + frame_of(r) * DH + c;
        float x[8];
        load8_part<true>(q_s + r * RS + c, part, sn, cs, scale, x);
        store8(q_s + r * RS + c, x);
        load8_part<true>(k_s + r * RS + c, part, sn, cs, 1.f, x);
        store8(k_s + r * RS + c, x);
      }
      __syncwarp();
    }
    tiny_attend<FT, DH, TI, true, PAIR>(q_s, k_s, v_s, lane, F);
    __syncwarp();
    if constexpr (kF32) {  // fp32 [FT, DH] at stride OS over q_s and k_s
      const float* o_s = reinterpret_cast<const float*>(q_s);
      for (int i = lane; i < FT * DH / 4; i += 32) {
        const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
        const float* o = o_s + r * T::OS + c;
        TI* d = dst[item_of(r)] + frame_of(r) * out_frame + c;
        if (in_seq(r) && c + 4 <= dh) {
          *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(o);
        } else if (in_seq(r)) {  // head dim 2: half a chunk
          for (int e = 0; c + e < dh; ++e) d[e] = o[e];
        }
      }
    } else {
      for (int i = lane; i < FT * CH; i += 32) {
        const int r = i / CH, c = (i % CH) * 8;
        TI* d = dst[item_of(r)] + frame_of(r) * out_frame + c;
        if (in_seq(r) && c + 8 <= dh) {
          *reinterpret_cast<uint4*>(d) =
              *reinterpret_cast<const uint4*>(q_s + r * RS + c);
        } else if (in_seq(r) && c < dh) {  // head dims 2 and 4
          store_part(d, q_s + r * RS + c, dh - c);
        }
      }
    }
    __syncwarp();  // the output read before the next item's copies land
  }
}

template <int FT, int DH, typename TI, bool PAIR = false>
cudaError_t launch_time_staged(const void* qkv, const void* sin_t,
                               const void* cos_t, void* out, int B, int F,
                               int N, int H, int dh, float scale,
                               cudaStream_t stream) {
  using S = StagedTime<FT, DH, TI, PAIR>;
  auto kern = time_attention_staged_kernel<FT, DH, TI, PAIR>;
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
  const long tasks = ((long)B * N * H + PAIR) / (PAIR ? 2 : 1);
  const long need = (tasks + S::warps - 1) / S::warps;
  const long blocks = need < (long)per_sm * sms ? need : (long)per_sm * sms;
  kern<<<(unsigned)blocks, 32 * S::warps, S::smem_bytes, stream>>>(
      static_cast<const TI*>(qkv), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<TI*>(out), B, N, H, scale,
      F, dh);
  return cudaGetLastError();
}

// Frames F = 8 (the frame class 16) or 16 < F <= 32 (the class 32), F % 8
// == 0, head dims dh dividing 128 from 2 up: the head-dim class 16, 32, 64
// or 128 that holds dh.
template <typename TI>
int launch_time_staged_classes(const void* qkv, const void* sin_t,
                               const void* cos_t, void* out, int B, int F,
                               int N, int H, int dh, float scale,
                               cudaStream_t stream) {
  if ((F != 8 && (F <= 16 || F > 32)) || F % 8 || dh < 2 || dh > 128 ||
      128 % dh)
    return cudaErrorInvalidValue;
#define MDT_STAGED(DH)                                                    \
  return F == 8 ? launch_time_staged<16, DH, TI, true>(qkv, sin_t, cos_t, \
                                                       out, B, F, N, H, dh, \
                                                       scale, stream)       \
                : launch_time_staged<32, DH, TI>(qkv, sin_t, cos_t, out,  \
                                                 B, F, N, H, dh, scale,   \
                                                 stream)
  switch (dh < 16 ? 16 : dh) {
    case 16: MDT_STAGED(16);
    case 32: MDT_STAGED(32);
    case 64: MDT_STAGED(64);
    case 128: MDT_STAGED(128);
  }
#undef MDT_STAGED
  return cudaErrorInvalidValue;
}

}  // namespace mdt
