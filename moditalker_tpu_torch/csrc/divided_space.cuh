// The divided space attention at the head dims its gate admits beyond the
// configurations' 64 (dh dividing 128 from 2 up), and at 64 in float32 past
// the wgmma tile's resident K (N > 1152): a rotation pre-pass, then one of
// the tiles the one-pass kernel runs on, reading what the pre-pass wrote.
// Replaces _space_kernel of moditalker_tpu/ops/pallas/divided_attention.py
// at those shapes (divided_attention.cuh keeps it at head dim 64).
//
// What held the small-head classes with the rotary back (PERF.md §6): at
// head dim 128 the tile is mma.sync with eight warps a block and a
// three-slot ring, 19 times its library call; at every width K passes
// through the registers of the warp on duty, which loads it, rotates it
// from the table in device memory and stores it, for every block of up to
// 256 query rows (N / 256 times per head), while the other warps wait on
// the slot. The rotary cannot ride a cp.async, which copies bytes. So:
//
//  * a pre-pass (space_rotate_kernel) writes, once per call, a bf16 scratch
//    [BF, N, 3 x H x w] (w = dh, 8 for heads of 2 and 4, zeros past dh):
//    q rotated and scaled in fp32 and rounded once, k rotated and rounded
//    once, and v rounded once where the tile cannot read it where it lies
//    (float32 qkv; heads narrower than a 16-byte chunk). Each thread takes
//    one 16-byte chunk of the scratch: 16 or 32 bytes of qkv and 32 bytes of
//    the pair table in, 16 bytes out. At qkv [32, 1024, 1536] bf16 that is
//    134 MB, 0.040 ms at 3.35 TB/s (float32: 302 MB with v), against the
//    0.0695 ms the attention's operations take at 989 TFLOP/s.
//  * K is rotated once per (frame, head), by the pre-pass, and every tile
//    then streams the scratch raw with cp.async, as the one-pass kernel
//    streams its inputs: Q with scale 1 (multiplying a bf16 value by 1 and
//    rounding it is exact, so q is rounded once), K and V into the rings.
//    The other design, the producer rotating each K chunk through its
//    registers as the D = 64 tile's K ring does, reads the table again
//    with every chunk: at dh = 128 a 32 KB tile of K needs 64 KB of fp32
//    table, rotated N / 128 times per head (K does not fit resident), and
//    the producer would need registers the consumers' S and O take.
//  * dh = 128 (and 64 in float32 past resident K): the wgmma tile built per
//    width (wgmma_wide.cuh, SPACE: the qkv row strides, a frame's heads as
//    its sequences, the output head-merged) with S = Q·Kᵀ and P·V on wgmma,
//    two consumer warpgroups of 64 rows, 128-key tiles.
//  * dh <= 32: the small-head tile's classes 16 and 32 (smallhead_tile.cuh,
//    PRE: no rotary in the tile, K and V by cp.async into its ring, the
//    output at its own head stride; heads of 2, 4 and 8 padded to 16):
//    ex2 at 16 per clock per SM bounds it, not the tensor cores.
//
// Rounding points are the TPU kernel's and divided_attention_float32_route's:
// q rotated (each product and the sum rounded on its own, rotate_pair_rn)
// and scaled in fp32 and rounded to bf16 once, k rotated and rounded once,
// v rounded once, fp32 scores, max and sums, p rounded to bf16 for P·V, the
// result divided by the fp32 row sum; float32 qkv gives a float32 result,
// stored from the accumulators. The scratch is the wrapper's
// (torch.empty); the kernels allocate nothing.
#pragma once

#include <type_traits>

#include "smallhead_tile.cuh"
#include "wgmma_wide.cuh"

namespace mdt {

// x, eight elements of a row (four rotary pairs), rotated by the pair
// table entries at tr ((cos, sin) of each pair), of which the first n
// elements exist (n < 8: a head of 2 or 4 dims; the rest are zeros),
// rounded as the plain rotary rounds it (rotate_pair_rn).
__device__ __forceinline__ void rotate8(float (&x)[8], const float* tr,
                                        int n) {
  float cs[4], sn[4];
  if (n >= 8) {
    const float4 t0 = reinterpret_cast<const float4*>(tr)[0];
    const float4 t1 = reinterpret_cast<const float4*>(tr)[1];
    cs[0] = t0.x; cs[1] = t0.z; cs[2] = t1.x; cs[3] = t1.z;
    sn[0] = t0.y; sn[1] = t0.w; sn[2] = t1.y; sn[3] = t1.w;
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      cs[p] = 2 * p < n ? tr[2 * p] : 0.f;
      sn[p] = 2 * p < n ? tr[2 * p + 1] : 0.f;
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
    rotate_pair_rn(x[2 * p], x[2 * p + 1], cs[p], sn[p], cs[p], sn[p]);
}

// The scratch's head width: whole 16-byte chunks of bf16.
__host__ __device__ constexpr int space_scratch_width(int dh) {
  return dh < 8 ? 8 : dh;
}

// grid ceil(BF x N x chunks / 256), block 256: chunk i of the scratch's
// `rows` rows, each `thirds` x H heads of w / 8 chunks (q, k, and v where
// thirds = 3); a chunk's elements past dh are zeros.
template <typename TI>
__global__ void __launch_bounds__(256)
space_rotate_kernel(const TI* __restrict__ qkv, const float* __restrict__ rot,
                    bf16* __restrict__ scratch, int rows, int N, int H,
                    int dh, int w, int thirds, float scale) {
  const int cw = w / 8, per_head = cw, per_third = H * cw;
  const int per_row = thirds * per_third;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * per_row) return;
  const long r = i / per_row;
  const int j = (int)(i - r * per_row);
  const int t = j / per_third, h = (j - t * per_third) / per_head;
  const int c = j % per_head;
  const int real = dh - 8 * c;  // elements of this chunk inside the head
  Chunk8<TI> raw;
  load_chunk(raw, qkv + r * 3 * H * dh + (t * H + h) * dh + 8 * c, real);
  float x[8];
  raw.to_float(x);
  if (t < 2) {  // q and k: rotated by the row's pair table entries
    rotate8(x, rot + (r % N) * dh + 8 * c, real);
    if (t == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= scale;
    }
  }
  *reinterpret_cast<uint4*>(scratch + r * 3 * H * w + (t * H + h) * w +
                            8 * c) = pack8_bf16(x);
}

// The pre-pass alone: the scratch's q and k thirds, and its v third where
// with_v; returns the launch's error.
template <typename TI>
cudaError_t launch_space_rotate(const TI* qkv, const float* rot, bf16* s,
                                int BF, int N, int H, int dh, bool with_v,
                                float scale, cudaStream_t stream) {
  const int w = space_scratch_width(dh), thirds = with_v ? 3 : 2;
  const long chunks = (long)BF * N * thirds * H * (w / 8);
  space_rotate_kernel<TI><<<(unsigned)((chunks + 255) / 256), 256, 0,
                            stream>>>(qkv, rot, s, BF * N, N, H, dh, w,
                                      thirds, scale);
  return cudaGetLastError();
}

// qkv [BF, N, 3·H·dh] (TI: bf16 or float32), rot [N, dh/2, 2] fp32 (cos,
// sin per rotated pair), scratch [BF, N, 3·H·space_scratch_width(dh)] bf16
// -> out [BF, N, H·dh] in TI; N % 128 == 0 from 256, dh dividing 128 from 2
// up, 64 in float32 only. Two launches: the pre-pass, then the tile.
template <typename TI>
int launch_space_prerotated(const void* qkv, const void* rot, void* scratch,
                            void* out, int BF, int N, int H, int dh,
                            float scale, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<TI, float>::value;
  if (dh < 2 || dh > 128 || 128 % dh || N < 256 || N % 128 || BF < 1 ||
      H < 1 || (dh == 64 && !kF32))
    return cudaErrorInvalidValue;
  const int w = space_scratch_width(dh);
  // v through the scratch where the tile cannot read it where it lies:
  // float32 (rounded there once) or a head narrower than a chunk
  const bool with_v = kF32 || w != dh;
  bf16* s = static_cast<bf16*>(scratch);
  cudaError_t err = launch_space_rotate<TI>(
      static_cast<const TI*>(qkv), static_cast<const float*>(rot), s, BF, N,
      H, dh, with_v, scale, stream);
  if (err != cudaSuccess) return err;

  const long hw = (long)H * w, row = 3 * hw;
  const bf16* v = s + 2 * hw;
  if constexpr (!kF32)
    if (!with_v) v = static_cast<const bf16*>(qkv) + 2L * H * dh;
  bf16* o = static_cast<bf16*>(out);  // holds TI elements
  const SmallHeadPreArgs sh{{s, s + hw, v, o, N * row, N * row, row,
                             (long)N * H * dh, H * dh, w, N, N, 1.f, dh},
                            dh};
  const WideSpaceArgs wd{{s, s + hw, v, o, N * row, N * row, dh, N, N, 1.f,
                          0, 0, 0, 0},
                         (long)N * H * dh, (int)row, H * dh, H};
  switch (dh < 16 ? 16 : dh) {
    case 16:   // heads of 2, 4 and 8 padded to 16
      return dh < 16 ? launch_smallhead<16, bf16, true, true, TI>(sh, BF, H,
                                                                  stream)
                     : launch_smallhead<16, bf16, false, true, TI>(sh, BF, H,
                                                                   stream);
    case 32:
      return launch_smallhead<32, bf16, false, true, TI>(sh, BF, H, stream);
    case 64:
      if constexpr (kF32) return launch_wide<64, bf16, true, TI>(wd, BF * H,
                                                                 stream);
      break;   // bf16 at 64 is the wgmma tile's (divided_attention.cu)
    case 128: return launch_wide<128, bf16, true, TI>(wd, BF * H, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace mdt
