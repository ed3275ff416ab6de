// Attention of one warp over one tiny sequence held in its shared buffer.
//
// Shared by the tiny-L kernel (tiny_attention.cu: contiguous [B, 16, D]) and
// the divided time-attention kernel (divided_attention.cu: the same
// attention with the time rotary, read straight out of the packed
// projection). Both are bound by bytes; what they share is the arithmetic
// between the loads and the stores.
//
// q_s (already scaled, and rotated where the caller rotates), k_s and v_s
// are [16, D] bf16 with row stride D + 8, written by the calling warp and
// made visible with __syncwarp(). S = Q·Kᵀ (fp32) and O = P·V run as
// mma.sync m16n8k16: at 16 rows the score tile is exactly one 16 x 16
// accumulator pair, so the softmax is a full-row one in registers (row max
// and fp32 row sum over the quad), P is rounded to bf16 for the second
// product and the output is divided by the row sum after it: the TPU
// kernels' rounding points. wgmma is not used: a 16-row problem cannot fill
// a 64-row warpgroup tile. The padded stride keeps the fragment loads on 32
// distinct banks. The output overwrites q_s: bf16 [16, D] at stride D + 8,
// or, for a float32 output (O = float: the time kernel's float32 route),
// fp32 [16, D] at stride D + 8 floats over q_s and k_s, never rounded to
// bf16; the caller runs __syncwarp() before it reads it.
//
// load8 and store8 move eight elements of a row between device memory (bf16
// or float32) and a warp's bf16 buffer, through fp32 where the caller scales
// or rotates them, rounded to bf16 once.
#pragma once

#include <type_traits>

#include "ptx.cuh"

namespace mdt {

// Eight consecutive elements of one row (bf16 or float32), rotated
// (rotate-every-two: out[2i] = x[2i]·cos - x[2i+1]·sin, out[2i+1] =
// x[2i+1]·cos + x[2i]·sin) when ROT, times `mul`, in fp32. Rows past the
// sequence end read as zeros.
template <bool ROT, typename T>
__device__ __forceinline__ void load8(const T* src, bool valid,
                                      const float* sn, const float* cs,
                                      float mul, float (&x)[8]) {
  if (!valid) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = 0.f;
    return;
  }
  Chunk8<T> in;
  in.load(src);
  in.to_float(x);
  if (ROT) {
    float s[8], c[8];
    *reinterpret_cast<float4*>(s) = reinterpret_cast<const float4*>(sn)[0];
    *reinterpret_cast<float4*>(s + 4) = reinterpret_cast<const float4*>(sn)[1];
    *reinterpret_cast<float4*>(c) = reinterpret_cast<const float4*>(cs)[0];
    *reinterpret_cast<float4*>(c + 4) = reinterpret_cast<const float4*>(cs)[1];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float a = x[2 * p], b = x[2 * p + 1];
      x[2 * p] = a * c[2 * p] - b * s[2 * p];
      x[2 * p + 1] = b * c[2 * p + 1] + a * s[2 * p + 1];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] *= mul;
}

__device__ __forceinline__ void store8(bf16* dst, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(dst) = pack8_bf16(x);
}

template <int L, int D>
struct TinyTile {
  static_assert(L == 16, "one m16 tile of query rows per warp");
  static_assert(D % 16 == 0, "contraction in k16 steps");
  static constexpr int RS = D + 8;            // padded smem row stride (bf16)
  static constexpr int CH = D / 8;            // 16-byte chunks per row
  static constexpr int warp_elems = 3 * L * RS;  // q, k, v
  // a float32 output's row stride (floats): [L, OS] fp32 fills q_s and k_s
  // exactly, and a half-warp's 8-byte stores land on 32 distinct banks
  static constexpr int OS = D + 8;
  static_assert(L * OS * 4 == 2 * L * RS * 2, "fp32 output over q_s, k_s");
};

template <int L, int D, typename O = bf16>
__device__ __forceinline__ void tiny_attend(bf16* q_s, const bf16* k_s,
                                            const bf16* v_s, int lane) {
  constexpr int RS = TinyTile<L, D>::RS;
  constexpr int OS = TinyTile<L, D>::OS;
  const int g = lane >> 2, t = lane & 3;

  // S = Q·Kᵀ: 16 rows x 16 keys, two n8 tiles
  float s[L / 8][4];
#pragma unroll
  for (int nt = 0; nt < L / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    const bf16* p0 = q_s + g * RS + kk * 16 + 2 * t;
    const bf16* p1 = p0 + 8 * RS;
    qa[0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qa[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
#pragma unroll
    for (int nt = 0; nt < L / 8; ++nt) {
      const bf16* kp = k_s + (nt * 8 + g) * RS + kk * 16 + 2 * t;
      mma_16816(s[nt], qa, *reinterpret_cast<const uint32_t*>(kp),
                *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }

  // full-row softmax; rows g (r = 0) and g + 8 (r = 1), each over a quad
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < L / 8; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < L / 8; ++nt) {
      s[nt][2 * r] = __expf(s[nt][2 * r] - mx);
      s[nt][2 * r + 1] = __expf(s[nt][2 * r + 1] - mx);
      sum += s[nt][2 * r] + s[nt][2 * r + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = sum;
  }

  // O = P·V, P re-packed from the S accumulators as one bf16 A fragment
  uint32_t pa[4];
  pa[0] = pack_bf16(s[0][0], s[0][1]);
  pa[1] = pack_bf16(s[0][2], s[0][3]);
  pa[2] = pack_bf16(s[1][0], s[1][1]);
  pa[3] = pack_bf16(s[1][2], s[1][3]);
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const unsigned short* v_u = reinterpret_cast<const unsigned short*>(v_s);
  // every lane has read its q and k fragments: q_s (and, for a float32
  // output, k_s after it) becomes the output
  __syncwarp();
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    // B fragment: V[2t][n], V[2t+1][n] and V[2t+8][n], V[2t+9][n], n = nd·8 + g
    const int col = nd * 8 + g;
    const uint32_t b0 = v_u[(2 * t) * RS + col] |
                        ((uint32_t)v_u[(2 * t + 1) * RS + col] << 16);
    const uint32_t b1 = v_u[(2 * t + 8) * RS + col] |
                        ((uint32_t)v_u[(2 * t + 9) * RS + col] << 16);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    mma_16816(o, pa, b0, b1);
    if constexpr (std::is_same<O, float>::value) {
      float* o_s = reinterpret_cast<float*>(q_s);
      *reinterpret_cast<float2*>(o_s + g * OS + nd * 8 + 2 * t) =
          make_float2(o[0] * inv0, o[1] * inv0);
      *reinterpret_cast<float2*>(o_s + (g + 8) * OS + nd * 8 + 2 * t) =
          make_float2(o[2] * inv1, o[3] * inv1);
    } else {
      *reinterpret_cast<uint32_t*>(q_s + g * RS + nd * 8 + 2 * t) =
          pack_bf16(o[0] * inv0, o[1] * inv0);
      *reinterpret_cast<uint32_t*>(q_s + (g + 8) * RS + nd * 8 + 2 * t) =
          pack_bf16(o[2] * inv1, o[3] * inv1);
    }
  }
}

}  // namespace mdt
