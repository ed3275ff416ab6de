// Attention of one warp over one tiny sequence held in its shared buffer.
//
// Shared by the tiny-L kernel (tiny_attention.cu: contiguous [B, L, D]) and
// the divided time-attention kernel (divided_attention.cu: the same
// attention with the time rotary, read straight out of the packed
// projection). Both are bound by bytes; what they share is the arithmetic
// between the loads and the stores.
//
// A tile is built per row class L (16 or 32 rows: one or two m16 tiles of
// queries) and head-dim class D (16, 32, 64 or 128). q_s (already scaled,
// and rotated where the caller rotates), k_s and v_s are [L, D] bf16 with
// row stride D + 8, written by the calling warp and made visible with
// __syncwarp(). S = Q·Kᵀ (fp32) and O = P·V run as mma.sync m16n8k16: the
// score tile is one (L = 16) or two (L = 32) m16 tiles over all L keys, so
// the softmax is a full-row one in registers (row max and fp32 row sum over
// the quad), P is rounded to bf16 for the second product and the output is
// divided by the row sum after it: the TPU kernels' rounding points. wgmma
// is not used: a 16- or 32-row problem cannot fill a 64-row warpgroup tile.
// The padded stride keeps the fragment loads on 32 distinct banks. The
// output overwrites q_s: bf16 [L, D] at stride D + 8, or, for a float32
// output (O = float: the float32 routes), fp32 [L, D] at stride D + 8 floats
// over q_s and k_s, never rounded to bf16; the caller runs __syncwarp()
// before it reads it.
//
// A sequence shorter than its class (MASK: 8 rows in a 16-row tile, 24 in a
// 32-row one) has its rows past `lr` loaded as zeros by the caller; their
// keys score -inf before the max (a zero key would score 0 and take
// weight), and their query rows are computed but never stored. A head
// narrower than its class has its columns past the true width loaded as
// zeros: they add nothing to a score and give output columns that are
// never stored.
//
// load8 and store8 move eight elements of a row between device memory (bf16
// or float32) and a warp's bf16 buffer, through fp32 where the caller scales
// or rotates them, rounded to bf16 once; load8_part does the same for a
// chunk only `n` of whose elements lie inside the row.
#pragma once

#include <type_traits>

#include "ptx.cuh"

namespace mdt {

// Eight consecutive elements of one row (bf16 or float32), rotated
// (rotate-every-two: out[2i] = x[2i]·cos - x[2i+1]·sin, out[2i+1] =
// x[2i+1]·cos + x[2i]·sin) when ROT, times `mul`, in fp32. Rows past the
// sequence end read as zeros. RN: the rotation rounded as the plain rotary
// rounds it (rotate_pair_rn), the classes' form.
template <bool ROT, typename T, bool RN = false>
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
      if (RN) {
        rotate_pair_rn(x[2 * p], x[2 * p + 1], c[2 * p], s[2 * p],
                       c[2 * p + 1], s[2 * p + 1]);
      } else {
        float a = x[2 * p], b = x[2 * p + 1];
        x[2 * p] = a * c[2 * p] - b * s[2 * p];
        x[2 * p + 1] = b * c[2 * p + 1] + a * s[2 * p + 1];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] *= mul;
}

__device__ __forceinline__ void store8(bf16* dst, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(dst) = pack8_bf16(x);
}

__device__ __forceinline__ float elem_to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float elem_to_float(float x) { return x; }

// load8 for a chunk of which the first `n` elements lie inside the row: all
// eight (n >= 8) as load8 reads them, a few one by one (a row narrower than
// a chunk: head dims 2 and 4), none (n <= 0: a padded row or column) as
// zeros. The table entries of the elements past n are not read. The
// classes' loader: the rotation rounded as the plain rotary rounds it.
template <bool ROT, typename T>
__device__ __forceinline__ void load8_part(const T* src, int n,
                                           const float* sn, const float* cs,
                                           float mul, float (&x)[8]) {
  if (n >= 8) {
    load8<ROT, T, true>(src, true, sn, cs, mul, x);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = i < n ? elem_to_float(src[i]) : 0.f;
  if (ROT) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (2 * p < n)
        rotate_pair_rn(x[2 * p], x[2 * p + 1], cs[2 * p], sn[2 * p],
                       cs[2 * p + 1], sn[2 * p + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] *= mul;
}

// A [F][dh] fp32 table into a [FT][DH] one in shared memory, zeros around
// it, by `threads` threads of the block: four floats a load where dh allows
// (every head dim but 2).
template <int FT, int DH>
__device__ __forceinline__ void stage_table(float* dst, const float* src,
                                            int F, int dh, int threads) {
  if (dh % 4 == 0) {
    for (int i = threadIdx.x; i < FT * DH / 4; i += threads) {
      const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
      reinterpret_cast<float4*>(dst)[i] =
          r < F && c < dh
              ? *reinterpret_cast<const float4*>(src + r * dh + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < FT * DH; i += threads) {
      const int r = i / DH, c = i % DH;
      dst[i] = r < F && c < dh ? src[r * dh + c] : 0.f;
    }
  }
}

// The first n (< 8) of a chunk of bf16 buffer values, one by one.
__device__ __forceinline__ void store_part(bf16* dst, const bf16* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

// Warps an SM holds with blocks of `warps` warps of `warp_bytes` shared
// memory each beside `fixed` bytes a block (a block may have 227 KB, an SM
// 228 KB): 0 where the block does not fit.
constexpr int resident_warps(int warps, int fixed, int warp_bytes) {
  return fixed + warps * warp_bytes > 232448
             ? 0
             : warps * (233472 / (fixed + warps * warp_bytes));
}

template <int L, int D>
struct TinyTile {
  static_assert(L == 16 || L == 32, "one or two m16 tiles of query rows");
  static_assert(D % 16 == 0 && D <= 128, "contraction in k16 steps");
  static constexpr int RS = D + 8;            // padded smem row stride (bf16)
  static constexpr int CH = D / 8;            // 16-byte chunks per row
  static constexpr int warp_elems = 3 * L * RS;  // q, k, v
  // a float32 output's row stride (floats): [L, OS] fp32 fills q_s and k_s
  // exactly, and a half-warp's 8-byte stores land on 32 distinct banks
  static constexpr int OS = D + 8;
  static_assert(L * OS * 4 == 2 * L * RS * 2, "fp32 output over q_s, k_s");
};

// MASK (the classes' tiles): keys at or past `lr` (the true sequence
// length) weigh nothing, and p = expf(s − max), the exp the plain softmax
// takes, where the configurations' tile takes the faster __expf. PAIRS (L =
// 16, with MASK): two sequences of 8 in one tile, rows and keys 0-7 and
// 8-15; a row's keys of the other sequence (the other n8 tile of S) weigh
// nothing instead, so each row's scores, max, sum and P·V are those of its
// sequence alone padded to 16 (a zero weight times the other's v adds 0).
template <int L, int D, typename O = bf16, bool MASK = false,
          bool PAIRS = false>
__device__ __forceinline__ void tiny_attend(bf16* q_s, const bf16* k_s,
                                            const bf16* v_s, int lane,
                                            int lr = L) {
  static_assert(!PAIRS || (MASK && L == 16), "two sequences of 8, masked");
  constexpr int RS = TinyTile<L, D>::RS;
  constexpr int OS = TinyTile<L, D>::OS;
  constexpr int MT = L / 16;                  // m16 tiles of query rows
  const int g = lane >> 2, t = lane & 3;

  // S = Q·Kᵀ: L rows x L keys, L / 8 n8 tiles per m16 tile of rows
  float s[MT][L / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L / 8; ++nt)
      s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t qa[4];
      const bf16* p0 = q_s + (mt * 16 + g) * RS + kk * 16 + 2 * t;
      const bf16* p1 = p0 + 8 * RS;
      qa[0] = *reinterpret_cast<const uint32_t*>(p0);
      qa[1] = *reinterpret_cast<const uint32_t*>(p1);
      qa[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
      qa[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
#pragma unroll
      for (int nt = 0; nt < L / 8; ++nt) {
        const bf16* kp = k_s + (nt * 8 + g) * RS + kk * 16 + 2 * t;
        mma_16816(s[mt][nt], qa, *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
  }

  // full-row softmax; rows g (r = 0) and g + 8 (r = 1) of each m16 tile,
  // each over a quad (s[mt][nt][2 r + c] is key 8 nt + 2 t + c)
  float l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (MASK) {
#pragma unroll
        for (int nt = 0; nt < L / 8; ++nt) {
          const int key = nt * 8 + 2 * t;
          if (PAIRS ? nt != r : key >= lr) s[mt][nt][2 * r] = -INFINITY;
          if (PAIRS ? nt != r : key + 1 >= lr)
            s[mt][nt][2 * r + 1] = -INFINITY;
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < L / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < L / 8; ++nt) {
        if (MASK) {
          s[mt][nt][2 * r] = expf(s[mt][nt][2 * r] - mx);
          s[mt][nt][2 * r + 1] = expf(s[mt][nt][2 * r + 1] - mx);
        } else {
          s[mt][nt][2 * r] = __expf(s[mt][nt][2 * r] - mx);
          s[mt][nt][2 * r + 1] = __expf(s[mt][nt][2 * r + 1] - mx);
        }
        sum += s[mt][nt][2 * r] + s[mt][nt][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[mt][r] = sum;
    }

  // O = P·V, P re-packed from the S accumulators as bf16 A fragments, one
  // per k16 step of keys
  uint32_t pa[MT][L / 16][4];
  float inv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      pa[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      pa[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      pa[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      pa[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
    inv[mt][0] = 1.f / l[mt][0];
    inv[mt][1] = 1.f / l[mt][1];
  }
  const unsigned short* v_u = reinterpret_cast<const unsigned short*>(v_s);
  // every lane has read its q and k fragments: q_s (and, for a float32
  // output, k_s after it) becomes the output
  __syncwarp();
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + g;
    float o[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      // B fragment: V[k0 + 2t][n], V[k0 + 2t + 1][n] and V[k0 + 2t + 8][n],
      // V[k0 + 2t + 9][n], k0 = 16 kk, n = nd·8 + g
      const int k0 = kk * 16;
      const uint32_t b0 = v_u[(k0 + 2 * t) * RS + col] |
                          ((uint32_t)v_u[(k0 + 2 * t + 1) * RS + col] << 16);
      const uint32_t b1 = v_u[(k0 + 2 * t + 8) * RS + col] |
                          ((uint32_t)v_u[(k0 + 2 * t + 9) * RS + col] << 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_16816(o[mt], pa[mt][kk], b0, b1);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = mt * 16 + g;
      if constexpr (std::is_same<O, float>::value) {
        float* o_s = reinterpret_cast<float*>(q_s);
        *reinterpret_cast<float2*>(o_s + row * OS + nd * 8 + 2 * t) =
            make_float2(o[mt][0] * inv[mt][0], o[mt][1] * inv[mt][0]);
        *reinterpret_cast<float2*>(o_s + (row + 8) * OS + nd * 8 + 2 * t) =
            make_float2(o[mt][2] * inv[mt][1], o[mt][3] * inv[mt][1]);
      } else {
        *reinterpret_cast<uint32_t*>(q_s + row * RS + nd * 8 + 2 * t) =
            pack_bf16(o[mt][0] * inv[mt][0], o[mt][1] * inv[mt][0]);
        *reinterpret_cast<uint32_t*>(q_s + (row + 8) * RS + nd * 8 + 2 * t) =
            pack_bf16(o[mt][2] * inv[mt][1], o[mt][3] * inv[mt][1]);
      }
    }
  }
}

}  // namespace mdt
