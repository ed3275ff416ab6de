// Flash attention on mma.sync, one (query tile, sequence) per block.
//
// The K-blocked fused attention kernel (flash_attention.cu) runs on it: Nq
// query rows against Nk keys, both lengths ragged. It was the port's first
// tile; the space attention has moved to wgmma_tile.cuh, the packed and the
// one-pass kernel to smallhead_tile.cuh and wgmma_tile.cuh. load8 and store8
// also serve the tiny-L kernel and, with the rotary, the divided time kernel.
// q, k and v of (sequence b, row r) sit at ptr + b·batch + r·row.
//
// The TPU kernel walks 128-wide K blocks with an online softmax; so does this
// one, over 64-key tiles (running max and sum, output rescaled per tile).
//
// Block: 4 warps, 16 query rows each (64 per block). Per key tile the block
// stages K row-major and V transposed in shared memory; each warp runs
// S = Q·Kᵀ and O += P·V with mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// P staying in registers between the two products. Rows are padded by 8 bf16
// so the fragment loads hit 32 distinct banks.
//
// Arithmetic follows the TPU kernels: the attention scale is applied to q in
// fp32 and rounded to bf16 once; scores, max and sum are fp32; P is rounded
// to bf16 for the P·V product; the output divides by the fp32 row sum.
#pragma once

#include "ptx.cuh"

namespace mdt {

constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // keys per tile
constexpr int kThreads = 128;

// Eight consecutive bf16 of one row, rotated (rotate-every-two: out[2i] =
// x[2i]·cos - x[2i+1]·sin, out[2i+1] = x[2i+1]·cos + x[2i]·sin) when ROT,
// times `mul`, in fp32. Rows past the sequence end read as zeros.
template <bool ROT>
__device__ __forceinline__ void load8(const bf16* src, bool valid,
                                      const float* sn, const float* cs,
                                      float mul, float (&x)[8]) {
  if (!valid) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = 0.f;
    return;
  }
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
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
  uint4 v;
  v.x = pack_bf16(x[0], x[1]);
  v.y = pack_bf16(x[2], x[3]);
  v.z = pack_bf16(x[4], x[5]);
  v.w = pack_bf16(x[6], x[7]);
  *reinterpret_cast<uint4*>(dst) = v;
}

template <int DH>
struct FlashShape {
  static constexpr int DK = (DH + 15) / 16 * 16;  // contraction, 0-padded
  static constexpr int QS = DK + 8;             // Q/K smem row stride (bf16)
  static constexpr int VS = kBK + 8;            // Vᵀ smem row stride (bf16)
  static constexpr int smem_bytes =
      (kBQ * QS + kBK * QS + DH * VS) * (int)sizeof(bf16);
};

// Element strides of q, of k/v (which share theirs) and of the output;
// L query rows attend to Lk keys.
struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  long q_batch, kv_batch, in_row, out_batch, out_row;
  int L, Lk;
  float scale;
};

// grid (ceil(L / 64), B), block 128, dynamic smem FlashShape<DH>::smem_bytes.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const FlashArgs a) {
  const int L = a.L, Lk = a.Lk;
  using S = FlashShape<DH>;
  constexpr int DK = S::DK, QS = S::QS, VS = S::VS;
  constexpr int CH = DH / 8;  // 8-wide chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][QS]
  bf16* k_s = q_s + kBQ * QS;                     // [kBK][QS]
  bf16* vt_s = k_s + kBK * QS;                    // [DH][VS]

  const int q0 = blockIdx.x * kBQ, b = blockIdx.y;
  const bf16* qb = a.q + b * a.q_batch;
  const bf16 *kb = a.k + b * a.kv_batch, *vb = a.v + b * a.kv_batch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if constexpr (DK > DH) {  // zero the contraction padding once
    constexpr int PAD = DK - DH;
    for (int i = tid; i < (kBQ + kBK) * PAD; i += kThreads)
      q_s[(i / PAD) * QS + DH + i % PAD] = __float2bfloat16(0.f);
  }

  // ---- Q tile: scaled, rounded to bf16 once
  for (int i = tid; i < kBQ * CH; i += kThreads) {
    int r = i / CH, c = (i % CH) * 8, row = q0 + r;
    float x[8];
    load8<false>(qb + row * a.in_row + c, row < L, nullptr, nullptr, a.scale,
                 x);
    store8(q_s + r * QS + c, x);
  }
  __syncthreads();

  uint32_t qa[DK / 16][4];
  {
    const int qr = warp * 16;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const bf16* p0 = q_s + (qr + g) * QS + kk * 16 + 2 * t;
      const bf16* p1 = p0 + 8 * QS;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
    }
  }

  float o[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kBK * CH; i += kThreads) {
      int r = i / CH, c = (i % CH) * 8, row = k0 + r;
      bool valid = row < Lk;
      float x[8];
      load8<false>(kb + row * a.in_row + c, valid, nullptr, nullptr, 1.f, x);
      store8(k_s + r * QS + c, x);
      load8<false>(vb + row * a.in_row + c, valid, nullptr, nullptr, 1.f, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c + e) * VS + r] = __float2bfloat16(x[e]);
    }
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows × 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const bf16* kp = k_s + (nt * 8 + g) * QS + kk * 16 + 2 * t;
        mma_16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    if (k0 + kBK > Lk) {  // ragged last tile: keys past Lk get no weight
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        int key = k0 + nt * 8 + 2 * t;
        if (key >= Lk) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= Lk) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }

    // online softmax; rows g (r=0) and g+8 (r=1), each spread over a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float m_new = fmaxf(m_run[r], mx);
      float alpha = __expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        s[nt][2 * r] = __expf(s[nt][2 * r] - m_new);
        s[nt][2 * r + 1] = __expf(s[nt][2 * r + 1] - m_new);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        o[nd][2 * r] *= alpha;
        o[nd][2 * r + 1] *= alpha;
      }
    }

    // O += P·V, P re-packed from the S accumulators as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const bf16* vp = vt_s + (nd * 8 + g) * VS + kk * 16 + 2 * t;
        mma_16816(o[nd], pa, *reinterpret_cast<const uint32_t*>(vp),
                  *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

  // finish the row sums across the quad and write the head-merged output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    int row = q0 + warp * 16 + g + 8 * r;
    if (row < L) {
      float inv = 1.f / l_run[r];
      bf16* dst = a.out + b * a.out_batch + row * a.out_row + 2 * t;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_bf16(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch_flash(const FlashArgs& args, int B, cudaStream_t stream) {
  constexpr int smem = FlashShape<DH>::smem_bytes;
  auto kern = flash_kernel<DH>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((args.L + kBQ - 1) / kBQ, B);
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace mdt
