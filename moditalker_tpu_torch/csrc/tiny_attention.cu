// Attention over tiny L for a large folded batch: q, k, v [B, L, D] bf16.
//
// Replaces _tiny_kernel of moditalker_tpu/ops/pallas/flash_attention.py,
// which the JAX package's sdpa picks for mask-free self-attention with
// L <= 32, L % 8 == 0, B >= 4096, B % 128 == 0, D in {64, 128}. That is the
// TimeSformer time attention when the fused divided kernels are switched
// off: [B·8·1024, 16, 64]. The TPU kernel takes 128 or 256 sequences into
// VMEM per grid step; that chunking is the TPU's and is not carried over.
//
// A sequence is 2 KB per tensor and does 4·L²·D = 65 KFLOP: the kernel moves
// bytes. One warp owns one sequence. Its lanes copy q (times the scale,
// rounded to bf16 once), k and v into the warp's shared buffer with 16-byte
// loads, neighbouring lanes on neighbouring addresses, so every global
// access is a full coalesced line. S = Q·Kᵀ (fp32) and O = P·V run as
// mma.sync m16n8k16: at L = 16 the score tile is exactly one 16 x 16
// accumulator pair, the softmax is a full-row one in registers (row max and
// fp32 row sum over the quad), P is rounded to bf16 for the second product
// and the output is divided by the row sum after it, the TPU kernel's
// rounding points. The output goes back through the shared buffer so the
// stores are 16-byte coalesced too.
#include "flash_tile.cuh"

namespace mdt {

template <int L, int D>
struct TinyShape {
  static_assert(L == 16, "one m16 tile of query rows per warp");
  static_assert(D % 16 == 0, "contraction in k16 steps");
  static constexpr int RS = D + 8;  // padded smem row stride (bf16)
  static constexpr int warps = 4;
  static constexpr int warp_elems = 3 * L * RS;  // q, k, v
  static constexpr int smem_bytes = warps * warp_elems * (int)sizeof(bf16);
};

// grid ceil(B / 4), block 128.
template <int L, int D>
__global__ void __launch_bounds__(128)
tiny_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      long B, float scale) {
  using S = TinyShape<L, D>;
  constexpr int RS = S::RS, CH = D / 8;  // 8-wide chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long seq = (long)blockIdx.x * S::warps + warp;
  if (seq >= B) return;  // whole warp leaves; no block barrier below
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw) + warp * S::warp_elems;
  bf16* k_s = q_s + L * RS;
  bf16* v_s = k_s + L * RS;
  const long base = seq * L * D;
  const int g = lane >> 2, t = lane & 3;

  for (int i = lane; i < L * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    float x[8];
    load8<false>(q + base + i * 8, true, nullptr, nullptr, scale, x);
    store8(q_s + r * RS + c, x);
    *reinterpret_cast<uint4*>(k_s + r * RS + c) =
        *reinterpret_cast<const uint4*>(k + base + i * 8);
    *reinterpret_cast<uint4*>(v_s + r * RS + c) =
        *reinterpret_cast<const uint4*>(v + base + i * 8);
  }
  __syncwarp();

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
  __syncwarp();  // every lane has read its q fragments: q_s becomes the output
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
    *reinterpret_cast<uint32_t*>(q_s + g * RS + nd * 8 + 2 * t) =
        pack_bf16(o[0] * inv0, o[1] * inv0);
    *reinterpret_cast<uint32_t*>(q_s + (g + 8) * RS + nd * 8 + 2 * t) =
        pack_bf16(o[2] * inv1, o[3] * inv1);
  }
  __syncwarp();
  for (int i = lane; i < L * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    *reinterpret_cast<uint4*>(out + base + i * 8) =
        *reinterpret_cast<const uint4*>(q_s + r * RS + c);
  }
}

template <int L, int D>
cudaError_t launch_tiny(const void* q, const void* k, const void* v, void* out,
                        long B, float scale, cudaStream_t stream) {
  using S = TinyShape<L, D>;
  auto kern = tiny_attention_kernel<L, D>;
  if (S::smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
    if (err != cudaSuccess) return err;
  }
  unsigned blocks = (unsigned)((B + S::warps - 1) / S::warps);
  kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, scale);
  return cudaGetLastError();
}

}  // namespace mdt

extern "C" {

// q, k, v, out: contiguous [B, L, D] bf16.
int tiny_attention(const void* q, const void* k, const void* v, void* out,
                   long B, int L, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // built for the (L, D) the repository's configurations reach (16 frames,
  // AE dim_head 64); keep in step with TINY_SHAPES in flash_attention.py
  if (L == 16 && D == 64)
    return mdt::launch_tiny<16, 64>(q, k, v, out, B, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
