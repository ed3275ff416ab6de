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
// rounding points (tiny_tile.cuh, shared with the divided time kernel). The
// output goes back through the shared buffer so the stores are 16-byte
// coalesced too.
#include "tiny_tile.cuh"

namespace mdt {

template <int L, int D>
struct TinyShape {
  static constexpr int warps = 4;
  static constexpr int smem_bytes =
      warps * TinyTile<L, D>::warp_elems * (int)sizeof(bf16);
};

// grid ceil(B / 4), block 128.
template <int L, int D>
__global__ void __launch_bounds__(128)
tiny_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      long B, float scale) {
  using S = TinyShape<L, D>;
  using T = TinyTile<L, D>;
  constexpr int RS = T::RS, CH = T::CH;  // 8-wide chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long seq = (long)blockIdx.x * S::warps + warp;
  if (seq >= B) return;  // whole warp leaves; no block barrier below
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw) + warp * T::warp_elems;
  bf16* k_s = q_s + L * RS;
  bf16* v_s = k_s + L * RS;
  const long base = seq * L * D;

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
  tiny_attend<L, D>(q_s, k_s, v_s, lane);
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
