// Attention over tiny L for a large folded batch: q, k, v [B, L, D], bf16 or
// float32. The kernel and its launcher; the C entry points are in
// tiny_attention.cu (bf16) and tiny_attention_f32.cu (float32) for the shape
// the configurations reach, (L, D) = (16, 64), and in flash_classes.cu and
// flash_classes_f32.cu for the rest of the gate, each a library of its own
// so that the bf16 translation unit holds no float32 instantiation.
//
// Replaces _tiny_kernel of moditalker_tpu/ops/pallas/flash_attention.py,
// which the JAX package's sdpa picks for mask-free self-attention with
// L <= 32, L % 8 == 0, B >= 4096, B % 128 == 0, D in {64, 128}. That is the
// TimeSformer time attention when the fused divided kernels are switched
// off: [B·8·1024, 16, 64] (and [B·8·1024, F, 64] for clips of F frames).
// The TPU kernel takes 128 or 256 sequences into VMEM per grid step; that
// chunking is the TPU's and is not carried over. The tile is built per row
// class (16 or 32) and head dim (64 or 128); L = 8 and 24 run on the 16- and
// 32-row tiles with the rows past L loaded as zeros and masked
// (tiny_tile.cuh), never stored.
//
// A sequence is 2 KB per bf16 tensor and does 4·L²·D = 65 KFLOP: the kernel
// moves bytes. One warp owns one sequence. Its lanes copy q (times the
// scale, rounded to bf16 once), k and v into the warp's shared buffer with
// 16-byte loads, neighbouring lanes on neighbouring addresses, so every
// global access is a full coalesced line. S = Q·Kᵀ (fp32) and O = P·V run
// as mma.sync m16n8k16: at L = 16 the score tile is exactly one 16 x 16
// accumulator pair, the softmax is a full-row one in registers (row max and
// fp32 row sum over the quad), P is rounded to bf16 for the second product
// and the output is divided by the row sum after it, the TPU kernel's
// rounding points (tiny_tile.cuh, shared with the divided time kernel). The
// output goes back through the shared buffer so the stores are 16-byte
// coalesced too.
//
// Float32 (T = float: the trainers' and the golden record's time attention
// on the modular path): the lanes read q, k and v as float32 (two 16-byte
// loads per eight elements, a lane's 24 loads in flight together) and round
// each to bf16 once on its way into the buffer, q after the scale in fp32;
// tiny_attend<L, D, float> writes the output, divided by the fp32 row sum,
// as float32 over the warp's q and k buffers, never rounded to bf16, and it
// leaves as 16-byte stores: 16 KB a sequence read and written once.
#pragma once

#include <type_traits>

#include "tiny_tile.cuh"

namespace mdt {

template <int L, int D>
struct TinyShape {
  static constexpr int warps = 4;
  static constexpr int smem_bytes =
      warps * TinyTile<L, D>::warp_elems * (int)sizeof(bf16);
};

// grid ceil(B / 4), block 128. PAD (the classes): sequences of lr <= L rows
// (row class L), the tile's MASK.
template <int L, int D, typename T, bool PAD = false>
__global__ void __launch_bounds__(128)
tiny_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, long B,
                      float scale, int lr_arg) {
  using S = TinyShape<L, D>;
  using Tile = TinyTile<L, D>;
  constexpr int RS = Tile::RS, CH = Tile::CH;  // 8-wide chunks per row
  const int lr = PAD ? lr_arg : L;             // the sequence's true rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long seq = (long)blockIdx.x * S::warps + warp;
  if (seq >= B) return;  // whole warp leaves; no block barrier below
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw) + warp * Tile::warp_elems;
  bf16* k_s = q_s + L * RS;
  bf16* v_s = k_s + L * RS;
  const long base = seq * lr * D;

  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = lane; i < L * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool valid = !PAD || r < lr;
      float x[8];
      load8<false>(q + base + i * 8, valid, nullptr, nullptr, scale, x);
      store8(q_s + r * RS + c, x);
      load8<false>(k + base + i * 8, valid, nullptr, nullptr, 1.f, x);
      store8(k_s + r * RS + c, x);
      load8<false>(v + base + i * 8, valid, nullptr, nullptr, 1.f, x);
      store8(v_s + r * RS + c, x);
    }
  } else {
    for (int i = lane; i < L * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool valid = !PAD || r < lr;
      float x[8];
      load8<false>(q + base + i * 8, valid, nullptr, nullptr, scale, x);
      store8(q_s + r * RS + c, x);
      const uint4 none = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(k_s + r * RS + c) =
          valid ? *reinterpret_cast<const uint4*>(k + base + i * 8) : none;
      *reinterpret_cast<uint4*>(v_s + r * RS + c) =
          valid ? *reinterpret_cast<const uint4*>(v + base + i * 8) : none;
    }
  }
  __syncwarp();
  tiny_attend<L, D, T, PAD>(q_s, k_s, v_s, lane, lr);
  __syncwarp();
  if constexpr (std::is_same<T, float>::value) {
    // fp32 [L, D] at stride OS over q_s and k_s; the sequence's output is
    // contiguous, so chunk i of it is row i / (D / 4)
    const float* o_s = reinterpret_cast<const float*>(q_s);
    for (int i = lane; i < lr * D / 4; i += 32) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(out + base + i * 4) =
          *reinterpret_cast<const float4*>(o_s + r * Tile::OS + c);
    }
  } else {
    for (int i = lane; i < lr * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      *reinterpret_cast<uint4*>(out + base + i * 8) =
          *reinterpret_cast<const uint4*>(q_s + r * RS + c);
    }
  }
}

template <int L, int D, typename T, bool PAD = false>
cudaError_t launch_tiny(const void* q, const void* k, const void* v, void* out,
                        long B, int lr, float scale, cudaStream_t stream) {
  using S = TinyShape<L, D>;
  auto kern = tiny_attention_kernel<L, D, T, PAD>;
  if (S::smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
    if (err != cudaSuccess) return err;
  }
  unsigned blocks = (unsigned)((B + S::warps - 1) / S::warps);
  kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), B, scale, lr);
  return cudaGetLastError();
}

// The tiny-L kernel at any (L, D) its gate admits (L in {8, 16, 24, 32}, D
// in {64, 128}): the row class 16 or 32, with the classes' masking and
// rounding (tiny_attend's MASK), rows past L (8, 24) loaded as zeros.
template <int D, typename T>
cudaError_t launch_tiny_class(const void* q, const void* k, const void* v,
                              void* out, long B, int L, float scale,
                              cudaStream_t stream) {
  if (L == 8 || L == 16)
    return launch_tiny<16, D, T, true>(q, k, v, out, B, L, scale, stream);
  if (L == 24 || L == 32)
    return launch_tiny<32, D, T, true>(q, k, v, out, B, L, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mdt
