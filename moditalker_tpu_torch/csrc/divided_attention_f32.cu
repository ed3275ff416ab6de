// The C entry points of the divided space and time kernels for float32 qkv
// (the kernels and their float32 route: divided_attention.cuh, and the
// space kernel of its own at head dim 64, one block or a cluster of two per
// (frame, head): resident_f32_tile.cuh). A library
// of their own, so that the bf16 kernels' translation unit
// (divided_attention.cu) holds no float32 instantiation.
#include "divided_attention.cuh"
#include "resident_f32_tile.cuh"

namespace mdt {

// qkv [BF, N, 3·H·64] float32, N a multiple of 128 up to 1152 -> out
// [BF, N, H·64] float32, through the V scratch [BF·H, N, 64] bf16; CL
// blocks a (frame, head): one, or a cluster of two (N from 256).
template <int CL = 1>
inline int launch_space_f32(const void* qkv, const void* rot, void* vs,
                            void* out, int BF, int N, int H, int dh,
                            float scale, cudaStream_t stream) {
  if (dh != kWgD) return cudaErrorInvalidValue;
  return launch_resident_f32<SpaceF32Args, CL>(
      SpaceF32Args{static_cast<const float*>(qkv),
                   static_cast<const float*>(rot), static_cast<bf16*>(vs),
                   static_cast<float*>(out), N, H, scale},
      H, BF, stream);
}

}  // namespace mdt

extern "C" {

// qkv [BF, N, 3·H·dh] float32, rot [N, dh/2, 2] fp32, the V scratch
// vs [BF·H, N, dh] bf16 or null -> out [BF, N, H·dh] float32; built for
// head dim 64 with K resident only (N <= 1152: the repository's
// configurations reach N = 1024), larger N is refused. With a scratch,
// resident_f32_tile.cuh's kernel; without one, the wgmma tile's float32 route
// (the wrapper chooses: space_f32_own_kernel in
// ops/kernels/divided_attention.py).
int divided_space_attention_f32(const void* qkv, const void* rot, void* vs,
                                void* out, int BF, int N, int H, int dh,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vs != nullptr)
    return mdt::launch_space_f32(qkv, rot, vs, out, BF, N, H, dh, scale, st);
  return mdt::launch_space<float>(qkv, rot, out, BF, N, H, dh, scale, st);
}

// The same with a cluster of two blocks per (frame, head), each walking
// every other round (resident_f32_tile.cuh's cluster plan; the wrapper's
// space_f32_own_kernel chooses it): the V scratch is required, N from 256.
int divided_space_attention_f32_cluster(const void* qkv, const void* rot,
                                        void* vs, void* out, int BF, int N,
                                        int H, int dh, float scale,
                                        void* stream) {
  if (vs == nullptr) return cudaErrorInvalidValue;
  return mdt::launch_space_f32<2>(qkv, rot, vs, out, BF, N, H, dh, scale,
                                  static_cast<cudaStream_t>(stream));
}

// qkv [B, F, N, 3·H·dh] float32, sin/cos [F, dh] fp32 -> out [B, F, N, H·dh]
// float32; built for 16 frames of dim_head 64.
int divided_time_attention_f32(const void* qkv, const void* sin_t,
                               const void* cos_t, void* out, int B, int F,
                               int N, int H, int dh, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 16 && dh == 64)
    return mdt::launch_time<16, 64, float>(qkv, sin_t, cos_t, out, B, F, N,
                                           H, dh, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
