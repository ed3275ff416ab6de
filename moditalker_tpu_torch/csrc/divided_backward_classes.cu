// The C entry points of the divided space and time backward kernels for
// bf16 qkv at the shapes the forward's gate admits beyond the
// configurations' (divided_backward.cu holds those: space at head dim
// 64, time at 16 frames of head dim 64), in a library of their own: space at
// head dims 32 and 128 (the pre-pass, dq and dk/dv of the wgmma design) and
// 2 to 16 (the class 16 on mma.sync, and one block per (frame, head) up to
// 1024 tokens where the plan table names it), time at every frame and
// head-dim class and at 8 frames the staged kernel (the kernels:
// divided_backward.cuh, time_staged_backward.cuh).
#include "divided_backward.cuh"
#include "time_staged_backward.cuh"

extern "C" {

// qkv [BF, N, 3·H·dh] bf16, rot [N, dh/2, 2] fp32, out and g
// [BF, N, H·dh] bf16 -> the pre-pass's scratch [BF, N, 3·H·dh] bf16,
// gs [BF, N, H·dh] bf16 and dsum [BF, H, N] fp32; dh 32 or 128.
int divided_space_backward_prepass_classes(
    const void* qkv, const void* rot, const void* out, const void* g,
    void* scratch, void* gs, void* dsum, int BF, int N, int H, int dh,
    float scale, void* stream) {
  return mdt::launch_space_backward_prepass<mdt::bf16>(
      qkv, rot, out, g, scratch, gs, dsum, BF, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// The pre-pass's scratch, gs and dsum, rot -> dqkv [BF, N, 3·H·dh] bf16;
// stats a float32 scratch [BF, H, N, 2] (dq writes it, dk/dv reads it).
int divided_space_backward_dq_classes(
    const void* scratch, const void* gs, const void* dsum, const void* rot,
    void* dqkv, void* stats, int BF, int N, int H, int dh, float scale,
    void* stream) {
  return mdt::launch_space_backward_classes<mdt::bf16, false>(
      scratch, gs, dsum, rot, dqkv, stats, BF, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

int divided_space_backward_dkdv_classes(
    const void* scratch, const void* gs, const void* dsum, const void* rot,
    void* dqkv, void* stats, int BF, int N, int H, int dh, float scale,
    void* stream) {
  return mdt::launch_space_backward_classes<mdt::bf16, true>(
      scratch, gs, dsum, rot, dqkv, stats, BF, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// qkv [BF, N, 3·H·dh] bf16, rot [N, dh/2, 2] fp32, out and g
// [BF, N, H·dh] bf16 -> dqkv [BF, N, 3·H·dh] bf16; stats a float32
// scratch [BF, H, N, 2]; dh 2, 4, 8 or 16. Two kernels (dq, then dk and dv).
int divided_space_attention_backward_classes(
    const void* qkv, const void* rot, const void* out, const void* g,
    void* dqkv, void* stats, int BF, int N, int H, int dh, float scale,
    void* stream) {
  return mdt::launch_space_backward_narrow<mdt::bf16>(
      qkv, rot, out, g, dqkv, stats, BF, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// qkv [BF, N, 3·H·dh] bf16, rot [N, dh/2, 2] fp32, out and g
// [BF, N, H·dh] bf16 -> dqkv [BF, N, 3·H·dh] bf16; dh 2, 4, 8 or 16,
// 256 <= N <= 1024, N % 128 == 0: one block per (frame, head), q~, k~, v
// and g resident, S worked out twice per score (one launch, no scratch).
int divided_space_attention_backward_resident(
    const void* qkv, const void* rot, const void* out, const void* g,
    void* dqkv, int BF, int N, int H, int dh, float scale, void* stream) {
  return mdt::launch_space_backward_resident<mdt::bf16>(
      qkv, rot, out, g, dqkv, BF, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// qkv [B, F, N, 3·H·dh] bf16, sin/cos [F, dh] fp32, g [B, F, N, H·dh]
// bf16 -> dqkv [B, F, N, 3·H·dh] bf16; F % 8 == 0, F <= 32, dh dividing 128.
int divided_time_attention_backward_classes(
    const void* qkv, const void* sin_t, const void* cos_t, const void* g,
    void* dqkv, int B, int F, int N, int H, int dh, float scale,
    void* stream) {
  return mdt::launch_time_backward_classes<mdt::bf16>(
      qkv, sin_t, cos_t, g, dqkv, B, F, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

// qkv [B, 8, N, 3·H·dh] bf16, sin/cos [8, dh] fp32, g [B, 8, N, H·dh]
// bf16 -> dqkv [B, 8, N, 3·H·dh] bf16; dh dividing 128 from 2 up: the
// time backward staged by cp.async, two items a 16-row tile
// (time_staged_backward.cuh).
int divided_time_attention_backward_staged(
    const void* qkv, const void* sin_t, const void* cos_t, const void* g,
    void* dqkv, int B, int F, int N, int H, int dh, float scale,
    void* stream) {
  return mdt::launch_time_backward_staged_classes<mdt::bf16>(
      qkv, sin_t, cos_t, g, dqkv, B, F, N, H, dh, scale,
      static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
