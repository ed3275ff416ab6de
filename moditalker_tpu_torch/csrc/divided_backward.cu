// The C entry points of the divided space and time backward kernels for
// bf16 qkv (the kernels: divided_backward.cuh). The float32 entry points
// are built apart, in divided_backward_f32.cu, as the forward's are.
#include "divided_backward.cuh"

extern "C" {

// qkv [BF, N, 3·H·dh] bf16, rot [N, dh/2, 2] fp32 (cos, sin per rotated
// pair), out and g [BF, N, H·dh] bf16 -> the pre-pass's scratch
// [BF, N, 3·H·dh] bf16 (q~, k~, v), gs [BF, N, H·dh] bf16 and dsum
// [BF, H, N] fp32. The space backward is three launches: this, then dq,
// then dk/dv.
int divided_space_backward_prepass(
    const void* qkv, const void* rot, const void* out, const void* g,
    void* scratch, void* gs, void* dsum, int BF, int N, int H, int dh,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // built for the head dim the repository's configurations reach; keep in
  // step with SPACE_BACKWARD_HEAD_DIMS in divided_attention.py
  switch (dh) {
    case 64:
      return mdt::launch_space_backward_prepass<mdt::bf16>(
          qkv, rot, out, g, scratch, gs, dsum, BF, N, H, dh, scale, st);
  }
  return cudaErrorInvalidValue;
}

// The pre-pass's scratch, gs and dsum, rot -> dqkv [BF, N, 3·H·dh] bf16
// (its q third; dk/dv: its k and v thirds); stats a float32 scratch
// [BF, H, N, 2] that dq writes and dk/dv reads.
int divided_space_backward_dq(
    const void* scratch, const void* gs, const void* dsum, const void* rot,
    void* dqkv, void* stats, int BF, int N, int H, int dh, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return mdt::launch_space_backward_sweep<64, 4, mdt::bf16, false>(
          scratch, gs, dsum, rot, dqkv, stats, BF, N, H, dh, scale, st);
  }
  return cudaErrorInvalidValue;
}

int divided_space_backward_dkdv(
    const void* scratch, const void* gs, const void* dsum, const void* rot,
    void* dqkv, void* stats, int BF, int N, int H, int dh, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return mdt::launch_space_backward_sweep<64, 4, mdt::bf16, true>(
          scratch, gs, dsum, rot, dqkv, stats, BF, N, H, dh, scale, st);
  }
  return cudaErrorInvalidValue;
}

// qkv [B, F, N, 3·H·dh] bf16, sin/cos [F, dh] fp32, g [B, F, N, H·dh] bf16
// -> dqkv [B, F, N, 3·H·dh] bf16.
int divided_time_attention_backward(const void* qkv, const void* sin_t,
                                    const void* cos_t, const void* g,
                                    void* dqkv, int B, int F, int N, int H,
                                    int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // (frames, head dim): keep in step with TIME_SHAPES in
  // divided_attention.py
  switch (F) {
    case 16:
      switch (dh) {
        case 64:
          return mdt::launch_time_backward<16, 64, mdt::bf16>(
              qkv, sin_t, cos_t, g, dqkv, B, F, N, H, dh, scale, st);
      }
  }
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
