// float32 <-> bf16 casts for the attention kernels' float32 route.
//
// The JAX trainers build their models in float32, and the Pallas kernels
// run their products in the input dtype. On this card the attention kernels
// keep their bf16 operands (products on the tensor cores with fp32
// accumulators: what a float32 dot costs at JAX's default precision on a
// TPU). Their tiles copy raw bytes with cp.async, which cannot convert in
// flight, so a float32 operand is cast to bf16 by one pass in front and the
// bf16 result back to float32 by one pass behind. Each pass reads and writes
// every element once in 16-byte accesses, neighbouring threads on
// neighbouring addresses: bound by bytes (6 bytes per element either way).
// The wrappers count these passes in the time of the kernel they serve.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

// eight elements per step: two float4 loads -> one 16-byte store
__global__ void f32_to_bf16_kernel(const float4* __restrict__ in,
                                   uint4* __restrict__ out, long n8) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += stride) {
    const float4 a = in[2 * i], b = in[2 * i + 1];
    out[i] = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                        pack2(b.z, b.w));
  }
}

// eight elements per step: one 16-byte load -> two float4 stores
__global__ void bf16_to_f32_kernel(const uint4* __restrict__ in,
                                   float4* __restrict__ out, long n8) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += stride) {
    const uint4 w = in[i];
    const float2 p0 = unpack2(w.x), p1 = unpack2(w.y), p2 = unpack2(w.z),
                 p3 = unpack2(w.w);
    out[2 * i] = make_float4(p0.x, p0.y, p1.x, p1.y);
    out[2 * i + 1] = make_float4(p2.x, p2.y, p3.x, p3.y);
  }
}

unsigned grid_for(long n8) {
  // enough blocks of 256 threads to cover the card several times over; the
  // loop strides past that
  const long want = (n8 + 255) / 256;
  return (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

}  // namespace

extern "C" {

// in: n float32, 16-byte aligned; out: n bf16, 16-byte aligned; n % 8 == 0.
int convert_f32_to_bf16(const void* in, void* out, long n, void* stream) {
  if (n % 8) return cudaErrorInvalidValue;
  const long n8 = n / 8;
  if (n8 == 0) return cudaSuccess;
  f32_to_bf16_kernel<<<grid_for(n8), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<uint4*>(out), n8);
  return cudaGetLastError();
}

// in: n bf16, 16-byte aligned; out: n float32, 16-byte aligned; n % 8 == 0.
int convert_bf16_to_f32(const void* in, void* out, long n, void* stream) {
  if (n % 8) return cudaErrorInvalidValue;
  const long n8 = n / 8;
  if (n8 == 0) return cudaSuccess;
  bf16_to_f32_kernel<<<grid_for(n8), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<float4*>(out), n8);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
