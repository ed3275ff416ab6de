// Thin wrappers over the PTX the port's kernels are built from: bf16
// packing, row chunks of bf16 or float32, mma.sync and ldmatrix, shared
// stores, cp.async, mbarriers, the proxy fence, ex2, and a cluster's rank,
// barrier and stores into its blocks' shared memory. Shared by every tile
// header; nothing here launches or allocates.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mdt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight consecutive elements of a row as one load brings them in: a 16-byte
// chunk of bf16, or two 16-byte chunks of float32 (the kernels' float32
// routes read their operands in their own type and round them once, after
// the rotary where there is one, where the bf16 routes round nothing on the
// way in).
template <typename T>
struct Chunk8;

template <>
struct Chunk8<bf16> {
  uint4 raw;
  __device__ __forceinline__ void load(const bf16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  // the first n (< 8) elements one by one, the rest zeros
  __device__ __forceinline__ void load_n(const bf16* p, int n) {
    raw = make_uint4(0u, 0u, 0u, 0u);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) e[i] = p[i];
  }
  __device__ __forceinline__ void to_float(float (&x)[8]) const {
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
  }
};

template <>
struct Chunk8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = reinterpret_cast<const float4*>(p)[0];
    hi = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void load_n(const float* p, int n) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = i < n ? p[i] : 0.f;
    lo = make_float4(x[0], x[1], x[2], x[3]);
    hi = make_float4(x[4], x[5], x[6], x[7]);
  }
  __device__ __forceinline__ void to_float(float (&x)[8]) const {
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  }
};

// The eight elements of a row at p of which the first n lie inside it (a
// head narrower than its class): all eight with one load where n >= 8, the
// first n one by one (a head of 2 or 4 dims), zeros where n <= 0.
template <typename T>
__device__ __forceinline__ void load_chunk(Chunk8<T>& c, const T* p, int n) {
  if (n >= 8) {
    c.load(p);
  } else {
    c = Chunk8<T>{};
    if (n > 0) c.load_n(p, n);
  }
}

// Eight fp32 values as one 16-byte chunk of bf16, each rounded once.
__device__ __forceinline__ uint4 pack8_bf16(const float (&x)[8]) {
  uint4 v;
  v.x = pack_bf16(x[0], x[1]);
  v.y = pack_bf16(x[2], x[3]);
  v.z = pack_bf16(x[4], x[5]);
  v.w = pack_bf16(x[6], x[7]);
  return v;
}

// The rotary's rotate-every-two on one pair, (a, b) -> (a·c0 − b·s0,
// b·c1 + a·s1), each product and the sum rounded on its own: what the plain
// PyTorch rotary (x∘cos + rotate_every_two(x)∘sin: two multiplies and an
// add) computes, where the compiler would fuse a product into the add. Every
// float32 rotation rotates so (the space pre-pass, the D = 64 tile's float32
// route), which keeps the float32 results on the route's function; the bf16
// tiles keep the fused form they were measured with.
__device__ __forceinline__ void rotate_pair_rn(float& a, float& b, float c0,
                                               float s0, float c1, float s1) {
  const float x0 = __fadd_rn(__fmul_rn(a, c0), -__fmul_rn(b, s0));
  const float x1 = __fadd_rn(__fmul_rn(b, c1), __fmul_rn(a, s1));
  a = x0;
  b = x1;
}

// Its transpose, (y0, y1) -> (y0·c0 + y1·s1, y1·c1 − y0·s0), rounded as the
// plain backward's y∘cos − rotate_every_two(y∘sin).
__device__ __forceinline__ void rotate_pair_t_rn(float& y0, float& y1,
                                                 float c0, float s0, float c1,
                                                 float s1) {
  const float x0 = __fadd_rn(__fmul_rn(y0, c0), __fmul_rn(y1, s1));
  const float x1 = __fsub_rn(__fmul_rn(y1, c1), __fmul_rn(y0, s0));
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- products
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// addresses of the eight 16-byte rows of matrix i; register i of lane
// (g = lane / 4, t = lane % 4) gets elements 2t, 2t + 1 of row g of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same, each matrix transposed on its way: register i gets elements
// (2t, g) and (2t + 1, g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// An 8 x 8 bf16 matrix held as ldmatrix leaves it (register of lane (g, t):
// elements 2t, 2t + 1 of row g) transposed across the warp, in registers.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// ---------------------------------------------------------------- shared
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the mbar_init calls of a block, before its first __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes (st.shared, cp.async) before wgmma's async-proxy reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One 16-byte store to shared memory (a float32 route's bf16 chunk, rounded
// in registers where the bf16 route copies it with cp.async).
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes from src when valid, 16 bytes of zeros otherwise (src is not read
// then, but has to be an address inside the tensor).
__device__ __forceinline__ void cp_async16_or_zeros(uint32_t dst,
                                                    const void* src,
                                                    bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One arrival on the mbarrier once every cp.async this thread has started so
// far has landed; the barrier's count includes it (noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- clusters
// This block's rank in its thread-block cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory byte in the cluster's block `rank`
// (a shared::cluster address, for st_cluster16).
__device__ __forceinline__ uint32_t mapa_shared(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// One 16-byte store into another block's shared memory of the cluster.
__device__ __forceinline__ void st_cluster16(uint32_t dst, uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The cluster barrier in two halves, every thread of every block of the
// cluster: arrive (release: this thread's writes before it, shared and
// global, are seen by the threads that wait) and wait (acquire). The relaxed
// arrive orders nothing: it only says that the block has started, so that
// its shared memory may be written by its peers after the wait.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on an mbarrier of another block of the cluster (an address
// from mapa_shared), releasing this thread's writes before it at cluster
// scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote_bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the writes the other blocks'
// arrivals released are seen after it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to the cluster's shared memory (st_cluster16 among
// them) before the async-proxy reads (wgmma) of the blocks they land in.
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

}  // namespace mdt
