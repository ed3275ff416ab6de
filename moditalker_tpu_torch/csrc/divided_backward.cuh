// Backward of the divided space/time attention on packed qkv: dqkv from
// qkv, the forward's output and the output's cotangent g, written straight
// into the packed [.., 3·H·dh] layout with no transposes and no cast pass.
//
// The JAX package has no backward kernel: its custom_vjp
// (moditalker_tpu/ops/pallas/divided_attention.py:310-322) runs jax.vjp of
// the reference, which XLA fuses. These kernels compute that gradient with
// the written-out adjoints (divided_backward.py holds them in plain
// PyTorch): with q~ = scale·rot(q) and k~ = rot(k),
//
//   S = q~·k~ᵀ, P = softmax(S), dV = Pᵀ·g, dP = g·Vᵀ, D = rowsum(P ∘ dP),
//   dS = P ∘ (dP − D), dq = rotᵀ(scale·dS·k~), dk = rotᵀ(dSᵀ·q~),
//
// rotᵀ being the transpose of the rotate-every-two rotary:
// dx[2i] = y[2i]·c[2i] + y[2i+1]·s[2i+1], dx[2i+1] = y[2i+1]·c[2i+1] −
// y[2i]·s[2i]. A C fragment of mma.sync m16n8k16 holds columns 2t and
// 2t + 1 of a row, one rotated pair, so rotᵀ runs in registers before the
// store.
//
// Rounding points are the forward's float32 route's and then some: q
// rotated and scaled in fp32 and rounded to bf16 once, k rotated and
// rounded once, v rounded once; g rounded to bf16 as an operand of dP and
// dV; P and dS rounded to bf16 as product operands; every accumulator, the
// softmax statistics and D in fp32; dqkv stored in qkv's type (float32 for
// the trainers, never rounded to bf16 there). No float atomics: each output
// element is summed by one thread in one order, so two calls agree bit for
// bit.
//
//  * space (per frame, attention over N patches, N % 128 == 0): two
//    kernels. At the AE's shape (qkv [16, 1024, 1536] float32) five
//    products of 2·N²·dh per (frame, head) make 8.6e10 FLOPs against 268 MB
//    moved: bound by operations. All products are mma.sync m16n8k16 on
//    ldmatrix fragments from padded shared tiles (a 144-byte row stride
//    puts the eight rows of each 8 x 8 matrix on 32 distinct banks).
//    - dq: a block of eight warps owns 128 query rows of one (frame, head),
//      holds its rows of q~ and g as A fragments, and walks the keys in
//      128-row tiles twice: once for each row's max and exp2 sum (each lane
//      keeps its own partial pair, merged across the quad once at the end),
//      once for dP, dS and dq += dS·k~ (S recomputed). D = rowsum(g ∘ out)
//      comes from the forward's output (fp32 g and out), so no third sweep
//      is needed. It writes each row's log2-sum-exp and D to a scratch
//      buffer [BF, H, N, 2] for the second kernel.
//    - dk, dv: a block of eight warps owns 128 keys, holds its rows of k~
//      and v as A fragments, and walks the queries in 128-row tiles
//      computing Sᵀ = k~·q~ᵀ and dPᵀ = v·gᵀ, so that Pᵀ and dSᵀ leave their
//      accumulators as the A fragments of dv += Pᵀ·g and dk += dSᵀ·q~.
//    Each walked tile passes through registers (float32 or bf16 read,
//    rotated and scaled in fp32, rounded once, 16-byte shared stores); its
//    loads are issued before the block computes on the tile before, one
//    tile buffer between two block barriers. Eight warps and 128-row tiles
//    stage each operand half as often as four warps and 64-row tiles, at
//    255 registers a thread and one block an SM: the faster of the shapes
//    tools/ab_space_backward.py times (PERF.md). The K ring, wgmma and TMA
//    are later work.
//  * time (per patch, attention over F = 16 frames): one warp per
//    (b, n, head), as the forward. The 16 rows are one m16 tile, so the
//    softmax is a full-row one in registers and D = Σ P ∘ dP needs no
//    output. q~, k~, v and g are read once (fp32 or bf16 16-byte loads,
//    the rotary on the way in from tables staged in shared memory), P and
//    dS pass through a small per-warp buffer to become the transposed A
//    operands of dv and dk, and dq, dv, dk leave in turn straight from
//    their accumulators (a quad writes 32 contiguous bytes). Bound by
//    bytes: 235 MB at qkv [1, 16, 1024, 1536] float32.
//
// The C entry points: divided_backward.cu (bf16) and divided_backward_f32.cu
// (float32), libraries of their own beside the forward's.
#pragma once

#include <type_traits>

#include "tiny_tile.cuh"

namespace mdt {

constexpr int kBwD = 64;          // head dim the kernels are built for
constexpr int kBwWarps = 8;       // a space block's warps
constexpr int kBwRows = 16 * kBwWarps;   // rows a space block owns
constexpr int kBwTile = 128;      // rows of the walked operand per tile
constexpr int kBwRS = kBwD + 8;   // padded shared row stride (bf16)
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ fragments
// All on bf16 tiles in shared memory with a row stride of `rs` elements
// (16-byte aligned rows). g = lane / 4, t = lane % 4 as in the PTX manual.

// A fragment (rows m0.., cols k0.., 16 x 16) of a tile stored [m][k].
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile,
                                       int rs, int m0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, tile + ((m0 + r + (i & 1) * 8) * rs + k0 + (i >> 1) * 8) * 2);
}

// A fragment (16 x 16 at m0, k0) of a tile stored transposed, [k][m].
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], uint32_t tile,
                                         int rs, int m0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(
      a, tile + ((k0 + r + (i >> 1) * 8) * rs + m0 + (i & 1) * 8) * 2);
}

// B fragments of two n8 tiles (n0.., n0 + 8..) over k0..k0 + 15 of a tile
// stored [n][k]: b[0], b[1] for the first, b[2], b[3] for the second.
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], uint32_t tile,
                                       int rs, int n0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, tile + ((n0 + r + (i >> 1) * 8) * rs + k0 + (i & 1) * 8) * 2);
}

// The same from a tile stored [k][n].
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], uint32_t tile,
                                         int rs, int n0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(
      b, tile + ((k0 + r + (i & 1) * 8) * rs + n0 + (i >> 1) * 8) * 2);
}

// Two n8 accumulator tiles (16 columns) as one bf16 A fragment over k16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// ------------------------------------------------------------ space
// ROWS rows of one head (row stride `ld` elements of T) into a padded bf16
// tile, by the whole block, in two steps so that a tile's loads are in
// flight while the block computes on the one before: load() brings the
// thread's chunks into registers; store() rotates them by the pair table
// rows at `tab` ([rows, dh/2] (cos, sin), the forward's rotary_pair_table;
// small and L2-resident, read here rather than held) when ROT, multiplies
// by `mul`, in fp32, and writes them rounded once.
template <bool ROT, int ROWS, typename T>
struct TileLoad {
  static constexpr int CH = kBwD / 8;
  static constexpr int PER = ROWS * CH / (32 * kBwWarps);
  static_assert(PER * 32 * kBwWarps == ROWS * CH, "whole chunks a thread");
  Chunk8<T> raw[PER];

  __device__ __forceinline__ void load(const T* src, long ld) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + 32 * kBwWarps * u;
      raw[u].load(src + (i / CH) * ld + (i % CH) * 8);
    }
  }

  __device__ __forceinline__ void store(bf16* dst, const float* tab,
                                        float mul) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + 32 * kBwWarps * u, r = i / CH, c = i % CH;
      float x[8];
      raw[u].to_float(x);
      if (ROT) {
        const float4* tp =
            reinterpret_cast<const float4*>(tab + r * kBwD + c * 8);
        const float4 t0 = tp[0], t1 = tp[1];
        const float cs[4] = {t0.x, t0.z, t1.x, t1.z};
        const float sn[4] = {t0.y, t0.w, t1.y, t1.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float a = x[2 * p], b = x[2 * p + 1];
          x[2 * p] = a * cs[p] - b * sn[p];
          x[2 * p + 1] = b * cs[p] + a * sn[p];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= mul;
      store8(dst + r * kBwRS + c * 8, x);
    }
  }
};

template <bool ROT, int ROWS, typename T>
__device__ __forceinline__ void stage_tile(bf16* dst, const T* src, long ld,
                                           const float* tab, float mul) {
  TileLoad<ROT, ROWS, T> t;
  t.load(src, ld);
  t.store(dst, tab, mul);
}

// An accumulator tile row pair (row g and g + 8 of 16 rows, 64 columns)
// through rotᵀ with the pair table rows at `tab` (ROT) and into `dst` (row
// stride ld), times `mul`.
template <bool ROT, typename T>
__device__ __forceinline__ void store_rows(T* dst, long ld, const float* tab,
                                           const float (&acc)[8][4],
                                           float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      float y0 = acc[nt][2 * r] * mul, y1 = acc[nt][2 * r + 1] * mul;
      if (ROT) {
        const float2 cs = *reinterpret_cast<const float2*>(
            tab + row * kBwD + col);   // (cos, sin) of the pair
        const float x0 = y0 * cs.x + y1 * cs.y;
        y1 = y1 * cs.x - y0 * cs.y;
        y0 = x0;
      }
      store2(dst + row * ld + col, y0, y1);
    }
  }
}

template <typename T>
struct SpaceBwdArgs {
  const T* qkv;      // [BF, N, 3·H·dh]
  const float* rot;  // [N, dh/2, 2]
  const T* out;      // [BF, N, H·dh]
  const T* g;        // [BF, N, H·dh]
  T* dqkv;           // [BF, N, 3·H·dh]
  float* stats;      // [BF, H, N, 2]: log2-sum-exp of the scaled scores, D
  int N, H;
  float scale;
};

// two bf16 tiles of max(kBwRows, kBwTile) rows: first the block's own rows
// (two operands), then the walked operands' tiles
constexpr int kBwBuf = (kBwRows > kBwTile ? kBwRows : kBwTile) * kBwRS;

// grid (N / kBwRows, H, BF), block 32·kBwWarps.
template <typename T>
__global__ void __launch_bounds__(32 * kBwWarps)
space_bwd_dq_kernel(const SpaceBwdArgs<T> a) {
  __shared__ __align__(16) bf16 buf[2 * kBwBuf];
  __shared__ float d_s[kBwRows];
  bf16* const x_s = buf;            // q~, then k~ tiles
  bf16* const y_s = buf + kBwBuf;   // g, then v tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int h = blockIdx.y, bf = blockIdx.z, q0 = blockIdx.x * kBwRows;
  const int N = a.N, HD = a.H * kBwD;
  const long ld = 3L * HD;
  const T* qb = a.qkv + (long)bf * N * ld + h * kBwD;
  const T* kb = qb + HD;
  const T* vb = qb + 2 * HD;
  const long io = (long)bf * N * HD + h * kBwD;   // out, g: row stride HD

  stage_tile<true, kBwRows>(x_s, qb + q0 * ld, ld, a.rot + q0 * kBwD,
                            a.scale);
  stage_tile<false, kBwRows>(y_s, a.g + io + (long)q0 * HD, HD, nullptr,
                             1.f);
  {  // D = rowsum(g ∘ out) in fp32: two lanes a row, 32 columns each
    const int row = warp * 16 + (lane >> 1), c0 = (lane & 1) * 32;
    const long off = io + (long)(q0 + row) * HD + c0;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      Chunk8<T> gc, oc;
      gc.load(a.g + off + c);
      oc.load(a.out + off + c);
      float x[8], y[8];
      gc.to_float(x);
      oc.to_float(y);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += x[e] * y[e];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (!(lane & 1)) d_s[row] = d;
  }
  TileLoad<true, kBwTile, T> kl;   // the next k~ tile, in flight
  kl.load(kb, ld);
  __syncthreads();
  const uint32_t xt = smem_u32(x_s), yt = smem_u32(y_s);
  uint32_t qa[4][4], ga[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(qa[kk], xt, kBwRS, warp * 16, kk * 16, lane);
    frag_a(ga[kk], yt, kBwRS, warp * 16, kk * 16, lane);
  }
  const int r0 = warp * 16 + g;   // this lane's rows: r0 and r0 + 8
  const float D[2] = {d_s[r0], d_s[r0 + 8]};

  // sweep 1: each lane's max and exp2 sum of log2e·S over its columns; the
  // last iteration brings in the first k~ and v tiles of sweep 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  TileLoad<false, kBwTile, T> vl;
  for (int k0 = 0; k0 < N; k0 += kBwTile) {
    __syncthreads();   // every warp is done with the last tile
    kl.store(x_s, a.rot + k0 * kBwD, 1.f);
    __syncthreads();
    if (k0 + kBwTile < N) {
      kl.load(kb + (k0 + kBwTile) * ld, ld);
    } else {
      kl.load(kb, ld);
      vl.load(vb, ld);
    }
    float s[kBwTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < kBwTile / 16; ++np) {
        uint32_t b[4];
        frag_b(b, xt, kBwRS, np * 16, kk * 16, lane);
        mma_16816(s[2 * np], qa[kk], b[0], b[1]);
        mma_16816(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < kBwTile / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]) * kLog2e);
      float sum = l[r] * exp2_approx(m[r] - mx);
#pragma unroll
      for (int nt = 0; nt < kBwTile / 8; ++nt)
        sum += exp2_approx(s[nt][2 * r] * kLog2e - mx) +
               exp2_approx(s[nt][2 * r + 1] * kLog2e - mx);
      m[r] = mx;
      l[r] = sum;
    }
  }
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // merge the quad's partial pairs
    float mx = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = l[r] * exp2_approx(m[r] - mx);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    lse[r] = mx + __log2f(sum);
  }
  if ((lane & 3) == 0) {
    float* st = a.stats + ((long)(bf * a.H + h) * N + q0 + r0) * 2;
    *reinterpret_cast<float2*>(st) = make_float2(lse[0], D[0]);
    *reinterpret_cast<float2*>(st + 16) = make_float2(lse[1], D[1]);
  }

  // sweep 2: P, dP, dS and dq += dS·k~, 16 keys at a time
  float dq[8][4] = {};
  for (int k0 = 0; k0 < N; k0 += kBwTile) {
    __syncthreads();
    kl.store(x_s, a.rot + k0 * kBwD, 1.f);
    vl.store(y_s, nullptr, 1.f);
    __syncthreads();
    if (k0 + kBwTile < N) {
      kl.load(kb + (k0 + kBwTile) * ld, ld);
      vl.load(vb + (k0 + kBwTile) * ld, ld);
    }
#pragma unroll
    for (int j = 0; j < kBwTile / 16; ++j) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        frag_b(b, xt, kBwRS, j * 16, kk * 16, lane);
        mma_16816(s[0], qa[kk], b[0], b[1]);
        mma_16816(s[1], qa[kk], b[2], b[3]);
        frag_b(b, yt, kBwRS, j * 16, kk * 16, lane);
        mma_16816(dp[0], ga[kk], b[0], b[1]);
        mma_16816(dp[1], ga[kk], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = exp2_approx(s[nt][e] * kLog2e - lse[r]);
          s[nt][e] = p * (dp[nt][e] - D[r]);   // dS
        }
      uint32_t da[4];
      pack_a(da, s);
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t b[4];
        frag_b_t(b, xt, kBwRS, dn * 16, j * 16, lane);
        mma_16816(dq[2 * dn], da, b[0], b[1]);
        mma_16816(dq[2 * dn + 1], da, b[2], b[3]);
      }
    }
  }
  store_rows<true>(a.dqkv + (long)bf * N * ld + h * kBwD +
                       (q0 + warp * 16) * ld,
                   ld, a.rot + (q0 + warp * 16) * kBwD, dq, a.scale, lane);
}

// grid (N / kBwRows, H, BF), block 32·kBwWarps; after space_bwd_dq_kernel
// (its stats).
template <typename T>
__global__ void __launch_bounds__(32 * kBwWarps)
space_bwd_dkdv_kernel(const SpaceBwdArgs<T> a) {
  __shared__ __align__(16) bf16 buf[2 * kBwBuf];
  __shared__ float2 st_s[kBwTile];   // (lse, D) of the tile's queries
  bf16* const x_s = buf;            // k~, then q~ tiles
  bf16* const y_s = buf + kBwBuf;   // v, then g tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int h = blockIdx.y, bf = blockIdx.z, k0 = blockIdx.x * kBwRows;
  const int N = a.N, HD = a.H * kBwD;
  const long ld = 3L * HD;
  const T* qb = a.qkv + (long)bf * N * ld + h * kBwD;
  const T* gb = a.g + (long)bf * N * HD + h * kBwD;
  const float2* stats =
      reinterpret_cast<const float2*>(a.stats) + (long)(bf * a.H + h) * N;
  const uint32_t xt = smem_u32(x_s), yt = smem_u32(y_s);

  // this warp's 16 keys: k~ and v as A fragments
  stage_tile<true, kBwRows>(x_s, qb + HD + k0 * ld, ld, a.rot + k0 * kBwD,
                            1.f);
  stage_tile<false, kBwRows>(y_s, qb + 2 * HD + k0 * ld, ld, nullptr, 1.f);
  TileLoad<true, kBwTile, T> ql;    // the next q~ and g tiles, in flight
  TileLoad<false, kBwTile, T> gl;
  ql.load(qb, ld);
  gl.load(gb, HD);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(ka[kk], xt, kBwRS, warp * 16, kk * 16, lane);
    frag_a(va[kk], yt, kBwRS, warp * 16, kk * 16, lane);
  }

  float dk[8][4] = {}, dv[8][4] = {};
  for (int i0 = 0; i0 < N; i0 += kBwTile) {
    __syncthreads();   // every warp is done with the last tile
    ql.store(x_s, a.rot + i0 * kBwD, a.scale);
    gl.store(y_s, nullptr, 1.f);
    if (threadIdx.x < kBwTile) st_s[threadIdx.x] = stats[i0 + threadIdx.x];
    __syncthreads();
    if (i0 + kBwTile < N) {
      ql.load(qb + (i0 + kBwTile) * ld, ld);
      gl.load(gb + (long)(i0 + kBwTile) * HD, HD);
    }
#pragma unroll
    for (int j = 0; j < kBwTile / 16; ++j) {
      float s[2][4] = {}, dp[2][4] = {};   // Sᵀ, dPᵀ: keys x 16 queries
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        frag_b(b, xt, kBwRS, j * 16, kk * 16, lane);
        mma_16816(s[0], ka[kk], b[0], b[1]);
        mma_16816(s[1], ka[kk], b[2], b[3]);
        frag_b(b, yt, kBwRS, j * 16, kk * 16, lane);
        mma_16816(dp[0], va[kk], b[0], b[1]);
        mma_16816(dp[1], va[kk], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 st = st_s[j * 16 + nt * 8 + 2 * t + (e & 1)];
          const float p = exp2_approx(s[nt][e] * kLog2e - st.x);
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - st.y);   // dSᵀ
        }
      uint32_t pa[4], da[4];
      pack_a(pa, s);
      pack_a(da, dp);
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t b[4];
        frag_b_t(b, yt, kBwRS, dn * 16, j * 16, lane);
        mma_16816(dv[2 * dn], pa, b[0], b[1]);
        mma_16816(dv[2 * dn + 1], pa, b[2], b[3]);
        frag_b_t(b, xt, kBwRS, dn * 16, j * 16, lane);
        mma_16816(dk[2 * dn], da, b[0], b[1]);
        mma_16816(dk[2 * dn + 1], da, b[2], b[3]);
      }
    }
  }
  const int kr = k0 + warp * 16;
  T* dst = a.dqkv + (long)bf * N * ld + h * kBwD + kr * ld;
  store_rows<true>(dst + HD, ld, a.rot + kr * kBwD, dk, 1.f, lane);
  store_rows<false>(dst + 2 * HD, ld, nullptr, dv, 1.f, lane);
}

// dqkv [BF, N, 3·H·dh] of element type T from qkv, out and g; stats is a
// float32 scratch [BF, H, N, 2]. dh = 64, N a multiple of kBwRows and
// kBwTile.
template <typename T>
int launch_space_backward(const void* qkv, const void* rot, const void* out,
                          const void* g, void* dqkv, void* stats, int BF,
                          int N, int H, float scale, cudaStream_t stream) {
  if (N <= 0 || N % kBwRows || N % kBwTile) return cudaErrorInvalidValue;
  SpaceBwdArgs<T> a{static_cast<const T*>(qkv), static_cast<const float*>(rot),
                    static_cast<const T*>(out),   static_cast<const T*>(g),
                    static_cast<T*>(dqkv),        static_cast<float*>(stats),
                    N, H, scale};
  const dim3 grid(N / kBwRows, H, BF);
  space_bwd_dq_kernel<T><<<grid, 32 * kBwWarps, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  space_bwd_dkdv_kernel<T><<<grid, 32 * kBwWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ time
template <int FT, int DH>
struct TimeBwdShape {
  static_assert(FT == 16, "one m16 tile of frames per warp");
  static constexpr int warps = 8;
  static constexpr int RS = DH + 8;           // q, k, v, g rows (bf16)
  static constexpr int PS = FT + 8;           // P, dS rows (bf16)
  static constexpr int warp_elems = 4 * FT * RS + 2 * FT * PS;
  static constexpr int table_floats = 2 * FT * DH;   // sin, cos
  static constexpr int smem_bytes = table_floats * (int)sizeof(float) +
                                    warps * warp_elems * (int)sizeof(bf16);
};

// grid ceil(B·N·H / 8), block 256; exactly FT frames; qkv, g and dqkv of
// element type T.
template <int FT, int DH, typename T>
__global__ void __launch_bounds__(32 * TimeBwdShape<FT, DH>::warps)
time_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ sin_t,
                const float* __restrict__ cos_t, const T* __restrict__ gin,
                T* __restrict__ dqkv, int B, int N, int H, float scale) {
  using S = TimeBwdShape<FT, DH>;
  constexpr int RS = S::RS, PS = S::PS, CH = DH / 8, KS = DH / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sin_s = reinterpret_cast<float*>(smem_raw);  // [FT][DH]
  float* cos_s = sin_s + FT * DH;
  for (int i = threadIdx.x; i < FT * DH / 4; i += 32 * S::warps) {
    reinterpret_cast<float4*>(sin_s)[i] =
        reinterpret_cast<const float4*>(sin_t)[i];
    reinterpret_cast<float4*>(cos_s)[i] =
        reinterpret_cast<const float4*>(cos_t)[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long wid = (long)blockIdx.x * S::warps + warp;
  if (wid >= (long)B * N * H) return;  // whole warp leaves; no barrier below
  bf16* q_s = reinterpret_cast<bf16*>(sin_s + S::table_floats) +
              warp * S::warp_elems;
  bf16* k_s = q_s + FT * RS;
  bf16* v_s = k_s + FT * RS;
  bf16* g_s = v_s + FT * RS;
  bf16* p_s = g_s + FT * RS;   // P [query][key]
  bf16* d_s = p_s + FT * PS;   // dS [query][key]

  const int h = (int)(wid % H);
  const int n = (int)((wid / H) % N);
  const int b = (int)(wid / ((long)H * N));
  const int HD = H * DH;
  const long in_frame = (long)N * 3 * HD, g_frame = (long)N * HD;
  const long src0 = ((long)b * FT * N + n) * 3L * HD + h * DH;
  const T* src = qkv + src0;
  const T* gsrc = gin + ((long)b * FT * N + n) * HD + h * DH;

#pragma unroll
  for (int i = lane; i < FT * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const T* row = src + r * in_frame + c;
    const float* sn = sin_s + r * DH + c;
    const float* cs = cos_s + r * DH + c;
    float x[8];
    load8<true>(row, true, sn, cs, scale, x);
    store8(q_s + r * RS + c, x);
    load8<true>(row + HD, true, sn, cs, 1.f, x);
    store8(k_s + r * RS + c, x);
    load8<false>(row + 2 * HD, true, nullptr, nullptr, 1.f, x);
    store8(v_s + r * RS + c, x);
    load8<false>(gsrc + r * g_frame + c, true, nullptr, nullptr, 1.f, x);
    store8(g_s + r * RS + c, x);
  }
  __syncwarp();
  const uint32_t qt = smem_u32(q_s), kt = smem_u32(k_s), vt = smem_u32(v_s);
  const uint32_t gt = smem_u32(g_s), pt = smem_u32(p_s), dt = smem_u32(d_s);

  // S = q~·k~ᵀ and dP = g·vᵀ, 16 x 16 each
  float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t fa[4], fb[4];
    frag_a(fa, qt, RS, 0, kk * 16, lane);
    frag_b(fb, kt, RS, 0, kk * 16, lane);
    mma_16816(s[0], fa, fb[0], fb[1]);
    mma_16816(s[1], fa, fb[2], fb[3]);
    frag_a(fa, gt, RS, 0, kk * 16, lane);
    frag_b(fb, vt, RS, 0, kk * 16, lane);
    mma_16816(dp[0], fa, fb[0], fb[1]);
    mma_16816(dp[1], fa, fb[2], fb[3]);
  }
  // full-row softmax, D = Σ P ∘ dP and dS = P ∘ (dP − D); rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                     fmaxf(s[1][2 * r], s[1][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx *= kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[nt][e] = exp2_approx(s[nt][e] * kLog2e - mx);
        sum += s[nt][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    float d = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[nt][e] *= inv;
        d += s[nt][e] * dp[nt][e];
      }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - d);
  }
  // P and dS as bf16 [query][key] for the transposed products
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (g + 8 * r) * PS + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(p_s + off) =
          pack_bf16(s[nt][2 * r], s[nt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(d_s + off) =
          pack_bf16(dp[nt][2 * r], dp[nt][2 * r + 1]);
    }
  uint32_t da[4];
  pack_a(da, dp);
  __syncwarp();

  T* dst = dqkv + src0;
  const long ld = in_frame;   // one frame to the next
  float acc[DH / 8][4];
  // dq = rotᵀ(scale·dS·k~), dk = rotᵀ(dSᵀ·q~), dv = Pᵀ·g, one at a time
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    uint32_t fa[4];
    if (which == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[e] = da[e];
    } else {
      frag_a_t(fa, which == 1 ? dt : pt, PS, 0, 0, lane);
    }
    const uint32_t bt = which == 0 ? kt : which == 1 ? qt : gt;
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      uint32_t fb[4];
      frag_b_t(fb, bt, RS, dn * 16, 0, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[2 * dn][e] = acc[2 * dn + 1][e] = 0.f;
      mma_16816(acc[2 * dn], fa, fb[0], fb[1]);
      mma_16816(acc[2 * dn + 1], fa, fb[2], fb[3]);
    }
    const float mul = which == 0 ? scale : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        float y0 = acc[nt][2 * r] * mul, y1 = acc[nt][2 * r + 1] * mul;
        if (which < 2) {   // rotᵀ with the time table (pair entries differ)
          const float* sn = sin_s + row * DH + col;
          const float* cs = cos_s + row * DH + col;
          const float x0 = y0 * cs[0] + y1 * sn[1];
          y1 = y1 * cs[1] - y0 * sn[0];
          y0 = x0;
        }
        store2(dst + row * ld + which * HD + col, y0, y1);
      }
    }
  }
}

template <int FT, int DH, typename T>
int launch_time_backward(const void* qkv, const void* sin_t,
                         const void* cos_t, const void* g, void* dqkv, int B,
                         int N, int H, float scale, cudaStream_t stream) {
  using S = TimeBwdShape<FT, DH>;
  auto kern = time_bwd_kernel<FT, DH, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
  if (err != cudaSuccess) return err;
  const long warps = (long)B * N * H;
  const unsigned blocks = (unsigned)((warps + S::warps - 1) / S::warps);
  kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<const T*>(g),
      static_cast<T*>(dqkv), B, N, H, scale);
  return cudaGetLastError();
}

}  // namespace mdt
