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
//  * space (per frame, attention over N patches, N % 128 == 0, N <= 2048 as
//    the gate admits): two kernels, built per head-dim class DH (16, 32, 64,
//    128; a head of 2, 4 or 8 dims runs on the 16-wide class with its
//    columns past dh read as zeros and never stored; at 2 and 4 dims the
//    scores' operands are split into bf16 hi + lo in those columns, SPLIT
//    below). At the AE's shape (qkv [16, 1024, 1536] float32) five
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
//    tools/ab_space_backward.py times (PERF.md). At DH = 128 a warp's dk and
//    dv accumulators alone take 128 registers, so a block has four warps
//    over 32-row tiles. The K ring, wgmma and TMA are later work.
//  * time (per patch, attention over F frames): one warp per (b, n, head),
//    as the forward, built per frame class (16 or 32) and head-dim class as
//    the forward (tiny_tile.cuh), frames past F and columns past dh read as
//    zeros, frames masked, neither stored. The rows are one or two m16
//    tiles, so the softmax is a full-row one in registers and D = Σ P ∘ dP
//    needs no output. q~, k~, v and g are read once (fp32 or bf16 16-byte loads,
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

constexpr float kLog2e = 1.4426950408889634f;

// A space block's shape per head-dim class: its warps (16 rows each), the
// rows it owns, the rows of the walked operand per tile, and the padded
// shared row stride (bf16). DH = 64 is the configurations' (eight warps over
// 128-row tiles); at DH = 128 the accumulators leave room for four warps
// and the loads in flight for 32-row tiles.
template <int DH>
struct SpaceBwd {
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 128,
                "head-dim classes");
  static constexpr int warps = DH == 128 ? 4 : 8;
  static constexpr int rows = 16 * warps;
  static constexpr int tile = DH == 128 ? 32 : 128;
  static constexpr int RS = DH + 8;
  // two bf16 tiles of max(rows, tile) rows: first the block's own rows (two
  // operands), then the walked operands' tiles
  static constexpr int buf = (rows > tile ? rows : tile) * RS;
};

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
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&c)[2][4]) {
  pack_a(a, c[0], c[1]);
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
// by `mul`, in fp32, and writes them rounded once. PAD (the classes): a
// head of dh <= DH dims, its chunks past dh read as zeros (its table entries
// not read), the rotation rounded as the plain rotary rounds it.
//
// SPLIT (heads of 2 and 4 dims, whose scores would otherwise sum two or
// four bf16-rounded products and miss the plain backward's limits): x is
// written as its bf16 rounding hi and the bf16 rounding lo of x - hi, in
// the 16 columns of the class, hi | lo | hi for q~ (kSplitQ) and hi | hi |
// lo for k~ (kSplitK), so that one k16 product sums q_hi·k_hi + q_lo·k_hi
// + q_hi·k_lo: the scores to some 16 bits more. The columns past dh are
// never stored, so dq = dS·k~ and dk = dSᵀ·q~ still take hi alone.
constexpr int kSplitQ = 1, kSplitK = 2;

template <bool ROT, int ROWS, typename T, int DH, bool PAD>
struct TileLoad {
  static constexpr int CH = DH / 8;
  static constexpr int THREADS = 32 * SpaceBwd<DH>::warps;
  static constexpr int PER = ROWS * CH / THREADS;
  static_assert(PER * THREADS == ROWS * CH, "whole chunks a thread");
  Chunk8<T> raw[PER];

  __device__ __forceinline__ void load(const T* src, long ld, int dh) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + THREADS * u;
      const T* p = src + (i / CH) * ld + (i % CH) * 8;
      if (PAD)
        load_chunk(raw[u], p, dh - (i % CH) * 8);
      else
        raw[u].load(p);
    }
  }

  __device__ __forceinline__ void store(bf16* dst, const float* tab, int dh,
                                        float mul, int split = 0) const {
    // (a head of at most 4 dims lies in chunk 0, whose thread writes both
    // chunks of its row)
    const bool two = PAD && DH == 16 && split && dh <= 4;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + THREADS * u, r = i / CH, c = i % CH;
      if (two && c) continue;
      float x[8];
      raw[u].to_float(x);
      if (ROT && (!PAD || c * 8 < dh)) {
        const float* tr = tab + r * dh + c * 8;   // (cos, sin) of 4 pairs
        float cs[4], sn[4];
        if (!PAD || c * 8 + 8 <= dh) {
          const float4 t0 = reinterpret_cast<const float4*>(tr)[0];
          const float4 t1 = reinterpret_cast<const float4*>(tr)[1];
          cs[0] = t0.x; cs[1] = t0.z; cs[2] = t1.x; cs[3] = t1.z;
          sn[0] = t0.y; sn[1] = t0.w; sn[2] = t1.y; sn[3] = t1.w;
        } else {   // a head of 2 or 4 dims: its pairs one by one
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool in = c * 8 + 2 * q < dh;
            cs[q] = in ? tr[2 * q] : 0.f;
            sn[q] = in ? tr[2 * q + 1] : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (PAD) {   // the classes' rounding (rotate_pair_rn)
            rotate_pair_rn(x[2 * q], x[2 * q + 1], cs[q], sn[q], cs[q],
                           sn[q]);
          } else {
            const float a = x[2 * q], b = x[2 * q + 1];
            x[2 * q] = a * cs[q] - b * sn[q];
            x[2 * q + 1] = b * cs[q] + a * sn[q];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= mul;
      if (two) {   // columns 0-7 in y0, 8-15 in y1
        float y0[8] = {}, y1[8] = {};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hi = __bfloat162float(__float2bfloat16_rn(x[e]));
          const float lo = x[e] - hi;
          const float second = split == kSplitQ ? lo : hi;
          const float third = split == kSplitQ ? hi : lo;
          if (dh == 4) {
            y0[e] = hi;
            y0[4 + e] = second;
            y1[e] = third;
          } else if (e < 2) {
            y0[e] = hi;
            y0[2 + e] = second;
            y0[4 + e] = third;
          }
        }
        store8(dst + r * SpaceBwd<DH>::RS, y0);
        store8(dst + r * SpaceBwd<DH>::RS + 8, y1);
        continue;
      }
      store8(dst + r * SpaceBwd<DH>::RS + c * 8, x);
    }
  }
};

template <bool ROT, int ROWS, typename T, int DH, bool PAD>
__device__ __forceinline__ void stage_tile(bf16* dst, const T* src, long ld,
                                           const float* tab, int dh,
                                           float mul, int split = 0) {
  TileLoad<ROT, ROWS, T, DH, PAD> t;
  t.load(src, ld, dh);
  t.store(dst, tab, dh, mul, split);
}

// An accumulator tile row pair (row g and g + 8 of 16 rows, DH columns)
// through rotᵀ with the pair table rows at `tab` (ROT) and into `dst` (row
// stride ld), times `mul`; columns past dh (PAD) are not stored, and rotᵀ
// is rounded as the plain backward rounds it (the classes).
template <bool ROT, typename T, int DH, bool PAD>
__device__ __forceinline__ void store_rows(T* dst, long ld, const float* tab,
                                           const float (&acc)[DH / 8][4],
                                           float mul, int lane, int dh) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (PAD && col >= dh) continue;
      float y0 = acc[nt][2 * r] * mul, y1 = acc[nt][2 * r + 1] * mul;
      if (ROT) {
        const float2 cs = *reinterpret_cast<const float2*>(
            tab + row * dh + col);   // (cos, sin) of the pair
        if (PAD) {
          rotate_pair_t_rn(y0, y1, cs.x, cs.y, cs.x, cs.y);
        } else {
          const float x0 = y0 * cs.x + y1 * cs.y;
          y1 = y1 * cs.x - y0 * cs.y;
          y0 = x0;
        }
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
  int dh;            // the head dim (its class DH where not padded)
};

// grid (N / rows, H, BF), block 32·warps (SpaceBwd<DH>).
template <typename T, int DH, bool PAD = false>
__global__ void __launch_bounds__(32 * SpaceBwd<DH>::warps)
space_bwd_dq_kernel(const SpaceBwdArgs<T> a) {
  using Sh = SpaceBwd<DH>;
  constexpr int RS = Sh::RS, ROWS = Sh::rows, TILE = Sh::tile, KS = DH / 16;
  __shared__ __align__(16) bf16 buf[2 * Sh::buf];
  __shared__ float d_s[ROWS];
  bf16* const x_s = buf;            // q~, then k~ tiles
  bf16* const y_s = buf + Sh::buf;  // g, then v tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int h = blockIdx.y, bf = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int dh = PAD ? a.dh : DH;
  const int N = a.N, HD = a.H * dh;
  const long ld = 3L * HD;
  const T* qb = a.qkv + (long)bf * N * ld + h * dh;
  const T* kb = qb + HD;
  const T* vb = qb + 2 * HD;
  const long io = (long)bf * N * HD + h * dh;   // out, g: row stride HD

  stage_tile<true, ROWS, T, DH, PAD>(x_s, qb + q0 * ld, ld, a.rot + q0 * dh,
                                     dh, a.scale, kSplitQ);
  stage_tile<false, ROWS, T, DH, PAD>(y_s, a.g + io + (long)q0 * HD, HD,
                                      nullptr, dh, 1.f);
  {  // D = rowsum(g ∘ out) in fp32: two lanes a row, DH / 2 columns each
    const int row = warp * 16 + (lane >> 1), c0 = (lane & 1) * (DH / 2);
    const long off = io + (long)(q0 + row) * HD + c0;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 2; c += 8) {
      Chunk8<T> gc, oc;
      if (PAD) {
        load_chunk(gc, a.g + off + c, dh - c0 - c);
        load_chunk(oc, a.out + off + c, dh - c0 - c);
      } else {
        gc.load(a.g + off + c);
        oc.load(a.out + off + c);
      }
      float x[8], y[8];
      gc.to_float(x);
      oc.to_float(y);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += x[e] * y[e];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (!(lane & 1)) d_s[row] = d;
  }
  TileLoad<true, TILE, T, DH, PAD> kl;   // the next k~ tile, in flight
  kl.load(kb, ld, dh);
  __syncthreads();
  const uint32_t xt = smem_u32(x_s), yt = smem_u32(y_s);
  uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    frag_a(qa[kk], xt, RS, warp * 16, kk * 16, lane);
    frag_a(ga[kk], yt, RS, warp * 16, kk * 16, lane);
  }
  const int r0 = warp * 16 + g;   // this lane's rows: r0 and r0 + 8
  const float D[2] = {d_s[r0], d_s[r0 + 8]};

  // sweep 1: each lane's max and exp2 sum of log2e·S over its columns; the
  // last iteration brings in the first k~ and v tiles of sweep 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  TileLoad<false, TILE, T, DH, PAD> vl;
  for (int k0 = 0; k0 < N; k0 += TILE) {
    __syncthreads();   // every warp is done with the last tile
    kl.store(x_s, a.rot + k0 * dh, dh, 1.f, kSplitK);
    __syncthreads();
    if (k0 + TILE < N) {
      kl.load(kb + (k0 + TILE) * ld, ld, dh);
    } else {
      kl.load(kb, ld, dh);
      vl.load(vb, ld, dh);
    }
    float s[TILE / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < TILE / 16; ++np) {
        uint32_t b[4];
        frag_b(b, xt, RS, np * 16, kk * 16, lane);
        mma_16816(s[2 * np], qa[kk], b[0], b[1]);
        mma_16816(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]) * kLog2e);
      float sum = l[r] * exp2_approx(m[r] - mx);
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt)
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
  float dq[DH / 8][4] = {};
  for (int k0 = 0; k0 < N; k0 += TILE) {
    __syncthreads();
    kl.store(x_s, a.rot + k0 * dh, dh, 1.f, kSplitK);
    vl.store(y_s, nullptr, dh, 1.f);
    __syncthreads();
    if (k0 + TILE < N) {
      kl.load(kb + (k0 + TILE) * ld, ld, dh);
      vl.load(vb + (k0 + TILE) * ld, ld, dh);
    }
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        frag_b(b, xt, RS, j * 16, kk * 16, lane);
        mma_16816(s[0], qa[kk], b[0], b[1]);
        mma_16816(s[1], qa[kk], b[2], b[3]);
        frag_b(b, yt, RS, j * 16, kk * 16, lane);
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
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t b[4];
        frag_b_t(b, xt, RS, dn * 16, j * 16, lane);
        mma_16816(dq[2 * dn], da, b[0], b[1]);
        mma_16816(dq[2 * dn + 1], da, b[2], b[3]);
      }
    }
  }
  store_rows<true, T, DH, PAD>(
      a.dqkv + (long)bf * N * ld + h * dh + (q0 + warp * 16) * ld, ld,
      a.rot + (q0 + warp * 16) * dh, dq, a.scale, lane, dh);
}

// grid (N / rows, H, BF), block 32·warps; after space_bwd_dq_kernel (its
// stats).
template <typename T, int DH, bool PAD = false>
__global__ void __launch_bounds__(32 * SpaceBwd<DH>::warps)
space_bwd_dkdv_kernel(const SpaceBwdArgs<T> a) {
  using Sh = SpaceBwd<DH>;
  constexpr int RS = Sh::RS, ROWS = Sh::rows, TILE = Sh::tile, KS = DH / 16;
  __shared__ __align__(16) bf16 buf[2 * Sh::buf];
  __shared__ float2 st_s[TILE];     // (lse, D) of the tile's queries
  bf16* const x_s = buf;            // k~, then q~ tiles
  bf16* const y_s = buf + Sh::buf;  // v, then g tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int h = blockIdx.y, bf = blockIdx.z, k0 = blockIdx.x * ROWS;
  const int dh = PAD ? a.dh : DH;
  const int N = a.N, HD = a.H * dh;
  const long ld = 3L * HD;
  const T* qb = a.qkv + (long)bf * N * ld + h * dh;
  const T* gb = a.g + (long)bf * N * HD + h * dh;
  const float2* stats =
      reinterpret_cast<const float2*>(a.stats) + (long)(bf * a.H + h) * N;
  const uint32_t xt = smem_u32(x_s), yt = smem_u32(y_s);

  // this warp's 16 keys: k~ and v as A fragments
  stage_tile<true, ROWS, T, DH, PAD>(x_s, qb + HD + k0 * ld, ld,
                                     a.rot + k0 * dh, dh, 1.f, kSplitK);
  stage_tile<false, ROWS, T, DH, PAD>(y_s, qb + 2 * HD + k0 * ld, ld,
                                      nullptr, dh, 1.f);
  TileLoad<true, TILE, T, DH, PAD> ql;    // the next q~ and g tiles, in flight
  TileLoad<false, TILE, T, DH, PAD> gl;
  ql.load(qb, ld, dh);
  gl.load(gb, HD, dh);
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    frag_a(ka[kk], xt, RS, warp * 16, kk * 16, lane);
    frag_a(va[kk], yt, RS, warp * 16, kk * 16, lane);
  }

  float dk[DH / 8][4] = {}, dv[DH / 8][4] = {};
  for (int i0 = 0; i0 < N; i0 += TILE) {
    __syncthreads();   // every warp is done with the last tile
    ql.store(x_s, a.rot + i0 * dh, dh, a.scale, kSplitQ);
    gl.store(y_s, nullptr, dh, 1.f);
    if (threadIdx.x < TILE) st_s[threadIdx.x] = stats[i0 + threadIdx.x];
    __syncthreads();
    if (i0 + TILE < N) {
      ql.load(qb + (i0 + TILE) * ld, ld, dh);
      gl.load(gb + (long)(i0 + TILE) * HD, HD, dh);
    }
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      float s[2][4] = {}, dp[2][4] = {};   // Sᵀ, dPᵀ: keys x 16 queries
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        frag_b(b, xt, RS, j * 16, kk * 16, lane);
        mma_16816(s[0], ka[kk], b[0], b[1]);
        mma_16816(s[1], ka[kk], b[2], b[3]);
        frag_b(b, yt, RS, j * 16, kk * 16, lane);
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
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t b[4];
        frag_b_t(b, yt, RS, dn * 16, j * 16, lane);
        mma_16816(dv[2 * dn], pa, b[0], b[1]);
        mma_16816(dv[2 * dn + 1], pa, b[2], b[3]);
        frag_b_t(b, xt, RS, dn * 16, j * 16, lane);
        mma_16816(dk[2 * dn], da, b[0], b[1]);
        mma_16816(dk[2 * dn + 1], da, b[2], b[3]);
      }
    }
  }
  const int kr = k0 + warp * 16;
  T* dst = a.dqkv + (long)bf * N * ld + h * dh + kr * ld;
  store_rows<true, T, DH, PAD>(dst + HD, ld, a.rot + kr * dh, dk, 1.f, lane,
                               dh);
  store_rows<false, T, DH, PAD>(dst + 2 * HD, ld, nullptr, dv, 1.f, lane, dh);
}

// dqkv [BF, N, 3·H·dh] of element type T from qkv, out and g; stats is a
// float32 scratch [BF, H, N, 2]. Head dim dh of class DH (PAD where they
// differ), N a multiple of the class's rows and tile.
template <typename T, int DH = 64, bool PAD = false>
int launch_space_backward(const void* qkv, const void* rot, const void* out,
                          const void* g, void* dqkv, void* stats, int BF,
                          int N, int H, int dh, float scale,
                          cudaStream_t stream) {
  using Sh = SpaceBwd<DH>;
  if (N <= 0 || N % Sh::rows || N % Sh::tile || (!PAD && dh != DH) ||
      dh > DH)
    return cudaErrorInvalidValue;
  SpaceBwdArgs<T> a{static_cast<const T*>(qkv), static_cast<const float*>(rot),
                    static_cast<const T*>(out),   static_cast<const T*>(g),
                    static_cast<T*>(dqkv),        static_cast<float*>(stats),
                    N, H, scale, dh};
  const dim3 grid(N / Sh::rows, H, BF);
  space_bwd_dq_kernel<T, DH, PAD><<<grid, 32 * Sh::warps, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  space_bwd_dkdv_kernel<T, DH, PAD><<<grid, 32 * Sh::warps, 0, stream>>>(a);
  return cudaGetLastError();
}

// The space backward at a head dim dh dividing 128 from 2 up (what the gate
// admits) other than the configurations' 64 (divided_backward{,_f32}.cu):
// the class 16 (2, 4 and 8 padded), 32 or 128, with the classes' padding
// and rounding (PAD).
template <typename T>
int launch_space_backward_classes(const void* qkv, const void* rot,
                                  const void* out, const void* g, void* dqkv,
                                  void* stats, int BF, int N, int H, int dh,
                                  float scale, cudaStream_t stream) {
  if (dh < 2 || dh > 128 || 128 % dh) return cudaErrorInvalidValue;
  switch (dh < 16 ? 16 : dh) {
    case 16:
      return launch_space_backward<T, 16, true>(qkv, rot, out, g, dqkv, stats,
                                                BF, N, H, dh, scale, stream);
    case 32:
      return launch_space_backward<T, 32, true>(qkv, rot, out, g, dqkv, stats,
                                                BF, N, H, dh, scale, stream);
    case 128:
      return launch_space_backward<T, 128, true>(qkv, rot, out, g, dqkv,
                                                 stats, BF, N, H, dh, scale,
                                                 stream);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ time
template <int FT, int DH>
struct TimeBwdShape {
  static_assert(FT == 16 || FT == 32, "one or two m16 tiles of frames");
  static constexpr int RS = DH + 8;           // q, k, v, g rows (bf16)
  static constexpr int PS = FT + 8;           // P, dS rows (bf16)
  static constexpr int warp_elems = 4 * FT * RS + 2 * FT * PS;
  static constexpr int table_floats = 2 * FT * DH;   // sin, cos
  // blocks of eight warps unless four keep more warps on an SM
  static constexpr int warps =
      resident_warps(4, table_floats * 4, warp_elems * 2) >
              resident_warps(8, table_floats * 4, warp_elems * 2)
          ? 4
          : 8;
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
  static_assert(FT == 16, "one m16 tile of frames per warp");
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


// The classes' time backward (grid ceil(B·N·H / warps), block 32·warps):
// the kernel above at F <= FT frames (one or two m16 tiles) of head dim
// dh <= DH, frames and columns past them read as zeros (frames masked in
// the softmax), never stored, and the rotary, its transpose and the exp
// rounded as the plain backward rounds them. A kernel of its own, so that
// the configurations' instantiation above compiles as it did before the
// classes.
template <int FT, int DH, typename T>
__global__ void __launch_bounds__(32 * TimeBwdShape<FT, DH>::warps)
time_bwd_class_kernel(const T* __restrict__ qkv,
                      const float* __restrict__ sin_t,
                      const float* __restrict__ cos_t,
                      const T* __restrict__ gin, T* __restrict__ dqkv, int B,
                      int N, int H, float scale, int F, int dh) {
  using S = TimeBwdShape<FT, DH>;
  constexpr int RS = S::RS, PS = S::PS, CH = DH / 8, KS = DH / 16;
  constexpr int MT = FT / 16;   // m16 tiles of frames
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sin_s = reinterpret_cast<float*>(smem_raw);  // [FT][DH]
  float* cos_s = sin_s + FT * DH;
  stage_table<FT, DH>(sin_s, sin_t, F, dh, 32 * S::warps);
  stage_table<FT, DH>(cos_s, cos_t, F, dh, 32 * S::warps);
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
  const int HD = H * dh;
  const long in_frame = (long)N * 3 * HD, g_frame = (long)N * HD;
  const long src0 = ((long)b * F * N + n) * 3L * HD + h * dh;
  const T* src = qkv + src0;
  const T* gsrc = gin + ((long)b * F * N + n) * HD + h * dh;

#pragma unroll
  for (int i = lane; i < FT * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const T* row = src + r * in_frame + c;
    const float* sn = sin_s + r * DH + c;
    const float* cs = cos_s + r * DH + c;
    // the elements of this chunk inside the sequence and the head
    const int part = r < F ? dh - c : 0;
    float x[8];
    load8_part<true>(row, part, sn, cs, scale, x);
    store8(q_s + r * RS + c, x);
    load8_part<true>(row + HD, part, sn, cs, 1.f, x);
    store8(k_s + r * RS + c, x);
    load8_part<false>(row + 2 * HD, part, nullptr, nullptr, 1.f, x);
    store8(v_s + r * RS + c, x);
    load8_part<false>(gsrc + r * g_frame + c, part, nullptr, nullptr, 1.f, x);
    store8(g_s + r * RS + c, x);
  }
  __syncwarp();
  const uint32_t qt = smem_u32(q_s), kt = smem_u32(k_s), vt = smem_u32(v_s);
  const uint32_t gt = smem_u32(g_s), pt = smem_u32(p_s), dt = smem_u32(d_s);

  // S = q~·k~ᵀ and dP = g·vᵀ, FT x FT each
  float s[MT][FT / 8][4] = {}, dp[MT][FT / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t fa[4], fb[4];
      frag_a(fa, qt, RS, mt * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < FT / 16; ++np) {
        frag_b(fb, kt, RS, np * 16, kk * 16, lane);
        mma_16816(s[mt][2 * np], fa, fb[0], fb[1]);
        mma_16816(s[mt][2 * np + 1], fa, fb[2], fb[3]);
      }
      frag_a(fa, gt, RS, mt * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < FT / 16; ++np) {
        frag_b(fb, vt, RS, np * 16, kk * 16, lane);
        mma_16816(dp[mt][2 * np], fa, fb[0], fb[1]);
        mma_16816(dp[mt][2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }
  // full-row softmax, D = Σ P ∘ dP and dS = P ∘ (dP − D); rows g, g + 8 of
  // each m16 tile (s[mt][nt][2 r + c] is key 8 nt + 2 t + c)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int nt = 0; nt < FT / 8; ++nt) {   // keys past F weigh nothing
        if (nt * 8 + 2 * t >= F) s[mt][nt][2 * r] = -INFINITY;
        if (nt * 8 + 2 * t + 1 >= F) s[mt][nt][2 * r + 1] = -INFINITY;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < FT / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < FT / 8; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[mt][nt][e] = expf(s[mt][nt][e] - mx);   // the plain softmax's
          sum += s[mt][nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      float d = 0.f;
#pragma unroll
      for (int nt = 0; nt < FT / 8; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[mt][nt][e] *= inv;
          d += s[mt][nt][e] * dp[mt][nt][e];
        }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
#pragma unroll
      for (int nt = 0; nt < FT / 8; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          dp[mt][nt][e] = s[mt][nt][e] * (dp[mt][nt][e] - d);
    }
  // P and dS as bf16 [query][key] for the transposed products
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < FT / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (mt * 16 + g + 8 * r) * PS + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p_s + off) =
            pack_bf16(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(d_s + off) =
            pack_bf16(dp[mt][nt][2 * r], dp[mt][nt][2 * r + 1]);
      }
  __syncwarp();

  T* dst = dqkv + src0;
  const long ld = in_frame;   // one frame to the next
  float acc[DH / 8][4];
  // dq = rotᵀ(scale·dS·k~), dk = rotᵀ(dSᵀ·q~), dv = Pᵀ·g, one at a time,
  // one m16 tile of output rows (queries for dq, keys for dk and dv) at a
  // time
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    const uint32_t bt = which == 0 ? kt : which == 1 ? qt : gt;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < DH / 8; ++e)
        acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < FT / 16; ++kk) {
        uint32_t fa[4];
        if (which == 0)
          pack_a(fa, dp[mt][2 * kk], dp[mt][2 * kk + 1]);
        else
          frag_a_t(fa, which == 1 ? dt : pt, PS, mt * 16, kk * 16, lane);
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t fb[4];
          frag_b_t(fb, bt, RS, dn * 16, kk * 16, lane);
          mma_16816(acc[2 * dn], fa, fb[0], fb[1]);
          mma_16816(acc[2 * dn + 1], fa, fb[2], fb[3]);
        }
      }
      const float mul = which == 0 ? scale : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mt * 16 + g + 8 * r;
        if (row >= F) continue;
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt) {
          const int col = nt * 8 + 2 * t;
          if (col >= dh) continue;
          float y0 = acc[nt][2 * r] * mul, y1 = acc[nt][2 * r + 1] * mul;
          if (which < 2) {   // rotᵀ with the time table (pair entries differ)
            const float* sn = sin_s + row * DH + col;
            const float* cs = cos_s + row * DH + col;
            rotate_pair_t_rn(y0, y1, cs[0], sn[0], cs[1], sn[1]);
          }
          store2(dst + row * ld + which * HD + col, y0, y1);
        }
      }
    }
  }
}

template <int FT, int DH, typename T, bool PAD = false>
int launch_time_backward(const void* qkv, const void* sin_t,
                         const void* cos_t, const void* g, void* dqkv, int B,
                         int F, int N, int H, int dh, float scale,
                         cudaStream_t stream) {
  using S = TimeBwdShape<FT, DH>;
  const long warps = (long)B * N * H;
  const unsigned blocks = (unsigned)((warps + S::warps - 1) / S::warps);
  const T *x = static_cast<const T*>(qkv), *gi = static_cast<const T*>(g);
  const float *sn = static_cast<const float*>(sin_t),
              *cs = static_cast<const float*>(cos_t);
  T* dx = static_cast<T*>(dqkv);
  if constexpr (PAD) {
    auto kern = time_bwd_class_kernel<FT, DH, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
    if (err != cudaSuccess) return err;
    kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(
        x, sn, cs, gi, dx, B, N, H, scale, F, dh);
  } else {
    auto kern = time_bwd_kernel<FT, DH, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
    if (err != cudaSuccess) return err;
    kern<<<blocks, 32 * S::warps, S::smem_bytes, stream>>>(x, sn, cs, gi, dx,
                                                           B, N, H, scale);
  }
  return cudaGetLastError();
}

// The time backward at what the gate admits (F % 8 == 0 up to 32, dh
// dividing 128 from 2 up): the frame class 16 or 32 and the head-dim class
// that hold the shape, with the classes' padding, masking and rounding.
template <typename T>
int launch_time_backward_classes(const void* qkv, const void* sin_t,
                                 const void* cos_t, const void* g, void* dqkv,
                                 int B, int F, int N, int H, int dh,
                                 float scale, cudaStream_t stream) {
  if (F < 8 || F > 32 || F % 8 || dh < 2 || dh > 128 || 128 % dh)
    return cudaErrorInvalidValue;
  const bool tall = F > 16;
#define MDT_TIME_BWD(DH)                                                     \
  return tall ? launch_time_backward<32, DH, T, true>(                       \
                    qkv, sin_t, cos_t, g, dqkv, B, F, N, H, dh, scale,       \
                    stream)                                                  \
              : launch_time_backward<16, DH, T, true>(                       \
                    qkv, sin_t, cos_t, g, dqkv, B, F, N, H, dh, scale, stream)
  switch (dh < 16 ? 16 : dh) {
    case 16: MDT_TIME_BWD(16);
    case 32: MDT_TIME_BWD(32);
    case 64: MDT_TIME_BWD(64);
    case 128: MDT_TIME_BWD(128);
  }
#undef MDT_TIME_BWD
  return cudaErrorInvalidValue;
}

}  // namespace mdt
