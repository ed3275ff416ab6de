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
// y[2i]·s[2i]. A C fragment (mma.sync's and wgmma's alike) holds columns 2t
// and 2t + 1 of a row, one rotated pair, so rotᵀ runs in registers before
// the store.
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
//  * space (per frame, attention over N patches, N % 128 == 0, 256 <= N <=
//    2048 as the gate admits): bound by operations (five products of
//    2·N²·dh per (frame, head): 8.6e10 FLOPs against 268 MB at the AE's qkv
//    [16, 1024, 1536] float32) and by ex2, since S is worked out three
//    times (row statistics, dq, dk and dv). At head dims 32, 64 and 128
//    three steps, the forward's pre-rotated design (divided_space.cuh)
//    carried over:
//    - a pre-pass, once per call: q~, k~ and v in bf16 into a scratch
//      [BF, N, 3·H·dh] (the forward's space_rotate_kernel), and g in bf16
//      into gs [BF, N, H·dh] with D = rowsum(g ∘ out) from g and out in
//      their own type into dsum [BF, H, N] (space_bwd_prep_kernel). The
//      scratch is the wrapper's (torch.empty); the kernels allocate
//      nothing.
//    - dq: a block owns 128 query rows of one (frame, head), 64 for each of
//      two consumer warpgroups, with q~ and g resident in 128-byte-swizzled
//      shared memory as the wgmma A operands. A producer warpgroup streams
//      tiles of k~ (then of k~ and v) raw through a ring of four slots with
//      cp.async arriving on the slot's mbarrier. Sweep 1 takes each row's
//      max and ex2 sum of log2e·S (S = q~·k~ᵀ on wgmma) and writes
//      (log2-sum-exp, D) to stats [BF, H, N, 2]; sweep 2 runs S and
//      dP = g·vᵀ on wgmma, P and dS in fp32 registers, and dq += dS·k~ with
//      dS rounded to bf16 as the register A operand and the k~ tile read as
//      the MN-major B operand (never transposed by hand).
//    - dk, dv: a block owns 128 keys, k~ and v resident; q~ and g tiles
//      stream with their rows' (lse, D): Sᵀ = k~·q~ᵀ and dPᵀ = v·gᵀ, then
//      Pᵀ and dSᵀ leave their accumulators as the register operands of
//      dv += Pᵀ·g and dk += dSᵀ·q~.
//    Built per head-dim class: 64 (64, and 32 padded: columns past dh zeros
//    in shared memory and never stored, the scores over the head's k16
//    steps alone) with 128-row tiles, and 128 (two 64-column panels a row)
//    with 64-row tiles, where dk and dv alone take 128 registers a thread.
//    Heads of 2 to 16 dims keep the earlier mma.sync class ("space,
//    narrow" below), which ran faster there.
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
// (float32), libraries of their own beside the forward's; the classes in
// divided_backward_classes{,_f32}.cu.
#pragma once

#include <type_traits>

#include "divided_space.cuh"
#include "tiny_tile.cuh"

namespace mdt {

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
// The pre-pass's second kernel (grid ceil(rows x H x dh / 8 / 256), block
// 256): g rounded to bf16 into gs [rows, H·dh], and D = rowsum(g ∘ out) in
// fp32 into dsum [BF, H, N], from g and out in their own type. One thread
// per 16-byte chunk of gs; a head's dh / 8 chunks are neighbouring lanes of
// one warp. Each lane sums its eight products in
// order, each product and sum rounded on its own, then the lanes add their
// sums pairwise (chunks 2i and 2i + 1, then pairs of pairs): the order
// space_backward_prepass_reference writes out.
template <typename TI>
__global__ void __launch_bounds__(256)
space_bwd_prep_kernel(const TI* __restrict__ g, const TI* __restrict__ out,
                      bf16* __restrict__ gs, float* __restrict__ dsum,
                      int rows, int N, int H, int dh) {
  const int cw = dh / 8, per_row = H * cw;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  // every lane runs the shuffles; a head's lanes are all in or all out
  const bool in = i < (long)rows * per_row;
  const long r = in ? i / per_row : 0;
  const int j = in ? (int)(i - r * per_row) : 0;
  const int h = j / cw, c = j % cw;
  float d = 0.f;
  if (in) {
    const long off = r * H * dh + h * dh + 8 * c;
    Chunk8<TI> gc, oc;
    gc.load(g + off);
    oc.load(out + off);
    float x[8], y[8];
    gc.to_float(x);
    oc.to_float(y);
#pragma unroll
    for (int e = 0; e < 8; ++e) d = __fadd_rn(d, __fmul_rn(x[e], y[e]));
    *reinterpret_cast<uint4*>(gs + off) = pack8_bf16(x);
  }
  for (int m = 1; m < cw; m <<= 1)
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, m));
  if (in && c == 0) dsum[(r / N * H + h) * N + r % N] = d;
}

// The pre-pass: the scratch [BF, N, 3·H·dh] (q~, k~, v in bf16; the
// forward's space_rotate_kernel), gs [BF, N, H·dh] and dsum [BF, H, N] from
// qkv, the forward's output and its cotangent g (TI: bf16 or float32); heads
// of 32 to 128 dims. Two launches; returns the first error.
template <typename TI>
int launch_space_backward_prepass(const void* qkv, const void* rot,
                                  const void* out, const void* g,
                                  void* scratch, void* gs, void* dsum, int BF,
                                  int N, int H, int dh, float scale,
                                  cudaStream_t stream) {
  if (dh < 32 || dh > 128 || 128 % dh || N < 1 || BF < 1 || H < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_space_rotate<TI>(
      static_cast<const TI*>(qkv), static_cast<const float*>(rot),
      static_cast<bf16*>(scratch), BF, N, H, dh, true, scale, stream);
  if (err != cudaSuccess) return err;
  const long chunks = (long)BF * N * H * (dh / 8);
  space_bwd_prep_kernel<TI><<<(unsigned)((chunks + 255) / 256), 256, 0,
                              stream>>>(
      static_cast<const TI*>(g), static_cast<const TI*>(out),
      static_cast<bf16*>(gs), static_cast<float*>(dsum), BF * N, N, H, dh);
  return cudaGetLastError();
}

// A block of either kernel: two consumer warpgroups, each owning 64 rows
// (queries for dq, keys for dk and dv) of one (frame, head), and a producer
// warpgroup that streams tiles of KN rows of the other operands. Per
// head-dim class DH (64, and 32 padded; 128), in bytes:
// a resident operand's 64 rows of one warpgroup (`operand`: DH / 64 panels
// of 64 rows x 128 bytes, 128-byte swizzled, wgmma_wide.cuh's layout), a
// streamed tile (`tile`: KN rows, the same panels), the ring of kSbSlots
// slots of two tiles each, the dk/dv kernel's row statistics of each
// slot's queries, then the barriers.
constexpr int kSbRows = 64;
constexpr int kSbSlots = 4;

template <int DH>
struct SpaceBwdTile {
  static_assert(DH == 64 || DH == 128, "head-dim classes");
  // 128-row tiles (m64n128 scores) where the registers hold them; at 128
  // dims dk and dv alone take 128 registers a thread
  static constexpr int KN = DH == 64 ? 128 : 64;
  static constexpr int operand = DH / 64 * kSbRows * 128;
  static constexpr int tile = DH / 64 * KN * 128;
  static constexpr int own = 2 * 2 * operand;     // two operands, two groups
  static constexpr int slot = 2 * tile;           // two streamed tiles
  static constexpr int stats = KN * 8;            // (lse, D) of a tile's rows
  static constexpr int smem =
      1024 + own + kSbSlots * (slot + stats) + (2 * kSbSlots + 1) * 8;
  static_assert(smem <= kWgSmemLimit, "the block's shared memory");
};

struct SpaceBwdArgs {
  const bf16* x;      // the scratch [BF, N, 3·H·dh]: q~ | k~ | v
  const bf16* gs;     // [BF, N, H·dh]
  const float* dsum;  // [BF, H, N]
  const float* rot;   // [N, dh/2, 2]: (cos, sin) of each rotated pair
  void* dqkv;         // [BF, N, 3·H·dh] of the kernel's TO
  float* stats;       // [BF, H, N, 2]: (log2-sum-exp of log2e·S, D)
  int N, H, dh;
  float scale;
};

// 128 rows (row stride ld) of one operand into the resident area at `dst`,
// rows 64 w .. of warpgroup w at dst + w·operand; chunks past `real` of a
// row as zeros. By every thread of the block; the caller waits for the
// copies.
template <int DH>
__device__ __forceinline__ void sb_copy_own(uint32_t dst, const bf16* src,
                                            long ld, int real) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < 2 * kSbRows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool valid = c < real;
    cp_async16_or_zeros(dst + (r / kSbRows) * SpaceBwdTile<DH>::operand +
                            paneled(r % kSbRows, c, kSbRows),
                        src + (valid ? r * ld + c * 8 : 0), valid);
  }
}

// acc = A·Bᵀ over STEPS k16 steps (the head's dims rounded up to 16): A a
// warpgroup's 64 rows at `a`, B a tile's KN rows at `b`, both K-major in
// shared memory; started, in the caller's commit group.
template <int STEPS, int KN>
__device__ __forceinline__ void sb_ss(float (&acc)[KN / 2], uint32_t a,
                                      uint32_t b) {
#pragma unroll
  for (int st = 0; st < STEPS; ++st)
    wgmma_ss<KN>(acc,
                 wgmma_desc(a + (st / 4) * kSbRows * 128 + (st % 4) * 32),
                 wgmma_desc(b + (st / 4) * KN * 128 + (st % 4) * 32),
                 st > 0);
}

// acc += A·B: A the KN columns of a bf16 accumulator re-packed as register
// fragments, B a tile (KN rows of DH) as the MN-major operand; started, in
// the caller's commit group.
template <int DH, int KN>
__device__ __forceinline__ void sb_rs(float (&acc)[DH / 2],
                                      const uint32_t (&a)[KN / 16][4],
                                      uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk)
    wgmma_rs_bt<DH>(acc, a[kk], wgmma_desc_lbo(b + kk * 16 * 128, KN * 128));
}

// A consumer's accumulator rows row0 and row0 + 8 (rows g and g + 8 of its
// warp's 16) into dst (row stride ld): columns below dh, times `mul`, through
// rotᵀ with the pair table (ROT), rounded as the plain backward rounds it.
template <bool ROT, typename TO, int DH>
__device__ __forceinline__ void sb_store(TO* dst, long ld, const float* tab,
                                         const float (&acc)[DH / 2],
                                         float mul, int row0, int t, int dh) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (col >= dh) continue;
      float y0 = acc[4 * nd + 2 * r] * mul, y1 = acc[4 * nd + 2 * r + 1] * mul;
      if (ROT) {
        const float2 cs =
            *reinterpret_cast<const float2*>(tab + (long)row * dh + col);
        rotate_pair_t_rn(y0, y1, cs.x, cs.y, cs.x, cs.y);
      }
      store2(dst + row * ld + col, y0, y1);
    }
  }
}

// What both kernels share: the barriers (a slot's `full`, then its
// `empty`, then the resident operands'), the block's 128 rows of its two
// resident operands (x, y) copied in by every thread, which the consumers
// wait for (`resident_ready`) while the producer goes on to stream, and the
// consumers' side of the ring.
template <int DH>
struct SbBlock {
  using S = SpaceBwdTile<DH>;
  uint32_t base, own, ring, stats_ring, bars;
  int lane;

  __device__ __forceinline__ SbBlock(unsigned char* smem) {
    const uint32_t raw = smem_u32(smem);
    base = (raw + 1023u) & ~1023u;
    own = base;
    ring = base + S::own;
    stats_ring = ring + kSbSlots * S::slot;
    bars = stats_ring + kSbSlots * S::stats;
    lane = threadIdx.x & 31;
  }
  __device__ __forceinline__ void setup(const bf16* x, long ldx,
                                        const bf16* y, long ldy, int real) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kSbSlots; ++i) {
        mbar_init(full(i), 128);    // producer threads
        mbar_init(empty(i), 2 * 4); // consumer warps
      }
      mbar_init(resident_bar(), blockDim.x);
      mbar_init_fence();
    }
    __syncthreads();
    sb_copy_own<DH>(own, x, ldx, real);
    sb_copy_own<DH>(own + 2 * S::operand, y, ldy, real);
    cp_async_arrive(resident_bar());
  }
  __device__ __forceinline__ uint32_t resident_bar() const {
    return bars + 8 * 2 * kSbSlots;
  }
  // a consumer: every thread's resident copies have landed
  __device__ __forceinline__ void resident_ready() const {
    mbar_wait(resident_bar(), 0);
    fence_proxy_async();
  }
  __device__ __forceinline__ uint32_t full(int j) const {
    return bars + 8 * (j % kSbSlots);
  }
  __device__ __forceinline__ uint32_t empty(int j) const {
    return bars + 8 * (kSbSlots + j % kSbSlots);
  }
  __device__ __forceinline__ uint32_t slot(int j) const {
    return ring + (j % kSbSlots) * S::slot;
  }
  // resident operand o (0: x, 1: y) of warpgroup wg
  __device__ __forceinline__ uint32_t resident(int o, int wg) const {
    return own + (2 * o + wg) * S::operand;
  }
  // the producer: slot of tile j free again
  __device__ __forceinline__ void claim(int j) const {
    mbar_wait(empty(j), ((j / kSbSlots) & 1) ^ 1);
  }
  // a consumer: tile j has landed (then visible to wgmma), and handed back
  __device__ __forceinline__ void arrived(int j) const {
    mbar_wait(full(j), (j / kSbSlots) & 1);
    fence_proxy_async();
  }
  __device__ __forceinline__ void release(int j) const {
    if (lane == 0) mbar_arrive(empty(j));
  }
};

// The dq kernel: grid (N / 128, H, BF), block 384, dynamic shared memory
// SpaceBwdTile<DH>::smem. Resident: q~ and g of the block's 128 query rows.
// The producer streams the key tiles twice: k~ alone (sweep 1: each row's
// max and ex2 sum of log2e·S; the row's (lse, D) to stats), then k~ and v
// (sweep 2: S and dP = g·vᵀ, P, dS = P ∘ (dP − D), dq += dS·k~ with dS
// rounded to bf16 as the register operand and k~ as the MN-major one).
// dq leaves through rotᵀ, times the scale, into dqkv's q third.
template <int DH, int STEPS, typename TO>
__global__ void __launch_bounds__(384, 1)
space_bwd_dq_kernel(const SpaceBwdArgs a) {
  using S = SpaceBwdTile<DH>;
  constexpr int KN = S::KN;
  extern __shared__ unsigned char sb_smem[];
  SbBlock<DH> blk(sb_smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int h = blockIdx.y, bf = blockIdx.z, q0 = blockIdx.x * 2 * kSbRows;
  const int N = a.N, H = a.H, dh = a.dh, real = dh / 8;
  const long ld = 3L * H * dh, ldg = (long)H * dh;
  const bf16* qb = a.x + (long)bf * N * ld + h * dh;
  const bf16* kb = qb + (long)H * dh;
  const bf16* vb = qb + 2L * H * dh;
  const bf16* gb = a.gs + (long)bf * N * ldg + h * dh;
  const int nkt = N / KN;
  blk.setup(qb + (long)q0 * ld, ld, gb + (long)q0 * ldg, ldg, real);

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = tid - 256;
    for (int j = 0; j < 2 * nkt; ++j) {
      blk.claim(j);
      const long k0 = (long)(j < nkt ? j : j - nkt) * KN;
      copy_panels<KN, DH / 8>(blk.slot(j), kb + k0 * ld, ld, KN, real,
                              DH / 8, pt);
      if (j >= nkt)
        copy_panels<KN, DH / 8>(blk.slot(j) + S::tile, vb + k0 * ld, ld, KN,
                                real, DH / 8, pt);
      cp_async_arrive(blk.full(j));
    }
    cp_async_wait_all();
    return;
  }

  // ------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t qa = blk.resident(0, wg), ga = blk.resident(1, wg);
  const int row0 = q0 + wg * kSbRows + warp * 16 + g;   // and row0 + 8
  const float* dsum = a.dsum + ((long)bf * H + h) * N;
  const float D[2] = {dsum[row0], dsum[row0 + 8]};
  blk.resident_ready();

  // sweep 1: each lane's max and ex2 sum over its columns
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[KN / 2], dp[KN / 2];
  for (int j = 0; j < nkt; ++j) {
    blk.arrived(j);
    wgmma_fence();
    sb_ss<STEPS, KN>(s, qa, blk.slot(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    blk.release(j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]) *
                           kLog2e);
      float sum = l[r] * exp2_approx(m[r] - mx);
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt)
        sum += exp2_approx(s[4 * nt + 2 * r] * kLog2e - mx) +
               exp2_approx(s[4 * nt + 2 * r + 1] * kLog2e - mx);
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
  if (t == 0) {
    float* st = a.stats + (((long)bf * H + h) * N + row0) * 2;
    *reinterpret_cast<float2*>(st) = make_float2(lse[0], D[0]);
    *reinterpret_cast<float2*>(st + 16) = make_float2(lse[1], D[1]);
  }

  // sweep 2: P, dP, dS and dq += dS·k~, one tile at a time
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
  uint32_t da[KN / 16][4];
  for (int j = nkt; j < 2 * nkt; ++j) {
    blk.arrived(j);
    wgmma_fence();
    sb_ss<STEPS, KN>(s, qa, blk.slot(j));
    sb_ss<STEPS, KN>(dp, ga, blk.slot(j) + S::tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {   // s becomes dS
      const int r = (i >> 1) & 1;
      const float p = exp2_approx(s[i] * kLog2e - lse[r]);
      s[i] = p * (dp[i] - D[r]);
    }
    wide_pack<KN>(s, da);
    fence_regs(dq);
    wgmma_fence();
    sb_rs<DH, KN>(dq, da, blk.slot(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    blk.release(j);
  }
  sb_store<true, TO, DH>(static_cast<TO*>(a.dqkv) + (long)bf * N * 3 * H * dh +
                             h * dh,
                         3L * H * dh, a.rot, dq, a.scale, row0, t, dh);
}

// The dk/dv kernel (after the dq kernel: its stats), grid (N / 128, H, BF),
// block 384. Resident: k~ and v of the block's 128 keys. The producer
// streams q~ and g tiles with their rows' (lse, D): Sᵀ = k~·q~ᵀ and dPᵀ =
// v·gᵀ, Pᵀ and dSᵀ re-packed as the register operands of dv += Pᵀ·g and
// dk += dSᵀ·q~. dk leaves through rotᵀ, dv as it is, into dqkv's k and v
// thirds.
template <int DH, int STEPS, typename TO>
__global__ void __launch_bounds__(384, 1)
space_bwd_dkdv_kernel(const SpaceBwdArgs a) {
  using S = SpaceBwdTile<DH>;
  constexpr int KN = S::KN;
  extern __shared__ unsigned char sb_smem[];
  SbBlock<DH> blk(sb_smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int h = blockIdx.y, bf = blockIdx.z, k0 = blockIdx.x * 2 * kSbRows;
  const int N = a.N, H = a.H, dh = a.dh, real = dh / 8;
  const long ld = 3L * H * dh, ldg = (long)H * dh;
  const bf16* qb = a.x + (long)bf * N * ld + h * dh;
  const bf16* kb = qb + (long)H * dh;
  const bf16* vb = qb + 2L * H * dh;
  const bf16* gb = a.gs + (long)bf * N * ldg + h * dh;
  const float* stats = a.stats + ((long)bf * H + h) * N * 2;
  const int nqt = N / KN;
  blk.setup(kb + (long)k0 * ld, ld, vb + (long)k0 * ld, ld, real);

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = tid - 256;
    for (int j = 0; j < nqt; ++j) {
      blk.claim(j);
      const long i0 = (long)j * KN;
      copy_panels<KN, DH / 8>(blk.slot(j), qb + i0 * ld, ld, KN, real,
                              DH / 8, pt);
      copy_panels<KN, DH / 8>(blk.slot(j) + S::tile, gb + i0 * ldg, ldg, KN,
                              real, DH / 8, pt);
      if (pt < KN / 2)   // 16 bytes: the (lse, D) of two rows
        cp_async16(blk.stats_ring + (j % kSbSlots) * S::stats + pt * 16,
                   stats + (i0 + 2 * pt) * 2);
      cp_async_arrive(blk.full(j));
    }
    cp_async_wait_all();
    return;
  }

  // ------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ka = blk.resident(0, wg), va = blk.resident(1, wg);
  const int row0 = k0 + wg * kSbRows + warp * 16 + g;   // and row0 + 8
  const unsigned char* sm = sb_smem + (blk.base - smem_u32(sb_smem));
  blk.resident_ready();
  float s[KN / 2], dp[KN / 2];
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[KN / 16][4], da[KN / 16][4];
  for (int j = 0; j < nqt; ++j) {
    blk.arrived(j);
    wgmma_fence();
    sb_ss<STEPS, KN>(s, ka, blk.slot(j));    // Sᵀ: keys x the tile's queries
    sb_ss<STEPS, KN>(dp, va, blk.slot(j) + S::tile);   // dPᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const float2* st = reinterpret_cast<const float2*>(
        sm + (blk.stats_ring - blk.base) + (j % kSbSlots) * S::stats);
#pragma unroll
    for (int nt = 0; nt < KN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 q = st[nt * 8 + 2 * t + c];   // this column's query
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // s becomes Pᵀ and dp dSᵀ
          const int i = 4 * nt + 2 * r + c;
          const float p = exp2_approx(s[i] * kLog2e - q.x);
          s[i] = p;
          dp[i] = p * (dp[i] - q.y);
        }
      }
    wide_pack<KN>(s, pa);
    wide_pack<KN>(dp, da);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    sb_rs<DH, KN>(dv, pa, blk.slot(j) + S::tile);
    sb_rs<DH, KN>(dk, da, blk.slot(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    blk.release(j);
  }
  TO* dst = static_cast<TO*>(a.dqkv) + (long)bf * N * 3 * H * dh + h * dh;
  sb_store<true, TO, DH>(dst + H * dh, 3L * H * dh, a.rot, dk, 1.f, row0, t,
                         dh);
  sb_store<false, TO, DH>(dst + 2 * H * dh, 3L * H * dh, nullptr, dv, 1.f,
                          row0, t, dh);
}

// One of the two kernels (DKDV: the dk/dv kernel) at the head-dim class DH
// and STEPS k16 steps of the scores, on the pre-pass's scratch, into dqkv
// [BF, N, 3·H·dh] of type TO; stats a float32 scratch [BF, H, N, 2];
// N % 128 == 0.
template <int DH, int STEPS, typename TO, bool DKDV>
int launch_space_backward_sweep(const void* scratch, const void* gs,
                                const void* dsum, const void* rot,
                                void* dqkv, void* stats, int BF, int N,
                                int H, int dh, float scale,
                                cudaStream_t stream) {
  if (N < 2 * kSbRows || N % (2 * kSbRows) || N % SpaceBwdTile<DH>::KN ||
      BF < 1 || H < 1 || dh > DH || (dh + 15) / 16 != STEPS)
    return cudaErrorInvalidValue;
  const SpaceBwdArgs a{static_cast<const bf16*>(scratch),
                       static_cast<const bf16*>(gs),
                       static_cast<const float*>(dsum),
                       static_cast<const float*>(rot),
                       dqkv,
                       static_cast<float*>(stats),
                       N, H, dh, scale};
  void (*kern)(const SpaceBwdArgs) = space_bwd_dq_kernel<DH, STEPS, TO>;
  if constexpr (DKDV) kern = space_bwd_dkdv_kernel<DH, STEPS, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SpaceBwdTile<DH>::smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N / (2 * kSbRows), H, BF), 384, SpaceBwdTile<DH>::smem,
         stream>>>(a);
  return cudaGetLastError();
}

// The same at the head dims beyond the configurations' 64 that this design
// runs (divided_backward_classes{,_f32}.cu): 32 on the class 64 (padded:
// its two k16 steps of the scores) and 128 on its own.
template <typename TO, bool DKDV>
int launch_space_backward_classes(const void* scratch, const void* gs,
                                  const void* dsum, const void* rot,
                                  void* dqkv, void* stats, int BF, int N,
                                  int H, int dh, float scale,
                                  cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_space_backward_sweep<64, 2, TO, DKDV>(
          scratch, gs, dsum, rot, dqkv, stats, BF, N, H, dh, scale, stream);
    case 128:
      return launch_space_backward_sweep<128, 8, TO, DKDV>(
          scratch, gs, dsum, rot, dqkv, stats, BF, N, H, dh, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ space, narrow
// Heads of 2 to 16 dims keep the earlier design on mma.sync, the class 16
// (tools/ab_space_backward.py pairs it with the wgmma design above, which
// ran 1.5–1.7 times slower there: its dq, dk and dv products padded to 64
// columns, four times the work of a 16-dim head): a dq kernel and a dk/dv
// kernel of eight warps, each owning 128 rows and walking the other
// operand in 128-row tiles that pass through registers (read in qkv's type,
// rotated and scaled in fp32, rounded once, 16-byte shared stores), the
// next tile's loads in flight while the block computes on the one before.
// ldmatrix fragments from padded tiles (a 48-byte row stride); a head
// narrower than 16 dims has its columns past dh read as zeros and never
// stored.
//
// A block's shape: its warps (16 rows each), the rows it owns, the rows of
// the walked operand per tile, and the padded shared row stride (bf16).
template <int DH>
struct SpaceBwd {
  static_assert(DH == 16, "the class of heads of 2 to 16 dims");
  static constexpr int warps = 8;
  static constexpr int rows = 16 * warps;
  static constexpr int tile = 128;
  static constexpr int RS = DH + 8;
  // two bf16 tiles of max(rows, tile) rows: first the block's own rows (two
  // operands), then the walked operands' tiles
  static constexpr int buf = (rows > tile ? rows : tile) * RS;
};

// ROWS rows of one head (row stride `ld` elements of T) into a padded bf16
// tile, by the whole block, in two steps so that a tile's loads are in
// flight while the block computes on the one before: load() brings the
// thread's chunks into registers; store() rotates them by the pair table
// rows at `tab` ([rows, dh/2] (cos, sin), the forward's rotary_pair_table;
// small and L2-resident, read here rather than held) when ROT, multiplies
// by `mul`, in fp32, and writes them rounded once: a head of dh <= DH
// dims, its chunks past dh read as zeros (its table entries not read), the
// rotation rounded as the plain rotary rounds it.
//
// SPLIT (heads of 2 and 4 dims, whose scores would otherwise sum two or
// four bf16-rounded products and miss the plain backward's limits): x is
// written as its bf16 rounding hi and the bf16 rounding lo of x - hi, in
// the 16 columns of the class, hi | lo | hi for q~ (kSplitQ) and hi | hi |
// lo for k~ (kSplitK), so that one k16 product sums q_hi·k_hi + q_lo·k_hi
// + q_hi·k_lo: the scores to some 16 bits more. The columns past dh are
// never stored, so dq = dS·k~ and dk = dSᵀ·q~ still take hi alone.
constexpr int kSplitQ = 1, kSplitK = 2;

template <bool ROT, int ROWS, typename T, int DH>
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
      load_chunk(raw[u], src + (i / CH) * ld + (i % CH) * 8,
                 dh - (i % CH) * 8);
    }
  }

  __device__ __forceinline__ void store(bf16* dst, const float* tab, int dh,
                                        float mul, int split = 0) const {
    // (a head of at most 4 dims lies in chunk 0, whose thread writes both
    // chunks of its row)
    const bool two = split && dh <= 4;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + THREADS * u, r = i / CH, c = i % CH;
      if (two && c) continue;
      float x[8];
      raw[u].to_float(x);
      if (ROT && c * 8 < dh) {
        const float* tr = tab + r * dh + c * 8;   // (cos, sin) of 4 pairs
        float cs[4], sn[4];
        if (c * 8 + 8 <= dh) {
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
        for (int q = 0; q < 4; ++q)
          rotate_pair_rn(x[2 * q], x[2 * q + 1], cs[q], sn[q], cs[q], sn[q]);
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

template <bool ROT, int ROWS, typename T, int DH>
__device__ __forceinline__ void stage_tile(bf16* dst, const T* src, long ld,
                                           const float* tab, int dh,
                                           float mul, int split = 0) {
  TileLoad<ROT, ROWS, T, DH> t;
  t.load(src, ld, dh);
  t.store(dst, tab, dh, mul, split);
}

// An accumulator tile row pair (row g and g + 8 of 16 rows, DH columns)
// through rotᵀ with the pair table rows at `tab` (ROT) and into `dst` (row
// stride ld), times `mul`; columns past dh are not stored, and rotᵀ is
// rounded as the plain backward rounds it.
template <bool ROT, typename T, int DH>
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
      if (col >= dh) continue;
      float y0 = acc[nt][2 * r] * mul, y1 = acc[nt][2 * r + 1] * mul;
      if (ROT) {
        const float2 cs = *reinterpret_cast<const float2*>(
            tab + row * dh + col);   // (cos, sin) of the pair
        rotate_pair_t_rn(y0, y1, cs.x, cs.y, cs.x, cs.y);
      }
      store2(dst + row * ld + col, y0, y1);
    }
  }
}

template <typename T>
struct SpaceClassArgs {
  const T* qkv;      // [BF, N, 3·H·dh]
  const float* rot;  // [N, dh/2, 2]
  const T* out;      // [BF, N, H·dh]
  const T* g;        // [BF, N, H·dh]
  T* dqkv;           // [BF, N, 3·H·dh]
  float* stats;      // [BF, H, N, 2]: log2-sum-exp of the scaled scores, D
  int N, H;
  float scale;
  int dh;            // the head dim, up to its class DH
};

// grid (N / rows, H, BF), block 32·warps (SpaceBwd<DH>).
template <typename T, int DH>
__global__ void __launch_bounds__(32 * SpaceBwd<DH>::warps)
space_class_dq_kernel(const SpaceClassArgs<T> a) {
  using Sh = SpaceBwd<DH>;
  constexpr int RS = Sh::RS, ROWS = Sh::rows, TILE = Sh::tile, KS = DH / 16;
  __shared__ __align__(16) bf16 buf[2 * Sh::buf];
  __shared__ float d_s[ROWS];
  bf16* const x_s = buf;            // q~, then k~ tiles
  bf16* const y_s = buf + Sh::buf;  // g, then v tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int h = blockIdx.y, bf = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int dh = a.dh;
  const int N = a.N, HD = a.H * dh;
  const long ld = 3L * HD;
  const T* qb = a.qkv + (long)bf * N * ld + h * dh;
  const T* kb = qb + HD;
  const T* vb = qb + 2 * HD;
  const long io = (long)bf * N * HD + h * dh;   // out, g: row stride HD

  stage_tile<true, ROWS, T, DH>(x_s, qb + q0 * ld, ld, a.rot + q0 * dh,
                                     dh, a.scale, kSplitQ);
  stage_tile<false, ROWS, T, DH>(y_s, a.g + io + (long)q0 * HD, HD,
                                      nullptr, dh, 1.f);
  {  // D = rowsum(g ∘ out) in fp32: two lanes a row, DH / 2 columns each
    const int row = warp * 16 + (lane >> 1), c0 = (lane & 1) * (DH / 2);
    const long off = io + (long)(q0 + row) * HD + c0;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 2; c += 8) {
      Chunk8<T> gc, oc;
      load_chunk(gc, a.g + off + c, dh - c0 - c);
      load_chunk(oc, a.out + off + c, dh - c0 - c);
      float x[8], y[8];
      gc.to_float(x);
      oc.to_float(y);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += x[e] * y[e];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (!(lane & 1)) d_s[row] = d;
  }
  TileLoad<true, TILE, T, DH> kl;   // the next k~ tile, in flight
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
  TileLoad<false, TILE, T, DH> vl;
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
  store_rows<true, T, DH>(
      a.dqkv + (long)bf * N * ld + h * dh + (q0 + warp * 16) * ld, ld,
      a.rot + (q0 + warp * 16) * dh, dq, a.scale, lane, dh);
}

// grid (N / rows, H, BF), block 32·warps; after space_class_dq_kernel
// (its stats).
template <typename T, int DH>
__global__ void __launch_bounds__(32 * SpaceBwd<DH>::warps)
space_class_dkdv_kernel(const SpaceClassArgs<T> a) {
  using Sh = SpaceBwd<DH>;
  constexpr int RS = Sh::RS, ROWS = Sh::rows, TILE = Sh::tile, KS = DH / 16;
  __shared__ __align__(16) bf16 buf[2 * Sh::buf];
  __shared__ float2 st_s[TILE];     // (lse, D) of the tile's queries
  bf16* const x_s = buf;            // k~, then q~ tiles
  bf16* const y_s = buf + Sh::buf;  // v, then g tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int h = blockIdx.y, bf = blockIdx.z, k0 = blockIdx.x * ROWS;
  const int dh = a.dh;
  const int N = a.N, HD = a.H * dh;
  const long ld = 3L * HD;
  const T* qb = a.qkv + (long)bf * N * ld + h * dh;
  const T* gb = a.g + (long)bf * N * HD + h * dh;
  const float2* stats =
      reinterpret_cast<const float2*>(a.stats) + (long)(bf * a.H + h) * N;
  const uint32_t xt = smem_u32(x_s), yt = smem_u32(y_s);

  // this warp's 16 keys: k~ and v as A fragments
  stage_tile<true, ROWS, T, DH>(x_s, qb + HD + k0 * ld, ld,
                                     a.rot + k0 * dh, dh, 1.f, kSplitK);
  stage_tile<false, ROWS, T, DH>(y_s, qb + 2 * HD + k0 * ld, ld,
                                      nullptr, dh, 1.f);
  TileLoad<true, TILE, T, DH> ql;    // the next q~ and g tiles, in flight
  TileLoad<false, TILE, T, DH> gl;
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
  store_rows<true, T, DH>(dst + HD, ld, a.rot + kr * dh, dk, 1.f, lane,
                               dh);
  store_rows<false, T, DH>(dst + 2 * HD, ld, nullptr, dv, 1.f, lane, dh);
}

// dqkv [BF, N, 3·H·dh] of element type T from qkv, out and g; stats is a
// float32 scratch [BF, H, N, 2]. Heads of 2 to 16 dims (dh dividing 128),
// N a multiple of 128 (divided_backward_classes{,_f32}.cu).
template <typename T>
int launch_space_backward_narrow(const void* qkv, const void* rot,
                                 const void* out, const void* g, void* dqkv,
                                 void* stats, int BF, int N, int H, int dh,
                                 float scale, cudaStream_t stream) {
  if (dh < 2 || 128 % dh) return cudaErrorInvalidValue;
  switch (dh <= 16 ? 16 : dh) {
    case 16: {
      using Sh = SpaceBwd<16>;
      if (N <= 0 || N % Sh::rows || N % Sh::tile)
        return cudaErrorInvalidValue;
      const SpaceClassArgs<T> a{
          static_cast<const T*>(qkv), static_cast<const float*>(rot),
          static_cast<const T*>(out), static_cast<const T*>(g),
          static_cast<T*>(dqkv),      static_cast<float*>(stats),
          N, H, scale, dh};
      const dim3 grid(N / Sh::rows, H, BF);
      space_class_dq_kernel<T, 16><<<grid, 32 * Sh::warps, 0, stream>>>(a);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      space_class_dkdv_kernel<T, 16><<<grid, 32 * Sh::warps, 0, stream>>>(a);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ space, resident
// Heads of 2 to 16 dims at N <= 1024 where the plan table names it
// (divided_attention.SPACE_BACKWARD_NARROW_PLANS): one block of 16 warps
// owns a whole (frame, head). The class above works S out three times per
// score (row statistics, dq, dk and dv: three ex2), and each of its N / 128
// blocks of a (frame, head) reads, rotates and rounds the whole walked
// operand again. Here:
//
//  * q~, k~, v and g are read once, rotated, scaled and rounded as the
//    class rounds them (the SPLIT scores at heads of 2 and 4), and kept
//    resident in bf16, [N][16] each (128 KB at N = 1024), rows of 32 bytes
//    whose two chunks swap on rows 4-7 of every 8, so ldmatrix's eight rows
//    fall on 32 distinct banks; D = rowsum(g ∘ out) beside them.
//  * sweep 1: the row statistics, each warp over its query tiles and every
//    key: the class's dq kernel's sweep, so each row's log2-sum-exp is the
//    class's bit for bit.
//  * sweep 2 works S, P, dP and dS out once per (query tile, key tile) and
//    feeds dq and dk, dv from them: two ex2 per score where the class takes
//    three. A warp owns two 16-key tiles a pass (512 keys a pass, two passes
//    at N = 1024), k~ and v as register A fragments, dk and dv in its
//    registers over every query tile in order (the class's order: dk and dv
//    are the class's where its P and dS are); the same dSᵀ fragment,
//    transposed in registers (movmatrix), is the A operand of dq = dS·k~.
//    Each query tile's dq is summed across the warps through shared memory
//    in one fixed order (warps 0-3, 4-7, 8-11 and 12-15 each in turn, then
//    the four sums pairwise), every warp summing one row while it computes
//    the next tile, one barrier a query tile (two buffers of partials, the
//    second over the key rows the first pass already holds in registers);
//    past one pass the sums wait in shared memory for the next. No float
//    atomics: two calls agree bit for bit.
//
// Bound by the SM's issue and its shared-memory and special-function
// pipes, not by bytes: at qkv [1, 16, 1024, 1536] in heads of 16 a block
// took about 59 k cycles to load its operands, 77 k for sweep 1 (its `ex2`
// floor 65.5 k) and 200 k for sweep 2, whose loop issues about 240
// instructions a warp a query tile (H100, tools/ab_space_backward.py
// --clock). A block of 8 warps owning 4 key tiles each read about the
// same.
constexpr int kSbrWarps = 16;
constexpr int kSbrKT = 2;                          // key tiles a warp holds
constexpr int kSbrPassTiles = kSbrWarps * kSbrKT;  // 32 tiles: 512 keys
constexpr int kSbrMaxN = 1024;

// The block's shared memory at N tokens: the four operands [N][16] bf16,
// (lse, D) [N] float2, the warps' dq partials [16][16][16] fp32 (two
// buffers; past one pass the second over k~'s first rows) and, past one
// pass, the dq sums [N][16] fp32.
__host__ __device__ constexpr int sbr_passes(int N) {
  return (N / 16 + kSbrPassTiles - 1) / kSbrPassTiles;
}
__host__ __device__ constexpr int sbr_smem(int N) {
  return 4 * N * 32 + N * 8 + kSbrWarps * 1024 +
         (sbr_passes(N) > 1 ? N * 64 : kSbrWarps * 1024);
}
static_assert(sbr_smem(kSbrMaxN) <= 232448, "the block's shared memory");

// Row r's 16-byte chunk c of a [rows][16] bf16 tile: the chunks of rows 4-7
// of every 8 swapped.
__device__ __forceinline__ uint32_t sbr_at(uint32_t tile, int r, int c) {
  return tile + r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

// A fragment (16 x 16) of rows m0.. of a tile stored [m][k].
__device__ __forceinline__ void sbr_frag_a(uint32_t (&a)[4], uint32_t tile,
                                           int m0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, sbr_at(tile, m0 + r + (i & 1) * 8, i >> 1));
}

// B fragments of rows k0.. of a tile stored [k][n]: its 16 columns as two
// n8 tiles.
__device__ __forceinline__ void sbr_frag_b_t(uint32_t (&b)[4], uint32_t tile,
                                             int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, sbr_at(tile, k0 + r + (i & 1) * 8, i >> 1));
}

// The (cos, sin) of the four rotated pairs of chunk c of row r from the
// pair table: TileLoad::store's reads (a head of 2 or 4 dims its pairs one
// by one, zeros past dh).
__device__ __forceinline__ void sbr_pairs(const float* tab, int r, int c,
                                          int dh, float (&cs)[4],
                                          float (&sn)[4]) {
  const float* tr = tab + r * dh + c * 8;
  if (c * 8 + 8 <= dh) {
    const float4 t0 = reinterpret_cast<const float4*>(tr)[0];
    const float4 t1 = reinterpret_cast<const float4*>(tr)[1];
    cs[0] = t0.x; cs[1] = t0.z; cs[2] = t1.x; cs[3] = t1.z;
    sn[0] = t0.y; sn[1] = t0.w; sn[2] = t1.y; sn[3] = t1.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in_head = c * 8 + 2 * q < dh;
      cs[q] = in_head ? tr[2 * q] : 0.f;
      sn[q] = in_head ? tr[2 * q + 1] : 0.f;
    }
  }
}

// Chunk c of row r, read as `in`, into a resident tile: TileLoad::store's
// arithmetic (rotated by its pairs' (cos, sin) when ROT, times mul, rounded
// once; SPLIT hi | lo columns at heads of 2 and 4, by chunk 0's thread).
template <bool ROT, typename T>
__device__ __forceinline__ void sbr_store(uint32_t tile, const Chunk8<T>& in,
                                          const float (&cs)[4],
                                          const float (&sn)[4], int r, int c,
                                          int dh, float mul, int split) {
  const bool two = split && dh <= 4;
  if (two && c) return;
  float x[8];
  in.to_float(x);
  if (ROT && c * 8 < dh) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rotate_pair_rn(x[2 * q], x[2 * q + 1], cs[q], sn[q], cs[q], sn[q]);
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
    st_shared16(sbr_at(tile, r, 0), pack8_bf16(y0));
    st_shared16(sbr_at(tile, r, 1), pack8_bf16(y1));
    return;
  }
  st_shared16(sbr_at(tile, r, c), pack8_bf16(x));
}

// grid (H, BF), block 32·kSbrWarps, sbr_smem(N) bytes of dynamic shared
// memory; 256 <= N <= kSbrMaxN, N % 128 == 0, heads of 2 to 16 dims (the
// class 16). a.stats is not read.
template <typename T>
__global__ void __launch_bounds__(32 * kSbrWarps, 1)
space_resident_bwd_kernel(const SpaceClassArgs<T> a) {
  constexpr int KT = kSbrKT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, NT = N / 16, dh = a.dh, HD = a.H * dh;
  const int passes = sbr_passes(N);
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t q_t = base, k_t = base + N * 32, v_t = base + 2 * N * 32,
                 g_t = base + 3 * N * 32;
  float2* const st_s = reinterpret_cast<float2*>(smem_raw + 4 * N * 32);
  float* const part0 = reinterpret_cast<float*>(smem_raw + 4 * N * 32 + N * 8);
  float* const part1 =
      passes > 1 ? reinterpret_cast<float*>(smem_raw + N * 32)
                 : part0 + kSbrWarps * 256;
  float2* const acc_s = reinterpret_cast<float2*>(part0 + kSbrWarps * 256);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, bf = blockIdx.y;
  const long ld = 3L * HD;
  const T* qb = a.qkv + (long)bf * N * ld + h * dh;
  // a lane's ldmatrix row in a group of 16 rows (512 bytes; the swizzle
  // repeats every 8 rows), hoisted out of the sweeps: off_b for B
  // fragments of a tile stored [n][k] (two n8 tiles of rows), off_at those
  // of sbr_frag_a and sbr_frag_b_t
  const uint32_t off_b = sbr_at(0, (lane & 7) + (lane >> 4) * 8,
                                (lane >> 3) & 1);
  const uint32_t off_at = sbr_at(0, (lane & 7) + ((lane >> 3) & 1) * 8,
                                 lane >> 4);
  const long io = (long)bf * N * HD + h * dh;   // out, g: row stride HD

  // q~ (rotated, scaled), k~ (rotated), v and g, resident; D = rowsum(g ∘
  // out) in fp32 beside them, two lanes a row (the class's order). Two rows
  // of chunks a thread at a time, all their loads (the pair table's too) in
  // flight together before the first shared store
  for (int i0 = threadIdx.x; i0 < 2 * N; i0 += 2 * 32 * kSbrWarps) {
    Chunk8<T> x[2][5];
    float cs[2][4], sn[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * 32 * kSbrWarps, r = i >> 1, c = i & 1;
      const bool in = i < 2 * N;
      const int part = in ? dh - c * 8 : 0;
#pragma unroll
      for (int m = 0; m < 3; ++m)
        load_chunk(x[u][m], qb + (long)r * ld + m * HD + c * 8, part);
      load_chunk(x[u][3], a.g + io + (long)r * HD + c * 8, part);
      load_chunk(x[u][4], a.out + io + (long)r * HD + c * 8, part);
      sbr_pairs(a.rot, in ? r : 0, c, part > 0 ? dh : 0, cs[u], sn[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * 32 * kSbrWarps, r = i >> 1, c = i & 1;
      if (i >= 2 * N) break;   // whole warps: 2N is a multiple of 256
      sbr_store<true>(q_t, x[u][0], cs[u], sn[u], r, c, dh, a.scale,
                      kSplitQ);
      sbr_store<true>(k_t, x[u][1], cs[u], sn[u], r, c, dh, 1.f, kSplitK);
      sbr_store<false>(v_t, x[u][2], cs[u], sn[u], r, c, dh, 1.f, 0);
      sbr_store<false>(g_t, x[u][3], cs[u], sn[u], r, c, dh, 1.f, 0);
      float gx[8], ox[8];
      x[u][3].to_float(gx);
      x[u][4].to_float(ox);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d += gx[e] * ox[e];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (!c) st_s[r].y = d;
    }
  }
  __syncthreads();

  // sweep 1: each row's log2-sum-exp of log2e·S, the warps' query tiles in
  // turn over every key (the class's dq kernel's sweep)
  for (int qt = warp; qt < NT; qt += kSbrWarps) {
    uint32_t qa[4];
    sbr_frag_a(qa, q_t, qt * 16, lane);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < N; k0 += 128) {
      float s[16][4] = {};
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, k_t + (k0 + np * 16) * 32 + off_b);
        mma_16816(s[2 * np], qa, b[0], b[1]);
        mma_16816(s[2 * np + 1], qa, b[2], b[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]) * kLog2e);
        float sum = l[r] * exp2_approx(m[r] - mx);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
          sum += exp2_approx(s[nt][2 * r] * kLog2e - mx) +
                 exp2_approx(s[nt][2 * r + 1] * kLog2e - mx);
        m[r] = mx;
        l[r] = sum;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // merge the quad's partial pairs
      float mx = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = l[r] * exp2_approx(m[r] - mx);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t == 0) st_s[qt * 16 + g + 8 * r].x = mx + __log2f(sum);
    }
  }
  __syncthreads();

  // sweep 2: per query tile, S, dP, P and dS once for each key tile a warp
  // owns; dv += Pᵀ·g and dk += dSᵀ·q~ in its registers, dq += dS·k~ into
  // its partial, the partials summed across the warps
  T* const dqb = a.dqkv + (long)bf * N * ld + h * dh;
  // a warp's partial of a query tile in its slot of a buffer ([16][16]
  // floats a warp): row r at position r ^ b (b = bit 2 of the warp: the
  // sums' two halves of a warp read two rows of one 128-byte line), the
  // column halves of positions 2-3 of every 4 swapped (the stores on
  // distinct banks). This lane's rows g and g + 8 start at wbase and
  // wbase + 128, its columns nt·8 + 2t at (nt·8) ^ wsw past them
  const int wpos = g ^ ((warp >> 2) & 1);
  const int wbase = warp * 256 + wpos * 16 + 2 * t;
  const int wsw = ((wpos >> 1) & 1) << 3;
  for (int pass = 0; pass < passes; ++pass) {
    uint32_t ka[KT][4], va[KT][4], kb[KT][4];
    // the key tiles this warp owns in the pass: the first `mine` of KT
    const int first = pass * kSbrPassTiles + warp;
    int mine = 0;
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (first + j * kSbrWarps < NT) mine = j + 1;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < mine) {
        const int kt = first + j * kSbrWarps;
        sbr_frag_a(ka[j], k_t, kt * 16, lane);
        sbr_frag_a(va[j], v_t, kt * 16, lane);
        sbr_frag_b_t(kb[j], k_t, kt * 16, lane);
      }
    }
    // the first pass's keys in registers: past one pass their rows of k~
    // take the second buffer of partials
    if (pass == 0) __syncthreads();
    float dk[KT][2][4] = {}, dv[KT][2][4] = {};
    const float2* const st_t = st_s + 2 * t;
    // one query tile over the warp's KA key tiles, with no branch between
    // them (a count the whole warp shares)
    auto tile = [&](auto ka_count, int qt, float (&dq)[2][4]) {
      constexpr int KA = decltype(ka_count)::value;
      uint32_t qfb[4], gfb[4], qft[4], gft[4];
      const uint32_t row = qt * 16 * 32;
      ldmatrix_x4(qfb, q_t + row + off_b);          // q~ᵀ for Sᵀ = k~·q~ᵀ
      ldmatrix_x4(gfb, g_t + row + off_b);          // gᵀ for dPᵀ = v·gᵀ
      ldmatrix_x4_trans(qft, q_t + row + off_at);   // q~ for dk
      ldmatrix_x4_trans(gft, g_t + row + off_at);   // g for dv
      float2 st[2][2];   // (lse, D) of the queries nt·8 + 2t + e
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[nt][e] = st_t[qt * 16 + nt * 8 + e];
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        float s[2][4] = {}, dp[2][4] = {};   // Sᵀ, dPᵀ: keys x 16 queries
        mma_16816(s[0], ka[j], qfb[0], qfb[1]);
        mma_16816(s[1], ka[j], qfb[2], qfb[3]);
        mma_16816(dp[0], va[j], gfb[0], gfb[1]);
        mma_16816(dp[1], va[j], gfb[2], gfb[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 sq = st[nt][e & 1];
            const float p = exp2_approx(s[nt][e] * kLog2e - sq.x);
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - sq.y);   // dSᵀ
          }
        uint32_t pa[4], da[4];
        pack_a(pa, s);
        pack_a(da, dp);
        mma_16816(dv[j][0], pa, gft[0], gft[1]);
        mma_16816(dv[j][1], pa, gft[2], gft[3]);
        mma_16816(dk[j][0], da, qft[0], qft[1]);
        mma_16816(dk[j][1], da, qft[2], qft[3]);
        // dS (queries x keys) as the A operand: dSᵀ's 8 x 8 quarters
        // transposed, the off-diagonal two swapped
        const uint32_t dsa[4] = {movmatrix_trans(da[0]),
                                 movmatrix_trans(da[2]),
                                 movmatrix_trans(da[1]),
                                 movmatrix_trans(da[3])};
        mma_16816(dq[0], dsa, kb[j][0], kb[j][1]);
        mma_16816(dq[1], dsa, kb[j][2], kb[j][3]);
      }
    };
    // warp w sums row w of each tile: its column pair i over the warps in
    // four chains of four, lane 8c + i; the (cos, sin) of the pair a lane
    // stores, loaded a tile ahead
    static_assert(kSbrWarps == 16, "a row of each tile a warp");
    const int c = lane >> 3, col = (lane & 7) * 2, srow = warp;
    const bool stores = pass + 1 == passes && c == 0 && col < dh;
    // this lane's row of tile 0: its pair's table entry, its dq, its sum
    const float* const rot_row = a.rot + srow * dh + col;
    T* const dq_row = dqb + srow * ld + col;
    float2* const acc_row = acc_s + srow * 8 + (col >> 1);
    auto pair_cs = [&](int qt) {
      return stores ? *reinterpret_cast<const float2*>(rot_row +
                                                       qt * 16 * dh)
                    : make_float2(0.f, 0.f);
    };
    auto write_part = [&](int qt, const float (&dq)[2][4]) {
      float* const buf = (qt & 1 ? part1 : part0) + wbase;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(buf + r * 128 + ((nt * 8) ^ wsw)) =
              make_float2(dq[nt][2 * r], dq[nt][2 * r + 1]);
    };
    // this lane's four partials of tile qt's row `srow`, those of warps
    // 4c .. 4c + 3 (slots 256 floats apart, at the row's position in them)
    const int rpos = srow ^ (c & 1);
    const int rbase =
        4 * c * 256 + rpos * 16 + (col ^ (((rpos >> 1) & 1) << 3));
    auto load_part = [&](int qt, float2 (&x)[4]) {
      const float* const buf = (qt & 1 ? part1 : part0) + rbase;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = *reinterpret_cast<const float2*>(buf + i * 256);
    };
    auto sum_tile = [&](int qt, const float2 (&x)[4], float2 cs) {
      // warps 4c .. 4c + 3 in order, then the chains as (0 + 1) + (2 + 3)
      float2 sum = x[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        sum.x += x[i].x;
        sum.y += x[i].y;
      }
#pragma unroll
      for (int off = 8; off <= 16; off <<= 1) {
        sum.x += __shfl_down_sync(0xffffffffu, sum.x, off);
        sum.y += __shfl_down_sync(0xffffffffu, sum.y, off);
      }
      if (c == 0) {
        if (passes > 1) {   // the earlier passes' sums first
          float2* const acc = acc_row + qt * 16 * 8;
          if (pass > 0) sum = make_float2(acc->x + sum.x, acc->y + sum.y);
          if (pass + 1 < passes) *acc = sum;
        }
        if (stores) {
          float y0 = sum.x * a.scale, y1 = sum.y * a.scale;
          rotate_pair_t_rn(y0, y1, cs.x, cs.y, cs.x, cs.y);
          store2(dq_row + qt * 16 * ld, y0, y1);
        }
      }
    };
    // the query tiles in turn, software-pipelined: tile qt computes while
    // the partials of tile qt - 1 (written before the last barrier) are
    // loaded and summed, one barrier a tile (a buffer is written again two
    // tiles later, after every warp has summed it). One loop per count of
    // key tiles a warp owns, so that no branch parts a tile's products and
    // the last tile's sums; every count passes the same barriers
    auto tiles = [&](auto ka_count) {
      constexpr int KA = decltype(ka_count)::value;
      float2 cs = pair_cs(0);
      {
        float dq[2][4] = {};
        if constexpr (KA > 0) tile(ka_count, 0, dq);
        write_part(0, dq);
        bar_sync(1, 32 * kSbrWarps);
      }
      for (int qt = 1; qt < NT; ++qt) {
        float2 x[4];
        load_part(qt - 1, x);
        const float2 cs_next = pair_cs(qt);
        float dq[2][4] = {};
        if constexpr (KA > 0) tile(ka_count, qt, dq);
        sum_tile(qt - 1, x, cs);
        cs = cs_next;
        write_part(qt, dq);
        bar_sync(1, 32 * kSbrWarps);
      }
      float2 x[4];
      load_part(NT - 1, x);
      sum_tile(NT - 1, x, cs);
    };
    static_assert(KT == 2, "a warp owns two key tiles, one or none a pass");
    if (mine == 2)
      tiles(std::integral_constant<int, 2>{});
    else if (mine == 1)
      tiles(std::integral_constant<int, 1>{});
    else
      tiles(std::integral_constant<int, 0>{});
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= mine) continue;
      const int kr = (first + j * kSbrWarps) * 16;
      T* const dst = dqb + kr * ld;
      store_rows<true, T, 16>(dst + HD, ld, a.rot + kr * dh, dk[j], 1.f,
                              lane, dh);
      store_rows<false, T, 16>(dst + 2 * HD, ld, nullptr, dv[j], 1.f, lane,
                               dh);
    }
  }
}

// dqkv [BF, N, 3·H·dh] of element type T from qkv, out and g: heads of 2
// to 16 dims (dh dividing 128), 256 <= N <= kSbrMaxN, N % 128 == 0
// (divided_backward_classes{,_f32}.cu). One launch, no scratch.
template <typename T>
int launch_space_backward_resident(const void* qkv, const void* rot,
                                   const void* out, const void* g, void* dqkv,
                                   int BF, int N, int H, int dh, float scale,
                                   cudaStream_t stream) {
  if (dh < 2 || 128 % dh || N < 256 || N > kSbrMaxN || N % 128)
    return cudaErrorInvalidValue;
  switch (dh <= 16 ? 16 : dh) {
    case 16: {
      auto kern = space_resident_bwd_kernel<T>;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          sbr_smem(kSbrMaxN));
      if (err != cudaSuccess) return err;
      const SpaceClassArgs<T> a{
          static_cast<const T*>(qkv), static_cast<const float*>(rot),
          static_cast<const T*>(out), static_cast<const T*>(g),
          static_cast<T*>(dqkv),      nullptr,
          N, H, scale, dh};
      kern<<<dim3(H, BF), 32 * kSbrWarps, sbr_smem(N), stream>>>(a);
      return cudaGetLastError();
    }
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
