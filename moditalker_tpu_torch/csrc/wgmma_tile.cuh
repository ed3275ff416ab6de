// Attention of Lq query rows over Lk keys of 64 dims on Hopper's warpgroup
// tensor cores, with the rotary applied to q and k on their way into shared
// memory.
//
// Used by the divided space-attention kernel (divided_attention.cu), which
// replaces _space_kernel of moditalker_tpu/ops/pallas/divided_attention.py,
// and, without the rotary (ROT = false), by the one-pass kernel (Lq = Lk)
// and the K-blocked fused kernel (Lq query rows over Lk keys) at head dim 64
// (flash_attention.cu: contiguous [B, N, 64] tensors as B sequences of one
// head). At the space attention's shipped shape (256 (frame, head) pairs of
// 1024 rows) the work is 68.7 GFLOP on 134 MB: bound by operations. The
// first port ran it on mma.sync with two shared loads per product step,
// re-rotated every K tile in each of 16 query blocks and transposed V by
// hand; this tile is built from what the card offers instead:
//
//  * both products are wgmma. S = Q·Kᵀ is m64n128k16 with Q as the register
//    A operand and the K tile read from shared memory (K-major, 128-byte
//    swizzle); O += P·V is m64n64k16 with P, re-packed from the S
//    accumulators, as the register A operand and the V tile read as the
//    MN-major (transposed) B operand from the same row-major swizzled layout,
//    so V is never transposed by hand.
//  * a block has consumer warpgroups of 64 query rows each (online softmax
//    per warpgroup in fp32) and one producer warpgroup. K passes through
//    registers: 16-byte loads, the rotary in fp32, one rounding to bf16,
//    16-byte stores into the swizzled tile. The producer keeps a ring of V
//    tiles in flight with cp.async; tiles are handed over with mbarriers
//    (full / empty per slot), so copies run while the tensor cores work.
//    cp.async with a hand XOR swizzle is used rather than TMA because K has
//    to pass through registers for the rotary in any case, so a tensor map
//    could serve V alone, and the library keeps its plain C interface: it
//    links nothing and encodes nothing per call. Without a rotary nothing
//    has to touch K: it goes into its swizzled tiles by cp.async as V does
//    (resident K: every warpgroup copies before the roles split; K ring: the
//    K tile travels in the V tile's cp.async group).
//  * K is rotated once per block. Up to L = 1152 every K tile gets a slot of
//    its own (resident K): one block per (sequence, head) rotates all of K
//    before the roles split, every warpgroup at it, then walks all query
//    rows, so K is rotated once per head (with too few heads to fill the
//    card, the rows are split over a few blocks per head). Above that K
//    does not fit beside the V ring: it streams through a ring of three
//    slots, rotated by the producer, and a block takes 128 query rows (K
//    rotated L / 128 times per head, where the first port rotated it L / 64
//    times). launch_wgmma chooses between the two by the key length Lk, and
//    sizes the grid by the query length Lq.
//  * a warp that starts a product waits about as long as the tensor cores
//    take for it, and the softmax of a 64 x 128 tile costs a warp about
//    twice that (ex2 at 16 per clock per SM, max, sum, convert). So the
//    tensor cores are busy only while other warps are in their softmax, and
//    what counts is how many consumer warps an SM holds. With resident K the
//    producer only copies V: it keeps 32 registers (setmaxnreg) and three
//    consumer warpgroups get 160 each. With a K ring the producer rotates
//    and needs 104, which leaves two consumers with 200.
//  * the rotary table is half width and interleaved, [L, 32, 2] fp32 =
//    (cos, sin) per rotated pair: the axial table repeats each entry over
//    its pair, so 32 bytes serve a 16-byte chunk of bf16.
//  * Q and the output pass through a padded per-warpgroup buffer, so global
//    loads and stores are 16 bytes per lane on neighbouring addresses.
//
// Rounding points are the TPU kernel's: q rotated and scaled in fp32 and
// rounded to bf16 once, k rotated and rounded once, fp32 scores, max and
// sum, P rounded to bf16 for P·V, the output divided by the fp32 row sum.
//
// The float32 route (TK = TQ = float: the divided space kernel's with the
// rotary, resident K only, Lk <= 1152, where resident_f32_tile.cuh's kernel
// read slower; the one-pass and fused kernels'
// at head dim 64 without it, the K ring where the pre-pass below read
// slower, and resident K where that kernel read slower or the shape is not
// its own) keeps those points
// and the bf16 tiles: q and k are read as two 16-byte float32 chunks per bf16
// chunk and rounded once (after the rotary, where there is one; without it
// K passes through the same registers that would rotate it, since cp.async
// copies bytes and cannot round: in the resident-K prologue, or in the
// producer's registers on its way into a ring slot); V passes through the
// producer's registers too and is rounded on its way into its slot (no
// float32 slot of 32 KB fits beside resident K: at N = 1024, 209 KB of the
// 227 KB are taken); the output is stored as float32 straight from the
// accumulators. With resident K the producer gets 56 registers for it and
// the consumers 152 (56 + 3 x 152 = 4 x 128: the block's registers, as
// 32 + 3 x 160 for bf16); with the ring the bf16 ring's 104 and 200.
//
// The float32 one-pass and fused kernels past resident K (TK = bf16,
// TQ = float: flash_attention_f32.cu's launch_prerounded) run the bf16 K
// ring on a scratch into which a pre-pass rounded K and V to bf16 once per
// sequence, where the float32 route's producer rounds every tile again in
// each of a sequence's Lq / 128 blocks: K and V go into their slots by
// cp.async, untouched, at the bf16 ring's registers, and only q (float32,
// scaled and rounded once) and the float32 output are the float32 route's.
// The rounding points are the same, so the output is the route's bit for
// bit. The pre-pass reads K and V once more and writes them, so the
// route's ring keeps one to three blocks of query rows a sequence over many
// sequences' keys, where it rounds each tile hardly more often.
//
// With the rotary, Lq = Lk and both are multiples of 128 (the space gate
// admits only such), so no tile is ragged. Without it, two edges are
// masked: a ragged last 64-row query chunk reads zeros past Lq and stores
// only the rows below it, and a short last key tile (Lk % 128 != 0, which
// the fused gate admits only below 128 keys) is zero-filled past Lk by the
// copies, so that no stale slot contents reach P·V, and its scores there are
// set to -inf before the max. Only resident K takes a short tile: the ring
// streams whole ones.
//
// Build note: the resident-K instantiation keeps a 16-byte stack with 12
// bytes of spill stores (the float32 one 8 bytes with 16), all in the K
// prologue before the roles split (its launch bound of 512 threads leaves 128
// registers until setmaxnreg), none in a loop. A prologue that copies raw K with cp.async and rotates it in place
// builds without the spill; it was no faster at B = 2 and slower at B = 1,
// so this one stays.
#pragma once

#include <type_traits>

#include "ptx.cuh"

namespace mdt {

constexpr int kWgD = 64;             // head dim
constexpr int kWgTile = 128;         // keys per K or V tile
constexpr int kWgVStages = 3;        // V ring
constexpr int kWgMaxKSlots = 9;      // resident K up to L = 1152
constexpr int kWgRingKSlots = 3;     // K ring above that
constexpr int kWgSmemLimit = 232448; // bytes a Hopper block may have
constexpr int kWgTileBytes = kWgTile * kWgD * 2;  // 16 KB, rows of 128 bytes
constexpr int kWgQStride = kWgD + 8;              // padded Q/output rows
constexpr int kWgRows = 64;          // query rows per consumer warpgroup
constexpr int kWgQBytes = kWgRows * kWgQStride * 2;  // one warpgroup's
constexpr int kWgBarBytes = 8 * 2 * (kWgMaxKSlots + kWgVStages);

constexpr int wgmma_smem_bytes(int k_slots, int consumers) {
  // 1 KB of slack: the tiles are aligned to the swizzle's 1024-byte period
  return 1024 + (k_slots + kWgVStages) * kWgTileBytes + consumers * kWgQBytes +
         kWgBarBytes;
}

static_assert(wgmma_smem_bytes(kWgMaxKSlots, 3) <= kWgSmemLimit &&
                  wgmma_smem_bytes(kWgMaxKSlots + 1, 3) > kWgSmemLimit,
              "resident K exactly where it fits beside the V ring");

// TK: the element type of k and v in memory; TQ: that of q and the
// output. bf16 and bf16; float32 and float32 (the float32 route); or bf16
// and float32 (the float32 one-pass and fused kernels past resident K, on
// the bf16 K and V their pre-pass rounded, flash_attention_f32.cu).
template <typename TK, typename TQ>
struct WgmmaArgsT {
  const TQ* q;
  const TK* k;
  const TK* v;
  const float* rot;  // [L, 32, 2] (cos, sin) per pair; read only when ROT
  TQ* out;
  long q_batch, kv_batch, in_row, out_batch, out_row;  // element strides
  int head;          // column offset of one head, inputs and output
  int Lq, Lk;        // query rows, keys
  float scale;
  // set by launch_wgmma
  int k_slots;       // ceil(Lk / 128): resident K; fewer: a ring
  int rounds;        // steps of NC x 64 query rows a block walks
};

using WgmmaArgs = WgmmaArgsT<bf16, bf16>;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product's start and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: rows of 128 bytes,
// groups of 8 rows 1024 bytes apart (the stride offset). The leading offset
// is not read for a K-major operand nor for an MN-major one of 64 columns;
// it carries the same 1024.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64] (+)= A (registers, 64 x 16) · Bᵀ (shared, K-major, 128 x 16).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accum)
      : "memory");
}

// d[32] += A (registers, 64 x 16) · B (shared, MN-major: 16 rows of 64).
__device__ __forceinline__ void wgmma_m64n64k16_bt(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// ---------------------------------------------------------------- rows
// Eight elements of one row (bf16 or float32; four rotary pairs, one
// 16-byte chunk of the bf16 tile), rotated by the chunk's (cos, sin) pairs
// when ROT, times `mul`, rounded to bf16 once. The float32 route rounds
// each product and sum of the rotation on its own (rotate_pair_rn), as the
// plain rotary and the space pre-pass do: the contracted form (one product
// fused into the sum) moved 20–304 rows of a float32 result off its route
// and one seed past the route's quantile limit. The bf16 instantiation
// keeps the contracted form it was measured with.
template <bool ROT, typename T>
__device__ __forceinline__ uint4 rotate_chunk(const Chunk8<T>& in, float4 t0,
                                              float4 t1, float mul) {
  float x[8];
  in.to_float(x);
  if (ROT) {
    const float c[4] = {t0.x, t0.z, t1.x, t1.z};
    const float s[4] = {t0.y, t0.w, t1.y, t1.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if constexpr (std::is_same<T, float>::value) {
        rotate_pair_rn(x[2 * p], x[2 * p + 1], c[p], s[p], c[p], s[p]);
      } else {
        float a = x[2 * p], b = x[2 * p + 1];
        x[2 * p] = a * c[p] - b * s[p];
        x[2 * p + 1] = b * c[p] + a * s[p];
      }
    }
  }
  uint4 v;
  v.x = pack_bf16(x[0] * mul, x[1] * mul);
  v.y = pack_bf16(x[2] * mul, x[3] * mul);
  v.z = pack_bf16(x[4] * mul, x[5] * mul);
  v.w = pack_bf16(x[6] * mul, x[7] * mul);
  return v;
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// One 128-row K tile from `src` (row stride in_row) into the swizzled tile at
// shared address `dst`, untouched: eight cp.async per thread of a warpgroup
// (thread t takes chunk t & 7 of rows t / 8 + 16 u, whose swizzle is that of
// row t / 8). The caller commits the group.
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src,
                                          long in_row, int t) {
  dst += swizzled(t >> 3, t & 7);
  src += (t >> 3) * in_row + (t & 7) * 8;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    cp_async16(dst + u * 16 * 128, src + u * 16 * in_row);
}

// The same for a short tile: rows at or past `rows` are zero-filled (their
// source address is row 0's, which is not read).
__device__ __forceinline__ void copy_tile_rows(uint32_t dst, const bf16* src,
                                               long in_row, int t, int rows) {
  dst += swizzled(t >> 3, t & 7);
  src += (t & 7) * 8;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = (t >> 3) + 16 * u;
    cp_async16_or_zeros(dst + u * 16 * 128, src + (r < rows ? r : 0) * in_row,
                        r < rows);
  }
}

// `ROWS` rows of 64 float32 starting at `src` (row stride in_row), rows at
// or past `rows` as zeros, each rounded to bf16 once, as bf16 chunks through
// `put(r, c, chunk)`: what stage_rows does without a rotary, for a last tile
// that may be short. Thread `tid` of the `T` takes chunk i = tid + T·u; the
// loads of BATCH chunks are in flight together.
template <int ROWS, int T, int BATCH, typename Put>
__device__ __forceinline__ void round_rows(const float* src, long in_row,
                                           int rows, int tid, Put put) {
  constexpr int PER = ROWS * 8 / T;  // chunks per thread
  static_assert(PER % BATCH == 0, "whole batches of chunks");
#pragma unroll
  for (int u0 = 0; u0 < PER; u0 += BATCH) {
    Chunk8<float> raw[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + T * (u0 + u);
      raw[u] = Chunk8<float>{};
      if ((i >> 3) < rows) raw[u].load(src + (i >> 3) * in_row + (i & 7) * 8);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + T * (u0 + u);
      float x[8];
      raw[u].to_float(x);
      put(i >> 3, i & 7, pack8_bf16(x));
    }
  }
}

// `ROWS` rows of 64 dims (bf16 or float32) starting at `src` (row stride
// in_row), rotated with the table rows starting at `tab` and scaled, as bf16
// chunks through `put(r, c, chunk)`. The `T` threads of the calling group
// take chunk i = tid + T·u: eight neighbouring lanes cover one row (128 bytes
// of bf16, 256 of float32). The loads of BATCH chunks (and of their table
// entries) are in flight together.
template <bool ROT, int ROWS, int T, int BATCH, typename TI, typename Put>
__device__ __forceinline__ void stage_rows(const TI* src, long in_row,
                                           const float* tab, float mul,
                                           int tid, Put put) {
  constexpr int PER = ROWS * 8 / T;  // chunks per thread
  static_assert(PER % BATCH == 0, "whole batches of chunks");
#pragma unroll
  for (int u0 = 0; u0 < PER; u0 += BATCH) {
    Chunk8<TI> raw[BATCH];
    float4 t0[BATCH], t1[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + T * (u0 + u), r = i >> 3, c = i & 7;
      raw[u].load(src + r * in_row + c * 8);
      if (ROT) {
        const float4* tp =
            reinterpret_cast<const float4*>(tab + (long)r * kWgD + c * 8);
        t0[u] = tp[0];
        t1[u] = tp[1];
      } else {
        t0[u] = t1[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + T * (u0 + u);
      put(i >> 3, i & 7, rotate_chunk<ROT>(raw[u], t0[u], t1[u], mul));
    }
  }
}

// ---------------------------------------------------------------- kernel
// NC consumer warpgroups and one producer: block (NC + 1) x 128, grid
// (ceil(Lq / 64 / (NC x rounds)), H, B), dynamic shared memory
// wgmma_smem_bytes(k_slots, NC). Consumer warpgroup w takes the 64 query
// rows of chunk (blockIdx.x x rounds + round) x NC + w in each round; a
// chunk past the sequence end is idle but keeps the ring's handshakes.
// NC = 3 is for resident K only: its producer gives up all but 32 registers
// and cannot rotate (56 for a float32 V, which it rounds to bf16 on its way
// into the ring). The float32 route takes the K ring (NC = 2) only without
// the rotary.
template <bool ROT, int NC, typename TK, typename TQ>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
wgmma_attention_kernel(const WgmmaArgsT<TK, TQ> a) {
  static_assert(NC == 2 || NC == 3, "two or three consumer warpgroups");
  // float32 K and V, rounded to bf16 on their way into shared memory
  constexpr bool kF32 = std::is_same<TK, float>::value;
  // float32 q and output
  constexpr bool kF32Q = std::is_same<TQ, float>::value;
  static_assert(kF32Q || !kF32, "float32 k and v with float32 q");
  static_assert(!kF32 || NC == 3 || !ROT,
                "float32 route with the rotary: resident K");
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw_base = smem_u32(wg_smem);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  unsigned char* sm = wg_smem + (base - raw_base);

  const int KS = a.k_slots;
  const int nkt = (a.Lk + kWgTile - 1) / kWgTile;
  const bool streamed = KS < nkt;
  // keys in the last tile: fewer than 128 only without the rotary
  const int last_rows = ROT ? kWgTile : a.Lk - (nkt - 1) * kWgTile;
  const uint32_t k_tiles = base;
  const uint32_t v_tiles = base + KS * kWgTileBytes;
  const int q_off = (KS + kWgVStages) * kWgTileBytes;
  const uint32_t bars = base + q_off + NC * kWgQBytes;
  // full_k[i], empty_k[i], full_v[i], empty_v[i]
  auto full_k = [&](int i) { return bars + 8 * i; };
  auto empty_k = [&](int i) { return bars + 8 * (kWgMaxKSlots + i); };
  auto full_v = [&](int i) { return bars + 8 * (2 * kWgMaxKSlots + i); };
  auto empty_v = [&](int i) {
    return bars + 8 * (2 * kWgMaxKSlots + kWgVStages + i);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kWgMaxKSlots; ++i) {
      mbar_init(full_k(i), 128);  // every producer thread arrives
      mbar_init(empty_k(i), 4 * NC);  // lane 0 of every consumer warp
    }
    for (int i = 0; i < kWgVStages; ++i) {
      mbar_init(full_v(i), 128);
      mbar_init(empty_v(i), 4 * NC);
    }
    mbar_init_fence();
  }

  const int h = blockIdx.y, b = blockIdx.z;
  // element offsets of this (sequence, head) in q and in k, v
  const long q_in = b * a.q_batch + (long)h * a.head;
  const long kv_in = b * a.kv_batch + (long)h * a.head;
  const int wg = tid >> 7;

  if (!streamed) {
    // resident K: before the roles split, the warpgroups rotate the K tiles
    // into their slots in turn, as many of a tile's loads in flight at once
    // as the registers of this phase hold. (Left to the producer alone, at
    // four chunks in flight per thread, the first pass over K waited on it
    // for a third of the block's time.)
    for (int j = wg; j < nkt; j += NC + 1) {
      const TK* ksrc = a.k + kv_in + (long)j * kWgTile * a.in_row;
      if constexpr (ROT) {
        unsigned char* kdst = sm + j * kWgTileBytes;
        // float32: half the chunks per batch, the same bytes in flight
        stage_rows<ROT, kWgTile, 128, NC == 2 ? 8 : (kF32 ? 2 : 4)>(
            ksrc, a.in_row, a.rot + (long)j * kWgTile * kWgD, 1.f, tid & 127,
            [&](int r, int c, uint4 v) {
              *reinterpret_cast<uint4*>(kdst + swizzled(r, c)) = v;
            });
      } else if constexpr (kF32) {
        // nothing to rotate, but float32 K is rounded to bf16 on its way
        // into its slot; keys past Lk as zeros
        unsigned char* kdst = sm + j * kWgTileBytes;
        round_rows<kWgTile, 128, 2>(
            ksrc, a.in_row, j < nkt - 1 ? kWgTile : last_rows, tid & 127,
            [&](int r, int c, uint4 v) {
              *reinterpret_cast<uint4*>(kdst + swizzled(r, c)) = v;
            });
      } else {  // nothing to rotate: K goes straight into its swizzled tile
        if (j < nkt - 1 || last_rows == kWgTile)
          copy_tile(k_tiles + j * kWgTileBytes, ksrc, a.in_row, tid & 127);
        else
          copy_tile_rows(k_tiles + j * kWgTileBytes, ksrc, a.in_row, tid & 127,
                         last_rows);
      }
    }
    if constexpr (!ROT && !kF32) cp_async_wait_all();
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == NC) {
    if constexpr (kF32) {
      // ---------------------------------------- producer, float32 K, V
      // Each V tile, and with a K ring each K tile ahead of it, passes
      // through this warpgroup's registers and is rounded to bf16 on its way
      // into its slot: cp.async copies bytes and cannot convert, and no
      // float32 staging slot fits beside resident K. The first half of a V
      // tile's loads is issued before the wait for its slot.
      if constexpr (NC == 2)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
      else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
      constexpr int kVBatch = 4;  // of the thread's eight chunks a tile
      const int pt = tid - NC * 128;
      const TK* vb = a.v + kv_in + (pt >> 3) * a.in_row + (pt & 7) * 8;
      unsigned char* vsm = sm + KS * kWgTileBytes + swizzled(pt >> 3, pt & 7);
      int it = 0;
      for (int round = 0; round < a.rounds; ++round) {
        for (int j = 0; j < nkt; ++j, ++it) {
          if constexpr (NC == 2) {
            if (streamed) {  // the ring takes whole tiles only
              const int ks = it % KS;
              mbar_wait(empty_k(ks), ((it / KS) & 1) ^ 1);
              unsigned char* kdst = sm + ks * kWgTileBytes;
              round_rows<kWgTile, 128, 4>(
                  a.k + kv_in + (long)j * kWgTile * a.in_row, a.in_row,
                  kWgTile, pt, [&](int r, int c, uint4 v) {
                    *reinterpret_cast<uint4*>(kdst + swizzled(r, c)) = v;
                  });
              fence_proxy_async();
              mbar_arrive(full_k(ks));
            }
          }
          const int vs = it % kWgVStages;
          const TK* vsrc = vb + (long)j * kWgTile * a.in_row;
          unsigned char* vdst = vsm + vs * kWgTileBytes;
#pragma unroll
          for (int u0 = 0; u0 < 8; u0 += kVBatch) {
            Chunk8<TK> c[kVBatch];
            if (ROT || j < nkt - 1 || last_rows == kWgTile) {
#pragma unroll
              for (int u = 0; u < kVBatch; ++u)
                c[u].load(vsrc + (u0 + u) * 16 * a.in_row);
            } else {  // a short last tile (no rotary): keys past Lk as zeros
#pragma unroll
              for (int u = 0; u < kVBatch; ++u) {
                const int du = (u0 + u) * 16;  // rows past this thread's first
                c[u] = Chunk8<TK>{};
                if ((pt >> 3) + du < last_rows) c[u].load(vsrc + du * a.in_row);
              }
            }
            if (u0 == 0) mbar_wait(empty_v(vs), ((it / kWgVStages) & 1) ^ 1);
#pragma unroll
            for (int u = 0; u < kVBatch; ++u) {
              float x[8];
              c[u].to_float(x);
              *reinterpret_cast<uint4*>(vdst + (u0 + u) * 16 * 128) =
                  pack8_bf16(x);
            }
          }
          fence_proxy_async();
          mbar_arrive(full_v(vs));
        }
      }
    } else {
      // ------------------------------------------------------ producer
      if constexpr (NC == 2)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
      else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
      const int pt = tid - NC * 128;
      // this thread's eight chunks of a tile: row pt / 8 + 16 u, whose
      // swizzle is that of row pt / 8
      const uint32_t v_sw = swizzled(pt >> 3, pt & 7);
      const TK* vb = a.v + kv_in + (pt >> 3) * a.in_row + (pt & 7) * 8;
      // Without a rotary a K ring's tiles travel with the V tiles, in the same
      // cp.async group; with one they pass through this warpgroup's registers.
      constexpr bool kCopyK = NC == 2 && !ROT;
      int it = 0;
      for (int round = 0; round < a.rounds; ++round) {
        for (int j = 0; j < nkt; ++j, ++it) {
          const int vs = it % kWgVStages;
          mbar_wait(empty_v(vs), ((it / kWgVStages) & 1) ^ 1);
          const uint32_t vdst = v_tiles + vs * kWgTileBytes + v_sw;
          const TK* vsrc = vb + (long)j * kWgTile * a.in_row;
          if (j == nkt - 1 && last_rows < kWgTile) {  // resident K only
            copy_tile_rows(v_tiles + vs * kWgTileBytes,
                           a.v + kv_in + (long)j * kWgTile * a.in_row, a.in_row,
                           pt, last_rows);
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              cp_async16(vdst + u * 16 * 128, vsrc + u * 16 * a.in_row);
          }
          if (kCopyK && streamed) {
            mbar_wait(empty_k(it % KS), ((it / KS) & 1) ^ 1);
            copy_tile(k_tiles + (it % KS) * kWgTileBytes,
                      a.k + kv_in + (long)j * kWgTile * a.in_row, a.in_row, pt);
          }
          cp_async_commit();
          if (it > 0) {  // the tiles started one step ago have landed
            cp_async_wait<1>();
            fence_proxy_async();
            mbar_arrive(full_v((it - 1) % kWgVStages));
            if (kCopyK && streamed) mbar_arrive(full_k((it - 1) % KS));
          }

          if constexpr (NC == 2 && ROT) {
            if (streamed) {
              const int ks = it % KS;
              mbar_wait(empty_k(ks), ((it / KS) & 1) ^ 1);
              unsigned char* kdst = sm + ks * kWgTileBytes;
              stage_rows<ROT, kWgTile, 128, 4>(
                  a.k + kv_in + (long)j * kWgTile * a.in_row, a.in_row,
                  a.rot + (long)j * kWgTile * kWgD, 1.f, pt,
                  [&](int r, int c, uint4 v) {
                    *reinterpret_cast<uint4*>(kdst + swizzled(r, c)) = v;
                  });
              fence_proxy_async();
              mbar_arrive(full_k(ks));
            }
          }
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(full_v((it - 1) % kWgVStages));
      if (kCopyK && streamed) mbar_arrive(full_k((it - 1) % KS));
    }
  } else {
    // ------------------------------------------------------ consumers
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    else if constexpr (kF32)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int ct = tid & 127, warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    bf16* q_s = reinterpret_cast<bf16*>(sm + q_off + wg * kWgQBytes);
    constexpr float kLog2e = 1.4426950408889634f;
    int it = 0;

    for (int round = 0; round < a.rounds; ++round) {
      const int q0 = ((blockIdx.x * a.rounds + round) * NC + wg) * kWgRows;
      if (q0 >= a.Lq) {
        // no rows left for this warpgroup: it only hands the tiles back
        for (int j = 0; j < nkt; ++j, ++it) {
          if (streamed) {
            mbar_wait(full_k(it % KS), (it / KS) & 1);
            if (lane == 0) mbar_arrive(empty_k(it % KS));
          }
          const int vs = it % kWgVStages;
          mbar_wait(full_v(vs), (it / kWgVStages) & 1);
          if (lane == 0) mbar_arrive(empty_v(vs));
        }
        continue;
      }
      // Q: rotary + scale, rounded to bf16 once, then into A fragments
      if (ROT || q0 + kWgRows <= a.Lq) {
        stage_rows<ROT, kWgRows, 128, 4>(
            a.q + q_in + q0 * a.in_row, a.in_row, a.rot + (long)q0 * kWgD,
            a.scale, ct,
            [&](int r, int c, uint4 v) {
              *reinterpret_cast<uint4*>(q_s + r * kWgQStride + c * 8) = v;
            });
      } else if constexpr (!ROT) {
        // ragged last chunk: rows past Lq compute on zeros
        const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = ct + 128 * u, r = i >> 3, c = i & 7;
          Chunk8<TQ> raw{};
          if (q0 + r < a.Lq) raw.load(a.q + q_in + (q0 + r) * a.in_row + c * 8);
          *reinterpret_cast<uint4*>(q_s + r * kWgQStride + c * 8) =
              rotate_chunk<false>(raw, none, none, a.scale);
        }
      }
      bar_sync(1 + wg, 128);
      uint32_t qa[kWgD / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgD / 16; ++kk) {
        const bf16* p0 = q_s + (warp * 16 + g) * kWgQStride + kk * 16 + 2 * t;
        const bf16* p1 = p0 + 8 * kWgQStride;
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

      for (int j = 0; j < nkt; ++j, ++it) {
        // S = Q·Kᵀ: this warpgroup's 64 rows x 128 keys
        const int ks = streamed ? it % KS : j;
        if (streamed) mbar_wait(full_k(ks), (it / KS) & 1);
        float s[64];
        const uint32_t kt = k_tiles + ks * kWgTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgD / 16; ++kk)
          wgmma_m64n128k16(s, qa[kk], wgmma_desc(kt + kk * 32), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        if (streamed && lane == 0) mbar_arrive(empty_k(ks));
        if (j == nkt - 1 && last_rows < kWgTile) {
          // short last tile: keys past Lk weigh nothing (s[4 nt + 2 r + c]
          // is key 8 nt + 2 t + c of row g + 8 r)
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int key = nt * 8 + 2 * t;
            if (key >= last_rows) s[4 * nt] = s[4 * nt + 2] = -INFINITY;
            if (key + 1 >= last_rows) s[4 * nt + 1] = s[4 * nt + 3] = -INFINITY;
          }
        }

        // online softmax; rows g (r = 0) and g + 8 (r = 1) of this warp's
        // 16, each spread over a quad
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt)
            mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[r], mx);
          const float alpha = exp2_approx((m_run[r] - m_new) * kLog2e);
          const float shift = m_new * kLog2e;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const float p0 = exp2_approx(fmaf(s[4 * nt + 2 * r], kLog2e, -shift));
            const float p1 =
                exp2_approx(fmaf(s[4 * nt + 2 * r + 1], kLog2e, -shift));
            s[4 * nt + 2 * r] = p0;
            s[4 * nt + 2 * r + 1] = p1;
            sum += p0 + p1;
          }
          l_run[r] = l_run[r] * alpha + sum;
          m_run[r] = m_new;
#pragma unroll
          for (int nd = 0; nd < 8; ++nd) {
            o[4 * nd + 2 * r] *= alpha;
            o[4 * nd + 2 * r + 1] *= alpha;
          }
        }

        // O += P·V, P re-packed from the S accumulators as bf16 A fragments
        uint32_t pa[kWgTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kWgTile / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        const int vs = it % kWgVStages;
        mbar_wait(full_v(vs), (it / kWgVStages) & 1);
        const uint32_t vt = v_tiles + vs * kWgTileBytes;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgTile / 16; ++kk)
          wgmma_m64n64k16_bt(o, pa[kk], wgmma_desc(vt + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty_v(vs));
      }

      // finish the row sums across the quad
      if constexpr (kF32Q) {
        // float32 straight from the fragments: a quad's four 8-byte stores
        // fill one 32-byte sector of a row (with the rotary rows are whole,
        // Lq % 128 == 0; without it rows past Lq are not stored)
        TQ* ob = a.out + b * a.out_batch + (long)h * a.head;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
          const float inv = 1.f / l_run[r];
          const int row = q0 + warp * 16 + g + 8 * r;
          TQ* dst = ob + (long)row * a.out_row + 2 * t;
          if (ROT || row < a.Lq) {
#pragma unroll
            for (int nd = 0; nd < 8; ++nd)
              *reinterpret_cast<float2*>(dst + nd * 8) = make_float2(
                  o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);
          }
        }
      } else {
        // the output leaves through the Q buffer as 16-byte stores (every
        // warp of the group has read its Q fragments: the products above
        // needed all four)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
          const float inv = 1.f / l_run[r];
          bf16* dst = q_s + (warp * 16 + g + 8 * r) * kWgQStride + 2 * t;
#pragma unroll
          for (int nd = 0; nd < 8; ++nd)
            *reinterpret_cast<uint32_t*>(dst + nd * 8) = pack_bf16(
                o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);
        }
        bar_sync(1 + wg, 128);
        TQ* ob = a.out + b * a.out_batch + (long)h * a.head;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = ct + 128 * u, r = i >> 3, c = i & 7;
          if (ROT || q0 + r < a.Lq)
            *reinterpret_cast<uint4*>(ob + (q0 + r) * a.out_row + c * 8) =
                *reinterpret_cast<const uint4*>(q_s + r * kWgQStride + c * 8);
        }
      }
      bar_sync(1 + wg, 128);  // before the next Q tile overwrites the buffer
    }
  }
}

template <bool ROT, int NC, typename TK, typename TQ>
cudaError_t launch_wgmma_plan(const WgmmaArgsT<TK, TQ>& args, int B, int H,
                              cudaStream_t stream) {
  const int smem = wgmma_smem_bytes(args.k_slots, NC);
  auto kern = wgmma_attention_kernel<ROT, NC, TK, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = NC * kWgRows * args.rounds;  // query rows per block
  dim3 grid((args.Lq + rows - 1) / rows, H, B);
  kern<<<grid, (NC + 1) * 128, smem, stream>>>(args);
  return cudaGetLastError();
}

// The K ring alone: two consumers, 128 query rows per block, whole K tiles.
template <bool ROT, typename TK, typename TQ>
cudaError_t launch_wgmma_ring(WgmmaArgsT<TK, TQ> args, int B, int H,
                              cudaStream_t stream) {
  if (args.Lq < 1 || args.Lk < 1 || args.Lk % kWgTile != 0)
    return cudaErrorInvalidValue;
  args.k_slots = kWgRingKSlots;
  args.rounds = 1;
  return launch_wgmma_plan<ROT, 2>(args, B, H, stream);
}

// B sequences of H heads. Resident K (three consumers) wherever every K
// tile has a slot, the K ring (launch_wgmma_ring) above that: chosen by Lk.
// With resident K one block per (sequence, head) walks all Lq rows in steps
// of 192, so that K is copied once per head; where that leaves the card
// short of blocks (few sequences, Lq > 192), the steps are split over more
// blocks: the most steps per block whose grid still fills the card, as
// launch_smallhead counts rows. With the rotary, Lq = Lk, a multiple of
// 128; the ring takes whole K tiles only. The float32 route (TK = float)
// has the ring only without the rotary: with it, above resident K it is
// refused.
template <bool ROT, typename TK = bf16, typename TQ = TK>
cudaError_t launch_wgmma(WgmmaArgsT<TK, TQ> args, int B, int H,
                         cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<TK, float>::value;
  const int nkt = (args.Lk + kWgTile - 1) / kWgTile;
  if (args.Lq < 1 || args.Lk < 1) return cudaErrorInvalidValue;
  if (ROT && (args.Lq != args.Lk || args.Lk % kWgTile != 0))
    return cudaErrorInvalidValue;
  if (nkt <= kWgMaxKSlots) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int steps = (args.Lq + 3 * kWgRows - 1) / (3 * kWgRows);
    args.k_slots = nkt;
    args.rounds = steps;
    while (args.rounds > 1 &&
           (long)B * H * ((steps + args.rounds - 1) / args.rounds) <
               sms - sms / 8)
      args.rounds = (args.rounds + 1) / 2;
    return launch_wgmma_plan<ROT, 3>(args, B, H, stream);
  }
  if constexpr (kF32 && ROT)
    return cudaErrorInvalidValue;
  else
    return launch_wgmma_ring<ROT>(args, B, H, stream);
}

}  // namespace mdt
