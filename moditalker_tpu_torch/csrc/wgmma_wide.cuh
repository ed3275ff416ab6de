// Attention of Lq query rows over Lk keys on Hopper's warpgroup tensor
// cores at any head width: wgmma_tile.cuh's tile built per width, for the
// one-pass and K-blocked fused kernels (flash_wide.cu, flash_wide_f32.cu)
// and the divided space attention at head dim 128, and at 64 in float32
// past resident K (divided_space.cuh). A header of its own, so that the
// translation units of the configurations' kernels, which include
// wgmma_tile.cuh, compile as they did.
#pragma once

#include <type_traits>

#include "wgmma_tile.cuh"

namespace mdt {

// The tile built per head width: the one-pass and K-blocked fused kernels
// at every head dim d % 8 == 0 above 32 but 64 (flash_wide.cu; 16, 32 and 64
// are flash_attention.cu's, the rest below 32 the small-head tile's
// classes, and in bf16 40 to 56 the narrow tile's), without the
// rotary. wgmma_tile.cuh's kernel stays as it is for head dim 64, so that
// the configurations' space, one-pass and fused kernels compile and run as
// they did (their outputs bit for bit); this one is the same tile
// generalised over the width. The rotary stays outside it: the divided
// space attention's pre-pass writes q and k rotated (divided_space.cuh),
// and the tile reads them raw through strides (SPACE: a frame's heads as
// its sequences, rows of the packed [.., 3·H·d] layout, the output
// head-merged, float32 on the float32 route):
//
//  * a block computes DN output columns: d itself up to 256 (DN = d, so
//    float32 heads of 40, 48 and 56 do no padded P·V columns), and past 256 groups
//    of 256 columns, one group a block (grid.y), each of which sums S over
//    all of d again: such a head does (groups) x the S products.
//  * S = Q·Kᵀ is wgmma with both operands in shared memory (Q as the
//    shared-memory A operand), in k16 steps over d rounded up to 16 (the
//    zero chunk of a d % 16 == 8 head is copied as zeros). Q and every K
//    tile are stored as 64-dim panels of 128-byte swizzled rows, the layout
//    the D = 64 tile uses for one panel; a step reads 32 bytes of a row of
//    one panel. With Q in shared memory a consumer's registers hold S and
//    O only: at DN = 256 O alone is 128 fp32 registers a thread.
//  * O += P·V is m64nDNk16 with P re-packed from the S accumulators and V
//    as the MN-major operand: panels of 64 columns, the leading byte offset
//    the panel stride.
//  * keys per tile KN = 128 up to DN = 128, 64 above (S is KN / 2 registers
//    a thread: 64 beside DN / 2 of O at DN = 128, 32 beside 128 at 256, the
//    flash-attention-3 plan for heads of 256). The float32 route's softmax
//    tiles are these (flash_attention.attention_float32_route).
//  * two consumer warpgroups of 64 query rows and one producer. K streams
//    through a ring of 64-dim chunks of a tile, V through a ring of tiles,
//    their depths sized per width from the block's 227 KB at launch
//    (launch_wide). The copies arrive on a slot's barrier themselves when
//    they land (cp.async.mbarrier.arrive), so the producer never waits for
//    memory and keeps every free slot's copies in flight; a consumer fences
//    the async proxy after its wait, before its products read the slot.
//  * up to 256 columns a tile's S products run as one commit group over all
//    its chunks (wide_s_start), and a consumer's tiles are pipelined: tile
//    j's S = Q·Kᵀ and tile j - 1's O += P·V start together, j's softmax
//    runs while P·V finishes, and O is rescaled once it has (S, P and O
//    live at once: KN / 2 + KN / 4 + DN / 2 registers, 160 at DN = 128,
//    176 at 256).
//  * past 256 columns the products run a commit group per K chunk and hand
//    each chunk back once the next one's are under way (wgmma.wait_group
//    1), so the ring needs no whole tile. Q stays resident in shared memory
//    up to what fits: 512 dims with two consumers, 1088 with one
//    (kWdMaxResidentDim). A wider head (the fused gate has no bound on d)
//    streams Q as well: one consumer stages each 64-dim panel of its Q
//    rows again for every key tile, into a ring of four panels, beside the
//    K chunk it is multiplied with.
//  * with too few sequences to fill the card a block takes 64 rows, one
//    warpgroup's, where 128 would leave SMs idle (launch_wide).
//  * the edges are the D = 64 tile's: a ragged last query chunk reads zeros
//    and stores only the rows below Lq; a short last key tile is zero-filled
//    past Lk (no stale slot reaches P·V) and its scores masked to -inf
//    before the max.
//
// bf16: K and V go into their slots by cp.async untouched; the producer
// keeps 40 registers and the consumers get 232 (40 + 2 x 232 = 3 x 168,
// the block's pool). Float32 (TI = float): q, k and v are read as float32
// and rounded to bf16 once, q in the consumers' registers (after the
// scale), K and V in the producer's on their way into their slots (72
// registers, consumers 216); the output is stored as float32 from the
// accumulators. Rounding points are the D = 64 tile's in both.

constexpr int kWdRows = 64;                   // query rows per consumer
constexpr int kWdPanelBytes = kWdRows * 128;  // 64 rows of one 64-dim panel
constexpr int kWdMaxKSlots = 16;              // K ring, in 64-dim chunks
constexpr int kWdMaxVSlots = 3;               // V ring, in tiles
constexpr int kWdGroup = 256;                 // output columns per block, at most
constexpr int kWdMaxResidentDim = 1088;       // Q resident with one consumer
constexpr int kWdQRing = 4;                   // Q panels in flight, streamed
constexpr int kWdBarBytes = 8 * 2 * (kWdMaxKSlots + kWdMaxVSlots);

constexpr int wide_smem_bytes(int k_chunk_bytes, int v_slot_bytes, int nc,
                              int panels, int k_slots, int v_slots) {
  return 1024 + k_slots * k_chunk_bytes + v_slots * v_slot_bytes +
         nc * panels * kWdPanelBytes + kWdBarBytes;
}

template <int DN>
struct WideTile {
  static_assert(DN % 8 == 0 && DN >= 8 && DN <= kWdGroup,
                "output columns a multiple of 8, up to 256");
  static constexpr int KN = DN <= 128 ? 128 : 64;       // keys per tile
  static constexpr int k_chunk_bytes = KN * 128;        // 64 dims of a K tile
  static constexpr int v_slot_bytes = (DN + 63) / 64 * KN * 128;
  // Q and K panels of a head DN wide (d rounded up to 16)
  static constexpr int panels = ((DN + 15) / 16 * 16 + 63) / 64;
  // the shallowest rings a head DN wide runs with (two consumers, a whole
  // tile's K chunks and at least three, two V tiles) fit the block
  static_assert(wide_smem_bytes(k_chunk_bytes, v_slot_bytes, 2, panels,
                                panels < 3 ? 3 : panels, 2) <= kWgSmemLimit,
                "a head DN wide fits beside its rings");
};
static_assert(wide_smem_bytes(WideTile<kWdGroup>::k_chunk_bytes,
                              WideTile<kWdGroup>::v_slot_bytes, 2, 8, 3, 2) <=
                      kWgSmemLimit &&
                  wide_smem_bytes(WideTile<kWdGroup>::k_chunk_bytes,
                                  WideTile<kWdGroup>::v_slot_bytes, 1,
                                  ((kWdMaxResidentDim + 15) / 16 * 16 + 63) /
                                      64,
                                  3, 2) <= kWgSmemLimit,
              "Q resident up to 512 dims with two consumers, and up to "
              "kWdMaxResidentDim with one");

// q, out: contiguous [B, Lq, d]; k, v: contiguous [B, Lk, d].
template <typename T>
struct WideArgsT {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  long q_batch, kv_batch;  // elements of one sequence: Lq·d, Lk·d
  int d;                   // head width, the row stride of all four
  int Lq, Lk;
  float scale;
  // set by launch_wide
  int k_slots, v_slots;    // ring depths: K chunks, V tiles
  int active;              // consumer warpgroups a block gives rows (1, 2)
  int q_stream;            // Q streamed per key tile (one consumer, DN 256)
};

// SPACE (the divided space attention's pre-rotated scratch, bf16;
// divided_space.cuh): B = frames x heads, q, k and v rows in_row apart with
// a head's d columns at head x d, q_batch the elements of one frame; the
// output [frames, Lq, heads x d] (out_batch, out_row) of the kernel's TO.
// A type of its own, so that every other instantiation keeps its arguments
// as they were.
struct WideSpaceArgs : WideArgsT<bf16> {
  long out_batch;
  int in_row, out_row, heads;
};

template <typename T, bool SPACE>
using WideArgsOf = std::conditional_t<SPACE, WideSpaceArgs, WideArgsT<T>>;

// Shared-memory matrix descriptor, 128-byte swizzle, with a leading byte
// offset: the stride from one 64-column panel of an MN-major operand to the
// next (V at more than 64 output columns).
__device__ __forceinline__ uint64_t wgmma_desc_lbo(uint32_t addr,
                                                   uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A (shared, K-major, 64 x 16) · Bᵀ (shared, K-major, KN x 16),
// KN = 64 or 128 keys.
template <int KN>
__device__ __forceinline__ void wgmma_ss(float (&d)[KN / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accum);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accum)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accum)
      : "memory");
}

// d[N / 2] += A (registers, 64 x 16) · B (shared, MN-major: 16 rows of N,
// in 64-column panels `lbo` bytes apart), for every N % 8 == 0 up to 256.
// The accumulate flag, A and the descriptor come first (%0 .. %5), so that
// the accumulators' list (MDT_WG_REGS_N, from %6) is one table for every N.
template <int N>
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b);

#define MDT_WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MDT_WG_REGS_8 "%6, %7, %8, %9"
#define MDT_WG_REGS_16 MDT_WG_REGS_8 ", %10, %11, %12, %13"
#define MDT_WG_REGS_24 MDT_WG_REGS_16 ", %14, %15, %16, %17"
#define MDT_WG_REGS_32 MDT_WG_REGS_24 ", %18, %19, %20, %21"
#define MDT_WG_REGS_40 MDT_WG_REGS_32 ", %22, %23, %24, %25"
#define MDT_WG_REGS_48 MDT_WG_REGS_40 ", %26, %27, %28, %29"
#define MDT_WG_REGS_56 MDT_WG_REGS_48 ", %30, %31, %32, %33"
#define MDT_WG_REGS_64 MDT_WG_REGS_56 ", %34, %35, %36, %37"
#define MDT_WG_REGS_72 MDT_WG_REGS_64 ", %38, %39, %40, %41"
#define MDT_WG_REGS_80 MDT_WG_REGS_72 ", %42, %43, %44, %45"
#define MDT_WG_REGS_88 MDT_WG_REGS_80 ", %46, %47, %48, %49"
#define MDT_WG_REGS_96 MDT_WG_REGS_88 ", %50, %51, %52, %53"
#define MDT_WG_REGS_104 MDT_WG_REGS_96 ", %54, %55, %56, %57"
#define MDT_WG_REGS_112 MDT_WG_REGS_104 ", %58, %59, %60, %61"
#define MDT_WG_REGS_120 MDT_WG_REGS_112 ", %62, %63, %64, %65"
#define MDT_WG_REGS_128 MDT_WG_REGS_120 ", %66, %67, %68, %69"
#define MDT_WG_REGS_136 MDT_WG_REGS_128 ", %70, %71, %72, %73"
#define MDT_WG_REGS_144 MDT_WG_REGS_136 ", %74, %75, %76, %77"
#define MDT_WG_REGS_152 MDT_WG_REGS_144 ", %78, %79, %80, %81"
#define MDT_WG_REGS_160 MDT_WG_REGS_152 ", %82, %83, %84, %85"
#define MDT_WG_REGS_168 MDT_WG_REGS_160 ", %86, %87, %88, %89"
#define MDT_WG_REGS_176 MDT_WG_REGS_168 ", %90, %91, %92, %93"
#define MDT_WG_REGS_184 MDT_WG_REGS_176 ", %94, %95, %96, %97"
#define MDT_WG_REGS_192 MDT_WG_REGS_184 ", %98, %99, %100, %101"
#define MDT_WG_REGS_200 MDT_WG_REGS_192 ", %102, %103, %104, %105"
#define MDT_WG_REGS_208 MDT_WG_REGS_200 ", %106, %107, %108, %109"
#define MDT_WG_REGS_216 MDT_WG_REGS_208 ", %110, %111, %112, %113"
#define MDT_WG_REGS_224 MDT_WG_REGS_216 ", %114, %115, %116, %117"
#define MDT_WG_REGS_232 MDT_WG_REGS_224 ", %118, %119, %120, %121"
#define MDT_WG_REGS_240 MDT_WG_REGS_232 ", %122, %123, %124, %125"
#define MDT_WG_REGS_248 MDT_WG_REGS_240 ", %126, %127, %128, %129"
#define MDT_WG_REGS_256 MDT_WG_REGS_248 ", %130, %131, %132, %133"
#define MDT_WG_OUTS_8 MDT_WG_F4(0)
#define MDT_WG_OUTS_16 MDT_WG_OUTS_8, MDT_WG_F4(4)
#define MDT_WG_OUTS_24 MDT_WG_OUTS_16, MDT_WG_F4(8)
#define MDT_WG_OUTS_32 MDT_WG_OUTS_24, MDT_WG_F4(12)
#define MDT_WG_OUTS_40 MDT_WG_OUTS_32, MDT_WG_F4(16)
#define MDT_WG_OUTS_48 MDT_WG_OUTS_40, MDT_WG_F4(20)
#define MDT_WG_OUTS_56 MDT_WG_OUTS_48, MDT_WG_F4(24)
#define MDT_WG_OUTS_64 MDT_WG_OUTS_56, MDT_WG_F4(28)
#define MDT_WG_OUTS_72 MDT_WG_OUTS_64, MDT_WG_F4(32)
#define MDT_WG_OUTS_80 MDT_WG_OUTS_72, MDT_WG_F4(36)
#define MDT_WG_OUTS_88 MDT_WG_OUTS_80, MDT_WG_F4(40)
#define MDT_WG_OUTS_96 MDT_WG_OUTS_88, MDT_WG_F4(44)
#define MDT_WG_OUTS_104 MDT_WG_OUTS_96, MDT_WG_F4(48)
#define MDT_WG_OUTS_112 MDT_WG_OUTS_104, MDT_WG_F4(52)
#define MDT_WG_OUTS_120 MDT_WG_OUTS_112, MDT_WG_F4(56)
#define MDT_WG_OUTS_128 MDT_WG_OUTS_120, MDT_WG_F4(60)
#define MDT_WG_OUTS_136 MDT_WG_OUTS_128, MDT_WG_F4(64)
#define MDT_WG_OUTS_144 MDT_WG_OUTS_136, MDT_WG_F4(68)
#define MDT_WG_OUTS_152 MDT_WG_OUTS_144, MDT_WG_F4(72)
#define MDT_WG_OUTS_160 MDT_WG_OUTS_152, MDT_WG_F4(76)
#define MDT_WG_OUTS_168 MDT_WG_OUTS_160, MDT_WG_F4(80)
#define MDT_WG_OUTS_176 MDT_WG_OUTS_168, MDT_WG_F4(84)
#define MDT_WG_OUTS_184 MDT_WG_OUTS_176, MDT_WG_F4(88)
#define MDT_WG_OUTS_192 MDT_WG_OUTS_184, MDT_WG_F4(92)
#define MDT_WG_OUTS_200 MDT_WG_OUTS_192, MDT_WG_F4(96)
#define MDT_WG_OUTS_208 MDT_WG_OUTS_200, MDT_WG_F4(100)
#define MDT_WG_OUTS_216 MDT_WG_OUTS_208, MDT_WG_F4(104)
#define MDT_WG_OUTS_224 MDT_WG_OUTS_216, MDT_WG_F4(108)
#define MDT_WG_OUTS_232 MDT_WG_OUTS_224, MDT_WG_F4(112)
#define MDT_WG_OUTS_240 MDT_WG_OUTS_232, MDT_WG_F4(116)
#define MDT_WG_OUTS_248 MDT_WG_OUTS_240, MDT_WG_F4(120)
#define MDT_WG_OUTS_256 MDT_WG_OUTS_248, MDT_WG_F4(124)
#define MDT_WGMMA_RS_BT(N)                                                    \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_rs_bt<N>(                             \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t desc_b) {             \
    uint32_t one = 1, a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"                  \
                 "wgmma.mma_async.sync.aligned.m64n" #N                       \
                 "k16.f32.bf16.bf16 {" MDT_WG_REGS_##N                        \
                 "}, {%1, %2, %3, %4}, %5, p, 1, 1, 1;\n}\n"                  \
                 : "+r"(one), "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3),         \
                   "+l"(desc_b), MDT_WG_OUTS_##N                              \
                 :                                                            \
                 : "memory");                                                 \
  }
MDT_WGMMA_RS_BT(8)   MDT_WGMMA_RS_BT(16)  MDT_WGMMA_RS_BT(24)
MDT_WGMMA_RS_BT(32)  MDT_WGMMA_RS_BT(40)  MDT_WGMMA_RS_BT(48)
MDT_WGMMA_RS_BT(56)  MDT_WGMMA_RS_BT(64)  MDT_WGMMA_RS_BT(72)
MDT_WGMMA_RS_BT(80)  MDT_WGMMA_RS_BT(88)  MDT_WGMMA_RS_BT(96)
MDT_WGMMA_RS_BT(104) MDT_WGMMA_RS_BT(112) MDT_WGMMA_RS_BT(120)
MDT_WGMMA_RS_BT(128) MDT_WGMMA_RS_BT(136) MDT_WGMMA_RS_BT(144)
MDT_WGMMA_RS_BT(152) MDT_WGMMA_RS_BT(160) MDT_WGMMA_RS_BT(168)
MDT_WGMMA_RS_BT(176) MDT_WGMMA_RS_BT(184) MDT_WGMMA_RS_BT(192)
MDT_WGMMA_RS_BT(200) MDT_WGMMA_RS_BT(208) MDT_WGMMA_RS_BT(216)
MDT_WGMMA_RS_BT(224) MDT_WGMMA_RS_BT(232) MDT_WGMMA_RS_BT(240)
MDT_WGMMA_RS_BT(248) MDT_WGMMA_RS_BT(256)
#undef MDT_WGMMA_RS_BT

// Byte offset of 16-byte chunk c of row r in 64-column panels of `rows`
// 128-byte swizzled rows each.
__device__ __forceinline__ uint32_t paneled(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128) + swizzled(r, c & 7);
}

// One tile of ROWS rows x CH 16-byte chunks (a K chunk's 8 or V's DN / 8)
// from `src` (row stride ld) into the panels at shared address `dst`,
// untouched, by the 128 producer threads (chunk i = pt + 128 u): chunks
// below `real` of rows below `rows` are copied, the rest up to `need` are
// zeros, the rest left as they are. The caller commits the group.
// (Not unrolled: a thread's chunks of a tile, up to 16, each with its own
// addresses, held across the tile loop would not fit the producer's
// registers.)
template <int ROWS, int CH>
__device__ __forceinline__ void copy_panels(uint32_t dst, const bf16* src,
                                            long ld, int rows, int real,
                                            int need, int pt) {
  constexpr int kItems = ROWS * CH;
#pragma unroll 1
  for (int i = pt; i < kItems; i += 128) {
    const int r = i / CH, c = i % CH;
    if (c < need) {
      const bool valid = r < rows && c < real;
      cp_async16_or_zeros(dst + paneled(r, c, ROWS),
                          src + (valid ? r * ld + c * 8 : 0), valid);
    }
  }
}

// The same for float32 rows, each chunk rounded to bf16 once on its way
// (BATCH chunks' loads in flight at once).
template <int ROWS, int CH, int BATCH>
__device__ __forceinline__ void round_panels(unsigned char* dst,
                                             const float* src, long ld,
                                             int rows, int real, int need,
                                             int pt) {
  constexpr int kItems = ROWS * CH, kPer = (kItems + 127) / 128;
  constexpr int kBatch = BATCH;
#pragma unroll 1
  for (int u0 = 0; u0 < kPer; u0 += kBatch) {
    Chunk8<float> raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = pt + 128 * (u0 + u), r = i / CH, c = i % CH;
      raw[u] = Chunk8<float>{};
      if (u0 + u < kPer && i < kItems && r < rows && c < real)
        raw[u].load(src + r * ld + c * 8);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = pt + 128 * (u0 + u), r = i / CH, c = i % CH;
      if (u0 + u < kPer && i < kItems && c < need) {
        float x[8];
        raw[u].to_float(x);
        *reinterpret_cast<uint4*>(dst + paneled(r, c, ROWS)) = pack8_bf16(x);
      }
    }
  }
}

// The wide tile's consumer steps, each on one warpgroup's 64 rows (rows g
// and g + 8 of each warp's 16, spread over a quad: s[4 nt + 2 r + c] is key
// 8 nt + 2 t + c of row g + 8 r, o[4 nd + 2 r + c] column 8 nd + 2 t + c).
//
// S = Q·Kᵀ for one tile of KN keys, started: P panels of Q (at shared
// address q_s) and K (chunks ik .. ik + P - 1 of the K ring of KS slots at
// k_ring) and STEPS k16 steps, known when compiled, after the tile's P
// chunks have landed; one commit group (`bars`: the K ring's full barriers,
// then its empty ones).
template <int KN, int P, int STEPS>
__device__ __forceinline__ void wide_s_start(float (&s)[KN / 2], uint32_t q_s,
                                             uint32_t k_ring, uint32_t bars,
                                             int ik, int KS) {
  constexpr int kChunk = KN * 128;
#pragma unroll
  for (int c = 0; c < P; ++c)
    mbar_wait(bars + 8 * ((ik + c) % KS), ((ik + c) / KS) & 1);
  fence_proxy_async();  // the copies' writes, before wgmma reads them
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < STEPS; ++st)
    wgmma_ss<KN>(s, wgmma_desc(q_s + (st / 4) * kWdPanelBytes + (st % 4) * 32),
                 wgmma_desc(k_ring + ((ik + st / 4) % KS) * kChunk +
                            (st % 4) * 32),
                 st > 0);
  wgmma_commit();
}

// Once that group is done: the tile's P chunks handed back.
template <int P>
__device__ __forceinline__ void wide_s_done(uint32_t bars, int& ik, int KS,
                                            int lane) {
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < P; ++c)
      mbar_arrive(bars + 8 * (kWdMaxKSlots + (ik + c) % KS));
  }
  ik += P;
}

// The online softmax of one tile of S: keys at or past `keys` (a short
// last tile) weigh nothing; each row's max, and where a row of the warp
// found a new one (returns true) the factor alpha that rescales its sum
// (here) and its O (wide_rescale, by the caller; elsewhere the factor is
// ex2(0) = 1); s becomes p = ex2(s·log2e − m·log2e), summed into l_run.
template <int KN>
__device__ __forceinline__ bool wide_softmax(float (&s)[KN / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], int keys,
                                             int t) {
  constexpr float kLog2e = 1.4426950408889634f;
  if (keys < KN) {
#pragma unroll
    for (int nt = 0; nt < KN / 8; ++nt) {
      const int key = nt * 8 + 2 * t;
      if (key >= keys) s[4 * nt] = s[4 * nt + 2] = -INFINITY;
      if (key + 1 >= keys) s[4 * nt + 1] = s[4 * nt + 3] = -INFINITY;
    }
  }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < KN / 8; ++nt)
      mx[r] = fmaxf(mx[r], fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  const bool moved =
      __any_sync(0xffffffffu, mx[0] > m_run[0] || mx[1] > m_run[1]);
  if (moved) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2_approx((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float shift = m_run[r] * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < KN / 8; ++nt) {
      const float p0 = exp2_approx(fmaf(s[4 * nt + 2 * r], kLog2e, -shift));
      const float p1 = exp2_approx(fmaf(s[4 * nt + 2 * r + 1], kLog2e, -shift));
      s[4 * nt + 2 * r] = p0;
      s[4 * nt + 2 * r + 1] = p1;
      sum += p0 + p1;
    }
    l_run[r] += sum;
  }
  return moved;
}

template <int DN>
__device__ __forceinline__ void wide_rescale(float (&o)[DN / 2],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nd = 0; nd < DN / 8; ++nd) {
      o[4 * nd + 2 * r] *= alpha[r];
      o[4 * nd + 2 * r + 1] *= alpha[r];
    }
}

// P re-packed from the S accumulators as bf16 A fragments.
template <int KN>
__device__ __forceinline__ void wide_pack(const float (&s)[KN / 2],
                                          uint32_t (&pa)[KN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O += P·V on the V tile at shared address vt (panels of KN rows), started
// as one commit group.
template <int DN, int KN>
__device__ __forceinline__ void wide_pv(float (&o)[DN / 2],
                                        const uint32_t (&pa)[KN / 16][4],
                                        uint32_t vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk)
    wgmma_rs_bt<DN>(o, pa[kk], wgmma_desc_lbo(vt + kk * 16 * 128, KN * 128));
  wgmma_commit();
}

// NC consumer warpgroups and one producer: block (NC + 1) x 128, grid
// (ceil(Lq / (64 x active)), ceil(d / DN), B), dynamic shared memory
// wide_smem_bytes of the plan launch_wide makes. Consumer warpgroup w takes
// the 64 query rows of chunk blockIdx.x x active + w (w < active). Q
// streams (q_stream) only in the one-consumer 256-column tile. SPACE: the
// strided layout of WideArgsT, bf16 inputs, the output of type TO.
template <int DN, int NC, typename T, bool SPACE = false, typename TO = T>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
wgmma_wide_kernel(const WideArgsOf<T, SPACE> a) {
  using W = WideTile<DN>;
  constexpr int KN = W::KN;
  constexpr bool kF32 = std::is_same<T, float>::value;
  static_assert(SPACE ? !kF32 : std::is_same<T, TO>::value,
                "SPACE: bf16 inputs; otherwise the output in T");
  static_assert(NC == 1 || NC == 2, "one or two consumer warpgroups");
  // with two consumers: the producer's registers and each consumer's
  // (producer + 2 x consumer = 3 x 168, the block's pool)
  constexpr int kProducerRegs = kF32 ? 72 : 40;
  constexpr int kConsumerRegs = (3 * 168 - kProducerRegs) / 2;
  extern __shared__ unsigned char wd_smem[];
  const uint32_t raw_base = smem_u32(wd_smem);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  unsigned char* sm = wd_smem + (base - raw_base);

  const int d = a.d, dc = d / 8;        // chunks of a row
  const int dkc = (d + 15) / 16 * 2;    // chunks S reads: whole k16 steps
  const int panels = (dkc + 7) / 8;     // 64-dim panels of Q and of K
  constexpr bool kStreamable = NC == 1 && DN == kWdGroup;
  const bool q_stream = kStreamable && a.q_stream;
  // Q's panels in shared memory: all of them, or a ring of four (which also
  // holds the four panels of output the bf16 route stages there)
  const int q_panels = q_stream ? kWdQRing : panels;
  const int col0 = blockIdx.y * DN;     // this block's output columns
  const int vc = min(DN, d - col0) / 8; // of them inside the head, in chunks
  const int KS = a.k_slots, VS = a.v_slots;
  const int nkt = (a.Lk + KN - 1) / KN;
  const int last_rows = a.Lk - (nkt - 1) * KN;  // keys in the last tile
  const uint32_t k_ring = base;
  const uint32_t v_ring = k_ring + KS * W::k_chunk_bytes;
  const uint32_t q_area = v_ring + VS * W::v_slot_bytes;
  const uint32_t bars = q_area + NC * q_panels * kWdPanelBytes;
  auto full_k = [&](int i) { return bars + 8 * i; };
  auto empty_k = [&](int i) { return bars + 8 * (kWdMaxKSlots + i); };
  auto full_v = [&](int i) { return bars + 8 * (2 * kWdMaxKSlots + i); };
  auto empty_v = [&](int i) {
    return bars + 8 * (2 * kWdMaxKSlots + kWdMaxVSlots + i);
  };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q_first = blockIdx.x * a.active * kWdRows;
  // the consumer warpgroups of this block that have rows: lane 0 of each of
  // their warps hands every slot back
  const int busy = min(a.active, (a.Lq - q_first + kWdRows - 1) / kWdRows);
  if (tid == 0) {
    for (int i = 0; i < KS; ++i) {
      mbar_init(full_k(i), 128);  // every producer thread arrives
      mbar_init(empty_k(i), 4 * busy);
    }
    for (int i = 0; i < VS; ++i) {
      mbar_init(full_v(i), 128);
      mbar_init(empty_v(i), 4 * busy);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const long seq = blockIdx.z;
  // the row strides of q, k, v and of the output, and this sequence's
  // offset in them (SPACE: of this frame's head)
  int ld = d, ld_out = d;
  long q_off = seq * a.q_batch, kv_off = seq * a.kv_batch;
  if constexpr (SPACE) {
    ld = a.in_row;
    ld_out = a.out_row;
    q_off = kv_off = seq / a.heads * a.q_batch + seq % a.heads * d;
  }
  const T* qb = a.q + q_off;
  const T* kb = a.k + kv_off;
  const T* vb = a.v + kv_off + col0;

  if (wg == NC) {
    // ------------------------------------------------------ producer
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    const int pt = tid - NC * 128;
    // tile j: its K chunks c = 0 .. panels - 1 (dims 64 c ..), then its V
    // tile (this block's columns); keys past Lk as zeros
    if constexpr (kF32) {
      // through this warpgroup's registers, rounded to bf16 on the way
      constexpr int kF32Batch = 4;
      int ik = 0;
      for (int j = 0; j < nkt; ++j) {
        const int rows = j < nkt - 1 ? KN : last_rows;
        for (int c = 0; c < panels; ++c, ++ik) {
          const int ks = ik % KS;
          mbar_wait(empty_k(ks), ((ik / KS) & 1) ^ 1);
          round_panels<KN, 8, kF32Batch>(sm + ks * W::k_chunk_bytes,
                              kb + (long)j * KN * ld + c * 64, ld, rows,
                              dc - 8 * c, min(8, dkc - 8 * c), pt);
          fence_proxy_async();
          mbar_arrive(full_k(ks));
        }
        const int vs = j % VS;
        mbar_wait(empty_v(vs), ((j / VS) & 1) ^ 1);
        round_panels<KN, DN / 8, kF32Batch>(
            sm + (v_ring - base) + vs * W::v_slot_bytes,
                                 vb + (long)j * KN * ld, ld, rows, vc, vc, pt);
        fence_proxy_async();
        mbar_arrive(full_v(vs));
      }
    } else {
      // cp.async; each thread's copies arrive on the slot's `full` barrier
      // when they land (the consumers fence the async proxy before their
      // products read the slot), so copies for several slots are in flight
      int ik = 0;
      for (int j = 0; j < nkt; ++j) {
        const int rows = j < nkt - 1 ? KN : last_rows;
        for (int c = 0; c < panels; ++c, ++ik) {
          const int ks = ik % KS;
          mbar_wait(empty_k(ks), ((ik / KS) & 1) ^ 1);
          copy_panels<KN, 8>(k_ring + ks * W::k_chunk_bytes,
                             kb + (long)j * KN * ld + c * 64, ld, rows,
                             dc - 8 * c, min(8, dkc - 8 * c), pt);
          cp_async_arrive(full_k(ks));
        }
        const int vs = j % VS;
        mbar_wait(empty_v(vs), ((j / VS) & 1) ^ 1);
        copy_panels<KN, DN / 8>(v_ring + vs * W::v_slot_bytes,
                                vb + (long)j * KN * ld, ld, rows, vc, vc, pt);
        cp_async_arrive(full_v(vs));
      }
      cp_async_wait_all();
    }
    return;
  }

  // ------------------------------------------------------ consumers
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  if (wg >= busy) return;  // no rows for this warpgroup
  const int ct = tid & 127, warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = q_first + wg * kWdRows;
  const uint32_t q_s = q_area + wg * q_panels * kWdPanelBytes;
  unsigned char* q_p = sm + (q_s - base);

  // Q chunks [c_lo, c_hi) of this warpgroup's 64 rows, scaled in fp32 and
  // rounded to bf16 once, into the panels at `dst` (chunk c_lo first);
  // chunks past d and rows past Lq as zeros. Then visible to wgmma.
  auto stage_q = [&](int c_lo, int c_hi, unsigned char* dst) {
    const int cw = c_hi - c_lo, items = kWdRows * cw;
    for (int i0 = ct; i0 < items; i0 += 4 * 128) {
      Chunk8<T> raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 128 * u, r = i / cw, c = c_lo + i % cw;
        raw[u] = Chunk8<T>{};
        if (i < items && c < dc && q0 + r < a.Lq)
          raw[u].load(qb + (long)(q0 + r) * ld + c * 8);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 128 * u, r = i / cw;
        if (i < items) {
          float x[8];
          raw[u].to_float(x);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] *= a.scale;
          *reinterpret_cast<uint4*>(dst + paneled(r, i % cw, kWdRows)) =
              pack8_bf16(x);
        }
      }
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
  };
  if (!q_stream) stage_q(0, dkc, q_p);

  float o[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
  float alpha[2];
  float s[KN / 2];
  uint32_t pa[KN / 16][4];
  int ik = 0;
  auto keys = [&](int j) { return j == nkt - 1 ? last_rows : KN; };
  auto pv = [&](int j) {  // O += P·V for tile j, started
    const int vs = j % VS;
    mbar_wait(full_v(vs), (j / VS) & 1);
    fence_proxy_async();  // the copies' writes, before wgmma reads them
    fence_regs(o);
    wide_pv<DN, KN>(o, pa, v_ring + vs * W::v_slot_bytes);
  };
  auto pv_done = [&](int j) {
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty_v(j % VS));
  };

  if (DN < kWdGroup || d == kWdGroup) {
    // a tile's products at once (wide_s_start), pipelined in the warpgroup:
    // tile j's S = Q·Kᵀ and tile j - 1's O += P·V run while nothing waits,
    // then j's softmax runs while P·V finishes; O is rescaled after it
    constexpr int kSteps = (DN + 15) / 16;
    auto s_start = [&] {
      if constexpr (DN < kWdGroup)
        wide_s_start<KN, (kSteps + 3) / 4, kSteps>(s, q_s, k_ring, bars, ik,
                                                   KS);
      else
        wide_s_start<KN, 4, 16>(s, q_s, k_ring, bars, ik, KS);
    };
    auto s_done = [&] {
      fence_regs(s);
      wide_s_done<(DN < kWdGroup ? (kSteps + 3) / 4 : 4)>(bars, ik, KS, lane);
    };
    s_start();
    wgmma_wait<0>();
    s_done();
    wide_softmax<KN>(s, m_run, l_run, alpha, keys(0), t);  // O is zeros
    wide_pack<KN>(s, pa);
    for (int j = 1; j < nkt; ++j) {
      s_start();
      pv(j - 1);
      wgmma_wait<1>();  // S of tile j
      s_done();
      const bool moved = wide_softmax<KN>(s, m_run, l_run, alpha, keys(j), t);
      wgmma_wait<0>();  // P·V of tile j - 1
      pv_done(j - 1);
      if (moved) wide_rescale<DN>(o, alpha);
      wide_pack<KN>(s, pa);
    }
    pv(nkt - 1);
    wgmma_wait<0>();
    pv_done(nkt - 1);
  } else {
    // any number of panels (a head past 256 dims), a commit group per
    // chunk; the chunk before is handed back once its products are done.
    // Q's panels stream through their ring here where q_stream.
    for (int j = 0; j < nkt; ++j) {
      for (int c = 0; c < panels; ++c, ++ik) {
        const int ks = ik % KS;
        mbar_wait(full_k(ks), (ik / KS) & 1);
        fence_proxy_async();
        const uint32_t kt = k_ring + ks * W::k_chunk_bytes;
        uint32_t qt = q_s + c * kWdPanelBytes;
        if constexpr (kStreamable) {
          if (q_stream) {
            // panel c into ring slot c mod 4, once every warp has waited
            // for the products of all but the last panel
            qt = q_s + (c % kWdQRing) * kWdPanelBytes;
            bar_sync(1 + wg, 128);
            stage_q(8 * c, min(8 * c + 8, dkc), sm + (qt - base));
          }
        }
        const int steps = min(4, dkc / 2 - 4 * c);
        wgmma_fence();
        if (steps == 4) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<KN>(s, wgmma_desc(qt + kk * 32),
                         wgmma_desc(kt + kk * 32), c > 0 || kk > 0);
        } else {
          for (int kk = 0; kk < steps; ++kk)
            wgmma_ss<KN>(s, wgmma_desc(qt + kk * 32),
                         wgmma_desc(kt + kk * 32), c > 0 || kk > 0);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty_k((ik - 1) % KS));
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k((ik - 1) % KS));
      if (wide_softmax<KN>(s, m_run, l_run, alpha, keys(j), t))
        wide_rescale<DN>(o, alpha);
      wide_pack<KN>(s, pa);
      pv(j);
      wgmma_wait<0>();
      pv_done(j);
    }
  }

  // finish the row sums across the quad; store the columns inside the head
  // of the rows below Lq
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  long o_off = seq * a.q_batch;
  if constexpr (SPACE)
    o_off = seq / a.heads * a.out_batch + seq % a.heads * d;
  TO* ob = reinterpret_cast<TO*>(a.out) + o_off + col0;
  if constexpr (std::is_same<TO, float>::value) {
    // float32 straight from the fragments: a quad's four 8-byte stores fill
    // one 32-byte sector of a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < a.Lq) {
#pragma unroll
        for (int nd = 0; nd < DN / 8; ++nd)
          if (nd < vc)
            *reinterpret_cast<float2*>(ob + (long)row * ld_out + nd * 8 +
                                       2 * t) =
                make_float2(o[4 * nd + 2 * r] * inv[r],
                            o[4 * nd + 2 * r + 1] * inv[r]);
      }
    }
  } else {
    // through this warpgroup's Q panels (its products are done), then 16
    // bytes per lane on neighbouring addresses
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int nd = 0; nd < DN / 8; ++nd)
        if (nd < vc)
          *reinterpret_cast<uint32_t*>(q_p + paneled(row, nd, kWdRows) +
                                       4 * t) =
              pack_bf16(o[4 * nd + 2 * r] * inv[r],
                        o[4 * nd + 2 * r + 1] * inv[r]);
    }
    bar_sync(1 + wg, 128);
    for (int i = ct; i < kWdRows * vc; i += 128) {
      const int r = i / vc, c = i % vc;
      if (q0 + r < a.Lq)
        *reinterpret_cast<uint4*>(ob + (long)(q0 + r) * ld_out + c * 8) =
            *reinterpret_cast<const uint4*>(q_p + paneled(r, c, kWdRows));
    }
  }
}

// The plan for NC consumers with Q's `q_panels` panels resident (or, with
// q_stream, a ring of them): the deepest V ring (3, else 2 tiles) beside
// which at least three K chunks fit, then as many K chunks as fit (up to
// three tiles' worth); the rows per block (64 x active) the most whose grid
// still fills the card. Returns cudaErrorInvalidValue where no plan fits.
template <int DN, int NC, typename T, bool SPACE = false, typename TO = T>
cudaError_t launch_wide_plan(WideArgsOf<T, SPACE> a, int B, int q_panels,
                             int q_stream, cudaStream_t stream) {
  using W = WideTile<DN>;
  const int panels = ((a.d + 15) / 16 * 16 + 63) / 64;
  int smem = 0;
  for (int vs = kWdMaxVSlots; vs >= 2 && !smem; --vs) {
    const int room = kWgSmemLimit - wide_smem_bytes(W::k_chunk_bytes,
                                                    W::v_slot_bytes, NC,
                                                    q_panels, 0, vs);
    const int ks = min(min(kWdMaxKSlots, 3 * panels), room / W::k_chunk_bytes);
    // at least three chunks, and a whole tile's where a tile's products
    // run at once (heads up to 256: s_tile)
    if (ks >= 3 && (a.d > kWdGroup || ks >= panels)) {
      a.k_slots = ks;
      a.v_slots = vs;
      smem = wide_smem_bytes(W::k_chunk_bytes, W::v_slot_bytes, NC, q_panels,
                             ks, vs);
    }
  }
  if (!smem) return cudaErrorInvalidValue;
  a.q_stream = q_stream;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kern = wgmma_wide_kernel<DN, NC, T, SPACE, TO>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.d + DN - 1) / DN;
  a.active = NC;
  if (NC == 2 &&
      (long)B * groups * ((a.Lq + 2 * kWdRows - 1) / (2 * kWdRows)) <
          sms - sms / 8)
    a.active = 1;
  const int rows = a.active * kWdRows;
  dim3 grid((a.Lq + rows - 1) / rows, groups, B);
  kern<<<grid, (NC + 1) * 128, smem, stream>>>(a);
  return cudaGetLastError();
}

// Two consumers where the rings fit beside their Q; else (a head past 512
// dims, one group of 256 columns a block) one, with Q resident up to
// kWdMaxResidentDim and streamed past it. SPACE and TO as the kernel's.
template <int DN, typename T, bool SPACE = false, typename TO = T>
cudaError_t launch_wide(const WideArgsOf<T, SPACE>& a, int B,
                        cudaStream_t stream) {
  const int panels = ((a.d + 15) / 16 * 16 + 63) / 64;
  cudaError_t err =
      launch_wide_plan<DN, 2, T, SPACE, TO>(a, B, panels, 0, stream);
  if constexpr (DN == kWdGroup) {
    if (err == cudaErrorInvalidValue)
      err = launch_wide_plan<DN, 1, T>(a, B, panels, 0, stream);
    if (err == cudaErrorInvalidValue)
      err = launch_wide_plan<DN, 1, T>(a, B, kWdQRing, 1, stream);
  }
  return err;
}

// The one-pass and K-blocked fused kernels (q [B, Nq, D] over k, v
// [B, Nk, D], contiguous) at the head dims flash_wide{,_f32}.cu build: each
// D % 8 == 0 from 40 to 256 but 64 a tile of its own (in bf16 from 72),
// and past 256 the tile of 256 columns in groups.
template <typename T>
cudaError_t launch_fused_wide(const void* q, const void* k, const void* v,
                              void* out, int B, int Nq, int Nk, int D,
                              float scale, cudaStream_t stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || D < 8 || D % 8)
    return cudaErrorInvalidValue;
  const WideArgsT<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(out),
                       (long)Nq * D, (long)Nk * D, D, Nq, Nk, scale,
                       0, 0, 0, 0};
  if (D > kWdGroup) return launch_wide<kWdGroup, T>(a, B, stream);
  // bf16 runs 40, 48 and 56 on the narrow tile (wgmma_narrow.cuh), which
  // was faster there: float32 only
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 40: return launch_wide<40, T>(a, B, stream);
      case 48: return launch_wide<48, T>(a, B, stream);
      case 56: return launch_wide<56, T>(a, B, stream);
    }
  }
  switch (D) {
    case 72: return launch_wide<72, T>(a, B, stream);
    case 80: return launch_wide<80, T>(a, B, stream);
    case 88: return launch_wide<88, T>(a, B, stream);
    case 96: return launch_wide<96, T>(a, B, stream);
    case 104: return launch_wide<104, T>(a, B, stream);
    case 112: return launch_wide<112, T>(a, B, stream);
    case 120: return launch_wide<120, T>(a, B, stream);
    case 128: return launch_wide<128, T>(a, B, stream);
    case 136: return launch_wide<136, T>(a, B, stream);
    case 144: return launch_wide<144, T>(a, B, stream);
    case 152: return launch_wide<152, T>(a, B, stream);
    case 160: return launch_wide<160, T>(a, B, stream);
    case 168: return launch_wide<168, T>(a, B, stream);
    case 176: return launch_wide<176, T>(a, B, stream);
    case 184: return launch_wide<184, T>(a, B, stream);
    case 192: return launch_wide<192, T>(a, B, stream);
    case 200: return launch_wide<200, T>(a, B, stream);
    case 208: return launch_wide<208, T>(a, B, stream);
    case 216: return launch_wide<216, T>(a, B, stream);
    case 224: return launch_wide<224, T>(a, B, stream);
    case 232: return launch_wide<232, T>(a, B, stream);
    case 240: return launch_wide<240, T>(a, B, stream);
    case 248: return launch_wide<248, T>(a, B, stream);
    case 256: return launch_wide<256, T>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace mdt
