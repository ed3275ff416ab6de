// Attention of Lq query rows over Lk keys at head dims 16 and 32.
//
// Shared by the packed-head attention kernel (packed_attention.cu: a head is
// a 16-column slice of each third of a packed [B, L, 3·H·16] row), the
// one-pass kernel at D = 16 and 32 (flash_attention.cu: contiguous
// [B, N, D] tensors; both with Lq = Lk) and the K-blocked fused kernel at
// D = 16 and 32 (flash_attention.cu: q [B, Nq, D] over k, v [B, Nk, D]).
// q of (sequence b, head h, row r) sits at q + b·q_batch + h·head +
// r·in_row, k and v at ptr + b·kv_batch + h·head + r·in_row, the output at
// out + b·out_batch + h·head + r·out_row.
//
// What bounds it: per score the tensor cores do 4·DH FLOPs (64 at DH = 16),
// but the SM must also do one ex2 (16 per clock per SM) and an fp32
// multiply-add, max, add and half a pack, so the softmax, not the products,
// is the floor: 16 x 2048² scores / (132 SMs x 16 per clock) = 32k clocks,
// 0.016 ms at 1980 MHz, four times the card's operations bound. The whole
// problem is some 2048 warps of work, four to a scheduler, so there is no
// occupancy to hide a warp's latencies behind: what counts is instructions
// and waits per score. The port's first tile (since retired) ran 3.5 times
// over that floor: 64 query rows per block, so every head's K and V were
// staged L / 64 times, through fp32 registers, with V transposed by 2-byte
// stores, nothing in flight behind the compute, and two 4-byte shared loads
// per product step. This tile:
//
//  * K and V go from device memory to shared memory untouched, as 16-byte
//    cp.async chunks, into a ring of kShStages slots of 128 keys, kShAhead
//    tiles ahead of the one in use. The warps take the copying in turns
//    (tile t is the duty of warp t mod warps: two or four cp.async per lane
//    and tensor), so no warp and no register is set aside for it: a producer
//    warp beside 16 others makes 544 threads, which get 96 registers each
//    and spill. A slot is handed over by a pair of mbarriers: the copies
//    arrive on `full` when they land (cp.async.mbarrier.arrive), every warp
//    arrives on `empty` after its last read. No block-wide barrier in the
//    loop.
//  * rows are 32 or 64 bytes, so eight rows of one 16-byte column would fall
//    on two or four banks; chunk c of row r is stored at chunk
//    c ^ (r / (8 / CH) mod CH) (CH chunks per row), which spreads every
//    ldmatrix phase over all 32 banks.
//  * fragments come from ldmatrix.x4: K as it lies (rows are keys), V through
//    .trans, so V is never transposed by hand. Q is read once per warp,
//    straight from device memory into A fragments (scaled in fp32, rounded to
//    bf16 once); it never sees shared memory.
//  * a block has up to 16 warps of 16 query rows each. The launcher takes the
//    most rows per block (256, 128 or 64) whose grid still fills the card, so
//    K and V are staged L / 256 times per head at the main path's B = 2 and
//    L / 128 times at B = 1.
//  * the softmax works on 128-key tiles (the cross-lane max is paid per 128
//    keys), p = ex2(s·log2e − m·log2e) is one multiply-add and one ex2 with
//    log2e applied to the fp32 scores, and the output and the row sum are
//    rescaled only in tiles where some row of the warp found a new max.
//  * a ragged last key tile (any Lk; the packed gate admits L % 8 == 0, the
//    fused one Nk < 128) is filled with zeros by the copies and masked to
//    -inf in the scores; query rows past Lq compute on zeros and are not
//    stored. The grid and the rows per block follow Lq, the tiles Lk.
//
// Products stay on mma.sync. Both were also built on wgmma (S as
// m64n128k16 on the K tile, whose hand swizzle is wgmma's 32- and 64-byte
// swizzle; P·V as m64n16k16 / m64n32k16 on V as the MN-major operand): right
// at once, 12 % slower at DH = 16 and 5 % faster at DH = 32, since a warp is
// held while its product runs and four warps then move as one. Also tried
// and not kept (times in PERF.md): a producer warpgroup with setmaxnreg (a
// block's register pool is what it was launched with: it hangs), handing
// the ex2 part of the softmax round a scheduler's warps in turns (slower),
// 64-key softmax steps with the next scores started ahead (equal), deeper
// rings (equal), 128 rows per block at B = 2 (slower).
//
// Rounding points are the TPU kernels': q·scale rounded to bf16 once, fp32
// scores, max and sum, P rounded to bf16 for P·V, the output divided by the
// fp32 row sum.
#pragma once

#include "ptx.cuh"

namespace mdt {

constexpr int kShTile = 128;    // keys per tile
constexpr int kShStages = 4;    // ring slots, each one K and one V tile
constexpr int kShAhead = 2;     // tiles in flight ahead of the one in use
constexpr int kShMaxWarps = 16; // warps per block: 256 query rows

struct SmallHeadArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  long q_batch, kv_batch, in_row, out_batch, out_row;  // element strides
  int head;  // column offset of one head, inputs and output
  int Lq, Lk;  // query rows, keys
  float scale;
};

template <int DH>
struct SmallHead {
  static_assert(DH == 16 || DH == 32, "rows of two or four 16-byte chunks");
  static constexpr int CH = DH / 8;                    // chunks per row
  static constexpr int row_bytes = DH * 2;
  static constexpr int tile_bytes = kShTile * row_bytes;  // one K or V tile
  static constexpr int stage_bytes = 2 * tile_bytes;
  // tiles, then the mbarriers: full and empty per slot
  static constexpr int smem_bytes =
      kShStages * stage_bytes + 2 * kShStages * 8;

  // Byte offset of 16-byte chunk c of row r in a swizzled tile.
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    return (uint32_t)(r * row_bytes + ((c ^ ((r / (8 / CH)) & (CH - 1))) << 4));
  }
};

// grid (ceil(Lq / (16 x warps)), H, B), block warps x 32 (4, 8 or 16 warps).
// Dynamic shared memory SmallHead<DH>::smem_bytes. SELF: Lk = Lq and
// kv_batch = q_batch (the packed and one-pass kernels), known when compiled:
// with the two lengths and offsets kept apart, DH = 32 spills 8 bytes more
// and its one-pass rows ran 3 % slower on an H100.
template <int DH, bool SELF>
__global__ void __launch_bounds__(kShMaxWarps * 32, 1)
smallhead_attention_kernel(const SmallHeadArgs a) {
  using S = SmallHead<DH>;
  constexpr int CH = S::CH;
  extern __shared__ __align__(128) unsigned char sh_smem[];
  const uint32_t base = smem_u32(sh_smem);
  const uint32_t bars = base + kShStages * S::stage_bytes;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kShStages + i); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;  // warps
  if (tid == 0) {
    for (int i = 0; i < kShStages; ++i) {
      mbar_init(full(i), 32);   // the copies of every lane of the warp on duty
      mbar_init(empty(i), nw);  // lane 0 of every warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int h = blockIdx.y, b = blockIdx.z;
  const long q_off = b * a.q_batch + (long)h * a.head;
  const long kv_off = b * (SELF ? a.q_batch : a.kv_batch) + (long)h * a.head;
  const int Lq = a.Lq, Lk = SELF ? a.Lq : a.Lk;
  const int tiles = (Lk + kShTile - 1) / kShTile;

  // Tile tt into its slot, by the whole calling warp: chunk i = lane + 32 u
  // is chunk i % CH of key i / CH. The copies arrive on the slot's `full`
  // barrier when they have landed.
  auto stage = [&](int tt) {
    const int slot = tt % kShStages;
    mbar_wait(empty(slot), ((tt / kShStages) & 1) ^ 1);
    const bf16* kb = a.k + kv_off + (lane % CH) * 8;
    const bf16* vb = a.v + kv_off + (lane % CH) * 8;
    const uint32_t kdst = base + slot * S::stage_bytes;
    const uint32_t vdst = kdst + S::tile_bytes;
#pragma unroll
    for (int u = 0; u < kShTile * CH / 32; ++u) {
      const int r = (lane + 32 * u) / CH, key = tt * kShTile + r;
      const bool valid = key < Lk;
      const long src = (long)(valid ? key : 0) * a.in_row;
      const uint32_t off = S::offset(r, lane % CH);
      cp_async16_or_zeros(kdst + off, kb + src, valid);
      cp_async16_or_zeros(vdst + off, vb + src, valid);
    }
    cp_async_arrive(full(slot));
  };
  if (warp < kShAhead && warp < tiles) stage(warp);  // the first tiles

  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (blockIdx.x * nw + warp) * 16;

  // Q: this warp's 16 rows as A fragments, scaled and rounded to bf16 once
  uint32_t qa[DH / 16][4];
  {
    const bf16* qb = a.q + q_off + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + g + 8 * (j & 1), col = kk * 16 + 8 * (j >> 1);
        uint32_t raw = 0;
        if (row < Lq)
          raw = *reinterpret_cast<const uint32_t*>(qb + row * a.in_row + col);
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&raw);
        qa[kk][j] = pack_bf16(__low2float(x) * a.scale,
                              __high2float(x) * a.scale);
      }
  }

  // per-lane row addresses of the ldmatrix loads inside a tile: lane 8i + r
  // gives row r of matrix i
  const int mi = lane >> 3, mr = lane & 7;
  // K: 4 / CH score tiles of 8 keys per load, all CH chunks of each
  constexpr int KPL = 8 * (4 / CH);
  const uint32_t k_lane = S::offset((mi / CH) * 8 + mr, mi % CH);
  // V (transposed on the way): 16 keys x 16 dims per load
  uint32_t v_lane[CH / 2];
#pragma unroll
  for (int hh = 0; hh < CH / 2; ++hh)
    v_lane[hh] = S::offset((mi & 1) * 8 + mr, 2 * hh + (mi >> 1));

  constexpr float kLog2e = 1.4426950408889634f;
  float o[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int t = 0; t < tiles; ++t) {
    // the warps take the copying in turns: tile t + kShAhead is this warp's
    // when its number says so
    if (t + kShAhead < tiles && (t + kShAhead) % nw == warp)
      stage(t + kShAhead);
    const int slot = t % kShStages;
    mbar_wait(full(slot), (t / kShStages) & 1);
    const uint32_t kt = base + slot * S::stage_bytes;
    const uint32_t vt = kt + S::tile_bytes;

    // S = Q·Kᵀ: this warp's 16 rows x 128 keys, 16 score tiles of 8 keys
    float s[kShTile / 8][4];
#pragma unroll
    for (int u = 0; u < kShTile / KPL; ++u) {
      uint32_t kf[4];
      ldmatrix_x4(kf, kt + u * KPL * S::row_bytes + k_lane);
#pragma unroll
      for (int n = 0; n < 4 / CH; ++n) {
        float(&acc)[4] = s[u * (4 / CH) + n];
        acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          mma_16816(acc, qa[kk], kf[n * CH + 2 * kk], kf[n * CH + 2 * kk + 1]);
      }
    }
    if ((t + 1) * kShTile > Lk) {  // ragged last tile: keys past Lk weigh nothing
#pragma unroll
      for (int nt = 0; nt < kShTile / 8; ++nt) {
        const int key = t * kShTile + nt * 8 + 2 * t4;
        if (key >= Lk) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= Lk) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }

    // online softmax; rows g (r = 0) and g + 8 (r = 1), each spread over a
    // quad
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kShTile / 8; ++nt)
        mx[r] = fmaxf(mx[r], fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (__any_sync(0xffffffffu, mx[0] > m_run[0] || mx[1] > m_run[1])) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], mx[r]);
        const float alpha = exp2_approx((m_run[r] - m_new) * kLog2e);
        m_run[r] = m_new;
        l_run[r] *= alpha;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
          o[nd][2 * r] *= alpha;
          o[nd][2 * r + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float shift = m_run[r] * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kShTile / 8; ++nt) {
        const float p0 = exp2_approx(fmaf(s[nt][2 * r], kLog2e, -shift));
        const float p1 = exp2_approx(fmaf(s[nt][2 * r + 1], kLog2e, -shift));
        s[nt][2 * r] = p0;
        s[nt][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] += sum;
    }

    // O += P·V, P re-packed from the S accumulators as bf16 A fragments
#pragma unroll
    for (int j = 0; j < kShTile / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int hh = 0; hh < CH / 2; ++hh) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + j * 16 * S::row_bytes + v_lane[hh]);
        mma_16816(o[2 * hh], pa, vf[0], vf[1]);
        mma_16816(o[2 * hh + 1], pa, vf[2], vf[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(slot));
  }

  // finish the row sums across the quad and write the head-merged output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = q0 + g + 8 * r;
    if (row < Lq) {
      const float inv = 1.f / l_run[r];
      bf16* dst = a.out + b * a.out_batch + row * a.out_row +
                  (long)h * a.head + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_bf16(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
    }
  }
}

// B sequences of H heads. The one copy of the plan: the most query rows per
// block (the fewest stagings of a head's K and V) whose grid still fills the
// card, from 256 down to 64, counted from Lq; the SELF instantiation where
// the query and key lengths and batch strides agree.
template <int DH>
cudaError_t launch_smallhead(const SmallHeadArgs& args, int B, int H,
                             cudaStream_t stream) {
  if (args.Lq < 1 || args.Lk < 1 || B < 1 || H < 1)
    return cudaErrorInvalidValue;
  auto kern = args.Lq == args.Lk && args.q_batch == args.kv_batch
                  ? smallhead_attention_kernel<DH, true>
                  : smallhead_attention_kernel<DH, false>;
  constexpr int smem = SmallHead<DH>::smem_bytes;
  // asked on every launch: a function-local static of a template is one
  // object for all the libraries of a process that instantiate it
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  auto blocks = [&](int warps) {
    return (long)B * H * ((args.Lq + 16 * warps - 1) / (16 * warps));
  };
  int warps = kShMaxWarps;
  while (warps > 4 && blocks(warps) < sms - sms / 8) warps /= 2;
  dim3 grid((args.Lq + 16 * warps - 1) / (16 * warps), H, B);
  kern<<<grid, warps * 32, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace mdt
