// Attention of Lq query rows over Lk keys at head dims 40, 48 and 56, bf16,
// on Hopper's warpgroup tensor cores: the one-pass kernel (Lq = Lk), which
// replaces _onepass_kernel of moditalker_tpu/ops/pallas/flash_attention.py,
// and the K-blocked fused kernel (Lq query rows over Lk keys), which
// replaces _attn_kernel of the same file, at these widths
// (flash_narrow.cu; contiguous [B, N, d] tensors). At [16, 2048, 48] the
// work is 12.9 GFLOP on 12.6 MB: bound by operations, and by the softmax's
// ex2 (16 a clock an SM) as much as by the products.
//
// Before this tile these widths ran on the small-head tile's class 64
// (mma.sync, every row padded to 64 columns in both products), which the
// wgmma tile built per width (wgmma_wide.cuh: Q in shared memory, K and V
// always streamed) did not beat in bf16. This is the plan of the D = 64
// tile (wgmma_tile.cuh, without the rotary) at the head's own width:
//
//  * Q stays in registers as the A operand of S = Q·Kᵀ (m64n128k16), K and
//    V go into the D = 64 tile's 128-byte swizzled tiles of 128 rows of 64
//    columns by cp.async. Nothing is padded in device memory: a row's d / 8
//    chunks are copied, and where d % 16 == 8 (40, 56) the one chunk past
//    d that S's last k16 step reads is zeros in shared memory (written once
//    per K slot, before the first copy; copies never touch it). Nothing
//    past d is stored.
//  * S runs ceil(d / 16) k16 steps (3 at 40 and 48, 4 at 56), and
//    O += P·V is m64ndk16 (n = 40, 48, 56) with V read as the MN-major B
//    operand from its row-major tile: no padded P·V columns.
//  * up to 1152 keys K stays resident (every K tile a slot of its own,
//    copied once per block before the roles split); past that K streams
//    through a ring of three slots beside the V ring. Either way two
//    consumer warpgroups take 64 query rows each: three, the D = 64 tile's
//    plan with K resident, left a quarter of the card idle at [16, 1024, d]
//    (192-row blocks) and, at 128 registers, spilled the pipelined loop
//    below. The producer only issues cp.async and keeps 40 registers; the
//    consumers get 232. Each thread's copies arrive on their slot's barrier
//    when they land (cp.async.mbarrier.arrive), so copies of every free slot
//    are in flight while the tensor cores work.
//  * the consumers pipeline a warpgroup's tiles (the wide tile's order):
//    tile j's S and tile j - 1's P·V are started together, j's softmax
//    runs while P·V finishes, and O is rescaled once it has. (The D = 64
//    tile's order, S, softmax, P·V in turn, read 0.97-1.08x this one, no
//    winner, and went.)
//  * the edges are the D = 64 tile's: a ragged last 64-row query chunk
//    reads zeros past Lq and stores only the rows below it; a short last
//    key tile (Lk < 128, the one the fused gate admits) is zero-filled past
//    Lk by its copies and its scores there set to -inf before the max.
//
// Rounding points are the TPU kernel's: q·scale rounded to bf16 once, fp32
// scores, max and sums, P rounded to bf16 for P·V, the output divided by
// the fp32 row sum.
#pragma once

#include "wgmma_wide.cuh"

namespace mdt {

template <int D>
struct NarrowTile {
  // 40, 48 and 56 (flash_narrow.cu); 64 only to be timed against the D = 64
  // tile (tools/ab_classes.py --narrow)
  static_assert(D % 8 == 0 && D >= 40 && D <= 64, "head dims 40 to 64");
  static constexpr int CH = D / 8;              // 16-byte chunks of a row
  static constexpr int STEPS = (D + 15) / 16;   // k16 steps of S
  static constexpr int SCH = 2 * STEPS;         // chunks S reads
};

struct NarrowArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  int Lq, Lk;
  float scale;
  // set by launch_narrow
  int k_slots;  // ceil(Lk / 128): resident K; fewer: a ring
  int rounds;   // steps of 128 query rows a block walks
};

// Rows [0, 128) of a tile of D-wide rows starting at `src` (contiguous, so
// chunk i of the tile is i·8 elements on) into the swizzled tile at shared
// address `dst`: chunk i = t + 128 u of the 128 threads t, rows at or past
// `rows` zero-filled. The caller commits or arrives.
template <int D>
__device__ __forceinline__ void narrow_copy(uint32_t dst, const bf16* src,
                                            int t, int rows) {
  constexpr int CH = NarrowTile<D>::CH;
#pragma unroll
  for (int u = 0; u < CH; ++u) {
    const int i = t + 128 * u, r = i / CH, c = i % CH;
    const bool valid = r < rows;
    cp_async16_or_zeros(dst + swizzled(r, c), src + (valid ? i * 8 : 0),
                        valid);
  }
}

// Two consumer warpgroups and one producer: block 3 x 128, grid
// (ceil(Lq / 128 / rounds), 1, B), dynamic shared memory
// wgmma_smem_bytes(k_slots, 2). Consumer warpgroup w takes the 64 query
// rows of chunk (blockIdx.x x rounds + round) x 2 + w in each round; a
// chunk past the sequence end is idle but keeps the ring's handshakes.
constexpr int kNwConsumers = 2;

template <int D>
__global__ void __launch_bounds__((kNwConsumers + 1) * 128, 1)
wgmma_narrow_kernel(const NarrowArgs a) {
  using Tl = NarrowTile<D>;
  constexpr int CH = Tl::CH, STEPS = Tl::STEPS, SCH = Tl::SCH;
  constexpr int NC = kNwConsumers;
  extern __shared__ unsigned char nw_smem[];
  const uint32_t raw_base = smem_u32(nw_smem);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  unsigned char* sm = nw_smem + (base - raw_base);

  const int KS = a.k_slots;
  const int nkt = (a.Lk + kWgTile - 1) / kWgTile;
  const bool streamed = KS < nkt;
  const int last_rows = a.Lk - (nkt - 1) * kWgTile;  // keys in the last tile
  const uint32_t k_tiles = base;
  const uint32_t v_tiles = base + KS * kWgTileBytes;
  const int q_off = (KS + kWgVStages) * kWgTileBytes;
  const uint32_t bars = base + q_off + NC * kWgQBytes;
  auto full_k = [&](int i) { return bars + 8 * i; };
  auto empty_k = [&](int i) { return bars + 8 * (kWgMaxKSlots + i); };
  auto full_v = [&](int i) { return bars + 8 * (2 * kWgMaxKSlots + i); };
  auto empty_v = [&](int i) {
    return bars + 8 * (2 * kWgMaxKSlots + kWgVStages + i);
  };

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < kWgMaxKSlots; ++i) {
      mbar_init(full_k(i), 128);      // every producer thread's copies land
      mbar_init(empty_k(i), 4 * NC);  // lane 0 of every consumer warp
    }
    for (int i = 0; i < kWgVStages; ++i) {
      mbar_init(full_v(i), 128);
      mbar_init(empty_v(i), 4 * NC);
    }
    mbar_init_fence();
  }

  const long b = blockIdx.z;
  const bf16* qb = a.q + b * a.Lq * (long)D;
  const bf16* kb = a.k + b * a.Lk * (long)D;
  const bf16* vb = a.v + b * a.Lk * (long)D;
  bf16* ob = a.out + b * a.Lq * (long)D;

  if constexpr (D % 16 == 8) {
    // the chunk past d that S's last k16 step reads: zeros in every K slot
    for (int i = tid; i < KS * kWgTile; i += (NC + 1) * 128)
      st_shared16(k_tiles + (i / kWgTile) * kWgTileBytes +
                      swizzled(i % kWgTile, CH),
                  make_uint4(0u, 0u, 0u, 0u));
  }
  if (!streamed) {
    // resident K: the warpgroups copy its tiles into their slots in turn
    for (int j = wg; j < nkt; j += NC + 1)
      narrow_copy<D>(k_tiles + j * kWgTileBytes, kb + (long)j * kWgTile * D,
                     tid & 127, j < nkt - 1 ? kWgTile : last_rows);
    cp_async_wait_all();
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = tid - NC * 128;
    int it = 0;
    for (int round = 0; round < a.rounds; ++round) {
      for (int j = 0; j < nkt; ++j, ++it) {
        if (streamed) {  // the ring takes whole tiles only
          const int ks = it % KS;
          mbar_wait(empty_k(ks), ((it / KS) & 1) ^ 1);
          narrow_copy<D>(k_tiles + ks * kWgTileBytes,
                         kb + (long)j * kWgTile * D, pt, kWgTile);
          cp_async_arrive(full_k(ks));
        }
        const int vs = it % kWgVStages;
        mbar_wait(empty_v(vs), ((it / kWgVStages) & 1) ^ 1);
        narrow_copy<D>(v_tiles + vs * kWgTileBytes, vb + (long)j * kWgTile * D,
                       pt, j < nkt - 1 ? kWgTile : last_rows);
        cp_async_arrive(full_v(vs));
      }
    }
    cp_async_wait_all();
    return;
  }

  // ------------------------------------------------------ consumers
  // 40 + 2 x 232 = 3 x 168, the block's registers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
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
    // Q: the row's chunks times the scale, rounded to bf16 once, then the
    // chunk past d (d % 16 == 8) and rows past Lq as zeros
    {
      Chunk8<bf16> raw[STEPS];
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int i = ct + 128 * u, r = i / SCH, c = i % SCH;
        raw[u] = Chunk8<bf16>{};
        if (c < CH && q0 + r < a.Lq) raw[u].load(qb + (long)(q0 + r) * D + c * 8);
      }
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int i = ct + 128 * u, r = i / SCH, c = i % SCH;
        float x[8];
        raw[u].to_float(x);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] *= a.scale;
        *reinterpret_cast<uint4*>(q_s + r * kWgQStride + c * 8) = pack8_bf16(x);
      }
    }
    bar_sync(1 + wg, 128);
    uint32_t qa[STEPS][4];
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      const bf16* p0 = q_s + (warp * 16 + g) * kWgQStride + kk * 16 + 2 * t;
      const bf16* p1 = p0 + 8 * kWgQStride;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
    float alpha[2] = {1.f, 1.f};
    float s[64];
    uint32_t pa[kWgTile / 16][4];
    const int it0 = it;

    // S = Q·Kᵀ for tile j (this warpgroup's 64 rows x 128 keys), started
    auto s_start = [&](int j) {
      const int ks = streamed ? (it0 + j) % KS : j;
      if (streamed) {
        mbar_wait(full_k(ks), ((it0 + j) / KS) & 1);
        fence_proxy_async();  // the copies' writes, before wgmma reads them
      }
      const uint32_t kt = k_tiles + ks * kWgTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk)
        wgmma_m64n128k16(s, qa[kk], wgmma_desc(kt + kk * 32), kk > 0);
      wgmma_commit();
    };
    // once S of tile j is done: its K slot handed back, keys past Lk masked
    auto s_done = [&](int j) {
      fence_regs(s);
      if (streamed && lane == 0) mbar_arrive(empty_k((it0 + j) % KS));
      if (j == nkt - 1 && last_rows < kWgTile) {
        // s[4 nt + 2 r + c] is key 8 nt + 2 t + c of row g + 8 r
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int key = nt * 8 + 2 * t;
          if (key >= last_rows) s[4 * nt] = s[4 * nt + 2] = -INFINITY;
          if (key + 1 >= last_rows) s[4 * nt + 1] = s[4 * nt + 3] = -INFINITY;
        }
      }
    };
    // the online softmax of S: rows g (r = 0) and g + 8 (r = 1) of this
    // warp's 16, each spread over a quad; s becomes p, alpha the factor
    // that rescales what earlier tiles summed
    auto softmax = [&] {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
          mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        alpha[r] = exp2_approx((m_run[r] - m_new) * kLog2e);
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
        l_run[r] = l_run[r] * alpha[r] + sum;
        m_run[r] = m_new;
      }
    };
    auto rescale = [&] {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          o[4 * nd + 2 * r] *= alpha[r];
          o[4 * nd + 2 * r + 1] *= alpha[r];
        }
    };
    // P re-packed from the S accumulators as bf16 A fragments
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < kWgTile / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // O += P·V for tile j, started
    auto pv_start = [&](int j) {
      const int vs = (it0 + j) % kWgVStages;
      mbar_wait(full_v(vs), ((it0 + j) / kWgVStages) & 1);
      fence_proxy_async();
      const uint32_t vt = v_tiles + vs * kWgTileBytes;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgTile / 16; ++kk)
        wgmma_rs_bt<D>(o, pa[kk], wgmma_desc(vt + kk * 16 * 128));
      wgmma_commit();
    };
    auto pv_done = [&](int j) {
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v((it0 + j) % kWgVStages));
    };

    s_start(0);
    wgmma_wait<0>();
    s_done(0);
    softmax();  // O is zeros: nothing to rescale
    pack();
    for (int j = 1; j < nkt; ++j) {
      s_start(j);
      pv_start(j - 1);
      wgmma_wait<1>();  // S of tile j
      s_done(j);
      softmax();
      wgmma_wait<0>();  // P·V of tile j - 1
      pv_done(j - 1);
      rescale();
      pack();
    }
    pv_start(nkt - 1);
    wgmma_wait<0>();
    pv_done(nkt - 1);
    it = it0 + nkt;

    // the row sums finished across the quad; the output leaves through the
    // Q buffer as 16-byte stores (every warp of the group has read its Q
    // fragments: the products above needed all four)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      const float inv = 1.f / l_run[r];
      bf16* dst = q_s + (warp * 16 + g + 8 * r) * kWgQStride + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_bf16(o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);
    }
    bar_sync(1 + wg, 128);
    for (int i = ct; i < kWgRows * CH; i += 128) {
      const int r = i / CH, c = i % CH;
      if (q0 + r < a.Lq)
        *reinterpret_cast<uint4*>(ob + (long)q0 * D + i * 8) =
            *reinterpret_cast<const uint4*>(q_s + r * kWgQStride + c * 8);
    }
    bar_sync(1 + wg, 128);  // before the next Q tile overwrites the buffer
  }
}

template <int D>
cudaError_t launch_narrow_plan(const NarrowArgs& args, int B,
                               cudaStream_t stream) {
  constexpr int NC = kNwConsumers;
  const int smem = wgmma_smem_bytes(args.k_slots, NC);
  auto kern = wgmma_narrow_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = NC * kWgRows * args.rounds;  // query rows per block
  dim3 grid((args.Lq + rows - 1) / rows, 1, B);
  kern<<<grid, (NC + 1) * 128, smem, stream>>>(args);
  return cudaGetLastError();
}

// B sequences: resident K wherever every K tile has a slot, a ring of whole
// K tiles above that, chosen by Lk; two consumers either way. With resident
// K the rows a block walks are split over more blocks where too few
// sequences would leave the card short of blocks, as launch_wgmma splits
// them (by steps of 128 rows: three consumers' 192-row steps left a
// quarter of the card idle at [16, 1024, d] and spilled registers).
template <int D>
cudaError_t launch_narrow(NarrowArgs args, int B, cudaStream_t stream) {
  if (args.Lq < 1 || args.Lk < 1 || B < 1) return cudaErrorInvalidValue;
  const int nkt = (args.Lk + kWgTile - 1) / kWgTile;
  if (nkt > kWgMaxKSlots && args.Lk % kWgTile != 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int steps = (args.Lq + 2 * kWgRows - 1) / (2 * kWgRows);
  args.k_slots = nkt <= kWgMaxKSlots ? nkt : kWgRingKSlots;
  args.rounds = nkt <= kWgMaxKSlots ? steps : 1;
  while (args.rounds > 1 &&
         (long)B * ((steps + args.rounds - 1) / args.rounds) < sms - sms / 8)
    args.rounds = (args.rounds + 1) / 2;
  return launch_narrow_plan<D>(args, B, stream);
}

}  // namespace mdt
