// Float32 attention at head dim 64 with K resident in shared memory (N <=
// 1152 tokens), one block per (sequence, head) walking all its N query
// rows: one kernel, resident_f32_kernel, instantiated for two callers.
//
//  * SpaceF32Args: the divided space attention on packed float32 qkv
//    [BF, N, 3·H·64] with the axial rotary, the kernel of
//    divided_space_attention_f32 (divided_attention_f32.cu), which replaces
//    _space_kernel of moditalker_tpu/ops/pallas/divided_attention.py for
//    the trainers' and the golden record's float32 extracts (qkv
//    [B·16, 1024, 1536], 8 heads);
//  * OnepassF32Args: the one-pass attention on contiguous float32 q, k, v
//    [B, N, 64] without a rotary, the kernel of fused_attention_f32
//    (flash_attention_f32.cu) at Nq = Nk, which replaces _onepass_kernel of
//    moditalker_tpu/ops/pallas/flash_attention.py for the AE's space
//    attention on the modular path (head-split in PyTorch: [B·128, 1024,
//    64] in the trainers).
//
// What the two differ in is the Args type's: where a block's q, k, v, V
// scratch slot and output lie and their row strides (the layout's two
// branches in the kernel), and the rotary table (rot_table);
// Args::kRot: K rotated against the table or only rounded, Q rotated and
// scaled or only scaled, each rounded to bf16 once; Args::kVFirst and the
// register split: where V is rounded (below).
//
// It reads 4 bytes an element where a bf16 kernel reads 2, so at
// train-diffusion's B = 10 it is bound by bytes (1.34 GB: 0.40 ms at 3.35
// TB/s) about as much as by operations (344 GFLOP: 0.35 ms) and by ex2 (one
// per score: 0.32 ms). Its products, softmax and rounding are the wgmma
// tile's (wgmma_tile.cuh: S = Q·Kᵀ m64n128k16 with Q as register A
// fragments, O += P·V m64n64k16 with V read MN-major, online softmax over
// 128-key tiles in fp32), so its output equals that tile's float32 route
// bit for bit; what is built for float32 is around them:
//
//  * V is rounded to bf16 once per (sequence, head), into the block's slot
//    of a scratch (`vs`, [slots, N, 64] bf16, allocated by the wrapper) from
//    which the producer warpgroup copies each bf16 V tile of every later
//    round (L2) with cp.async, as the bf16 route copies V from qkv. One
//    block walks all N query rows of a (sequence, head) in rounds (see the
//    plan below). Before the roles split, every thread of the block rotates
//    (or rounds) K into its resident slots, a batch of four (eight without
//    the rotary) 16-byte chunks a thread in flight together. Then V:
//    - space (kVFirst false): every thread rounds V into the slot in the
//      prologue too, eight chunks in flight, so no float32 V passes through
//      the producer, which keeps 40 registers (rounding it in the first
//      round at 40 registers left that round waiting on two chunks in
//      flight a thread: tools/ab_space_f32.py's variants);
//    - one-pass (kVFirst true): the producer rounds V in the first round,
//      on its way into the ring and into the slot, a tile's eight chunks a
//      thread in flight at 104 registers, so the first round's products
//      hide V's float32 reads, which the prologue cannot (read 0.954x /
//      0.968x the V-in-the-prologue plan at [128 | 1280, 1024, 64] on an
//      H100: tools/ab_space_f32.py --onepass --variants).
//  * two consumer warpgroups of 64 query rows: a round is 128 rows, so
//    every N the kernel takes is whole rounds and no warpgroup sits one
//    out (three took six rounds for 5 1/3 rounds of rows at N = 1024). The
//    block's 384 threads have 168 registers each at launch; the producer
//    gives up 128 and each consumer takes 232 (40 + 2 x 232 = 3 x 168), or
//    (one-pass) 64 and 32 (104 + 2 x 200), so the 64 score, 32 output and
//    16 Q fragment registers and the softmax never spill. (Four consumers
//    at 112 registers spill, and ptxas then serializes their wgmma, Q held
//    in registers or read from shared memory alike; three at 160 leave two
//    of three idle in the last round: the tool's variants.) Q is staged,
//    rotated, scaled and rounded once, into a 128-byte-swizzled tile per
//    consumer, and read from there into its fragments.
//  * O is rescaled only where a row's running max moved (the warp skips
//    the products when no row of it did: a factor of 1 leaves O as it is).
//
// Rounding points are the bf16 tile's and the float32 route's: q rotated
// and scaled in fp32 and rounded to bf16 once, k rotated and rounded once
// (rotate_pair_rn; without the rotary q·scale and k rounded once), v
// rounded once, fp32 scores, max and sum, p rounded to bf16 for P·V
// against each 128-key tile's running max, the output divided by the fp32
// row sum and stored as float32 straight from the accumulators.
//
// The plan: one block per (sequence, head) walks every round, K rounded
// and V rounded once per head. The prologue's reads overlap no compute of
// the block, so it pays off over many rounds and many blocks: each wrapper
// (space_f32_own_kernel in ops/kernels/divided_attention.py,
// onepass_f32_own_kernel in ops/kernels/flash_attention.py) passes the
// scratch, and with it this kernel, only where it read faster than the
// wgmma tile's float32 route on an H100 (tools/ab_space_f32.py --gate,
// --onepass --gate); elsewhere its entry point runs that route, which
// streams V during its rounds.
//
// The cluster plan (space only, CL = 2; the entry point
// divided_space_attention_f32_cluster): a thread-block cluster of two
// blocks per (frame, head), launched with cudaLaunchKernelEx, each walking
// every other round (4 of 8 at N = 1024), so that 64 pairs (8-frame clips)
// fill 128 of the 132 SMs in one wave, and each block's prologue is half
// of K. space_f32_own_kernel names it where it read faster than both the
// one-block plan and the route (at 1024 tokens from 64 pairs: 0.93x the
// route at 64 pairs, 0.97x / 0.99x the one-block plan at 128 / 1280). Each block rotates half of K's chunks and stores each into its own
// swizzled slot and at the same offset of its peer's shared memory (mapa +
// st.shared::cluster); a cluster barrier (release / acquire, after a proxy
// fence for the peer's wgmma) then hands both blocks a whole K. The peer
// must have started before the first store into its shared memory: every
// block arrives on the cluster barrier at entry and waits with its first
// batch's loads in flight. V is the one-pass plan's: each producer rounds
// every V tile on its way into its ring in its first round (at the one-pass
// plan's 104 / 200 registers), and every other tile into the pair's scratch
// slot; it arrives on its peer's mbarrier (release at cluster scope, after
// a GPU-scope fence) once its tiles are there, and waits on its own for the
// peer's before its second round copies the slot. (V rounded into the slot
// in the prologue instead, half by each block, took a block 34.6 k clocks
// of prologue and 22.0 k of first round against this plan's 18.2 k and
// 27.0 k at qkv [1, 8, 1024, 1536] on an H100: tools/ab_space_f32.py
// --clock, two calls.) Splitting the queries keeps every sum where it was:
// the output is the one-block plan's, and so the route's, bit for bit.
#pragma once

#include "wgmma_tile.cuh"

namespace mdt {

constexpr int kRfConsumers = 2;
constexpr int kRfRoundRows = kRfConsumers * kWgRows;  // query rows a round
constexpr int kRfQBytes = kWgRows * kWgD * 2;         // one swizzled Q tile
constexpr int kRfBarBytes = 8 * (2 * kWgVStages + 1);  // + the cluster's
constexpr int kRfKBatch = 4;         // prologue chunks in flight a thread: K
constexpr int kRfVBatch = 8;         // (with its table entries), and V
constexpr int kRfVFirstBatch = 8;    // V in the first round (of a tile's 8)

constexpr int resident_f32_smem_bytes(int k_slots) {
  // 1 KB of slack: the tiles are aligned to the swizzle's 1024-byte period
  return 1024 + (k_slots + kWgVStages) * kWgTileBytes +
         kRfConsumers * kRfQBytes + kRfBarBytes;
}

static_assert(resident_f32_smem_bytes(kWgMaxKSlots) <= kWgSmemLimit,
              "resident K up to 1152 tokens beside the V ring and Q tiles");

// The divided space attention: grid (1, H, BF). V rounded in the prologue;
// the producer only copies it from the scratch, at 40 registers.
struct SpaceF32Args {
  static constexpr bool kRot = true, kVFirst = false;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  const float* qkv;  // [BF, N, 3·H·64]
  const float* rot;  // [N, 32, 2] (cos, sin) per pair
  bf16* vs;          // [BF·H, N, 64]: V rounded once per (frame, head)
  float* out;        // [BF, N, H·64]
  int N, H;
  float scale;
};

// the rotary table (the one-pass attention has none)
__device__ __forceinline__ const float* rot_table(const SpaceF32Args& a) {
  return a.rot;
}

// The one-pass attention: grid (1, 1, B). V rounded by the producer in the
// first round, a tile's eight chunks a thread in flight (104 registers;
// the consumers at 200).
struct OnepassF32Args {
  static constexpr bool kRot = false, kVFirst = true;
  static constexpr int kProducerRegs = 104, kConsumerRegs = 200;
  const float* q;    // [B, N, 64]
  const float* k;    // [B, N, 64]
  const float* v;    // [B, N, 64]
  bf16* vs;          // [B, N, 64]: V rounded once per sequence
  float* out;        // [B, N, 64]
  int N;
  float scale;
};

__device__ __forceinline__ const float* rot_table(const OnepassF32Args&) {
  return nullptr;
}

// block 384, dynamic shared memory resident_f32_smem_bytes(N / 128); CL
// blocks a (sequence, head) in a cluster of CL along x (the cluster plan,
// space only: CL = 2), each walking every CL-th round.
template <typename Args, int CL = 1>
__global__ void __launch_bounds__((kRfConsumers + 1) * 128, 1)
resident_f32_kernel(const Args a) {
  constexpr int NC = kRfConsumers;
  constexpr bool ROT = Args::kRot;
  static_assert(CL == 1 || CL == 2, "one block or a cluster of two");
  // where V is rounded, and the register split that goes with it: the
  // cluster plan's (in the producer's first round, at the one-pass plan's
  // 104 / 200 registers) or the Args'
  constexpr bool VFIRST = CL > 1 || Args::kVFirst;
  constexpr int kProducerRegs = CL > 1 ? 104 : Args::kProducerRegs;
  constexpr int kConsumerRegs = CL > 1 ? 200 : Args::kConsumerRegs;
  extern __shared__ unsigned char rf_smem[];
  const uint32_t raw_base = smem_u32(rf_smem);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  unsigned char* sm = rf_smem + (base - raw_base);

  const int N = a.N, nkt = N / kWgTile;
  const uint32_t k_tiles = base;
  const uint32_t v_tiles = base + nkt * kWgTileBytes;
  const uint32_t q_tiles = v_tiles + kWgVStages * kWgTileBytes;
  const uint32_t bars = q_tiles + NC * kRfQBytes;
  auto full_v = [&](int i) { return bars + 8 * i; };
  auto empty_v = [&](int i) { return bars + 8 * (kWgVStages + i); };
  // the cluster plan: the peer's half of the V slot written (every peer
  // producer thread arrives once its first round has written its tiles)
  const uint32_t v_peer = bars + 8 * 2 * kWgVStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < kWgVStages; ++i) {
      mbar_init(full_v(i), 128);         // every producer thread arrives
      mbar_init(empty_v(i), 4 * NC);     // lane 0 of every consumer warp
    }
    if (CL > 1) mbar_init(v_peer, 128 * (CL - 1));
    mbar_init_fence();
  }
  // the cluster plan: this block's rank; every block of the cluster has
  // started (its shared memory may take its peer's stores) once the wait
  // before the first store below returns
  int rank = 0;
  if constexpr (CL > 1) {
    rank = (int)cluster_ctarank();
    cluster_arrive_relaxed();
  }

  const int h = blockIdx.y, b = blockIdx.z;
  // the layout: q, k, v at row 0 of this (sequence, head) and their row
  // stride in_row, the output's hd
  long hd, in_row;
  const float *q, *k, *v;
  if constexpr (ROT) {  // packed qkv [BF, N, 3·H·64], out [BF, N, H·64]
    hd = (long)a.H * kWgD, in_row = 3 * hd;
    q = a.qkv + (long)b * N * in_row + (long)h * kWgD;
    k = q + hd;
    v = q + 2 * hd;
  } else {              // q, k, v and out [B, N, 64], one head (h = 0)
    hd = in_row = kWgD;
    const long seq = (long)b * N * in_row;
    q = a.q + seq;
    k = a.k + seq;
    v = a.v + seq;
  }
  const int rounds = (N + kRfRoundRows - 1) / kRfRoundRows;
  // this (sequence, head)'s scratch slot, V's chunks rounded into it
  const int v_chunks = N * 8;
  bf16* vsc;
  if constexpr (ROT)
    vsc = a.vs + (long)(b * a.H + h) * N * kWgD;
  else
    vsc = a.vs + (long)b * N * kWgD;

  // ------------------------------------------------------------ prologue
  // Every thread of the block (168 registers each until the roles split):
  // K rotated (or rounded) into its slots, then (unless kVFirst) V rounded
  // into the block's scratch slot, each thread taking chunk i = tid + 384 u
  // of the N x 8 16-byte chunks (of bf16) in batches whose loads are in
  // flight together (K's with its table entries: half the chunks of V's).
  // In a cluster each block takes its 1/CL of K's chunks, stored into its
  // own slots and at the same offset of its peer's.
  constexpr int kThreads = (NC + 1) * 128;
  constexpr int kKBatch = ROT ? kRfKBatch : kRfVBatch;
  const int chunks = N * 8;
  const int c_lo = rank * (chunks / CL), c_hi = c_lo + chunks / CL;
  for (int i0 = c_lo + tid; i0 < c_hi; i0 += kThreads * kKBatch) {
    Chunk8<float> raw[kKBatch];
    float4 t0[kKBatch], t1[kKBatch];
#pragma unroll
    for (int u = 0; u < kKBatch; ++u) {
      const int i = i0 + kThreads * u, r = i >> 3, c = i & 7;
      if (i < c_hi) {
        raw[u].load(k + (long)r * in_row + c * 8);
        if constexpr (ROT) {
          const float4* tp =
              reinterpret_cast<const float4*>(rot_table(a) + (long)r * kWgD +
                                              c * 8);
          t0[u] = tp[0];
          t1[u] = tp[1];
        } else {
          t0[u] = t1[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    if constexpr (CL > 1) {
      // every thread's first batch (N >= 256: more chunks a block than
      // threads), its loads in flight: the peer has started
      if (i0 == c_lo + tid) cluster_wait_acquire();
    }
#pragma unroll
    for (int u = 0; u < kKBatch; ++u) {
      const int i = i0 + kThreads * u, r = i >> 3, c = i & 7;
      if (i < c_hi) {  // rows of consecutive tiles: one swizzled run
        const uint4 kc = rotate_chunk<ROT>(raw[u], t0[u], t1[u], 1.f);
        *reinterpret_cast<uint4*>(sm + swizzled(r, c)) = kc;
        if constexpr (CL > 1) {
#pragma unroll
          for (int p = 1; p < CL; ++p)
            st_cluster16(mapa_shared(base + swizzled(r, c), (rank + p) % CL),
                         kc);
        }
      }
    }
  }
  for (int i0 = tid; !VFIRST && i0 < v_chunks;
       i0 += kThreads * kRfVBatch) {
    Chunk8<float> raw[kRfVBatch];
#pragma unroll
    for (int u = 0; u < kRfVBatch; ++u) {
      const int i = i0 + kThreads * u;
      if (i < v_chunks) raw[u].load(v + (long)(i >> 3) * in_row + (i & 7) * 8);
    }
#pragma unroll
    for (int u = 0; u < kRfVBatch; ++u) {
      const int i = i0 + kThreads * u;
      if (i < v_chunks) {
        float x[8];
        raw[u].to_float(x);
        *reinterpret_cast<uint4*>(vsc + (long)i * 8) = pack8_bf16(x);
      }
    }
  }
  fence_proxy_async();
  if constexpr (CL > 1) {
    // the peers' K stores before their wgmma reads
    fence_proxy_async_cluster();
    cluster_arrive_release();
    cluster_wait_acquire();
    fence_proxy_async();
  }
  __syncthreads();  // also makes the scratch's V visible to the producer

  if (wg == NC) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    const int pt = tid - NC * 128;
    // this thread's eight chunks of a tile: row pt / 8 + 16 u, chunk pt % 8
    const uint32_t v_sw = v_tiles + swizzled(pt >> 3, pt & 7);
    bf16* const vrow = vsc + (pt >> 3) * kWgD + (pt & 7) * 8;
    int it = 0, round = rank;
    if constexpr (VFIRST) {
      // the first round: float32 V rounded once on its way into the ring,
      // and into the scratch slot that the later rounds copy it from (a
      // cluster's blocks: every tile into the ring, every CL-th into the
      // slot they share, where either walks a later round); the loads of
      // kRfVFirstBatch chunks in flight together, the first batch issued
      // before the wait for the tile's slot
      const float* vsrc = v + (long)(pt >> 3) * in_row + (pt & 7) * 8;
      const bool keep = CL > 1 ? rounds > CL : rounds > 1;
      for (int j = 0; j < nkt; ++j, ++it) {
        const int vs = it % kWgVStages;
        const float* src = vsrc + (long)j * kWgTile * in_row;
#pragma unroll
        for (int u0 = 0; u0 < 8; u0 += kRfVFirstBatch) {
          Chunk8<float> c[kRfVFirstBatch];
#pragma unroll
          for (int u = 0; u < kRfVFirstBatch; ++u)
            c[u].load(src + (u0 + u) * 16 * in_row);
          if (u0 == 0) mbar_wait(empty_v(vs), ((it / kWgVStages) & 1) ^ 1);
#pragma unroll
          for (int u = 0; u < kRfVFirstBatch; ++u) {
            float x[8];
            c[u].to_float(x);
            const uint4 r = pack8_bf16(x);
            st_shared16(v_sw + vs * kWgTileBytes + (u0 + u) * 16 * 128, r);
            if (keep && j % CL == rank)
              *reinterpret_cast<uint4*>(
                  vrow + ((long)j * kWgTile + (u0 + u) * 16) * kWgD) = r;
          }
        }
        fence_proxy_async();
        mbar_arrive(full_v(vs));
      }
      round = rank + CL;
      if constexpr (CL > 1) {
        // this thread's chunks of its tiles written: the peer copies them
        // from its second round on (it waits for this arrival, so it is
        // still there; one that walks one round never waits, and is given
        // none)
        const int mine = (rounds - rank + CL - 1) / CL;
        const int peers = (rounds - (rank + 1) % CL + CL - 1) / CL;
        if (peers > 1) {
          __threadfence();
          mbar_arrive_cluster(mapa_shared(v_peer, (rank + 1) % CL));
        }
        if (mine > 1) mbar_wait_cluster(v_peer, 0);
      }
    }
    // the bf16 tiles from the scratch slot (L2), the copies one step ahead
    // of their arrival
    const int it0 = it;
    for (; round < rounds; round += CL) {
      for (int j = 0; j < nkt; ++j, ++it) {
        const int vs = it % kWgVStages;
        mbar_wait(empty_v(vs), ((it / kWgVStages) & 1) ^ 1);
        const bf16* src = vrow + (long)j * kWgTile * kWgD;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          cp_async16(v_sw + vs * kWgTileBytes + u * 16 * 128,
                     src + u * 16 * kWgD);
        cp_async_commit();
        if (it > it0) {  // the tile started one step ago has landed
          cp_async_wait<1>();
          fence_proxy_async();
          mbar_arrive(full_v((it - 1) % kWgVStages));
        }
      }
    }
    if (!VFIRST || it > it0) {
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(full_v((it - 1) % kWgVStages));
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int ct = tid & 127, warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_tile = q_tiles + wg * kRfQBytes;
    unsigned char* q_sm = sm + (q_tile - base);
    constexpr float kLog2e = 1.4426950408889634f;
    int it = 0;

    for (int round = rank; round < rounds; round += CL) {
      const int q0 = (round * NC + wg) * kWgRows;
      // Q: rotary (where there is one) + scale, rounded to bf16 once, into
      // the swizzled tile (after every warp of the group is past the last
      // round's products)
      bar_sync(1 + wg, 128);
      stage_rows<ROT, kWgRows, 128, 4>(
          q + (long)q0 * in_row, in_row,
          ROT ? rot_table(a) + (long)q0 * kWgD : nullptr, a.scale, ct,
          [&](int r, int c, uint4 x) {
            *reinterpret_cast<uint4*>(q_sm + swizzled(r, c)) = x;
          });
      fence_proxy_async();
      bar_sync(1 + wg, 128);

      // this thread's A fragments of Q (rows warp x 16 + g and + 8)
      uint32_t qa[kWgD / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgD / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          qa[kk][c] = *reinterpret_cast<const uint32_t*>(
              q_sm + swizzled(warp * 16 + g + 8 * (c & 1), 2 * kk + (c >> 1)) +
              4 * t);

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

      for (int j = 0; j < nkt; ++j, ++it) {
        // S = Q·Kᵀ: this warpgroup's 64 rows x 128 keys
        float s[64];
        const uint32_t kt = k_tiles + j * kWgTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgD / 16; ++kk)
          wgmma_m64n128k16(s, qa[kk], wgmma_desc(kt + kk * 32), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);

        // online softmax; rows g (r = 0) and g + 8 (r = 1) of this warp's
        // 16, each spread over a quad
        float alpha[2];
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
            const float p0 =
                exp2_approx(fmaf(s[4 * nt + 2 * r], kLog2e, -shift));
            const float p1 =
                exp2_approx(fmaf(s[4 * nt + 2 * r + 1], kLog2e, -shift));
            s[4 * nt + 2 * r] = p0;
            s[4 * nt + 2 * r + 1] = p1;
            sum += p0 + p1;
          }
          l_run[r] = l_run[r] * alpha[r] + sum;
          m_run[r] = m_new;
        }
        // O rescaled where a row's max moved (a factor of 1 leaves it as it
        // is: the warp skips the products only when no row of it moved)
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int nd = 0; nd < 8; ++nd) {
            o[4 * nd] *= alpha[0];
            o[4 * nd + 1] *= alpha[0];
            o[4 * nd + 2] *= alpha[1];
            o[4 * nd + 3] *= alpha[1];
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

      // finish the row sums across the quad; float32 straight from the
      // fragments: a quad's four 8-byte stores fill one 32-byte sector
      float* ob = a.out + (long)b * N * hd + (long)h * kWgD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        const float inv = 1.f / l_run[r];
        float* dst =
            ob + (long)(q0 + warp * 16 + g + 8 * r) * hd + 2 * t;
#pragma unroll
        for (int nd = 0; nd < 8; ++nd)
          *reinterpret_cast<float2*>(dst + nd * 8) = make_float2(
              o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);
      }
    }
  }
}

// Checks the shape (N a multiple of 128 up to 1152; with a cluster, from
// 256, a round for each block at least) and launches CL blocks per
// (sequence, head): one, or (CL = 2) a cluster of two, launched with its
// cluster dimension as a launch attribute, after asking once whether such
// a cluster fits the card at all (cudaOccupancyMaxActiveClusters; none is
// an error, never a fallback). The callers' launchers sit in their entry
// points' sources (launch_space_f32 in divided_attention_f32.cu,
// launch_onepass_f32 in flash_attention_f32.cu), so that each library
// holds its own instantiation alone.
template <typename Args, int CL = 1>
inline int launch_resident_f32(const Args& a, int heads, int seqs,
                               cudaStream_t stream) {
  const int nkt = a.N / kWgTile;
  if (a.N < (CL > 1 ? 256 : kWgTile) || a.N % kWgTile ||
      nkt > kWgMaxKSlots || seqs < 1 || heads < 1)
    return cudaErrorInvalidValue;
  const int smem = resident_f32_smem_bytes(nkt);
  auto kern = resident_f32_kernel<Args, CL>;
  dim3 grid(CL, heads, seqs);
  if constexpr (CL == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, (kRfConsumers + 1) * 128, smem, stream>>>(a);
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3((kRfConsumers + 1) * 128);
    config.dynamicSmemBytes = resident_f32_smem_bytes(kWgMaxKSlots);
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    // the clusters the card holds at once at the largest N (asked once);
    // none is an error (invalid configuration), never a fallback
    static int fits = -1;
    if (fits < 0) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)config.dynamicSmemBytes);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&fits, kern, &config);
      if (err != cudaSuccess) {
        fits = -1;
        return err;
      }
    }
    if (fits == 0) return cudaErrorInvalidConfiguration;
    config.dynamicSmemBytes = smem;
    cudaError_t err = cudaLaunchKernelEx(&config, kern, a);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace mdt
