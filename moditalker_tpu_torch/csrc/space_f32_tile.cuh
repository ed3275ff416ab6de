// The divided space attention at head dim 64 on float32 qkv, K resident in
// shared memory (N <= 1152 tokens): the kernel of divided_space_attention_f32
// (divided_attention_f32.cu), which replaces _space_kernel of
// moditalker_tpu/ops/pallas/divided_attention.py for the trainers' and the
// golden record's float32 extracts (qkv [B·16, 1024, 1536], 8 heads).
//
// It reads 4 bytes an element where the bf16 kernel reads 2, so at
// train-diffusion's B = 10 it is bound by bytes (1.34 GB: 0.40 ms at 3.35
// TB/s) about as much as by operations (344 GFLOP: 0.35 ms) and by ex2 (one
// per score: 0.32 ms). Its products, softmax and rounding are the wgmma
// tile's (wgmma_tile.cuh: S = Q·Kᵀ m64n128k16 with Q as register A
// fragments, O += P·V m64n64k16 with V read MN-major, online softmax over
// 128-key tiles in fp32), so its output equals that tile's float32 route
// bit for bit; what is built for float32 is around them:
//
//  * V is rounded to bf16 once per (frame, head). One block walks all N
//    query rows of a (frame, head) in rounds (see the plan below). Before
//    the roles split, every thread of the block rotates K into its
//    resident slots and rounds V into the block's scratch slot (`vs`,
//    [slots, N, 64] bf16, allocated by the wrapper), a batch of four K and
//    eight V 16-byte chunks a thread in flight together; the producer
//    warpgroup then copies each bf16 V tile of every round from the slot
//    (L2) with cp.async, as the bf16 route copies V from qkv. So no float32
//    V passes through the producer, which keeps 40 registers. (Rounding V
//    in the first round instead, in the producer's registers, leaves that
//    round waiting on two chunks in flight a thread: tools/ab_space_f32.py's
//    "V in the first round".)
//  * two consumer warpgroups of 64 query rows: a round is 128 rows, so
//    every N the kernel takes is whole rounds and no warpgroup sits one
//    out (three took six rounds for 5 1/3 rounds of rows at N = 1024). The
//    block's 384 threads have 168 registers each at launch; the producer
//    gives up 128 and each consumer takes 232 (40 + 2 x 232 = 3 x 168), so
//    the 64 score, 32 output and 16 Q fragment registers and the softmax
//    never spill. (Four consumers at 112 registers spill, and ptxas then
//    serializes their wgmma, Q held in registers or read from shared
//    memory alike; three at 160 leave two of three idle in the last round:
//    the tool's variants.) Q is staged, rotated, scaled and rounded once,
//    into a 128-byte-swizzled tile per consumer, and read from there into
//    its fragments.
//  * O is rescaled only where a row's running max moved (the warp skips
//    the products when no row of it did: a factor of 1 leaves O as it is).
//
// Rounding points are the bf16 tile's and the float32 route's: q rotated
// and scaled in fp32 and rounded to bf16 once, k rotated and rounded once
// (rotate_pair_rn), v rounded once, fp32 scores, max and sum, p rounded to
// bf16 for P·V against each 128-key tile's running max, the output divided
// by the fp32 row sum and stored as float32 straight from the accumulators.
//
// The plan: one block per (frame, head) walks every round, K rotated and V
// rounded once per head. The prologue's reads overlap no compute of the
// block, so it pays off over many rounds and many blocks: the wrapper
// (space_f32_own_kernel in ops/kernels/divided_attention.py) passes the
// scratch, and with it this kernel, only where it read faster than the
// wgmma tile's float32 route on an H100 (tools/ab_space_f32.py --gate);
// elsewhere divided_space_attention_f32 runs that route, which streams V
// during its rounds.
#pragma once

#include "wgmma_tile.cuh"

namespace mdt {

constexpr int kSfConsumers = 2;
constexpr int kSfRoundRows = kSfConsumers * kWgRows;  // query rows a round
constexpr int kSfQBytes = kWgRows * kWgD * 2;         // one swizzled Q tile
constexpr int kSfBarBytes = 8 * 2 * kWgVStages;
constexpr int kSfKBatch = 4;         // prologue chunks in flight a thread: K
constexpr int kSfVBatch = 8;         // and V

constexpr int space_f32_smem_bytes(int k_slots) {
  // 1 KB of slack: the tiles are aligned to the swizzle's 1024-byte period
  return 1024 + (k_slots + kWgVStages) * kWgTileBytes +
         kSfConsumers * kSfQBytes + kSfBarBytes;
}

static_assert(space_f32_smem_bytes(kWgMaxKSlots) <= kWgSmemLimit,
              "resident K up to 1152 tokens beside the V ring and Q tiles");

struct SpaceF32Args {
  const float* qkv;  // [BF, N, 3·H·64]
  const float* rot;  // [N, 32, 2] (cos, sin) per pair
  bf16* vs;          // [BF·H, N, 64]: V rounded once per (frame, head)
  float* out;        // [BF, N, H·64]
  int N, H;
  float scale;
};

// grid (1, H, BF), block 384, dynamic shared memory
// space_f32_smem_bytes(N / 128).
__global__ void __launch_bounds__((kSfConsumers + 1) * 128, 1)
space_f32_kernel(const SpaceF32Args a) {
  constexpr int NC = kSfConsumers;
  extern __shared__ unsigned char sf_smem[];
  const uint32_t raw_base = smem_u32(sf_smem);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  unsigned char* sm = sf_smem + (base - raw_base);

  const int N = a.N, nkt = N / kWgTile;
  const uint32_t k_tiles = base;
  const uint32_t v_tiles = base + nkt * kWgTileBytes;
  const uint32_t q_tiles = v_tiles + kWgVStages * kWgTileBytes;
  const uint32_t bars = q_tiles + NC * kSfQBytes;
  auto full_v = [&](int i) { return bars + 8 * i; };
  auto empty_v = [&](int i) { return bars + 8 * (kWgVStages + i); };

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < kWgVStages; ++i) {
      mbar_init(full_v(i), 128);         // every producer thread arrives
      mbar_init(empty_v(i), 4 * NC);     // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }

  const int h = blockIdx.y, b = blockIdx.z;
  const long hd = (long)a.H * kWgD, in_row = 3 * hd;
  const float* q = a.qkv + (long)b * N * in_row + (long)h * kWgD;
  const float* k = q + hd;
  const float* v = q + 2 * hd;
  const int rounds = (N + kSfRoundRows - 1) / kSfRoundRows;
  // this (frame, head)'s scratch slot, V's chunks rounded into it
  const int v_chunks = N * 8;
  bf16* const vsc = a.vs + (long)(b * a.H + h) * N * kWgD;

  // ------------------------------------------------------------ prologue
  // Every thread of the block (168 registers each until the roles split):
  // K rotated into its slots, then V rounded into the block's scratch slot,
  // each thread taking chunk i = tid + 384 u of the N x 8 16-byte chunks
  // (of bf16) in batches whose loads are in flight together.
  constexpr int kThreads = (NC + 1) * 128;
  const int chunks = N * 8;
  for (int i0 = tid; i0 < chunks; i0 += kThreads * kSfKBatch) {
    Chunk8<float> raw[kSfKBatch];
    float4 t0[kSfKBatch], t1[kSfKBatch];
#pragma unroll
    for (int u = 0; u < kSfKBatch; ++u) {
      const int i = i0 + kThreads * u, r = i >> 3, c = i & 7;
      if (i < chunks) {
        raw[u].load(k + (long)r * in_row + c * 8);
        const float4* tp =
            reinterpret_cast<const float4*>(a.rot + (long)r * kWgD + c * 8);
        t0[u] = tp[0];
        t1[u] = tp[1];
      }
    }
#pragma unroll
    for (int u = 0; u < kSfKBatch; ++u) {
      const int i = i0 + kThreads * u, r = i >> 3, c = i & 7;
      if (i < chunks)  // rows of consecutive tiles: one swizzled run
        *reinterpret_cast<uint4*>(sm + swizzled(r, c)) =
            rotate_chunk<true>(raw[u], t0[u], t1[u], 1.f);
    }
  }
  for (int i0 = tid; i0 < v_chunks; i0 += kThreads * kSfVBatch) {
    Chunk8<float> raw[kSfVBatch];
#pragma unroll
    for (int u = 0; u < kSfVBatch; ++u) {
      const int i = i0 + kThreads * u;
      if (i < v_chunks) raw[u].load(v + (long)(i >> 3) * in_row + (i & 7) * 8);
    }
#pragma unroll
    for (int u = 0; u < kSfVBatch; ++u) {
      const int i = i0 + kThreads * u;
      if (i < v_chunks) {
        float x[8];
        raw[u].to_float(x);
        *reinterpret_cast<uint4*>(vsc + (long)i * 8) = pack8_bf16(x);
      }
    }
  }
  fence_proxy_async();
  __syncthreads();  // also makes the scratch's V visible to the producer

  if (wg == NC) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = tid - NC * 128;
    // this thread's eight chunks of a tile: row pt / 8 + 16 u, chunk pt % 8
    const uint32_t v_sw = v_tiles + swizzled(pt >> 3, pt & 7);
    const bf16* vrow = vsc + (pt >> 3) * kWgD + (pt & 7) * 8;
    // the bf16 tiles from the scratch slot (L2), the copies one step ahead
    // of their arrival
    int it = 0;
    for (int round = 0; round < rounds; ++round) {
      for (int j = 0; j < nkt; ++j, ++it) {
        const int vs = it % kWgVStages;
        mbar_wait(empty_v(vs), ((it / kWgVStages) & 1) ^ 1);
        const bf16* src = vrow + (long)j * kWgTile * kWgD;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          cp_async16(v_sw + vs * kWgTileBytes + u * 16 * 128,
                     src + u * 16 * kWgD);
        cp_async_commit();
        if (it > 0) {  // the tile started one step ago has landed
          cp_async_wait<1>();
          fence_proxy_async();
          mbar_arrive(full_v((it - 1) % kWgVStages));
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(full_v((it - 1) % kWgVStages));
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid & 127, warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_tile = q_tiles + wg * kSfQBytes;
    unsigned char* q_sm = sm + (q_tile - base);
    constexpr float kLog2e = 1.4426950408889634f;
    int it = 0;

    for (int round = 0; round < rounds; ++round) {
      const int q0 = (round * NC + wg) * kWgRows;
      // Q: rotary + scale, rounded to bf16 once, into the swizzled tile
      // (after every warp of the group is past the last round's products)
      bar_sync(1 + wg, 128);
      stage_rows<true, kWgRows, 128, 4>(
          q + (long)q0 * in_row, in_row, a.rot + (long)q0 * kWgD, a.scale, ct,
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
        float* dst = ob + (long)(q0 + warp * 16 + g + 8 * r) * hd + 2 * t;
#pragma unroll
        for (int nd = 0; nd < 8; ++nd)
          *reinterpret_cast<float2*>(dst + nd * 8) = make_float2(
              o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);
      }
    }
  }
}

// qkv [BF, N, 3·H·64] float32, N a multiple of 128 up to 1152 -> out
// [BF, N, H·64] float32, through the V scratch [BF·H, N, 64] bf16.
inline int launch_space_f32(const void* qkv, const void* rot, void* vs,
                            void* out, int BF, int N, int H, int dh,
                            float scale, cudaStream_t stream) {
  const int nkt = N / kWgTile;
  if (dh != kWgD || N < kWgTile || N % kWgTile || nkt > kWgMaxKSlots ||
      BF < 1 || H < 1)
    return cudaErrorInvalidValue;
  SpaceF32Args a{static_cast<const float*>(qkv),
                 static_cast<const float*>(rot), static_cast<bf16*>(vs),
                 static_cast<float*>(out), N, H, scale};
  const int smem = space_f32_smem_bytes(nkt);
  cudaError_t err = cudaFuncSetAttribute(space_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(1, H, BF);
  space_f32_kernel<<<grid, (kSfConsumers + 1) * 128, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mdt
