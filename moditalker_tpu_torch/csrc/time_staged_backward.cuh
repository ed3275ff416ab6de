// The divided time attention's backward at clips of 8 frames (the frame
// class 16), bf16 and float32: replaces, at that length, the jax.vjp of the
// reference that the custom_vjp of _time_kernel runs
// (moditalker_tpu/ops/pallas/divided_attention.py:310-322), which the
// classes' time backward (divided_backward.cuh, time_bwd_class_kernel)
// computed before.
//
// Bound by bytes: qkv and g read once, dqkv written once, 58.7 MB at qkv
// [1, 8, 1024, 1536] bf16 (0.0175 ms at 3.35 TB/s). The class gives a warp
// one (b, n, head), pads its 8 frames to a 16-row tile (half of every
// product and every exp on padding) and loads its rows through registers
// with the rotary on the way, so each warp's loads, products and stores run
// in turn. Here the forward's staged design (time_staged.cuh) carried over:
//
//  * two items a warp's 16-row tile (PAIR): rows 0-7 hold item A, rows 8-15
//    item B, each item's keys in their own n8 tile of S and dP; a row's
//    scores of the other item are -inf before the max, so its P and dS there
//    are exactly 0, and dv = Pᵀ·g, dk = dSᵀ·q~ and dq = dS·k~ sum the class's
//    nonzero products and exact zeros: dqkv is the class's bit for bit (the
//    row sums add the other item's zeros in the class's order). But a
//    non-finite v or g of one item reaches its partner's gradient through
//    that zero weight (0 x inf), where the class keeps items apart.
//  * raw rows staged by cp.async into two stages: a warp's next pair lands,
//    every copy in flight at once, in one stage while it computes on the
//    other. bf16 q, k, v and g land in the tiles the products read (row
//    stride dh + 8), q and k rotated and scaled there in place; float32 raw
//    rows [4][16][DH] fp32 are rounded into the bf16 tiles written over the
//    start of their stage a few rows at a time (each group read before it
//    is overwritten). Every value is rounded as the class's loader
//    (load8_part) rounds it: the same arithmetic on the same values.
//  * bf16 dqkv rows go through k~'s tile, dead once dq has read it, and out
//    in 16 bytes a lane: whole sectors, where a quad's 4-byte stores from
//    the accumulators write half of one (float32's 8-byte stores fill
//    theirs).
//  * resident blocks walking pairs grid-stride, dealt warp-major so that
//    every SM gets about as many, as many warps a block as keep the most on
//    an SM (staged_block_warps), the rotary table of 8 frames staged once
//    per block; P and dS pass through the warp's buffer (over v's tile,
//    which only dP reads, where it fits) to become the transposed operands
//    of dv and dk, as in the class.
//
// At qkv [1, 8, 1024, 1536] on an H100 (tools/ab_classes.py --time8) bf16
// read 0.0363 ms against the class's 0.0580, float32 0.0542 against 0.0648;
// one stage (float32 v and g then through registers while q and k land)
// read 0.0425 / 0.0608, and bf16's 4-byte stores from the accumulators
// 0.0432.
#pragma once

#include <type_traits>

#include "divided_backward.cuh"
#include "time_staged.cuh"

namespace mdt {

// A warp's two stages, bytes each: the tiles of q, k, v and g [16][DH + 8]
// bf16, then P and dS [16][24] each unless they go over v's tile; in
// float32 the four raw operands [4][16][DH] fp32 with the tiles over their
// start.
template <int DH, typename T>
struct StagedTimeBwd {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int FT = 16, TR = 8;   // tile rows; table rows (frames)
  static constexpr int RS = DH + 8, PS = FT + 8, CH = DH / 8;
  static constexpr int tile = FT * RS * 2;
  static constexpr int pd = 2 * FT * PS * 2;
  static constexpr bool pd_over_v = tile >= pd;
  static constexpr int raw = kF32 ? 4 * FT * DH * 4 : 0;
  static constexpr int tiles = 4 * tile + (pd_over_v ? 0 : pd);
  static constexpr int stage = raw > tiles ? raw : tiles;
  static constexpr int warp_bytes = 2 * stage;
  static constexpr int table_floats = 2 * TR * DH;   // sin, cos
  static constexpr int warps = staged_block_warps(table_floats * 4, warp_bytes);
  static constexpr int smem_bytes = table_floats * 4 + warps * warp_bytes;
};

// A pair's two items: each item's rows of qkv, g and dqkv, and whether it
// is one (the last tile of an odd count holds one).
template <typename T>
struct TimeBwdPair {
  const T* src[2];
  const T* gsrc[2];
  T* dst[2];
  bool live[2];
  // by an item known only at run time, selected rather than indexed (an
  // indexed array would put the pair in local memory)
  __device__ __forceinline__ bool is_live(int it) const {
    return it ? live[1] : live[0];
  }
  __device__ __forceinline__ const T* qkv_of(int it) const {
    return it ? src[1] : src[0];
  }
  __device__ __forceinline__ const T* g_of(int it) const {
    return it ? gsrc[1] : gsrc[0];
  }
  __device__ __forceinline__ T* dqkv_of(int it) const {
    return it ? dst[1] : dst[0];
  }
};

// grid: at most the blocks the SMs hold, block 32·warps; F = 8 frames of
// head dim dh (2 <= dh <= DH, dh dividing 128); qkv, g and dqkv of element
// type T. A warp's tile holds the items (b, n, h) = 2 i and 2 i + 1 of a
// pair i.
template <int DH, typename T>
__global__ void __launch_bounds__(32 * StagedTimeBwd<DH, T>::warps)
time_bwd_staged_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ sin_t,
                       const float* __restrict__ cos_t,
                       const T* __restrict__ gin, T* __restrict__ dqkv,
                       int B, int N, int H, float scale, int dh) {
  using S = StagedTimeBwd<DH, T>;
  constexpr int FT = S::FT, TR = S::TR, RS = S::RS, PS = S::PS, CH = S::CH;
  constexpr bool kF32 = S::kF32;
  constexpr int F = 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sin_s = reinterpret_cast<float*>(smem_raw);  // [TR][DH]
  float* cos_s = sin_s + TR * DH;
  stage_table<TR, DH>(sin_s, sin_t, F, dh, 32 * S::warps);
  stage_table<TR, DH>(cos_s, cos_t, F, dh, 32 * S::warps);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* const wbuf =
      smem_raw + S::table_floats * 4 + warp * S::warp_bytes;
  const int HD = H * dh;
  const long in_frame = (long)N * 3 * HD, g_frame = (long)N * HD;
  const long items = (long)B * N * H;
  const long tasks = (items + 1) / 2;
  auto item_of = [](int r) { return r >> 3; };
  auto frame_of = [](int r) { return r & 7; };
  if (dh < 8) {
    // a row's dh elements are copied alone: the rest of the buffer stays the
    // zeros written here (q and k are rewritten whole by the rotation, the
    // float32 loader reads no element past dh)
    for (int i = lane; i < S::warp_bytes / 16; i += 32)
      *reinterpret_cast<uint4*>(wbuf + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  using Pair = TimeBwdPair<T>;
  auto pair_of = [&](long wid) {
    Pair p;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const long i = wid * 2 + it;
      p.live[it] = i < items;
      const long idx = p.live[it] ? i : 0;
      const int h = (int)(idx % H);
      const int n = (int)((idx / H) % N);
      const int b = (int)(idx / ((long)H * N));
      const long row0 = (long)b * F * N + n;
      p.src[it] = qkv + row0 * 3L * HD + h * dh;
      p.gsrc[it] = gin + row0 * HD + h * dh;
      p.dst[it] = dqkv + row0 * 3L * HD + h * dh;
    }
    return p;
  };
  // operand m's row r (q, k, v, then g) of a pair in device memory
  auto row_of = [&](const Pair& p, int m, int r) {
    const int it = item_of(r), fr = frame_of(r);
    return m < 3 ? p.qkv_of(it) + fr * in_frame + m * HD
                 : p.g_of(it) + fr * g_frame;
  };
  // a pair's copies into a stage (bf16 into the tiles, float32 raw), every
  // copy in flight at once; rows of a missing item zeros (dh >= 8) or left
  // as they are (dh < 8: never stored, and finite)
  auto copy = [&](unsigned char* st, const Pair& p) {
    const uint32_t st_s = smem_u32(st);
    auto at = [&](int m, int r, int c) {
      return st_s + (kF32 ? ((m * FT + r) * DH + c) * 4
                          : ((m * FT + r) * RS + c) * 2);
    };
    if (dh >= 8) {
#pragma unroll
      for (int i = lane; i < FT * CH; i += 32) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool valid = p.is_live(item_of(r)) && c < dh;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const T* src = valid ? row_of(p, m, r) + c : p.src[0];
          cp_async16_or_zeros(at(m, r, c), src, valid);
          if constexpr (kF32)
            cp_async16_or_zeros(at(m, r, c) + 16, src + (valid ? 4 : 0),
                                valid);
        }
      }
    } else {
      for (int r = lane; r < FT; r += 32)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (!p.is_live(item_of(r))) continue;
          if (dh == 2)
            cp_async_bytes<2 * sizeof(T)>(at(m, r, 0), row_of(p, m, r));
          else
            cp_async_bytes<4 * sizeof(T)>(at(m, r, 0), row_of(p, m, r));
        }
    }
    cp_async_commit();
  };

  // pairs dealt warp-major (warp w of every block before warp w + 1), so
  // that a count of pairs the resident warps do not divide leaves each SM
  // about the same number of them
  const long stride = (long)gridDim.x * S::warps;
  long wid = (long)warp * gridDim.x + blockIdx.x;
  int cur = 0;
  if (wid < tasks) copy(wbuf, pair_of(wid));
  for (; wid < tasks; wid += stride, cur ^= 1) {
    const Pair p = pair_of(wid);
    unsigned char* const st = wbuf + cur * S::stage;
    bf16* const q_s = reinterpret_cast<bf16*>(st);
    bf16* const k_s = q_s + FT * RS;
    bf16* const v_s = k_s + FT * RS;
    bf16* const g_s = v_s + FT * RS;
    bf16* const p_s = S::pd_over_v ? v_s : g_s + FT * RS;
    bf16* const d_s = p_s + FT * PS;
    // the rows of the tile inside an item, and a chunk's elements inside it
    auto part_of = [&](int r, int c) {
      return p.is_live(item_of(r)) ? dh - c : 0;
    };

    // the next pair's copies into the other stage, in flight while this one
    // computes
    if (wid + stride < tasks)
      copy(wbuf + (cur ^ 1) * S::stage, pair_of(wid + stride));
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    if constexpr (kF32) {
      // the raw operands rotated (q scaled), each rounded to bf16 once into
      // its tile over the raw rows: a group of rows is read into registers
      // before any of it is written (a tile row is narrower than a raw one,
      // so a group's tile rows cover only raw rows read)
      const float* raw = reinterpret_cast<const float*>(st);
      constexpr int kPer = FT * CH / 32 < 8 ? FT * CH / 32 : 8;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int u0 = 0; u0 < FT * CH; u0 += 32 * kPer) {
          float x[kPer][8];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = u0 + lane + 32 * u, r = i / CH, c = (i % CH) * 8;
            const int tr = frame_of(r);
            const float* src = raw + (m * FT + r) * DH + c;
            if (m < 2)
              load8_part<true>(src, part_of(r, c), sin_s + tr * DH + c,
                               cos_s + tr * DH + c, m == 0 ? scale : 1.f,
                               x[u]);
            else
              load8_part<false>(src, part_of(r, c), nullptr, nullptr, 1.f,
                                x[u]);
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = u0 + lane + 32 * u, r = i / CH, c = (i % CH) * 8;
            store8(q_s + (m * FT + r) * RS + c, x[u]);
          }
          __syncwarp();
        }
      }
    } else {
      // q rotated and scaled, k rotated, in place; v and g as copied
#pragma unroll
      for (int i = lane; i < FT * CH; i += 32) {
        const int r = i / CH, c = (i % CH) * 8;
        const int part = part_of(r, c);
        const float* sn = sin_s + frame_of(r) * DH + c;
        const float* cs = cos_s + frame_of(r) * DH + c;
        float x[8];
        load8_part<true>(q_s + r * RS + c, part, sn, cs, scale, x);
        store8(q_s + r * RS + c, x);
        load8_part<true>(k_s + r * RS + c, part, sn, cs, 1.f, x);
        store8(k_s + r * RS + c, x);
      }
      __syncwarp();
    }
    const uint32_t qt = smem_u32(q_s), kt = smem_u32(k_s), vt = smem_u32(v_s);
    const uint32_t gt = smem_u32(g_s), pt = smem_u32(p_s), dt = smem_u32(d_s);

    // S = q~·k~ᵀ and dP = g·vᵀ, 16 x 16 each: the class's products
    float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
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
    // the class's full-row softmax, D = Σ P ∘ dP and dS = P ∘ (dP − D); rows
    // g (item A) and g + 8 (item B), each over its own item's n8 tile of keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        if (nt != r) s[nt][2 * r] = s[nt][2 * r + 1] = -INFINITY;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - mx);   // the plain softmax's
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
    // P and dS as bf16 [query][key] for the transposed products (over v's
    // tile where they fit: every lane has read v for dP)
    if (S::pd_over_v) __syncwarp();
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
    __syncwarp();

    // dq = rotᵀ(scale·dS·k~), dk = rotᵀ(dSᵀ·q~), dv = Pᵀ·g, one at a time;
    // each row of the tile to its item's frame
    float acc[DH / 8][4];
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const uint32_t bt = which == 0 ? kt : which == 1 ? qt : gt;
#pragma unroll
      for (int e = 0; e < DH / 8; ++e)
        acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
      uint32_t fa[4];
      if (which == 0)
        pack_a(fa, dp[0], dp[1]);
      else
        frag_a_t(fa, which == 1 ? dt : pt, PS, 0, 0, lane);
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t fb[4];
        frag_b_t(fb, bt, RS, dn * 16, 0, lane);
        mma_16816(acc[2 * dn], fa, fb[0], fb[1]);
        mma_16816(acc[2 * dn + 1], fa, fb[2], fb[3]);
      }
      const float mul = which == 0 ? scale : 1.f;
      // a row's column pair (rotᵀ with the time table for dq and dk: its
      // pair entries differ), as the class rounds it
      auto pair_out = [&](int r, int nt, float& y0, float& y1) {
        const int row = g + 8 * r, col = nt * 8 + 2 * t;
        y0 = acc[nt][2 * r] * mul;
        y1 = acc[nt][2 * r + 1] * mul;
        if (which < 2) {
          const float* sn = sin_s + frame_of(row) * DH + col;
          const float* cs = cos_s + frame_of(row) * DH + col;
          rotate_pair_t_rn(y0, y1, cs[0], sn[0], cs[1], sn[1]);
        }
      };
      if constexpr (!kF32) {
        // bf16 rows through k~'s tile (dead once dq has read it), then 16
        // bytes a lane
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int nt = 0; nt < DH / 8; ++nt) {
            float y0, y1;
            pair_out(r, nt, y0, y1);
            *reinterpret_cast<uint32_t*>(k_s + (g + 8 * r) * RS + nt * 8 +
                                         2 * t) = pack_bf16(y0, y1);
          }
        __syncwarp();
#pragma unroll
        for (int i = lane; i < FT * CH; i += 32) {
          const int r = i / CH, c = (i % CH) * 8;
          if (!p.is_live(item_of(r)) || c >= dh) continue;
          T* const dst = p.dqkv_of(item_of(r)) + frame_of(r) * in_frame +
                         which * HD + c;
          if (c + 8 <= dh)
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(k_s + r * RS + c);
          else   // head dims 2 and 4
            store_part(dst, k_s + r * RS + c, dh - c);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!p.live[r]) continue;   // rows g and g + 8: items A and B
          T* const dst =
              p.dst[r] + frame_of(g + 8 * r) * in_frame + which * HD;
#pragma unroll
          for (int nt = 0; nt < DH / 8; ++nt) {
            const int col = nt * 8 + 2 * t;
            if (col >= dh) continue;
            float y0, y1;
            pair_out(r, nt, y0, y1);
            store2(dst + col, y0, y1);
          }
        }
      }
    }
    __syncwarp();   // the buffer read before the next pair's copies land
  }
  cp_async_wait<0>();
}

template <int DH, typename T>
cudaError_t launch_time_backward_staged(const void* qkv, const void* sin_t,
                                        const void* cos_t, const void* g,
                                        void* dqkv, int B, int N, int H,
                                        int dh, float scale,
                                        cudaStream_t stream) {
  using S = StagedTimeBwd<DH, T>;
  auto kern = time_bwd_staged_kernel<DH, T>;
  cudaError_t err = cudaSuccess;
  if (S::smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, 32 * S::warps, S::smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long tasks = ((long)B * N * H + 1) / 2;
  const long need = (tasks + S::warps - 1) / S::warps;
  const long blocks = need < (long)per_sm * sms ? need : (long)per_sm * sms;
  kern<<<(unsigned)blocks, 32 * S::warps, S::smem_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<const T*>(g),
      static_cast<T*>(dqkv), B, N, H, scale, dh);
  return cudaGetLastError();
}

// F = 8 frames, head dims dividing 128 from 2 up: the head-dim class 16,
// 32, 64 or 128 that holds dh.

template <typename T>
int launch_time_backward_staged_classes(const void* qkv, const void* sin_t,
                                        const void* cos_t, const void* g,
                                        void* dqkv, int B, int F, int N,
                                        int H, int dh, float scale,
                                        cudaStream_t stream) {
  if (F != 8 || dh < 2 || dh > 128 || 128 % dh) return cudaErrorInvalidValue;
#define MDT_TIME_BWD_STAGED(DH)                       \
  return launch_time_backward_staged<DH, T>(          \
      qkv, sin_t, cos_t, g, dqkv, B, N, H, dh, scale, stream)
  switch (dh < 16 ? 16 : dh) {
    case 16: MDT_TIME_BWD_STAGED(16);
    case 32: MDT_TIME_BWD_STAGED(32);
    case 64: MDT_TIME_BWD_STAGED(64);
    case 128: MDT_TIME_BWD_STAGED(128);
  }
#undef MDT_TIME_BWD_STAGED
  return cudaErrorInvalidValue;
}

}  // namespace mdt
