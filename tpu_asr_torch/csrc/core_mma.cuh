// The bf16 relative-position attention core on the tensor cores, shared by
// attention.cu (core_mma_kernel: the block sublayer, the per-head
// attention and the packed segment mode) and layer.cu (the attention phase
// of layer_mma_kernel, the fused eval layer). The backward's passes in
// attention.cu take their tile shapes, staging and key spans from here too.
#pragma once

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"
#include "dropout.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// The bf16 core on the tensor cores (flash-attention style): per (batch
// row, head, 64 queries), 4 warps of 16 query rows walk 64-key tiles of K,
// V and the position window, double-buffered with 8-byte cp.async copies
// (a head row of dk = 44 bf16 is 88 bytes: 8-byte aligned, not 16) into
// rows padded with zeros to DKP (dk rounded up to 16, 32, 48, 64 or 128) at
// a stride of DKP + 8 values, an odd number of 16-byte units, so ldmatrix
// reads are conflict-free. The global layouts stay those the backward
// reads.
//   - content scores: Qu (16 x DKP) . K tile^T on mma.sync.m16n8k16;
//   - position scores: warp w's 16 x 64 block needs the 79 relative
//     positions t - s = tw + 15 - l (l = 0 .. 78, tw its first query), a
//     contiguous run of P rows; G = Qv (16 x DKP) . P_win^T (DKP x 80) on
//     mma, and the rel-shift score_pos[r][j] = G[r][j - r + 15] is read
//     back through a per-warp fp32 tile in shared memory. This replaces
//     core_tile's per-lane gather and keeps the term a dk-long contraction;
//   - softmax in fp32 with core_tile's conventions: key_bias, -INF beyond
//     T, -1e30 outside the window, a row with no finite maximum yet uses 0;
//     the normaliser sums the undropped probabilities, the value product
//     takes the dropped ones (the same dropout_keep(stream, t * tp + s));
//   - P V: the dropped probabilities, rounded to bf16 in registers, are
//     the A operand directly (the m16n8 accumulator of two key tiles is the
//     m16n8k16 A fragment), V comes through ldmatrix.trans;
//   - packed segments (seg not null): the block first finds the ids of its
//     valid queries (seg > 0), [lo, hi], then the first and last key of the
//     row whose id lies in [lo, hi], and walks only the key tiles between
//     them, staging only their K, V and position rows (the position rows
//     follow the key tile, so skipping a key tile skips its P rows). That
//     span holds every key a valid query can see for any map; packing
//     places segments end to end with ids rising along the row, so it is
//     the tile's own segments and the guards between them. A skipped tile
//     would only have added keys at -1e30, whose weight is exactly 0 once a
//     finite score has been seen, so the result is the full sweep's.
//     Inside the span a key of another segment scores -1e30. A query of
//     segment 0 (guard or pad) gets the uniform average over the span's
//     keys, and a tile with no valid query visits nothing and writes
//     zeros (and lse = +1e30, so the backward's p is 0 there): finite
//     garbage that the layer re-masks. The span comes from seg_span, which
//     the backward's passes call too. The scan reads the
//     whole row's map in every block; a span table built once per forward
//     would spare it, but built with torch ops on the device it costs more
//     than the scans of all the layers it serves (PERF.md, section 6).
//   - a local window (kWin, left / right >= 0 on a side that is limited):
//     the queries q0 .. q0 + 63 see keys q0 - left .. q0 + 63 + right
//     at most, so the block walks only the key tiles of that range
//     (window_tiles), with segments the intersection with the span. The
//     position rows follow the key tile, so they narrow with it. A skipped
//     tile would only have added keys at -1e30 (the window's mask inside a
//     visited tile stays in_window's), whose weight is exactly 0 once a
//     finite score has been seen, and a valid query always sees itself: the
//     result is the full sweep's, and the work falls from T^2 to about
//     T (left + right + 128) a head. A padded query whose window holds only
//     padded keys gets the uniform average over the visited tiles' keys
//     instead of over the row's: finite garbage that the layer re-masks.
// What bounds it: at B=32, T=376, H=4, dk=44 the products are 4.8 GFLOP
// per layer, 5 us at the bf16 tensor rate; the SIMT core (core_tile) is
// held back by its shared-memory operand loads, three float4s per 8 FMAs.
// On the tensor cores the exp and the dropout hash per score and the skew
// round trip are the per-score costs left.
// ---------------------------------------------------------------------------

constexpr int kMQ = 64;           // queries per block: 4 warps x 16 rows
constexpr int kMS = 64;           // keys per tile
constexpr int kMP = kMQ + kMS;    // position rows staged per key tile
constexpr int kGW = 80;           // positions of one warp's block (79 + 1)
constexpr int kGS = 84;           // row stride (floats) of the skew tile

// DKP = 128 (conformer-XLarge's dk): 195,584 bytes of shared memory, one
// block an SM. A warp's O accumulator is then 64 registers a thread, and
// the Qu and Qv A fragments would be 64 more, so the core keeps them in the
// staged rows and loads each k step's fragment where the product takes it
// (kQInSmem; ldmatrix from rows already in shared memory): a tile's 8 + 8
// loads instead of spills. DKP <= 64 keeps them in registers.
template <int DKP>
struct CoreMma {
  static constexpr int kSE = DKP + 8;                 // staged row stride
  static constexpr int kTileElems = (2 * kMS + kMP) * kSE;  // K, V, P
  static constexpr bool kQInSmem = DKP > 64;
  static constexpr size_t kSmem =
      sizeof(bf16) * ((size_t)2 * kMQ * kSE + 2 * (size_t)kTileElems) +
      sizeof(float) * 4 * 16 * kGS;
};

// The A fragment (m16 x k16, row-major) of k step ks of rows 16 w .. of a
// staged tile (row stride DKP + 8).
template <int DKP>
__device__ __forceinline__ void frag_rows(uint32_t (&f)[4], const bf16* tile,
                                          int warp, int lane, int ks) {
  ldmatrix_x4(f, tile + (16 * warp + lane % 16) * (DKP + 8) + ks * 16 +
                     (lane / 16) * 8);
}

// The key tiles [j_lo, j_hi) that the kMQ queries q0 .. of a packed row
// visit (seg_row: the row's (T) segment map): with [lo, hi] the ids of the
// valid queries (id > 0), the kMS-key tiles from the first to the last key
// whose id lies in [lo, hi]; (0, 0) when no query is valid. The forward's
// core and both backward passes take their tiles from here, so each
// backward recomputes exactly the scores its forward summed. Every thread
// of a 128-thread block calls it with the same arguments and `span`, 4 ints
// of shared memory; it starts and ends with a block barrier, so a loop may
// call it once a tile.
__device__ __forceinline__ void seg_span(const int* __restrict__ seg_row,
                                         int q0, int t_len, int* span,
                                         int& j_lo, int& j_hi) {
  const unsigned full = 0xffffffffu;
  __syncthreads();  // a previous call's span is read
  if (threadIdx.x == 0) {
    span[0] = INT_MAX;
    span[1] = 0;
    span[2] = t_len;
    span[3] = 0;
  }
  __syncthreads();
  int lo = INT_MAX, hi = 0;
  for (int i = threadIdx.x; i < kMQ && q0 + i < t_len; i += blockDim.x) {
    const int id = seg_row[q0 + i];
    if (id > 0) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
  }
  lo = __reduce_min_sync(full, lo);
  hi = __reduce_max_sync(full, hi);
  if (threadIdx.x % 32 == 0 && lo <= hi) {
    atomicMin(&span[0], lo);
    atomicMax(&span[1], hi);
  }
  __syncthreads();
  lo = span[0];
  hi = span[1];
  int first = t_len, last = 0;
  for (int s = threadIdx.x; lo <= hi && s < t_len; s += blockDim.x) {
    const int id = seg_row[s];
    if (id >= lo && id <= hi) {
      first = min(first, s);
      last = s + 1;
    }
  }
  first = __reduce_min_sync(full, first);
  last = __reduce_max_sync(full, last);
  if (threadIdx.x % 32 == 0 && first < last) {
    atomicMin(&span[2], first);
    atomicMax(&span[3], last);
  }
  __syncthreads();
  const bool any = span[2] < span[3];
  j_lo = any ? span[2] / kMS : 0;
  j_hi = any ? (span[3] + kMS - 1) / kMS : 0;
}

// The key tiles [j_lo, j_hi) of n_tiles that the window (left, right)
// lets the kMQ queries q0 .. reach: keys q0 - left .. q0 + kMQ - 1 + right,
// a side at -1 unlimited. The forward's core and the dq pass narrow their
// key tiles to it, and the dkv pass visits query tile i only where its key
// tile lies in tile i's range, so each backward recomputes exactly the
// tiles its forward summed.
__device__ __forceinline__ void window_tiles(int q0, int left, int right,
                                             int n_tiles, int& j_lo,
                                             int& j_hi) {
  j_lo = left < 0 ? 0 : max(q0 - left, 0) / kMS;
  j_hi = right < 0 ? n_tiles : min(n_tiles, (q0 + kMQ - 1 + right) / kMS + 1);
}

// Rows first .. first + n - 1 of a (valid, dk) bf16 matrix into dst (row
// stride DKP + 8) in 8-byte pieces, zero outside [0, valid) and past dk
// (dk % 4 == 0).
template <int DKP>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            int first, int n, int valid,
                                            int dk) {
  constexpr int kP = DKP / 4;
  for (int i = threadIdx.x; i < n * kP; i += blockDim.x) {
    const int r = i / kP, c = 4 * (i - r * kP);
    const int row = first + r;
    const bool v = row >= 0 && row < valid && c < dk;
    cp_async8(dst + r * CoreMma<DKP>::kSE + c,
              v ? src + (size_t)row * dk + c : src, v);
  }
}

// One core tile: context rows q0 .. q0 + 63 of head (b, hh), bh = b * heads
// + hh, into ctx (layout cl), and with lse their log-sum-exp. `smem_raw`
// holds CoreMma<DKP>::kSmem bytes, 16-byte aligned; the block is 128
// threads, all of which call it. It reads shared memory from its first
// instruction, so a block that calls it again first passes a barrier.
// core_mma_kernel runs one tile a block; layer.cu's layer_mma_kernel walks
// the tiles of its attention phase with it. kWin: the key tiles narrow to
// the window's (window_tiles); without it every tile is visited and the
// window, if any, only masks.
template <int DKP, bool kSeg, bool kWin = false>
__device__ __forceinline__ void core_mma_tile(
    char* smem_raw,
    const bf16* __restrict__ qu, const bf16* __restrict__ qv,  // (B,H,T,dk)
    const bf16* __restrict__ kk, const bf16* __restrict__ vv,  // (B,H,T,dk)
    const bf16* __restrict__ pos,                              // (H,2T-1,dk)
    const float* __restrict__ key_bias,                        // (B, T)
    bf16* __restrict__ ctx, HeadLayout cl,
    float* __restrict__ lse,                                   // or null
    int bh, int q0, int t_len, int heads, int dk, float scale,
    uint32_t seed, uint32_t b_stride, uint32_t thresh, float dscale, int tp,
    int left, int right, const int* __restrict__ seg) {  // kSeg: (B, T)
  using S = CoreMma<DKP>;
  constexpr int kSE = S::kSE, kKS = DKP / 16, kND = DKP / 8;
  constexpr bool kQS = S::kQInSmem;
  bf16* Qu = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qv = Qu + kMQ * kSE;
  bf16* tiles = Qv + kMQ * kSE;         // 2 x (K kMS, V kMS, P kMP rows)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* G = reinterpret_cast<float*>(tiles + 2 * S::kTileElems) +
             warp * 16 * kGS;

  const int b = bh / heads, hh = bh - b * heads;
  const int tw = q0 + 16 * warp;
  const uint32_t stream = seed + b_stride * (uint32_t)b + (uint32_t)hh;
  const int n_pos = 2 * t_len - 1;
  const size_t head_off = (size_t)bh * t_len * dk;
  const bf16* pos_h = pos + (size_t)hh * n_pos * dk;
  const float* kb_row = key_bias + (size_t)b * t_len;
  const int n_tiles = (t_len + kMS - 1) / kMS;

  // key tile j: K and V rows s0 .., and the P rows of relative positions
  // q0 + 63 - s0 down to q0 - 64 - s0 (P row T - 1 - (t - s)); warp w's
  // window starts at staged row 16 (3 - w)
  auto stage_tile = [&](int j, int buf) {
    bf16* kt = tiles + buf * S::kTileElems;
    const int s0 = j * kMS;
    stage_async<DKP>(kt, kk + head_off, s0, kMS, t_len, dk);
    stage_async<DKP>(kt + kMS * kSE, vv + head_off, s0, kMS, t_len, dk);
    stage_async<DKP>(kt + 2 * kMS * kSE, pos_h, t_len - kMQ - q0 + s0, kMP,
                     n_pos, dk);
  };
  // the key tiles j_lo .. j_hi - 1 to visit: all of them, or with packed
  // segments those of the span of the tile's valid queries' segments, and
  // with kWin those the window reaches
  int j_lo = 0, j_hi = n_tiles;
  const int* seg_row = kSeg ? seg + (size_t)b * t_len : nullptr;
  int seg_q[2] = {0, 0};
  if constexpr (kSeg) {
    __shared__ int span[4];  // lowest id, highest id, first key, last key + 1
    seg_span(seg_row, q0, t_len, span, j_lo, j_hi);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = tw + g + 8 * hr;
      seg_q[hr] = t < t_len ? seg_row[t] : 0;
    }
  }
  if constexpr (kWin) {
    int w_lo, w_hi;
    window_tiles(q0, left, right, n_tiles, w_lo, w_hi);
    j_lo = max(j_lo, w_lo);
    j_hi = min(j_hi, w_hi);
  }
  if (j_lo < j_hi) {
    stage_async<DKP>(Qu, qu + head_off, q0, kMQ, t_len, dk);
    stage_async<DKP>(Qv, qv + head_off, q0, kMQ, t_len, dk);
    stage_tile(j_lo, 0);
    cp_async_commit();
  }

  uint32_t qa[kKS][4], qb[kKS][4];
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int j = j_lo; j < j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j + 1 < j_hi) {
      stage_tile(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and at j = j_lo the query rows) landed
    if constexpr (!kQS) {
      if (j == j_lo) {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          const int off = (16 * warp + lane % 16) * kSE + ks * 16 +
                          (lane / 16) * 8;
          ldmatrix_x4(qa[ks], Qu + off);
          ldmatrix_x4(qb[ks], Qv + off);
        }
      }
    }
    const bf16* Kt = tiles + buf * S::kTileElems;
    const bf16* Vt = Kt + kMS * kSE;
    const bf16* Pw = Vt + kMS * kSE + (kMQ - 16 - 16 * warp) * kSE;
    const int s0 = j * kMS;
    // B-operand rows (keys or positions) n .. n + 15, k step ks
    const int b_row = lane % 8 + (lane / 16) * 8;
    const int b_col = ((lane / 8) % 2) * 8;

    {  // position scores through the skew tile
      float ga[kGW / 8][4];
#pragma unroll
      for (int n = 0; n < kGW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if constexpr (kQS) frag_rows<DKP>(qb[ks], Qv, warp, lane, ks);
#pragma unroll
        for (int nn = 0; nn < kGW / 16; ++nn) {
          uint32_t bq[4];
          ldmatrix_x4(bq, Pw + (16 * nn + b_row) * kSE + ks * 16 + b_col);
          mma_bf16(ga[2 * nn], qb[ks], bq[0], bq[1]);
          mma_bf16(ga[2 * nn + 1], qb[ks], bq[2], bq[3]);
        }
      }
      __syncwarp();  // the previous tile's skew reads are done
#pragma unroll
      for (int n = 0; n < kGW / 8; ++n) {
        const int c = 8 * n + 2 * t4;
        G[g * kGS + c] = ga[n][0];
        G[g * kGS + c + 1] = ga[n][1];
        G[(g + 8) * kGS + c] = ga[n][2];
        G[(g + 8) * kGS + c + 1] = ga[n][3];
      }
      __syncwarp();
    }

    float sc[kMS / 8][4];
#pragma unroll
    for (int n = 0; n < kMS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      if constexpr (kQS) frag_rows<DKP>(qa[ks], Qu, warp, lane, ks);
#pragma unroll
      for (int nn = 0; nn < kMS / 16; ++nn) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (16 * nn + b_row) * kSE + ks * 16 + b_col);
        mma_bf16(sc[2 * nn], qa[ks], bk[0], bk[1]);
        mma_bf16(sc[2 * nn + 1], qa[ks], bk[2], bk[3]);
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr, t = tw + r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kMS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jc = 8 * n + 2 * t4 + e, s = s0 + jc;
          float x = -INFINITY;
          if (s < t_len) {
            x = (sc[n][2 * hr + e] + G[r * kGS + jc - r + 15]) * scale +
                kb_row[s];
            if (!in_window(t, s, left, right)) x = -1e30f;
            if constexpr (kSeg) {
              if (seg_row[s] != seg_q[hr]) x = -1e30f;
            }
          }
          sc[n][2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m_r[hr] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kMS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sc[n][2 * hr + e] - m_use);
          sum += p;
          float pd = p;
          if (thresh) {
            const int s = s0 + 8 * n + 2 * t4 + e;
            pd = dropout_keep(stream,
                              (uint32_t)t * (uint32_t)tp + (uint32_t)s,
                              thresh)
                     ? p * dscale
                     : 0.f;
          }
          sc[n][2 * hr + e] = pd;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[hr] = l_r[hr] * corr + sum;
      m_r[hr] = m_new;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        o[n][2 * hr] *= corr;
        o[n][2 * hr + 1] *= corr;
      }
    }

#pragma unroll
    for (int kc = 0; kc < kMS / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dd = 0; dd < kND / 2; ++dd) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, Vt + (16 * kc + lane % 8 + ((lane / 8) % 2) * 8) * kSE +
                    16 * dd + (lane / 16) * 8);
        mma_bf16(o[2 * dd], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dd + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // tile j is consumed before its buffer is refilled
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = tw + g + 8 * hr;
    if (t >= t_len) continue;
    bf16* dst = ctx + cl.at(b, hh, t);
    // with segments a tile with no valid query visits no key: l = 0
    const float inv = !kSeg || l_r[hr] > 0.f ? 1.f / l_r[hr] : 0.f;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c < dk) dst[c] = __float2bfloat16(o[n][2 * hr] * inv);
      if (c + 1 < dk) dst[c + 1] = __float2bfloat16(o[n][2 * hr + 1] * inv);
    }
    // a row that saw no key gets lse = +1e30: every backward p = exp(x -
    // lse) on it is 0, where -inf would give inf and then NaN
    if (lse && t4 == 0)
      lse[(size_t)bh * t_len + t] =
          !kSeg || l_r[hr] > 0.f ? m_r[hr] + logf(l_r[hr]) : 1e30f;
  }
}

}  // namespace
