// The relative-position attention core shared by attention.cu (the block
// sublayer and the per-head attention) and layer.cu (the fused layer): per
// (batch row, head, 32 queries), content and position scores, key bias,
// local window, online softmax, dropout on the probabilities and the value
// product, flash-style over 32-key tiles, so the scores never leave the
// block. See attention.cu for the design and what bounds it.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kBQ = 32;  // queries per block: 8 warps x 4 rows
constexpr int kBS = 32;  // keys per tile: one per lane

// Where row t of head h of batch row b lies in a per-row tensor: element d
// at b * b_ + h * h_ + t * t_ + d. (B, H, T, dk) is {H T dk, T dk, dk};
// (B, T, H dk) is {T H dk, dk, H dk}.
struct HeadLayout {
  long long b_, h_, t_;
  __device__ __forceinline__ long long at(int b, int h, int t) const {
    return b * b_ + h * h_ + t * t_;
  }
};

// The local window of tpu_asr/ops/pallas_attention.py::_local_mask: key s
// is visible from query t when s - t >= -left (left >= 0) and
// s - t <= right (right >= 0); (-1, -1) is full context.
__device__ __forceinline__ bool in_window(int t, int s, int left,
                                          int right) {
  return (left < 0 || s - t >= -left) && (right < 0 || s - t <= right);
}

// Row stride (floats) of the shared tiles: a multiple of 4 holding dk, with
// an odd number of float4s.
__host__ __device__ __forceinline__ int row_stride(int dk) {
  int s = (dk + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

// Shared memory (bytes) of core_tile.
__host__ __device__ __forceinline__ size_t core_smem(int dk) {
  return sizeof(float) * (size_t)row_stride(dk) *
         (2 * kBQ + 2 * kBS + kBQ + kBS - 1);
}

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int first, int n_rows,
                                           int valid_rows, int dk, int ks) {
  // dst[r * ks + d] = src[(first + r) * dk + d], zero outside the source;
  // one warp per row, lanes along d
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n_rows; r += blockDim.x / 32) {
    const int row = first + r;
    const bool ok = row >= 0 && row < valid_rows;
    const T* s = src + (size_t)row * dk;
    for (int d = lane; d < ks; d += 32)
      dst[r * ks + d] = (ok && d < dk) ? to_f(s[d]) : 0.f;
  }
}

// Context rows q0 .. q0 + 31 of head (b, hh), bh = b * heads + hh, into ctx
// (layout cl) and, when lse is not null, their log-sum-exp into lse
// (B, H, T). q_u, q_v, k, v are (B, H, T, dk) and pos (H, 2T-1, dk) in T;
// key_bias (B, T). With kSeg, `seg` (B, T) is the packed-segment map: a
// key whose segment differs from the query's scores -1e30, as the window's
// do (every key tile is still visited; a guard query, segment 0, gets the
// uniform average over the row's keys); without, seg is not read. `smem`
// holds core_smem(dk) bytes, 16-byte aligned. The block's 256 threads all
// call it; it starts with a block barrier, so a block may call it for one
// tile after another. Lane l holds columns l + 32 c of a head row, c < kC:
// kC = 2 takes dk <= 64, kC = 4 dk <= 128 (conformer-XLarge).
template <typename T, bool kSeg = false, int kC = 2>
__device__ void core_tile(float* smem, const T* __restrict__ qu,
                          const T* __restrict__ qv, const T* __restrict__ kk,
                          const T* __restrict__ vv, const T* __restrict__ pos,
                          const float* __restrict__ key_bias,
                          T* __restrict__ ctx, HeadLayout cl,
                          float* __restrict__ lse, int bh, int q0, int t_len,
                          int heads, int dk, float scale, uint32_t stream,
                          uint32_t thresh, float dscale, int tp, int left,
                          int right, const int* __restrict__ seg = nullptr) {
  const int ks = row_stride(dk);
  float* Qu = smem;              // kBQ x ks
  float* Qv = Qu + kBQ * ks;     // kBQ x ks
  float* Ks = Qv + kBQ * ks;     // kBS x ks
  float* Vs = Ks + kBS * ks;     // kBS x ks
  float* Ps = Vs + kBS * ks;     // (kBQ + kBS - 1) x ks

  const int b = bh / heads, hh = bh - b * heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pos = 2 * t_len - 1;
  const size_t head_off = (size_t)bh * t_len * dk;
  const T* pos_h = pos + (size_t)hh * n_pos * dk;

  __syncthreads();  // the previous tile's shared rows are consumed
  stage_rows(Qu, qu + head_off, q0, kBQ, t_len, dk, ks);
  stage_rows(Qv, qv + head_off, q0, kBQ, t_len, dk, ks);

  float m_i[kRows], l_i[kRows], o[kRows][kC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[r][c] = 0.f;
  }
  const int* seg_row = kSeg ? seg + (size_t)b * t_len : nullptr;
  int seg_q[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    seg_q[r] = kSeg && t < t_len ? seg_row[t] : 0;
  }

  for (int s0 = 0; s0 < t_len; s0 += kBS) {
    __syncthreads();  // the previous tile is consumed
    stage_rows(Ks, kk + head_off, s0, kBS, t_len, dk, ks);
    stage_rows(Vs, vv + head_off, s0, kBS, t_len, dk, ks);
    // local row l holds relative position t - s = q0 - s0 + 31 - l, which
    // is P row (T - 1) - (t - s)
    stage_rows(Ps, pos_h, (t_len - 1) - (q0 - s0 + kBS - 1), kBQ + kBS - 1,
               n_pos, dk, ks);
    __syncthreads();

    const int s = s0 + lane;
    const float kb = s < t_len ? key_bias[(size_t)b * t_len + s] : 0.f;
    const int seg_k = kSeg && s < t_len ? seg_row[s] : 0;
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * ks);
    for (int d4 = 0; d4 < ks / 4; ++d4) {
      const float4 k4 = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = warp * kRows + r;
        const float4 a = reinterpret_cast<const float4*>(Qu + row * ks)[d4];
        const float4 c = reinterpret_cast<const float4*>(Qv + row * ks)[d4];
        const float4 p = reinterpret_cast<const float4*>(
            Ps + (lane - row + kBS - 1) * ks)[d4];
        float v = sc[r];
        v = fmaf(a.x, k4.x, v);
        v = fmaf(a.y, k4.y, v);
        v = fmaf(a.z, k4.z, v);
        v = fmaf(a.w, k4.w, v);
        v = fmaf(c.x, p.x, v);
        v = fmaf(c.y, p.y, v);
        v = fmaf(c.z, p.z, v);
        v = fmaf(c.w, p.w, v);
        sc[r] = v;
      }
    }

    float pw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = q0 + warp * kRows + r;
      float x = s < t_len ? sc[r] * scale + kb : -INFINITY;
      if (s < t_len && !in_window(t, s, left, right)) x = -1e30f;
      if (kSeg && s < t_len && seg_k != seg_q[r]) x = -1e30f;
      const float m_new = fmaxf(m_i[r], warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(x - m_use);
      const float corr = expf(m_i[r] - m_use);
      l_i[r] = l_i[r] * corr + warp_sum(p);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) o[r][c] *= corr;
      float pd = p;
      if (thresh) {
        pd = dropout_keep(stream, (uint32_t)t * (uint32_t)tp + (uint32_t)s,
                          thresh)
                 ? p * dscale
                 : 0.f;
      }
      pw[r] = to_f(from_f<T>(pd));  // the value product takes T operands
    }
    for (int j = 0; j < kBS; ++j) {
      float vc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        vc[c] = lane + 32 * c < dk ? Vs[j * ks + lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = __shfl_sync(0xffffffffu, pw[r], j);
#pragma unroll
        for (int c = 0; c < kC; ++c) o[r][c] = fmaf(p, vc[c], o[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t >= t_len) continue;
    T* dst = ctx + cl.at(b, hh, t);
    const float inv = 1.f / l_i[r];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (lane + 32 * c < dk) dst[lane + 32 * c] = from_f<T>(o[r][c] * inv);
    if (lse && lane == 0) lse[(size_t)bh * t_len + t] = m_i[r] + logf(l_i[r]);
  }
}

}  // namespace
